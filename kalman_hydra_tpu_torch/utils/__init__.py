"""Utilities of the port: checkpoint/resume and run reports."""
from . import checkpoint, report

__all__ = ["checkpoint", "report"]
