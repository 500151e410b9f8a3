"""Utilities of the port: checkpoint/resume, run reports, numeric
sanitizers and profiling."""
from . import checkpoint, debug, profiling, report

__all__ = ["checkpoint", "debug", "profiling", "report"]
