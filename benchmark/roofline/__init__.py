"""Stages of the roofline, one file each (see lib/roofline.py)."""
