"""The plain reference of the tracked pipeline (flow.py, tracker.py)."""
