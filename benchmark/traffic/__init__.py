"""Traffic: the footage generator (blob.py) and the mixes (*.json)."""
