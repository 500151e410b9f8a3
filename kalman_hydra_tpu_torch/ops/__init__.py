"""Image and flow operations of the port (plain PyTorch)."""
