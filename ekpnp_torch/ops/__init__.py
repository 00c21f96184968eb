"""Physics operators of the port (plain PyTorch)."""
