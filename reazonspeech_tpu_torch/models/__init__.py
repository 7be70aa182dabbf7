"""Model layers and architectures (PyTorch)."""
