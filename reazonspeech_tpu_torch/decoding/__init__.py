"""Transducer decoders (PyTorch)."""
