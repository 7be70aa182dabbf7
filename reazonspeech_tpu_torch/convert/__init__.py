"""Checkpoint converters (published containers -> the native param tree),
param-tree storage, int8 quantization and the weight bridge from numpy."""
