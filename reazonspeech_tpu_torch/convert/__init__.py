"""Param-tree storage and the weight bridge from the JAX package."""
