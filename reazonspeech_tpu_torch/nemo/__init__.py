"""NeMo flavor (nemo-v2) of the port."""
