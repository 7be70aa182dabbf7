"""espnet flavor of the PyTorch port."""
