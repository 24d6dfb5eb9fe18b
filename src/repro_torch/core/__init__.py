"""Core index, query and build modules of the PyTorch port."""
