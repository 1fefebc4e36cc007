"""Tensor operations of the PyTorch port (counterparts of the reference's ops/)."""
