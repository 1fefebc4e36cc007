"""Host utilities of the PyTorch port (the CUDA build and its binding)."""
