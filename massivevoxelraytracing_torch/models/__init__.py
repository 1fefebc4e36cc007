"""Scene build, traversal dispatch and primary frames of the PyTorch port."""
