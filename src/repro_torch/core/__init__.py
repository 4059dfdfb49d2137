"""Core engine of the PyTorch/CUDA port."""
