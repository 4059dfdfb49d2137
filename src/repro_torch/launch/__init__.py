"""Deployment helpers of the PyTorch/CUDA port (operator placement)."""
