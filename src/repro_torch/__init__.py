"""PyTorch/CUDA port of DSCEP (the JAX package ``repro`` is the reference)."""
