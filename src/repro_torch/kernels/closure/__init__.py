"""Transitive-closure kernels (boolean squaring, fused descendants)."""
