"""Mamba-2 SSD chunked scan (state-space duality), with an initial state."""
