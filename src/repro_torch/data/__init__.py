"""Synthetic stream and KB generators (same rows as the reference for a seed)."""
