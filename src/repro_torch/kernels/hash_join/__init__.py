"""Fused window-vs-KB joins (scan and probe)."""
