"""LM serving of the port: cached prefill and greedy decode (``lm.py``)."""
