"""LM models of the port: dense GQA decoder stacks (``lm.py``)."""
