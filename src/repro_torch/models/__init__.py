"""LM models of the port: GQA decoder stacks with dense or MoE FFNs and
Mamba-2 stacks (``lm.py``)."""
