"""Serving: multi-query SCEP serving (``engine``, ``batcher``) and LM
prefill and greedy decode (``lm``)."""
from . import batcher, engine, lm  # noqa: F401
