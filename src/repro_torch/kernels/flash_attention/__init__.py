"""GQA flash attention forward (causal / sliding window, ``q_offset``)."""
