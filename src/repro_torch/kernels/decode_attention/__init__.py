"""GQA decode attention: one query token per sequence against a KV cache."""
