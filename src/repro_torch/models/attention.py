"""GQA attention (QKV bias, RoPE) with and without a KV cache.

The cache of one layer is ``{"k": [B, Hk, S, D], "v": [B, Hk, S, D],
"len": int}``: heads before positions, so the kernels read it where it
lies (the reference keeps ``[B, S, Hk, D]`` and transposes per call).  The
length is one host integer shared by the batch: the port runs eagerly, so
the cached prefill knows it and takes the flash kernel with ``q_offset``
set.  :func:`gqa_forward` writes the new rows into the cache tensors in
place.

:func:`_sdpa` keeps the reference's dispatch (``models/attention.py``
``_sdpa``): one new token, causal, no window -> decode attention over the
first ``len + 1`` cache rows; any other attention -> flash attention with
``q_offset = len``.  CUDA tensors take the kernels, CPU tensors their plain
versions.  MLA and per-sequence cache lengths raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig, not_ported
from ..kernels.decode_attention import ops as da_ops
from ..kernels.flash_attention import ops as fa_ops
from .common import apply_rope, dense, normal_param, zeros_param


class Attention(nn.Module):
    """Weights in the reference's layout: ``wq [d, Hq*D]``, ``wk, wv [d,
    Hk*D]``, ``wo [Hq*D, d]``; biases ``bq, bk, bv`` or None."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("bq", bq), ("bk", bk), ("bv", bv)):
            setattr(self, name, None if t is None
                    else nn.Parameter(t, requires_grad=False))


def check_attention(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise not_ported("MLA attention (%s)" % cfg.name,
                         "Other LM architectures")
    if cfg.mrope_sections is not None:
        raise not_ported("M-RoPE (%s)" % cfg.name, "Other LM architectures")


def init_attention(cfg: ModelConfig, generator: Optional[torch.Generator],
                   device, dtype) -> Attention:
    check_attention(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd, kd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    w = [normal_param(shape, generator, device, dtype)
         for shape in ((d, qd), (d, kd), (d, kd), (qd, d))]
    b = ([zeros_param((n,), device, dtype) for n in (qd, kd, kd)]
         if cfg.qkv_bias else [None] * 3)
    return Attention(*w, *b)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          window: Optional[int], q_offset: int) -> torch.Tensor:
    """``q [B, Hq, T, D]`` against ``k, v [B, Hk, S, D]``; query row ``i``
    at absolute position ``q_offset + i``."""
    b, _, t, _ = q.shape
    if t == 1 and causal and window is None:
        # one query row against the cache: its valid length is the
        # just-written position + 1
        lengths = torch.full((b,), q_offset + 1, dtype=torch.int32,
                             device=q.device)
        return da_ops.decode_attention(q, k, v, lengths)
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def gqa_forward(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``x [B, T, d]`` at ``positions [B, T]`` -> ``(out [B, T, d],
    cache)``.  With a cache, the T new key/value rows are written at
    ``cache["len"]`` in place, and the returned cache holds the same
    tensors with ``len + T``."""
    check_attention(cfg)
    b, t, _ = x.shape
    hd, hq, hk = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = dense(x, p.wq, p.bq).reshape(b, t, hq, hd)
    k = dense(x, p.wk, p.bk).reshape(b, t, hk, hd)
    v = dense(x, p.wv, p.bv).reshape(b, t, hk, hd)
    q = apply_rope(q, positions, cfg.rope_theta).transpose(1, 2).contiguous()
    k = apply_rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        out = _sdpa(q, k.contiguous(), v.contiguous(), causal=True,
                    window=cfg.swa_window, q_offset=0)
        new_cache = None
    else:
        idx = cache["len"]
        if not isinstance(idx, int):
            raise not_ported("per-sequence cache lengths",
                             "LM continuous batching")
        if idx + t > cache["k"].shape[2]:
            raise ValueError("the cache holds %d rows; %d + %d do not fit"
                             % (cache["k"].shape[2], idx, t))
        cache["k"][:, :, idx:idx + t] = k
        cache["v"][:, :, idx:idx + t] = v
        out = _sdpa(q, cache["k"], cache["v"], causal=True,
                    window=cfg.swa_window, q_offset=idx)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + t}
    out = out.transpose(1, 2).reshape(b, t, hq * hd)
    return dense(out, p.wo), new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device="cpu",
                    per_seq: bool = False) -> Dict:
    """An empty cache of one layer: zeros ``[batch, Hk, max_len, D]``."""
    if per_seq:
        raise not_ported("per-sequence cache lengths", "LM continuous batching")
    shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}
