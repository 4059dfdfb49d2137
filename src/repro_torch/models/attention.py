"""GQA attention (QKV bias, RoPE, sliding windows) with and without a KV
cache.

The cache of one layer is ``{"k": [B, Hk, S, D], "v": [B, Hk, S, D],
"len"}``: heads before positions, so the kernels read it where it lies
(the reference keeps ``[B, S, Hk, D]`` and transposes per call).  ``len``
is either one host integer shared by the batch, or, for the continuous
batcher's slot lanes (``per_seq``), an int32 ``[B]`` tensor on the
cache's device.  :func:`gqa_forward` writes the new rows into the cache
tensors in place.

* **Shared length.**  The cached prefill knows the length on the host and
  takes the flash kernel with ``q_offset`` set; the T new rows go at
  ``len`` and must fit.
* **Per-sequence lengths.**  The T new rows of lane b go at ``len[b]``,
  the start clamped to ``[0, S - T]`` as JAX's ``dynamic_update_slice``
  clamps it (the reference advances every lane by T each step, idle lanes
  too, so an idle lane's length can pass S: it neither raises nor writes
  past the end).  One indexed copy a tensor writes every lane, with no
  host read: a one-token step never reads the lengths back.  T > 1 (not
  used by the batcher) runs the flash kernel once per lane with that
  lane's ``q_offset``, which reads the lengths to the host once.

:func:`_sdpa` dispatches: one new token, causal -> decode attention over
the cache rows ``[max(0, len + 1 - window), len + 1)`` (the reference's
mask ``kpos > qpos - window`` with ``qpos = len``), with or without a
window; any other attention -> flash attention with ``q_offset = len``.
The reference's Pallas dispatch sends a windowed one-token step to flash
attention (``models/attention.py`` ``_sdpa``); the port takes decode
attention there too, since flash would spend a 128-row query tile on one
row.  The function computed is the same.  CUDA tensors take the kernels,
CPU tensors their plain versions.  MLA raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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
          window: Optional[int],
          q_offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """``q [B, Hq, T, D]`` against ``k, v [B, Hk, S, D]``; query row ``i``
    of sequence b at absolute position ``q_offset + i``, ``q_offset`` an
    int or an int32 ``[B]`` tensor (one per sequence)."""
    b, _, t, _ = q.shape
    per_seq = torch.is_tensor(q_offset)
    if t == 1 and causal:
        # one query row against the cache: the rows up to the just-written
        # position, the window's start taken from the same length
        lengths = (q_offset + 1 if per_seq else
                   torch.full((b,), q_offset + 1, dtype=torch.int32,
                              device=q.device))
        return da_ops.decode_attention(q, k, v, lengths, window)
    if not per_seq:
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    return torch.cat([
        fa_ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                               causal=causal, window=window, q_offset=off)
        for i, off in enumerate(q_offset.tolist())])


def gqa_forward(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``x [B, T, d]`` at ``positions [B, T]`` -> ``(out [B, T, d],
    cache)``.  With a cache, the T new key/value rows are written at
    ``cache["len"]`` (per lane for per-sequence lengths) in place, and the
    returned cache holds the same tensors with ``len + T``."""
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
        s = cache["k"].shape[2]
        if torch.is_tensor(idx):
            if t > s:
                raise ValueError("the cache holds %d rows; %d new rows do "
                                 "not fit" % (s, t))
            rows = idx.clamp(0, s - t)[:, None].long() + torch.arange(
                t, device=idx.device)
            lane = torch.arange(b, device=idx.device)[:, None]
            cache["k"][lane, :, rows] = k.transpose(1, 2)
            cache["v"][lane, :, rows] = v.transpose(1, 2)
        else:
            if idx + t > s:
                raise ValueError("the cache holds %d rows; %d + %d do not fit"
                                 % (s, idx, t))
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
    """An empty cache of one layer: zeros ``[batch, Hk, max_len, D]``,
    length 0 (an int32 ``[batch]`` tensor of zeros with ``per_seq``)."""
    shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": seq_lengths(batch, device) if per_seq else 0}


def seq_lengths(batch: int, device) -> torch.Tensor:
    """Per-sequence cache lengths, all 0: int32 ``[batch]`` on ``device``."""
    return torch.zeros((batch,), dtype=torch.int32, device=device)
