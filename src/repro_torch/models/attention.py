"""GQA attention (QKV bias, RoPE or Qwen2-VL's M-RoPE, sliding windows) and
multi-head latent attention (MLA: MiniCPM3, DeepSeek-V2), with and without
a cache.

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

:func:`_sdpa` dispatches (``impl="pallas"``, the serving default): one
new token, causal -> decode attention over
the cache rows ``[max(0, len + 1 - window), len + 1)`` (the reference's
mask ``kpos > qpos - window`` with ``qpos = len``), with or without a
window; any other attention -> flash attention with ``q_offset = len``.
The reference's Pallas dispatch sends a windowed one-token step to flash
attention (``models/attention.py`` ``_sdpa``); the port takes decode
attention there too, since flash would spend a 128-row query tile on one
row.  The function computed is the same.  CUDA tensors take the kernels,
CPU tensors their plain versions.  ``impl="xla"`` (training) runs the
reference's float32 einsum attention instead (:func:`_sdpa_xla`), which
autograd differentiates; the kernels refuse a graph.

**MLA** (:func:`mla_forward`, the reference's ``mla_forward``) caches the
compressed latent instead of per-head keys and values: ``{"ckv": [B, S,
r], "krope": [B, S, dr], "len"}`` in the reference's layout, the T new
rows written in place at ``len`` as above (per lane, clamped, for
per-sequence lengths).  Two ways to attend:

* **Non-absorbed** (``mla_absorbed=False``, the default): the latent rows
  are expanded through ``wkv_b`` straight into keys ``[B, H, n, dn + dr]``
  (the shared rotary key appended to each head) and values ``[B, H, n,
  dv]``, then :func:`_sdpa` runs the flash or decode kernel at head dims
  ``(D, Dv) = (dn + dr, dv)``, scaled by ``1/sqrt(D)``.  With a shared
  length only the live rows ``n = len + T`` are expanded (the causal mask
  kills the rest); per-sequence lengths expand all S rows and read nothing
  back to the host, as a tick must not.
* **Absorbed** (``mla_absorbed=True``, with a cache): attention in latent
  space, ``wkv_b``'s key half folded into the query and its value half
  applied after the contraction, in float32 torch products exactly as the
  reference's einsums (its causal mask for T > 1 included).  The reference
  runs it outside any Pallas kernel, and so does the port (ROADMAP.md
  lists an MQA launch of the decode kernel at D = r + dr as deferred).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.decode_attention import ops as da_ops
from ..kernels.flash_attention import ops as fa_ops
from .common import (
    apply_mrope, apply_rope, check_impl, dense, normal_param, refuse_grad,
    zeros_param,
)

NEG_INF = -1e30


class Attention(nn.Module):
    """Weights in the reference's layout: ``wq [d, Hq*D]``, ``wk, wv [d,
    Hk*D]``, ``wo [Hq*D, d]``; biases ``bq, bk, bv`` or None."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("bq", bq), ("bk", bk), ("bv", bv)):
            setattr(self, name, None if t is None
                    else nn.Parameter(t, requires_grad=False))


class MLA(nn.Module):
    """MLA weights in the reference's layout: ``wq_a [d, rq]`` and ``wq_b
    [rq, H*(dn+dr)]`` (or ``wq [d, H*(dn+dr)]`` where ``q_lora_rank`` is
    0), ``wkv_a [d, r]``, ``wk_rope [d, dr]``, ``wkv_b [r, H*(dn+dv)]``
    (per head: dn key columns, then dv value columns), ``wo [H*dv, d]``;
    the query leaves a configuration does not use are None."""

    def __init__(self, wkv_a, wk_rope, wkv_b, wo, wq=None, wq_a=None,
                 wq_b=None):
        super().__init__()
        for name, t in (("wq", wq), ("wq_a", wq_a), ("wq_b", wq_b),
                        ("wkv_a", wkv_a), ("wk_rope", wk_rope),
                        ("wkv_b", wkv_b), ("wo", wo)):
            setattr(self, name, None if t is None
                    else nn.Parameter(t, requires_grad=False))


def check_attention(cfg: ModelConfig) -> None:
    """M-RoPE rotates GQA's queries and keys; MLA rotates with RoPE only
    (the reference's ``mla_forward``), so the two together are an
    error."""
    if cfg.mrope_sections is not None and cfg.mla is not None:
        raise ValueError("%s: M-RoPE with MLA is not a model of the "
                         "reference" % cfg.name)


def init_attention(cfg: ModelConfig, generator: Optional[torch.Generator],
                   device, dtype) -> Union[Attention, MLA]:
    """Weights normal / sqrt(fan_in) drawn from ``generator`` (the
    reference's ``param``), biases 0; an MLA layer draws its query leaves,
    ``wkv_a``, ``wk_rope``, ``wkv_b`` and ``wo`` in the reference's
    order."""
    check_attention(cfg)
    if cfg.mla is not None:
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        qd = h * (m.nope_head_dim + m.rope_head_dim)

        def w(*shape):
            return normal_param(shape, generator, device, dtype)

        q = (dict(wq_a=w(d, m.q_lora_rank), wq_b=w(m.q_lora_rank, qd))
             if m.q_lora_rank else dict(wq=w(d, qd)))
        return MLA(w(d, m.kv_lora_rank), w(d, m.rope_head_dim),
                   w(m.kv_lora_rank, h * (m.nope_head_dim + m.v_head_dim)),
                   w(h * m.v_head_dim, d), **q)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd, kd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    w = [normal_param(shape, generator, device, dtype)
         for shape in ((d, qd), (d, kd), (d, kd), (qd, d))]
    b = ([zeros_param((n,), device, dtype) for n in (qd, kd, kd)]
         if cfg.qkv_bias else [None] * 3)
    return Attention(*w, *b)


def _sdpa_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: Optional[int],
              q_offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """The reference's ``impl="xla"`` attention, differentiable: float32
    einsums over ``[B, Hk, group, T, S]`` logits scaled by ``1/sqrt(D)``,
    masked to -1e30, softmax, -> ``[B, Hq, T, Dv]`` in ``q``'s dtype."""
    b, hq, t, dd = q.shape
    hk, s = k.shape[1], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dd)))
    qf = q.reshape(b, hk, hq // hk, t, dd).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float()) * scale
    off = (q_offset.long() if torch.is_tensor(q_offset)
           else torch.tensor(q_offset, device=q.device))
    qpos = off[..., None] + torch.arange(t, device=q.device)   # [t] | [B, t]
    kpos = torch.arange(s, device=q.device)
    mask = torch.ones(qpos.shape + (s,), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos[..., None]
    if window is not None:
        mask &= kpos > qpos[..., None] - window
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(b, hq, t, v.shape[-1]).to(q.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          window: Optional[int], q_offset: Union[int, torch.Tensor],
          impl: str = "pallas") -> torch.Tensor:
    """``q [B, Hq, T, D]`` against ``k [B, Hk, S, D]`` and ``v [B, Hk, S,
    Dv]`` -> ``[B, Hq, T, Dv]``; query row ``i`` of sequence b at absolute
    position ``q_offset + i``, ``q_offset`` an int or an int32 ``[B]``
    tensor (one per sequence).  ``impl="xla"`` is :func:`_sdpa_xla`;
    ``"pallas"`` the kernels, which refuse a graph."""
    check_impl(impl)
    if impl == "xla":
        return _sdpa_xla(q, k, v, causal, window, q_offset)
    refuse_grad("attention", q, k, v)
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
                impl: str = "pallas",
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``x [B, T, d]`` at ``positions [B, T]`` (``[3, B, T]`` with M-RoPE)
    -> ``(out [B, T, d], cache)``.  With a cache, the T new key/value rows
    are written at ``cache["len"]`` (per lane for per-sequence lengths) in
    place, and the returned cache holds the same tensors with ``len +
    T``."""
    b, t, _ = x.shape
    hd, hq, hk = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = dense(x, p.wq, p.bq).reshape(b, t, hq, hd)
    k = dense(x, p.wk, p.bk).reshape(b, t, hk, hd)
    v = dense(x, p.wv, p.bv).reshape(b, t, hk, hd)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = q.transpose(1, 2).contiguous()
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        out = _sdpa(q, k.contiguous(), v.contiguous(), causal=True,
                    window=cfg.swa_window, q_offset=0, impl=impl)
        new_cache = None
    else:
        idx = cache["len"]
        _write_rows(cache, {"k": k, "v": v}, 2)
        out = _sdpa(q, cache["k"], cache["v"], causal=True,
                    window=cfg.swa_window, q_offset=idx, impl=impl)
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


def _write_rows(cache: Dict, new: Dict[str, torch.Tensor], axis: int) -> None:
    """Write the T new rows of each ``new[name]`` (``[B, ..., T, ...]``,
    rows on ``axis``) into ``cache[name]`` in place at ``cache["len"]``:
    a shared host length must leave room; per-sequence lengths put lane
    b's rows at ``clamp(len[b], 0, S - T)``, as JAX clamps, with one
    indexed copy a tensor and no host read."""
    idx = cache["len"]
    name0 = next(iter(new))
    s, t = cache[name0].shape[axis], new[name0].shape[axis]
    if torch.is_tensor(idx):
        if t > s:
            raise ValueError("the cache holds %d rows; %d new rows do not "
                             "fit" % (s, t))
        rows = idx.clamp(0, s - t)[:, None].long() + torch.arange(
            t, device=idx.device)
        lane = torch.arange(rows.shape[0], device=idx.device)[:, None]
        for name, x in new.items():
            if axis == 1:
                cache[name][lane, rows] = x
            else:
                cache[name][lane, :, rows] = x.transpose(1, axis)
    else:
        if idx + t > s:
            raise ValueError("the cache holds %d rows; %d + %d do not fit"
                             % (s, idx, t))
        for name, x in new.items():
            cache[name].narrow(axis, idx, t).copy_(x)


def mla_forward(p: MLA, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                impl: str = "pallas",
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA: ``x [B, T, d]`` at ``positions [B, T]`` -> ``(out [B, T, d],
    cache)``, the reference's ``mla_forward``.  With a cache ``{"ckv":
    [B, S, r], "krope": [B, S, dr], "len"}`` the T new latent rows are
    written at ``len`` in place (per lane for per-sequence lengths) and the
    returned cache holds the same tensors with ``len + T``."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    q = (dense(dense(x, p.wq_a), p.wq_b) if m.q_lora_rank
         else dense(x, p.wq)).reshape(b, t, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = dense(x, p.wkv_a)                               # [B, T, r] latent
    k_rope = apply_rope(dense(x, p.wk_rope).reshape(b, t, 1, dr), positions,
                        cfg.rope_theta).reshape(b, t, dr)  # shared by heads

    if cache is None:
        ckv_all, kr_all, q_offset, new_cache = ckv, k_rope, 0, None
    else:
        _write_rows(cache, {"ckv": ckv, "krope": k_rope}, 1)
        q_offset = cache["len"]
        new_cache = {"ckv": cache["ckv"], "krope": cache["krope"],
                     "len": q_offset + t}
        live = cache["ckv"].shape[1] if torch.is_tensor(q_offset) \
            else q_offset + t
        ckv_all = cache["ckv"][:, :live]
        kr_all = cache["krope"][:, :live]

    if cache is not None and cfg.mla_absorbed:
        out = _mla_absorbed(p, cfg, q_nope, q_rope, ckv_all, kr_all,
                            q_offset).to(x.dtype)
    else:
        # the latent rows expanded per head, keys [B, H, n, dn + dr] (the
        # shared rotary key after each head's dn columns), values [B, H,
        # n, dv]: written once each, in the layout the kernels read
        n = ckv_all.shape[1]
        kv = dense(ckv_all, p.wkv_b).reshape(b, n, h, dn + dv).transpose(1,
                                                                         2)
        k = torch.cat([kv[..., :dn], kr_all[:, None].expand(b, h, n, dr)],
                      dim=-1)
        v = kv[..., dn:].contiguous()
        qk = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2).contiguous()
        out = _sdpa(qk, k, v, causal=True, window=cfg.swa_window,
                    q_offset=q_offset, impl=impl).transpose(1, 2)
    return dense(out.reshape(b, t, h * dv), p.wo), new_cache


def _mla_absorbed(p: MLA, cfg: ModelConfig, q_nope: torch.Tensor,
                  q_rope: torch.Tensor, ckv_all: torch.Tensor,
                  kr_all: torch.Tensor,
                  q_offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """Latent-space attention, float32: ``wkv_b``'s key half folded into
    the query (``q_lat [B, T, H, r]``), scores against the latent rows plus
    the rotary part, the causal mask from each sequence's offset, the
    context ``[B, T, H, r]`` through ``wkv_b``'s value half -> ``[B, T, H,
    dv]``.  The reference's einsums, one for one."""
    m, h = cfg.mla, cfg.num_heads
    dn, dr = m.nope_head_dim, m.rope_head_dim
    t, s = q_nope.shape[1], ckv_all.shape[1]
    wkv_b = p.wkv_b.float().reshape(m.kv_lora_rank, h, dn + m.v_head_dim)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    ckv_f = ckv_all.float()
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope.float(), w_k)
    logits = (torch.einsum("bthr,bsr->bhts", q_lat, ckv_f)
              + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                             kr_all.float())) / math.sqrt(dn + dr)
    dev = q_nope.device
    off = (q_offset.long() if torch.is_tensor(q_offset)
           else torch.tensor(q_offset, device=dev))
    qpos = off[..., None] + torch.arange(t, device=dev)
    mask = torch.arange(s, device=dev) <= qpos[..., None]   # [t|B,t, s]
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    ctx = torch.einsum("bhts,bsr->bthr", probs, ckv_f)
    return torch.einsum("bthr,rhd->bthd", ctx, w_v)


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device="cpu",
                    per_seq: bool = False) -> Dict:
    """An empty MLA cache of one layer, the reference's layout: zeros
    ``ckv [batch, max_len, r]`` and ``krope [batch, max_len, dr]``, length
    0 (an int32 ``[batch]`` tensor of zeros with ``per_seq``)."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, m.rope_head_dim),
                                 dtype=dtype, device=device),
            "len": seq_lengths(batch, device) if per_seq else 0}


def attn_forward(p: Union[Attention, MLA], cfg: ModelConfig,
                 x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Dict] = None, impl: str = "pallas",
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """:func:`mla_forward` for an MLA configuration, else
    :func:`gqa_forward`."""
    if cfg.mla is not None:
        return mla_forward(p, cfg, x, positions, cache, impl)
    return gqa_forward(p, cfg, x, positions, cache, impl)


def attn_cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype, device="cpu",
                     per_seq: bool = False) -> Dict:
    """:func:`mla_cache_shape` or :func:`gqa_cache_shape`."""
    fn = mla_cache_shape if cfg.mla is not None else gqa_cache_shape
    return fn(cfg, batch, max_len, dtype, device, per_seq)
