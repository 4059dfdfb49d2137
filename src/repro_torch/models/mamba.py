"""Mamba mixers with and without a decode cache: Mamba-1 (the selective
scan, Jamba's) and Mamba-2 (SSD).

The three branches of the reference's ``mamba1_forward`` and
``mamba2_forward``:

* no cache (``lm.forward``): the scan from a zero state;
* a cached prefill (T > 1): the scan from the cached state, which emits
  the final state (Mamba-2: the reference runs its plain ``ssd_ref`` with
  ``init_state`` here; the port takes the same function through the SSD
  kernel, so no prefill steps token by token);
* one new token: the plain one-step recurrence on the cached state (the
  reference has no kernel there either).

Mamba-1's scan is torch ops in float32, as the reference's is XLA (a
``jax.lax.associative_scan`` over time, no Pallas kernel): the time axis
is cut into chunks of :func:`scan_chunk` steps, each scanned in log2 of
its length steps, its incoming state added after the scan as the
reference adds a cached one, so no ``[B, T, di, S]`` tensor is held
whole.

``impl`` (``models/common.py``): ``"pallas"`` (the serving default) runs
Mamba-2's scan without a cache through the SSD kernel and Mamba-1's
chunks in place; ``"xla"`` (training) runs the former as plain chunked
torch ops with the reference's ``ssd_ref`` rounding (:func:`ssd_xla`)
and the latter out of place, so autograd differentiates both.

The cache of one layer is ``{"conv": [B, K-1, C]`` in the model dtype
(the causal conv's last K-1 inputs; C = d_inner for Mamba-1, d_inner +
2·G·S for Mamba-2), ``"ssm"`` float32 (``[B, d_inner, S]`` for Mamba-1,
``[B, H, S, P]`` for Mamba-2)``}``; the forwards write the new tail and
state into those tensors in place.  The continuous batcher's slot lanes
are the batch rows; its launcher zeroes a lane before the lane's prefill
(``launch/serve.py``), so that prefill's scan runs from a zero state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd import ref as ssd_ref
from .common import (
    check_impl, dense, normal_param, ones_param, refuse_grad, rms_norm,
    zeros_param,
)

# the reference's parameter names by version, in Mamba's argument order;
# the per-head (Mamba-2) or per-channel (Mamba-1) vectors and Mamba-1's
# A_log stay float32 whatever the model dtype
LEAVES = {
    1: ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
        "A_log", "D", "out_proj"),
    2: ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
        "out_proj"),
}
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")

# Mamba-1's scan holds at most SCAN_LIVE float32 [B, chunk, d_inner, S]
# tensors at once, SCAN_BYTES in all
SCAN_BYTES = 2 << 30
SCAN_LIVE = 4


class Mamba(nn.Module):
    """Weights in the reference's layout, ``LEAVES[version]`` in order.
    Mamba-2: ``in_proj [d, 2·di + 2·G·S + H]`` (z, then x·B·C, then dt),
    ``conv_w [K, C]``, ``conv_b [C]``, ``A_log, D, dt_bias [H]`` float32,
    ``norm_w [di]``, ``out_proj [di, d]``.  Mamba-1: ``in_proj [d, 2·di]``
    (x, then z), ``conv_w [K, di]``, ``conv_b [di]``, ``x_proj [di, r +
    2·S]`` (dt rank r, then B, C), ``dt_proj [r, di]``, ``dt_bias [di]``,
    ``A_log [di, S]``, ``D [di]`` float32, ``out_proj [di, d]``."""

    def __init__(self, *tensors: torch.Tensor, version: int = 2):
        super().__init__()
        self.version = version
        names = LEAVES[version]
        if len(tensors) != len(names):
            raise ValueError("Mamba-%d takes %d tensors (%s), not %d"
                             % (version, len(names), ", ".join(names),
                                len(tensors)))
        for name, t in zip(names, tensors):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def check_mamba(cfg: ModelConfig) -> None:
    if cfg.mamba is None:
        raise ValueError("%s has a Mamba layer but no MambaConfig" % cfg.name)
    if cfg.mamba.version not in LEAVES:
        raise ValueError("%s: no Mamba-%d" % (cfg.name, cfg.mamba.version))


def dt_rank(d_model: int) -> int:
    """Mamba-1's dt projection rank, ``ceil(d_model / 16)``."""
    return max(1, math.ceil(d_model / 16))


def init_mamba(cfg: ModelConfig, generator: Optional[torch.Generator],
               device, dtype) -> Mamba:
    """The reference's distributions: projections normal / sqrt(fan_in),
    ``conv_w`` normal * 0.5, ``A_log``, ``dt_bias`` and ``conv_b`` 0, ``D``
    and ``norm_w`` 1."""
    check_mamba(cfg)
    mc, d = cfg.mamba, cfg.d_model
    di, s, f32 = mc.d_inner(d), mc.d_state, torch.float32
    if mc.version == 1:
        r = dt_rank(d)
        return Mamba(
            normal_param((d, 2 * di), generator, device, dtype),
            normal_param((mc.d_conv, di), generator, device, dtype,
                         scale=0.5),
            zeros_param((di,), device, dtype),
            normal_param((di, r + 2 * s), generator, device, dtype),
            normal_param((r, di), generator, device, dtype),
            zeros_param((di,), device, f32),
            zeros_param((di, s), device, f32),
            ones_param((di,), device, f32),
            normal_param((di, d), generator, device, dtype), version=1)
    nh = mc.nheads(d)
    conv_ch = di + 2 * mc.ngroups * s
    return Mamba(
        normal_param((d, di + conv_ch + nh), generator, device, dtype),
        normal_param((mc.d_conv, conv_ch), generator, device, dtype, scale=0.5),
        zeros_param((conv_ch,), device, dtype),
        zeros_param((nh,), device, f32),
        ones_param((nh,), device, f32),
        zeros_param((nh,), device, f32),
        ones_param((di,), device, dtype),
        normal_param((di, d), generator, device, dtype))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv: ``x [B, T, C]``, ``w [K, C]`` -> ``(y [B, T,
    C]``, the new tail ``[B, K-1, C])``: the last K-1 inputs, the old tail's
    included when T < K-1.  Taps summed in the reference's order."""
    k, t = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xx = torch.cat([tail, x], dim=1)                     # [B, T+K-1, C]
    y = xx[:, 0:t] * w[0]
    for i in range(1, k):
        y = y + xx[:, i:i + t] * w[i]
    y = y + b
    new_tail = xx[:, t:] if k > 1 else torch.zeros_like(tail)
    return y, new_tail


def ssd_xla(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            D: torch.Tensor) -> torch.Tensor:
    """The scan from a zero state as plain differentiable torch ops, the
    reference's ``impl="xla"`` (``ssd_ref``): the chunked scan in float32
    (chunk ``min(128, T)``), ``+ D·x`` in float32, then cast to ``x``'s
    dtype."""
    xf = x.float()
    y, _ = ssd_ref.ssd_chunked(xf, dt, A, Bm, Cm,
                               min(ssd_ops.DEFAULT_CHUNK, x.shape[1]))
    return (y + D.float()[None, None, :, None] * xf).to(x.dtype)


def mamba2_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[Dict] = None, impl: str = "pallas",
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``x [B, T, d]`` -> ``(out [B, T, d], cache)``.  With a cache, the new
    conv tail and SSM state are written into its tensors in place, and the
    returned cache holds the same tensors.  Without one, ``impl`` picks
    the SSD kernel (``"pallas"``) or :func:`ssd_xla`."""
    check_impl(impl)
    mc = cfg.mamba
    b, t, d = x.shape
    di, nh = mc.d_inner(d), mc.nheads(d)
    g, s, hd = mc.ngroups, mc.d_state, mc.headdim

    z, xb, dt_raw = torch.split(dense(x, p.in_proj),
                                [di, di + 2 * g * s, nh], dim=-1)
    xb, new_tail = _causal_conv(xb, p.conv_w, p.conv_b,
                                cache["conv"] if cache is not None else None)
    xb = F.silu(xb)
    xs, Bm, Cm = torch.split(xb, [di, g * s, g * s], dim=-1)
    xs = xs.reshape(b, t, nh, hd)          # views of xb: the kernel reads them
    Bm = Bm.reshape(b, t, g, s)
    Cm = Cm.reshape(b, t, g, s)
    dt = F.softplus(dt_raw.float() + p.dt_bias)                  # [b, t, nh]
    A = -torch.exp(p.A_log)

    if cache is None and impl == "xla":
        y, new_cache = ssd_xla(xs, dt, A, Bm, Cm, p.D), None
    elif cache is None:
        refuse_grad("the SSD scan", xs, dt, Bm, Cm)
        y, _ = ssd_ops.ssd(xs, dt, A, Bm, Cm, p.D)
        new_cache = None
    else:
        if t > 1:       # prefill: the scan from the cached state
            y, state = ssd_ops.ssd(xs, dt, A, Bm, Cm, p.D,
                                   init_state=cache["ssm"])
        else:           # one step of the recurrence on the cached state
            rep = nh // g
            Bh = Bm[:, 0].float().repeat_interleave(rep, dim=1)  # [b, nh, s]
            Ch = Cm[:, 0].float().repeat_interleave(rep, dim=1)
            x0 = xs[:, 0].float()                                # [b, nh, hd]
            a = torch.exp(dt[:, 0] * A)                          # [b, nh]
            upd = (dt[:, 0, :, None] * Bh)[..., None] * x0[:, :, None, :]
            state = a[..., None, None] * cache["ssm"] + upd
            y = torch.einsum("bhs,bhsp->bhp", Ch, state)
            y = y + p.D[None, :, None] * x0
            y = y[:, None].to(x.dtype)                           # [b,1,nh,hd]
        cache["conv"].copy_(new_tail)
        cache["ssm"].copy_(state)
        new_cache = {"conv": cache["conv"], "ssm": cache["ssm"]}

    # gated RMSNorm (the Mamba-2 block's epilogue), eps 1e-6 in float32
    y = y.reshape(b, t, di) * F.silu(z)
    return dense(rms_norm(y, p.norm_w), p.out_proj), new_cache


def scan_chunk(b: int, di: int, s: int) -> int:
    """Time steps of one chunk of Mamba-1's scan over ``[b, ·, di, s]``."""
    return max(1, SCAN_BYTES // (SCAN_LIVE * 4 * b * di * s))


def _scan_(a: torch.Tensor, h: torch.Tensor) -> None:
    """The inclusive scan over axis 1 of the pairs ``(a_t, h_t)`` under
    ``(a1, h1) . (a2, h2) = (a1 a2, h2 + a2 h1)``, in place, in log2(T)
    steps: afterwards ``h_t`` is the state from a zero start and ``a_t``
    the product of ``a`` over ``[0, t]``, the reference's combine."""
    t, k = a.shape[1], 1
    while k < t:
        h[:, k:] += a[:, k:] * h[:, :-k]
        a[:, k:] = a[:, k:] * a[:, :-k]
        k *= 2


def _scan(a: torch.Tensor,
          h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_scan_` out of place (the same combine and steps), so
    autograd differentiates it: ``(a, h)`` scanned."""
    t, k = a.shape[1], 1
    while k < t:
        h = torch.cat([h[:, :k], h[:, k:] + a[:, k:] * h[:, :-k]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, h


def selective_scan(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   state: Optional[torch.Tensor] = None,
                   differentiable: bool = False,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1's recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
    ``y_t = C_t . h_t``, float32: ``dt, x [B, T, di]``, ``A [di, S]``,
    ``Bm, Cm [B, T, S]``, ``h_{-1} = state [B, di, S]`` (zero where None)
    -> ``(y [B, T, di], h_{T-1})``.  Chunk by chunk of :func:`scan_chunk`
    steps; a chunk's incoming state enters after its scan, ``h + a ·
    state``, as the reference's carried state does.  In place, or with
    ``differentiable`` out of place (:func:`_scan`)."""
    b, t, di = dt.shape
    lc = scan_chunk(b, di, A.shape[1])
    ys = []
    for c0 in range(0, t, lc):
        c = slice(c0, min(t, c0 + lc))
        h = (dt[:, c] * x[:, c])[..., None] * Bm[:, c, None, :]
        if differentiable:
            a, h = _scan(torch.exp(dt[:, c, :, None] * A), h)
            if state is not None:
                h = h + a * state[:, None]
        else:
            a = dt[:, c, :, None] * A
            a.exp_()                                      # [B, lc, di, S]
            _scan_(a, h)
            if state is not None:
                h.addcmul_(a, state[:, None])
        del a
        ys.append(torch.einsum("bts,btds->btd", Cm[:, c], h))
        state = h[:, -1] if differentiable else h[:, -1].clone()
        del h
    return torch.cat(ys, dim=1), state


def mamba1_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[Dict] = None, impl: str = "pallas",
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``x [B, T, d]`` -> ``(out [B, T, d], cache)``, the reference's
    ``mamba1_forward``: dt's product in the model dtype and then float32;
    the scan in float32; ``y + D·x`` cast to the model dtype before the
    ``silu(z)`` gate.  With a cache, the new conv tail and SSM state are
    written into its tensors in place, and the returned cache holds the
    same tensors.  ``impl="xla"`` scans out of place (differentiable),
    ``"pallas"`` in place; the function is the same."""
    check_impl(impl)
    mc = cfg.mamba
    b, t, d = x.shape
    di, s, r = mc.d_inner(d), mc.d_state, dt_rank(d)

    xs, z = dense(x, p.in_proj).chunk(2, dim=-1)
    xs, new_tail = _causal_conv(xs, p.conv_w, p.conv_b,
                                cache["conv"] if cache is not None else None)
    xs = F.silu(xs)
    dt_r, Bm, Cm = torch.split(dense(xs, p.x_proj), [r, s, s], dim=-1)
    dt = F.softplus(dense(dt_r, p.dt_proj).float() + p.dt_bias)  # [b, t, di]
    A = -torch.exp(p.A_log)                                       # [di, s]
    xf, Bm, Cm = xs.float(), Bm.float(), Cm.float()

    if cache is None or t > 1:
        y, state = selective_scan(dt, A, xf, Bm, Cm,
                                  cache["ssm"] if cache is not None else None,
                                  differentiable=impl == "xla")
    else:               # one step of the recurrence on the cached state
        a = torch.exp(dt[:, 0, :, None] * A)                      # [b, di, s]
        u = (dt[:, 0] * xf[:, 0])[..., None] * Bm[:, 0, None, :]
        state = a * cache["ssm"] + u
        y = torch.einsum("bs,bds->bd", Cm[:, 0], state)[:, None]
    if cache is None:
        new_cache = None
    else:
        cache["conv"].copy_(new_tail)
        cache["ssm"].copy_(state)
        new_cache = {"conv": cache["conv"], "ssm": cache["ssm"]}
    y = (y + p.D * xf).to(x.dtype) * F.silu(z)
    return dense(y, p.out_proj), new_cache


def mamba_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                  cache: Optional[Dict] = None, impl: str = "pallas",
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """:func:`mamba1_forward` or :func:`mamba2_forward` by the
    configuration's Mamba version, as the reference dispatches."""
    fn = mamba1_forward if cfg.mamba.version == 1 else mamba2_forward
    return fn(p, cfg, x, cache, impl)


def mamba_cache_shape(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device="cpu") -> Dict:
    """An empty cache of one layer, zeros: the conv tail ``[batch, K-1,
    C]`` in ``dtype`` and the SSM state float32, ``[batch, di, S]``
    (Mamba-1) or ``[batch, H, S, P]`` (Mamba-2)."""
    check_mamba(cfg)
    mc, d = cfg.mamba, cfg.d_model
    di = mc.d_inner(d)
    if mc.version == 1:
        conv_ch, ssm = di, (batch, di, mc.d_state)
    else:
        conv_ch = di + 2 * mc.ngroups * mc.d_state
        ssm = (batch, mc.nheads(d), mc.d_state, mc.headdim)
    return {"conv": torch.zeros((batch, mc.d_conv - 1, conv_ch), dtype=dtype,
                                device=device),
            "ssm": torch.zeros(ssm, dtype=torch.float32, device=device)}
