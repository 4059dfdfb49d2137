"""Mamba-2 mixer (SSD) with and without a decode cache.

The three branches of the reference's ``mamba2_forward``:

* no cache (``lm.forward``): the SSD scan from a zero state;
* a cached prefill (T > 1): the SSD scan from the cached state, which
  emits the final state (the reference runs its plain ``ssd_ref`` with
  ``init_state`` here; the port takes the same function through the
  kernel, so no prefill steps token by token);
* one new token: the plain one-step recurrence on the cached state (the
  reference has no kernel there either).

The cache of one layer is ``{"conv": [B, K-1, C]`` in the model dtype
(the causal conv's last K-1 inputs, C = d_inner + 2·G·S), ``"ssm": [B, H,
S, P]`` float32``}``; :func:`mamba2_forward` writes the new tail and
state into those tensors in place.  The continuous batcher's slot lanes
are the batch rows; its launcher zeroes a lane before the lane's prefill
(``launch/serve.py``), so that prefill's SSD scan runs from a zero state.  Mamba-1 (Jamba) raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, not_ported
from ..kernels.ssd import ops as ssd_ops
from .common import dense, normal_param, ones_param, rms_norm, zeros_param

# the reference's parameter names, in Mamba's argument order; the three
# per-head vectors stay float32 whatever the model dtype
LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
          "out_proj")
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


class Mamba(nn.Module):
    """Weights in the reference's layout: ``in_proj [d, 2·di + 2·G·S + H]``
    (z, then x·B·C, then dt), ``conv_w [K, C]``, ``conv_b [C]``, ``A_log,
    D, dt_bias [H]`` float32, ``norm_w [di]``, ``out_proj [di, d]``."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w,
                 out_proj):
        super().__init__()
        for name, t in zip(LEAVES, (in_proj, conv_w, conv_b, A_log, D,
                                    dt_bias, norm_w, out_proj)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def check_mamba(cfg: ModelConfig) -> None:
    if cfg.mamba is None:
        raise ValueError("%s has a Mamba layer but no MambaConfig" % cfg.name)
    if cfg.mamba.version != 2:
        raise not_ported("Mamba-%d (%s)" % (cfg.mamba.version, cfg.name),
                         "Other LM architectures")


def init_mamba(cfg: ModelConfig, generator: Optional[torch.Generator],
               device, dtype) -> Mamba:
    """The reference's distributions: projections normal / sqrt(fan_in),
    ``conv_w`` normal * 0.5, ``A_log``, ``dt_bias`` and ``conv_b`` 0, ``D``
    and ``norm_w`` 1."""
    check_mamba(cfg)
    mc, d = cfg.mamba, cfg.d_model
    di, nh = mc.d_inner(d), mc.nheads(d)
    conv_ch = di + 2 * mc.ngroups * mc.d_state
    f32 = torch.float32
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


def mamba2_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[Dict] = None,
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``x [B, T, d]`` -> ``(out [B, T, d], cache)``.  With a cache, the new
    conv tail and SSM state are written into its tensors in place, and the
    returned cache holds the same tensors."""
    check_mamba(cfg)
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

    if cache is None:
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


def mamba_cache_shape(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device="cpu") -> Dict:
    """An empty cache of one layer: the conv tail ``[batch, K-1, C]`` in
    ``dtype`` and the SSM state ``[batch, H, S, P]`` float32, zeros."""
    check_mamba(cfg)
    mc, d = cfg.mamba, cfg.d_model
    conv_ch = mc.d_inner(d) + 2 * mc.ngroups * mc.d_state
    return {"conv": torch.zeros((batch, mc.d_conv - 1, conv_ch), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, mc.nheads(d), mc.d_state, mc.headdim),
                               dtype=torch.float32, device=device)}
