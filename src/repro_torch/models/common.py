"""Shared model primitives: RMSNorm, the non-parametric LayerNorm, RoPE,
the dense projection, init.

Rounding follows the reference: norms and RoPE compute in float32 and
round back to the input's dtype; :func:`dense` casts the weight to the
input's dtype and adds the bias in that dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is visible (the LM entry points default to the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r asked for, but no CUDA device is visible; pass "
            "device='cpu' to run the plain PyTorch versions" % str(device))
    return dev


# --------------------------------------------------------------------------
# init: the reference's distributions (weights from a torch.Generator)
# --------------------------------------------------------------------------

def normal_param(shape: Sequence[int], generator: Optional[torch.Generator],
                 device, dtype, scale: Optional[float] = None) -> torch.Tensor:
    """``normal * scale`` drawn in float32, then cast; the default scale is
    ``1 / sqrt(fan_in)`` with fan_in the first axis (the last for a
    vector), as the reference's ``param``."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def zeros_param(shape: Sequence[int], device, dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape), device=device, dtype=dtype)


def ones_param(shape: Sequence[int], device, dtype) -> torch.Tensor:
    return torch.ones(tuple(shape), device=device, dtype=dtype)


# --------------------------------------------------------------------------
# norms, RoPE, projections
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's LayerNorm without scale or bias: the mean and the population
    variance of the last axis, in float32."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


NORMS = ("rmsnorm", "layernorm_nonparam")


def apply_norm(kind: str, x: torch.Tensor,
               weight: Optional[torch.Tensor]) -> torch.Tensor:
    """The configuration's norm: ``rmsnorm`` (with ``weight``) or
    ``layernorm_nonparam`` (no weight)."""
    if kind == "rmsnorm":
        return rms_norm(x, weight)
    if kind == "layernorm_nonparam":
        return layer_norm_nonparam(x)
    raise ValueError(kind)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Half-split rotary embedding of ``x [..., T, H, D]`` (or ``[..., T,
    D]``) at ``positions [..., T]``, in float32."""
    d = x.shape[-1]
    ang = positions.float()[..., None] * rope_freqs(d, theta, x.device)
    if x.dim() == ang.dim() + 1:                       # [..., T, H, D]
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` with ``w [d_in, d_out]`` cast to ``x``'s dtype, plus the
    bias in that dtype."""
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out
