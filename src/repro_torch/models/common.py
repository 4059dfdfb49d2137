"""Shared model primitives: RMSNorm, the non-parametric LayerNorm, RoPE
and Qwen2-VL's M-RoPE, the dense projection, init.

Rounding follows the reference: norms and RoPE compute in float32 and
round back to the input's dtype; :func:`dense` casts the weight to the
input's dtype and adds the bias in that dtype.

``impl`` picks the attention and SSD path, as the reference's does:
``"pallas"`` dispatches to the kernels (the CUDA kernels on CUDA tensors,
their plain versions on the CPU), ``"xla"`` runs plain differentiable
torch ops (the reference's einsum attention and plain scan).  The caller
chooses; nothing switches on its own.  No kernel has a backward, nor has
the reference's Pallas path, so asking for gradients through
``"pallas"`` raises (:func:`refuse_grad`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
IMPLS = ("xla", "pallas")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError("impl is one of %s, not %r" % (IMPLS, impl))


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a graph through a kernel: the
    kernels (and the reference's Pallas kernels) have no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "%s under impl='pallas' has no backward (nor has the "
            "reference's Pallas kernel): train with impl='xla', or run the "
            "kernel path under torch.no_grad()" % what)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE of ``x [B, T, H, D]`` at ``positions [3,
    B, T]`` (temporal, height, width), in float32: the D/2 frequencies
    split into ``sections``, section s rotated by position stream s, the
    halves then rotated as :func:`apply_rope` does.  Three equal streams
    give :func:`apply_rope`'s values."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError("M-RoPE sections %s do not sum to half of head dim "
                         "%d" % (tuple(sections), d))
    freqs = torch.split(rope_freqs(d, theta, x.device), list(sections))
    ang = torch.cat([positions[s].float()[..., None] * f
                     for s, f in enumerate(freqs)], dim=-1)[..., None, :]
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
