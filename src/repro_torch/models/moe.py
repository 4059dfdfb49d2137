"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

The reference's (``models/moe.py``): a float32 router picks each token's
``k`` experts by k iterated argmaxes (a tie goes to the lower expert id)
and renormalises their probabilities to sum to 1; a stable sort by expert
id ranks the ``n * k`` entries, and each expert keeps its first ``cap``
entries in token order (the rest go to an overflow slot that is dropped).
The kept tokens are gathered into ``[G, e, rows, d]`` blocks for the
batched expert products, and scatter-added back with their router weights
in the activation dtype.  ``dispatch_groups`` splits the tokens into G
groups, each dispatched on its own with its own capacity; ``dropless``
sets the capacity to the group's token count (every expert can take every
token), so the result does not depend on which tokens share a call.

Where ``cap`` exceeds ``TRIM_MIN_CAP``, the expert products run over the
first ``rows`` slots of each expert, ``rows`` being the fullest expert's
kept count (read to the host once a call), not over all ``cap``: the
slots past an expert's count hold no token, their products are zero rows
that the combine drops, so the function is the reference's.  Under
``dropless`` (``cap >= n``) that skips about ``1 - k/e`` of the
reference's expert work in a prefill.  At ``cap <= TRIM_MIN_CAP`` (a
decode tick: ``cap`` is the batch) every slot runs and nothing is read
back to the host.  The reference computes
the products as einsums and the dispatch with plain array ops, outside
any Pallas kernel, and so does the port (``torch.einsum``, indexing,
``torch.sort``, ``index_add_``).  Its GSPMD sharding constraints
(``group_axes``, ``combine_axes``) are not ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MoEConfig
from .common import normal_param
from .mlp import MLP, init_mlp


class MoE(nn.Module):
    """Weights in the reference's layout: ``router [d, e]`` (float32 in
    every model dtype), ``wi, wg [e, d, f]``, ``wo [e, f, d]``; ``shared``
    an :class:`MLP` of width ``(shared_ff or expert_ff) * num_shared``, or
    None."""

    def __init__(self, router: torch.Tensor, wi: torch.Tensor,
                 wg: torch.Tensor, wo: torch.Tensor,
                 shared: Optional[MLP] = None):
        super().__init__()
        if router.dtype != torch.float32:
            raise ValueError("the router is float32, not %s" % router.dtype)
        self.router = nn.Parameter(router, requires_grad=False)
        self.wi = nn.Parameter(wi, requires_grad=False)
        self.wg = nn.Parameter(wg, requires_grad=False)
        self.wo = nn.Parameter(wo, requires_grad=False)
        self.shared = shared


def init_moe(d_model: int, mo: MoEConfig,
             generator: Optional[torch.Generator], device, dtype) -> MoE:
    """The reference's distributions: every weight normal / sqrt(its first
    axis) (the experts' is ``e``), the router in float32."""
    e, f = mo.num_experts, mo.expert_ff
    router = normal_param((d_model, e), generator, device, torch.float32)
    w = [normal_param(shape, generator, device, dtype)
         for shape in ((e, d_model, f), (e, d_model, f), (e, f, d_model))]
    shared = (init_mlp(d_model, (mo.shared_ff or f) * mo.num_shared,
                       generator, device, dtype) if mo.num_shared else None)
    return MoE(router, *w, shared)


# Below this many slots an expert, the expert products are bound by their
# weights' bytes, not by their rows: over r rows a product does r
# operations (a multiply-add is 2) per byte of its bf16 weights, and an
# H100's ridge is 295 operations per byte (989 TFLOP/s over 3.35 TB/s).
# Trimming there would save no time and cost a host read.
TRIM_MIN_CAP = 256


def capacity(num_tokens: int, mo: MoEConfig) -> int:
    """Slots an expert has: ``ceil(n * k * capacity_factor / e)``, at least
    4, rounded up to a multiple of 4."""
    c = int(math.ceil(num_tokens * mo.top_k * mo.capacity_factor
                      / mo.num_experts))
    return max(4, -(-c // 4) * 4)


def dropless_capacity(num_tokens: int) -> int:
    """Slots an expert has under ``dropless``: every token, at least 4,
    rounded up to a multiple of 4."""
    return max(4, -(-num_tokens // 4) * 4)


def topk_router(probs: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k iterated argmaxes over the last axis: ``(weights [..., k], sel
    [..., k] int32)``, each pick masked out before the next; ties go to
    the first index."""
    p = probs
    ws, idxs = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        ws.append(torch.gather(p, -1, i))
        idxs.append(i)
        p = p.scatter(-1, i, float("-inf"))
    return torch.cat(ws, -1), torch.cat(idxs, -1).to(torch.int32)


def dispatch_group(xf: torch.Tensor, probs: torch.Tensor, k: int, e: int,
                   cap: int):
    """Sort-based dispatch of G token groups at once: ``xf [G, n, d]``,
    ``probs [G, n, e]`` -> ``(xe [G, e, rows, d], tok_for_slot [G, e*cap],
    w_for_slot [G, e*cap], sel [G, n, k])``.  Slot ``j * cap + i`` holds
    expert j's i-th kept token (-1 and weight 0 where none); ``rows`` is
    ``cap``, or above ``TRIM_MIN_CAP`` the fullest expert's kept count."""
    g, n, d = xf.shape
    dev = xf.device
    weights, sel = topk_router(probs, k)                        # [G, n, k]
    weights = weights / weights.sum(-1, keepdim=True)

    flat_e = sel.reshape(g, n * k).long()
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k).expand(
        g, n * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = flat_tok.gather(1, order)
    sw = weights.reshape(g, n * k).gather(1, order)
    counts = torch.zeros((g, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    pos = torch.arange(n * k, device=dev) - (counts.cumsum(1)
                                             - counts).gather(1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)           # overflow
    tok_for_slot = torch.full((g, e * cap + 1), -1, dtype=torch.long,
                              device=dev).scatter_(
        1, slot, torch.where(keep, st, -1))[:, :e * cap]
    w_for_slot = torch.zeros((g, e * cap + 1), dtype=sw.dtype,
                             device=dev).scatter_(
        1, slot, torch.where(keep, sw, 0.0))[:, :e * cap]

    rows = int(counts.clamp(max=cap).max()) if cap > TRIM_MIN_CAP else cap
    tok = tok_for_slot.view(g, e, cap)[:, :, :rows]
    xe = xf[torch.arange(g, device=dev)[:, None, None], tok.clamp(min=0)]
    xe = torch.where((tok >= 0)[..., None], xe, torch.zeros((), dtype=xf.dtype,
                                                            device=dev))
    return xe, tok_for_slot, w_for_slot, sel


def experts(p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """The batched expert products: ``xe [G, e, rows, d]`` -> ``[G, e,
    rows, d]``, each expert's SwiGLU in ``xe``'s dtype."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p.wg.to(xe.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", xe, p.wi.to(xe.dtype))
    return torch.einsum("gecf,efd->gecd", h, p.wo.to(xe.dtype))


def moe_forward(p: MoE, mo: MoEConfig, x: torch.Tensor,
                dropless: bool = False,
                dispatch_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, T, d]`` -> ``(y [B, T, d], aux)``, aux the float32
    load-balancing loss over all ``B*T`` tokens (the top-1 share of each
    expert times its mean probability, times ``e`` and
    ``aux_loss_weight``).  ``dispatch_groups`` falls back to 1 where it
    does not divide the tokens or leaves a group under 4."""
    b, t, d = x.shape
    n = b * t
    e, k = mo.num_experts, mo.top_k
    G = dispatch_groups
    if n % G or n // G < 4:
        G = 1
    ng = n // G
    cap = dropless_capacity(ng) if dropless else capacity(ng, mo)
    xf = x.reshape(n, d)
    probs = torch.softmax(torch.matmul(xf.float(), p.router), dim=-1)

    xe, tok_for_slot, w_for_slot, sel = dispatch_group(
        xf.view(G, ng, d), probs.view(G, ng, e), k, e, cap)
    rows = xe.shape[2]
    ye = experts(p, xe)

    # weighted combine, each group's dropped and empty slots into row ng
    tok = tok_for_slot.view(G, e, cap)[:, :, :rows]
    w = w_for_slot.view(G, e, cap)[:, :, :rows]
    src = ye * w[..., None].to(ye.dtype)
    dest = torch.where(tok >= 0, tok, ng) + (ng + 1) * torch.arange(
        G, device=x.device)[:, None, None]
    y = torch.zeros((G * (ng + 1), d), dtype=ye.dtype,
                    device=x.device).index_add_(0, dest.reshape(-1),
                                                src.reshape(-1, d))
    y = y.view(G, ng + 1, d)[:, :ng].reshape(n, d)
    if p.shared is not None:
        y = y + p.shared(xf).to(y.dtype)

    frac_tokens = F.one_hot(sel.reshape(n, k)[:, 0].long(), e).float().mean(0)
    aux = torch.sum(frac_tokens * probs.mean(0)) * e * mo.aux_loss_weight
    return y.reshape(b, t, d).to(x.dtype), aux
