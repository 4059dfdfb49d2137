"""Plain PyTorch version of the decode-attention kernel: one query row
per sequence against the live rows of a KV cache."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """``q [B, Hq, 1, D]``, ``k [B, Hk, S, D]``, ``v [B, Hk, S, Dv]``,
    ``lengths [B]`` -> ``[B, Hq, 1, Dv]`` in ``q``'s dtype, scaled by
    ``1/sqrt(D)``.  Sequence b attends to the cache
    rows ``[max(0, lengths[b] - window), min(lengths[b], S))`` (from row 0
    without a window): the query sits at position ``lengths[b] - 1`` and
    a window keeps keys ``kpos > qpos - window``.  0 where no row is
    live."""
    b, hq, tq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError("query heads %d are not a multiple of KV heads %d"
                         % (hq, hk))
    qf = q.reshape(b, hk, hq // hk, tq, d).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float()) / (d ** 0.5)
    kpos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.to(q.device).long()[:, None]
    live = kpos < lens
    if window is not None:
        live &= kpos >= lens - window
    mask = live[:, None, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.where(mask, torch.softmax(logits, dim=-1),
                        torch.zeros_like(logits))
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(b, hq, tq, v.shape[-1]).to(q.dtype)
