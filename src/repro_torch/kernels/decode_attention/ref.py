"""Plain PyTorch version of the decode-attention kernel: one query row
per sequence against the first ``lengths[b]`` rows of a KV cache."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """``q [B, Hq, 1, D]``, ``k, v [B, Hk, S, D]``, ``lengths [B]`` ->
    ``[B, Hq, 1, D]`` in ``q``'s dtype; 0 where the length is 0."""
    b, hq, tq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError("query heads %d are not a multiple of KV heads %d"
                         % (hq, hk))
    qf = q.reshape(b, hk, hq // hk, tq, d).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float()) / (d ** 0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.where(mask, torch.softmax(logits, dim=-1),
                        torch.zeros_like(logits))
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(b, hq, tq, d).to(q.dtype)
