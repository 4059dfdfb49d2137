"""Plain PyTorch version of the flash-attention kernel: GQA scaled dot
product attention with causal and sliding-window masks, softmax in
float32."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """``q [B, Hq, Tq, D]``, ``k [B, Hk, Tk, D]``, ``v [B, Hk, Tk, Dv]`` ->
    ``[B, Hq, Tq, Dv]`` in ``q``'s dtype, scaled by ``1/sqrt(D)`` (MLA's
    value width Dv may differ from D).  Query row ``i`` sits at absolute
    position ``q_offset + i``; key ``j`` at ``j``.  Causal keeps keys ``j
    <= pos``, a window keeps ``j > pos - window``.  A row with no live key
    is 0."""
    b, hq, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError("query heads %d are not a multiple of KV heads %d"
                         % (hq, hk))
    group = hq // hk
    kg = k.repeat_interleave(group, dim=1).float()
    vg = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kg) / (d ** 0.5)
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # rows with no live key
    return torch.einsum("bhqk,bhkd->bhqd", probs, vg).to(q.dtype)
