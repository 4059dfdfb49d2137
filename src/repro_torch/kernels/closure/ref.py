"""Plain PyTorch versions of the closure kernels and the full oracles."""
from __future__ import annotations

from typing import Tuple

import torch


def closure_step_ref(reach: torch.Tensor) -> torch.Tensor:
    """One repeated-squaring step: ``min(R @ R, 1)`` (exact on 0/1 input)."""
    r = reach.to(torch.float32)
    return torch.clamp_max(r @ r, 1.0).to(reach.dtype)


def descendants_step_ref(reach: torch.Tensor, rootcol: torch.Tensor,
                         out_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused last squaring for one root column: ascending rows with
    ``min(reach @ rootcol, 1) > 0.5``, zero-padded/clipped to ``out_cap``,
    and their count."""
    mask = torch.clamp_max(reach @ rootcol, 1.0) > 0.5
    rows = torch.nonzero(mask).flatten().to(torch.int32)
    ids = torch.zeros((out_cap,), dtype=torch.int32, device=reach.device)
    k = min(out_cap, rows.numel())
    ids[:k] = rows[:k]
    return ids, mask.sum().to(torch.int32)


def closure_ref(adj: torch.Tensor, steps: int) -> torch.Tensor:
    n = adj.shape[-1]
    reach = torch.clamp_max(
        adj.to(torch.float32) + torch.eye(n, device=adj.device), 1.0)
    for _ in range(steps):
        reach = torch.clamp_max(reach @ reach, 1.0)
    return reach


def descendants_ref(adj: torch.Tensor, root: int, steps: int, out_cap: int):
    """Oracle for the fused descendant extraction over ``steps`` squarings."""
    reach = closure_ref(adj, steps)
    mask = reach[:, root] > 0.5
    rows = torch.nonzero(mask).flatten().to(torch.int32)
    ids = torch.zeros((out_cap,), dtype=torch.int32, device=adj.device)
    k = min(out_cap, rows.numel())
    ids[:k] = rows[:k]
    return ids, mask.sum().to(torch.int32)
