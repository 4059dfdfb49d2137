"""Public closure wrappers: padded transitive closure and closure sets.

``closure_step`` / ``descendants_step`` dispatch on the matrix's device: a
CUDA tensor launches the kernel (or raises), a CPU tensor takes the plain
version in ``ref.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import kernel, ref


def closure_step(reach: torch.Tensor) -> torch.Tensor:
    if reach.is_cuda:
        return kernel.closure_step_cuda(reach)
    return ref.closure_step_ref(reach)


def descendants_step(reach: torch.Tensor, rootcol: torch.Tensor,
                     out_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if reach.is_cuda:
        return kernel.descendants_cuda(reach, rootcol, out_cap)
    return ref.descendants_step_ref(reach, rootcol, out_cap)


def _steps(n: int, max_depth) -> int:
    return max(1, int(np.ceil(np.log2(max(2, max_depth or n)))))


def _reach(adj, block: int, device) -> torch.Tensor:
    """``min(adj + I, 1)`` as float32 on ``device``, zero-padded to a
    multiple of ``block`` (padding rows/columns reach nothing)."""
    if not torch.is_tensor(adj):
        adj = torch.from_numpy(np.ascontiguousarray(adj, np.float32))
    a = adj.to(device=device, dtype=torch.float32)
    n = a.shape[0]
    reach = torch.clamp_max(a + torch.eye(n, device=a.device), 1.0)
    rem = (-n) % block
    if rem:
        reach = torch.nn.functional.pad(reach, (0, rem, 0, rem))
    return reach.contiguous()


def transitive_closure(adj, max_depth: int | None = None, block: int = 128,
                       device="cpu") -> torch.Tensor:
    """Reflexive-transitive closure of ``adj`` (0/1) as a bool ``[n, n]``:
    ``log2(max_depth)`` squaring steps."""
    n = adj.shape[0]
    reach = _reach(adj, block, device)
    for _ in range(_steps(n, max_depth)):
        reach = closure_step(reach)
    return reach[:n, :n] > 0.5


def closure_descendants(adj, root: int, out_cap: int,
                        max_depth: int | None = None, block: int = 128,
                        device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Descendant set of node ``root``: ``steps - 1`` squarings, then the
    fused final step.  Returns ``(ids [out_cap] int32, count [] int32)``;
    ``count > out_cap`` means the id list was clipped.  Padding rows never
    reach ``root``, so ids stay below n."""
    n = adj.shape[0]
    reach = _reach(adj, block, device)
    for _ in range(_steps(n, max_depth) - 1):
        reach = closure_step(reach)
    return descendants_step(reach, reach[:, root], out_cap)


def closure_ancestors(adj, root: int, out_cap: int,
                      max_depth: int | None = None, block: int = 128,
                      device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestor set of ``root``: the descendants computation on the
    transposed adjacency."""
    a = adj.T if torch.is_tensor(adj) else np.asarray(adj).T
    return closure_descendants(a, root, out_cap, max_depth=max_depth,
                               block=block, device=device)
