"""Triple patterns and binding tables (the engine's relations).

A *compiled* plan fixes the variable universe: every variable gets a column
in a fixed-width binding table.  ``PAD_ID`` (0) doubles as SPARQL's
*unbound* value, which makes OPTIONAL's outer join an elementwise maximum.

Binding tables carry a leading window dimension ``W`` written out (the
engine runs every window of a chunk in one batched op): ``cols [W, cap,
nv]`` int64 (uint32 values), ``valid [W, cap]`` bool, ``overflow [W]``
bool.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Tuple

import torch

from .rdf import ID_DTYPE


class SlotMode(enum.IntEnum):
    CONST = 0       # slot is a fixed term id
    BOUND = 1       # slot is a variable already bound at this plan step
    FREE = 2        # slot is a variable first bound by this pattern


@dataclasses.dataclass(frozen=True)
class Slot:
    mode: SlotMode
    const: int = 0      # term id when CONST
    var: int = -1       # variable column when BOUND/FREE

    @staticmethod
    def const_(term_id: int) -> "Slot":
        return Slot(SlotMode.CONST, const=int(term_id))

    @staticmethod
    def bound(var_col: int) -> "Slot":
        return Slot(SlotMode.BOUND, var=int(var_col))

    @staticmethod
    def free(var_col: int) -> "Slot":
        return Slot(SlotMode.FREE, var=int(var_col))


@dataclasses.dataclass(frozen=True)
class CompiledPattern:
    """One triple pattern with slot modes resolved against the plan state."""

    s: Slot
    p: Slot
    o: Slot

    def free_vars(self) -> Tuple[int, ...]:
        return tuple(
            sl.var for sl in (self.s, self.p, self.o) if sl.mode == SlotMode.FREE
        )

    def predicates(self) -> Tuple[int, ...]:
        return (self.p.const,) if self.p.mode == SlotMode.CONST else ()


class Bindings(NamedTuple):
    """Fixed-capacity solution-mapping tables, one per window.

    ``overflow`` — capacity was exceeded somewhere upstream, so the result
    is a (deterministic, prefix-preserving) under-approximation.
    """

    cols: torch.Tensor      # [W, cap, nv]
    valid: torch.Tensor     # [W, cap]
    overflow: torch.Tensor  # [W]

    @property
    def capacity(self) -> int:
        return int(self.cols.shape[-2])

    @property
    def num_vars(self) -> int:
        return int(self.cols.shape[-1])

    @property
    def num_windows(self) -> int:
        return int(self.cols.shape[0])

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


def empty_bindings(num_windows: int, capacity: int, num_vars: int,
                   device="cpu") -> Bindings:
    return Bindings(
        cols=torch.zeros((num_windows, capacity, num_vars), dtype=ID_DTYPE,
                         device=device),
        valid=torch.zeros((num_windows, capacity), dtype=torch.bool,
                          device=device),
        overflow=torch.zeros((num_windows,), dtype=torch.bool, device=device),
    )


def universe_bindings(num_windows: int, capacity: int, num_vars: int,
                      device="cpu") -> Bindings:
    """A single all-unbound solution per window (the BGP identity)."""
    b = empty_bindings(num_windows, capacity, num_vars, device)
    b.valid[:, 0] = True
    return b


def compact_index(mask: torch.Tensor, out_cap: int):
    """Order-preserving compaction indices of ``mask [W, n]``.

    Returns ``(src [W, out_cap] int64, valid [W, out_cap], overflow [W])``:
    ``src[w, k]`` is the index of the k-th set entry of ``mask[w]`` (clamped
    to a safe 0 past the count), so callers gather only the ``out_cap``
    winners instead of materializing every candidate row.
    """
    w, n = mask.shape
    # one flat scan, rebased per row: PyTorch's CUDA cumsum along the last
    # dim of a few very long rows runs one slow row scan each, while a 1-D
    # cumsum is a device-wide scan
    flat = torch.cumsum(mask.reshape(-1), dim=0, dtype=torch.int64).view(w, n)
    cum = flat - (flat[:, :1] - mask[:, :1].to(torch.int64)) if n else flat
    total = cum[:, -1] if n else torch.zeros((w,), dtype=torch.int64,
                                             device=mask.device)
    k = torch.arange(out_cap, device=mask.device, dtype=torch.int64)
    valid = k[None, :] < total.clamp(max=out_cap)[:, None]
    if n:
        src = torch.searchsorted(cum, (k + 1).expand(w, out_cap).contiguous())
        src = torch.where(valid, src, torch.zeros_like(src))
    else:
        src = torch.zeros((w, out_cap), dtype=torch.int64, device=mask.device)
    return src, valid, total > out_cap


def gather_rows(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``rows [W, n, ...]`` gathered at ``src [W, k]`` -> ``[W, k, ...]``."""
    w = rows.shape[0]
    return rows[torch.arange(w, device=rows.device)[:, None], src]


def compact_rows(
    rows: torch.Tensor, mask: torch.Tensor, out_cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Order-preserving compaction of masked ``[W, n, ...]`` rows.

    Returns ``(rows_out [W, out_cap, ...], valid [W, out_cap], overflow
    [W])``; slots past the count are zero.
    """
    src, valid, overflow = compact_index(mask, out_cap)
    out = gather_rows(rows, src)
    vshape = valid.shape + (1,) * (rows.dim() - 2)
    out = torch.where(valid.view(vshape), out, torch.zeros_like(out))
    return out, valid, overflow
