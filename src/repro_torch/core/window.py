"""Window management — the Aggregator's second half (tumbling count windows).

The paper (§4.4) uses count-based windows measured in *triples* but never
splits an RDF-graph event across windows: "DSCEP aggregates as many RDF
graphs that their sum of triples is a maximum of 1000 RDF triples".  This
module reproduces exactly that greedy packing for tumbling windows; sliding
windows (``STEP < RANGE``) and time windows are not ported yet.

The greedy packing is inherently sequential over graphs (the reference runs
it as a ``lax.scan``).  Here it runs on the host with numpy from the graph
sizes — the chunk's graph/valid columns come to the host once per chunk —
and only the dense ``[W, C]`` gather indices go back to the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .rdf import TripleBatch, take_rows


class Windows(NamedTuple):
    """A batch of triple windows: every field is ``[W, C]``."""

    triples: TripleBatch
    window_valid: torch.Tensor   # [W] bool — windows holding >= 1 event

    @property
    def num_windows(self) -> int:
        return int(self.window_valid.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.triples.s.shape[-1])


def _pack_rows(graph: np.ndarray, valid: np.ndarray, capacity: int,
               max_units: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy graph-preserving packing of an ordered stream into
    capacity-bounded units (host side).

    Graph events are contiguous runs of equal ``graph`` id among valid rows
    (invalid rows sit at the tail); a graph moves to the next unit when it
    would overflow the current one, and a graph larger than ``capacity`` is
    truncated to ``capacity`` in a unit of its own.  Returns ``(unit, col,
    ok)`` per row.
    """
    n = len(graph)
    idx = np.arange(n)
    prev_g = np.concatenate([graph[:1], graph[:-1]])
    new_graph = ((idx == 0) | (graph != prev_g)) & valid
    graph_idx = np.where(valid, np.cumsum(new_graph) - 1, -1)
    starts = np.flatnonzero(new_graph)
    sizes = np.bincount(graph_idx[valid], minlength=len(starts))
    graph_unit = np.zeros(len(starts), np.int64)
    graph_off = np.zeros(len(starts), np.int64)
    fill, unit = 0, 0
    for g, size in enumerate(sizes.tolist()):
        size_c = min(size, capacity)
        if fill + size_c > capacity:
            unit += 1
            graph_off[g] = 0
            fill = size_c
        else:
            graph_off[g] = fill
            fill += size_c
        graph_unit[g] = unit
    gi = np.maximum(graph_idx, 0)
    if len(starts):
        start_of_row = starts[gi]
        wid = np.where(graph_idx >= 0, graph_unit[gi], -1)
        off = np.where(graph_idx >= 0, graph_off[gi], 0)
    else:
        start_of_row = np.zeros(n, np.int64)
        wid = np.full(n, -1, np.int64)
        off = np.zeros(n, np.int64)
    col = off + (idx - start_of_row)
    ok = valid & (wid >= 0) & (wid < max_units) & (col < capacity)
    return wid, col, ok


def _scatter_units(unit: np.ndarray, col: np.ndarray, ok: np.ndarray,
                   capacity: int, max_units: int) -> np.ndarray:
    """Row placement -> dense ``[max_units, capacity]`` gather indices
    (-1 = empty slot).  Placed rows have distinct targets."""
    slot = np.full(max_units * capacity, -1, np.int64)
    rows = np.flatnonzero(ok)
    slot[unit[rows] * capacity + col[rows]] = rows
    return slot.reshape(max_units, capacity)


def count_windows(stream: TripleBatch, window_capacity: int, max_windows: int,
                  step: Optional[int] = None) -> Windows:
    """Greedy graph-preserving tumbling count windows (paper §4.4)."""
    if step is not None and step < window_capacity:
        raise NotImplementedError(
            "sliding count windows (STEP < RANGE) are ROADMAP queue 1, "
            "'Incremental evaluation' (window slides)")
    graph = stream.graph.cpu().numpy()
    valid = stream.valid.cpu().numpy()
    wid, col, ok = _pack_rows(graph, valid, window_capacity, max_windows)
    idx = _scatter_units(wid, col, ok, window_capacity, max_windows)
    wt = take_rows(stream, torch.from_numpy(idx).to(stream.valid.device))
    return Windows(wt, wt.valid.any(dim=-1))
