"""Window management — the Aggregator's second half.

The paper (§4.4) uses count-based windows measured in *triples* but never
splits an RDF-graph event across windows: "DSCEP aggregates as many RDF
graphs that their sum of triples is a maximum of 1000 RDF triples".  This
module reproduces exactly that packing, generalized to sliding count
windows (``[RANGE TRIPLES n STEP m]``), plus time-based windows.

Sliding count windows factor through *slides*: the stream is greedily
packed graph by graph into slides of ``m`` triples, and window ``w`` is the
concatenation of slides ``w .. w + R - 1`` with ``R = ceil(n / m)``.  A
graph never splits across slides, and a graph larger than ``m`` is
truncated to ``m`` in a slide of its own.  When ``m`` does not divide ``n``
the window capacity rounds up to ``R * m``.  ``STEP >= RANGE`` (or no STEP)
is tumbling: one slide per window, the single-level packing bit for bit.

The greedy packing is inherently sequential over graphs (the reference runs
it as a ``lax.scan``).  Here it runs on the host with numpy from the graph
sizes — the chunk's graph/valid/ts columns come to the host once per chunk
— and only row placements go back to the device.  Incremental (delta)
evaluation skips the window materialization: :class:`SlideView` keeps the
per-row slide assignment so the engine can evaluate the whole chunk once
and select each window's rows by slide-span intervals
(``engine.run_plan_slides``).
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


class SlideView(NamedTuple):
    """Slide-level view of a merged stream (sliding count windows).

    Produced by :func:`count_slides`; consumed by
    :func:`windows_from_slides` (overlapping windows for per-window
    recompute) or by ``engine.run_plan_slides`` (incremental evaluation).
    """

    stream: TripleBatch          # merged, ts-ordered stream [n]
    slide_of_row: torch.Tensor   # [n] int64 — slide ordinal, -1 = dropped
    slide_col: torch.Tensor      # [n] int64 — position of the row in its slide
    slide_valid: torch.Tensor    # [S] bool — slides holding >= 1 triple
    slide_ts: torch.Tensor       # [S] int64 — max ts per slide (0 when empty)

    @property
    def num_slides(self) -> int:
        return int(self.slide_valid.shape[0])


def window_slides(window_capacity: int,
                  step: Optional[int] = None) -> Tuple[int, int]:
    """Resolve ``STEP`` geometry to ``(slide_capacity, slides_per_window)``:
    tumbling (one slide of the full capacity) when ``step`` is None or
    ``>= window_capacity``, else slides of ``step`` triples and ``R =
    ceil(window_capacity / step)`` of them per window."""
    if step is None or step >= window_capacity:
        return window_capacity, 1
    if step < 1:
        raise ValueError("window step must be >= 1, got %d" % step)
    return step, -(-window_capacity // step)


def _pack_rows(graph: np.ndarray, valid: np.ndarray, capacity: int,
               max_units: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy graph-preserving packing of an ordered stream into
    capacity-bounded units (windows or slides), on the host.

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


def count_slides(stream: TripleBatch, window_capacity: int, max_windows: int,
                 step: Optional[int] = None) -> SlideView:
    """Pack the stream into ``max_windows + R - 1`` slides of ``step``
    triples (paper §4.4 packing at slide granularity)."""
    slide_cap, r = window_slides(window_capacity, step)
    num_slides = max_windows + r - 1
    graph = stream.graph.cpu().numpy()
    valid = stream.valid.cpu().numpy()
    ts = stream.ts.cpu().numpy()
    sid, col, ok = _pack_rows(graph, valid, slide_cap, num_slides)
    placed = sid[ok]
    slide_valid = np.bincount(placed, minlength=num_slides) > 0
    # max ts per slide; an empty slide keeps 0, the ts recompute gives an
    # empty window
    slide_ts = np.zeros(num_slides, np.int64)
    np.maximum.at(slide_ts, placed, ts[ok])
    dev = stream.valid.device
    return SlideView(
        stream=stream,
        slide_of_row=torch.from_numpy(np.where(ok, sid, -1)).to(dev),
        slide_col=torch.from_numpy(np.where(ok, col, 0)).to(dev),
        slide_valid=torch.from_numpy(slide_valid).to(dev),
        slide_ts=torch.from_numpy(slide_ts).to(dev),
    )


def windows_from_slides(view: SlideView, window_capacity: int,
                        max_windows: int,
                        step: Optional[int] = None) -> Windows:
    """Materialize overlapping windows: window ``w`` = slides ``w..w+R-1``.

    The window capacity is ``R * slide_capacity`` (the window capacity when
    STEP divides RANGE, rounded up otherwise); rows repeat across the up to
    ``R`` windows sharing each slide.
    """
    slide_cap, r = window_slides(window_capacity, step)
    num_slides = max_windows + r - 1
    dev = view.slide_of_row.device
    ok = view.slide_of_row >= 0
    dump = num_slides * slide_cap
    target = torch.where(ok, view.slide_of_row * slide_cap + view.slide_col,
                         torch.full_like(view.slide_col, dump))
    rows = torch.arange(ok.shape[0], device=dev)
    slot = torch.full((dump + 1,), -1, dtype=torch.int64, device=dev)
    # placed rows have distinct targets; only the dropped ones share the
    # dump slot, which is cut off
    slot.scatter_(0, target, torch.where(ok, rows, torch.full_like(rows, -1)))
    slide_idx = slot[:dump].view(num_slides, slide_cap)
    widx = (torch.arange(max_windows, device=dev)[:, None]
            + torch.arange(r, device=dev)[None, :])                  # [W, R]
    gather_idx = slide_idx[widx].reshape(max_windows, r * slide_cap)
    window_valid = view.slide_valid[widx].any(dim=1)
    return Windows(take_rows(view.stream, gather_idx), window_valid)


def count_windows(stream: TripleBatch, window_capacity: int, max_windows: int,
                  step: Optional[int] = None) -> Windows:
    """Greedy graph-preserving count windows (paper §4.4).

    Without ``step`` (or ``step >= window_capacity``) windows tumble as the
    paper describes.  With ``step < window_capacity`` they overlap: the
    stream packs into slides of ``step`` triples and each window holds
    ``ceil(window_capacity / step)`` consecutive slides.
    """
    _, r = window_slides(window_capacity, step)
    if r > 1:
        view = count_slides(stream, window_capacity, max_windows, step)
        return windows_from_slides(view, window_capacity, max_windows, step)
    graph = stream.graph.cpu().numpy()
    valid = stream.valid.cpu().numpy()
    wid, col, ok = _pack_rows(graph, valid, window_capacity, max_windows)
    idx = _scatter_units(wid, col, ok, window_capacity, max_windows)
    wt = take_rows(stream, torch.from_numpy(idx).to(stream.valid.device))
    return Windows(wt, wt.valid.any(dim=-1))


def time_windows(stream: TripleBatch, t0: int, width: int, slide: int,
                 window_capacity: int, max_windows: int) -> Windows:
    """Time-based windows ``[t0 + w*slide, t0 + w*slide + width)``.

    Sliding windows (``slide < width``) repeat rows across overlapping
    windows; tumbling windows are ``slide == width``.  Row placement per
    window keeps stream order; rows past the capacity are dropped (bounded
    buffer).  All windows are placed by one batched scatter.
    """
    n = stream.capacity
    dev = stream.valid.device
    # the reference compares int32 views of the uint32 timestamps
    ts = torch.where(stream.ts >= (1 << 31), stream.ts - (1 << 32), stream.ts)
    lo = t0 + torch.arange(max_windows, dtype=torch.int64, device=dev) * slide
    inw = (stream.valid[None, :] & (ts[None, :] >= lo[:, None])
           & (ts[None, :] < (lo + width)[:, None]))                   # [W, n]
    pos = torch.cumsum(inw.to(torch.int64), dim=1) - 1
    tgt = torch.where(inw & (pos < window_capacity), pos,
                      torch.full_like(pos, window_capacity))
    src = torch.where(inw, torch.arange(n, device=dev)[None, :],
                      torch.full_like(pos, -1))
    idx = torch.full((max_windows, window_capacity + 1), -1,
                     dtype=torch.int64, device=dev)
    # member rows have distinct targets; the rest share the cut-off column
    idx.scatter_(1, tgt, src)
    return Windows(take_rows(stream, idx[:, :window_capacity]), inw.any(dim=1))
