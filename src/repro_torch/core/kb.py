"""Partitioned background knowledge base (the paper's central object).

* :class:`KnowledgeBase` — an immutable sorted triple store with two probe
  views (``(p,s)``-sorted and ``(p,o)``-sorted) so lookups cost O(log N)
  binary search + bounded gather instead of an O(N) scan.  The views are
  sorted on the host with numpy at plan time and moved to the device once.
* ``prune`` — plan-time used-KB extraction by predicate/object signature.
* ``pad_to`` — capacity padding (pads carry the max sort key).
* ``shard_rows`` / ``row_block`` — the row-block layout a KB is divided
  into across devices (``core.kb_dist``).

Two access methods mirror the paper's two measured methods: ``scan``
(C-SPARQL KB access: the whole attached slice per join) and ``probe``
(SPARQL subquery/SERVICE: indexed lookups, independent of unused rows).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .rdf import PRED_SPACE, TERM_BITS, TERM_SPACE, NUM_BASE, U32_MAX, to_u32_bits


class _KBArrays(NamedTuple):
    s_ps: torch.Tensor
    p_ps: torch.Tensor
    o_ps: torch.Tensor
    key_ps: torch.Tensor   # composite (p << TERM_BITS) | enc(s)
    s_po: torch.Tensor
    p_po: torch.Tensor
    o_po: torch.Tensor
    key_po: torch.Tensor   # composite (p << TERM_BITS) | enc(o)
    valid: torch.Tensor    # [N] bool (same count in both views; pads sort last)


class KnowledgeBase(_KBArrays):
    """Immutable KB partition.  All row arrays share shape ``[N]``.

    ``*_ps`` arrays are row-sorted by the composite key ``(p, s)``; ``*_po``
    by ``(p, o)``.  Both views store full rows (s, p, o).
    """

    @functools.cached_property
    def words(self) -> _KBArrays:
        """The same arrays with every id column as int32 words holding the
        uint32 bits, as the CUDA kernels read them (``valid`` is shared).
        Built on first use and kept with the KB, so a join does not convert
        the whole KB again."""
        return _KBArrays(*(c if c.dtype == torch.bool else
                           to_u32_bits(c).contiguous() for c in self))

    @functools.cached_property
    def fences(self) -> "Fences":
        """Every ``2**shift``-th key of each sorted view, as int32 words
        padded with ``0xFFFFFFFF`` to a multiple of 4: the table the probe
        kernel stages into shared memory to start its lower-bound search.
        Built on first use and kept with the KB, like :attr:`words`."""
        keys = self.words.key_ps, self.words.key_po
        n = int(keys[0].shape[-1])
        shift = fence_shift(n)

        def table(k):
            f = k[::1 << shift]
            pad = f.new_full(((-f.shape[0]) % 4,), -1)
            return torch.cat([f, pad]).contiguous()

        return Fences(shift, table(keys[0]), table(keys[1]))

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def to(self, device) -> "KnowledgeBase":
        return KnowledgeBase(*(c.to(device) for c in self))


_PAD_KEY = U32_MAX

FENCE_SHIFT = 6       # a fence every 64 keys: the segment a thread counts
FENCE_MAX = 16384     # the most fences a KB builds (64 KB; the kernel takes
                      # twice that)


class Fences(NamedTuple):
    """Fence tables of the two sorted views: ``ps[i]`` is ``key_ps[i <<
    shift]`` for ``i < ceil(N / 2**shift)`` (the rest is padding), ``po``
    likewise."""

    shift: int
    ps: torch.Tensor
    po: torch.Tensor


def fence_shift(n: int) -> int:
    """The fence stride for an ``n``-key view: every 64th key, or sparser
    where that would give more than ``FENCE_MAX`` fences."""
    shift = FENCE_SHIFT
    while -(-n >> shift) > FENCE_MAX:
        shift += 1
    return shift


def composite_key_np(p: np.ndarray, term: np.ndarray) -> np.ndarray:
    """Host (numpy uint32) twin of :func:`repro_torch.core.rdf.composite_key`."""
    p = np.asarray(p, np.uint32)
    t = np.asarray(term, np.uint32)
    mask = np.uint32(TERM_SPACE - 1)
    with np.errstate(over="ignore"):
        low = np.where(t >= np.uint32(NUM_BASE),
                       (t ^ (t >> np.uint32(TERM_BITS))) & mask,
                       (t - np.uint32(PRED_SPACE)) & mask)
    low = np.where(t == 0, np.uint32(0), low).astype(np.uint32)
    return ((p << np.uint32(TERM_BITS)) | low).astype(np.uint32)


def build_kb(s: np.ndarray, p: np.ndarray, o: np.ndarray,
             capacity: Optional[int] = None, device="cpu") -> KnowledgeBase:
    """Host-side constructor from raw id columns (plan time)."""
    s = np.asarray(s, np.uint32)
    p = np.asarray(p, np.uint32)
    o = np.asarray(o, np.uint32)
    n = len(s)
    cap = capacity if capacity is not None else max(n, 1)
    if n > cap:
        raise ValueError("KB rows (%d) exceed capacity (%d)" % (n, cap))

    def padded(col):
        out = np.zeros((cap,), np.uint32)
        out[:n] = col
        return out

    sp, pp, op_ = padded(s), padded(p), padded(o)
    valid = np.arange(cap) < n
    key_ps = composite_key_np(pp, sp)
    key_po = composite_key_np(pp, op_)
    key_ps[~valid] = _PAD_KEY
    key_po[~valid] = _PAD_KEY
    ps_order = np.argsort(key_ps, kind="stable")
    po_order = np.argsort(key_po, kind="stable")

    def dev(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    return KnowledgeBase(
        s_ps=dev(sp[ps_order]), p_ps=dev(pp[ps_order]), o_ps=dev(op_[ps_order]),
        key_ps=dev(key_ps[ps_order]),
        s_po=dev(sp[po_order]), p_po=dev(pp[po_order]), o_po=dev(op_[po_order]),
        key_po=dev(key_po[po_order]),
        # pad keys sort last in both views: valid rows are the first n slots
        valid=torch.from_numpy(valid).to(device),
    )


def kb_from_triples(rows, capacity: Optional[int] = None,
                    device="cpu") -> KnowledgeBase:
    """From ``(s, p, o)`` rows: a sequence of tuples or an ``[n, 3]`` array."""
    arr = np.asarray(rows, np.uint32).reshape(-1, 3)
    if len(arr):
        return build_kb(arr[:, 0], arr[:, 1], arr[:, 2], capacity, device)
    return build_kb(arr[:, 0], arr[:, 1], arr[:, 2], capacity or 1, device)


def host_rows(kb: KnowledgeBase) -> np.ndarray:
    """Valid (s,p,o) rows in (p,s)-sorted order as ``uint32 [n, 3]``."""
    v = kb.valid.cpu().numpy()
    return np.stack(
        [kb.s_ps.cpu().numpy()[v], kb.p_ps.cpu().numpy()[v],
         kb.o_ps.cpu().numpy()[v]], axis=1
    ).astype(np.uint32)


# --------------------------------------------------------------------------
# plan-time KB statistics (the planner's cost model inputs)
# --------------------------------------------------------------------------

class PredStat(NamedTuple):
    """Per-predicate access statistics: row count and the widest probe range
    in each sorted view (composite-key collisions included)."""

    rows: int
    k_ps: int
    k_po: int


class KBStats(NamedTuple):
    total_rows: int
    preds: dict            # {pred_id: PredStat}


def collect_kb_stats(kb: KnowledgeBase) -> KBStats:
    """Scan one partition's sorted views into :class:`KBStats` (host-side)."""
    v = kb.valid.cpu().numpy()
    preds_col = kb.p_ps.cpu().numpy()[v]
    pids, counts = np.unique(preds_col, return_counts=True)
    rows_by_pred = {int(p): int(c) for p, c in zip(pids, counts)}
    widest = {int(p): [0, 0] for p in pids}
    for i, keys in enumerate((kb.key_ps.cpu().numpy()[v],
                              kb.key_po.cpu().numpy()[v])):
        uk, uc = np.unique(keys, return_counts=True)
        key_pred = uk >> TERM_BITS
        for p in widest:
            m = key_pred == p
            if m.any():
                widest[p][i] = int(uc[m].max())
    stats = {p: PredStat(rows=n, k_ps=widest[p][0], k_po=widest[p][1])
             for p, n in rows_by_pred.items()}
    return KBStats(total_rows=int(preds_col.shape[0]), preds=stats)


# --------------------------------------------------------------------------
# the paper's technique: used-KB pruning (plan time, host side)
# --------------------------------------------------------------------------

def prune(
    kb: KnowledgeBase,
    predicates: Sequence[int],
    objects_by_pred: Optional[dict] = None,
    capacity: Optional[int] = None,
) -> KnowledgeBase:
    """Extract the "used KB" for a sub-query signature (see the reference's
    ``kb.prune``): rows whose predicate is listed, with listed predicates'
    objects optionally narrowed to a set."""
    rows = host_rows(kb)
    if len(rows) == 0:
        return kb_from_triples([], capacity or 1, kb.device)
    mask = np.isin(rows[:, 1], np.asarray(sorted(predicates), np.uint32))
    if objects_by_pred:
        for pid, objs in objects_by_pred.items():
            prow = rows[:, 1] == np.uint32(pid)
            ok = np.isin(rows[:, 2], np.asarray(sorted(objs), np.uint32))
            mask &= ~prow | ok
    kept = rows[mask]
    return build_kb(kept[:, 0], kept[:, 1], kept[:, 2], capacity, kb.device)


def pad_to(kb: KnowledgeBase, capacity: int) -> KnowledgeBase:
    """Pad every row array to ``capacity`` (pads carry the max sort key)."""
    cur = kb.capacity
    if cur == capacity:
        return kb
    if cur > capacity:
        raise ValueError("cannot shrink KB %d -> %d" % (cur, capacity))
    ext = capacity - cur

    def pad_col(col, fill):
        return torch.cat([col, torch.full((ext,), fill, dtype=col.dtype,
                                          device=col.device)])

    return KnowledgeBase(
        s_ps=pad_col(kb.s_ps, 0), p_ps=pad_col(kb.p_ps, 0),
        o_ps=pad_col(kb.o_ps, 0), key_ps=pad_col(kb.key_ps, _PAD_KEY),
        s_po=pad_col(kb.s_po, 0), p_po=pad_col(kb.p_po, 0),
        o_po=pad_col(kb.o_po, 0), key_po=pad_col(kb.key_po, _PAD_KEY),
        valid=pad_col(kb.valid, False),
    )


def shard_rows(kb: KnowledgeBase, num_shards: int) -> KnowledgeBase:
    """Reshape ``[N] -> [num_shards, N / num_shards]`` row blocks (padded
    first when ``num_shards`` does not divide ``N``).

    Both views are key-sorted, so a row block is a contiguous key range of
    its view, and a search within one block stays correct.  Each view is
    cut on its own: block ``i`` of the ``(p,s)`` view and block ``i`` of
    the ``(p,o)`` view hold different triples, so a block is never rebuilt
    from its triples (that would sort its ``(p,o)`` view anew).  The result
    is a layout, not a KB a join takes: :func:`row_block` gives one block
    as a KB of its own (``core.kb_dist`` joins against those).
    """
    cap = kb.capacity
    if cap % num_shards:
        kb = pad_to(kb, -(-cap // num_shards) * num_shards)
    per = kb.capacity // num_shards
    return KnowledgeBase(*(c.reshape(num_shards, per) for c in kb))


def row_block(kb_blocks: KnowledgeBase, i: int) -> KnowledgeBase:
    """Block ``i`` of a :func:`shard_rows` layout as a contiguous 1-D
    :class:`KnowledgeBase`, with kernel words and a fence table of its own
    (``fence_shift`` of the block's length).  A block may be all padding,
    and shorter than a fence stride."""
    return KnowledgeBase(*(c[i].contiguous() for c in kb_blocks))


# --------------------------------------------------------------------------
# probes
# --------------------------------------------------------------------------

def probe_view(kb: KnowledgeBase, pat):
    """``(sorted keys, (s, p, o) columns, anchor slot, anchor_is_subject)``
    for a probe on ``pat`` (const predicate + anchored endpoint required).
    Subject anchors are preferred when both endpoints are anchored."""
    from .pattern import SlotMode

    assert pat.p.mode == SlotMode.CONST, "probe requires a constant predicate"
    if pat.s.mode != SlotMode.FREE:
        return kb.key_ps, (kb.s_ps, kb.p_ps, kb.o_ps), pat.s, True
    assert pat.o.mode != SlotMode.FREE, "probe needs an anchored endpoint"
    return kb.key_po, (kb.s_po, kb.p_po, kb.o_po), pat.o, False


def probe_range(keys_sorted: torch.Tensor,
                query_key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) row range whose composite key equals ``query_key``."""
    lo = torch.searchsorted(keys_sorted, query_key, side="left")
    hi = torch.searchsorted(keys_sorted, query_key, side="right")
    return lo, hi


def gather_matches(kb_cols, lo: torch.Tensor, hi: torch.Tensor, k_max: int):
    """Gather up to ``k_max`` rows from [lo, hi); returns (cols, valid, overflow)."""
    idx = lo[..., None] + torch.arange(k_max, device=lo.device)
    ok = idx < hi[..., None]
    idx_safe = idx.clamp(max=kb_cols[0].shape[-1] - 1)
    cols = tuple(c[idx_safe] for c in kb_cols)
    return cols, ok, (hi - lo) > k_max
