"""Vectorized relational algebra over triple windows and KB partitions.

Every SPARQL feature the paper's evaluation uses has a static-shape operator
here, batched over the window dimension ``W`` (binding tables are ``[W, cap,
nv]``, windows ``[W, C]``):

* basic graph patterns      -> ``scan_pattern`` + ``join``
* KB access (two methods)   -> ``kb_join`` (``"scan"`` | ``"probe"``) over the
                               join kernels of
                               :mod:`repro_torch.kernels.hash_join`: the fused
                               scan and probe joins, or the unfused scan
                               join (match matrix, then compaction)
* FILTER                    -> ``filter_num`` / ``filter_bool`` / ``filter_in``
                               / ``filter_bound``
* UNION / OPTIONAL          -> ``union`` / ``optional_join``
* CONSTRUCT                 -> ``construct``
* incremental evaluation    -> ``scan_pattern_delta`` / ``delta_retract`` /
                               ``delta_window_mask`` (slide-span columns)

Everything is deterministic and order-preserving, and ``canonical_order``
makes the published row order a function of the result set, so decomposed
and monolithic executions are bit-identical.

Pair joins never build the ``[W, ca, cb, nv]`` merged rows: the ``[W, ca,
cb]`` match mask is compacted to indices and only the ``out_cap`` winners
are merged (``compact_index`` + gather), which is bit-identical to
compacting the materialized rows.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.hash_join import ops as hj_ops
from ..obs.metrics import stat_max
from .kb import KnowledgeBase, probe_range, probe_view
from .pattern import (
    Bindings, CompiledPattern, SlotMode, compact_index, compact_rows,
    gather_rows, universe_bindings,
)
from .rdf import (
    ID_DTYPE, NUM_BASE, PAD_ID, ROW_BASE, U32_MAX, TripleBatch, composite_key,
    lexsort_order,
)


# --------------------------------------------------------------------------
# pattern scan over a window
# --------------------------------------------------------------------------

def _slot_match(slot, col_vals):
    if slot.mode == SlotMode.CONST:
        return col_vals == int(slot.const)
    return torch.ones_like(col_vals, dtype=torch.bool)


def _repeat_pairs(slots):
    for i in range(3):
        for j in range(i + 1, 3):
            if (slots[i].mode != SlotMode.CONST
                    and slots[j].mode != SlotMode.CONST
                    and slots[i].var == slots[j].var):
                yield i, j


def _scan_rows(window: TripleBatch, pat: CompiledPattern, width: int):
    """Match mask ``[W, n]`` of one triple pattern over ``window [W, n]``
    and the rows ``[W, n, width]`` binding the pattern's variables."""
    cols = (window.s, window.p, window.o)
    slots = (pat.s, pat.p, pat.o)
    m = window.valid
    for i, slot in enumerate(slots):
        m = m & _slot_match(slot, cols[i])
    for i, j in _repeat_pairs(slots):
        m = m & (cols[i] == cols[j])
    w, n = window.valid.shape
    out = torch.zeros((w, n, width), dtype=ID_DTYPE, device=m.device)
    for i, slot in enumerate(slots):
        if slot.mode != SlotMode.CONST:
            out[..., slot.var] = cols[i]
    return m, out


def scan_pattern(window: TripleBatch, pat: CompiledPattern, num_vars: int,
                 out_cap: int) -> Bindings:
    """Match one triple pattern against every window ``[W, C]``."""
    m, out = _scan_rows(window, pat, num_vars)
    rows, valid, overflow = compact_rows(out, m, out_cap)
    return Bindings(rows, valid, overflow)


# --------------------------------------------------------------------------
# natural join / union / optional
# --------------------------------------------------------------------------

def _pair_mask(a: Bindings, b: Bindings, shared: Tuple[int, ...]):
    m = a.valid[:, :, None] & b.valid[:, None, :]
    for c in shared:
        m = m & (a.cols[:, :, None, c] == b.cols[:, None, :, c])
    return m


def _merge_pairs(a: Bindings, b: Bindings, src: torch.Tensor) -> torch.Tensor:
    """Max-merged rows of the flat pair indices ``src [W, k]`` (PAD=0)."""
    cb = b.capacity
    return torch.maximum(gather_rows(a.cols, src // cb),
                         gather_rows(b.cols, src % cb))


def join(a: Bindings, b: Bindings, shared: Tuple[int, ...],
         out_cap: int) -> Bindings:
    """Natural join on the static shared-variable columns."""
    w, ca, cb = a.num_windows, a.capacity, b.capacity
    m = _pair_mask(a, b, shared)
    src, valid, overflow = compact_index(m.reshape(w, ca * cb), out_cap)
    rows = _merge_pairs(a, b, src)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return Bindings(rows, valid, overflow | a.overflow | b.overflow)


def union(a: Bindings, b: Bindings, out_cap: int) -> Bindings:
    rows = torch.cat([a.cols, b.cols], dim=1)
    mask = torch.cat([a.valid, b.valid], dim=1)
    out, valid, overflow = compact_rows(rows, mask, out_cap)
    return Bindings(out, valid, overflow | a.overflow | b.overflow)


def optional_join(a: Bindings, b: Bindings, shared: Tuple[int, ...],
                  out_cap: int) -> Bindings:
    """SPARQL OPTIONAL: left outer join; unmatched left rows keep PAD."""
    w, ca, cb = a.num_windows, a.capacity, b.capacity
    m = _pair_mask(a, b, shared)
    matched_any = m.any(dim=2)
    flat = torch.cat([m.reshape(w, ca * cb), a.valid & ~matched_any], dim=1)
    src, valid, overflow = compact_index(flat, out_cap)
    is_pair = src < ca * cb
    pair = _merge_pairs(a, b, torch.where(is_pair, src, torch.zeros_like(src)))
    left = gather_rows(a.cols, (src - ca * cb).clamp(min=0))
    rows = torch.where(is_pair[..., None], pair, left)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return Bindings(rows, valid, overflow | a.overflow | b.overflow)


# --------------------------------------------------------------------------
# KB access — the paper's two measured methods
# --------------------------------------------------------------------------

# candidate-matrix entries one step of the unfused compaction scans, which
# keeps every ``nonzero`` below INT_MAX elements
COMPACT_BLOCK = 1 << 30
# candidate-matrix bytes one match-matrix launch may write: the unfused join
# launches over as many windows at once as fit (all 8 windows of a
# full-width tumbling chunk, 4096 x 860,600 bytes each, in one launch)
MM_LAUNCH_BYTES = 1 << 35


def _first_matches(mm: torch.Tensor, rows: int, need: int):
    """Flat row-major indices of the first ``need`` set entries of ``mm [M,
    N]`` among its first ``rows`` rows, and how many entries the scan found
    (``>= need`` whenever there are that many: it stops once it has them).
    Memory grows with the matches, never with ``M x N``."""
    n = mm.shape[1]
    step = max(1, COMPACT_BLOCK // max(1, n))
    hits, found = [], 0
    for r0 in range(0, rows, step):
        nz = mm[r0:r0 + step].reshape(-1).nonzero().squeeze(1)
        hits.append(nz + r0 * n)
        found += nz.numel()
        if found >= need:
            break
    if not hits:
        return torch.zeros((0,), dtype=torch.int64, device=mm.device), 0
    return torch.cat(hits)[:need], found


def kb_join_scan(bind: Bindings, kb: KnowledgeBase, pat: CompiledPattern,
                 out_cap: int, fuse_compaction: bool = True) -> Bindings:
    """Join bindings against a KB partition by full scan.

    Cost is linear in the *total* partition size — the behaviour of paper
    Figs. 6/7 (unused triples still cost time), and the reason KB pruning
    wins.  ``fuse_compaction=True`` runs the fused scan join (matches are
    compacted where they are found).  ``False`` is the unfused baseline:
    the match-matrix kernel writes the ``[W, M, N]`` candidate matrix of as
    many windows as ``MM_LAUNCH_BYTES`` holds in one launch, then each
    window's matches are compacted in row-major order into the ``out_cap``
    extended rows.  Both give the same bytes.
    """
    if fuse_compaction:
        return hj_ops.join_compact(bind, kb, pat, out_cap)
    w, m, nv = bind.cols.shape
    n = kb.capacity
    dev = bind.cols.device
    kcols = (kb.s_ps, kb.p_ps, kb.o_ps)
    rows = torch.zeros((w, out_cap, nv), dtype=ID_DTYPE, device=dev)
    # rows past a window's last valid one match nothing
    used = (torch.where(bind.valid, torch.arange(m, device=dev), -1)
            .amax(dim=1) + 1).tolist()
    totals = []
    group = max(1, MM_LAUNCH_BYTES // max(1, m * n))
    for g0 in range(0, w, group):
        mm = hj_ops.match_matrix(Bindings(bind.cols[g0:g0 + group],
                                          bind.valid[g0:g0 + group],
                                          bind.overflow[g0:g0 + group]),
                                 kb, pat)
        for i in range(g0, g0 + mm.shape[0]):
            sel, found = _first_matches(mm[i - g0], used[i], out_cap + 1)
            sel = sel[:out_cap]
            ext = bind.cols[i, sel // n]
            for k, slot in enumerate((pat.s, pat.p, pat.o)):
                if slot.mode == SlotMode.FREE:
                    ext[:, slot.var] = kcols[k][sel % n]
            rows[i, :sel.shape[0]] = ext
            totals.append(found)
        del mm
    total = torch.tensor(totals, dtype=torch.int64, device=dev)
    k = torch.arange(out_cap, device=dev)
    valid = k[None, :] < total.clamp(max=out_cap)[:, None]
    return Bindings(rows, valid, (total > out_cap) | bind.overflow)


def _probe_width_hw(bind: Bindings, kb: KnowledgeBase,
                    pat: CompiledPattern) -> torch.Tensor:
    """Widest probe range (``hi - lo``) over each window's valid binding
    rows, ``[W]`` int32: the number ``k_max`` must dominate for the probe
    to be lossless.  The fused probe never materializes ``lo``/``hi``
    outside its kernel, so this is a plain ``searchsorted`` over the probe
    view beside it, run only when metrics are on."""
    keys, _, anchor, _ = probe_view(kb, pat)
    if anchor.mode == SlotMode.CONST:
        aval = torch.full(bind.valid.shape, int(anchor.const),
                          dtype=bind.cols.dtype, device=bind.cols.device)
    else:
        aval = bind.cols[..., anchor.var]
    lo, hi = probe_range(keys, composite_key(int(pat.p.const), aval))
    width = torch.where(bind.valid, hi - lo, torch.zeros_like(lo))
    return width.amax(-1).to(torch.int32)


def kb_join_probe(bind: Bindings, kb: KnowledgeBase, pat: CompiledPattern,
                  out_cap: int, k_max: int = 8,
                  stats: Optional[dict] = None) -> Bindings:
    """Join bindings against the KB through sorted-index probes: the fused
    probe join (composite-key search, bounded ``k_max`` gather, exact
    re-check and compaction), with the widest probe range as the
    ``hw_probe_k`` gauge when ``stats`` is given."""
    if stats is not None:
        stat_max(stats, "hw_probe_k", _probe_width_hw(bind, kb, pat))
    return hj_ops.probe_compact(bind, kb, pat, out_cap, k_max)


def kb_join(bind: Bindings, kb: KnowledgeBase, pat: CompiledPattern,
            out_cap: int, method: str = "scan", k_max: int = 8,
            fuse_compaction: bool = True,
            stats: Optional[dict] = None) -> Bindings:
    """Dispatch one KB join to its access method (resolved at plan time).

    The probe always runs the fused probe kernel, as the reference's
    kernel path does whatever ``fuse_compaction`` says; an ineligible probe
    (variable predicate or no anchored endpoint) falls back to the scan,
    preserving semantics for hand-built plans.
    """
    if method == "probe" and pat.p.mode == SlotMode.CONST and not (
            pat.s.mode == SlotMode.FREE and pat.o.mode == SlotMode.FREE):
        return kb_join_probe(bind, kb, pat, out_cap, k_max, stats)
    return kb_join_scan(bind, kb, pat, out_cap, fuse_compaction)


# --------------------------------------------------------------------------
# filters / projection / dedup
# --------------------------------------------------------------------------

_NUM_OPS = ("lt", "le", "gt", "ge", "eq", "ne")


def _num_cmp(bind: Bindings, var: int, op: str, value_id: int):
    """Shared comparison leaf: ``(true mask, error mask)``.

    Numeric right-hand sides compare fixed-point ids (error: non-numeric
    binding); term right-hand sides are SPARQL term equality, ``eq``/``ne``
    only (error: unbound binding).
    """
    assert op in _NUM_OPS, op
    is_term = int(value_id) < NUM_BASE
    v = bind.cols[..., var]
    t = int(value_id)
    if is_term:
        assert op in ("eq", "ne"), (
            "term comparisons support only eq/ne, got %r" % op)
        err = v == PAD_ID
        cmp = (v == t) if op == "eq" else (v != t)
        return cmp & ~err, err
    is_num = v >= NUM_BASE
    cmp = {"lt": v < t, "le": v <= t, "gt": v > t,
           "ge": v >= t, "eq": v == t, "ne": v != t}[op]
    return cmp & is_num, ~is_num


def filter_num(bind: Bindings, var: int, op: str, value_id: int) -> Bindings:
    val, err = _num_cmp(bind, var, op, value_id)
    return bind._replace(valid=bind.valid & val & ~err)


def _bool_eval(bind: Bindings, expr: Tuple):
    """Compiled boolean filter tree -> ``(true, error)`` row masks under
    SPARQL three-valued logic (``true & error == 0``)."""
    kind = expr[0]
    if kind == "cmp":
        _, var, op, value_id = expr
        return _num_cmp(bind, var, op, value_id)
    if kind == "not":
        val, err = _bool_eval(bind, expr[1])
        return ~val & ~err, err
    vals, errs = zip(*(_bool_eval(bind, a) for a in expr[1:]))
    any_err = functools.reduce(torch.logical_or, errs)
    if kind == "and":
        any_false = functools.reduce(
            torch.logical_or, (~v & ~e for v, e in zip(vals, errs)))
        all_true = functools.reduce(torch.logical_and, vals)
        return all_true & ~any_err, any_err & ~any_false
    if kind == "or":
        any_true = functools.reduce(torch.logical_or, vals)
        return any_true, any_err & ~any_true
    raise ValueError("unknown filter expr %r" % (expr,))


def filter_bool(bind: Bindings, expr: Tuple) -> Bindings:
    val, err = _bool_eval(bind, expr)
    return bind._replace(valid=bind.valid & val & ~err)


def filter_in(bind: Bindings, var: int, sorted_ids: torch.Tensor) -> Bindings:
    """Set-membership FILTER (e.g. subclass-closure sets)."""
    v = bind.cols[..., var].contiguous()
    pos = torch.searchsorted(sorted_ids, v)
    pos = pos.clamp(max=sorted_ids.shape[0] - 1)
    member = sorted_ids[pos] == v
    return bind._replace(valid=bind.valid & member)


def filter_bound(bind: Bindings, var: int) -> Bindings:
    return bind._replace(valid=bind.valid & (bind.cols[..., var] != PAD_ID))


def project(bind: Bindings, keep: Tuple[int, ...]) -> Bindings:
    mask = torch.zeros((bind.num_vars,), dtype=torch.bool,
                       device=bind.cols.device)
    mask[list(keep)] = True
    return bind._replace(
        cols=torch.where(mask, bind.cols, torch.zeros_like(bind.cols)))


def _take_rows(bind: Bindings, order: torch.Tensor) -> Bindings:
    return Bindings(gather_rows(bind.cols, order),
                    torch.gather(bind.valid, 1, order), bind.overflow)


def canonical_order(bind: Bindings, sig_cols: Tuple[int, ...]) -> Bindings:
    """Sort valid rows lexicographically by ``sig_cols`` (invalid last),
    most significant first; ties keep their order (stable)."""
    keys = tuple(bind.cols[..., c] for c in reversed(sig_cols))
    inv = (~bind.valid).to(ID_DTYPE)
    return _take_rows(bind, lexsort_order(keys + (inv,)))


def distinct(bind: Bindings, out_cap: Optional[int] = None) -> Bindings:
    """Deduplicate valid rows (order of first occurrence preserved)."""
    out_cap = out_cap or bind.capacity
    nv = bind.num_vars
    keys = [bind.cols[..., c] for c in range(nv - 1, -1, -1)]
    inv = (~bind.valid).to(ID_DTYPE)
    order = lexsort_order(tuple(keys) + (inv,))
    srt = _take_rows(bind, order)
    prev = torch.cat([torch.zeros_like(srt.cols[:, :1]), srt.cols[:, :-1]],
                     dim=1)
    is_new = torch.any(srt.cols != prev, dim=2)
    is_new[:, 0] = True
    keep = srt.valid & is_new
    keep_orig = torch.zeros_like(keep).scatter_(1, order, keep)
    rows, valid, overflow = compact_rows(bind.cols, keep_orig, out_cap)
    return Bindings(rows, valid, overflow | bind.overflow)


# --------------------------------------------------------------------------
# CONSTRUCT — derive the output RDF stream
# --------------------------------------------------------------------------

def construct(
    bind: Bindings,
    templates: Sequence[Tuple],
    ts: torch.Tensor,
    out_cap: int,
    graph_base: torch.Tensor,
) -> Tuple[TripleBatch, torch.Tensor]:
    """Emit one RDF-graph event per binding row from CONSTRUCT templates.

    Template slots are ``("const", id)``, ``("var", col)`` or ``("row",
    ns)``.  Every triple of window w is stamped with ``ts[w]``; graph ids
    are ``graph_base[w] + row``.  Returns the ``[W, out_cap]`` batch and a
    ``[W]`` overflow flag.
    """
    w, cap = bind.valid.shape
    t = len(templates)
    dev = bind.cols.device
    row_idx = torch.arange(cap, dtype=ID_DTYPE, device=dev)[None, :]
    graph = (row_idx + graph_base[:, None]).expand(w, cap)

    def slot_vals(spec):
        kind, val = spec
        if kind == "const":
            return torch.full((w, cap), int(val), dtype=ID_DTYPE, device=dev)
        if kind == "row":     # synthetic per-binding row node (ROW_BASE band)
            return graph + (int(val) + ROW_BASE)
        return bind.cols[..., val]

    trip = torch.stack(
        [torch.stack([slot_vals(s) for s in tpl], dim=-1) for tpl in templates],
        dim=2)                                              # [W, cap, t, 3]
    rows = torch.cat([
        trip,
        ts[:, None, None, None].expand(w, cap, t, 1),
        graph[:, :, None, None].expand(w, cap, t, 1),
    ], dim=-1).reshape(w, cap * t, 5)                      # graph-contiguous
    mask = bind.valid[:, :, None].expand(w, cap, t).reshape(w, cap * t)
    out, valid, overflow = compact_rows(rows, mask, out_cap)
    return TripleBatch(
        s=out[..., 0], p=out[..., 1], o=out[..., 2], ts=out[..., 3],
        graph=out[..., 4], valid=valid,
    ), overflow


# --------------------------------------------------------------------------
# incremental (delta) evaluation — slide-span tracking
# --------------------------------------------------------------------------
#
# Sliding count windows overlap on whole slides (window w = slides
# w..w+R-1, see core/window.py), and every step of a delta-safe plan is
# monotone in the stream triples it consumes: a joined binding row exists in
# window w iff all its contributing triples do.  So the engine evaluates the
# merged chunk ONCE, tracking for every binding row the interval
# [min_slide, max_slide] of contributing slides, and selects window w's rows
# with an interval test.  Spans only grow under joins, so a row whose span
# already exceeds R-1 slides is retracted eagerly (``delta_retract``).
#
# The interval rides in two extra columns after the ``num_vars`` variable
# columns, encoded so that the elementwise maximum ``join`` already takes
# merges spans:
#
#   col nv     = max_slide + 1                  ("enc_max"; 0 = no triples)
#   col nv + 1 = SPAN_ENC_K - (min_slide + 1)   ("enc_min" complement)
#
# A row with no stream triples (the universe row, KB-only derivations) has
# both columns 0 and belongs to every window.  KB joins, filters, union and
# compaction treat the columns as opaque words.  The reference computes in
# uint32 and relies on its wraparound; ids here are int64, so every such
# sum is masked to 32 bits.

SPAN_ENC_K = 0xFFFFFFFF


def delta_universe(capacity: int, num_vars: int, device="cpu") -> Bindings:
    """The BGP identity (one table) with empty span columns attached."""
    return universe_bindings(1, capacity, num_vars + 2, device)


def scan_pattern_delta(stream: TripleBatch, pat: CompiledPattern,
                       num_vars: int, out_cap: int,
                       slide_of_row: torch.Tensor) -> Bindings:
    """``scan_pattern`` over the whole merged chunk ``stream [n]``: one
    table of ``num_vars + 2`` columns, the extra two holding each row's
    slide as a one-slide span.  Rows the slide packing dropped
    (``slide_of_row == -1``) are excluded, as in the windows."""
    m, out = _scan_rows(stream.map(lambda c: c[None]), pat, num_vars + 2)
    m = m & (slide_of_row >= 0)[None]
    enc = slide_of_row.clamp(min=0) + 1
    out[0, :, num_vars] = enc
    out[0, :, num_vars + 1] = SPAN_ENC_K - enc
    rows, valid, overflow = compact_rows(out, m, out_cap)
    return Bindings(rows, valid, overflow)


def delta_retract(bind: Bindings, num_vars: int, max_span: int) -> Bindings:
    """Retract rows whose slide span exceeds ``max_span`` slides (a span of
    k means max_slide - min_slide == k): spans only grow under joins, so
    such rows never re-enter a window."""
    enc_max = bind.cols[..., num_vars]
    enc_min = bind.cols[..., num_vars + 1]
    # (mx + 1) + (K - (mn + 1)) - K == mx - mn in 32-bit arithmetic
    span = (enc_max + enc_min - SPAN_ENC_K) & U32_MAX
    keep = (enc_max == 0) | (span <= max_span)
    return bind._replace(valid=bind.valid & keep)


def delta_window_mask(bind: Bindings, num_vars: int, window: torch.Tensor,
                      slides_per_window: int) -> torch.Tensor:
    """Membership ``[V, cap]`` of the rows of one span-tagged table in each
    window of ``window [V]`` (window w = slides ``w .. w + R - 1``): the
    row's span must sit inside that range.  Span-free rows pass."""
    w = (window.to(ID_DTYPE) & U32_MAX)[:, None]
    enc_max = bind.cols[0, :, num_vars][None, :]
    enc_min = bind.cols[0, :, num_vars + 1][None, :]
    in_w = ((enc_max <= ((w + slides_per_window) & U32_MAX))
            & (((SPAN_ENC_K - 1 - enc_min) & U32_MAX) >= w))
    return bind.valid[0][None, :] & in_w
