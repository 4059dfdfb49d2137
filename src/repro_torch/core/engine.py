"""The vectorized RSP engine: executes compiled plans over triple windows.

A :class:`Plan` is a static list of steps (Python-level control flow only).
Executing it runs PyTorch ops eagerly over the whole window batch at once:
the window dimension ``W`` is written out in every op (the reference
``vmap``-s a per-window program instead).  :func:`run_plan_slides` is the
incremental path: the step chain runs once per chunk over span-tagged
bindings, and only the per-window tail runs batched over ``W``.

Every runner takes ``with_stats``: True also returns a flat dict of chunk
scalars (``repro_torch.obs.metrics``: occupancy high-water marks, probe
widths, windows, retractions), computed on the device beside the step.
Each instrumentation site is behind a Python-level ``stats is not None``
test, so the stats-off call runs exactly the ops it runs without them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..obs.metrics import reduce_stats, stat_add, stat_max
from . import algebra
from .kb import KnowledgeBase
from .pattern import Bindings, CompiledPattern, compact_rows, universe_bindings
from .rdf import ID_DTYPE, TripleBatch
from .window import SlideView, Windows


# --------------------------------------------------------------------------
# plan steps (static dataclasses — hashable)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScanJoin:
    """Scan a stream pattern in the window, natural-join into the state."""

    pat: CompiledPattern
    shared: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class KBJoin:
    pat: CompiledPattern
    method: str = "scan"          # "scan" | "probe"  (paper's two methods)
    k_max: int = 8
    fuse_compaction: bool = True  # False: the unfused scan (match matrix)


@dataclasses.dataclass(frozen=True)
class FilterNumStep:
    var: int
    op: str
    value_id: int


@dataclasses.dataclass(frozen=True)
class FilterBoolStep:
    """Boolean FILTER tree: ``("cmp", col, op, value_id)`` leaves under
    ``("and"|"or"|"not", ...)`` nodes."""

    expr: Tuple


@dataclasses.dataclass(frozen=True)
class FilterInStep:
    var: int
    set_name: str                 # env key holding a sorted id tensor


@dataclasses.dataclass(frozen=True)
class OptionalSteps:
    sub: Tuple["Step", ...]
    shared: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class UnionSteps:
    left: Tuple["Step", ...]
    right: Tuple["Step", ...]


@dataclasses.dataclass(frozen=True)
class DistinctStep:
    pass


@dataclasses.dataclass(frozen=True)
class ProjectStep:
    keep: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class BindingJoin:
    """Join a pre-joined upstream binding *table* into the state.

    The split aggregation sink (``planner.split_agg_plan``) replaces the
    binding-graph decode scans (one ScanJoin per published variable, each
    over the whole augmented window) with one natural join against the
    upstream operator's already-projected table of result rows.
    ``cols[j]`` is the sink-plan column the table's j-th column binds;
    ``shared`` are the columns joined on (recomputed by the rewriter from
    the bound-before set, as for any ScanJoin).  ``replace=True`` marks the
    plan's very first step, where ``universe ⋈ T == T`` and the outer
    product is skipped.
    """

    source: str
    cols: Tuple[int, ...]
    shared: Tuple[int, ...]
    replace: bool = False


Step = Union[
    ScanJoin, KBJoin, FilterNumStep, FilterBoolStep, FilterInStep,
    OptionalSteps, UnionSteps, DistinctStep, ProjectStep, BindingJoin,
]


@dataclasses.dataclass(frozen=True)
class Plan:
    """A compiled continuous query."""

    name: str
    num_vars: int
    var_names: Tuple[str, ...]            # col index -> variable name
    steps: Tuple[Step, ...]
    templates: Tuple[Tuple, ...]          # compiled construct templates
    scan_cap: int = 128                   # pattern-scan result capacity
    bind_cap: int = 256                   # working binding-table capacity
    out_cap: int = 512                    # constructed-triples capacity

    def var_col(self, name: str) -> int:
        return self.var_names.index(name)


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

Env = Dict[str, torch.Tensor]

# Upstream binding tables for the split aggregation sink: operator name ->
# ``(cols, valid)``.  A window table is ``[W, rows, k]`` / ``[W, rows]``
# (one column per published variable); a delta table is chunk-level,
# ``[rows, k + 2]`` / ``[rows]`` (the two span columns appended).  Only
# BindingJoin steps read these.
Tables = Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]

# Optional metrics dict (repro_torch.obs.metrics).  None, the default
# everywhere, collects nothing.  Inside a runner the gauges are per window,
# ``[W]`` int32 (``[1]`` on the chunk-level delta chain); the runner
# reduces them to chunk scalars on return.
Stats = Optional[Dict[str, torch.Tensor]]


def _rows(x) -> torch.Tensor:
    """Valid rows of each window, ``[W]`` int32, of a binding table, a
    triple batch or a bare ``[W, rows]`` mask."""
    valid = x if torch.is_tensor(x) else x.valid
    return valid.sum(-1, dtype=torch.int32)


def plan_out_vars(plan: Plan) -> Tuple[int, ...]:
    """Columns the CONSTRUCT templates reference (the output signature)."""
    return tuple(sorted({
        val for tpl in plan.templates for kind, val in tpl if kind == "var"
    }))


def _binding_table(step: BindingJoin, tables: Tables, width: int,
                   num_span: int = 0) -> Bindings:
    """Scatter an upstream table into a ``width``-column relation.

    ``num_span`` > 0 (the delta path) also maps the table's trailing span
    columns onto the state's span columns at ``width - num_span``.  A
    chunk-level table becomes one relation (``W = 1``).
    """
    assert tables is not None and step.source in tables, (
        "BindingJoin on %r but no table supplied: split-sink runners must "
        "pass the upstream tables" % step.source)
    tcols, tvalid = tables[step.source]
    if tcols.dim() == 2:
        tcols, tvalid = tcols[None], tvalid[None]
    k = len(step.cols)
    out = tcols.new_zeros(tcols.shape[:2] + (width,))
    # published variables are distinct, so their columns are too
    out[..., list(step.cols)] = tcols[..., :k]
    if num_span:
        out[..., width - num_span:] = tcols[..., k:k + num_span]
    # upstream clipping is reported as that operator's own overflow flag
    return Bindings(out, tvalid, torch.zeros_like(tvalid[:, 0]))


def _join_table(step: BindingJoin, cur: Bindings, b: Bindings,
                plan: Plan) -> Bindings:
    if step.replace:
        # first step: universe ⋈ T is T itself (shared is empty, the
        # max-merge with all-PAD is the identity); clip to bind_cap
        # without the [1, rows] outer product
        rows, valid, ovf = compact_rows(b.cols, b.valid, plan.bind_cap)
        return Bindings(rows, valid, ovf | cur.overflow)
    return algebra.join(cur, b, step.shared, plan.bind_cap)


def _apply(step: Step, cur: Bindings, window: TripleBatch,
           kb: Optional[KnowledgeBase], env: Env, plan: Plan,
           tables: Tables = None, stats: Stats = None) -> Bindings:
    if isinstance(step, BindingJoin):
        b = _binding_table(step, tables, plan.num_vars)
        if stats is not None:
            stat_max(stats, "hw_scan", _rows(b))
        return _join_table(step, cur, b, plan)
    if isinstance(step, ScanJoin):
        b = algebra.scan_pattern(window, step.pat, plan.num_vars, plan.scan_cap)
        if stats is not None:
            stat_max(stats, "hw_scan", _rows(b))
        return algebra.join(cur, b, step.shared, plan.bind_cap)
    if isinstance(step, KBJoin):
        assert kb is not None, "plan %s touches the KB but none attached" % plan.name
        return algebra.kb_join(cur, kb, step.pat, plan.bind_cap,
                               method=step.method, k_max=step.k_max,
                               fuse_compaction=step.fuse_compaction,
                               stats=stats)
    if isinstance(step, FilterNumStep):
        return algebra.filter_num(cur, step.var, step.op, step.value_id)
    if isinstance(step, FilterBoolStep):
        return algebra.filter_bool(cur, step.expr)
    if isinstance(step, FilterInStep):
        return algebra.filter_in(cur, step.var, env[step.set_name])
    if isinstance(step, OptionalSteps):
        sub = universe_bindings(cur.num_windows, plan.bind_cap, plan.num_vars,
                                cur.cols.device)
        for s in step.sub:
            sub = _apply(s, sub, window, kb, env, plan, tables, stats)
        return algebra.optional_join(cur, sub, step.shared, plan.bind_cap)
    if isinstance(step, UnionSteps):
        left = cur
        for s in step.left:
            left = _apply(s, left, window, kb, env, plan, tables, stats)
        right = cur
        for s in step.right:
            right = _apply(s, right, window, kb, env, plan, tables, stats)
        return algebra.union(left, right, plan.bind_cap)
    if isinstance(step, DistinctStep):
        return algebra.distinct(cur)
    if isinstance(step, ProjectStep):
        return algebra.project(cur, step.keep)
    raise TypeError("unknown step %r" % (step,))


def run_steps(plan: Plan, cur: Bindings, steps: Sequence[Step],
              window: TripleBatch, kb: Optional[KnowledgeBase],
              env: Env, tables: Tables = None,
              stats: Stats = None) -> Bindings:
    """Apply a step subsequence (with the binding table's high-water mark
    after every step when ``stats`` is given)."""
    for step in steps:
        cur = _apply(step, cur, window, kb, env, plan, tables, stats)
        if stats is not None:
            stat_max(stats, "hw_bind", _rows(cur))
    return cur


def _emit_relation(plan: Plan, cur: Bindings) -> Bindings:
    """Project onto the CONSTRUCT variables, dedup and canonically order:
    the relation a plan publishes (as triples, or as its table)."""
    out_vars = plan_out_vars(plan)
    # significance by variable *name*: column numbering is plan-local
    sig = tuple(sorted(out_vars, key=lambda c: plan.var_names[c]))
    return algebra.canonical_order(
        algebra.distinct(algebra.project(cur, out_vars)), sig)


def finalize_bindings(plan: Plan, cur: Bindings, ts: torch.Tensor,
                      graph_base: torch.Tensor, stats: Stats = None
                      ) -> Tuple[TripleBatch, torch.Tensor]:
    """Project onto the CONSTRUCT variables, dedup, canonically order,
    construct.  Returns (output triples [W, out_cap], overflow [W])."""
    emit = _emit_relation(plan, cur) if plan_out_vars(plan) else cur
    out, c_ovf = algebra.construct(emit, plan.templates, ts, plan.out_cap,
                                   graph_base)
    if stats is not None:
        stat_max(stats, "hw_out", _rows(out))
    return out, cur.overflow | emit.overflow | c_ovf


def run_plan(plan: Plan, window: TripleBatch, kb: Optional[KnowledgeBase],
             env: Env, graph_base: torch.Tensor, tables: Tables = None,
             stats: Stats = None):
    """Execute ``plan`` on a ``[W, C]`` window batch.  Returns
    (constructed stream [W, out_cap], final bindings, overflow [W])."""
    w = window.valid.shape[0]
    cur = universe_bindings(w, plan.bind_cap, plan.num_vars, window.valid.device)
    cur = run_steps(plan, cur, plan.steps, window, kb, env, tables, stats)
    ts = torch.where(window.valid, window.ts, torch.zeros_like(window.ts)).amax(-1)
    out, ovf = finalize_bindings(plan, cur, ts, graph_base, stats)
    return out, cur, ovf


def _chunk_stats(stats: Dict[str, torch.Tensor],
                 window_valid: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-window gauges reduced to chunk scalars, plus the valid windows
    (``window_valid`` None: a chunk-level table, which counts none)."""
    stats = reduce_stats(stats)
    if window_valid is not None:
        stat_add(stats, "n_windows", window_valid.sum(dtype=torch.int32))
    return stats


def run_plan_windows(plan: Plan, windows: Windows,
                     kb: Optional[KnowledgeBase], env: Env,
                     tables: Tables = None, with_stats: bool = False,
                     first_window: int = 0):
    """Run the plan over every window of the batch at once.

    Returns a ``[W, out_cap]``-leaf TripleBatch plus a ``[W]`` overflow
    flag (a set flag means capacities clipped that window), plus the chunk
    stats when ``with_stats``.  ``first_window`` is the chunk's index of
    the batch's first window (a data-axis slice's offset): output graph ids
    number the chunk's windows, not the slice's.
    """
    w = windows.num_windows
    dev = windows.window_valid.device
    stats: Stats = {} if with_stats else None
    graph_base = torch.arange(first_window, first_window + w, dtype=ID_DTYPE,
                              device=dev) * plan.bind_cap
    out, _, ovf = run_plan(plan, windows.triples, kb, env, graph_base, tables,
                           stats)
    out = out._replace(valid=out.valid & windows.window_valid[:, None])
    if stats is None:
        return out, ovf
    return out, ovf, _chunk_stats(stats, windows.window_valid)


# --------------------------------------------------------------------------
# incremental (delta) execution over slides
# --------------------------------------------------------------------------

def _apply_delta(step: Step, cur: Bindings, view: SlideView,
                 kb: Optional[KnowledgeBase], env: Env, plan: Plan,
                 max_span: int, tables: Tables = None,
                 stats: Stats = None) -> Bindings:
    """One plan step over one span-tagged table (``num_vars + 2`` columns).

    Every step here is monotone (``planner.plan_supports_delta`` gates
    plans to this vocabulary): stream scans stamp each match with its
    slide, joins merge spans through the elementwise-max merge, and a
    retract after every stream join drops rows whose span no longer fits a
    window.  KB joins and filters treat the span columns as opaque words.
    BindingJoin is monotone too: an upstream table row carries the span of
    its contributing slides, the max-merge unions spans across the join,
    and a combined derivation fits a window iff every constituent span
    does.
    """
    if isinstance(step, (BindingJoin, ScanJoin)):
        if isinstance(step, BindingJoin):
            b = _binding_table(step, tables, plan.num_vars + 2, num_span=2)
            joined = _join_table(step, cur, b, plan)
        else:
            b = algebra.scan_pattern_delta(view.stream, step.pat,
                                           plan.num_vars, plan.scan_cap,
                                           view.slide_of_row)
            joined = algebra.join(cur, b, step.shared, plan.bind_cap)
        retracted = algebra.delta_retract(joined, plan.num_vars, max_span)
        if stats is not None:
            stat_max(stats, "hw_scan", _rows(b))
            stat_add(stats, "n_retract", _rows(joined) - _rows(retracted))
        return retracted
    if isinstance(step, UnionSteps):
        left = cur
        for s in step.left:
            left = _apply_delta(s, left, view, kb, env, plan, max_span,
                                tables, stats)
        right = cur
        for s in step.right:
            right = _apply_delta(s, right, view, kb, env, plan, max_span,
                                 tables, stats)
        return algebra.union(left, right, plan.bind_cap)
    if isinstance(step, (KBJoin, FilterNumStep, FilterBoolStep, FilterInStep)):
        return _apply(step, cur, view.stream, kb, env, plan, stats=stats)
    raise TypeError(
        "step %r is not delta-safe: plan_supports_delta should have routed "
        "this plan to per-window recompute" % (step,))


def _delta_chain(plan: Plan, view: SlideView, slides_per_window: int,
                 kb: Optional[KnowledgeBase], env: Env,
                 tables: Tables = None, stats: Stats = None) -> Bindings:
    """The plan's step chain once over the chunk: one span-tagged table."""
    cur = algebra.delta_universe(plan.bind_cap, plan.num_vars,
                                 view.slide_valid.device)
    for step in plan.steps:
        cur = _apply_delta(step, cur, view, kb, env, plan,
                           slides_per_window - 1, tables, stats)
        if stats is not None:
            stat_max(stats, "hw_bind", _rows(cur))
    return cur


def run_plan_slides(plan: Plan, view: SlideView, slides_per_window: int,
                    max_windows: int, kb: Optional[KnowledgeBase], env: Env,
                    tables: Tables = None, with_stats: bool = False):
    """Incremental execution: one chunk-level pass, per-window selection.

    The step chain runs ONCE over the merged stream (``W = 1``) with slide
    spans riding along, instead of once per window as in
    :func:`run_plan_windows`; each window then selects its rows with an
    interval test, and the finalize tail (project -> distinct ->
    canonical_order -> construct) runs batched over the ``W`` selections of
    that one table.  The tail is the set-to-stream function recompute uses
    and the selected binding sets are equal, so the output is the same
    bytes.  The chunk-level pass shares one ``scan_cap``/``bind_cap``
    across the chunk where recompute has them per window, so overflow trips
    earlier here; the flag reports it as usual.

    Returns a ``[W, out_cap]``-leaf TripleBatch plus a ``[W]`` overflow
    flag (plus the chunk stats when ``with_stats``: the chain's gauges are
    chunk-level already, ``hw_out`` is the fullest window's).
    """
    r = slides_per_window
    dev = view.slide_valid.device
    stats: Stats = {} if with_stats else None
    cur = _delta_chain(plan, view, r, kb, env, tables, stats)
    out_vars = plan_out_vars(plan)
    assert out_vars, (
        "plan %s has no output variables: plan_supports_delta should have "
        "routed it to per-window recompute" % plan.name)
    sig = tuple(sorted(out_vars, key=lambda c: plan.var_names[c]))

    wid = torch.arange(max_windows, device=dev)
    widx = wid[:, None] + torch.arange(r, device=dev)[None, :]       # [W, R]
    w_ts = view.slide_ts[widx].amax(dim=1)
    w_valid = view.slide_valid[widx].any(dim=1)
    memb = algebra.delta_window_mask(cur, plan.num_vars, wid, r)    # [W, cap]
    chunk_ovf = cur.overflow.expand(max_windows)
    rows = Bindings(cur.cols[..., :plan.num_vars].expand(
        max_windows, plan.bind_cap, plan.num_vars), memb, chunk_ovf)
    emit = algebra.canonical_order(
        algebra.distinct(algebra.project(rows, out_vars)), sig)
    out, c_ovf = algebra.construct(emit, plan.templates, w_ts, plan.out_cap,
                                   wid.to(ID_DTYPE) * plan.bind_cap)
    out = out._replace(valid=out.valid & w_valid[:, None])
    ovf = chunk_ovf | emit.overflow | c_ovf
    if stats is None:
        return out, ovf
    stat_max(stats, "hw_out", _rows(out).amax())
    return out, ovf, _chunk_stats(stats, w_valid)


# --------------------------------------------------------------------------
# split aggregation sink: upstream table producers + sink runners
# --------------------------------------------------------------------------
#
# The binding-graph protocol (planner.decompose) ships upstream results as
# RDF triples, one graph event per result row, and the aggregation sink
# re-parses them: one decode ScanJoin per published variable over the
# augmented window, then the natural joins that stitch each row back
# together.  The split sink skips that round trip: each upstream publishes
# its final binding TABLE (joined, projected, deduplicated and canonically
# ordered), and the rewritten sink plan (planner.split_agg_plan) joins the
# tables directly through BindingJoin.  Output bytes are unchanged: the
# published stream is a function of the binding *set* (finalize_bindings
# dedups and canonically orders), and the table rows are exactly the rows
# the decode scans would have rebuilt.

def _clip_table(emit: Bindings, pub_cols: Tuple[int, ...], rows_cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather ``pub_cols`` from the leading ``rows_cap`` rows of ``emit``.

    ``emit`` keeps its valid rows as a prefix (distinct and canonical_order
    guarantee that), so the prefix clip drops exactly the rows the triple
    publication would have clipped at ``out_cap``.  Returns ``(cols [W,
    rows_cap, k], valid [W, rows_cap], clipped [W])``.
    """
    take = min(rows_cap, emit.capacity)
    cols = emit.cols[:, :take, list(pub_cols)]
    valid = emit.valid[:, :take]
    clipped = (emit.valid[:, take:].any(-1) if take < emit.capacity
               else torch.zeros_like(emit.overflow))
    if take < rows_cap:
        pad = rows_cap - take
        cols = torch.cat([cols, cols.new_zeros(
            (cols.shape[0], pad, len(pub_cols)))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((valid.shape[0], pad))],
                          dim=1)
    return cols, valid, clipped


def run_plan_window_tables(plan: Plan, windows: Windows,
                           pub_cols: Tuple[int, ...], rows_cap: int,
                           kb: Optional[KnowledgeBase], env: Env,
                           with_stats: bool = False):
    """Upstream table producer, per window: the operator's whole step
    chain, then project -> distinct -> canonical_order (the emit relation
    the triple publication constructs from), clipped to ``rows_cap`` rows.

    Returns ``((cols [W, rows_cap, k], valid [W, rows_cap]), ovf [W])``
    (plus the chunk stats when ``with_stats``).
    """
    w = windows.num_windows
    stats: Stats = {} if with_stats else None
    cur = universe_bindings(w, plan.bind_cap, plan.num_vars,
                            windows.window_valid.device)
    cur = run_steps(plan, cur, plan.steps, windows.triples, kb, env,
                    stats=stats)
    emit = _emit_relation(plan, cur)
    cols, valid, clipped = _clip_table(emit, pub_cols, rows_cap)
    valid = valid & windows.window_valid[:, None]
    ovf = cur.overflow | emit.overflow | clipped
    if stats is None:
        return (cols, valid), ovf
    stat_max(stats, "hw_out", _rows(valid))
    return (cols, valid), ovf, _chunk_stats(stats, windows.window_valid)


def run_plan_slide_tables(plan: Plan, view: SlideView,
                          pub_cols: Tuple[int, ...], rows_cap: int,
                          slides_per_window: int,
                          kb: Optional[KnowledgeBase], env: Env,
                          with_stats: bool = False):
    """Upstream table producer, incremental: one chunk-level delta pass,
    emitting the span-tagged table (variable columns + the two span
    columns).  The sink's per-window interval test selects each window's
    rows, so the table is produced once per chunk, not once per window.

    Returns ``((cols [rows_cap, k + 2], valid [rows_cap]), ovf [])``
    (plus the chunk stats when ``with_stats``).
    """
    stats: Stats = {} if with_stats else None
    cur = _delta_chain(plan, view, slides_per_window, kb, env, stats=stats)
    nv = plan.num_vars
    span = (nv, nv + 1)
    # dedup over (variables, span): rows equal in both are interchangeable
    # for every window's interval test, so multiplicity can go here
    emit = algebra.distinct(
        algebra.project(cur, tuple(plan_out_vars(plan)) + span))
    cols, valid, clipped = _clip_table(emit, tuple(pub_cols) + span,
                                       rows_cap)
    table = (cols[0], valid[0])
    ovf = (cur.overflow | emit.overflow | clipped)[0]
    if stats is None:
        return table, ovf
    stat_max(stats, "hw_out", _rows(valid))
    return table, ovf, _chunk_stats(stats, None)


def run_sink_windows(plan: Plan, windows: Windows,
                     tables: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                     kb: Optional[KnowledgeBase], env: Env,
                     with_stats: bool = False):
    """Split-sink twin of :func:`run_plan_windows`: the rewritten sink plan
    over the RAW windows, with the per-window upstream tables (leaves
    ``[W, rows, k]`` / ``[W, rows]``).  The finalize tail, and so the
    published bytes, are those of the unsplit path: upstream publication
    triples carry their window's max timestamp, so the raw window's ts is
    the augmented one's."""
    return run_plan_windows(plan, windows, kb, env, tables, with_stats)


def run_sink_slides(plan: Plan, view: SlideView,
                    tables: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                    slides_per_window: int, max_windows: int,
                    kb: Optional[KnowledgeBase], env: Env,
                    with_stats: bool = False):
    """Split-sink twin of :func:`run_plan_slides`: the rewritten sink
    plan's delta pass over the chunk, joining chunk-level span-tagged
    upstream tables, then the per-window interval select and finalize.
    Shares :func:`run_plan_slides` so the set-to-stream tail cannot diverge
    from the recompute path."""
    return run_plan_slides(plan, view, slides_per_window, max_windows, kb,
                           env, tables, with_stats)
