"""The vectorized RSP engine: executes compiled plans over triple windows.

A :class:`Plan` is a static list of steps (Python-level control flow only).
Executing it runs PyTorch ops eagerly over the whole window batch at once:
the window dimension ``W`` is written out in every op (the reference
``vmap``-s a per-window program instead).  :func:`run_plan_slides` is the
incremental path: the step chain runs once per chunk over span-tagged
bindings, and only the per-window tail runs batched over ``W``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from . import algebra
from .kb import KnowledgeBase
from .pattern import Bindings, CompiledPattern, universe_bindings
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


Step = Union[
    ScanJoin, KBJoin, FilterNumStep, FilterBoolStep, FilterInStep,
    OptionalSteps, UnionSteps, DistinctStep, ProjectStep,
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


def plan_out_vars(plan: Plan) -> Tuple[int, ...]:
    """Columns the CONSTRUCT templates reference (the output signature)."""
    return tuple(sorted({
        val for tpl in plan.templates for kind, val in tpl if kind == "var"
    }))


def _apply(step: Step, cur: Bindings, window: TripleBatch,
           kb: Optional[KnowledgeBase], env: Env, plan: Plan) -> Bindings:
    if isinstance(step, ScanJoin):
        b = algebra.scan_pattern(window, step.pat, plan.num_vars, plan.scan_cap)
        return algebra.join(cur, b, step.shared, plan.bind_cap)
    if isinstance(step, KBJoin):
        assert kb is not None, "plan %s touches the KB but none attached" % plan.name
        return algebra.kb_join(cur, kb, step.pat, plan.bind_cap,
                               method=step.method, k_max=step.k_max,
                               fuse_compaction=step.fuse_compaction)
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
            sub = _apply(s, sub, window, kb, env, plan)
        return algebra.optional_join(cur, sub, step.shared, plan.bind_cap)
    if isinstance(step, UnionSteps):
        left = cur
        for s in step.left:
            left = _apply(s, left, window, kb, env, plan)
        right = cur
        for s in step.right:
            right = _apply(s, right, window, kb, env, plan)
        return algebra.union(left, right, plan.bind_cap)
    if isinstance(step, DistinctStep):
        return algebra.distinct(cur)
    if isinstance(step, ProjectStep):
        return algebra.project(cur, step.keep)
    raise TypeError("unknown step %r" % (step,))


def run_steps(plan: Plan, cur: Bindings, steps: Sequence[Step],
              window: TripleBatch, kb: Optional[KnowledgeBase],
              env: Env) -> Bindings:
    """Apply a step subsequence."""
    for step in steps:
        cur = _apply(step, cur, window, kb, env, plan)
    return cur


def finalize_bindings(plan: Plan, cur: Bindings, ts: torch.Tensor,
                      graph_base: torch.Tensor) -> Tuple[TripleBatch, torch.Tensor]:
    """Project onto the CONSTRUCT variables, dedup, canonically order,
    construct.  Returns (output triples [W, out_cap], overflow [W])."""
    out_vars = plan_out_vars(plan)
    emit = cur
    if out_vars:
        # significance by variable *name*: column numbering is plan-local
        sig = tuple(sorted(out_vars, key=lambda c: plan.var_names[c]))
        emit = algebra.canonical_order(
            algebra.distinct(algebra.project(cur, out_vars)), sig)
    out, c_ovf = algebra.construct(emit, plan.templates, ts, plan.out_cap,
                                   graph_base)
    return out, cur.overflow | emit.overflow | c_ovf


def run_plan(plan: Plan, window: TripleBatch, kb: Optional[KnowledgeBase],
             env: Env, graph_base: torch.Tensor):
    """Execute ``plan`` on a ``[W, C]`` window batch.  Returns
    (constructed stream [W, out_cap], final bindings, overflow [W])."""
    w = window.valid.shape[0]
    cur = universe_bindings(w, plan.bind_cap, plan.num_vars, window.valid.device)
    cur = run_steps(plan, cur, plan.steps, window, kb, env)
    ts = torch.where(window.valid, window.ts, torch.zeros_like(window.ts)).amax(-1)
    out, ovf = finalize_bindings(plan, cur, ts, graph_base)
    return out, cur, ovf


def run_plan_windows(plan: Plan, windows: Windows,
                     kb: Optional[KnowledgeBase], env: Env):
    """Run the plan over every window of the batch at once.

    Returns a ``[W, out_cap]``-leaf TripleBatch plus a ``[W]`` overflow
    flag (a set flag means capacities clipped that window).
    """
    w = windows.num_windows
    dev = windows.window_valid.device
    graph_base = torch.arange(w, dtype=ID_DTYPE, device=dev) * plan.bind_cap
    out, _, ovf = run_plan(plan, windows.triples, kb, env, graph_base)
    return out._replace(valid=out.valid & windows.window_valid[:, None]), ovf


# --------------------------------------------------------------------------
# incremental (delta) execution over slides
# --------------------------------------------------------------------------

def _apply_delta(step: Step, cur: Bindings, view: SlideView,
                 kb: Optional[KnowledgeBase], env: Env, plan: Plan,
                 max_span: int) -> Bindings:
    """One plan step over one span-tagged table (``num_vars + 2`` columns).

    Every step here is monotone (``planner.plan_supports_delta`` gates
    plans to this vocabulary): stream scans stamp each match with its
    slide, joins merge spans through the elementwise-max merge, and a
    retract after every stream join drops rows whose span no longer fits a
    window.  KB joins and filters treat the span columns as opaque words.
    """
    if isinstance(step, ScanJoin):
        b = algebra.scan_pattern_delta(view.stream, step.pat, plan.num_vars,
                                       plan.scan_cap, view.slide_of_row)
        joined = algebra.join(cur, b, step.shared, plan.bind_cap)
        return algebra.delta_retract(joined, plan.num_vars, max_span)
    if isinstance(step, UnionSteps):
        left = cur
        for s in step.left:
            left = _apply_delta(s, left, view, kb, env, plan, max_span)
        right = cur
        for s in step.right:
            right = _apply_delta(s, right, view, kb, env, plan, max_span)
        return algebra.union(left, right, plan.bind_cap)
    if isinstance(step, (KBJoin, FilterNumStep, FilterBoolStep, FilterInStep)):
        return _apply(step, cur, view.stream, kb, env, plan)
    raise TypeError(
        "step %r is not delta-safe: plan_supports_delta should have routed "
        "this plan to per-window recompute" % (step,))


def run_plan_slides(plan: Plan, view: SlideView, slides_per_window: int,
                    max_windows: int, kb: Optional[KnowledgeBase], env: Env):
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

    Returns a ``[W, out_cap]``-leaf TripleBatch plus a ``[W]`` overflow flag.
    """
    r = slides_per_window
    dev = view.slide_valid.device
    cur = algebra.delta_universe(plan.bind_cap, plan.num_vars, dev)
    for step in plan.steps:
        cur = _apply_delta(step, cur, view, kb, env, plan, r - 1)
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
    return out, chunk_ovf | emit.overflow | c_ovf
