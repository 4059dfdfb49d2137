"""The vectorized RSP engine: executes compiled plans over triple windows.

A :class:`Plan` is a static list of steps (Python-level control flow only).
Executing it runs PyTorch ops eagerly over the whole window batch at once:
the window dimension ``W`` is written out in every op (the reference
``vmap``-s a per-window program instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from . import algebra
from .kb import KnowledgeBase
from .pattern import Bindings, CompiledPattern, universe_bindings
from .rdf import ID_DTYPE, TripleBatch
from .window import Windows


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
                               method=step.method, k_max=step.k_max)
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
