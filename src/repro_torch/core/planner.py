"""Query compiler, decomposer and KB pruner.

* ``compile_query`` — Query AST -> executable :class:`~repro_torch.core.engine.Plan`
  (variable numbering, bound-mode resolution, filter placement, and the
  ``kb_method="auto"`` per-join cost model).
* ``decompose``     — one query -> a DAG of sub-queries (paper Fig. 4): every
  KB-touching enrichment chain becomes its own operator; a final aggregation
  operator joins the intermediate streams.
* ``prune_kb_for``  — the "used KB" extraction per sub-query.
* ``split_agg_plan`` — the aggregation sink rewritten to join upstream
  binding tables (the split sink) instead of decoding their triples.
* ``explain_plan``  — a compiled plan's decisions as a JSON-ready artifact
  (``RegisteredQuery.explain()``).
* ``plan_fingerprint`` / ``plan_shape`` / ``shared_prefix_len`` — the keys
  the serving engine shares work by (``serve/engine.py``).

Closure sets (subclass FILTER env, ``p+``/``p*`` path relations) are always
computed through :mod:`repro_torch.kernels.closure` on the KB's device: the
CUDA kernels on the card, their plain versions on the CPU.

Intermediate streams use the *binding-graph protocol*: each result row of a
sub-query is published as one RDF-graph event ``(row_node, var_pred_v,
value)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import query as Q
from .engine import (
    BindingJoin, DistinctStep, FilterBoolStep, FilterInStep, FilterNumStep,
    KBJoin, OptionalSteps, Plan, ProjectStep, ScanJoin, Step, UnionSteps,
    plan_out_vars,
)
from .kb import KBStats, KnowledgeBase, build_kb, host_rows, prune
from .pattern import CompiledPattern, Slot, SlotMode
from .rdf import CLOSURE_PRED_BASE, NUM_BASE, PRED_SPACE, Vocab
from .reasoner import (
    adjacency_from_edges, build_class_index, descendants, subclass_edges,
)


# --------------------------------------------------------------------------
# variable-length paths: closure-pair relations under synthetic predicates
# --------------------------------------------------------------------------

def closure_path_specs(q: Q.Query) -> List[Tuple[int, int]]:
    """Distinct ``(pred, min_hops)`` closure-path specs in first-seen order;
    spec *i* owns the synthetic predicate ``CLOSURE_PRED_BASE + i``."""
    specs: List[Tuple[int, int]] = []
    for item in q.where:
        if isinstance(item, Q.PathClosure):
            key = (item.pred, item.min_hops)
            if key not in specs:
                specs.append(key)
    if len(specs) > PRED_SPACE - CLOSURE_PRED_BASE:
        raise ValueError(
            "query %r uses %d distinct closure paths; the synthetic "
            "predicate band holds %d"
            % (q.name, len(specs), PRED_SPACE - CLOSURE_PRED_BASE))
    return specs


def _kernel_reach_set(edges: Sequence[Tuple[int, int]], root: int,
                      ancestors: bool, device) -> Set[int]:
    """One root's closure set via the fused descendants/ancestors step."""
    from repro_torch.kernels.closure import ops as cl_ops

    idx, ids = build_class_index(edges)
    if root not in idx:
        return {root}
    adj = adjacency_from_edges(edges, idx)
    op = cl_ops.closure_ancestors if ancestors else cl_ops.closure_descendants
    got, count = op(adj, idx[root], out_cap=len(ids), device=device)
    sel = got.cpu().numpy()[: int(count)]
    return {int(v) for v in ids[sel]}


def closure_kb_key(q: Q.Query) -> Tuple:
    """Everything :func:`augment_kb_with_closures` reads from ``q``: per
    closure spec, in spec order (spec *i* owns ``CLOSURE_PRED_BASE + i``),
    ``(pred, min_hops, start consts, end consts, anchor)``.  The constant
    endpoints of the spec's uses are ``p*``'s extra reflexive pairs and
    the roots of an anchored closure set; ``anchor`` is ``"end"`` (every
    use ends in a constant), ``"start"`` (every use starts in one) or None
    (the full reach matrix).  Queries with equal keys get byte-equal
    augmented KBs; variable names are not part of it."""
    key = []
    for pid, min_hops in closure_path_specs(q):
        uses = [it for it in q.where if isinstance(it, Q.PathClosure)
                and (it.pred, it.min_hops) == (pid, min_hops)]
        starts, ends = (tuple(sorted({int(t.id) for t in terms
                                      if isinstance(t, Q.Const)}))
                        for terms in ([u.start for u in uses],
                                      [u.end for u in uses]))
        if all(isinstance(u.end, Q.Const) for u in uses):
            anchor = "end"
        elif all(isinstance(u.start, Q.Const) for u in uses):
            anchor = "start"
        else:
            anchor = None
        key.append((pid, min_hops, starts, ends, anchor))
    return tuple(key)


def _closure_pairs(edges: Sequence[Tuple[int, int]], min_hops: int,
                   starts: Sequence[int], ends: Sequence[int],
                   anchor: Optional[str], device) -> Set[Tuple[int, int]]:
    """The pair relation ``{(x, y) : x pred^n y, n >= min_hops}`` of one
    :func:`closure_kb_key` entry.

    ``p*``'s zero-length pairs are reflexive over the predicate's edge-graph
    nodes plus the constant endpoints of the query's path expressions.  When
    every use anchors the same endpoint with a constant, only that
    endpoint's closure set is materialized (the fused descendants step);
    otherwise the full reach matrix is closed once.
    """
    pairs: Set[Tuple[int, int]] = set()
    if min_hops == 0:
        refl = {x for e in edges for x in e} | set(starts) | set(ends)
        pairs |= {(x, x) for x in refl}
    if not edges:
        return pairs

    if anchor is not None:
        # p+ composes one explicit edge onto the p* set: the first edge for
        # descendants (x -> z ->* root), the last for ancestors
        const_end = anchor == "end"
        for root in (ends if const_end else starts):
            star = _kernel_reach_set(edges, root, not const_end, device)
            if const_end:
                if min_hops == 0:
                    pairs |= {(x, root) for x in star}
                else:
                    pairs |= {(s, root) for s, o in edges if o in star}
            else:
                if min_hops == 0:
                    pairs |= {(root, y) for y in star}
                else:
                    pairs |= {(root, o) for s, o in edges if s in star}
        return pairs

    # mixed / variable endpoints: close the whole reach matrix once
    from repro_torch.kernels.closure import ops as cl_ops

    idx, ids = build_class_index(edges)
    adj = adjacency_from_edges(edges, idx)
    reach = cl_ops.transitive_closure(adj, max_depth=len(idx),
                                      device=device).cpu().numpy()
    if min_hops == 1:
        reach = (adj @ reach.astype(np.float32)) > 0.5
    pairs |= {(int(ids[i]), int(ids[j])) for i, j in zip(*np.nonzero(reach))}
    return pairs


def augment_kb_with_closures(q: Q.Query, kb: KnowledgeBase) -> KnowledgeBase:
    """Materialize every variable-length path of ``q`` as closure-pair rows
    ``(x, CLOSURE_PRED_BASE + i, y)`` appended to the KB (on its device).
    It reads ``q`` only through :func:`closure_kb_key`."""
    key = closure_kb_key(q)
    if not key:
        return kb
    rows = host_rows(kb)
    parts = [rows]
    for i, (pid, min_hops, starts, ends, anchor) in enumerate(key):
        m = rows[:, 1] == np.uint32(pid)
        edges = [(int(s), int(o)) for s, _, o in rows[m]]
        pairs = _closure_pairs(edges, min_hops, starts, ends, anchor,
                               kb.device)
        arr = np.asarray(sorted(pairs), np.uint32).reshape(-1, 2)
        cp = np.full((len(arr), 1), CLOSURE_PRED_BASE + i, np.uint32)
        parts.append(np.concatenate([arr[:, :1], cp, arr[:, 1:]], axis=1))
    out = np.concatenate(parts, axis=0)
    return build_kb(out[:, 0], out[:, 1], out[:, 2], None, kb.device)


# --------------------------------------------------------------------------
# KB-access cost model (``kb_method="auto"``)
# --------------------------------------------------------------------------

PROBE_K_CAP = 64    # largest k_max the planner will derive for a probe


def _round_up_k(fanout: int) -> int:
    """Observed max fan-out rounded up to a multiple of 8, floor 8."""
    return max(8, ((int(fanout) + 7) // 8) * 8)


def _choose_kb_method(cp: CompiledPattern, kb_stats: Optional[KBStats],
                      default_k: int) -> Tuple[str, int]:
    """Per-join access-method selection from host-side KB statistics: a
    probe (const predicate + anchored endpoint) with a derived ``k_max``
    that covers the observed fan-out, or the fused scan."""
    if kb_stats is None:
        return "scan", default_k
    if cp.p.mode != SlotMode.CONST or (
            cp.s.mode == SlotMode.FREE and cp.o.mode == SlotMode.FREE):
        return "scan", default_k
    stat = kb_stats.preds.get(int(cp.p.const))
    if stat is None:
        # predicate absent from this slice: every probe is an instant miss
        return "probe", _round_up_k(0)
    fanout = stat.k_ps if cp.s.mode != SlotMode.FREE else stat.k_po
    if fanout > PROBE_K_CAP:
        return "scan", default_k
    k = _round_up_k(fanout)
    n = max(1, kb_stats.total_rows)
    if math.ceil(math.log2(n + 1)) + k >= n:
        return "scan", default_k          # tiny partition: scan is cheaper
    return "probe", k


def _kb_item_var_names(item: Q.WhereItem) -> Set[str]:
    if isinstance(item, Q.Pattern):
        return set(item.vars())
    if isinstance(item, (Q.PathKB, Q.PathClosure)):
        return {t.name for t in (item.start, item.end) if isinstance(t, Q.Var)}
    if isinstance(item, Q.FilterSubclass):
        return {item.var}
    return set()


def _kb_item_cost(item: Q.WhereItem, kb_stats: KBStats,
                  closure_specs: Sequence[Tuple[int, int]],
                  bound_names: Set[str]) -> float:
    """Estimated per-binding fan-out of one KB item (lower = more
    selective), given the variable names bound before it runs."""

    def pat_cost(s_term, pred: Optional[int], o_term) -> float:
        if pred is None:                       # variable predicate: full scan
            return float(kb_stats.total_rows)
        stat = kb_stats.preds.get(int(pred))
        if stat is None:
            return 0.0                         # empty relation: kills all rows

        def anchored(t) -> bool:
            return isinstance(t, Q.Const) or (
                isinstance(t, Q.Var) and t.name in bound_names)

        if anchored(s_term):
            return float(stat.k_ps)
        if anchored(o_term):
            return float(stat.k_po)
        return float(stat.rows)                # unanchored: rows x bindings

    if isinstance(item, Q.Pattern):
        pred = item.p.id if isinstance(item.p, Q.Const) else None
        return pat_cost(item.s, pred, item.o)
    if isinstance(item, Q.PathKB):
        end = item.end if len(item.preds) == 1 else Q.Var("__chain")
        return pat_cost(item.start, item.preds[0], end)
    if isinstance(item, Q.PathClosure):
        cp = CLOSURE_PRED_BASE + closure_specs.index((item.pred, item.min_hops))
        return pat_cost(item.start, cp, item.end)
    if isinstance(item, Q.FilterSubclass):
        return pat_cost(Q.Var(item.var), item.type_pred, Q.Var("__cls"))
    return float("inf")


def order_kb_items(items: List[Q.WhereItem], kb_stats: KBStats,
                   closure_specs: Sequence[Tuple[int, int]],
                   bound_names: Set[str]) -> List[Q.WhereItem]:
    """Greedy selectivity ordering of a query's KB-join sequence (ties keep
    listed order).  Output-invariant thanks to ``canonical_order``."""
    names = set(bound_names)
    pending = list(enumerate(items))
    ordered: List[Q.WhereItem] = []
    while pending:
        idx, best = min(
            pending,
            key=lambda t: (_kb_item_cost(t[1], kb_stats, closure_specs,
                                         names), t[0]),
        )
        pending.remove((idx, best))
        ordered.append(best)
        names |= _kb_item_var_names(best)
    return ordered


# --------------------------------------------------------------------------
# compilation
# --------------------------------------------------------------------------

class _VarTable:
    def __init__(self) -> None:
        self.names: List[str] = []

    def col(self, name: str) -> int:
        if name not in self.names:
            self.names.append(name)
        return self.names.index(name)


def _slot(term: Q.Term, vt: _VarTable, bound: Set[int]) -> Slot:
    if isinstance(term, Q.Const):
        return Slot.const_(term.id)
    c = vt.col(term.name)
    return Slot.bound(c) if c in bound else Slot.free(c)


def _compile_pattern(pat: Q.Pattern, vt: _VarTable, bound: Set[int],
                     scan: bool = False) -> CompiledPattern:
    """Resolve slot modes.  ``scan=True`` compiles a window scan pattern:
    every variable slot is FREE (equality with earlier bindings is enforced
    by the natural join on the shared columns)."""
    s = _slot(pat.s, vt, bound)
    p = _slot(pat.p, vt, bound)
    o = _slot(pat.o, vt, bound)
    if scan:
        s, p, o = (
            Slot.free(sl.var) if sl.mode != SlotMode.CONST else sl
            for sl in (s, p, o)
        )
    for sl in (s, p, o):
        if sl.mode == SlotMode.FREE:
            bound.add(sl.var)
    return CompiledPattern(s, p, o)


def _compile_filter_expr(e: Q.FilterExpr, vt: "_VarTable") -> Tuple:
    if isinstance(e, Q.FilterNum):
        return ("cmp", vt.col(e.var), e.op, e.value_id)
    if e.op == "not":
        return ("not", _compile_filter_expr(e.args[0], vt))
    return (e.op,) + tuple(_compile_filter_expr(a, vt) for a in e.args)


def _scan_shared(cp: CompiledPattern, before: Set[int]) -> Tuple[int, ...]:
    return tuple(sorted(
        {sl.var for sl in (cp.s, cp.p, cp.o) if sl.mode != SlotMode.CONST}
        & before))


def compile_query(
    q: Q.Query,
    kb_method: str = "scan",
    scan_cap: int = 128,
    bind_cap: int = 256,
    out_cap: int = 512,
    k_max: int = 8,
    kb_stats: Optional[KBStats] = None,
    fuse_compaction: bool = True,
) -> Plan:
    """Compile the AST into a Plan (same decisions as the reference:
    stream patterns in connected listed order, then KB items — cost-ordered
    under ``kb_method="auto"`` with stats — then OPTIONAL/UNION groups,
    filters as soon as their variables are bound).  Every KB join carries
    ``fuse_compaction`` (False: the unfused scan join)."""
    vt = _VarTable()
    bound: Set[int] = set()
    steps: List[Step] = []
    pending_filters: List[Q.WhereItem] = []
    aux = [0]
    closure_specs = closure_path_specs(q)

    def _kb_step(cp: CompiledPattern) -> KBJoin:
        method, k = kb_method, k_max
        if kb_method == "auto":
            method, k = _choose_kb_method(cp, kb_stats, k_max)
        return KBJoin(cp, method, k, fuse_compaction)

    def fresh_aux() -> str:
        aux[0] += 1
        return "__aux%d" % aux[0]

    def _filter_vars(item) -> Tuple[str, ...]:
        return (item.var,) if isinstance(item, Q.FilterNum) else item.vars()

    def _filter_step(item) -> Step:
        if isinstance(item, Q.FilterNum):
            return FilterNumStep(vt.col(item.var), item.op, item.value_id)
        return FilterBoolStep(_compile_filter_expr(item, vt))

    def flush_filters():
        for item in list(pending_filters):
            if all(vt.col(v) in bound for v in _filter_vars(item)):
                steps.append(_filter_step(item))
                pending_filters.remove(item)

    # pass 1: stream patterns, each after the first sharing a variable with
    # the already-joined set where possible (no cross joins)
    remaining = [
        it for it in q.where if isinstance(it, Q.Pattern) and it.src == Q.STREAM
    ]
    for item in q.where:
        if isinstance(item, (Q.FilterNum, Q.FilterBool)):
            pending_filters.append(item)
    bound_names: Set[str] = set()
    while remaining:
        pick = next(
            (p for p in remaining if set(p.vars()) & bound_names), remaining[0]
        )
        remaining.remove(pick)
        shared_before = set(bound)
        cp = _compile_pattern(pick, vt, bound, scan=True)
        bound_names |= set(pick.vars())
        steps.append(ScanJoin(cp, _scan_shared(cp, shared_before)))
        flush_filters()

    # pass 2: KB patterns / paths / subclass reasoning
    kb_items: List[Q.WhereItem] = [
        it for it in q.where
        if (isinstance(it, Q.Pattern) and it.src == Q.KB)
        or isinstance(it, (Q.PathKB, Q.PathClosure, Q.FilterSubclass))
    ]
    if kb_method == "auto" and kb_stats is not None and len(kb_items) > 1:
        kb_items = order_kb_items(kb_items, kb_stats, closure_specs,
                                  bound_names)
    for item in kb_items:
        if isinstance(item, Q.Pattern) and item.src == Q.KB:
            steps.append(_kb_step(_compile_pattern(item, vt, bound)))
        elif isinstance(item, Q.PathKB):
            cur: Q.Term = item.start
            for i, pid in enumerate(item.preds):
                nxt = item.end if i == len(item.preds) - 1 else Q.Var(fresh_aux())
                cp = _compile_pattern(
                    Q.Pattern(cur, Q.Const(pid), nxt, Q.KB), vt, bound)
                steps.append(_kb_step(cp))
                cur = nxt
        elif isinstance(item, Q.PathClosure):
            # one join against the materialized closure-pair relation
            cp_pred = CLOSURE_PRED_BASE + closure_specs.index(
                (item.pred, item.min_hops))
            cp = _compile_pattern(
                Q.Pattern(item.start, Q.Const(cp_pred), item.end, Q.KB),
                vt, bound)
            steps.append(_kb_step(cp))
        elif isinstance(item, Q.FilterSubclass):
            cls_var = Q.Var(fresh_aux())
            cp = _compile_pattern(
                Q.Pattern(Q.Var(item.var), Q.Const(item.type_pred), cls_var,
                          Q.KB), vt, bound)
            steps.append(_kb_step(cp))
            steps.append(
                FilterInStep(vt.col(cls_var.name), "closure:%d" % item.super_class))
        flush_filters()

    # pass 3: optional / union groups
    for item in q.where:
        if isinstance(item, Q.OptionalGroup):
            shared_before = set(bound)
            sub_steps: List[Step] = []
            sub_bound: Set[int] = set()
            for p in item.patterns:
                if p.src == Q.KB:
                    sub_steps.append(_kb_step(_compile_pattern(p, vt, sub_bound)))
                else:
                    before = set(sub_bound)
                    cp = _compile_pattern(p, vt, sub_bound, scan=True)
                    sub_steps.append(ScanJoin(cp, _scan_shared(cp, before)))
            bound |= sub_bound
            shared = tuple(sorted(
                shared_before
                & {vt.col(v) for p in item.patterns for v in p.vars()}))
            steps.append(OptionalSteps(tuple(sub_steps), shared))
        elif isinstance(item, Q.UnionGroup):
            union_before = set(bound)

            def _branch(pats: Tuple[Q.Pattern, ...]) -> Tuple[Step, ...]:
                bs: List[Step] = []
                br_bound = set(union_before)
                for p in pats:
                    if p.src == Q.KB:
                        bs.append(_kb_step(_compile_pattern(p, vt, br_bound)))
                    else:
                        before = set(br_bound)
                        cp = _compile_pattern(p, vt, br_bound, scan=True)
                        bs.append(ScanJoin(cp, _scan_shared(cp, before)))
                bound.update(br_bound)
                return tuple(bs)

            steps.append(UnionSteps(_branch(item.left), _branch(item.right)))
        flush_filters()

    # any filters whose variables only appear in construct scope
    for item in pending_filters:
        steps.append(_filter_step(item))

    def tslot(t):
        if isinstance(t, Q.RowId):
            return ("row", t.ns * (1 << 18))   # per-operator id namespace
        if isinstance(t, Q.Const):
            return ("const", t.id)
        return ("var", vt.col(t.name))

    templates = tuple(
        (tslot(t.s), tslot(t.p), tslot(t.o)) for t in q.construct
    )
    return Plan(
        name=q.name,
        num_vars=max(1, len(vt.names)),
        var_names=tuple(vt.names) or ("_",),
        steps=tuple(steps),
        templates=templates,
        scan_cap=scan_cap,
        bind_cap=bind_cap,
        out_cap=out_cap,
    )


def plan_supports_delta(plan: Plan) -> bool:
    """Whether incremental (slide-delta) evaluation is valid for ``plan``.

    ``engine.run_plan_slides`` tracks, per binding row, the span of slides
    its stream triples came from and selects each window's rows by an
    interval test, which is sound only when every step is *monotone* (a
    derivation exists in a window iff all its contributing triples do):
    stream scans, KB joins of any method, filters, UNION and BindingJoin
    (a table row carries the union span of its contributing slides, and
    the max-merge unions spans across the join).  OPTIONAL is
    non-monotone, and a plan without output variables skips the
    pre-CONSTRUCT distinct, making row multiplicity observable; both fall
    back to per-window recompute.
    """
    def steps_ok(steps: Sequence[Step]) -> bool:
        for s in steps:
            if isinstance(s, UnionSteps):
                if not (steps_ok(s.left) and steps_ok(s.right)):
                    return False
            elif not isinstance(s, (ScanJoin, KBJoin, FilterNumStep,
                                    FilterBoolStep, FilterInStep,
                                    BindingJoin)):
                return False
        return True

    has_out = any(kind == "var" for tpl in plan.templates for kind, _ in tpl)
    return has_out and steps_ok(plan.steps)


def plan_caps(plan: Plan) -> Dict[str, int]:
    """The plan's capacities plus the largest probe ``k_max`` any KBJoin
    carries."""
    def max_k(steps: Sequence[Step]) -> int:
        k = 0
        for s in steps:
            if isinstance(s, KBJoin) and s.method == "probe":
                k = max(k, s.k_max)
            elif isinstance(s, OptionalSteps):
                k = max(k, max_k(s.sub))
            elif isinstance(s, UnionSteps):
                k = max(k, max_k(s.left), max_k(s.right))
        return k

    return {"scan_cap": plan.scan_cap, "bind_cap": plan.bind_cap,
            "out_cap": plan.out_cap, "k_max": max_k(plan.steps)}


# --------------------------------------------------------------------------
# plan sharing (the serving engine's keys, serve/engine.py)
# --------------------------------------------------------------------------
# * identical plans    — ``plan_fingerprint`` (the plan minus its name):
#   equal fingerprints on the same (KB, env) publish identical outputs, so
#   the serving engine evaluates one representative and fans it out;
# * identical shapes   — ``plan_shape`` abstracts every constant (slot
#   consts, filter literals, CONSTRUCT const ids, closure-set env keys)
#   into positional markers: plans with equal shapes differ only in a
#   ``uint32`` vector (``plan_consts``) and their env tensors, and
#   ``bind_plan_consts`` rebuilds each from the representative;
# * identical prefixes — ``shared_prefix_len`` finds the longest common
#   leading step run of two plans, so a common KB-join prefix runs once
#   and each query runs only its own suffix.

def plan_fingerprint(plan: Plan) -> Tuple:
    """Everything significant about a compiled plan except its name.  Two
    plans with equal fingerprints, run against the same KB and env,
    publish byte-identical streams: the serving layer's dedup key."""
    return (plan.num_vars, plan.var_names, plan.steps, plan.templates,
            plan.scan_cap, plan.bind_cap, plan.out_cap)


def _map_plan_consts(plan: Plan, const_fn, set_fn) -> Plan:
    """Rebuild ``plan`` with ``const_fn(value, ctx)`` applied to every
    constant (``ctx`` is ``"slot"``, ``"filter"`` or ``"template"``) and
    ``set_fn(name)`` to every :class:`FilterInStep` env key: the one walk
    order shape, extraction and binding share, so they cannot disagree."""

    def map_slot(sl: Slot) -> Slot:
        if sl.mode != SlotMode.CONST:
            return sl
        return Slot(SlotMode.CONST, const=const_fn(sl.const, "slot"), var=-1)

    def map_pat(cp: CompiledPattern) -> CompiledPattern:
        return CompiledPattern(map_slot(cp.s), map_slot(cp.p), map_slot(cp.o))

    def map_expr(expr: Tuple) -> Tuple:
        if expr[0] == "cmp":
            _, var, op, value_id = expr
            return ("cmp", var, op, const_fn(value_id, "filter"))
        if expr[0] == "not":
            return ("not", map_expr(expr[1]))
        return (expr[0],) + tuple(map_expr(a) for a in expr[1:])

    def map_step(step: Step) -> Step:
        if isinstance(step, ScanJoin):
            return ScanJoin(map_pat(step.pat), step.shared)
        if isinstance(step, KBJoin):
            return dataclasses.replace(step, pat=map_pat(step.pat))
        if isinstance(step, FilterNumStep):
            return FilterNumStep(step.var, step.op,
                                 const_fn(step.value_id, "filter"))
        if isinstance(step, FilterBoolStep):
            return FilterBoolStep(map_expr(step.expr))
        if isinstance(step, FilterInStep):
            return FilterInStep(step.var, set_fn(step.set_name))
        if isinstance(step, OptionalSteps):
            return OptionalSteps(tuple(map_step(s) for s in step.sub),
                                 step.shared)
        if isinstance(step, UnionSteps):
            return UnionSteps(tuple(map_step(s) for s in step.left),
                              tuple(map_step(s) for s in step.right))
        return step

    def map_tpl(spec: Tuple) -> Tuple:
        kind, val = spec
        if kind == "const":
            return ("const", const_fn(val, "template"))
        return spec

    return dataclasses.replace(
        plan,
        steps=tuple(map_step(s) for s in plan.steps),
        templates=tuple(tuple(map_tpl(spec) for spec in tpl)
                        for tpl in plan.templates),
    )


def _is_term(value: int) -> bool:
    return int(value) < NUM_BASE


def _canonical_sets():
    sets: Dict[str, str] = {}

    def set_fn(name):
        if name not in sets:
            sets[name] = "__set%d" % len(sets)
        return sets[name]

    return set_fn


def plan_shape(plan: Plan) -> Plan:
    """The plan with every constant replaced by a positional marker and
    every env key by a canonical ``__set%d`` name, name cleared: the
    cohort key.  Filter-literal markers also carry the term-or-numeric
    class, which selects the comparison's semantics."""
    counter = [0]

    def const_fn(value, ctx):
        i = counter[0]
        counter[0] += 1
        if ctx == "filter":
            return ("c%d" % i, _is_term(value))
        return "c%d" % i

    return dataclasses.replace(
        _map_plan_consts(plan, const_fn, _canonical_sets()), name="")


def plan_consts(plan: Plan) -> np.ndarray:
    """The plan's constants as a ``uint32`` vector in ``plan_shape``'s walk
    order: with the env tensors, all that tells apart two plans of one
    shape."""
    vals: List[int] = []

    def const_fn(value, ctx):
        vals.append(int(value))
        return value

    _map_plan_consts(plan, const_fn, lambda n: n)
    return np.asarray(vals, np.uint32)


def plan_set_names(plan: Plan) -> Tuple[str, ...]:
    """FilterInStep env keys in first-appearance walk order: a cohort
    member's env tensor for ``__set%d`` is its entry at index ``d``."""
    names: List[str] = []

    def set_fn(name):
        if name not in names:
            names.append(name)
        return name

    _map_plan_consts(plan, lambda v, c: v, set_fn)
    return tuple(names)


def bind_plan_consts(plan: Plan, const_vec) -> Plan:
    """Substitute ``const_vec[i]`` (one row of a cohort's ``[Q, K]``
    ``uint32`` matrix) for the plan's constants as host ints, renaming env
    keys canonically.  A filter literal keeps the representative's
    term-or-numeric class (part of the cohort shape): a value of the other
    class raises."""
    counter = [0]

    def const_fn(value, ctx):
        i = counter[0]
        counter[0] += 1
        v = int(const_vec[i])
        if ctx == "filter" and _is_term(v) != _is_term(value):
            raise ValueError(
                "constant %d of plan %r is a %s literal; %d is not"
                % (i, plan.name, "term" if _is_term(value) else "numeric", v))
        return v

    return _map_plan_consts(plan, const_fn, _canonical_sets())


def shared_prefix_len(a: Plan, b: Plan) -> int:
    """Longest common leading step run of two plans.  It binds the same
    columns in both only when they agree on ``num_vars`` and capacities
    (compilation is deterministic), which the serving engine checks."""
    n = 0
    for sa, sb in zip(a.steps, b.steps):
        if sa != sb:
            break
        n += 1
    return n


def count_kb_joins(steps: Sequence[Step]) -> int:
    """KB joins in a step sequence: the work prefix sharing saves, and
    what decides whether a shared prefix is worth a program."""
    total = 0
    for s in steps:
        if isinstance(s, KBJoin):
            total += 1
        elif isinstance(s, OptionalSteps):
            total += count_kb_joins(s.sub)
        elif isinstance(s, UnionSteps):
            total += count_kb_joins(s.left) + count_kb_joins(s.right)
    return total


def _render_slot(slot: Slot, plan: Plan, vocab: Optional[Vocab]) -> str:
    if slot.mode == SlotMode.CONST:
        cid = int(slot.const)
        if CLOSURE_PRED_BASE <= cid < PRED_SPACE:
            return "<closure#%d>" % (cid - CLOSURE_PRED_BASE)
        return vocab.to_str(cid) if vocab is not None else "<%d>" % cid
    name = (plan.var_names[slot.var] if slot.var < len(plan.var_names)
            else "_%d" % slot.var)
    return "?" + name


def _render_pattern(cp: CompiledPattern, plan: Plan,
                    vocab: Optional[Vocab]) -> str:
    return " ".join(_render_slot(sl, plan, vocab) for sl in (cp.s, cp.p, cp.o))


def _names(plan: Plan, cols: Sequence[int]) -> List[str]:
    return [plan.var_names[c] if c < len(plan.var_names) else "_%d" % c
            for c in cols]


def _explain_steps(
    steps: Sequence[Step], plan: Plan, kb_stats: Optional[KBStats],
    vocab: Optional[Vocab],
) -> List[Dict]:
    out: List[Dict] = []
    for step in steps:
        if isinstance(step, ScanJoin):
            out.append({
                "step": "ScanJoin",
                "pattern": _render_pattern(step.pat, plan, vocab),
                "shared": _names(plan, step.shared),
            })
        elif isinstance(step, KBJoin):
            entry: Dict = {
                "step": "KBJoin",
                "pattern": _render_pattern(step.pat, plan, vocab),
                "method": step.method,
            }
            if step.method == "probe":
                entry["k_max"] = step.k_max
            cp = step.pat
            if cp.s.mode != SlotMode.FREE:
                entry["anchor"] = "s"
            elif cp.o.mode != SlotMode.FREE:
                entry["anchor"] = "o"
            if kb_stats is not None and cp.p.mode == SlotMode.CONST:
                stat = kb_stats.preds.get(int(cp.p.const))
                if stat is None:
                    entry["est_rows"], entry["est_fanout"] = 0, 0.0
                else:
                    entry["est_rows"] = int(stat.rows)
                    fan = (stat.k_ps if cp.s.mode != SlotMode.FREE
                           else stat.k_po if cp.o.mode != SlotMode.FREE
                           else stat.rows)
                    entry["est_fanout"] = float(fan)
            out.append(entry)
        elif isinstance(step, FilterNumStep):
            out.append({
                "step": "FilterNum",
                "pattern": "?%s %s %s" % (
                    plan.var_names[step.var], step.op,
                    vocab.to_str(step.value_id) if vocab is not None
                    else step.value_id),
            })
        elif isinstance(step, FilterBoolStep):
            out.append({"step": "FilterBool", "pattern": repr(step.expr)})
        elif isinstance(step, FilterInStep):
            out.append({
                "step": "FilterIn",
                "pattern": "?%s in env[%s]" % (
                    plan.var_names[step.var], step.set_name),
            })
        elif isinstance(step, OptionalSteps):
            out.append({
                "step": "Optional",
                "shared": _names(plan, step.shared),
                "sub": _explain_steps(step.sub, plan, kb_stats, vocab),
            })
        elif isinstance(step, UnionSteps):
            out.append({
                "step": "Union",
                "left": _explain_steps(step.left, plan, kb_stats, vocab),
                "right": _explain_steps(step.right, plan, kb_stats, vocab),
            })
        elif isinstance(step, BindingJoin):
            out.append({
                "step": "BindingJoin",
                "source": step.source,
                "cols": _names(plan, step.cols),
                "shared": _names(plan, step.shared),
                "replace": step.replace,
            })
        elif isinstance(step, DistinctStep):
            out.append({"step": "Distinct"})
        elif isinstance(step, ProjectStep):
            out.append({"step": "Project", "pattern": ", ".join(
                "?" + n for n in _names(plan, step.keep))})
        else:
            out.append({"step": type(step).__name__})
    return out


def explain_plan(
    plan: Plan, kb_stats: Optional[KBStats] = None,
    vocab: Optional[Vocab] = None,
) -> Dict:
    """The compiled plan's decisions as a JSON-ready artifact.

    Per step: the rendered pattern, the chosen KB-access method and derived
    ``k_max`` and — when ``kb_stats`` (from
    :func:`repro_torch.core.kb.collect_kb_stats`) is supplied — the estimated
    per-binding fan-out the cost model compared (``est_fanout``) and the
    relation size (``est_rows``).  The step list order *is* the join order
    the cost model committed to.  Pure host-side introspection: no step
    runs.
    """
    return {
        "plan": plan.name,
        "var_names": list(plan.var_names),
        "caps": plan_caps(plan),
        "delta_capable": plan_supports_delta(plan),
        "steps": _explain_steps(plan.steps, plan, kb_stats, vocab),
        "construct_templates": len(plan.templates),
    }



# --------------------------------------------------------------------------
# environment (closure sets) and KB pruning — the "used KB" machinery
# --------------------------------------------------------------------------

def prepare_env(q: Q.Query, kb: KnowledgeBase) -> Dict[str, torch.Tensor]:
    """Closure sets required by the query's reasoning filters, computed by
    the closure kernels on the KB's device."""
    env: Dict[str, torch.Tensor] = {}
    for item in q.where:
        if isinstance(item, Q.FilterSubclass):
            key, arr = closure_env_entry(kb, item.subclass_pred,
                                         item.super_class)
            env[key] = arr
    return env


def closure_env_entry(kb: KnowledgeBase, subclass_pred: int,
                      super_class: int) -> Tuple[str, torch.Tensor]:
    """One :func:`prepare_env` entry: ``("closure:<super>", sorted ids)``."""
    edges = subclass_edges(kb, subclass_pred)
    ids = _closure_set(edges, super_class, kb.device)
    return "closure:%d" % super_class, torch.from_numpy(
        ids.astype(np.int64)).to(kb.device)


def _closure_set(edges, root: int, device) -> np.ndarray:
    if edges:
        idx, ids = build_class_index(edges)
        if root in idx:
            from repro_torch.kernels.closure import ops as cl_ops

            adj = adjacency_from_edges(edges, idx)
            dids, count = cl_ops.closure_descendants(
                adj, idx[root], out_cap=len(ids), device=device)
            sel = dids.cpu().numpy()[: int(count)]
            return np.sort(ids[sel]).astype(np.uint32)
    # no subclass edge touches the root: the closure is just {root}
    return np.asarray([root], np.uint32)


def kb_signature(q: Q.Query) -> Tuple[Tuple[int, ...], Dict[int, Set[int]]]:
    """(predicates, {pred: allowed objects}) this query can ever touch."""
    return tuple(q.kb_predicates()), {}


def prune_kb_for(q: Q.Query, kb: KnowledgeBase, capacity: Optional[int] = None,
                 closure_narrow: bool = True) -> KnowledgeBase:
    """Extract this query's used KB: triples whose predicate the query
    mentions (synthetic closure predicates included), with ``rdf:type`` rows
    of a ``FilterSubclass`` narrowed to the super-class's closure (host BFS).
    """
    specs = closure_path_specs(q)
    preds = tuple(sorted(set(kb_signature(q)[0]) | {
        CLOSURE_PRED_BASE + i for i in range(len(specs))
    }))
    closure_traversed = {pid for pid, _ in specs}
    objects_by_pred: Dict[int, Set[int]] = {}
    if closure_narrow:
        for item in q.where:
            if isinstance(item, Q.FilterSubclass):
                # never narrow a predicate a closure path traverses
                if item.type_pred in closure_traversed:
                    continue
                edges = subclass_edges(kb, item.subclass_pred)
                cls = set(int(c) for c in descendants(edges, item.super_class))
                objects_by_pred.setdefault(item.type_pred, set()).update(cls)
    return prune(kb, preds, objects_by_pred or None, capacity)


# --------------------------------------------------------------------------
# decomposition into an operator DAG (paper Fig. 4)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SubQuery:
    """One SCEP operator's query + its used-KB signature."""

    query: Q.Query
    inputs: Tuple[str, ...] = ("stream",)   # upstream operator names
    touches_kb: bool = False


@dataclasses.dataclass
class OperatorDAG:
    name: str
    subqueries: Dict[str, SubQuery]
    final: str                              # name of the aggregation sub-query
    var_preds: Dict[str, int]               # binding-graph protocol predicates
    row_base: int                           # term id base for row nodes


def _var_pred(vocab: Vocab, name: str) -> int:
    return vocab.pred("?:%s" % name)


def decompose(q: Q.Query, vocab: Vocab) -> OperatorDAG:
    """Split a query into KB-touching enrichment operators + an aggregator.

    KB items are grouped into connected components (shared variables),
    each anchored at the first stream variable it touches; every group
    becomes a sub-query that scans the stream patterns binding its
    variables, runs its KB chain and publishes its bindings on the
    binding-graph protocol.  Stream-only items stay in the final
    aggregation operator, which joins the intermediate streams.
    """
    stream_pats = [
        it for it in q.where if isinstance(it, Q.Pattern) and it.src == Q.STREAM
    ]
    kb_items: List[Q.WhereItem] = [
        it for it in q.where
        if (isinstance(it, Q.Pattern) and it.src == Q.KB)
        or isinstance(it, (Q.PathKB, Q.PathClosure, Q.FilterSubclass))
    ]
    other_items = [
        it for it in q.where if it not in stream_pats and it not in kb_items
    ]

    stream_vars: Set[str] = set()
    for p in stream_pats:
        stream_vars |= set(p.vars())

    n_items = len(kb_items)
    parent = list(range(n_items))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n_items):
        for j in range(i + 1, n_items):
            if _kb_item_var_names(kb_items[i]) & _kb_item_var_names(kb_items[j]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)

    components: Dict[int, List[int]] = {}
    for i in range(n_items):
        components.setdefault(find(i), []).append(i)

    groups: Dict[str, List[int]] = {}
    for root, idxs in sorted(components.items()):
        comp_vars: Set[str] = set()
        for i in idxs:
            comp_vars |= _kb_item_var_names(kb_items[i])
        anchors = sorted(comp_vars & stream_vars)
        anchor = anchors[0] if anchors else "__global"
        groups.setdefault(anchor, []).extend(idxs)

    subqueries: Dict[str, SubQuery] = {}
    var_preds: Dict[str, int] = {}
    row_base = int(vocab.term("row:base"))

    def binding_templates(out_vars: Sequence[str], anchor: str,
                          op_index: int) -> Tuple[Q.ConstructTemplate, ...]:
        ordered = [v for v in out_vars if v == anchor] + [
            v for v in out_vars if v != anchor
        ]
        tpls = []
        for v in ordered:
            var_preds.setdefault(v, _var_pred(vocab, v))
            tpls.append(
                Q.ConstructTemplate(Q.RowId(ns=op_index + 1),
                                    Q.Const(var_preds[v]), Q.Var(v))
            )
        return tuple(tpls)

    covered_pats: List[Q.Pattern] = []
    for i, (anchor, idxs) in enumerate(sorted(groups.items())):
        items = [kb_items[j] for j in sorted(idxs)]   # preserve listed order
        name = "%s_kb%d_%s" % (q.name, i, anchor.strip("?_"))
        needed_vars = set()
        for it in items:
            needed_vars |= _kb_item_var_names(it)
        anchor_pats = [
            p for p in stream_pats if set(p.vars()) & (needed_vars | {anchor})
        ]
        pat_vars = set()
        for p in anchor_pats:
            pat_vars |= set(p.vars())
        out_vars = sorted(
            (needed_vars | pat_vars | {anchor}) & set(q.variables())
        )
        sub_q = Q.Query(
            name=name,
            where=tuple(list(anchor_pats) + list(items)),
            construct=binding_templates(out_vars, anchor, i),
        )
        subqueries[name] = SubQuery(sub_q, inputs=("stream",), touches_kb=True)
        for p in anchor_pats:
            if set(p.vars()) <= set(out_vars):
                covered_pats.append(p)

    final_name = "%s_agg" % q.name
    agg_where: List[Q.WhereItem] = [
        p for p in stream_pats if p not in covered_pats
    ] + list(other_items)
    for name, sub in subqueries.items():
        row_var = "__row_%s" % name
        for tpl in sub.query.construct:
            assert isinstance(tpl.p, Q.Const)
            agg_where.append(
                Q.Pattern(Q.Var(row_var), Q.Const(tpl.p.id), tpl.o, Q.STREAM)
            )
    final_q = Q.Query(name=final_name, where=tuple(agg_where),
                      construct=q.construct, select=q.select)
    subqueries[final_name] = SubQuery(
        final_q,
        inputs=tuple(sorted(subqueries)) + ("stream",),
        touches_kb=bool(final_q.kb_predicates()),
    )
    return OperatorDAG(
        name=q.name,
        subqueries=subqueries,
        final=final_name,
        var_preds=var_preds,
        row_base=row_base,
    )


# --------------------------------------------------------------------------
# split aggregation sink: rewrite the sink plan to join upstream TABLES
# --------------------------------------------------------------------------

def split_agg_plan(plan: Plan, dag: OperatorDAG
                   ) -> Optional[Tuple[Plan, Dict[str, Tuple[str, ...]]]]:
    """Rewrite the aggregation-sink plan to consume upstream binding tables.

    The decomposed sink re-parses the binding-graph protocol: one decode
    ScanJoin per published variable, ``(?__row_u, var_pred_v, ?v)`` over
    the *augmented* window, then natural joins stitch each row back
    together.  This rewrite replaces each upstream's decode-scan group with
    ONE :class:`~repro_torch.core.engine.BindingJoin` against that
    upstream's final binding table, and runs the remaining scans over the
    RAW window: no augmentation, no decode.

    Semantics are kept exactly:

    * a table row is the variable tuple the decode scans would rebuild for
      one published row node (row ids are unique per row, so decode joins
      never mix rows);
    * ``shared`` tuples are *replayed* over the new step order from the
      bound-before sets, so every cross-step equality the decode path
      enforced is enforced here (the max-merge treats non-shared
      overlapping columns as corruption);
    * filters stay in place; a BindingJoin binds an upstream's variables at
      its *first* decode position, never later than the decode chain did.

    Returns ``(rewritten plan, {upstream -> published variable names in
    table column order})``, or ``None`` when the plan falls outside the
    equivalent fragment and the caller keeps the augmented-window path:

    * a stream scan (top level or inside OPTIONAL/UNION) with a variable
      predicate or a predicate in the binding-protocol band: over the
      augmented window it matches the binding triples themselves;
    * a decode step after a KBJoin / OPTIONAL / UNION: those keep their
      compiled bound-mode/shared wiring, valid only when every decode (so
      every BindingJoin) precedes them;
    * an upstream with no decode step in the plan, a plan with no output
      variables (row multiplicity observable), or a Distinct/Project step
      (not produced for sink plans).
    """
    upstreams = [n for n in dag.subqueries if n != dag.final]
    protocol_preds = set(dag.var_preds.values())
    if not plan_out_vars(plan):
        return None

    # map decode ScanJoins to their upstream through the row column
    row_cols = {}
    for u in upstreams:
        row_var = "__row_%s" % u
        if row_var in plan.var_names:
            row_cols[plan.var_col(row_var)] = u

    def scan_ok(cp: CompiledPattern) -> bool:
        # a raw-window scan must match the same rows with and without the
        # binding-triple augmentation
        return (cp.p.mode == SlotMode.CONST
                and int(cp.p.const) not in protocol_preds)

    def group_ok(steps: Sequence[Step]) -> bool:
        # OPTIONAL/UNION bodies: stream scans pass the raw-window test, KB
        # joins and filters never read the window, anything else bails
        for s in steps:
            if isinstance(s, ScanJoin):
                if not scan_ok(s.pat):
                    return False
            elif isinstance(s, OptionalSteps):
                if not group_ok(s.sub):
                    return False
            elif isinstance(s, UnionSteps):
                if not (group_ok(s.left) and group_ok(s.right)):
                    return False
            elif not isinstance(s, (KBJoin, FilterNumStep, FilterBoolStep,
                                    FilterInStep)):
                return False
        return True

    decode_of: Dict[int, str] = {}              # step index -> upstream
    tail = False   # seen a KBJoin/OPTIONAL/UNION
    for i, step in enumerate(plan.steps):
        if isinstance(step, (FilterNumStep, FilterBoolStep, FilterInStep)):
            continue
        if isinstance(step, ScanJoin):
            cp = step.pat
            if (cp.s.mode == SlotMode.FREE and cp.s.var in row_cols
                    and cp.p.mode == SlotMode.CONST
                    and int(cp.p.const) in protocol_preds
                    and cp.o.mode == SlotMode.FREE):
                if tail:
                    return None
                decode_of[i] = row_cols[cp.s.var]
            elif not scan_ok(cp):
                return None
        elif isinstance(step, KBJoin):
            tail = True
        elif isinstance(step, OptionalSteps):
            if not group_ok(step.sub):
                return None
            tail = True
        elif isinstance(step, UnionSteps):
            if not (group_ok(step.left) and group_ok(step.right)):
                return None
            tail = True
        else:
            return None
    if set(decode_of.values()) != set(upstreams):
        return None

    # publication signature per upstream: the CONSTRUCT template order
    # (anchor first, then the rest), the column order of its table
    pub: Dict[str, Tuple[str, ...]] = {}
    for u in upstreams:
        names = tuple(tpl.o.name for tpl in dag.subqueries[u].query.construct)
        if any(n not in plan.var_names for n in names):
            return None
        pub[u] = names

    # splice: each upstream's first decode step becomes its BindingJoin,
    # the rest go; then replay the bound set to recompute every shared
    first_decode: Dict[str, int] = {}
    for i, u in decode_of.items():
        first_decode.setdefault(u, i)
    spliced: List[Step] = []
    for i, step in enumerate(plan.steps):
        u = decode_of.get(i)
        if u is None:
            spliced.append(step)
        elif first_decode[u] == i:
            spliced.append(BindingJoin(
                source=u, cols=tuple(plan.var_col(n) for n in pub[u]),
                shared=()))

    def step_vars(s: Step) -> Set[int]:
        # every column a step can bind (for the bound-set replay)
        if isinstance(s, BindingJoin):
            return set(s.cols)
        if isinstance(s, (ScanJoin, KBJoin)):
            return {sl.var for sl in (s.pat.s, s.pat.p, s.pat.o)
                    if sl.mode != SlotMode.CONST}
        if isinstance(s, OptionalSteps):
            return set().union(set(), *(step_vars(x) for x in s.sub))
        if isinstance(s, UnionSteps):
            return set().union(
                set(), *(step_vars(x) for x in s.left + s.right))
        return set()

    bound: Set[int] = set()
    steps: List[Step] = []
    for step in spliced:
        if isinstance(step, BindingJoin):
            shared = tuple(sorted(set(step.cols) & bound))
            steps.append(dataclasses.replace(
                step, shared=shared, replace=not steps and not shared))
        elif isinstance(step, ScanJoin):
            free = {sl.var for sl in (step.pat.s, step.pat.p, step.pat.o)
                    if sl.mode != SlotMode.CONST}
            steps.append(dataclasses.replace(
                step, shared=tuple(sorted(free & bound))))
        else:
            # KBJoin / OPTIONAL / UNION / filters keep their compiled
            # wiring: every decode (so every BindingJoin) precedes them, and
            # the bound sets they were compiled against differ from the
            # replayed ones only in the __row columns, which no query-level
            # pattern can reference
            steps.append(step)
        bound |= step_vars(step)

    return dataclasses.replace(plan, steps=tuple(steps)), pub
