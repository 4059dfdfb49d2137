"""ServeEngine: many standing C-SPARQL queries over one Session.

A :class:`~repro_torch.core.session.Session` gives every registered query
its own runtime; ``ServeEngine`` keeps one population and shares work at
three granularities, publishing for every query the bytes its own
single-query session would (``tests/test_torch_serve.py`` holds it to the
reference's per-query sessions):

1. **plan dedup**: registrations whose compiled plans have equal
   :func:`~repro_torch.core.planner.plan_fingerprint` on the same KB, env
   and window geometry run once, and the published chunk fans out to every
   member.  Closure-augmented KBs, ``kb_method="auto"`` statistics,
   reasoning closure sets and padded KBs are built once per distinct key
   and shared by identity (``_kb_cache``, ``_kb_stats_cache``,
   ``_env_cache``, ``_kb_pad_cache``).
2. **shared KB-join prefixes**: distinct plans that start with the same
   step run (same caps and width) and whose common prefix holds a KB join
   bind that prefix once per chunk over every window; each member then
   runs its suffix and finalize tail (:func:`~repro_torch.core.engine.
   run_steps`, :func:`~repro_torch.core.engine.finalize_bindings`, the ops
   ``run_plan_windows`` runs).
3. **constant cohorts**: plans with equal
   :func:`~repro_torch.core.planner.plan_shape` (equal up to constants)
   form a cohort over a ``[Q, K]`` constant matrix; each member's plan is
   rebuilt from the representative by
   :func:`~repro_torch.core.planner.bind_plan_consts` and runs over the
   windows the cohort shares.

Windowing (merge + ``count_windows``, or ``count_slides`` for incremental
evaluation, which pack on the host) runs once per window geometry per
chunk, shared by every program of that geometry.  The batched paths (2
and 3) run where the reference runs them, under ``fuse_compaction=False``
without incremental evaluation: there the KB joins take the match-matrix
kernel (scan) or the fused probe join.  Every other registration runs its
own :class:`~repro_torch.core.operator.SCEPOperator` (the fused scan and
probe joins), with dedup fan-out still applied.  ``ServeEngine.last_stats``
reports the schedule and, under ``ExecutionConfig(trace=...)`` with
metrics, per-query engine metrics.

The engine runs on the session's device: the KB is there already, and
each chunk is moved there once.  Per-query overflow counts accumulate in
0-dim tensors on that device, read only by :meth:`ServeEngine.
overflow_totals` and :attr:`ServeEngine.last_stats`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import query as Q
from ..core.engine import (
    _chunk_stats, finalize_bindings, run_plan_windows, run_steps,
)
from ..core.faults import validate_chunk
from ..core.kb import KnowledgeBase, collect_kb_stats, pad_to
from ..core.operator import OperatorConfig, SCEPOperator, publish_chunk
from ..core.pattern import universe_bindings
from ..core.planner import (
    augment_kb_with_closures, bind_plan_consts, closure_env_entry,
    closure_kb_key, compile_query, count_kb_joins, plan_caps, plan_consts,
    plan_fingerprint, plan_set_names, plan_shape, shared_prefix_len,
)
from ..core.rdf import ID_DTYPE, TripleBatch
from ..core.runtime import RuntimeConfig
from ..core.sparql import ParseInfo, parse_query_info, serialize_query
from ..core.stream import merge_streams
from ..core.window import SlideView, Windows, count_slides, count_windows
from ..obs.metrics import finalize_stats, merge_stats
from ..obs.report import attach_saturation
from ..obs.trace import resolve_trace
from .batcher import QueryAdmission


# --------------------------------------------------------------------------
# a registered serving unit
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServeUnit:
    """One standing query as the engine sees it: compiled plan, shared
    KB and env, window geometry and its own operator."""

    name: str
    query: Q.Query
    info: Optional[ParseInfo]
    text: str
    plan: Any
    kb: Optional[KnowledgeBase]
    env: Dict[str, torch.Tensor]
    rcfg: RuntimeConfig
    op: SCEPOperator

    @property
    def geometry(self) -> Tuple:
        r = self.rcfg
        return (r.window_capacity, r.max_windows, r.window_step,
                r.incremental)

    @property
    def env_sig(self) -> Tuple:
        # env tensors come from the engine's shared cache, so identity
        # equality is value equality here
        return tuple(sorted((k, id(v)) for k, v in self.env.items()))


@dataclasses.dataclass
class _Group:
    """A dedup group: one representative evaluation, fanned out."""

    rep: ServeUnit
    members: List[ServeUnit]


# --------------------------------------------------------------------------
# executables: one program each
# --------------------------------------------------------------------------

class _OpExec:
    """A singleton or a registration the batched paths do not take: the
    group's own SCEPOperator."""

    kind = "operator"

    def __init__(self, group: _Group):
        self.groups = [group]

    def run(self, engine: "ServeEngine", chunk: TripleBatch, wcache: Dict):
        # SCEPOperator.process on the windows (or slides) the engine packed
        # for this geometry once per chunk
        g = self.groups[0]
        op = g.rep.op
        view = engine._windows_for(g.rep.geometry, chunk, wcache)
        step = (op.process_slides if op.config.incremental
                else op.process_windows)
        out_w, ovf, *stats = step(view, engine._collect)
        for st in stats:
            merge_stats(engine._stats_acc.setdefault(g.rep.name, {}), st)
        return [(g, publish_chunk(out_w, op.config.out_stream_cap), ovf)]


class _PrefixExec:
    """Distinct plans sharing a step prefix that holds a KB join: the
    prefix binds once over every window of the chunk, then each member
    runs its suffix, finalize and publish."""

    kind = "prefix"

    def __init__(self, groups: List[_Group], prefix_len: int):
        self.groups = groups
        self.prefix_len = prefix_len
        self.kb_joins_shared = count_kb_joins(
            groups[0].rep.plan.steps[:prefix_len])

    def run(self, engine: "ServeEngine", chunk: TripleBatch, wcache: Dict):
        rep0 = self.groups[0].rep
        p = self.prefix_len
        windows = engine._windows_for(rep0.geometry, chunk, wcache)
        tri, wvalid = windows.triples, windows.window_valid
        w, dev = windows.num_windows, wvalid.device
        stats = {} if engine._collect else None
        cur = universe_bindings(w, rep0.plan.bind_cap, rep0.plan.num_vars, dev)
        cur = run_steps(rep0.plan, cur, rep0.plan.steps[:p], tri, rep0.kb,
                        rep0.env, stats=stats)
        ts = torch.where(tri.valid, tri.ts, torch.zeros_like(tri.ts)).amax(-1)
        wid = torch.arange(w, dtype=ID_DTYPE, device=dev)
        res = []
        for g in self.groups:
            u = g.rep
            st = dict(stats) if stats is not None else None
            c = run_steps(u.plan, cur, u.plan.steps[p:], tri, rep0.kb, u.env,
                          stats=st)
            out, ovf = finalize_bindings(u.plan, c, ts, wid * u.plan.bind_cap,
                                         st)
            out = out._replace(valid=out.valid & wvalid[:, None])
            if st is not None:
                merge_stats(engine._stats_acc.setdefault(u.name, {}),
                            _chunk_stats(st, wvalid))
            res.append((g, publish_chunk(out, u.rcfg.out_stream_cap), ovf))
        return res


class _CohortExec:
    """Plans of one shape: a ``[Q, K]`` constant matrix over one
    representative plan, each member's env tensors under the canonical
    ``__set%d`` keys, and the windows the members share.  The members run
    one after another."""

    kind = "cohort"

    def __init__(self, groups: List[_Group]):
        self.groups = groups
        rep = groups[0].rep
        self.const_mat = np.stack(
            [plan_consts(g.rep.plan) for g in groups])     # [Q, K] uint32
        self.plans = [bind_plan_consts(rep.plan, row)
                      for row in self.const_mat]
        self.envs = [
            {"__set%d" % j: g.rep.env[n]
             for j, n in enumerate(plan_set_names(g.rep.plan))}
            for g in groups]

    def run(self, engine: "ServeEngine", chunk: TripleBatch, wcache: Dict):
        rep = self.groups[0].rep
        windows = engine._windows_for(rep.geometry, chunk, wcache)
        res = []
        for g, plan, env in zip(self.groups, self.plans, self.envs):
            out_w, ovf, *stats = run_plan_windows(
                plan, windows, rep.kb, env, with_stats=engine._collect)
            for st in stats:
                merge_stats(engine._stats_acc.setdefault(g.rep.name, {}), st)
            res.append((g, publish_chunk(out_w, g.rep.rcfg.out_stream_cap),
                        ovf))
        return res


@dataclasses.dataclass
class _Schedule:
    groups: List[_Group]
    execs: List[Any]

    def prefix_execs(self) -> List[_PrefixExec]:
        return [e for e in self.execs if e.kind == "prefix"]

    def cohort_execs(self) -> List[_CohortExec]:
        return [e for e in self.execs if e.kind == "cohort"]


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class ServeEngine:
    """Multi-query serving over one Session's vocab, KB, config and device.

    ``dedup=False`` turns off fingerprint dedup and prefix sharing (every
    registration evaluates: the control arm); ``batch=False`` also turns
    off cohorts, leaving one operator a registration that share only the
    windowing step.
    """

    def __init__(self, session, dedup: bool = True, batch: bool = True):
        self.session = session
        self.dedup = dedup
        self.batch = batch
        self.units: Dict[str, ServeUnit] = {}
        self._schedule: Optional[_Schedule] = None
        self._kb_cache: Dict[Tuple, KnowledgeBase] = {}
        self._kb_pad_cache: Dict[Tuple, KnowledgeBase] = {}
        self._kb_stats_cache: Dict[int, Any] = {}
        self._env_cache: Dict[Tuple, torch.Tensor] = {}
        self._ovf_acc: Dict[str, torch.Tensor] = {}
        self._stats_acc: Dict[str, Dict[str, torch.Tensor]] = {}
        self._admission: Optional[QueryAdmission] = None
        tcfg = resolve_trace(session.config.trace)
        self._collect = bool(tcfg and tcfg.metrics)
        self.counters: Dict[str, int] = {
            "chunks": 0, "shared_plan_hits": 0, "shared_prefix_hits": 0,
        }

    # -- registration --------------------------------------------------------
    def register(self, query: Union[str, Q.Query], name: Optional[str] = None,
                 replace: bool = False) -> ServeUnit:
        """Register a standing query (C-SPARQL text or AST).  A duplicate
        name raises ``ValueError`` with both serializations unless
        ``replace=True`` (``Session.register``'s contract)."""
        info: Optional[ParseInfo] = None
        if isinstance(query, str):
            query, info = parse_query_info(query, self.session.vocab, name)
        elif not isinstance(query, Q.Query):
            raise TypeError(
                "register() takes C-SPARQL text or a repro_torch.core.query."
                "Query, got %r" % type(query).__name__)
        prefixes = dict(info.prefixes) if info else None
        text = serialize_query(query, self.session.vocab, prefixes, info=info)
        existing = self.units.get(query.name)
        if existing is not None and not replace:
            raise ValueError(
                "query %r is already registered.\n"
                "existing:\n%s\nnew:\n%s\n"
                "Pass replace=True to substitute the new registration."
                % (query.name, existing.text, text))
        unit = self._build_unit(query, info, text)
        self.units[unit.name] = unit
        self._ovf_acc.setdefault(unit.name, torch.zeros(
            (), dtype=torch.int64, device=self.session.device))
        self._schedule = None
        return unit

    def unregister(self, name: str) -> None:
        """Drop a standing query from the population."""
        del self.units[name]
        self._ovf_acc.pop(name, None)
        self._stats_acc.pop(name, None)
        self._schedule = None

    def _build_unit(self, query: Q.Query, info: Optional[ParseInfo],
                    text: str) -> ServeUnit:
        cfg = self.session.config
        if cfg.window_from_query and info is not None and info.window_triples:
            cfg = cfg.replace(window_capacity=info.window_triples,
                              window_step=info.window_step)
        rcfg = cfg.runtime_config()
        kb = self.session.kb
        if kb is None and query.kb_predicates():
            raise ValueError(
                "query %r touches the KB (GRAPH <kb> patterns) but the "
                "Session has no kb= attached" % query.name)
        akb = kb
        kb_stats = None
        if kb is not None:
            # one closure-augmented KB per distinct closure_kb_key.  The
            # (pred, min_hops) specs alone are not enough: the closure set
            # is rooted at the uses' constant endpoints and p* adds them as
            # reflexive pairs, so `?c :p* A` and `?c :p* B` need two KBs
            ck = closure_kb_key(query)
            akb = self._kb_cache.get(ck)
            if akb is None:
                akb = self._kb_cache[ck] = augment_kb_with_closures(query, kb)
            if rcfg.kb_method == "auto":
                # the cache holds every augmented KB, so no id is reused
                kb_stats = self._kb_stats_cache.get(id(akb))
                if kb_stats is None:
                    kb_stats = self._kb_stats_cache[id(akb)] = (
                        collect_kb_stats(akb))
        plan = compile_query(
            query, kb_method=rcfg.kb_method, scan_cap=rcfg.scan_cap,
            bind_cap=rcfg.bind_cap, out_cap=rcfg.out_cap, kb_stats=kb_stats,
            fuse_compaction=rcfg.fuse_compaction,
        )
        # one closure set per (subclass_pred, super_class): it reads only
        # the subclass_pred rows, which augmentation (synthetic predicates
        # only) never adds to, so any augmented KB gives the same set
        env: Dict[str, torch.Tensor] = {}
        for item in query.where:
            if isinstance(item, Q.FilterSubclass):
                ek = (item.subclass_pred, item.super_class)
                if ek not in self._env_cache:
                    _, self._env_cache[ek] = closure_env_entry(
                        akb, item.subclass_pred, item.super_class)
                env["closure:%d" % item.super_class] = self._env_cache[ek]
        if rcfg.kb_capacity and akb is not None:
            pk = (id(akb), rcfg.kb_capacity)
            if pk not in self._kb_pad_cache:
                self._kb_pad_cache[pk] = pad_to(akb, rcfg.kb_capacity)
            akb = self._kb_pad_cache[pk]
        op = SCEPOperator(query.name, plan, akb, env, OperatorConfig(
            rcfg.window_capacity, rcfg.max_windows, rcfg.out_stream_cap,
            window_step=rcfg.window_step, incremental=rcfg.incremental))
        return ServeUnit(name=query.name, query=query, info=info, text=text,
                         plan=plan, kb=akb, env=env, rcfg=rcfg, op=op)

    # -- scheduling ----------------------------------------------------------
    def _build_schedule(self) -> _Schedule:
        units = list(self.units.values())
        groups: List[_Group] = []
        if self.dedup:
            by_fp: Dict[Tuple, _Group] = {}
            for u in units:
                key = (plan_fingerprint(u.plan), id(u.kb), u.env_sig,
                       u.geometry, u.rcfg.out_stream_cap)
                g = by_fp.get(key)
                if g is None:
                    g = by_fp[key] = _Group(rep=u, members=[])
                    groups.append(g)
                g.members.append(u)
        else:
            groups = [_Group(rep=u, members=[u]) for u in units]

        execs: List[Any] = []
        batchable: List[_Group] = []
        for g in groups:
            # the batched programs run where the reference runs them: the
            # unfused scan join, recompute; everything else keeps its
            # operator (fused kernels, incremental evaluation)
            if (g.rep.geometry[3] or g.rep.rcfg.fuse_compaction
                    or not self.batch):
                execs.append(_OpExec(g))
            else:
                batchable.append(g)

        remaining = batchable
        if self.dedup:
            clusters, remaining = self._cluster_prefixes(batchable)
            execs.extend(_PrefixExec(gs, p) for gs, p in clusters)

        by_shape: Dict[Tuple, List[_Group]] = {}
        for g in remaining:
            key = (plan_shape(g.rep.plan), id(g.rep.kb), g.rep.geometry,
                   g.rep.rcfg.out_stream_cap)
            by_shape.setdefault(key, []).append(g)
        for gs in by_shape.values():
            execs.append(_CohortExec(gs) if len(gs) >= 2 else _OpExec(gs[0]))
        return _Schedule(groups=groups, execs=execs)

    @staticmethod
    def _cluster_prefixes(
        groups: List[_Group],
    ) -> Tuple[List[Tuple[List[_Group], int]], List[_Group]]:
        """Greedy clustering of distinct plans by their common leading step
        run.  A cluster forms only where the shared prefix holds a KB join
        (the work worth sharing) and the plans agree on the binding-table
        geometry the prefix runs under; the rest go on to cohorts and
        singletons."""
        clusters: List[Dict[str, Any]] = []
        rest: List[_Group] = []
        for g in groups:
            u = g.rep
            placed = False
            for cl in clusters:
                seed = cl["members"][0].rep
                if (seed.plan.num_vars != u.plan.num_vars
                        or seed.plan.scan_cap != u.plan.scan_cap
                        or seed.plan.bind_cap != u.plan.bind_cap
                        or seed.geometry != u.geometry
                        or id(seed.kb) != id(u.kb)):
                    continue
                p = min(cl["prefix"], shared_prefix_len(seed.plan, u.plan))
                if p >= 1 and count_kb_joins(seed.plan.steps[:p]) >= 1:
                    cl["members"].append(g)
                    cl["prefix"] = p
                    placed = True
                    break
            if not placed:
                clusters.append({"members": [g], "prefix": len(u.plan.steps)})
        out: List[Tuple[List[_Group], int]] = []
        for cl in clusters:
            if len(cl["members"]) >= 2:
                out.append((cl["members"], cl["prefix"]))
            else:
                rest.extend(cl["members"])
        return out, rest

    @staticmethod
    def _windows_for(geometry: Tuple, chunk: TripleBatch,
                     cache: Dict) -> Union[Windows, SlideView]:
        """The windows (the slides, for incremental evaluation) of one
        geometry, packed once per chunk and shared by every program of
        that geometry: merge + count_windows or count_slides, the ops
        SCEPOperator.process starts with.  The packing reads the chunk on
        the host, one copy per geometry per chunk."""
        if geometry not in cache:
            cap, max_w, step, incremental = geometry
            pack = count_slides if incremental else count_windows
            cache[geometry] = pack(merge_streams((chunk,)), cap, max_w, step)
        return cache[geometry]

    # -- drive surface -------------------------------------------------------
    @property
    def schedule(self) -> _Schedule:
        if self._schedule is None:
            self._schedule = self._build_schedule()
        return self._schedule

    def process_chunk(self, chunk: TripleBatch) -> Dict[str, TripleBatch]:
        """Push one chunk through every registered query; returns ``{query
        name: published output chunk}``, each entry byte-identical to the
        query's own single-session output for this chunk."""
        sched = self.schedule
        chunk = chunk.to(self.session.device)
        outs: Dict[str, TripleBatch] = {}
        wcache: Dict = {}
        for ex in sched.execs:
            for g, out, ovf in ex.run(self, chunk, wcache):
                n_ovf = ovf.sum()
                for u in g.members:
                    outs[u.name] = out
                    self._ovf_acc[u.name] = self._ovf_acc[u.name] + n_ovf
        self.counters["chunks"] += 1
        self.counters["shared_plan_hits"] += sum(
            len(g.members) - 1 for g in sched.groups)
        self.counters["shared_prefix_hits"] += sum(
            (len(ex.groups) - 1) * ex.prefix_len
            for ex in sched.prefix_execs())
        return outs

    def run(self, chunks: Sequence[TripleBatch]
            ) -> Tuple[Dict[str, List[TripleBatch]], Dict[str, int]]:
        """Whole-stream drive: one output chunk per input chunk per query,
        plus per-query lifetime overflow totals."""
        outs: Dict[str, List[TripleBatch]] = {n: [] for n in self.units}
        for c in chunks:
            for n, o in self.process_chunk(c).items():
                outs[n].append(o)
        return outs, self.overflow_totals()

    def admission(self, **opts) -> QueryAdmission:
        """A :class:`~repro_torch.serve.batcher.QueryAdmission` front-end
        bound to this engine.  Unless the caller gives a ``validator``, it
        gates chunks with :func:`repro_torch.core.faults.validate_chunk`
        over this session's vocab, so malformed ingest is refused at the
        boundary."""
        if "validator" not in opts:
            opts["validator"] = functools.partial(
                validate_chunk, vocab=self.session.vocab)
        self._admission = QueryAdmission(self, **opts)
        return self._admission

    # -- observability -------------------------------------------------------
    def overflow_totals(self) -> Dict[str, int]:
        """Lifetime overflowed-window counts per query (a host read)."""
        return {n: int(v) for n, v in self._ovf_acc.items()}

    @property
    def last_stats(self) -> Dict[str, Any]:
        """Schedule, sharing and per-query engine metrics::

            {
              "queries", "dedup", "batch", "distinct_plans",
              "shared_plan_hits", "shared_prefix_hits",   # cumulative
              "prefix_groups": [{"queries", "prefix_len",
                                 "kb_joins_shared"}, ...],
              "cohorts": [{"size", "queries"}, ...],
              "batch_sizes": [...],                       # per cohort
              "singletons", "chunks", "overflow_totals",
              "admission": {...},                         # when attached
              "operators": {name: {...}},                 # metrics on only
            }

        ``operators`` is keyed by each evaluated plan's representative.
        Reading it reads the device accumulators (a host sync).
        """
        sched = self.schedule
        ops: Dict[str, Any] = {}
        for name, acc in self._stats_acc.items():
            unit = self.units.get(name)
            caps = plan_caps(unit.plan) if unit is not None else {}
            ops[name] = attach_saturation(finalize_stats(acc), caps)
        return {
            "queries": len(self.units),
            "dedup": self.dedup,
            "batch": self.batch,
            "distinct_plans": len(sched.groups),
            "shared_plan_hits": self.counters["shared_plan_hits"],
            "shared_prefix_hits": self.counters["shared_prefix_hits"],
            "prefix_groups": [
                {"queries": [g.rep.name for g in ex.groups],
                 "prefix_len": ex.prefix_len,
                 "kb_joins_shared": ex.kb_joins_shared}
                for ex in sched.prefix_execs()
            ],
            "cohorts": [
                {"size": len(ex.groups),
                 "queries": [g.rep.name for g in ex.groups]}
                for ex in sched.cohort_execs()
            ],
            "batch_sizes": [len(ex.groups) for ex in sched.cohort_execs()],
            "singletons": sum(1 for e in sched.execs if e.kind == "operator"),
            "chunks": self.counters["chunks"],
            "overflow_totals": self.overflow_totals(),
            "admission": (self._admission.stats()
                          if self._admission is not None else {}),
            "operators": ops,
        }
