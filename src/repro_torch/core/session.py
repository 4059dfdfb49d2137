"""The execution facade: one ``Session`` over the ported runtimes.

    cfg = ExecutionConfig(mode="single_program", kb_method="auto")
    sess = Session(cfg, vocab=vocab, kb=kb)
    reg = sess.register(open("query.rq").read())     # text or Query AST
    outs, overflow = reg.run(chunks)                 # whole stream
    for out in reg.stream(chunks): ...               # incremental

Entry points run on the card: ``ExecutionConfig.device`` defaults to
``"cuda"``, and construction raises when no card is visible.  The KB and
every chunk are moved to that device; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the host.

``monolithic``, ``single_program`` and ``pipelined`` produce bit-identical
output streams, and so do sliding windows with and without incremental
evaluation.  ``pipelined`` places the operators on devices (``placement``)
and keeps up to ``channel_capacity`` chunks in flight between them.

``trace=True`` (or a :class:`~repro_torch.obs.trace.TraceConfig`) records
spans and device-side engine metrics in every mode, read through
``RegisteredQuery.last_stats``; ``RegisteredQuery.explain()`` reports the
planner's decisions.  ``faults=`` (a seeded
:class:`~repro_torch.core.faults.FaultPlan`) and ``recovery=`` (a
:class:`~repro_torch.core.recovery.RecoveryConfig`) run the pipelined mode
under injected faults and its recovery ladder.  ``mesh=`` (a
:class:`~repro_torch.launch.mesh.Mesh`) shards each chunk's windows over
its ``data_axis`` in ``single_program`` mode, one slice a device, with the
bytes of the unsharded run; ``monolithic`` ignores it and ``pipelined``
refuses it (that mode spreads operators through ``placement``).

``Session.serve()`` returns a :class:`~repro_torch.serve.engine.ServeEngine`:
a population of standing queries over the session's KB, sharing plans,
KB-join prefixes and constant cohorts, each query publishing the bytes of
its own session.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from . import query as Q
from ..launch.mesh import place_operators
from ..obs.report import attach_saturation
from ..obs.trace import TraceConfig, Tracer, resolve_trace
from .faults import FaultPlan
from .kb import KnowledgeBase, collect_kb_stats
from .pipeline import PipelinedRuntime
from .planner import OperatorDAG, decompose, explain_plan, plan_caps
from .rdf import TripleBatch, Vocab
from .recovery import RecoveryConfig
from .runtime import DSCEPRuntime, MonolithicRuntime, RuntimeConfig
from .sparql import ParseInfo, parse_query_info, serialize_query

MODES = ("monolithic", "single_program", "pipelined")
KB_METHODS = ("scan", "probe", "auto")


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """One frozen config for every ported execution mode."""

    window_capacity: int = 1000
    max_windows: int = 8
    out_stream_cap: int = 2048
    # sliding count windows: slide size in triples (C-SPARQL ``STEP m``).
    # None or >= window_capacity tumbles; otherwise windows overlap on
    # ceil(window_capacity / step) consecutive slides (core/window.py)
    window_step: Optional[int] = None
    # incremental (delta) evaluation: each chunk runs once with slide-span
    # state instead of once per window; same output bytes.  Plans with
    # OPTIONAL fall back to per-window recompute, operator by operator
    incremental: bool = False
    # per-query window geometry: a registration's ``[RANGE TRIPLES n STEP
    # m]`` clause overrides window_capacity/window_step for that query only
    window_from_query: bool = False
    kb_method: str = "scan"            # "scan" | "probe" | "auto" (cost-based)
    kb_capacity: Optional[int] = None
    scan_cap: int = 128
    bind_cap: int = 256
    out_cap: int = 512
    intermediate_cap: int = 512
    # scan-method KB joins: True runs the fused scan join; False the
    # unfused one (the match-matrix kernel writes the [W, M, N] candidate
    # matrix, then its matches are compacted), the paper's KB-scan
    # baseline: a measurement baseline, slower on every configuration
    # measured, not a deployment setting.  The reference defaults to
    # False; both give the same bytes
    fuse_compaction: bool = True
    mode: str = "single_program"       # monolithic | single_program | pipelined
    device: str = "cuda"               # where the KB, chunks and kernels run
    # single_program mode: a launch.mesh.Mesh whose ``data_axis`` shards
    # each chunk's windows, one slice a device (monolithic ignores it)
    mesh: Optional[Any] = None
    data_axis: str = "data"
    # pipelined mode: operator -> device.  A strategy name for
    # launch.mesh.place_operators ("round_robin" or "single", over every
    # visible card when ``device`` is "cuda", else over ``device`` alone),
    # an explicit {operator: device} dict, or None (as "single")
    placement: Union[str, Dict[str, Any], None] = "round_robin"
    channel_capacity: int = 4          # chunks in flight (pipelined)
    # observability (repro_torch.obs): None/False = off, and the runtimes
    # call nothing of it; True = the default TraceConfig (host spans and
    # device-side engine metrics); or an explicit TraceConfig.  Read
    # through RegisteredQuery.last_stats and RegisteredQuery.explain()
    trace: Union[None, bool, TraceConfig] = None
    # fault tolerance (pipelined mode only): ``faults`` is a seeded
    # FaultPlan injected into the driver (chaos runs replay exactly);
    # ``recovery`` tunes the checkpoint/retry/restart/degradation ladder
    # (a FaultPlan alone implies the default RecoveryConfig).  Both None:
    # the driver calls nothing of either module
    faults: Optional[FaultPlan] = None
    recovery: Optional[RecoveryConfig] = None

    def __post_init__(self):
        resolve_trace(self.trace)     # validates the field's type
        if self.mode not in MODES:
            raise ValueError(
                "unknown mode %r (expected one of %s)" % (self.mode, list(MODES)))
        if self.kb_method not in KB_METHODS:
            raise ValueError(
                "unknown kb_method %r (expected one of %s)"
                % (self.kb_method, list(KB_METHODS)))
        if self.window_step is not None and self.window_step < 1:
            raise ValueError("window_step must be >= 1, got %d"
                             % self.window_step)
        if self.mode == "pipelined" and self.mesh is not None:
            raise ValueError(
                "pipelined mode distributes via placement=, not mesh= "
                "(window sharding belongs to single_program mode)")
        if self.faults is not None and not isinstance(self.faults, FaultPlan):
            raise TypeError(
                "faults= takes a repro_torch.core.faults.FaultPlan, got %r"
                % type(self.faults).__name__)
        if self.recovery is not None and not isinstance(
                self.recovery, RecoveryConfig):
            raise TypeError(
                "recovery= takes a repro_torch.core.recovery.RecoveryConfig, "
                "got %r" % type(self.recovery).__name__)
        if (self.faults is not None or self.recovery is not None) \
                and self.mode != "pipelined":
            raise ValueError(
                "fault injection / recovery (faults=, recovery=) require "
                "mode='pipelined': the monolithic and single-program modes "
                "have no channel between stages to fail and recover")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExecutionConfig(device=%r) but no CUDA device is visible; "
                "pass device='cpu' to run the plain PyTorch versions"
                % self.device)

    def runtime_config(self) -> RuntimeConfig:
        return RuntimeConfig(
            window_capacity=self.window_capacity,
            max_windows=self.max_windows,
            out_stream_cap=self.out_stream_cap,
            window_step=self.window_step,
            incremental=self.incremental,
            kb_method=self.kb_method,
            kb_capacity=self.kb_capacity,
            scan_cap=self.scan_cap,
            bind_cap=self.bind_cap,
            out_cap=self.out_cap,
            intermediate_cap=self.intermediate_cap,
            fuse_compaction=self.fuse_compaction,
        )

    def replace(self, **changes) -> "ExecutionConfig":
        return dataclasses.replace(self, **changes)


class RegisteredQuery:
    """A continuous query registered with a :class:`Session`: owns the
    compiled runtime of the session's mode and its drive surface."""

    def __init__(self, session: "Session", query: Q.Query,
                 info: Optional[ParseInfo] = None):
        self.session = session
        self.query = query
        self.info = info
        cfg = session.config
        # per-query window geometry: the registration's RANGE TRIPLES clause
        # (with its STEP, or tumbling without one) overrides the session's
        if cfg.window_from_query and info is not None and info.window_triples:
            cfg = cfg.replace(window_capacity=info.window_triples,
                              window_step=info.window_step)
        self.config = cfg
        self.mode = cfg.mode
        self.dag: Optional[OperatorDAG] = None
        tcfg = resolve_trace(cfg.trace)
        self.tracer: Optional[Tracer] = Tracer(tcfg) if tcfg else None
        self._runtime = self._build_runtime()

    @property
    def window_geometry(self) -> Tuple[int, Optional[int]]:
        """``(window_triples, window_step)`` of this registration: the
        effective window capacity, and the query text's STEP whenever it
        has one (even where ``window_from_query=False`` left it without
        effect), else the session's ``window_step``.  A step that is None
        or ``>=`` the capacity means tumbling."""
        step = self.config.window_step
        if self.info is not None and self.info.window_step:
            step = self.info.window_step
        return (self.config.window_capacity, step)

    def _build_runtime(self):
        cfg = self.config
        kb = self.session.kb
        if kb is None and self.query.kb_predicates():
            raise ValueError(
                "query %r touches the KB (GRAPH <kb> patterns) but the "
                "Session has no kb= attached" % self.query.name)
        if self.mode == "monolithic":
            return MonolithicRuntime(self.query, kb, cfg.runtime_config(),
                                     tracer=self.tracer)
        self.dag = decompose(self.query, self.session.vocab)
        if self.mode == "single_program":
            return DSCEPRuntime(self.dag, kb, self.session.vocab,
                                cfg.runtime_config(), tracer=self.tracer,
                                mesh=cfg.mesh, data_axis=cfg.data_axis)
        placement = cfg.placement
        if placement is None:
            placement = "single"
        if isinstance(placement, str):
            dev = self.session.device
            devices = (None if dev.type == "cuda" and dev.index is None
                       else [dev])
            placement = place_operators(list(self.dag.subqueries),
                                        self.dag.final, devices=devices,
                                        strategy=placement)
        return PipelinedRuntime(self.dag, kb, self.session.vocab,
                                cfg.runtime_config(), placement=placement,
                                channel_capacity=cfg.channel_capacity,
                                tracer=self.tracer, faults=cfg.faults,
                                recovery=cfg.recovery)

    @property
    def runtime(self):
        return self._runtime

    @property
    def operators(self) -> Dict[str, Any]:
        """Name -> SCEPOperator (one entry, the query itself, in monolithic)."""
        if self.mode == "monolithic":
            return {self.query.name: self._runtime.operator}
        return dict(self._runtime.operators)

    @property
    def text(self) -> str:
        """Canonical C-SPARQL serialization of the registered query."""
        prefixes = dict(self.info.prefixes) if self.info else None
        return serialize_query(self.query, self.session.vocab, prefixes,
                               info=self.info)

    def _on_device(self, chunk: TripleBatch) -> TripleBatch:
        return chunk.to(self.session.device)

    def process_chunk(self, chunk: TripleBatch) -> Tuple[TripleBatch, Dict[str, int]]:
        """Push one chunk through; returns (output chunk, overflow counts)."""
        out, ovf = self._runtime.process_chunk(self._on_device(chunk))
        if not isinstance(ovf, dict):
            ovf = {self.query.name: ovf}
        return out, {n: int(v.sum()) for n, v in ovf.items()}

    def run(self, chunks: Sequence[TripleBatch]
            ) -> Tuple[List[TripleBatch], Dict[str, int]]:
        """Push a whole stream through; returns (outputs, overflowed-window
        counts per operator over this stream)."""
        return self._runtime.process_stream(
            [self._on_device(c) for c in chunks])

    def stream(self, chunks: Sequence[TripleBatch]) -> Iterator[TripleBatch]:
        """Yield one output chunk per input chunk, in input order.

        In pipelined mode the schedule keeps ``channel_capacity`` chunks in
        flight, so outputs trail inputs by the pipeline depth.  The
        pipelined generator needs an idle runtime, and drains any chunks
        left in flight when it is closed early, so a later ``run`` or
        ``stream`` never sees another call's leftovers.
        """
        if self.mode == "pipelined":
            yield from self._runtime.iter_stream(
                self._on_device(c) for c in chunks)
            return
        for c in chunks:
            yield self._runtime.process_chunk(self._on_device(c))[0]

    def overflow_totals(self) -> Dict[str, int]:
        """Lifetime per-operator overflow counts (synced when read)."""
        return self._runtime.overflow_totals()

    def channel_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-edge channel statistics: filled in pipelined mode (the only
        mode with channels between operators), ``{}`` elsewhere."""
        return self._runtime.channel_stats()

    # -- observability ------------------------------------------------------
    @property
    def last_stats(self) -> Dict[str, Any]:
        """The observability surface, one shape in all three modes::

            {
              "query": ..., "mode": ...,
              "overflow_totals": {op: windows clipped, ...},
              "channels": {edge: {...}, ...},      # {} outside pipelined
              "operators": {op: {"counters": ..., "caps": ...,
                                 "saturation": ...}, ...},
              "spans": {path: {"count", "first_s", "steady": {...}}, ...},
              "recovery": {"enabled", "injected", "retries", ...},
              "degraded": bool,
            }

        ``operators`` and ``spans`` fill in only under
        ``ExecutionConfig(trace=...)``; ``recovery`` carries live counters
        only under pipelined ``faults=``/``recovery=``.  Reading it reads
        the device accumulators (a host sync).
        """
        ops: Dict[str, Any] = {}
        for name, counters in self._runtime.op_metrics().items():
            op = self.operators.get(name)
            caps = plan_caps(op.plan) if op is not None else {}
            ops[name] = attach_saturation(counters, caps)
        return {
            "query": self.query.name,
            "mode": self.mode,
            "overflow_totals": self._runtime.overflow_totals(),
            "channels": self._runtime.channel_stats(),
            "operators": ops,
            "spans": self.tracer.stats() if self.tracer is not None else {},
            "recovery": self._runtime.recovery_stats(),
            "degraded": self._runtime.degraded,
        }

    def explain(self) -> Dict[str, Any]:
        """The planner's decisions for this registration, per operator.

        KB statistics are recomputed on the host from each operator's KB
        slice (no step runs), so the estimates are the numbers the
        ``kb_method="auto"`` cost model compared.
        """
        win_cap, win_step = self.window_geometry
        operators: Dict[str, Any] = {}
        for name, op in self.operators.items():
            stats = collect_kb_stats(op.kb) if op.kb is not None else None
            entry = explain_plan(op.plan, stats, self.session.vocab)
            entry["kb_rows"] = stats.total_rows if stats is not None else 0
            operators[name] = entry
        return {
            "query": self.query.name,
            "mode": self.mode,
            "kb_method": self.config.kb_method,
            "incremental": self.config.incremental,
            "window": {"capacity": win_cap, "step": win_step},
            "operators": operators,
        }


class Session:
    """Entry point: register C-SPARQL text (or ASTs) and execute streams."""

    def __init__(self, config: Optional[ExecutionConfig] = None, *,
                 vocab: Optional[Vocab] = None,
                 kb: Optional[KnowledgeBase] = None):
        self.config = config if config is not None else ExecutionConfig()
        self.device = torch.device(self.config.device)
        self.vocab = vocab if vocab is not None else Vocab()
        self.kb = kb.to(self.device) if kb is not None else None
        self.queries: Dict[str, RegisteredQuery] = {}

    def register(self, query: Union[str, Q.Query], name: Optional[str] = None,
                 replace: bool = False) -> RegisteredQuery:
        """Register a continuous query: C-SPARQL text or a Query AST.  A
        duplicate name raises unless ``replace=True``."""
        info: Optional[ParseInfo] = None
        if isinstance(query, str):
            query, info = parse_query_info(query, self.vocab, name)
        elif not isinstance(query, Q.Query):
            raise TypeError(
                "register() takes C-SPARQL text or a repro_torch.core.query."
                "Query, got %r" % type(query).__name__)
        existing = self.queries.get(query.name)
        if existing is not None and not replace:
            prefixes = dict(info.prefixes) if info else None
            raise ValueError(
                "query %r is already registered.\nexisting:\n%s\nnew:\n%s\n"
                "Pass replace=True to substitute the new registration."
                % (query.name, existing.text,
                   serialize_query(query, self.vocab, prefixes, info=info)))
        reg = RegisteredQuery(self, query, info)
        self.queries[query.name] = reg
        return reg

    def unregister(self, name: str) -> None:
        del self.queries[name]

    def serve(self, **opts):
        """A :class:`~repro_torch.serve.engine.ServeEngine` over this
        session's vocab, KB, config and device, for populations of
        standing queries (``dedup=``, ``batch=``)."""
        from ..serve.engine import ServeEngine

        return ServeEngine(self, **opts)

    def register_file(self, path: str,
                      name: Optional[str] = None) -> RegisteredQuery:
        with open(path) as f:
            return self.register(f.read(), name=name)
