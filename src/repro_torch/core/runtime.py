"""DSCEP runtimes: the decomposed operator DAG and the monolithic baseline.

* :class:`DSCEPRuntime` — every operator of the decomposed DAG runs on the
  same window batch, chunk by chunk, and intermediate results stay
  **window-aligned**, which is what makes decomposed and monolithic results
  identical (paper: "All results are the same").  Where the sink plan's
  rewrite applies (:func:`prepare_split_sink`), the upstream operators
  publish binding *tables* and the aggregation sink joins them directly
  over the raw windows (the split sink; incremental mode ships chunk-level
  span-tagged tables).  Otherwise the aggregator sees upstream output
  triples appended to the very window that produced them (the augmented
  window) and decodes them.  With a :class:`~repro_torch.launch.mesh.Mesh`
  it shards each chunk's windows over the mesh's data axis, one slice a
  device (:func:`sharded_chunk`), as the reference shards them over
  devices; ``balance_windows`` pads a batch to the engine count.
* :class:`MonolithicRuntime` — one operator, the whole query, the full KB
  (the paper's baseline).

:class:`~repro_torch.core.pipeline.PipelinedRuntime` runs the same stages
as independently scheduled steps joined by channels.

Each runtime takes an optional :class:`~repro_torch.obs.trace.Tracer`:
then a ``"chunk"`` span (``mode`` in its meta) times every chunk, and with
``TraceConfig.metrics`` the engine's chunk metrics fold into per-operator
accumulators on the device (:meth:`op_metrics` reads them).  Untraced, a
runtime calls nothing in :mod:`repro_torch.obs`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..launch.mesh import Mesh, on_device
from ..obs.metrics import finalize_stats, merge_stats
from ..obs.trace import NULL_SPAN, Tracer
from .kb import KnowledgeBase, collect_kb_stats, pad_to
from .operator import OperatorConfig, SCEPOperator, publish_chunk
from .engine import Plan
from .planner import (
    OperatorDAG, augment_kb_with_closures, compile_query,
    plan_supports_delta, prepare_env, prune_kb_for, split_agg_plan,
)
from .rdf import TripleBatch, Vocab
from .recovery import empty_recovery_stats
from .stream import merge_streams
from .window import (
    SlideView, Windows, count_slides, count_windows, windows_from_slides,
)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    window_capacity: int = 1000
    max_windows: int = 8
    out_stream_cap: int = 2048
    # sliding count windows: STEP m slide size (None / >= capacity tumbles)
    window_step: Optional[int] = None
    # incremental (delta) evaluation: each chunk runs once with slide-span
    # tracking and every window selects its rows, instead of re-running the
    # join chain per window.  Same output bytes; plans with OPTIONAL
    # (non-monotone) fall back to recompute per operator.
    incremental: bool = False
    # KB-access method: "scan" | "probe" | "auto" (per-join cost model)
    kb_method: str = "scan"
    kb_capacity: Optional[int] = None
    scan_cap: int = 128
    bind_cap: int = 256
    out_cap: int = 512
    # capacity of window-aligned intermediate binding streams between
    # operators (the aggregator's window grows by the sum of these)
    intermediate_cap: int = 512
    # scan-method KB joins: fused (matches compacted where they are found)
    # or unfused (the [M, N] candidate matrix, then compaction)
    fuse_compaction: bool = True

    def operator_config(self) -> OperatorConfig:
        return OperatorConfig(self.window_capacity, self.max_windows,
                              self.out_stream_cap, self.window_step,
                              self.incremental)


def build_operators(dag: OperatorDAG, kb: KnowledgeBase,
                    config: RuntimeConfig) -> Dict[str, SCEPOperator]:
    """Compile one :class:`SCEPOperator` per DAG node, each with its own
    used-KB slice (pruned, closure-augmented, profiled under ``auto``)."""
    operators: Dict[str, SCEPOperator] = {}
    for name, sub in dag.subqueries.items():
        op_kb = None
        kb_stats = None
        if sub.touches_kb:
            op_kb = prune_kb_for(sub.query, kb)
            op_kb = augment_kb_with_closures(sub.query, op_kb)
            if config.kb_method == "auto":
                kb_stats = collect_kb_stats(op_kb)
            if config.kb_capacity:
                op_kb = pad_to(op_kb, config.kb_capacity)
        plan = compile_query(
            sub.query,
            kb_method=config.kb_method,
            scan_cap=config.scan_cap,
            bind_cap=config.bind_cap,
            out_cap=(config.out_cap if name == dag.final
                     else min(config.intermediate_cap, config.out_cap)),
            kb_stats=kb_stats,
            fuse_compaction=config.fuse_compaction,
        )
        env = prepare_env(sub.query, kb)
        operators[name] = SCEPOperator(name, plan, op_kb, env,
                                       config.operator_config())
    return operators


# --------------------------------------------------------------------------
# split aggregation sink (planner.split_agg_plan, the engine's sink runners)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PubSpec:
    """How one upstream operator publishes its binding table to the sink."""

    vars: Tuple[str, ...]       # published variable names, table column order
    cols: Tuple[int, ...]       # upstream-plan columns, same order
    rows_cap: int               # windows-mode table rows (out_cap / templates)
    slide_rows_cap: int         # delta-mode table rows (the chain's bind_cap)


@dataclasses.dataclass(frozen=True)
class SplitSink:
    """A split aggregation sink: the rewritten plan plus each upstream's
    table publication.  ``delta=True`` routes the sink through the
    span-tagged slide path (one sink-chain pass per chunk)."""

    plan: Plan
    pub: Dict[str, PubSpec]
    delta: bool


def prepare_split_sink(dag: OperatorDAG, operators: Dict[str, SCEPOperator],
                       config: RuntimeConfig,
                       mesh: Optional[Mesh] = None) -> Optional[SplitSink]:
    """Try to split the aggregation sink of this DAG.

    Returns ``None`` (the caller keeps the augmented-window path) when the
    plan rewrite is outside the equivalent fragment
    (:func:`~repro_torch.core.planner.split_agg_plan`), when a mesh shards
    the windows (tables are not window-sharded), or when incremental mode
    is asked for but a plan of the DAG cannot run the delta path (mixing
    per-window tables with a delta sink would need a third table format).

    ``rows_cap`` mirrors the triple path's clipping: an upstream publishes
    ``templates-per-row * rows`` triples into ``out_cap``, so the decode
    path sees at most ``out_cap // templates`` complete rows (a clipped
    partial row decodes to nothing).  The delta table carries the whole
    chunk-level chain state, which ``bind_cap`` already bounds.
    """
    if mesh is not None:
        return None
    res = split_agg_plan(operators[dag.final].plan, dag)
    if res is None:
        return None
    plan, pub_vars = res
    delta = False
    if config.incremental:
        if not all(plan_supports_delta(operators[u].plan) for u in pub_vars):
            return None
        if not plan_supports_delta(plan):
            return None
        delta = True
    pub = {
        u: PubSpec(
            vars=names,
            cols=tuple(operators[u].plan.var_col(v) for v in names),
            rows_cap=max(1, operators[u].plan.out_cap // max(1, len(names))),
            slide_rows_cap=operators[u].plan.bind_cap,
        )
        for u, names in pub_vars.items()
    }
    return SplitSink(plan=plan, pub=pub, delta=delta)


def sink_kind(split: Optional[SplitSink]) -> str:
    """Which sink a DAG runs: ``"split"``, ``"split-delta"`` or
    ``"augmented"``."""
    if split is None:
        return "augmented"
    return "split-delta" if split.delta else "split"


def build_dag(dag: OperatorDAG, kb: KnowledgeBase, config: RuntimeConfig,
              mesh: Optional[Mesh] = None
              ) -> Tuple[Dict[str, SCEPOperator], Optional[SplitSink]]:
    """The operators of a decomposed DAG and its split sink, if the rewrite
    applies.  The sink operator's plan is swapped for the rewritten one, so
    introspection reports the plan that runs."""
    operators = build_operators(dag, kb, config)
    split = prepare_split_sink(dag, operators, config, mesh)
    if split is not None:
        operators[dag.final].plan = split.plan
    return operators, split


# --------------------------------------------------------------------------
# the DAG's stages, shared by DSCEPRuntime (one chunk at a time) and
# PipelinedRuntime (stages scheduled apart, joined by channels)
# --------------------------------------------------------------------------

def source_stage(merged: TripleBatch, config: RuntimeConfig,
                 split: Optional[SplitSink]):
    """The aggregator's front end: window one merged chunk.

    Returns ``(sink payload, operator payload)``.  The sink takes the
    windows, and the upstream operators the windows or, incrementally, the
    slide view.  With a delta split sink both sides take the view and no
    window is materialized.
    """
    cfg = config
    if cfg.incremental:
        view = count_slides(merged, cfg.window_capacity, cfg.max_windows,
                            cfg.window_step)
        if split is not None and split.delta:
            return view, view
        return windows_from_slides(view, cfg.window_capacity,
                                   cfg.max_windows, cfg.window_step), view
    windows = count_windows(merged, cfg.window_capacity, cfg.max_windows,
                            cfg.window_step)
    return windows, windows


def upstream_stage(split: Optional[SplitSink], name: str, op: SCEPOperator,
                   payload, max_windows: int, with_stats: bool = False,
                   first_window: int = 0):
    """One enrichment operator's step over a chunk's windows (or slide
    view).  Returns ``(publication, overflow [max_windows])``, and the
    chunk stats when ``with_stats``: its binding table under the split sink
    (per window, or chunk-level over a ``SlideView`` when delta), else its
    output triples.  A delta table's chunk-level flag is broadcast to the
    per-window convention every overflow consumer expects.
    ``first_window`` offsets a data-axis slice of the windows (augmented
    path only)."""
    if split is None:
        if isinstance(payload, SlideView):
            return op.process_slides(payload, with_stats)
        return op.process_windows(payload, with_stats, first_window)
    spec = split.pub[name]
    if split.delta:
        table, ovf, *stats = op.process_slide_tables(
            payload, spec.cols, spec.slide_rows_cap, with_stats)
        return (table, ovf.expand(max_windows), *stats)
    return op.process_window_tables(payload, spec.cols, spec.rows_cap,
                                    with_stats)


def sink_stage(dag: OperatorDAG, split: Optional[SplitSink],
               op: SCEPOperator, payload, inputs: Dict[str, Any],
               with_stats: bool = False, first_window: int = 0):
    """The aggregation operator's step.  The split sink joins the upstream
    tables over the raw windows (or the slide view, delta); otherwise the
    upstream output triples are appended to the very window that produced
    them, in the final sub-query's declared input order, and decoded.
    Returns ``(output triples [W, out_cap], overflow [W])``, and the chunk
    stats when ``with_stats``."""
    if split is None:
        parts = [payload.triples] + [
            inputs[src] for src in dag.subqueries[dag.final].inputs
            if src != "stream"]
        aug = TripleBatch(*(torch.cat(cols, dim=-1) for cols in zip(*parts)))
        return op.process_windows(Windows(aug, payload.window_valid),
                                  with_stats, first_window)
    if split.delta:
        return op.process_sink_slides(payload, inputs, with_stats)
    return op.process_sink_windows(payload, inputs, with_stats)


def dag_stages(dag: OperatorDAG, split: Optional[SplitSink],
               operators: Dict[str, SCEPOperator], max_windows: int,
               sink_in, op_in, with_stats: bool = False,
               first_window: int = 0):
    """Each upstream operator, then the sink, over one source stage's
    payloads (``first_window``: the offset of a slice of the windows).
    Returns ``(output triples [W, out_cap], {operator: overflow [W]},
    {operator: stats})`` (the stats dict is empty unless ``with_stats``)."""
    final = dag.final
    overflow: Dict[str, torch.Tensor] = {}
    inputs: Dict[str, Any] = {}
    stats: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in dag.subqueries:
        if name != final:
            inputs[name], overflow[name], *st = upstream_stage(
                split, name, operators[name], op_in, max_windows, with_stats,
                first_window)
            if st:
                stats[name] = st[0]
    out_w, overflow[final], *st = sink_stage(
        dag, split, operators[final], sink_in, inputs, with_stats,
        first_window)
    if st:
        stats[final] = st[0]
    return out_w, overflow, stats


def dag_chunk(dag: OperatorDAG, split: Optional[SplitSink],
              operators: Dict[str, SCEPOperator], config: RuntimeConfig,
              chunk: TripleBatch, with_stats: bool = False):
    """One chunk through every stage of the DAG, channel-free: the source
    stage, each upstream operator, the sink, the publisher.  Returns
    ``(published chunk, {operator: overflow [W]}, {operator: stats})``
    (the stats dict is empty unless ``with_stats``)."""
    sink_in, op_in = source_stage(merge_streams([chunk]), config, split)
    out_w, overflow, stats = dag_stages(dag, split, operators,
                                        config.max_windows, sink_in, op_in,
                                        with_stats)
    return publish_chunk(out_w, config.out_stream_cap), overflow, stats


# --------------------------------------------------------------------------
# window sharding over a mesh's data axis (intra-operator parallelism)
# --------------------------------------------------------------------------

def window_slices(num_windows: int, mesh: Mesh, axis: str = "data"
                  ) -> List[Tuple[torch.device, int, int]]:
    """``(device, start, stop)`` of each data-axis slice of a ``[W, ...]``
    window batch: ``ceil(W / n)`` windows a slice, as a sharded axis is
    split, so the last slices may be shorter or empty.  Each slice goes to
    the first device of its position along ``axis``; the other axes
    replicate, so each slice runs once."""
    devices = mesh.devices_along(axis)
    per = -(-num_windows // len(devices))
    return [(d, min(i * per, num_windows), min((i + 1) * per, num_windows))
            for i, d in enumerate(devices)]


def shard_windows(windows: Windows, mesh: Mesh, axis: str = "data"
                  ) -> List[Tuple[torch.device, int, Windows]]:
    """Split a window batch into its data-axis slices: ``(device, index of
    the slice's first window, slice on the device)`` (see
    :func:`window_slices`).  Empty slices are left out, so no kernel
    launches on a zero-size grid."""
    return [(dev, lo, Windows(windows.triples.map(lambda c: c[lo:hi].to(dev)),
                              windows.window_valid[lo:hi].to(dev)))
            for dev, lo, hi in window_slices(windows.num_windows, mesh, axis)
            if hi > lo]


def balance_windows(stream: TripleBatch, num_engines: int,
                    window_capacity: int, max_windows: int,
                    window_step: Optional[int] = None) -> Windows:
    """Straggler-aware packing: count windows (equal triple counts up to one
    graph), padded with empty windows to a multiple of ``num_engines`` so
    the data axis divides evenly."""
    w = count_windows(stream, window_capacity, max_windows, window_step)
    pad = -w.num_windows % num_engines
    if pad:
        w = Windows(
            w.triples.map(lambda c: torch.cat(
                [c, c.new_zeros((pad,) + tuple(c.shape[1:]))])),
            torch.cat([w.window_valid, w.window_valid.new_zeros(pad)]))
    return w


def sharded_chunk(dag: OperatorDAG, replicas: Dict[torch.device,
                                                   Dict[str, SCEPOperator]],
                  config: RuntimeConfig, mesh: Mesh, axis: str,
                  chunk: TripleBatch, with_stats: bool = False):
    """One chunk with its windows sharded over ``axis``: every slice runs
    the upstream operators and the (augmented-window) sink on its device,
    from that device's operator replicas; the ``[W, out_cap]`` outputs and
    ``[W]`` flags come back to the chunk's device in data order, and the
    chunk is published there.  Windows run independently, and each slice
    numbers its output graphs from its first window's index in the chunk,
    so the bytes are the unsharded run's.  Per-slice stats merge as the
    chunk's: counters add, high-water marks take the max."""
    cfg = config
    home = chunk.s.device
    windows = count_windows(merge_streams([chunk]), cfg.window_capacity,
                            cfg.max_windows, cfg.window_step)
    outs: List[TripleBatch] = []
    flags: Dict[str, List[torch.Tensor]] = {}
    stats: Dict[str, Dict[str, torch.Tensor]] = {}
    for dev, first, part in shard_windows(windows, mesh, axis):
        with on_device(dev):
            out_w, ovf, st = dag_stages(dag, None, replicas[dev],
                                        cfg.max_windows, part, part,
                                        with_stats, first)
        outs.append(out_w.to(home))
        for name, f in ovf.items():
            flags.setdefault(name, []).append(f.to(home))
        for name, s in st.items():
            merge_stats(stats.setdefault(name, {}),
                        {k: v.to(home) for k, v in s.items()})
    out_w = TripleBatch(*(torch.cat(cols) for cols in zip(*outs)))
    overflow = {name: torch.cat(f) for name, f in flags.items()}
    return publish_chunk(out_w, cfg.out_stream_cap), overflow, stats


def stage_span(tracer: Optional[Tracer], name: str, **meta):
    """The span a runtime opens around a stage: the tracer's, or the null
    span when untraced (which calls no function of the tracer's module)."""
    return NULL_SPAN if tracer is None else tracer.span(name, **meta)


class _OverflowAccumulator:
    """Lifetime per-operator overflowed-window counts, kept on the device
    (the host syncs only when they are read)."""

    def __init__(self, names: Sequence[str], device):
        self._acc = {n: torch.zeros((), dtype=torch.int64, device=device)
                     for n in names}

    def restore(self, mark: Dict[str, torch.Tensor]) -> None:
        """Set the counts to a :meth:`mark` (a checkpoint's)."""
        self._acc = dict(mark)

    def add(self, name: str, flags: torch.Tensor) -> None:
        self._acc[name] = self._acc[name] + flags.sum()

    def totals(self) -> Dict[str, int]:
        return {n: int(v) for n, v in self._acc.items()}

    def mark(self) -> Dict[str, torch.Tensor]:
        """The counts now, still on the device (no sync)."""
        return dict(self._acc)

    def since(self, mark: Dict[str, torch.Tensor]) -> Dict[str, int]:
        """Counts added after :meth:`mark` (synced when read)."""
        return {n: int(v - mark[n]) for n, v in self._acc.items()}


class DSCEPRuntime:
    """Executes a decomposed query DAG over chunked input streams.

    With a ``mesh``, each chunk's windows are sharded over its
    ``data_axis`` (:func:`sharded_chunk`): every slice runs on its own
    device, from replicas of the operators placed there once.  As in the
    reference, a mesh keeps the augmented-window sink and evaluates
    windows, not slides (``incremental`` has no effect on the path)."""

    def __init__(self, dag: OperatorDAG, kb: KnowledgeBase, vocab: Vocab,
                 config: Optional[RuntimeConfig] = None,
                 tracer: Optional[Tracer] = None,
                 mesh: Optional[Mesh] = None, data_axis: str = "data"):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh= takes a repro_torch.launch.mesh.Mesh, "
                            "got %r" % type(mesh).__name__)
        self.dag = dag
        self.config = config if config is not None else RuntimeConfig()
        self.vocab = vocab
        self.mesh = mesh
        self.data_axis = data_axis
        # the split sink (None keeps the augmented-window path)
        self.operators, self._split = build_dag(dag, kb, self.config, mesh)
        self._replicas: Dict[torch.device, Dict[str, SCEPOperator]] = {}
        if mesh is not None:
            for dev in mesh.devices_along(data_axis):
                if dev not in self._replicas:
                    self._replicas[dev] = {n: op.to(dev) for n, op
                                           in self.operators.items()}
        self._overflow = _OverflowAccumulator(self.operators, kb.device)
        self.tracer = tracer
        self._collect = bool(tracer is not None and tracer.config.metrics)
        self._stats_acc: Dict[str, Dict[str, torch.Tensor]] = {
            n: {} for n in self.operators}

    @property
    def sink_kind(self) -> str:
        return sink_kind(self._split)

    def process_chunk(self, chunk: TripleBatch) -> Tuple[TripleBatch, Dict[str, torch.Tensor]]:
        """Push one stream chunk through the DAG; returns (final output,
        per-operator overflow flags [W])."""
        with stage_span(self.tracer, "chunk", mode="single_program") as sp:
            if self.mesh is None:
                out, overflow, stats = dag_chunk(self.dag, self._split,
                                                 self.operators, self.config,
                                                 chunk, self._collect)
            else:
                out, overflow, stats = sharded_chunk(
                    self.dag, self._replicas, self.config, self.mesh,
                    self.data_axis, chunk, self._collect)
            for name, st in stats.items():
                merge_stats(self._stats_acc[name], st)
            sp.fence(out)
        for name, flags in overflow.items():
            self._overflow.add(name, flags)
        return out, overflow

    def process_stream(self, chunks: Sequence[TripleBatch]
                       ) -> Tuple[List[TripleBatch], Dict[str, int]]:
        """Push all chunks through the DAG; returns (outputs, overflowed
        window counts per operator over this stream)."""
        before = self._overflow.totals()
        outs = [self.process_chunk(c)[0] for c in chunks]
        after = self._overflow.totals()
        return outs, {n: after[n] - before[n] for n in after}

    def overflow_totals(self) -> Dict[str, int]:
        return self._overflow.totals()

    def channel_stats(self) -> Dict[str, Dict[str, int]]:
        """No inter-operator channels here: the DAG's edges are plain
        tensors handed from one stage to the next within a chunk."""
        return {}

    def op_metrics(self) -> Dict[str, Dict[str, int]]:
        """Per-operator engine metrics, read from the device (empty unless
        the runtime has a metrics-collecting tracer)."""
        return {n: finalize_stats(a) for n, a in self._stats_acc.items() if a}

    @property
    def degraded(self) -> bool:
        """No channels to route a chunk around in this mode."""
        return False

    def recovery_stats(self) -> Dict[str, Any]:
        """The recovery surface's shape, inert: faults and recovery belong
        to the pipelined runtime only."""
        return empty_recovery_stats(False)


class MonolithicRuntime:
    """Single-operator execution of the *whole* query against the *full*
    KB: the paper's Table-2 baseline (no decomposition, no pruning)."""

    def __init__(self, q, kb: KnowledgeBase,
                 config: Optional[RuntimeConfig] = None,
                 tracer: Optional[Tracer] = None):
        config = config if config is not None else RuntimeConfig()
        kb = augment_kb_with_closures(q, kb)
        plan = compile_query(
            q, kb_method=config.kb_method, scan_cap=config.scan_cap,
            bind_cap=config.bind_cap, out_cap=config.out_cap,
            kb_stats=(collect_kb_stats(kb) if config.kb_method == "auto"
                      else None),
            fuse_compaction=config.fuse_compaction,
        )
        env = prepare_env(q, kb)
        if config.kb_capacity:
            kb = pad_to(kb, config.kb_capacity)
        self.config = config
        self.operator = SCEPOperator(q.name, plan, kb, env,
                                     config.operator_config())
        self._overflow = _OverflowAccumulator([q.name], kb.device)
        self.tracer = tracer
        self._collect = bool(tracer is not None and tracer.config.metrics)
        self._stats_acc: Dict[str, torch.Tensor] = {}

    def process_chunk(self, chunk: TripleBatch) -> Tuple[TripleBatch, torch.Tensor]:
        with stage_span(self.tracer, "chunk", mode="monolithic") as sp:
            out, ovf, *stats = self.operator.process([chunk], self._collect)
            for st in stats:
                merge_stats(self._stats_acc, st)
            sp.fence(out)
        self._overflow.add(self.operator.name, ovf)
        return out, ovf

    def process_stream(self, chunks: Sequence[TripleBatch]
                       ) -> Tuple[List[TripleBatch], Dict[str, int]]:
        before = self._overflow.totals()
        outs = [self.process_chunk(c)[0] for c in chunks]
        after = self._overflow.totals()
        return outs, {n: after[n] - before[n] for n in after}

    def overflow_totals(self) -> Dict[str, int]:
        return self._overflow.totals()

    def channel_stats(self) -> Dict[str, Dict[str, int]]:
        return {}

    def op_metrics(self) -> Dict[str, Dict[str, int]]:
        if not self._stats_acc:
            return {}
        return {self.operator.name: finalize_stats(self._stats_acc)}

    @property
    def degraded(self) -> bool:
        """The baseline has no channels to degrade around."""
        return False

    def recovery_stats(self) -> Dict[str, Any]:
        return empty_recovery_stats(False)
