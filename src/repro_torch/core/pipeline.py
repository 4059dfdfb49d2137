"""Pipelined inter-operator dataflow runtime.

:class:`~repro_torch.core.runtime.DSCEPRuntime` pushes chunks through the
whole operator DAG one at a time.  This module is the execution mode the
paper deploys: operators as *independently scheduled steps* joined by
bounded queues ("each SCEP operator can process part of the data and send
it to other SCEP operators"), so the aggregation operator consumes chunk
*t* while the upstream enrichment operators already produce *t + 1*.

Structure:

* every *buffering* DAG edge is a capacity-bounded device channel
  (:mod:`repro_torch.core.channel`): the ``source -> aggregator`` edge
  carries window-aligned :class:`~repro_torch.core.window.Windows` (or the
  chunk's :class:`~repro_torch.core.window.SlideView` under the delta split
  sink), ``op -> aggregator`` edges carry the operator's publication and
  its ``overflow[W]``: output triples ``[W, out_cap]``, or, with the split
  sink, its binding table.  Upstream operators consume their windows the
  tick they are produced, so that hand-off is a direct transfer, not a
  queue;
* a **placement** maps operators to devices
  (:func:`repro_torch.launch.mesh.place_operators`): each operator's KB
  slice and env move to its device, channels live on the *consumer's*
  device, and a transfer is ``.to(device, non_blocking=True)`` or the
  push's copy into the slot (no-ops across one device);
* the host driver runs a **software-pipelined schedule**: it feeds chunk
  *t + 1* into the producer stages before draining chunk *t* from the
  sink, keeping up to ``channel_capacity`` chunks in flight.  Nothing on
  the feed path reads a device value besides the window packing's one
  copy of the chunk to the host (``core/window.py``); overflow totals are
  read at stream boundaries only.

Every stage enqueues on the current stream of its device, so on one card
the stages run in the order the driver dispatches them.  Results are the
bytes of :class:`DSCEPRuntime` and
:class:`~repro_torch.core.runtime.MonolithicRuntime`: the stages are the
same functions (``runtime.source_stage``, ``upstream_stage``,
``sink_stage``), only cut at the channels.  Each stage runs with its
operator's device current, because the kernels' launchers take the device
from the CUDA runtime (``kernels/_cuda.stream_of`` raises otherwise).

With a tracer, each stage runs in a span (``stage:source``,
``stage:<operator>``) and, with metrics on, its engine metrics fold into
per-operator accumulators.  With ``faults=`` / ``recovery=``
(:mod:`repro_torch.core.faults`, :mod:`repro_torch.core.recovery`) the
driver numbers every fed chunk, keeps the pristine chunks past the last
checkpoint, dispatches every stage through the fault ladder (retry with
backoff on a timeout; checkpoint restore and replay on a crash, a channel
desync or exhausted retries; a chunk past ``max_restarts`` is re-run
channel-free on the sink's device) and dedups replayed outputs by sequence
number, so the output stream is the fault-free run's bytes.  Without them
the driver calls nothing in those modules.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, Iterator, List, Optional, Set, Tuple

import torch

from ..launch.mesh import on_device, place_operators
from ..obs.metrics import finalize_stats, merge_stats
from ..obs.trace import Tracer
from . import channel
from .channel import Channel, tree_leaves, tree_map
from .faults import (
    FaultInjector, FaultPlan, InjectedCrash, corrupt_batch, validate_chunk,
)
from .kb import KnowledgeBase
from .operator import publish_chunk
from .planner import OperatorDAG
from .rdf import ID_DTYPE, TripleBatch, Vocab
from .recovery import (
    ChannelDesyncError, Checkpoint, ChunkRejectedError, PipelineStalledError,
    RecoveryConfig, RecoveryExhaustedError, StageTimeoutError,
    copy_edge_stats, empty_recovery_stats, restore_tree, snapshot_stats_acc,
    snapshot_tree, tree_bytes, wait_until_ready,
)
from .runtime import (
    RuntimeConfig, _OverflowAccumulator, build_dag, dag_chunk, sink_kind,
    sink_stage, source_stage, stage_span, upstream_stage,
)
from .stream import merge_streams
from .window import Windows, window_slides

__all__ = ["PipelinedRuntime", "PipelineStalledError"]


def _zeros_triples(shape, device) -> TripleBatch:
    z = [torch.zeros(shape, dtype=ID_DTYPE, device=device) for _ in range(5)]
    return TripleBatch(*z, torch.zeros(shape, dtype=torch.bool, device=device))


def _flags(num_windows: int, device) -> torch.Tensor:
    return torch.zeros((num_windows,), dtype=torch.bool, device=device)


def _to(tree, device):
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


def _if_valid(x: torch.Tensor, ok: bool) -> torch.Tensor:
    """``x`` masked by a pop's validity, as a tensor of its own (a popped
    payload is a view of its channel slot)."""
    return x.clone() if ok else torch.zeros_like(x)


class PipelinedRuntime:
    """Streaming execution of a decomposed query DAG over device channels.

    Takes :class:`~repro_torch.core.runtime.DSCEPRuntime`'s arguments plus:

    * ``placement`` — ``{operator_name: device}`` (see
      :func:`repro_torch.launch.mesh.place_operators`); ``None`` places
      every stage on the KB's device (still pipelined, transport a no-op);
    * ``channel_capacity`` — slots per edge channel, at least 2 for the
      double-buffered schedule; it bounds the chunks in flight;
    * ``tracer`` — per-stage spans and engine metrics (``repro_torch.obs``);
    * ``faults`` / ``recovery`` — a seeded :class:`FaultPlan` injected into
      the driver, and the recovery ladder's knobs (a plan alone implies the
      default :class:`RecoveryConfig`).

    ``feed()`` only queues: chunks land in a host-side source queue, and
    ``_pump()`` advances every stage whose outbound edge has room, so
    ``feed()`` never raises on a full pipeline; excess chunks wait until
    ``drain()`` frees a slot.
    """

    def __init__(self, dag: OperatorDAG, kb: KnowledgeBase, vocab: Vocab,
                 config: Optional[RuntimeConfig] = None,
                 placement: Optional[Dict[str, Any]] = None,
                 channel_capacity: int = 4,
                 tracer: Optional[Tracer] = None,
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryConfig] = None,
                 mesh=None):
        if channel_capacity < 2:
            raise ValueError(
                "pipelining needs channel_capacity >= 2 (double buffering), "
                "got %d" % channel_capacity)
        if mesh is not None:
            # window sharding belongs to DSCEPRuntime; per-operator channel
            # buffers on one device would undo it here
            raise NotImplementedError(
                "PipelinedRuntime does not shard windows over a mesh; "
                "pass placement= instead (or use DSCEPRuntime with mesh=)")
        self.dag = dag
        self.vocab = vocab
        self.config = cfg = config if config is not None else RuntimeConfig()
        self.channel_capacity = channel_capacity
        # the split sink: upstream stages publish binding tables and the
        # sink joins them directly (None keeps the augmented path)
        self.operators, self._split = build_dag(dag, kb, cfg)
        self.final = dag.final
        # upstream operators in DAG insertion order, as DSCEPRuntime runs them
        self.upstream: List[str] = [n for n in dag.subqueries
                                    if n != self.final]
        if placement is None:
            placement = place_operators(list(self.operators), self.final,
                                        devices=[kb.device], strategy="single")
        self.placement = {n: torch.device(d) for n, d in placement.items()}
        missing = set(self.operators) - set(self.placement)
        if missing:
            raise ValueError("placement missing operators: %s"
                             % sorted(missing))
        # each operator's KB slice and env move to its device, so its step
        # runs there (a new KB builds its words and fences there)
        for name, op in self.operators.items():
            dev = self.placement[name]
            if op.kb is not None and op.kb.device != dev:
                op.kb = op.kb.to(dev)
            op.env = {k: v.to(dev) for k, v in op.env.items()}
        self._sink_dev = self.placement[self.final]

        # per-edge channels on the consumer's device.  The physical window
        # width is R * slide_capacity (the window capacity when tumbling).
        # The payload examples (meta tensors) are kept: a degraded restart
        # rebuilds the channels empty from them
        slide_cap, slides_per_win = window_slides(cfg.window_capacity,
                                                  cfg.window_step)
        self._win_example: Optional[Windows] = None
        if not (self._split is not None and self._split.delta):
            shape = (cfg.max_windows, slide_cap * slides_per_win)
            self._win_example = Windows(_zeros_triples(shape, "meta"),
                                        _flags(cfg.max_windows, "meta"))
        # else the sink consumes the chunk's SlideView, whose stream leaf is
        # sized by the chunk: the window channel is allocated from the
        # first payload (_ensure_win_channel)
        self._agg_win_ch: Optional[Channel] = None
        self._win_sig = None
        if self._win_example is not None:
            self._agg_win_ch = channel.make_channel(
                self._win_example, channel_capacity, self._sink_dev)
        up_out_cap = min(cfg.intermediate_cap, cfg.out_cap)
        self._pub_examples: Dict[str, Any] = {}
        for name in self.upstream:
            flags = _flags(cfg.max_windows, "meta")
            if self._split is not None:
                spec = self._split.pub[name]
                k = len(spec.cols)
                rows = ((spec.slide_rows_cap,) if self._split.delta
                        else (cfg.max_windows, spec.rows_cap))
                width = k + 2 if self._split.delta else k
                table = (torch.zeros(rows + (width,), dtype=ID_DTYPE,
                                     device="meta"),
                         torch.zeros(rows, dtype=torch.bool, device="meta"))
                self._pub_examples[name] = (table, flags)
            else:
                self._pub_examples[name] = (
                    _zeros_triples((cfg.max_windows, up_out_cap), "meta"),
                    flags)
        self._out_ch: Dict[str, Channel] = {
            n: channel.make_channel(ex, channel_capacity, self._sink_dev)
            for n, ex in self._pub_examples.items()}

        self._in_flight = 0
        # high-water mark of chunks in flight at once: the pipeline depth
        # the driver achieved
        self.depth_hw = 0
        # dispatch queues of (seq, payload): _src_q holds raw chunks not yet
        # windowed, _disp_q[name] the windowed payloads operator ``name``
        # has not run
        self._src_q: Deque[Tuple[int, TripleBatch]] = deque()
        self._disp_q: Dict[str, Deque[Tuple[int, Any]]] = {
            n: deque() for n in self.upstream}
        # device-side clipped-window counts per operator (read at stream
        # boundaries only)
        self._overflow = _OverflowAccumulator(self.operators, self._sink_dev)
        self._last_overflow: Dict[str, torch.Tensor] = {}
        # host-side schedule counters per edge
        self._edge_stats: Dict[str, Dict[str, int]] = {
            e: {"pushes": 0, "pops": 0, "depth_hw": 0} for e in self._edges()}

        # observability: engine metrics fold into per-operator accumulators
        # on the operator's device
        self.tracer = tracer
        self._collect = bool(tracer is not None and tracer.config.metrics)
        self._stats_acc: Dict[str, Dict[str, torch.Tensor]] = {
            n: {} for n in self.operators}

        # fault tolerance: host bookkeeping only; the stages run the same
        # ops with or without it
        self._injector = FaultInjector(faults) if faults is not None else None
        if recovery is None and faults is not None:
            recovery = RecoveryConfig()    # chaos implies the default ladder
        self._rcfg = recovery
        self._resilient = recovery is not None
        # lifetime chunk sequence numbers, assigned at feed(): the dedup
        # key of replayed outputs
        self._next_seq = 0
        self._emitted_hw = -1                # highest seq drain() returned
        self._inflight_seqs: List[int] = []  # seqs windowed into channels
        # replay buffer: pristine fed chunks past the last checkpoint's
        # emitted watermark (pruned at every checkpoint)
        self._retained: Dict[int, TripleBatch] = {}
        self._degraded: Set[int] = set()     # seqs past max_restarts
        self._degraded_out: Dict[int, Tuple[TripleBatch, Dict[str, torch.Tensor]]] = {}
        self._fail_counts: Dict[int, int] = {}
        self._ckpt: Optional[Checkpoint] = None
        # global restart budget: injected events fire once each, so any
        # recovery loop ends well inside it; spending it means a persistent
        # fault no chunk can be blamed for
        self._restart_budget = 64 + 4 * (len(faults.events) if faults else 0)
        self._rec: Dict[str, int] = {
            "retries": 0, "restarts": 0, "replayed": 0, "deduped": 0,
            "checkpoints": 0, "checkpoint_bytes": 0, "rejected": 0,
            "corrupt_recovered": 0,
        }

    @property
    def sink_kind(self) -> str:
        return sink_kind(self._split)

    def _edges(self) -> List[str]:
        return ["source->%s" % self.final] + [
            "%s->%s" % (n, self.final) for n in self.upstream]

    # -- host-side edge accounting (schedule facts, not device state) -------
    def _edge_pushed(self, edge: str) -> None:
        e = self._edge_stats[edge]
        e["pushes"] += 1
        e["depth_hw"] = max(e["depth_hw"], e["pushes"] - e["pops"])

    def _edge_room(self, edge: str) -> bool:
        e = self._edge_stats[edge]
        return e["pushes"] - e["pops"] < self.channel_capacity

    # -- the sink stage -----------------------------------------------------
    def _sink_impl(self):
        """Aggregation operator step: pop every inbound edge, join,
        publish.  An empty pop's outputs and overflow flags are masked out
        by its validity.  Returns ``(output chunk, overflow)``, and the
        sink's stats when metrics are on."""
        self._agg_win_ch, sink_payload, has = channel.pop(self._agg_win_ch)
        overflow: Dict[str, torch.Tensor] = {}
        inputs: Dict[str, Any] = {}
        for name in self.upstream:
            self._out_ch[name], (pub, ovf), h = channel.pop(self._out_ch[name])
            inputs[name] = pub
            overflow[name] = _if_valid(ovf, h)
        out_w, ovf_f, *stats = sink_stage(
            self.dag, self._split, self.operators[self.final], sink_payload,
            inputs, self._collect)
        overflow[self.final] = _if_valid(ovf_f, has)
        out = publish_chunk(out_w, self.config.out_stream_cap)
        if not has:
            out = out._replace(valid=torch.zeros_like(out.valid))
        return (out, overflow, *stats)

    # -- host-side driver -------------------------------------------------
    def _ensure_win_channel(self, payload) -> None:
        """Allocate the sink's window channel from the first payload (the
        delta split sink ships the SlideView, sized by the chunk)."""
        sig = tuple((tuple(t.shape), t.dtype) for t in tree_leaves(payload))
        if self._agg_win_ch is None:
            self._agg_win_ch = channel.make_channel(
                payload, self.channel_capacity, self._sink_dev)
            self._win_sig = sig
        elif self._win_sig is not None and self._win_sig != sig:
            raise RuntimeError(
                "split-delta pipelining requires uniform chunk shapes: the "
                "window channel was sized for a different chunk capacity")

    def _run_stage(self, stage: str, seq: int, thunk, retryable: bool = True):
        """Dispatch one stage step through the fault ladder.

        Without recovery this is ``thunk()``.  With it: an injected crash
        raises :class:`InjectedCrash` (handled by a checkpoint restore);
        injected stalls and real timeouts (the step's device work not done
        within ``stage_timeout_s``, polled through events) surface as
        :class:`StageTimeoutError` and are retried with bounded exponential
        backoff.  ``retryable=False`` (the sink, whose pops already
        advanced its channels) sends a real timeout straight to a restore;
        injected stalls fire before dispatch and are always retryable.
        """
        if not self._resilient:
            return thunk()
        inj, rc = self._injector, self._rcfg
        if inj is not None and inj.take("crash_stage", stage, seq):
            raise InjectedCrash(stage, seq)
        attempts = 0
        while True:
            try:
                if inj is not None and inj.take("stall_stage", stage, seq):
                    raise StageTimeoutError(stage, seq, rc.stage_timeout_s,
                                            injected=True)
                out = thunk()
                if rc.stage_timeout_s is not None and not wait_until_ready(
                        out, rc.stage_timeout_s):
                    raise StageTimeoutError(stage, seq, rc.stage_timeout_s)
            except StageTimeoutError as err:
                attempts += 1
                if attempts > rc.max_retries or (
                        not err.injected and not retryable):
                    raise
                self._rec["retries"] += 1
                time.sleep(rc.backoff_s * (2 ** (attempts - 1)))
                continue
            return out

    def _push_payload(self, stage: str, edge: str, seq: int, payload) -> None:
        """Push a stage's outbound payload, subject to transport faults.
        ``drop_payload`` skips the push and its ledger entry (the loss
        surfaces as a :class:`ChannelDesyncError` at the sink's pre-pop
        audit); ``duplicate_payload`` pushes twice."""
        inj = self._injector
        if inj is not None and inj.take("drop_payload", stage, seq):
            return
        dup = inj is not None and inj.take("duplicate_payload", stage, seq)
        for _ in range(2 if dup else 1):
            if stage == "source":
                self._agg_win_ch = channel.push(self._agg_win_ch, payload)
            else:
                self._out_ch[stage] = channel.push(self._out_ch[stage],
                                                   payload)
            self._edge_pushed(edge)

    def _check_desync(self) -> None:
        """Pre-pop audit: every edge must hold exactly one payload per
        chunk in flight, or the sink would join mismatched windows.

        An operator's payloads still in its dispatch queue count as held:
        a duplicate that fills the operator's edge leaves its next payload
        queued, and the two would cancel in the edge's count alone.  (The
        reference counts the edge only, and then fails its sink's
        lagging-queue assertion; where it passes, every queue is empty and
        the two audits agree.)"""
        expected = self._in_flight
        queued = {"%s->%s" % (n, self.final): len(q)
                  for n, q in self._disp_q.items()}
        for edge in self._edges():
            e = self._edge_stats[edge]
            actual = e["pushes"] - e["pops"] + queued.get(edge, 0)
            if actual != expected:
                raise ChannelDesyncError(edge, actual, expected)

    def _pump(self) -> None:
        """Advance every stage that has queued work and a free slot to
        publish into.  With equal edge capacities the operator dispatch
        queues empty within the pump that windows their chunk; they exist
        so ``feed()`` never blocks on a full pipeline."""
        cfg, tr = self.config, self.tracer
        src_edge = "source->%s" % self.final
        while self._src_q and self._edge_room(src_edge):
            seq, chunk = self._src_q.popleft()
            with stage_span(tr, "stage:source") as sp, \
                    on_device(self._sink_dev):
                sink_payload, op_payload = self._run_stage(
                    "source", seq, lambda: source_stage(
                        merge_streams([chunk]), cfg, self._split))
                sp.fence(sink_payload)
            self._ensure_win_channel(sink_payload)
            self._push_payload("source", src_edge, seq, sink_payload)
            for name in self.upstream:
                self._disp_q[name].append((seq, op_payload))
            self._in_flight += 1
            self._inflight_seqs.append(seq)
            self.depth_hw = max(self.depth_hw, self._in_flight)
        for name in self.upstream:
            edge = "%s->%s" % (name, self.final)
            q = self._disp_q[name]
            op, dev = self.operators[name], self.placement[name]
            while q and self._edge_room(edge):
                seq, payload = q.popleft()
                with stage_span(tr, "stage:%s" % name) as sp, on_device(dev):
                    pub, ovf, *stats = self._run_stage(
                        name, seq, lambda: upstream_stage(
                            self._split, name, op, _to(payload, dev),
                            cfg.max_windows, self._collect))
                    for st in stats:
                        merge_stats(self._stats_acc[name], st)
                    sp.fence(pub)
                self._push_payload(name, edge, seq, (pub, ovf))

    def _pump_guarded(self) -> None:
        """``_pump`` under the recovery ladder: a stage fault while pumping
        restores the last checkpoint and pumps again (bounded by the global
        restart budget in :meth:`_handle_fault`)."""
        if not self._resilient:
            self._pump()
            return
        while True:
            try:
                self._pump()
                return
            except (InjectedCrash, StageTimeoutError) as err:
                self._handle_fault(err.stage, err.seq)

    def feed(self, chunk: TripleBatch) -> None:
        """Accept one chunk and dispatch every stage with room.  Never
        raises on a full pipeline: chunks past the channel capacity wait in
        the source queue until ``drain()`` frees slots.

        With recovery the chunk first passes the
        :func:`~repro_torch.core.faults.validate_chunk` ingest gate (a
        malformed chunk raises :class:`ChunkRejectedError` and leaves the
        pipeline untouched), and the pristine chunk enters the replay buffer
        before the (possibly corrupted in transit) ingest copy is queued.
        """
        if not self._resilient:
            self._src_q.append((self._next_seq, chunk))
            self._next_seq += 1
            self._pump()
            return
        rc = self._rcfg
        if rc.validate:
            reasons = validate_chunk(chunk, self.vocab, rc.max_graph_size)
            if reasons:
                self._rec["rejected"] += 1
                raise ChunkRejectedError(reasons)
        if self._ckpt is None:
            self._take_checkpoint()       # the clean-state checkpoint 0
        seq = self._next_seq
        self._next_seq += 1
        self._retained[seq] = chunk       # pristine, before transit
        ingest = chunk
        inj = self._injector
        if inj is not None and inj.take("corrupt_chunk", "ingest", seq):
            ingest = corrupt_batch(chunk)
        if ingest is not chunk and validate_chunk(ingest, self.vocab,
                                                  rc.max_graph_size):
            # the gate caught corruption in transit: take the pristine
            # copy from the replay buffer instead
            self._rec["corrupt_recovered"] += 1
            ingest = self._retained[seq]
        self._src_q.append((seq, ingest))
        self._pump_guarded()

    def drain(self) -> TripleBatch:
        """Dispatch the sink stage for the oldest chunk in flight and
        return its published chunk (a device tensor: read it when the host
        needs the values).  Overflow flags accumulate on the device; read
        them with :meth:`overflow_totals`."""
        if self._resilient:
            return self._drain_resilient()
        self._pump()
        if self._in_flight == 0:
            if self._src_q:
                raise PipelineStalledError(self._stall_detail())
            raise RuntimeError("nothing in flight; feed() first")
        _seq, out = self._drain_once()
        self._pump()          # the pop freed a slot on every edge
        return out

    def _drain_once(self) -> Tuple[int, TripleBatch]:
        """The sink dispatch of the plain and the resilient drain: pop
        every edge, join, count overflow, retire the oldest seq."""
        # equal edge capacities keep the operator stages in step with the
        # source stage: the sink never pops an unmatched window
        assert all(not q for q in self._disp_q.values()), (
            "operator dispatch queues lag the window edge")
        seq = self._inflight_seqs[0] if self._inflight_seqs else -1
        with stage_span(self.tracer, "stage:%s" % self.final) as sp, \
                on_device(self._sink_dev):
            out, overflow, *stats = self._run_stage(
                self.final, seq, self._sink_impl, retryable=False)
            for st in stats:
                merge_stats(self._stats_acc[self.final], st)
            sp.fence(out)
        for edge in self._edges():
            self._edge_stats[edge]["pops"] += 1
        self._accumulate_overflow(overflow)
        self._last_overflow = overflow
        self._in_flight -= 1
        if self._inflight_seqs:
            self._inflight_seqs.pop(0)
        return seq, out

    def _accumulate_overflow(self, overflow: Dict[str, torch.Tensor]) -> None:
        for name, flags in overflow.items():
            self._overflow.add(name, flags)

    def _drain_resilient(self) -> TripleBatch:
        """Recovery-aware drain: emit the lowest pending seq exactly once.

        Replayed drains of seqs already emitted advance the channels and
        count their overflow again (the accumulators were restored to the
        checkpoint, so totals stay exact), but their outputs are discarded:
        the sequence-number dedup that makes recovery bit-exact.  Degraded
        seqs bypass the channels through the channel-free fallback.
        """
        self._pump_guarded()
        while True:
            # flush degraded outputs whose seqs were already emitted
            for s in [s for s in self._degraded_out if s <= self._emitted_hw]:
                _out, ovf = self._degraded_out.pop(s)
                self._accumulate_overflow(ovf)
                self._rec["deduped"] += 1
            cand = []
            if self._inflight_seqs:
                cand.append(self._inflight_seqs[0])
            if self._degraded_out:
                cand.append(min(self._degraded_out))
            if not cand:
                if self._src_q:
                    raise PipelineStalledError(self._stall_detail())
                raise RuntimeError("nothing in flight; feed() first")
            s = min(cand)
            if s in self._degraded_out and (
                    not self._inflight_seqs or s < self._inflight_seqs[0]):
                out, ovf = self._degraded_out.pop(s)
                self._accumulate_overflow(ovf)
                self._last_overflow = ovf
                self._emitted_hw = s
                self._maybe_checkpoint()
                return out
            try:
                self._check_desync()
                seq, out = self._drain_once()
            except (InjectedCrash, StageTimeoutError,
                    ChannelDesyncError) as err:
                self._handle_fault(getattr(err, "stage", None),
                                   getattr(err, "seq", None))
                self._pump_guarded()
                continue
            if seq <= self._emitted_hw:
                self._rec["deduped"] += 1     # replayed output: discard
                self._pump_guarded()
                continue
            self._emitted_hw = seq
            self._maybe_checkpoint()
            self._pump_guarded()
            return out

    def _stall_detail(self) -> str:
        blocked = [e for e in self._edges() if not self._edge_room(e)]
        return ("%d chunk(s) queued at the source but nothing is in flight "
                "to drain and no stage can advance; blocked edge(s): %s"
                % (len(self._src_q), ", ".join(blocked) if blocked else
                   "none (driver accounting bug)"))

    # -- checkpoint / restore -------------------------------------------------
    def _take_checkpoint(self) -> None:
        """Snapshot a consistent cut of the driver and device state.

        The channel rings, accumulators and envs are deep host copies (a
        push rewrites ring slots in place); queued payloads and raw chunks
        are references, since nothing writes them in place.  The replay
        buffer is pruned to seqs past the new emitted watermark.
        """
        ck = Checkpoint(
            fed=self._next_seq,
            emitted=self._emitted_hw,
            in_flight=self._in_flight,
            inflight_seqs=list(self._inflight_seqs),
            src_q=list(self._src_q),
            disp_q={n: list(q) for n, q in self._disp_q.items()},
            win_ch=(channel.snapshot(self._agg_win_ch)
                    if self._agg_win_ch is not None else None),
            win_sig=self._win_sig,
            out_ch={n: channel.snapshot(c) for n, c in self._out_ch.items()},
            overflow_acc=snapshot_tree(self._overflow.mark()),
            stats_acc=snapshot_stats_acc(self._stats_acc),
            edge_stats=copy_edge_stats(self._edge_stats),
            envs={n: op.state() for n, op in self.operators.items()},
            degraded_out=dict(self._degraded_out),
        )
        ck.nbytes = tree_bytes([ck.win_ch and ck.win_ch.slots,
                                [c.slots for c in ck.out_ch.values()],
                                ck.envs])
        self._ckpt = ck
        self._rec["checkpoints"] += 1
        self._rec["checkpoint_bytes"] = ck.nbytes
        for s in [s for s in self._retained if s <= ck.emitted]:
            del self._retained[s]

    def _maybe_checkpoint(self) -> None:
        ce = self._rcfg.checkpoint_every
        if ce and (self._emitted_hw + 1) % ce == 0:
            self._take_checkpoint()

    def _restore_common(self, ck: Checkpoint) -> None:
        self._overflow.restore(restore_tree(ck.overflow_acc, self._sink_dev))
        self._stats_acc = {n: restore_tree(a, self.placement[n])
                           for n, a in ck.stats_acc.items()}
        for n, op in self.operators.items():
            op.restore_state(ck.envs[n], self.placement[n])

    def _restore_full(self, ck: Checkpoint) -> None:
        """Restore the checkpoint as it was and re-feed every retained
        chunk that entered after it: the plain restart."""
        self._agg_win_ch = (channel.restore(ck.win_ch, self._sink_dev)
                            if ck.win_ch is not None else None)
        self._win_sig = ck.win_sig
        self._out_ch = {n: channel.restore(c, self._sink_dev)
                        for n, c in ck.out_ch.items()}
        self._edge_stats = copy_edge_stats(ck.edge_stats)
        self._in_flight = ck.in_flight
        self._inflight_seqs = list(ck.inflight_seqs)
        self._src_q = deque(ck.src_q)
        self._disp_q = {n: deque(q) for n, q in ck.disp_q.items()}
        self._degraded_out = dict(ck.degraded_out)
        self._restore_common(ck)
        refed = sorted(s for s in self._retained
                       if ck.fed <= s < self._next_seq)
        for s in refed:
            if s in self._degraded:
                self._degraded_out[s] = self._run_fallback(s)
            else:
                self._src_q.append((s, self._retained[s]))
        self._rec["replayed"] += len(refed)

    def _rebuild_degraded(self, ck: Checkpoint) -> None:
        """Restart with a degraded seq pending: the faulting chunk must not
        enter the channels again (it would fault the same stage), so they
        are rebuilt empty, every seq not emitted is re-fed from the replay
        buffer, and degraded seqs run through the channel-free fallback."""
        if self._win_example is None:
            self._agg_win_ch = None       # the delta split sink's window
            self._win_sig = None          # channel is sized on next feed
        else:
            self._agg_win_ch = channel.make_channel(
                self._win_example, self.channel_capacity, self._sink_dev)
        self._out_ch = {
            n: channel.make_channel(ex, self.channel_capacity, self._sink_dev)
            for n, ex in self._pub_examples.items()}
        self._edge_stats = copy_edge_stats(ck.edge_stats)
        for e in self._edge_stats.values():
            e["pushes"] = e["pops"]          # rebuilt channels are empty
        self._in_flight = 0
        self._inflight_seqs = []
        self._src_q = deque()
        self._disp_q = {n: deque() for n in self.upstream}
        self._degraded_out = {}
        self._restore_common(ck)
        pending = sorted(s for s in self._retained
                         if ck.emitted < s < self._next_seq)
        for s in pending:
            if s in self._degraded:
                self._degraded_out[s] = self._run_fallback(s)
            else:
                self._src_q.append((s, self._retained[s]))
        self._rec["replayed"] += len(pending)

    def _handle_fault(self, stage: Optional[str], seq: Optional[int]) -> None:
        """One rung down the ladder: blame the failure on a seq, degrade
        that seq once it passes ``max_restarts``, and restore the last
        checkpoint (the full restore, or the degraded rebuild while a
        degraded seq is pending)."""
        if self._ckpt is None:               # fault before any feed
            raise RecoveryExhaustedError(
                "fault in stage %r before any checkpoint exists" % stage)
        self._restart_budget -= 1
        if self._restart_budget < 0:
            raise RecoveryExhaustedError(
                "restart budget exhausted recovering stage %r (seq %s): "
                "the fault is persistent and not attributable to one chunk"
                % (stage, seq))
        key = seq if seq is not None and seq >= 0 else (
            self._inflight_seqs[0] if self._inflight_seqs else -1)
        if key >= 0:
            self._fail_counts[key] = self._fail_counts.get(key, 0) + 1
            if self._fail_counts[key] > self._rcfg.max_restarts:
                self._degraded.add(key)
        self._rec["restarts"] += 1
        ck = self._ckpt
        if any(s > ck.emitted for s in self._degraded):
            self._rebuild_degraded(ck)
        else:
            self._restore_full(ck)

    # -- graceful degradation: the channel-free fallback ----------------------
    def _run_fallback(self, seq: int):
        """One degraded seq through the DAG's stages with the channels cut
        out (``runtime.dag_chunk``, as single_program runs it), on the
        sink's device: operators placed elsewhere run from copies of their
        KB slice and env there.  Every pop of a real chunk is valid, so the
        output is the pipelined (and monolithic) bytes."""
        dev = self._sink_dev
        ops = {n: op.to(dev) for n, op in self.operators.items()}
        with on_device(dev):
            out, overflow, _ = dag_chunk(self.dag, self._split, ops,
                                         self.config,
                                         self._retained[seq].to(dev))
        return out, overflow

    def _pending_count(self) -> int:
        """Chunks accepted but not yet emitted."""
        degraded_pending = sum(
            1 for s in self._degraded_out if s > self._emitted_hw)
        return self._in_flight + len(self._src_q) + degraded_pending

    def _require_idle(self, what: str) -> None:
        # the whole-stream entry points own the schedule end to end: chunks
        # left in flight by manual feed() calls would surface as this
        # call's outputs and overflow
        if self._pending_count():
            raise RuntimeError(
                "%s with %d chunk(s) already in flight; drain() them first"
                % (what, self._pending_count()))

    def process_chunk(self, chunk: TripleBatch
                      ) -> Tuple[TripleBatch, Dict[str, torch.Tensor]]:
        """One chunk, no overlap: feed + drain."""
        self._require_idle("process_chunk")
        self.feed(chunk)
        out = self.drain()
        return out, dict(self._last_overflow)

    def iter_stream(self, chunks: Iterable[TripleBatch]
                    ) -> Iterator[TripleBatch]:
        """Software-pipelined stream execution: yields one published chunk
        per input chunk, in input order.

        ``channel_capacity`` chunks stay in flight: the sink consumes chunk
        *t* only after the producer stages of the chunks after it were
        dispatched, so outputs trail inputs by the pipeline depth.  Needs an
        idle runtime; a generator closed early drains the chunks it left in
        flight, so a later call never sees its leftovers.  With recovery, a
        checkpoint at the stream's end prunes the replay buffer.
        """
        self._require_idle("iter_stream")
        try:
            for c in chunks:
                if self._in_flight >= self.channel_capacity:
                    yield self.drain()
                self.feed(c)
            while self._pending_count():
                pending = self._pending_count()
                yield self.drain()
                if self._pending_count() >= pending:
                    raise PipelineStalledError(
                        "drain() retired no chunk (%d still pending); %s"
                        % (pending, self._stall_detail()))
        except GeneratorExit:           # closed early
            while self._pending_count():
                self.drain()
            raise
        if self._resilient:
            self._take_checkpoint()

    def process_stream(self, chunks: Iterable[TripleBatch]
                       ) -> Tuple[List[TripleBatch], Dict[str, int]]:
        """:meth:`iter_stream` to its end.  Returns ``(outputs, overflow)``
        like ``DSCEPRuntime.process_stream``: the counts cover exactly this
        call's chunks, read once at its end."""
        self._require_idle("process_stream")
        before = self._overflow.mark()
        outs = list(self.iter_stream(chunks))
        return outs, self._overflow.since(before)

    # -- observability ----------------------------------------------------
    def overflow_totals(self) -> Dict[str, int]:
        """Lifetime windows clipped per operator (reads a few scalars)."""
        return self._overflow.totals()

    def channel_stats(self) -> Dict[str, Dict[str, int]]:
        """Occupancy, dropped pushes and schedule counters of every edge.

        ``depth_hw`` is the most payloads an edge held at once: how much
        pipelining the driver achieved against ``capacity``."""
        stats: Dict[str, Dict[str, int]] = {}

        def one(edge: str, ch: Optional[Channel]) -> None:
            # a lazily sized window channel reports its configured capacity
            # before the first feed allocates it
            stats[edge] = {
                "capacity": (ch.capacity if ch is not None
                             else self.channel_capacity),
                "size": ch.size if ch is not None else 0,
                "overflows": ch.overflows if ch is not None else 0,
                **self._edge_stats[edge],
            }

        one("source->%s" % self.final, self._agg_win_ch)
        for name, ch in self._out_ch.items():
            one("%s->%s" % (name, self.final), ch)
        return stats

    def op_metrics(self) -> Dict[str, Dict[str, int]]:
        """Per-operator engine metrics, read from the devices (empty unless
        the runtime has a metrics-collecting tracer)."""
        return {n: finalize_stats(a) for n, a in self._stats_acc.items() if a}

    @property
    def degraded(self) -> bool:
        """True when a chunk was routed around the channels through the
        lossless channel-free fallback (its output is still bit-exact)."""
        return bool(self._degraded)

    def recovery_stats(self) -> Dict[str, Any]:
        """The fault-tolerance surface (``last_stats["recovery"]``):
        injected events per kind, retries, restarts, replays, dedups,
        checkpoints and their bytes, degraded seqs, ingest rejections."""
        st = empty_recovery_stats(self._resilient)
        st.update(self._rec)
        st["degraded_chunks"] = sorted(self._degraded)
        if self._injector is not None:
            st["injected"] = dict(self._injector.fired)
            st["scheduled"] = self._injector.plan.counts()
        return st
