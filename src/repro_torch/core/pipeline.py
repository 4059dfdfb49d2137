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
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Any, Deque, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from . import channel
from .channel import Channel, tree_leaves, tree_map
from ..launch.mesh import place_operators
from .kb import KnowledgeBase
from .operator import publish_chunk
from .planner import OperatorDAG
from .rdf import ID_DTYPE, TripleBatch, Vocab
from .runtime import (
    RuntimeConfig, _OverflowAccumulator, build_dag, sink_kind, sink_stage,
    source_stage, upstream_stage,
)
from .stream import merge_streams
from .window import Windows, window_slides


class PipelineStalledError(RuntimeError):
    """The driver made no progress: work is queued, but no stage can run
    and nothing is in flight to drain."""

    def __init__(self, detail: str):
        super().__init__("pipeline stalled: %s" % detail)


def _zeros_triples(shape, device) -> TripleBatch:
    z = [torch.zeros(shape, dtype=ID_DTYPE, device=device) for _ in range(5)]
    return TripleBatch(*z, torch.zeros(shape, dtype=torch.bool, device=device))


def _flags(num_windows: int, device) -> torch.Tensor:
    return torch.zeros((num_windows,), dtype=torch.bool, device=device)


def _to(tree, device):
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


def _current(device: torch.device):
    """Make ``device`` the current CUDA device for a stage's launches (a
    no-op for the CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
      double-buffered schedule; it bounds the chunks in flight.

    ``feed()`` only queues: chunks land in a host-side source queue, and
    ``_pump()`` advances every stage whose outbound edge has room, so
    ``feed()`` never raises on a full pipeline; excess chunks wait until
    ``drain()`` frees a slot.
    """

    def __init__(self, dag: OperatorDAG, kb: KnowledgeBase, vocab: Vocab,
                 config: Optional[RuntimeConfig] = None,
                 placement: Optional[Dict[str, Any]] = None,
                 channel_capacity: int = 4):
        if channel_capacity < 2:
            raise ValueError(
                "pipelining needs channel_capacity >= 2 (double buffering), "
                "got %d" % channel_capacity)
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
        # width is R * slide_capacity (the window capacity when tumbling)
        slide_cap, slides_per_win = window_slides(cfg.window_capacity,
                                                  cfg.window_step)
        self._agg_win_ch: Optional[Channel] = None
        self._win_sig = None
        if not (self._split is not None and self._split.delta):
            shape = (cfg.max_windows, slide_cap * slides_per_win)
            self._agg_win_ch = channel.make_channel(
                Windows(_zeros_triples(shape, "meta"),
                        _flags(cfg.max_windows, "meta")),
                channel_capacity, self._sink_dev)
        # else the sink consumes the chunk's SlideView, whose stream leaf is
        # sized by the chunk: the window channel is allocated from the
        # first payload (_ensure_win_channel)
        up_out_cap = min(cfg.intermediate_cap, cfg.out_cap)
        self._out_ch: Dict[str, Channel] = {}
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
                example = (table, flags)
            else:
                example = (_zeros_triples((cfg.max_windows, up_out_cap),
                                          "meta"), flags)
            self._out_ch[name] = channel.make_channel(
                example, channel_capacity, self._sink_dev)

        self._in_flight = 0
        # high-water mark of chunks in flight at once: the pipeline depth
        # the driver achieved
        self.depth_hw = 0
        # dispatch queues: _src_q holds raw chunks not yet windowed,
        # _disp_q[name] the windowed payloads operator ``name`` has not run
        self._src_q: Deque[TripleBatch] = deque()
        self._disp_q: Dict[str, Deque[Any]] = {n: deque()
                                               for n in self.upstream}
        # device-side clipped-window counts per operator (read at stream
        # boundaries only)
        self._overflow = _OverflowAccumulator(self.operators, self._sink_dev)
        self._last_overflow: Dict[str, torch.Tensor] = {}
        # host-side schedule counters per edge
        self._edge_stats: Dict[str, Dict[str, int]] = {
            e: {"pushes": 0, "pops": 0, "depth_hw": 0} for e in self._edges()}

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
    def _sink_impl(self) -> Tuple[TripleBatch, Dict[str, torch.Tensor]]:
        """Aggregation operator step: pop every inbound edge, join,
        publish.  An empty pop's outputs and overflow flags are masked out
        by its validity."""
        self._agg_win_ch, sink_payload, has = channel.pop(self._agg_win_ch)
        overflow: Dict[str, torch.Tensor] = {}
        inputs: Dict[str, Any] = {}
        for name in self.upstream:
            self._out_ch[name], (pub, ovf), h = channel.pop(self._out_ch[name])
            inputs[name] = pub
            overflow[name] = _if_valid(ovf, h)
        out_w, ovf_f = sink_stage(self.dag, self._split,
                                  self.operators[self.final], sink_payload,
                                  inputs)
        overflow[self.final] = _if_valid(ovf_f, has)
        out = publish_chunk(out_w, self.config.out_stream_cap)
        if not has:
            out = out._replace(valid=torch.zeros_like(out.valid))
        return out, overflow

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

    def _push(self, stage: str, edge: str, payload) -> None:
        if stage == "source":
            self._agg_win_ch = channel.push(self._agg_win_ch, payload)
        else:
            self._out_ch[stage] = channel.push(self._out_ch[stage], payload)
        self._edge_pushed(edge)

    def _pump(self) -> None:
        """Advance every stage that has queued work and a free slot to
        publish into.  With equal edge capacities the operator dispatch
        queues empty within the pump that windows their chunk; they exist
        so ``feed()`` never blocks on a full pipeline."""
        src_edge = "source->%s" % self.final
        while self._src_q and self._edge_room(src_edge):
            chunk = self._src_q.popleft()
            with _current(self._sink_dev):
                sink_payload, op_payload = source_stage(
                    merge_streams([chunk]), self.config, self._split)
            self._ensure_win_channel(sink_payload)
            self._push("source", src_edge, sink_payload)
            for name in self.upstream:
                self._disp_q[name].append(op_payload)
            self._in_flight += 1
            self.depth_hw = max(self.depth_hw, self._in_flight)
        for name in self.upstream:
            edge = "%s->%s" % (name, self.final)
            q = self._disp_q[name]
            dev = self.placement[name]
            while q and self._edge_room(edge):
                with _current(dev):
                    pub = upstream_stage(self._split, name,
                                         self.operators[name],
                                         _to(q.popleft(), dev),
                                         self.config.max_windows)
                self._push(name, edge, pub)

    def feed(self, chunk: TripleBatch) -> None:
        """Accept one chunk and dispatch every stage with room.  Never
        raises on a full pipeline: chunks past the channel capacity wait in
        the source queue until ``drain()`` frees slots."""
        self._src_q.append(chunk)
        self._pump()

    def drain(self) -> TripleBatch:
        """Dispatch the sink stage for the oldest chunk in flight and
        return its published chunk (a device tensor: read it when the host
        needs the values).  Overflow flags accumulate on the device; read
        them with :meth:`overflow_totals`."""
        self._pump()
        if self._in_flight == 0:
            if self._src_q:
                raise PipelineStalledError(self._stall_detail())
            raise RuntimeError("nothing in flight; feed() first")
        out = self._drain_once()
        self._pump()          # the pop freed a slot on every edge
        return out

    def _drain_once(self) -> TripleBatch:
        # equal edge capacities keep the operator stages in step with the
        # source stage: the sink never pops an unmatched window
        assert all(not q for q in self._disp_q.values()), (
            "operator dispatch queues lag the window edge")
        with _current(self._sink_dev):
            out, overflow = self._sink_impl()
        for edge in self._edges():
            self._edge_stats[edge]["pops"] += 1
        for name, flags in overflow.items():
            self._overflow.add(name, flags)
        self._last_overflow = overflow
        self._in_flight -= 1
        return out

    def _stall_detail(self) -> str:
        blocked = [e for e in self._edges() if not self._edge_room(e)]
        return ("%d chunk(s) queued at the source but nothing is in flight "
                "to drain and no stage can advance; blocked edge(s): %s"
                % (len(self._src_q), ", ".join(blocked) if blocked else
                   "none (driver accounting bug)"))

    def _pending_count(self) -> int:
        """Chunks accepted but not yet emitted."""
        return self._in_flight + len(self._src_q)

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
        flight, so a later call never sees its leftovers.
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
