"""Checkpoint/restart machinery for the pipelined dataflow runtime.

The pipelined mode is the paper's deployment shape — independently
scheduled operators over bounded queues — and so the mode where partial
failure is a normal event: a stage wedges, a channel payload is lost or
delivered twice, a chunk arrives corrupted.  This module holds the
host-side recovery primitives
:class:`~repro_torch.core.pipeline.PipelinedRuntime` drives:

* :class:`RecoveryConfig` — the knobs (checkpoint cadence, stage timeout,
  retry/backoff budget, restart budget, ingest validation);
* :class:`Checkpoint` — a host-side snapshot of the driver and device
  state (channel rings, overflow and stat accumulators, dispatch queues,
  sequence watermarks, per-operator env) taken every ``checkpoint_every``
  emitted chunks;
* the error ladder (:class:`StageTimeoutError` → retry/backoff,
  :class:`ChannelDesyncError`/:class:`~repro_torch.core.faults.InjectedCrash`
  → checkpoint restore + replay, :class:`RecoveryExhaustedError` when the
  budget is spent) plus the driver-misuse and ingest errors
  (:class:`PipelineStalledError`, :class:`ChunkRejectedError`).

Recovery is **bit-exact**: a checkpoint captures every tensor the stages
read that a later step rewrites in place (the channel rings, whose slots
``push`` overwrites), the replay buffer keeps the pristine fed chunks past
the checkpoint's emitted watermark, and the sink dedups replayed outputs by
sequence number, so the recovered output stream is the fault-free run's
bytes (``tests/test_torch_faults.py``).  With ``faults=None`` and
``recovery=None`` the pipelined runtime never calls into this module.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from ..obs.trace import record_events
from .channel import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Fault-tolerance knobs for the pipelined runtime (frozen and
    hashable, so it rides inside
    :class:`~repro_torch.core.session.ExecutionConfig`).

    * ``checkpoint_every`` — snapshot the driver and device state every N
      *emitted* chunks; ``0`` disables periodic checkpoints (the initial
      clean-state checkpoint is still taken, so crash recovery replays from
      the stream head — correct, just unbounded replay).
    * ``stage_timeout_s`` — per-stage wall-clock budget for the stage's
      device work; ``None`` disables the watchdog (injected stalls still
      exercise the timeout path).
    * ``max_retries``/``backoff_s`` — bounded exponential backoff for a
      timed-out stage before escalating to a restart.
    * ``max_restarts`` — checkpoint restores attributable to one chunk
      before that chunk is *degraded*: re-evaluated through the
      channel-free stages (same plan, same canonical order ⇒ same bytes).
    * ``validate``/``max_graph_size`` — run the
      :func:`~repro_torch.core.faults.validate_chunk` ingest gate on every
      fed chunk (``max_graph_size`` adds the per-event size cap).
    """

    checkpoint_every: int = 4
    stage_timeout_s: Optional[float] = None
    max_retries: int = 3
    backoff_s: float = 0.01
    max_restarts: int = 2
    validate: bool = True
    max_graph_size: Optional[int] = None

    def __post_init__(self):
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if self.max_retries < 0 or self.max_restarts < 0:
            raise ValueError("max_retries/max_restarts must be >= 0")
        if self.stage_timeout_s is not None and self.stage_timeout_s <= 0:
            raise ValueError("stage_timeout_s must be positive or None")


# --------------------------------------------------------------------------
# the error ladder
# --------------------------------------------------------------------------

class StageTimeoutError(RuntimeError):
    """A stage's step exceeded its wall-clock budget (or an injected
    ``stall_stage`` event simulated one).  First rung of the ladder: the
    driver retries with exponential backoff up to ``max_retries``."""

    def __init__(self, stage: str, seq: int, timeout_s: Optional[float],
                 injected: bool = False):
        kind = "injected stall" if injected else (
            "no progress within %.3gs" % (timeout_s or 0.0))
        super().__init__(
            "stage %r timed out on chunk seq %d (%s)" % (stage, seq, kind))
        self.stage = stage
        self.seq = seq
        self.injected = injected


class ChannelDesyncError(RuntimeError):
    """An edge's occupancy disagrees with the chunks in flight — a payload
    was lost or duplicated in transport.  Detected before the sink pops
    (popping unmatched edges would join wrong windows); recovered by
    checkpoint restore + replay."""

    def __init__(self, edge: str, actual: int, expected: int):
        word = "lost" if actual < expected else "duplicated"
        super().__init__(
            "channel desync on edge %r: %d payload(s) queued where the "
            "schedule expects %d (a payload was %s in transport)"
            % (edge, actual, expected, word))
        self.edge = edge
        self.actual = actual
        self.expected = expected


class PipelineStalledError(RuntimeError):
    """The driver made no progress: work is queued, but no stage can run
    and nothing is in flight to drain."""

    def __init__(self, detail: str):
        super().__init__("pipeline stalled: %s" % detail)


class ChunkRejectedError(ValueError):
    """The ingest gate rejected a fed chunk (malformed ids, mask or
    geometry).  Carries the reasons; the pipeline state is untouched, so
    the caller may drop the chunk and continue the stream."""

    def __init__(self, reasons: List[str]):
        super().__init__(
            "chunk rejected at ingest: %s" % "; ".join(reasons))
        self.reasons = list(reasons)


class RecoveryExhaustedError(RuntimeError):
    """The global restart budget is spent and the stream still cannot make
    progress — the fault is persistent and not attributable to one chunk.
    Final rung: surfaced to the caller instead of looping forever."""


# --------------------------------------------------------------------------
# snapshots
# --------------------------------------------------------------------------

def snapshot_tree(tree: Any) -> Any:
    """Deep host copy of a tree of device tensors (``None``-safe).  The
    copy waits for the work that writes them, and shares no storage with
    them."""
    return tree_map(lambda t: t.to("cpu", copy=True), tree)


def restore_tree(snap: Any, device) -> Any:
    """A host snapshot back on ``device``, as tensors of its own (a later
    in-place write never reaches the snapshot, which may be restored
    again)."""
    return tree_map(lambda t: t.to(device, copy=True), snap)


def tree_bytes(tree: Any) -> int:
    """Payload bytes of the tensors of a host snapshot (checkpoint size)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclasses.dataclass
class Checkpoint:
    """One consistent cut of the pipelined driver and device state.

    ``fed``/``emitted`` are the sequence watermarks at snapshot time (seqs
    < ``fed`` had entered the driver; seqs <= ``emitted`` had been emitted).
    Channel rings, accumulators and envs are host deep copies.  Queue
    payloads and raw chunks are *references*: they are stage outputs or
    fed chunks, which nothing writes in place.
    """

    fed: int
    emitted: int
    in_flight: int
    inflight_seqs: List[int]
    src_q: List[Tuple[int, Any]]
    disp_q: Dict[str, List[Tuple[int, Any]]]
    win_ch: Any                       # host snapshot (None: not sized yet)
    win_sig: Any
    out_ch: Dict[str, Any]            # host snapshots
    overflow_acc: Dict[str, Any]      # host scalars
    stats_acc: Dict[str, Dict[str, Any]]
    edge_stats: Dict[str, Dict[str, int]]
    envs: Dict[str, Any]              # per-operator env host snapshots
    degraded_out: Dict[int, Any]      # seq -> (out, overflow) refs
    nbytes: int = 0


def wait_until_ready(out: Any, timeout_s: float) -> bool:
    """Wait for a step's outputs with a wall-clock budget.

    Records an event on the current stream of each CUDA device holding a
    tensor of ``out`` and polls them against the clock: ``True`` = the
    work completed in time, ``False`` = the budget elapsed (the kernels run
    on, since a launch cannot be cancelled, but the driver is free to
    restore a checkpoint and move on).  CPU tensors are ready on return.
    """
    events = record_events(out)
    deadline = time.perf_counter() + timeout_s
    pause = 1e-5
    while not all(ev.query() for ev in events):
        if time.perf_counter() >= deadline:
            return False
        time.sleep(pause)
        pause = min(2 * pause, 1e-3)
    return True


def copy_edge_stats(edge_stats: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    return {e: dict(v) for e, v in edge_stats.items()}


def snapshot_stats_acc(stats_acc: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    return {n: snapshot_tree(a) for n, a in stats_acc.items()}


def empty_recovery_stats(enabled: bool = False) -> Dict[str, Any]:
    """The uniform ``last_stats["recovery"]`` shape for runtimes without
    fault machinery (monolithic, single-program) and fresh pipelines."""
    return {
        "enabled": enabled,
        "injected": {},
        "scheduled": {},
        "retries": 0,
        "restarts": 0,
        "replayed": 0,
        "deduped": 0,
        "checkpoints": 0,
        "checkpoint_bytes": 0,
        "degraded_chunks": [],
        "rejected": 0,
        "corrupt_recovered": 0,
    }
