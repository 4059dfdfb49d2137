"""Deterministic fault injection and ingest validation for the pipelined
runtime.

An operator graph spread over devices is only credible if an operator
stall, a lost channel payload or a poisoned input neither corrupts nor
kills the stream.  This module supplies the two host-side ingredients the
recovery layer (:mod:`repro_torch.core.recovery`) builds on:

* :class:`FaultPlan` — a **seeded, exactly reproducible** schedule of
  fault events keyed by ``(stage, chunk_idx)``.  Five kinds cover the
  failure modes a Kafka-style deployment sees:

  - ``drop_payload``      — a stage's outbound channel payload is lost in
    transit (the push never lands);
  - ``duplicate_payload`` — the payload is delivered twice (at-least-once
    transport without dedup);
  - ``stall_stage``       — the stage's step exceeds its timeout once
    (surfaces as a :class:`~repro_torch.core.recovery.StageTimeoutError`,
    through the retry/backoff ladder);
  - ``crash_stage``       — the stage's step raises mid-chunk (checkpoint
    restore + replay);
  - ``corrupt_chunk``     — the chunk is scribbled between the ingest gate
    and the window stage (:func:`validate_chunk` + recovery of the
    pristine copy from the replay buffer).

* :func:`validate_chunk` — the ingest gate: checks a
  :class:`~repro_torch.core.rdf.TripleBatch` against the interned id bands
  *before* it reaches a stage, so malformed input is a counted,
  attributable rejection instead of undefined id arithmetic.

Everything here is host bookkeeping: with ``faults=None`` the pipelined
runtime never calls into this module, and its stages run the same torch
ops and kernel launches as without it (``tests/test_torch_faults.py``).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .rdf import NUM_BASE, PRED_SPACE, ROW_BASE, TERM_SPACE, TripleBatch, Vocab

# the five injectable failure modes (see module docstring)
FAULT_KINDS = (
    "drop_payload", "duplicate_payload", "stall_stage", "crash_stage",
    "corrupt_chunk",
)


class FaultError(RuntimeError):
    """Base class for injected faults (raised on the host)."""


class InjectedCrash(FaultError):
    """An injected ``crash_stage`` event firing inside a stage dispatch."""

    def __init__(self, stage: str, seq: int):
        super().__init__(
            "injected crash in stage %r while processing chunk seq %d"
            % (stage, seq))
        self.stage = stage
        self.seq = seq


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` fires when ``stage`` touches chunk
    ``chunk`` (the 0-based lifetime sequence number the driver assigns at
    ``feed()``).  ``drop_payload``/``duplicate_payload`` name the *producer*
    stage whose outbound payload is affected; ``corrupt_chunk`` ignores the
    stage (corruption happens at ingest, use ``"ingest"``)."""

    kind: str
    stage: str
    chunk: int

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                "unknown fault kind %r (expected one of %s)"
                % (self.kind, list(FAULT_KINDS)))
        if self.chunk < 0:
            raise ValueError("chunk index must be >= 0, got %d" % self.chunk)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, hashable schedule of :class:`FaultEvent`\\ s.

    Frozen so it can live inside the (frozen, hashable)
    :class:`~repro_torch.core.session.ExecutionConfig`.  The plan itself
    carries no runtime state — each
    :class:`~repro_torch.core.pipeline.PipelinedRuntime`
    builds its own :class:`FaultInjector` over it, and every event fires at
    most **once** per runtime: a replayed chunk does not re-trip the fault
    that crashed it, which is exactly the at-most-once semantics a
    deterministic chaos schedule needs to terminate.
    """

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    @classmethod
    def seeded(
        cls,
        seed: int,
        stages: Sequence[str],
        num_chunks: int,
        n_events: int = 4,
        kinds: Sequence[str] = FAULT_KINDS,
    ) -> "FaultPlan":
        """A reproducible random schedule: ``n_events`` events drawn by
        ``random.Random(seed)`` over the given stages and chunk range.  The
        same ``(seed, stages, num_chunks, n_events, kinds)`` always yields
        the same plan — chaos runs replay exactly."""
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError("unknown fault kind %r" % k)
        rng = random.Random(seed)
        events = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            stage = "ingest" if kind == "corrupt_chunk" else rng.choice(
                list(stages))
            events.append(FaultEvent(kind, stage, rng.randrange(num_chunks)))
        return cls(tuple(events))

    def counts(self) -> Dict[str, int]:
        """Scheduled events per kind (what a chaos test expects to fire)."""
        out = {k: 0 for k in FAULT_KINDS}
        for ev in self.events:
            out[ev.kind] += 1
        return out


class FaultInjector:
    """Per-runtime firing state over a :class:`FaultPlan`.

    ``take(kind, stage, chunk)`` consumes (fires) one matching un-fired
    event and returns ``True``; the driver calls it at each injection point
    (stage dispatch, channel push, ingest).  ``fired`` counts fired events
    per kind — `last_stats["recovery"]["injected"]` reports them so tests
    can assert the schedule was exercised *exactly*.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending: List[FaultEvent] = list(plan.events)
        self.fired: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    def take(self, kind: str, stage: str, chunk: int) -> bool:
        for i, ev in enumerate(self._pending):
            if ev.kind == kind and ev.chunk == chunk and (
                    ev.stage == stage or ev.kind == "corrupt_chunk"):
                del self._pending[i]
                self.fired[kind] += 1
                return True
        return False

    def pending(self) -> int:
        return len(self._pending)

    def fired_total(self) -> int:
        return sum(self.fired.values())


# --------------------------------------------------------------------------
# ingest validation
# --------------------------------------------------------------------------

def validate_chunk(
    chunk: TripleBatch,
    vocab: Optional[Vocab] = None,
    max_graph_size: Optional[int] = None,
) -> List[str]:
    """The ingest gate: reasons a :class:`TripleBatch` must not reach a
    stage (empty list = valid).  Host-side numpy over the valid rows (one
    copy of the chunk to the host):

    * predicate ids of valid rows must be interned — ``[1, vocab.num_preds)``
      (the synthetic closure band and id 0 never appear on the wire);
    * subject/object ids must be interned terms
      (``[PRED_SPACE, PRED_SPACE + vocab.num_terms)``) or numeric literals
      (``>= NUM_BASE``) — the synthetic row-node band is operator-internal;
    * the ``valid`` mask must be boolean (anything else makes ``count()``
      and window packing lie);
    * with ``max_graph_size``, no graph event may exceed it (a graph larger
      than the window capacity can never be windowed whole).

    Without a ``vocab`` the structural band bounds are used instead of the
    live interner extents.
    """
    reasons: List[str] = []
    if chunk.valid.dtype != torch.bool:
        return ["valid mask must be boolean, got dtype %s"
                % str(chunk.valid.dtype).replace("torch.", "")]
    v = chunk.valid.cpu().numpy()
    if not v.any():
        return reasons
    s, p, o, g = (c.cpu().numpy()[v].astype(np.int64)
                  for c in (chunk.s, chunk.p, chunk.o, chunk.graph))
    pred_hi = vocab.num_preds if vocab is not None else PRED_SPACE
    term_hi = (PRED_SPACE + vocab.num_terms if vocab is not None
               else PRED_SPACE + TERM_SPACE)
    if ((p < 1) | (p >= pred_hi)).any():
        reasons.append(
            "predicate id outside the interned band [1, %d)" % pred_hi)

    def _bad_term(t: np.ndarray) -> np.ndarray:
        interned = (t >= PRED_SPACE) & (t < term_hi)
        numeric = t >= int(NUM_BASE)
        return ~(interned | numeric)

    if _bad_term(s).any():
        reasons.append(
            "subject id outside the vocab bands ([%d, %d) or numeric)"
            % (PRED_SPACE, term_hi))
    if _bad_term(o).any():
        reasons.append(
            "object id outside the vocab bands ([%d, %d) or numeric)"
            % (PRED_SPACE, term_hi))
    if ((s >= int(ROW_BASE)) & (s < int(NUM_BASE))).any() or (
            (o >= int(ROW_BASE)) & (o < int(NUM_BASE))).any():
        # row nodes are synthetic operator-internal ids; reaching ingest
        # means a publication leaked back into a source stream
        reasons.append("synthetic row-node id in an ingest stream")
    if max_graph_size is not None and g.size:
        _, counts = np.unique(g, return_counts=True)
        worst = int(counts.max())
        if worst > max_graph_size:
            reasons.append(
                "graph event of %d triples exceeds the %d-triple cap"
                % (worst, max_graph_size))
    return reasons


def corrupt_batch(chunk: TripleBatch) -> TripleBatch:
    """The deterministic in-transit scribble a ``corrupt_chunk`` event
    applies: the first row becomes a live triple whose predicate sits in the
    reserved closure band and whose subject falls in the dead zone between
    the term band and the numeric band — both caught by
    :func:`validate_chunk` whatever the vocab extents are.  Pure (returns a
    new batch); the pristine chunk stays in the driver's replay buffer.
    """
    s, p, valid = chunk.s.clone(), chunk.p.clone(), chunk.valid.clone()
    s[0] = int(ROW_BASE) + 7            # row-node band
    p[0] = PRED_SPACE - 1               # closure band
    valid[0] = True
    return chunk._replace(s=s, p=p, valid=valid)
