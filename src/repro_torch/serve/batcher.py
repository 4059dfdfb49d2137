"""Admission front-end for the multi-query serving engine.

The serving engine wants a bounded standing-query population and a steady
chunk feed; tenants arrive ragged.  :class:`QueryAdmission` owns
``num_slots`` query slots (claim on free, retire on done, a fixed-shape
engine tick):

* **query slots**: ``submit`` queues a registration request; ``admit``
  moves queued requests into free slots by registering them with the
  :class:`~repro_torch.serve.engine.ServeEngine`; ``retire`` unregisters
  and frees the slot.  A full admission queue rejects (backpressure,
  counted).
* **per-tenant chunk queues**: ``offer_chunk`` appends to the tenant's
  bounded queue and returns ``False`` (and counts a rejection) when it is
  full, so producers see backpressure instead of unbounded memory.
* **round-robin ticks**: each ``tick`` drains one chunk from the next
  non-empty tenant queue through ``engine.process_chunk``, so no tenant
  starves the others however fast it produces.
* **validation and quarantine**: an optional ingest ``validator``
  (defaulted by :meth:`repro_torch.serve.engine.ServeEngine.admission` to
  :func:`repro_torch.core.faults.validate_chunk` over the session vocab)
  rejects malformed chunks at the queue boundary with per-tenant reasons,
  and a tenant whose ticks *fault* ``max_tenant_faults`` times in a row is
  quarantined (its queries retired, its queue dropped, further traffic
  refused) instead of taking the whole engine down.

Everything here is host bookkeeping; the device work happens inside the
engine's step.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class QueryRequest:
    """A standing-query admission request (text or AST, per tenant)."""

    query: Any                     # C-SPARQL text or a core.query.Query
    tenant: str = "default"
    name: Optional[str] = None     # fallback name for text without REGISTER


@dataclasses.dataclass
class QuerySlot:
    request: Optional[QueryRequest] = None
    name: Optional[str] = None     # registered query name while occupied


class QueryAdmission:
    """Slot-based admission + per-tenant chunk queues over a ServeEngine."""

    def __init__(self, engine, num_slots: int = 64,
                 queue_cap: int = 256, chunk_queue_cap: int = 8,
                 validator: Optional[Callable[[Any], List[str]]] = None,
                 max_tenant_faults: int = 3):
        self.engine = engine
        self.num_slots = num_slots
        self.slots = [QuerySlot() for _ in range(num_slots)]
        self.queue: Deque[QueryRequest] = deque()
        self.queue_cap = queue_cap
        self.chunk_queue_cap = chunk_queue_cap
        self.chunk_queues: Dict[str, Deque] = {}
        self._rr: List[str] = []          # round-robin tenant order
        self._rr_next = 0
        # ingest gate: chunk -> list of rejection reasons ([] = valid)
        self.validator = validator
        # consecutive *faulting* ticks (engine exceptions) a tenant is
        # allowed before quarantine; successes reset the count
        self.max_tenant_faults = max_tenant_faults
        self.quarantined: Set[str] = set()
        self._consec_faults: Dict[str, int] = {}
        self.invalid_reasons: Dict[str, List[str]] = {}   # last per tenant
        self.counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "retired": 0,
            "rejected_queries": 0, "chunks_offered": 0,
            "chunks_rejected": 0, "chunks_processed": 0,
            "chunks_dropped": 0, "ticks": 0,
            "chunks_invalid": 0, "tenant_faults": 0,
            "quarantined_tenants": 0,
        }

    # -- query lifecycle -----------------------------------------------------
    def submit(self, req: QueryRequest, admit: bool = True) -> bool:
        """Queue a standing-query registration; ``False`` = queue full (or
        the tenant is quarantined)."""
        self.counters["submitted"] += 1
        if req.tenant in self.quarantined:
            self.counters["rejected_queries"] += 1
            return False
        if len(self.queue) >= self.queue_cap:
            self.counters["rejected_queries"] += 1
            return False
        self.queue.append(req)
        if admit:
            self.admit()
        return True

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.request is None:
                return i
        return None

    def admit(self) -> List[str]:
        """Register queued requests into free slots; returns new names."""
        admitted: List[str] = []
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.queue.popleft()
            unit = self.engine.register(req.query, name=req.name)
            self.slots[slot] = QuerySlot(req, name=unit.name)
            self.counters["admitted"] += 1
            admitted.append(unit.name)
        return admitted

    def retire(self, name: str, drain: bool = True) -> None:
        """Unregister a standing query and free its slot.

        When this was the tenant's **last** admitted query (and the tenant
        has nothing waiting in the admission queue), the tenant's chunk
        queue and round-robin membership are torn down with it: with
        ``drain=True`` (default) its queued chunks are processed through the
        engine *before* unregistering — the retiring query still sees its
        tenant's final chunks — with ``drain=False`` they are discarded and
        counted as ``chunks_dropped``.  The round-robin cursor is
        re-anchored around the removal so the rotation resumes at the same
        neighbour — leaving the cursor untouched would skip or double-serve
        a tenant, and leaving retired tenants in the rotation forever would
        burn a tick slot on every revolution.
        """
        for i, s in enumerate(self.slots):
            if s.name == name:
                tenant = s.request.tenant if s.request else None
                last = tenant is not None and not (
                    any(o.request is not None and o.request.tenant == tenant
                        for j, o in enumerate(self.slots) if j != i)
                    or any(r.tenant == tenant for r in self.queue))
                if last:
                    self._teardown_tenant(tenant, drain)
                self.engine.unregister(name)
                self.slots[i] = QuerySlot()
                self.counters["retired"] += 1
                self.admit()               # backfill from the queue
                return
        raise KeyError("no admitted query named %r" % name)

    def _teardown_tenant(self, tenant: str, drain: bool) -> None:
        q = self.chunk_queues.pop(tenant, None)
        if q:
            if drain:
                while q:
                    self.engine.process_chunk(q.popleft())
                    self.counters["chunks_processed"] += 1
            else:
                self.counters["chunks_dropped"] += len(q)
                q.clear()
        if tenant in self._rr:
            idx = self._rr.index(tenant)
            pos = self._rr_next % len(self._rr)
            self._rr.remove(tenant)
            if not self._rr:
                self._rr_next = 0
            else:
                self._rr_next = (pos - 1 if idx < pos else pos) % len(self._rr)

    def active(self) -> List[str]:
        return [s.name for s in self.slots if s.name is not None]

    # -- chunk feed ------------------------------------------------------------
    def offer_chunk(self, chunk, tenant: str = "default") -> bool:
        """Bounded per-tenant enqueue; ``False`` = backpressure, a
        quarantined tenant, or a chunk the ingest validator rejected
        (each counted separately)."""
        self.counters["chunks_offered"] += 1
        if tenant in self.quarantined:
            self.counters["chunks_rejected"] += 1
            return False
        if self.validator is not None:
            reasons = self.validator(chunk)
            if reasons:
                self.counters["chunks_invalid"] += 1
                self.invalid_reasons[tenant] = list(reasons)
                return False
        q = self.chunk_queues.get(tenant)
        if q is None:
            q = self.chunk_queues[tenant] = deque()
            self._rr.append(tenant)
        if len(q) >= self.chunk_queue_cap:
            self.counters["chunks_rejected"] += 1
            return False
        q.append(chunk)
        return True

    def pending_chunks(self) -> int:
        return sum(len(q) for q in self.chunk_queues.values())

    def tick(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        """One engine tick: pop one chunk from the next non-empty tenant
        queue (round-robin) and push it through every admitted query.
        Returns ``(tenant, outputs)`` or ``None`` when all queues are empty.

        A tick that *faults* (the engine raises on this tenant's chunk) is
        contained: the exception is counted against the tenant, and after
        ``max_tenant_faults`` consecutive faults the tenant is quarantined
        — its standing queries retired, its queued chunks dropped, further
        traffic refused — so one poisoned feed cannot take down the shared
        engine.  Successful ticks reset the tenant's fault count.
        """
        self.counters["ticks"] += 1
        for _ in range(len(self._rr)):
            tenant = self._rr[self._rr_next % len(self._rr)]
            self._rr_next += 1
            q = self.chunk_queues[tenant]
            if q:
                chunk = q.popleft()
                try:
                    outs = self.engine.process_chunk(chunk)
                except Exception:
                    self.counters["tenant_faults"] += 1
                    n = self._consec_faults.get(tenant, 0) + 1
                    self._consec_faults[tenant] = n
                    if n >= self.max_tenant_faults:
                        self.quarantine(tenant)
                    return None
                self._consec_faults[tenant] = 0
                self.counters["chunks_processed"] += 1
                return tenant, outs
        return None

    def quarantine(self, tenant: str) -> None:
        """Isolate a repeatedly-faulting tenant: retire its admitted
        queries (without draining — its chunks are suspect), purge its
        waiting registrations, drop its queue, and refuse future traffic."""
        if tenant in self.quarantined:
            return
        self.quarantined.add(tenant)
        self.counters["quarantined_tenants"] += 1
        # purge waiting registrations first so retire()'s last-query check
        # sees no pending work for the tenant and tears its queue down
        purged = [r for r in self.queue if r.tenant == tenant]
        for r in purged:
            self.queue.remove(r)
            self.counters["rejected_queries"] += 1
        for name in [s.name for s in self.slots
                     if s.request is not None and s.request.tenant == tenant
                     and s.name is not None]:
            self.retire(name, drain=False)
        # a tenant with chunks but no admitted query: tear down directly
        if tenant in self.chunk_queues:
            self._teardown_tenant(tenant, drain=False)
        self._consec_faults.pop(tenant, None)

    def drain(self) -> List[Tuple[str, Dict[str, Any]]]:
        """Tick until every tenant queue is empty."""
        outs: List[Tuple[str, Dict[str, Any]]] = []
        while self.pending_chunks():
            res = self.tick()
            if res is not None:
                outs.append(res)
        return outs

    # -- observability ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            **self.counters,
            "slots": self.num_slots,
            "occupied_slots": len(self.active()),
            "queued_queries": len(self.queue),
            "chunk_queue_depths": {
                t: len(q) for t, q in self.chunk_queues.items()
            },
            "quarantined": sorted(self.quarantined),
            "invalid_reasons": {t: list(r)
                                for t, r in self.invalid_reasons.items()},
        }
