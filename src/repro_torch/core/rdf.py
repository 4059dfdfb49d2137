"""Dictionary-encoded RDF terms and triple tensors (PyTorch port).

Every term (URI, blank node, literal) is interned into a uint32 id space by
:class:`Vocab`.  The id space is split so that composite sort keys fit in 32
bits:

* predicates:      ``[1, PRED_SPACE)``            (< 2**12 ids)
* URIs / strings:  ``[PRED_SPACE, NUM_BASE)``     (< 2**20 ids)
* numeric literals: ``[NUM_BASE, 2**32)`` encoded as
  ``NUM_BASE + NUM_OFFSET + round(v * NUM_SCALE)``

id 0 is the reserved PAD/NULL term (also SPARQL's unbound value).

**Representation.** ``torch.uint32`` lacks sort, searchsorted and cumsum,
and int32 bit patterns order ``0xFFFFFFFF`` as -1.  So every id tensor in
the port is ``torch.int64`` holding a value in ``[0, 2**32)``: unsigned
order is the int64 order.  Kernels take 32-bit words (:func:`to_u32_bits`
/ :func:`from_u32_bits`): the KB's once, as ``KnowledgeBase.words``, and
the binding tables in the join wrappers, on every call.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

PAD_ID = 0
PRED_BITS = 12
TERM_BITS = 20
PRED_SPACE = 1 << PRED_BITS          # predicate ids live in [1, 4096)
# top of the predicate band is reserved for per-query synthetic predicates
# (closure-pair relations of p+/p* paths, see planner.py)
CLOSURE_PRED_BASE = PRED_SPACE - 64
TERM_SPACE = 1 << TERM_BITS          # term ids live in [PRED_SPACE, 2**20)
NUM_BASE = 1 << 30                   # numeric literals live above this
NUM_SCALE = 100.0                    # fixed-point scale for numeric literals
NUM_OFFSET = 1 << 29                 # fixed-point zero (admits negatives)
# synthetic per-binding row nodes (the binding-graph protocol between SCEP
# operators) live in the free band between URI terms and numeric literals
ROW_BASE = 1 << 21
U32_MAX = 0xFFFFFFFF

ID_DTYPE = torch.int64

TermLike = Union[str, int, float]


class VocabError(ValueError):
    pass


class Vocab:
    """Bidirectional interning of RDF terms into the split uint32 id space."""

    def __init__(self) -> None:
        self._pred_to_id: Dict[str, int] = {}
        self._term_to_id: Dict[str, int] = {}
        self._id_to_str: Dict[int, str] = {PAD_ID: "<pad>"}
        self._next_pred = 1
        self._next_term = PRED_SPACE

    # -- encoding ----------------------------------------------------------
    def pred(self, name: str) -> int:
        pid = self._pred_to_id.get(name)
        if pid is None:
            if self._next_pred >= CLOSURE_PRED_BASE:
                raise VocabError(
                    "predicate space exhausted (max %d; the top band is "
                    "reserved for synthetic closure predicates)"
                    % CLOSURE_PRED_BASE)
            pid = self._next_pred
            self._next_pred += 1
            self._pred_to_id[name] = pid
            self._id_to_str[pid] = name
        return pid

    def term(self, name: TermLike) -> int:
        if isinstance(name, (int, float)) and not isinstance(name, bool):
            return self.number(float(name))
        tid = self._term_to_id.get(name)
        if tid is None:
            if self._next_term >= PRED_SPACE + TERM_SPACE:
                raise VocabError("term space exhausted (max %d)" % TERM_SPACE)
            tid = self._next_term
            self._next_term += 1
            self._term_to_id[name] = tid
            self._id_to_str[tid] = name
        return tid

    @staticmethod
    def number(value: float) -> int:
        """Encode a numeric literal as a fixed-point id (order-isomorphic)."""
        q = int(round(value * NUM_SCALE)) + NUM_OFFSET
        if q < 0:
            raise VocabError(
                "literal %r below the encodable range (min %s)"
                % (value, -NUM_OFFSET / NUM_SCALE))
        if NUM_BASE + q > U32_MAX:
            raise VocabError(
                "literal %r above the encodable range (max %s)"
                % (value, (U32_MAX - NUM_BASE - NUM_OFFSET) / NUM_SCALE))
        return NUM_BASE + q

    @staticmethod
    def is_number(term_id: int) -> bool:
        return int(term_id) >= NUM_BASE

    @staticmethod
    def decode_number(term_id: int) -> float:
        return (int(term_id) - NUM_BASE - NUM_OFFSET) / NUM_SCALE

    # -- decoding ----------------------------------------------------------
    def to_str(self, term_id: int) -> str:
        term_id = int(term_id)
        if term_id >= NUM_BASE:
            return repr(self.decode_number(term_id))
        return self._id_to_str.get(term_id, "<unk:%d>" % term_id)

    @property
    def num_preds(self) -> int:
        return self._next_pred

    @property
    def num_terms(self) -> int:
        return self._next_term - PRED_SPACE


def composite_key(p, term):
    """``(p << TERM_BITS) | low_bits(term)`` probe key on int64-held uint32.

    Terms are offset by PRED_SPACE so they fit in TERM_BITS bits; numeric
    literals are hashed into the same width (the joins re-check equality
    exactly, so collisions only cost verification work).  ``p`` and
    ``term`` are int64 tensors or Python ints; the result is an int64
    tensor in ``[0, 2**32)``.
    """
    t = torch.as_tensor(term, dtype=ID_DTYPE)
    p = torch.as_tensor(p, dtype=ID_DTYPE, device=t.device)
    mask = TERM_SPACE - 1
    low = torch.where(t >= NUM_BASE, (t ^ (t >> TERM_BITS)) & mask,
                      (t - PRED_SPACE) & mask)
    low = torch.where(t == PAD_ID, torch.zeros_like(low), low)
    return ((p << TERM_BITS) | low) & U32_MAX


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 -> int32 tensor with the same 32 bits (for kernels)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 kernel words -> int64-held uint32."""
    return x.to(ID_DTYPE) & U32_MAX


class TripleBatch(NamedTuple):
    """Struct-of-arrays batch of timestamped triples (a stream chunk).

    All arrays share shape ``[..., N]``; ``valid`` masks real rows; id
    columns are int64 holding uint32 values.
    """

    s: torch.Tensor
    p: torch.Tensor
    o: torch.Tensor
    ts: torch.Tensor
    graph: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.s.shape[-1])

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def map(self, fn) -> "TripleBatch":
        return TripleBatch(*(fn(c) for c in self))

    def to(self, device) -> "TripleBatch":
        return self.map(lambda c: c.to(device))


def make_triples(
    rows: Sequence[Tuple[int, int, int, int, int]],
    capacity: Optional[int] = None, device="cpu",
) -> TripleBatch:
    """Build a TripleBatch from host-side ``(s, p, o, ts, graph)`` rows."""
    n = len(rows)
    cap = capacity if capacity is not None else max(n, 1)
    if n > cap:
        raise ValueError("rows (%d) exceed capacity (%d)" % (n, cap))
    arr = np.zeros((cap, 5), np.int64)
    if n:
        arr[:n] = np.asarray(rows, np.uint32)
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    cols = torch.from_numpy(arr).to(device)
    return TripleBatch(cols[:, 0].contiguous(), cols[:, 1].contiguous(),
                       cols[:, 2].contiguous(), cols[:, 3].contiguous(),
                       cols[:, 4].contiguous(),
                       torch.from_numpy(valid).to(device))


def concat_triples(batches: Sequence[TripleBatch]) -> TripleBatch:
    return TripleBatch(*(torch.cat(cols, dim=-1) for cols in zip(*batches)))


def lexsort_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort`` over the last dim: the LAST key is primary.

    A chain of stable sorts from the least significant key (``keys[0]``)
    to the most significant; ties keep the original index.  Keys share a
    shape ``[..., n]``; returns the int64 permutation of the last dim.
    """
    n = keys[0].shape[-1]
    order = torch.arange(n, device=keys[0].device).expand(keys[0].shape)
    for k in keys:
        kk = torch.gather(k, -1, order)
        perm = torch.sort(kk, dim=-1, stable=True).indices
        order = torch.gather(order, -1, perm)
    return order


def sort_by_timestamp(batch: TripleBatch) -> TripleBatch:
    """Stable sort by (invalid-last, ts, graph) — the Aggregator's merge order."""
    ts_key = torch.where(batch.valid, batch.ts, torch.full_like(batch.ts, U32_MAX))
    order = lexsort_order((batch.graph, ts_key))
    return batch.map(lambda col: torch.gather(col, -1, order))


def take_rows(batch: TripleBatch, idx: torch.Tensor) -> TripleBatch:
    """Gather rows of a 1-D batch by index (any shape); -1 yields a PAD row."""
    safe = idx.clamp(min=0)
    out = batch.map(lambda col: col[safe])
    return out._replace(valid=(idx >= 0) & out.valid)


def to_host_rows(batch: TripleBatch) -> List[Tuple[int, int, int, int, int]]:
    """Debug/Publisher helper: valid rows as python tuples."""
    s, p, o, ts, g, v = (x.cpu().numpy() for x in batch)
    return [
        (int(s[i]), int(p[i]), int(o[i]), int(ts[i]), int(g[i]))
        for i in range(len(v))
        if v[i]
    ]
