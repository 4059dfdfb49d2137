"""Capacity-bounded device channels: the inter-operator transport.

The paper wires SCEP operators together with Kafka topics: bounded queues
of RDF events between independently scheduled processes.  Here a channel is
a **ring buffer of preallocated payload slots in the consumer's device
memory**.  A push copies the payload into the next free slot (``copy_``, so
the steady path allocates nothing; from another device that copy is the
transport); a pop hands out the oldest slot.

A :class:`Channel` carries any fixed-shape payload tree (tensors inside
tuples, named tuples, lists and dicts).  In the DSCEP pipeline the payloads
are window-aligned batches: :class:`~repro_torch.core.window.Windows` (or a
:class:`~repro_torch.core.window.SlideView`) on the source -> aggregator
edge, and ``(publication, overflow[W])`` on operator -> aggregator edges.

Semantics (the reference's, pinned by ``tests/test_torch_channel.py``):

* ``push`` into a **full** channel drops the *new* payload and counts it in
  ``overflows``: bounded-queue backpressure is observable, never silent.
* ``pop`` from an **empty** channel returns the zero payload with
  ``valid=False`` and leaves the state untouched.
* FIFO order holds through the ring's wraparound.

``head``, ``size`` and ``overflows`` are host ints.  The reference keeps
them as device scalars because its push and pop run inside jitted programs,
but its driver schedules on host-side edge counters only.  Eagerly, a
device-side ``full`` test would cost a host sync per push (or a ``where``
over the whole slot), so the ring's bookkeeping stays on the host and only
the payloads live on the device.

A popped payload is a *view* of its slot: it stays valid until a push
writes that slot again, which happens only after ``capacity`` further
pushes.  The consumer enqueues its reads of the payload first, and work on
one device runs in the order it was enqueued, so a later push cannot
overtake them.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leaf by leaf over payload trees of one structure:
    tensors inside tuples, named tuples, lists and dicts (``None`` is an
    empty subtree)."""
    t = trees[0]
    if torch.is_tensor(t):
        return fn(*trees)
    if t is None:
        return None
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    raise TypeError("unsupported payload node %r" % type(t).__name__)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a payload tree, in :func:`tree_map` order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


class Channel(NamedTuple):
    """A bounded ring buffer over a payload tree.

    ``slots`` holds ``capacity`` payloads stacked on a new leading axis;
    ``head`` indexes the oldest element; ``size`` is the occupancy.
    """

    slots: Any        # payload tree; every leaf is [capacity, ...]
    head: int         # ring index of the oldest element
    size: int         # occupancy in [0, capacity]
    overflows: int    # pushes dropped because the channel was full

    @property
    def capacity(self) -> int:
        return int(tree_leaves(self.slots)[0].shape[0])


def make_channel(payload_example: Any, capacity: int, device=None) -> Channel:
    """Allocate an empty channel shaped to hold ``capacity`` payloads.

    ``payload_example`` fixes the per-slot shapes and dtypes (its values are
    not stored); the slots live on ``device`` (default: each leaf's) and
    start zeroed.
    """
    if capacity < 1:
        raise ValueError("channel capacity must be >= 1, got %d" % capacity)
    slots = tree_map(
        lambda leaf: torch.zeros((capacity,) + tuple(leaf.shape),
                                 dtype=leaf.dtype,
                                 device=device if device is not None
                                 else leaf.device),
        payload_example)
    return Channel(slots=slots, head=0, size=0, overflows=0)


def push(ch: Channel, payload: Any) -> Channel:
    """Enqueue ``payload`` (copied into the tail slot); a full channel
    drops it and counts the overflow."""
    cap = ch.capacity
    if ch.size >= cap:
        return ch._replace(overflows=ch.overflows + 1)
    tail = (ch.head + ch.size) % cap
    tree_map(lambda buf, x: buf[tail].copy_(x, non_blocking=True),
             ch.slots, payload)
    return ch._replace(size=ch.size + 1)


def pop(ch: Channel) -> Tuple[Channel, Any, bool]:
    """Dequeue the oldest payload; returns ``(channel', payload, valid)``.

    An empty channel is left unchanged and yields the zero payload with
    ``valid=False``.
    """
    if ch.size <= 0:
        return ch, tree_map(lambda buf: torch.zeros_like(buf[0]),
                            ch.slots), False
    payload = tree_map(lambda buf: buf[ch.head], ch.slots)
    return (ch._replace(head=(ch.head + 1) % ch.capacity, size=ch.size - 1),
            payload, True)


def occupancy(ch: Channel) -> int:
    """Current number of queued payloads."""
    return ch.size


def snapshot(ch: Channel) -> Channel:
    """Deep host copy of a channel's ring (a checkpoint ingredient).

    ``push`` rewrites slots in place and a popped payload is a view of its
    slot, so a checkpoint must never hold the device slots: the ring is
    copied to the host (the copy waits for the writes enqueued before it,
    a consistent cut) with ``head``, ``size`` and ``overflows``."""
    return ch._replace(slots=tree_map(lambda t: t.to("cpu", copy=True),
                                      ch.slots))


def restore(snap: Channel, device) -> Channel:
    """A :func:`snapshot` back in slots of its own on ``device`` (the
    consumer's): the snapshot is never written, so it can be restored
    again."""
    return snap._replace(slots=tree_map(lambda t: t.to(device, copy=True),
                                        snap.slots))
