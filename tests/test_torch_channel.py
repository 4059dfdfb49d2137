"""The port's inter-operator channels and operator placement.

Channel semantics as ``tests/test_channel.py`` pins them for the
reference: round trip, drop-new overflow, empty pop, FIFO through the
ring's wraparound (capacity 2 and 4, with overflow between), and a
positive capacity.  The port keeps the ring's bookkeeping as host ints and
the payloads in preallocated slots; these cases also check that a push
copies into a slot and allocates nothing.  Then ``place_operators``'s two
strategies on CPU devices.  Pure torch, no reference run.
"""
import pytest
import torch

from repro_torch.core import channel
from repro_torch.core.rdf import TripleBatch
from repro_torch.core.window import Windows
from repro_torch.launch.mesh import place_operators


def _payload(x: float):
    """A small payload tree: a vector leaf and a scalar leaf."""
    return {"vec": torch.full((4,), x, dtype=torch.float32),
            "n": torch.tensor(int(x), dtype=torch.int64)}


def test_push_pop_roundtrip():
    ch = channel.make_channel(_payload(0.0), capacity=3)
    assert ch.capacity == 3
    for i in (1, 2):
        ch = channel.push(ch, _payload(float(i)))
    assert channel.occupancy(ch) == 2
    ch, got, ok = channel.pop(ch)
    assert ok and int(got["n"]) == 1
    assert torch.equal(got["vec"], torch.full((4,), 1.0))
    ch, got, ok = channel.pop(ch)
    assert ok and int(got["n"]) == 2
    assert channel.occupancy(ch) == 0 and ch.overflows == 0


def test_overflow_drops_new_payload_and_counts():
    ch = channel.make_channel(_payload(0.0), capacity=2)
    for i in (1, 2, 3, 4):        # 3 and 4 are dropped, 1 and 2 kept
        ch = channel.push(ch, _payload(float(i)))
    assert ch.size == 2 and ch.overflows == 2
    ch, got, ok = channel.pop(ch)
    assert ok and int(got["n"]) == 1
    ch, got, ok = channel.pop(ch)
    assert ok and int(got["n"]) == 2


def test_pop_empty_is_invalid_zero_and_state_stable():
    ch = channel.make_channel(_payload(0.0), capacity=2)
    ch = channel.push(ch, _payload(5.0))
    ch, _, _ = channel.pop(ch)          # slot 0 now holds 5, the ring empty
    before = ch
    ch, got, ok = channel.pop(ch)
    assert not ok
    assert int(got["n"]) == 0 and torch.equal(got["vec"], torch.zeros(4))
    assert ch == before and ch.size == 0 and ch.head == 1
    # a push after an empty pop still lands in slot order
    ch = channel.push(ch, _payload(7.0))
    ch, got, ok = channel.pop(ch)
    assert ok and int(got["n"]) == 7


def test_fifo_through_ring_wraparound():
    ch = channel.make_channel(_payload(0.0), capacity=2)
    seen = []
    for nxt in range(1, 6):        # 5 push/pop cycles: the head wraps
        ch = channel.push(ch, _payload(float(nxt)))
        ch, got, ok = channel.pop(ch)
        assert ok
        seen.append(int(got["n"]))
    assert seen == [1, 2, 3, 4, 5] and ch.overflows == 0


def test_wraparound_at_capacity_four_with_interleaved_overflow():
    """Fill to 4, drop a 5th, drain two, refill across the wrap point, drop
    again, drain: FIFO order and drop-new hold in every phase, and a push
    into a full ring leaves the four stored payloads intact."""
    ch = channel.make_channel(_payload(0.0), capacity=4)
    slots = [t.data_ptr() for t in channel.tree_leaves(ch.slots)]
    for i in (1, 2, 3, 4):
        ch = channel.push(ch, _payload(float(i)))
    assert ch.size == 4
    ch = channel.push(ch, _payload(99.0))      # full: dropped, counted
    assert ch.size == 4 and ch.overflows == 1
    assert ch.slots["n"].tolist() == [1, 2, 3, 4]
    seen = []
    for _ in range(2):                         # head moves to slot 2
        ch, got, ok = channel.pop(ch)
        assert ok
        seen.append(int(got["n"]))
    for i in (5, 6):                           # the tail wraps to slots 0, 1
        ch = channel.push(ch, _payload(float(i)))
    assert ch.size == 4
    ch = channel.push(ch, _payload(98.0))      # full again past the wrap
    assert ch.overflows == 2
    while ch.size:
        ch, got, ok = channel.pop(ch)
        assert ok
        seen.append(int(got["n"]))
    assert seen == [1, 2, 3, 4, 5, 6], "dropped payloads leaked in or FIFO broke"
    # every push copied into the preallocated slots
    assert [t.data_ptr() for t in channel.tree_leaves(ch.slots)] == slots


def test_capacity_must_be_positive():
    with pytest.raises(ValueError):
        channel.make_channel(_payload(0.0), capacity=0)
    ch = channel.make_channel(_payload(0.0), capacity=1)
    ch = channel.push(channel.push(ch, _payload(1.0)), _payload(2.0))
    assert ch.size == 1 and ch.overflows == 1


def test_named_tuple_payloads_keep_their_types():
    """Windows of TripleBatch leaves (the source edge's payload) come back
    as the same named tuples, zeroed on an empty pop."""
    tb = TripleBatch(*(torch.arange(6).view(2, 3) + k for k in range(5)),
                     torch.ones((2, 3), dtype=torch.bool))
    win = Windows(tb, torch.tensor([True, False]))
    ch = channel.make_channel(win, capacity=2)
    ch, got, ok = channel.pop(channel.push(ch, win))
    assert ok and isinstance(got, Windows) and isinstance(got.triples,
                                                          TripleBatch)
    assert all(torch.equal(a, b) for a, b in zip(channel.tree_leaves(got),
                                                 channel.tree_leaves(win)))
    _, empty, ok = channel.pop(ch)
    assert not ok and not bool(empty.triples.valid.any())


def test_place_operators_policies():
    names = ["a_kb0", "b_kb1", "agg"]
    devs = [torch.device("cpu")] * 3
    single = place_operators(names, "agg", devices=devs[:1], strategy="single")
    assert single == {n: torch.device("cpu") for n in names}
    rr = place_operators(names, "agg", devices=devs)
    assert set(rr) == set(names) and rr["agg"] == devs[0]
    # one device: round robin falls back to it for every operator
    assert place_operators(names, "agg", devices=["cpu"]) == single
    with pytest.raises(ValueError, match="strategy"):
        place_operators(names, "agg", devices=devs, strategy="random")
    with pytest.raises(ValueError, match="final"):
        place_operators(names, "nope", devices=devs)
    with pytest.raises(ValueError, match="no devices"):
        place_operators(names, "agg", devices=[])


def test_round_robin_cycles_upstreams_over_the_other_devices():
    """The sink is pinned to the first device; upstream operators cycle
    over the rest (placement is data: plain device handles suffice)."""
    devs = ["cpu:0", "cpu:1", "cpu:2"]
    rr = place_operators(["u0", "u1", "u2", "sink"], "sink", devices=devs)
    assert rr == {"sink": torch.device("cpu:0"), "u0": torch.device("cpu:1"),
                  "u1": torch.device("cpu:2"), "u2": torch.device("cpu:1")}
