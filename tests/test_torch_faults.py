"""PyTorch port vs the JAX reference: fault injection, checkpoint/restart
and graceful degradation in the pipelined runtime.

Held to the reference on the shared 36-tweet world
(``test_torch_session._world``): the seeded fault schedules, the ingest
gate's reasons, the chaos stream's bytes and overflow, and every recovery
counter (``checkpoint_bytes`` against the port's own ``tree_bytes``: its
ids are int64 where the reference's are uint32).  The port's own pins: a
stalled schedule names its edge, ``ExecutionConfig`` validates the knobs,
and with the chaos machinery on but no event firing every stage runs the
same torch ops as without it.
"""
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.faults import FaultEvent as RFaultEvent
from repro.core.faults import FaultPlan as RFaultPlan
from repro.core.faults import corrupt_batch as rcorrupt_batch
from repro.core.faults import validate_chunk as rvalidate_chunk
from repro.core.recovery import RecoveryConfig as RRecoveryConfig
from repro_torch.core import channel as chmod
from repro_torch.core import pipeline as ppipeline
from repro_torch.core.faults import (
    FAULT_KINDS, FaultEvent, FaultInjector, FaultPlan, corrupt_batch,
    validate_chunk,
)
from repro_torch.core.pipeline import PipelineStalledError as ReExported
from repro_torch.core.recovery import (
    ChunkRejectedError, PipelineStalledError, RecoveryConfig,
    empty_recovery_stats, tree_bytes,
)
from repro_torch.core.session import ExecutionConfig
from repro_torch.obs.report import format_recovery_table

from test_torch_session import (  # noqa: F401
    _bytes, _world, one_torch_thread, pworld,
)

CHAOS_QUERIES = ("q15", "cquery1")


def _schedule(pworld, q):
    """Events over all five kinds, placed as the reference's chaos test
    places them on this DAG."""
    dag = pworld.port_registered(q, "single_program", "auto").dag
    up = [n for n in dag.subqueries if n != dag.final]
    return (("corrupt_chunk", "ingest", 0), ("stall_stage", dag.final, 0),
            ("drop_payload", up[0] if up else "source", 1),
            ("crash_stage", "source", 2), ("duplicate_payload", "source", 2))


def _knobs(events, **recovery):
    port = dict(faults=FaultPlan(tuple(FaultEvent(*e) for e in events)),
                recovery=RecoveryConfig(**recovery))
    ref = dict(faults=RFaultPlan(tuple(RFaultEvent(*e) for e in events)),
               recovery=RRecoveryConfig(**recovery))
    return port, ref


def _chaos_runs(q, events, **recovery):
    """The port's and the reference's pipelined runs of ``q`` under the
    same fault schedule: ``(registration, outputs, overflow)`` of each."""
    return _chaos_cached(q, events, tuple(sorted(recovery.items())))


@functools.lru_cache(maxsize=None)
def _chaos_cached(q, events, recovery):
    pworld = _world()
    port_kw, ref_kw = _knobs(events, **dict(recovery))
    reg = pworld.port_register(q, "pipelined", "auto", **port_kw)
    outs, ovf = reg.run(pworld.port_chunks())
    ref = pworld.ref_register(q, "pipelined", "auto", **ref_kw)
    routs, rovf = ref.run(pworld.chunks)
    return reg, outs, ovf, ref, routs, rovf


@pytest.fixture(scope="module", params=CHAOS_QUERIES)
def chaos(request, pworld):
    """One pipelined run under a plan over all five fault kinds
    (checkpoint every 2 emitted chunks), in both packages."""
    return _chaos_runs(request.param, _schedule(pworld, request.param),
                       checkpoint_every=2)


def _assert_same_stream(outs, ref_outs):
    assert len(outs) == len(ref_outs)
    for po, ro in zip(outs, ref_outs):
        for pc, rc in zip(po, ro):
            assert _bytes(pc) == _bytes(rc)


# --------------------------------------------------------------------------
# the plan / injector / validator layer (host only)
# --------------------------------------------------------------------------

def test_fault_plan_seeded_is_deterministic():
    a = FaultPlan.seeded(7, ("source", "opA"), num_chunks=5, n_events=6)
    b = FaultPlan.seeded(7, ("source", "opA"), num_chunks=5, n_events=6)
    c = FaultPlan.seeded(8, ("source", "opA"), num_chunks=5, n_events=6)
    assert a == b and a.events == b.events
    assert a != c
    assert sum(a.counts().values()) == 6
    for ev in a.events:
        assert ev.kind in FAULT_KINDS
        assert 0 <= ev.chunk < 5
        if ev.kind == "corrupt_chunk":
            assert ev.stage == "ingest"
        else:
            assert ev.stage in ("source", "opA")


@pytest.mark.parametrize("seed", range(5))
def test_fault_plan_seeded_draws_the_references_events(seed):
    stages = ("source", "q_kb0", "q_agg")
    got = FaultPlan.seeded(seed, stages, num_chunks=7, n_events=9)
    want = RFaultPlan.seeded(seed, stages, num_chunks=7, n_events=9)
    assert [(e.kind, e.stage, e.chunk) for e in got.events] == [
        (e.kind, e.stage, e.chunk) for e in want.events]
    assert got.counts() == want.counts()


def test_fault_event_validation():
    with pytest.raises(ValueError):
        FaultEvent("explode", "source", 0)
    with pytest.raises(ValueError):
        FaultEvent("crash_stage", "source", -1)
    with pytest.raises(ValueError):
        FaultPlan.seeded(0, ("source",), num_chunks=0)


def test_fault_injector_fires_each_event_once():
    plan = FaultPlan((FaultEvent("crash_stage", "s", 1),
                      FaultEvent("corrupt_chunk", "ingest", 2)))
    inj = FaultInjector(plan)
    assert not inj.take("crash_stage", "s", 0)      # wrong chunk
    assert not inj.take("crash_stage", "t", 1)      # wrong stage
    assert inj.take("crash_stage", "s", 1)
    assert not inj.take("crash_stage", "s", 1)      # fires once
    # corrupt_chunk matches whatever stage the caller names
    assert inj.take("corrupt_chunk", "whatever", 2)
    assert inj.pending() == 0
    assert inj.fired == {"crash_stage": 1, "corrupt_chunk": 1,
                         "drop_payload": 0, "duplicate_payload": 0,
                         "stall_stage": 0}
    assert inj.fired_total() == 2


def test_validate_chunk_and_corrupt_batch(pworld):
    vocab = pworld.port_vocab()
    chunk = pworld.port_chunks()[0]
    assert validate_chunk(chunk, vocab) == []
    bad = corrupt_batch(chunk)
    assert torch.equal(chunk.s, pworld.port_chunks()[0].s)   # pure
    reasons = validate_chunk(bad, vocab)
    assert any("predicate" in r for r in reasons)
    assert any("row-node" in r for r in reasons)
    assert validate_chunk(bad) != []
    intmask = chunk._replace(valid=chunk.valid.to(torch.int32))
    assert validate_chunk(intmask, vocab) == [
        "valid mask must be boolean, got dtype int32"]
    assert validate_chunk(chunk, vocab, max_graph_size=1) != []


def test_validate_chunk_gives_the_references_reasons(pworld):
    """The same batches, scribbled the same way, give the reference's
    reasons, with and without a vocab and a graph-size cap."""
    vocab = pworld.port_vocab()
    for chunk, rchunk in zip(pworld.port_chunks(), pworld.chunks):
        bad, rbad = corrupt_batch(chunk), rcorrupt_batch(rchunk)
        for b in range(6):
            assert _bytes(bad[b]) == _bytes(rbad[b])
        for v, rv in ((vocab, pworld.vocab), (None, None)):
            for cap in (None, 1, 64):
                for x, rx in ((chunk, rchunk), (bad, rbad)):
                    assert validate_chunk(x, v, cap) == rvalidate_chunk(
                        rx, rv, cap)


def test_channel_snapshot_restore_roundtrip():
    ch = chmod.make_channel({"x": torch.zeros(4, dtype=torch.int32)}, 3)
    ch = chmod.push(ch, {"x": torch.arange(4, dtype=torch.int32)})
    snap = chmod.snapshot(ch)
    assert snap.slots["x"].device.type == "cpu"
    assert snap.slots["x"].data_ptr() != ch.slots["x"].data_ptr()
    restored = chmod.restore(snap, "cpu")
    # a push into the restored ring never reaches the snapshot, which can
    # be restored again
    restored = chmod.push(restored, {"x": torch.full((4,), 9,
                                                     dtype=torch.int32)})
    assert int(snap.slots["x"][1].sum()) == 0
    restored, payload, ok = chmod.pop(restored)
    assert ok and torch.equal(payload["x"], torch.arange(4, dtype=torch.int32))
    assert restored.size == 1 and snap.size == 1


# --------------------------------------------------------------------------
# chaos: every fault kind, recovered bit-exact, counted as the reference
# --------------------------------------------------------------------------

def test_chaos_all_kinds_recover_bit_exact(pworld, chaos):
    reg, outs, ovf, _, routs, rovf = chaos
    _assert_same_stream(outs, routs)
    assert ovf == dict(rovf)
    # and the fault-free single_program run's bytes
    _, ref_outs, ref_ovf, _ = pworld.ref_run(reg.query.name, "single_program",
                                             "auto")
    _assert_same_stream(outs, ref_outs)
    assert ovf == dict(ref_ovf)


def test_chaos_recovery_counters_equal_reference(chaos):
    reg, _, _, ref, _, _ = chaos
    got, want = reg.last_stats, ref.last_stats
    rec, rrec = got["recovery"], want["recovery"]
    ck = reg.runtime._ckpt
    assert rec["checkpoint_bytes"] == tree_bytes(
        [ck.win_ch.slots, [c.slots for c in ck.out_ch.values()],
         ck.envs]) > 0
    assert {k: v for k, v in rec.items() if k != "checkpoint_bytes"} == {
        k: v for k, v in rrec.items() if k != "checkpoint_bytes"}
    for key in ("channels", "overflow_totals", "degraded"):
        assert got[key] == want[key], key


def test_chaos_exercises_every_scheduled_event(chaos):
    reg = chaos[0]
    rec = reg.last_stats["recovery"]
    assert rec["enabled"]
    assert rec["injected"] == reg.runtime._injector.plan.counts() == \
        rec["scheduled"], "every scheduled fault must fire exactly once"
    assert rec["retries"] >= 1          # the injected stall was retried
    assert rec["restarts"] >= 2         # the crash and a desync restore
    assert rec["replayed"] >= 1
    assert rec["checkpoints"] >= 2      # initial + cadence/boundary
    assert rec["corrupt_recovered"] == 1
    assert rec["degraded_chunks"] == []
    assert reg.last_stats["degraded"] is False


def test_chaos_leaves_channels_drained(chaos):
    for edge, st in chaos[0].runtime.channel_stats().items():
        assert st["size"] == 0, edge
        assert st["overflows"] == 0, edge
        assert st["pushes"] >= st["pops"], edge


def test_recovery_table_renders(chaos):
    txt = format_recovery_table(chaos[0].last_stats["recovery"])
    assert "injected:crash_stage" in txt
    assert "restarts" in txt and "deduped" in txt
    assert "degraded_chunks" in format_recovery_table(empty_recovery_stats())


def test_resilient_runtime_rejects_malformed_ingest(pworld):
    rt = pworld.port_register("q15", "pipelined", "auto",
                              recovery=RecoveryConfig()).runtime
    with pytest.raises(ChunkRejectedError) as ei:
        rt.feed(corrupt_batch(pworld.port_chunks()[0]))
    assert ei.value.reasons
    assert rt.recovery_stats()["rejected"] == 1
    assert rt._pending_count() == 0, "a rejected chunk must leave no state"
    assert rt._ckpt is None and rt._next_seq == 0


def test_degraded_chunk_takes_lossless_fallback(pworld):
    """``max_restarts=0``: the first fault blamed on a chunk degrades it;
    the channel-free fallback still publishes the fault-free bytes, and
    every counter equals the reference's."""
    reg, outs, ovf, ref, routs, rovf = _chaos_runs(
        "q15", (("crash_stage", "source", 1),), checkpoint_every=0,
        max_restarts=0)
    _assert_same_stream(outs, routs)
    assert ovf == dict(rovf)
    st = reg.last_stats
    assert st["degraded"] is True
    rec = st["recovery"]
    assert rec["degraded_chunks"] == [1]
    assert rec["restarts"] >= 1
    assert rec["injected"]["crash_stage"] == 1
    rrec = ref.last_stats["recovery"]
    assert {k: v for k, v in rec.items() if k != "checkpoint_bytes"} == {
        k: v for k, v in rrec.items() if k != "checkpoint_bytes"}


def test_a_duplicate_filling_an_operator_edge_is_a_desync(pworld):
    """``channel_capacity=2``, Q15's upstream payload of chunk 0 delivered
    twice: the duplicate fills the operator's edge, so its next payload
    waits in its dispatch queue.  The port's pre-pop audit counts that
    payload, sees the desync and restores, with the fault-free bytes; the
    reference's audit counts the edge alone and then fails its sink's
    lagging-queue assertion (a reference-side limit, ``ROADMAP.md`` queue
    3)."""
    dag = pworld.port_registered("q15", "single_program", "auto").dag
    up = next(n for n in dag.subqueries if n != dag.final)
    events = (("duplicate_payload", up, 0),)
    port_kw, ref_kw = _knobs(events, checkpoint_every=2)
    ref = pworld.ref_register("q15", "pipelined", "auto", channel_capacity=2,
                              **ref_kw)
    with pytest.raises(AssertionError, match="dispatch queues lag"):
        ref.run(pworld.chunks)
    reg = pworld.port_register("q15", "pipelined", "auto", channel_capacity=2,
                               **port_kw)
    outs, ovf = reg.run(pworld.port_chunks())
    _, want, want_ovf, _ = pworld.ref_run("q15", "single_program", "auto")
    _assert_same_stream(outs, want)
    assert ovf == dict(want_ovf)
    rec = reg.last_stats["recovery"]
    assert rec["injected"]["duplicate_payload"] == 1 and rec["restarts"] == 1


@pytest.mark.parametrize("q", CHAOS_QUERIES)
def test_operator_state_roundtrip(pworld, q):
    ops = pworld.port_registered(q, "pipelined", "auto").runtime.operators
    assert any(op.env for op in ops.values())
    for op in ops.values():
        snap = op.state()
        before = {k: v.clone() for k, v in op.env.items()}
        for k, v in snap.items():
            assert v.device.type == "cpu"
            assert v.data_ptr() != op.env[k].data_ptr()
        op.restore_state(snap, "cpu")
        assert sorted(op.env) == sorted(before)
        assert all(torch.equal(op.env[k], before[k]) for k in before)


# --------------------------------------------------------------------------
# zero overhead: the chaos machinery adds no op to any stage
# --------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched while active."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _stage_ops(pworld, monkeypatch, q, **kw):
    """The aten ops each stage function dispatches over a whole-stream
    pipelined run: ``{(stage, call index): [op names]}``."""
    reg = pworld.port_register(q, "pipelined", "auto", **kw)
    seen, calls = {}, {}
    for fn in ("source_stage", "upstream_stage", "sink_stage"):
        real = getattr(ppipeline, fn)

        def wrapped(*a, _fn=fn, _real=real, **k):
            key = (_fn, a[1] if _fn == "upstream_stage" else "")
            calls[key] = calls.get(key, 0) + 1
            with _Ops() as rec:
                res = _real(*a, **k)
            seen[key + (calls[key],)] = rec.names
            return res

        monkeypatch.setattr(ppipeline, fn, wrapped)
    reg.run(pworld.port_chunks())
    monkeypatch.undo()
    return seen


def test_fault_machinery_adds_no_op_to_any_stage(pworld, monkeypatch):
    """A schedule whose events never fire (their chunk never comes), with
    checkpoints and the ingest gate on: every stage call dispatches the
    same aten ops, in the same order, as the fault-free runtime's."""
    plain = _stage_ops(pworld, monkeypatch, "cquery1")
    never = FaultPlan((FaultEvent("crash_stage", "source", 99),
                       FaultEvent("drop_payload", "source", 99)))
    chaotic = _stage_ops(pworld, monkeypatch, "cquery1", faults=never,
                         recovery=RecoveryConfig(checkpoint_every=1))
    stages = len(pworld.port_registered("cquery1", "single_program",
                                        "auto").operators) + 1
    assert len(plain) == stages * len(pworld.chunks)
    assert all(plain.values())
    assert plain == chaotic


# --------------------------------------------------------------------------
# the stall watchdog, config validation, the inert surfaces
# --------------------------------------------------------------------------

def test_stalled_pipeline_raises_diagnostic_not_spin(pworld):
    """A wedged edge surfaces as PipelineStalledError naming the edge."""
    assert ReExported is PipelineStalledError
    rt = pworld.port_register("q15", "pipelined", "auto").runtime
    edge = "source->%s" % rt.final
    # wedge the source edge: the ledger says it is full, so _pump cannot
    # window the fed chunk and nothing enters flight
    rt._edge_stats[edge]["pushes"] += rt.channel_capacity
    rt.feed(pworld.port_chunks()[0])
    assert rt._in_flight == 0 and len(rt._src_q) == 1
    with pytest.raises(PipelineStalledError) as ei:
        rt.drain()
    assert edge in str(ei.value)
    idle = pworld.port_register("q15", "pipelined", "auto").runtime
    with pytest.raises(RuntimeError, match="feed"):
        idle.drain()


def test_config_rejects_faults_outside_pipelined():
    plan = FaultPlan((FaultEvent("crash_stage", "source", 0),))
    with pytest.raises(ValueError, match="pipelined"):
        ExecutionConfig(device="cpu", mode="monolithic", faults=plan)
    with pytest.raises(ValueError, match="pipelined"):
        ExecutionConfig(device="cpu", mode="single_program",
                        recovery=RecoveryConfig())
    with pytest.raises(TypeError):
        ExecutionConfig(device="cpu", mode="pipelined", faults="not a plan")
    with pytest.raises(TypeError):
        ExecutionConfig(device="cpu", mode="pipelined",
                        recovery="not a config")
    with pytest.raises(ValueError):
        RecoveryConfig(checkpoint_every=-1)
    with pytest.raises(ValueError):
        RecoveryConfig(stage_timeout_s=0.0)


def test_nonpipelined_modes_report_inert_recovery_surface(pworld):
    for mode in ("monolithic", "single_program"):
        st = pworld.port_run("q15", mode, "auto")[0].last_stats
        assert st["recovery"] == empty_recovery_stats(enabled=False)
        assert st["degraded"] is False


def test_a_fault_plan_alone_implies_the_default_ladder(pworld):
    plan = FaultPlan((FaultEvent("crash_stage", "source", 99),))
    rt = pworld.port_registered("q15", "pipelined", "auto",
                                faults=plan).runtime
    assert rt._rcfg == RecoveryConfig()
    assert rt.recovery_stats()["enabled"] is True
    assert rt.recovery_stats()["scheduled"]["crash_stage"] == 1
