"""PyTorch port vs the JAX reference: the split aggregation sink and the
pipelined runtime.

* the split sink's upstream tables, per window (``run_plan_window_tables``)
  and per chunk with slide spans (``run_plan_slide_tables``), equal the
  reference's as ``np.uint32`` bytes for the four paper queries, with the
  same publication specs;
* ``mode="pipelined"`` against the reference's ``PipelinedRuntime`` on Q15:
  the same bytes and the same channel statistics (pushes, pops and the
  depth high-water marks are host schedule facts);
* the overflow case: clipped capacities give the reference's flags and
  bytes in ``single_program`` and ``pipelined``;
* port-only schedule checks: incremental pipelined equals recompute (the
  delta split sink on Q15, the augmented fallback on CQuery1, sliding
  windows on artist_classes), manual driving keeps two chunks in flight,
  driver misuse raises, ``feed`` queues past capacity, an early-closed
  ``stream`` drains, and every placement gives the same bytes.

The whole-stream comparisons of ``pipelined`` with the reference for the
four queries are cases of ``tests/test_torch_session.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import planner as rplanner
from repro.core.stream import merge_streams as rmerge
from repro.core.window import count_slides as rcount_slides
from repro.core.window import count_windows as rcount_windows
from repro_torch.core import engine as pengine
from repro_torch.core.pipeline import PipelinedRuntime
from repro_torch.core.stream import merge_streams
from repro_torch.core.window import count_slides, count_windows

from test_torch_session import (  # noqa: F401
    CAPS, QUERIES, check_against_reference, one_torch_thread, pworld,
)

CAP, W = CAPS["window_capacity"], CAPS["max_windows"]


def u32(x) -> bytes:
    if torch.is_tensor(x):
        x = x.numpy()
    return np.asarray(x).astype(np.uint32).tobytes()


# the reference's producers, jitted once per plan (eager JAX takes ~10x
# longer on these shapes)
@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def _ref_window_tables(plan, chunk, pub_cols, rows_cap, kb, env):
    windows = rcount_windows(rmerge([chunk]), CAP, W)
    return reng.run_plan_window_tables(plan, windows, pub_cols, rows_cap,
                                       kb, env)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def _ref_slide_tables(plan, chunk, pub_cols, rows_cap, kb, env):
    view = rcount_slides(rmerge([chunk]), CAP, W)
    return reng.run_plan_slide_tables(plan, view, pub_cols, rows_cap, 1, kb,
                                      env)


def port_run(pworld, q, mode, **kw):
    """The port's (outputs, overflow) for one ``auto`` configuration, run
    once per test process and shared with the session tests."""
    return pworld.port_run(q, mode, "auto", **kw)[1:]


def _same_stream(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert all(torch.equal(u, v) for u, v in zip(x, y)), i


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("kind", ["windows", "slides"])
def test_split_sink_tables_equal_reference(pworld, q, kind):
    """Each upstream operator's table for the split sink, on every chunk:
    per window (tumbling) or one chunk-level span-tagged table (the delta
    producer; every upstream plan of the four queries is delta-safe)."""
    ref_rt = pworld.ref_registered(q, "single_program", "auto").runtime
    rt = pworld.port_registered(q, "single_program", "auto").runtime
    assert rt.sink_kind == "split" and ref_rt._split is not None
    rows = 0
    for name, spec in ref_rt._split.pub.items():
        assert dataclasses.astuple(rt._split.pub[name]) == \
            dataclasses.astuple(spec)
        ref_op, op = ref_rt.operators[name], rt.operators[name]
        assert rplanner.plan_supports_delta(ref_op.plan)
        for rc, pc in zip(pworld.chunks, pworld.port_chunks()):
            if kind == "windows":
                want, want_ovf = _ref_window_tables(
                    ref_op.plan, rc, spec.cols, spec.rows_cap, ref_op.kb,
                    ref_op.env)
                got, got_ovf = pengine.run_plan_window_tables(
                    op.plan, count_windows(merge_streams([pc]), CAP, W),
                    spec.cols, spec.rows_cap, op.kb, op.env)
            else:
                want, want_ovf = _ref_slide_tables(
                    ref_op.plan, rc, spec.cols, spec.slide_rows_cap,
                    ref_op.kb, ref_op.env)
                got, got_ovf = pengine.run_plan_slide_tables(
                    op.plan, count_slides(merge_streams([pc]), CAP, W),
                    spec.cols, spec.slide_rows_cap, 1, op.kb, op.env)
            assert got[0].shape == want[0].shape, (name, kind)
            assert u32(got[0]) == u32(want[0]), (name, kind)
            assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()
            assert got_ovf.numpy().tobytes() == np.asarray(want_ovf).tobytes()
            rows += int(got[1].sum())
    assert rows > 0


def test_pipelined_channel_stats_equal_reference(pworld):
    """Q15 through both packages' ``PipelinedRuntime``: the same bytes, and
    the same statistics on every edge."""
    ref_reg, ref_outs, ref_ovf, _ = pworld.ref_run("q15", "pipelined", "auto")
    reg, outs, ovf = pworld.port_run("q15", "pipelined", "auto")
    assert isinstance(reg.runtime, PipelinedRuntime)
    assert len(outs) == len(ref_outs)
    for ro, po in zip(ref_outs, outs):
        assert all(u32(a) == u32(b) for a, b in zip(ro, po))
    assert ovf == dict(ref_ovf)
    stats = reg.channel_stats()
    assert stats == ref_reg.channel_stats()
    assert all(st["depth_hw"] >= 2 and st["pushes"] == st["pops"]
               for st in stats.values())
    assert reg.runtime.depth_hw == ref_reg.runtime.depth_hw


@pytest.mark.parametrize("mode", ["single_program", "pipelined"])
def test_overflow_case_flags_match_reference(pworld, mode):
    """Capacities small enough to clip the upstream table (4 rows of 2
    columns): the reference's per-operator overflowed-window counts and its
    clipped streams, in both DAG modes."""
    reg, _ = check_against_reference(pworld, "q15", mode, "auto",
                                     out_cap=16, intermediate_cap=8)
    totals = reg.overflow_totals()
    assert sum(totals.values()) > 0, "intended an overflowing configuration"


@pytest.mark.parametrize("q,kind", [("q15", "split-delta"),
                                    ("cquery1", "augmented")])
def test_incremental_pipelined_equals_recompute(pworld, q, kind):
    """Q15 runs the delta split sink (span-tagged tables through the
    channels, the SlideView on the source edge); CQuery1's OPTIONAL keeps
    the augmented window."""
    inc, outs, ovf = pworld.port_run(q, "pipelined", "auto", incremental=True)
    assert inc.runtime.sink_kind == kind
    ref, ref_ovf = port_run(pworld, q, "single_program")
    _same_stream(outs, ref)
    assert ovf == ref_ovf
    assert sum(int(o.valid.sum()) for o in outs) > 0


def test_sliding_incremental_pipelined_equals_single_program(pworld):
    """artist_classes at its own ``RANGE 256 STEP 64``: four slides a
    window through the channels, delta and recompute."""
    kw = dict(window_from_query=True)
    want, want_ovf = port_run(pworld, "artist_classes", "single_program", **kw)
    for incremental in (False, True):
        reg, outs, ovf = pworld.port_run("artist_classes", "pipelined",
                                         "auto", incremental=incremental, **kw)
        assert reg.config.window_step == 64
        _same_stream(outs, want)
        assert ovf == want_ovf


def test_schedule_keeps_two_chunks_in_flight(pworld):
    """Manual drive: the sink consumes chunk t only after chunk t + 1's
    producers were dispatched."""
    want, _ = port_run(pworld, "q15", "single_program")
    rt = pworld.port_register("q15", "pipelined", "auto").runtime
    outs, most = [], 0
    for c in pworld.port_chunks():
        if rt._in_flight >= 2:
            outs.append(rt.drain())
        rt.feed(c)
        most = max(most, rt._in_flight)
    while rt._in_flight:
        outs.append(rt.drain())
    assert most == 2 and rt.depth_hw == 2
    _same_stream(outs, want)


def test_driver_misuse_raises_and_feed_queues_past_capacity(pworld):
    rt = pworld.port_register("q16", "pipelined", "auto").runtime
    chunks = pworld.port_chunks()
    cap = rt.channel_capacity
    with pytest.raises(RuntimeError, match="feed"):
        rt.drain()
    # feed never raises on a full pipeline: chunks past the channel
    # capacity wait in the host-side source queue
    for _ in range(cap + 2):
        rt.feed(chunks[0])
    assert rt._in_flight == cap and len(rt._src_q) == 2
    with pytest.raises(RuntimeError, match="in flight"):
        rt.process_stream(chunks)
    with pytest.raises(RuntimeError, match="in flight"):
        rt.process_chunk(chunks[1])
    rt.drain()
    # draining freed a slot; the queue backfills it in the same call
    assert rt._in_flight == cap and len(rt._src_q) == 1
    while rt._pending_count():
        rt.drain()
    assert all(st["size"] == 0 and st["overflows"] == 0
               and st["pushes"] == st["pops"] == cap + 2
               for st in rt.channel_stats().values())


def test_pipeline_requires_double_buffering(pworld):
    with pytest.raises(ValueError, match="channel_capacity"):
        pworld.port_register("q15", "pipelined", "auto", channel_capacity=1)


def test_stream_generator_drains_when_closed_early(pworld):
    reg = pworld.port_register("q15", "pipelined", "auto")
    want, _ = port_run(pworld, "q15", "single_program")
    gen = reg.stream(pworld.port_chunks())
    first = next(gen)
    gen.close()
    assert reg.runtime._pending_count() == 0
    assert all(torch.equal(a, b) for a, b in zip(first, want[0]))
    _same_stream(list(reg.stream(pworld.port_chunks())), want)
    out, ovf = reg.process_chunk(pworld.port_chunks()[1])
    assert all(torch.equal(a, b) for a, b in zip(out, want[1]))
    assert set(ovf) == set(reg.operators)


@pytest.mark.parametrize("placement", ["single", None, "dict"])
def test_every_placement_gives_the_same_bytes(pworld, placement):
    """A strategy name, no placement (as "single"), and an explicit
    per-operator dict of CPU devices: the stream of single_program (which
    the default round robin gives too, above), every operator placed."""
    want, _ = port_run(pworld, "q15", "single_program")
    if placement == "dict":
        placement = {"q15_kb0_ent": "cpu", "q15_agg": torch.device("cpu")}
    reg, outs, _ = pworld.port_run("q15", "pipelined", "auto",
                                   placement=placement)
    assert reg.runtime.placement == {n: torch.device("cpu")
                                     for n in reg.operators}
    _same_stream(outs, want)
