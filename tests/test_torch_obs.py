"""PyTorch port vs the JAX reference: observability.

Tracer, metric and report units of ``repro_torch.obs``, and the uniform
surfaces of the three runtimes held to the reference on the shared
36-tweet world (``test_torch_session._world``): ``last_stats``'s
per-operator counters, caps and saturation, its overflow totals, channels,
recovery surface and ``degraded``, the set of span paths, and
``explain()``.  The port's own pins: traced runs give the untraced bytes,
and with tracing off no function of ``repro_torch.obs``,
``repro_torch.core.faults`` or ``repro_torch.core.recovery`` runs.
"""
import inspect
import json
import math
import sys
import time

import numpy as np
import pytest
import torch

from repro.obs.metrics import reduce_stats as rreduce_stats
from repro_torch.core import faults as pfaults
from repro_torch.core import recovery as precovery
from repro_torch.core.rdf import to_host_rows
from repro_torch.core.session import MODES
from repro_torch.obs import metrics as pmetrics
from repro_torch.obs import report as preport
from repro_torch.obs import trace as ptrace
from repro_torch.obs.metrics import (
    finalize_stats, merge_stats, reduce_stats, saturation, stat_add, stat_max,
)
from repro_torch.obs.report import (
    attach_saturation, bottleneck_stage, format_explain, format_metrics_table,
    format_stage_table, to_json,
)
from repro_torch.obs.trace import TraceConfig, Tracer, resolve_trace, span_or_null

from test_torch_session import CAPS, QUERIES, one_torch_thread, pworld  # noqa: F401

def _run(pworld, q, mode, **kw):
    """The port's cached whole-stream run of a configuration."""
    return pworld.port_run(q, mode, "auto", **kw)


def _ref_run(pworld, q, mode, **kw):
    return pworld.ref_run(q, mode, "auto", **kw)


def _same_bytes(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        for ca, cb in zip(a, b):
            assert torch.equal(ca, cb)


# --------------------------------------------------------------------------
# tracer units: nesting, first/steady split, config resolution
# --------------------------------------------------------------------------

def test_span_nesting_builds_paths():
    tr = Tracer(TraceConfig(fence=False))
    with tr.span("chunk"):
        with tr.span("stage:a"):
            pass
        with tr.span("stage:b"):
            with tr.span("probe"):
                pass
    with tr.span("chunk"):
        with tr.span("stage:a"):
            pass
    stats = tr.stats()
    assert set(stats) == {"chunk", "chunk/stage:a", "chunk/stage:b",
                          "chunk/stage:b/probe"}
    assert stats["chunk"]["count"] == 2
    assert stats["chunk/stage:a"]["count"] == 2
    assert stats["chunk/stage:b"]["count"] == 1


def test_first_sample_separated_from_steady():
    tr = Tracer(TraceConfig(fence=False))
    for _ in range(4):
        with tr.span("step"):
            time.sleep(0.001)
    s = tr.stats()["step"]
    assert s["count"] == 4
    assert s["steady"]["count"] == 3
    # the first sample never enters the steady totals
    assert s["steady"]["total_s"] == pytest.approx(s["steady"]["mean_s"] * 3)
    assert s["first_s"] > 0.0
    tr.reset()
    assert tr.stats() == {}


def test_span_fence_passes_values_through_and_needs_no_card_for_cpu():
    """A fence returns its value; CPU tensors record no event (they are
    ready when the call returns), so this runs without a card."""
    tr = Tracer(TraceConfig())
    x = torch.arange(8)
    with tr.span("step") as sp:
        out = sp.fence({"y": (x * 2, None), "n": 3})
    assert torch.equal(out["y"][0], x * 2)
    assert ptrace.record_events(out) == []
    assert tr.stats()["step"]["count"] == 1


def test_resolve_trace_normalization():
    assert resolve_trace(None) is None
    assert resolve_trace(False) is None
    assert resolve_trace(True) == TraceConfig()
    cfg = TraceConfig(spans=False, metrics=True)
    assert resolve_trace(cfg) is cfg
    with pytest.raises(TypeError):
        resolve_trace("yes")


def test_spans_off_and_null_span_are_noop():
    tr = Tracer(TraceConfig(spans=False))
    with tr.span("ignored") as sp:
        assert sp.fence(123) == 123
    assert tr.stats() == {}
    with span_or_null(None, "also-ignored") as sp:
        assert sp.fence("v") == "v"


def test_annotations_and_profiler_export(tmp_path):
    """``annotations=True`` names every span on the profiler's timeline,
    and ``profiler_dir`` exports a Chrome trace holding them."""
    tr = Tracer(TraceConfig(annotations=True, profiler_dir=str(tmp_path)))
    assert tr.start_profiler()
    assert not tr.start_profiler()           # one session at a time
    with tr.span("chunk"):
        with tr.span("stage:a"):
            torch.ones(4).sum()
    path = tr.stop_profiler()
    assert tr.stop_profiler() is None
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"chunk", "chunk/stage:a"} <= names


# --------------------------------------------------------------------------
# metric units: merge conventions encoded in the key names
# --------------------------------------------------------------------------

def test_stat_helpers_are_none_safe():
    stat_max(None, "hw_bind", 5)
    stat_add(None, "n_windows", 1)
    stats = {}
    for v in (3, 7, 2):
        stat_max(stats, "hw_bind", torch.tensor(v, dtype=torch.int32))
    stat_add(stats, "n_windows", torch.tensor(2, dtype=torch.int32))
    stat_add(stats, "n_windows", torch.tensor(3, dtype=torch.int32))
    assert int(stats["hw_bind"]) == 7
    assert int(stats["n_windows"]) == 5


def test_reduce_and_merge_follow_hw_vs_n_convention():
    # per-window stats: hw_* gauges reduce by max, n_* counters by sum
    per_window = {"hw_bind": [3, 9, 4], "n_retract": [1, 0, 2]}
    red = reduce_stats({k: torch.tensor(v) for k, v in per_window.items()})
    ref = rreduce_stats({k: np.array(v) for k, v in per_window.items()})
    assert {k: int(v) for k, v in red.items()} == {
        k: int(v) for k, v in ref.items()} == {"hw_bind": 9, "n_retract": 3}
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in red.values())
    acc = {}
    merge_stats(acc, {"hw_bind": torch.tensor(5), "n_windows": torch.tensor(2)})
    merge_stats(acc, {"hw_bind": torch.tensor(3), "n_windows": torch.tensor(4)})
    fin = finalize_stats(acc)
    assert fin == {"hw_bind": 5, "n_windows": 6}
    assert all(isinstance(v, int) for v in fin.values())


def test_saturation_vs_caps():
    sat = saturation({"hw_bind": 512, "hw_probe_k": 8, "n_windows": 7},
                     {"bind_cap": 1024, "k_max": 8})
    assert sat["hw_bind"] == pytest.approx(0.5)
    assert sat["hw_probe_k"] == pytest.approx(1.0)
    assert "n_windows" not in sat      # counters have no capacity


# --------------------------------------------------------------------------
# report units
# --------------------------------------------------------------------------

def _span(first, steady):
    return {
        "count": 1 + len(steady), "first_s": first,
        "steady": {"count": len(steady), "total_s": sum(steady),
                   "mean_s": sum(steady) / len(steady) if steady else 0.0,
                   "min_s": min(steady) if steady else 0.0,
                   "max_s": max(steady) if steady else 0.0},
    }


def test_bottleneck_stage_prefix_and_first_sample_fallback():
    spans = {
        "chunk": _span(9.0, [5.0, 5.0]),            # enclosing span, excluded
        "chunk/stage:a": _span(8.0, [0.5, 0.4]),
        "chunk/stage:b": _span(1.0, [2.0, 2.1]),
    }
    # prefix matches the *last* path segment, skipping the chunk wrapper
    assert bottleneck_stage(spans, prefix="stage") == "chunk/stage:b"
    assert bottleneck_stage(spans) == "chunk"
    # single-pass traces (no steady samples) compete on the first sample
    only_first = {"chunk/stage:a": _span(8.0, []),
                  "chunk/stage:b": _span(1.0, [])}
    assert bottleneck_stage(only_first, prefix="stage") == "chunk/stage:a"
    assert bottleneck_stage({}, prefix="stage") is None


def test_tables_render():
    spans = {"stage:a": _span(0.5, [0.01, 0.02])}
    ops = {"op0": attach_saturation({"hw_bind": 10, "n_windows": 2},
                                    {"bind_cap": 100})}
    assert "stage:a" in format_stage_table(spans)
    table = format_metrics_table(ops)
    assert "hw_bind" in table and "10%" in table


# --------------------------------------------------------------------------
# uniform runtime surfaces, held to the reference
# --------------------------------------------------------------------------

def test_last_stats_uniform_across_modes_trace_off(pworld):
    for mode in MODES:
        reg = _run(pworld, "cquery1", mode)[0]
        stats = reg.last_stats
        assert set(stats) == {"query", "mode", "overflow_totals", "channels",
                              "operators", "spans", "recovery", "degraded"}
        assert stats["mode"] == mode
        assert stats["recovery"]["enabled"] is False
        assert stats["degraded"] is False
        assert stats["operators"] == {}    # metrics need trace= enabled
        assert stats["spans"] == {}
        assert all(v == 0 for v in stats["overflow_totals"].values())
        if mode == "pipelined":
            assert stats["channels"]           # edges exist here only
            for entry in stats["channels"].values():
                assert {"pushes", "pops", "depth_hw"} <= set(entry)
        else:
            assert stats["channels"] == {}
        json.dumps(stats)


@pytest.mark.parametrize("mode", MODES)
def test_traced_last_stats_equal_reference(pworld, mode):
    """``last_stats`` of a traced CQuery1 run (two upstream operators, the
    split sink, probe joins, an OPTIONAL): per-operator counters, caps and
    saturation, overflow totals, channels, recovery and ``degraded`` equal
    the reference's, and so does the set of span paths."""
    q = "cquery1"
    reg = _run(pworld, q, mode, trace=True)[0]
    ref = _ref_run(pworld, q, mode, trace=True)[0]
    got, want = reg.last_stats, ref.last_stats
    assert got["operators"], (q, mode)
    for key in ("operators", "overflow_totals", "channels", "recovery",
                "degraded", "query", "mode"):
        assert got[key] == want[key], key
    assert set(got["spans"]) == set(want["spans"])
    json.dumps(got)


@pytest.mark.parametrize("mode", ["single_program", "pipelined"])
def test_incremental_traced_counters_equal_reference(pworld, mode):
    """The delta evaluator's gauges and ``n_retract`` (sliding windows,
    the delta split sink) equal the reference's."""
    kw = dict(trace=True, incremental=True, window_step=24)
    reg = _run(pworld, "q15", mode, **kw)[0]
    ref = _ref_run(pworld, "q15", mode, **kw)[0]
    assert reg.runtime.sink_kind == "split-delta"
    got = reg.last_stats["operators"]
    assert got == ref.last_stats["operators"]
    assert all("n_retract" in e["counters"] for e in got.values())


def test_traced_metrics_agree_across_decomposed_modes(pworld):
    metrics = {}
    for mode in ("single_program", "pipelined"):
        stats = _run(pworld, "cquery1", mode, trace=True)[0].last_stats
        assert stats["operators"], mode
        for entry in stats["operators"].values():
            assert {"counters", "caps", "saturation"} == set(entry)
        metrics[mode] = {op: e["counters"]
                         for op, e in stats["operators"].items()}
        assert stats["spans"], mode
    # both modes run the same per-operator stages over the same stream
    assert metrics["single_program"] == metrics["pipelined"]


def test_monolithic_hw_out_matches_published_rows(pworld):
    reg, outs, _ = _run(pworld, "cquery1", "monolithic", trace=True)
    counters = reg.last_stats["operators"][reg.query.name]["counters"]
    # the single operator's constructed-output high-water is the largest
    # published chunk
    assert counters["hw_out"] == max(len(to_host_rows(o)) for o in outs)
    assert counters["n_windows"] >= len(pworld.chunks)
    assert 0 < counters["hw_bind"] <= CAPS["bind_cap"]
    assert 0 < counters["hw_scan"] <= CAPS["scan_cap"]


def test_pipelined_stage_spans_cover_every_operator(pworld):
    reg = pworld.port_register("cquery1", "pipelined", "auto", trace=True)
    reg.run(pworld.port_chunks())
    reg.run(pworld.port_chunks())          # a second pass: steady samples
    spans = reg.last_stats["spans"]
    stages = {p.split("/")[-1] for p in spans
              if p.split("/")[-1].startswith("stage:")}
    assert stages == {"stage:source"} | {"stage:%s" % n
                                         for n in reg.operators}
    for path, s in spans.items():
        if path.split("/")[-1].startswith("stage:"):
            assert s["count"] > 0 and s["steady"]["count"] > 0, path
    assert bottleneck_stage(spans, prefix="stage") in {
        p for p in spans if p.split("/")[-1].startswith("stage:")}


# --------------------------------------------------------------------------
# tracing off: nothing of obs, faults or recovery runs; on: the same bytes
# --------------------------------------------------------------------------

def _poison_targets():
    """Every function of ``repro_torch.obs``, ``core.faults`` and
    ``core.recovery`` (``module``, ``name``) pairs, and every alias a
    module of ``repro_torch`` imported of them."""
    mods = (ptrace, pmetrics, preport, pfaults, precovery)
    funcs = {}
    for mod in mods:
        for name, obj in vars(mod).items():
            if inspect.isfunction(obj) and obj.__module__ == mod.__name__:
                funcs[id(obj)] = obj
    targets = []
    for mname, mod in list(sys.modules.items()):
        if mod is None or not mname.startswith("repro_torch"):
            continue
        for name, obj in list(vars(mod).items()):
            if id(obj) in funcs and obj is funcs[id(obj)]:
                targets.append((mod, name))
    return targets


@pytest.mark.parametrize("mode", MODES)
def test_off_path_runs_nothing_of_obs_faults_or_recovery(pworld, mode,
                                                         monkeypatch):
    """With trace, faults and recovery off, a whole-stream run calls no
    function of those modules (each is poisoned to raise), and gives the
    traced run's bytes."""
    off = pworld.port_register("cquery1", mode, "auto")
    on = pworld.port_register("cquery1", mode, "auto", trace=True)
    chunks = pworld.port_chunks()
    targets = _poison_targets()
    assert len(targets) > 30

    def poisoned(*a, **k):
        raise AssertionError("observability or fault code ran")

    for mod, name in targets:
        monkeypatch.setattr(mod, name, poisoned)
    outs, _ = off.run(chunks)
    with pytest.raises(AssertionError, match="code ran"):
        on.run(chunks)                 # the poison does reach a traced run
    monkeypatch.undo()
    _same_bytes(outs, _run(pworld, "cquery1", mode, trace=True)[1])


def test_traced_outputs_bit_identical_to_untraced(pworld):
    for mode in MODES:
        _, outs_off, ovf_off = _run(pworld, "cquery1", mode)
        _, outs_on, ovf_on = _run(pworld, "cquery1", mode, trace=True)
        _same_bytes(outs_off, outs_on)
        assert ovf_off == ovf_on


# --------------------------------------------------------------------------
# explain
# --------------------------------------------------------------------------

def _close(a, b, path="$"):
    """``a == b`` as JSON trees, floats within 1e-9 relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("mode", MODES)
def test_explain_equals_reference(pworld, q, mode):
    got = pworld.port_registered(q, mode, "auto").explain()
    want = pworld.ref_registered(q, mode, "auto").explain()
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(want)))


def test_explain_reports_planner_decisions(pworld):
    reg = pworld.port_registered("cquery1", "single_program", "auto")
    art = reg.explain()
    assert art["query"] == reg.query.name
    assert art["kb_method"] == "auto"
    assert set(art["operators"]) == set(reg.operators)
    saw_kb_join = False
    for op_art in art["operators"].values():
        assert {"scan_cap", "bind_cap", "out_cap", "k_max"} <= set(
            op_art["caps"])
        assert isinstance(op_art["delta_capable"], bool)
        for step in op_art["steps"]:
            if step["step"] == "KBJoin":
                saw_kb_join = True
                assert step["method"] in ("scan", "probe")
                assert step.get("est_rows") is not None
                if step["method"] == "probe":
                    assert step["k_max"] >= 1
    assert saw_kb_join
    rendered = format_explain(art)
    assert reg.query.name in rendered and "KBJoin" in rendered
    json.dumps(art)


def test_to_json_bundles_stats_and_explain(pworld):
    reg = _run(pworld, "cquery1", "monolithic", trace=True)[0]
    payload = to_json(reg.last_stats, explain=reg.explain())
    assert payload["query"] == reg.query.name
    assert "explain" in payload and "spans" in payload
    json.dumps(payload)
