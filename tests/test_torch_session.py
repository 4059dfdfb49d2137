"""PyTorch port vs the JAX reference: the whole slice through ``Session``.

The same vocabulary, KB and stream chunks (carried over as numpy arrays)
go through the reference ``Session`` (fused jnp joins, bit-identical to its
Pallas kernels) and the port's ``Session`` on the CPU (the kernels' plain
versions).  The output streams must be equal as ``np.uint32`` bytes with
equal overflow totals, and the compiled plans must agree field by field.
"""
import copy
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from repro.core import paper_queries as RPQ
from repro.core import planner as rplanner
from repro.core.rdf import Vocab as RVocab
from repro.core.session import ExecutionConfig as RConfig
from repro.core.session import Session as RSession
from repro.data.dbpedia import KBConfig, generate_kb
from repro.data.tweets import (
    TweetSchema, TweetStreamConfig, generate_tweets, stream_chunks,
)
from repro_torch import interop
from repro_torch.core import engine as pengine
from repro_torch.core import planner as pplanner
from repro_torch.core.session import ExecutionConfig, Session

QUERY_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "queries")
CAPS = dict(window_capacity=96, max_windows=4, bind_cap=1024, scan_cap=128,
            out_cap=1024, intermediate_cap=512)
QUERIES = ("q15", "q16", "cquery1", "artist_classes")
CASES = ([(q, mode, "auto") for q in QUERIES
          for mode in ("monolithic", "single_program", "pipelined")]
         + [("cquery1", mode, m) for m in ("scan", "probe")
            for mode in ("monolithic", "single_program", "pipelined")])


def _texts():
    texts = dict(RPQ.RQ_TEXTS)
    with open(os.path.join(QUERY_DIR, "artist_classes.rq")) as f:
        texts["artist_classes"] = f.read()
    return texts


def _key(q, mode, method, kw):
    return (q, mode, method, tuple(sorted((k, repr(v))
                                          for k, v in kw.items())))


class PortWorld:
    """One reference world, and the same state as plain arrays.  Runs and
    registrations are cached by their configuration: every port test module
    shares one world per process (:func:`_world`), so no configuration runs
    twice in a test worker."""

    def __init__(self):
        self.vocab = RVocab()
        self.kbd = generate_kb(self.vocab, KBConfig(
            num_artists=24, num_shows=12, filler_triples=80, seed=0))
        tweets = TweetSchema.create(self.vocab)
        pool = np.concatenate([self.kbd.artist_ids, self.kbd.show_ids])
        rows = generate_tweets(self.vocab, tweets, pool, TweetStreamConfig(
            num_tweets=36, mentions_min=2, mentions_max=3, seed=0))
        self.chunks = list(stream_chunks(rows, 96))
        self.kb_arrays = {f: np.asarray(getattr(self.kbd.kb, f))
                          for f in self.kbd.kb._fields}
        self.chunk_arrays = [[np.asarray(c) for c in ch] for ch in self.chunks]
        self.texts = _texts()
        self.ref = {}
        self.ref_regs = {}
        self.port_regs = {}
        self.port_runs = {}

    def port_vocab(self):
        v = self.vocab
        return interop.vocab_from_state(v._pred_to_id, v._term_to_id,
                                        v._next_pred, v._next_term)

    def ref_register(self, q, mode, method, **kw):
        cfg = dict(CAPS, fuse_compaction=True)
        cfg.update(kw)
        sess = RSession(RConfig(mode=mode, kb_method=method, **cfg),
                        vocab=copy.deepcopy(self.vocab), kb=self.kbd.kb)
        return sess.register(self.texts[q])

    def ref_registered(self, q, mode, method, **kw):
        """The reference registration of this configuration, built once
        (and run at most once, by :meth:`ref_run`)."""
        key = _key(q, mode, method, kw)
        if key not in self.ref_regs:
            self.ref_regs[key] = self.ref_register(q, mode, method, **kw)
        return self.ref_regs[key]

    def ref_run(self, q, mode, method, **kw):
        key = _key(q, mode, method, kw)
        if key not in self.ref:
            reg = self.ref_registered(q, mode, method, **kw)
            outs, overflow = reg.run(self.chunks)
            self.ref[key] = (reg, [[np.asarray(c) for c in o] for o in outs],
                             overflow, reg.overflow_totals())
        return self.ref[key]

    def port_register(self, q, mode, method, **kw):
        sess = Session(ExecutionConfig(mode=mode, kb_method=method,
                                       device="cpu", **dict(CAPS, **kw)),
                       vocab=self.port_vocab(),
                       kb=interop.kb_from_arrays(self.kb_arrays))
        return sess.register(self.texts[q])

    def port_registered(self, q, mode, method, **kw):
        """The port's registration of this configuration, built once and
        never run (:meth:`port_run` keeps its own)."""
        key = _key(q, mode, method, kw)
        if key not in self.port_regs:
            self.port_regs[key] = self.port_register(q, mode, method, **kw)
        return self.port_regs[key]

    def port_run(self, q, mode, method, **kw):
        """``(registration, outputs, overflow)`` of the port's whole-stream
        run of this configuration, run once.  Callers read the registration
        and do not drive it again."""
        key = _key(q, mode, method, kw)
        if key not in self.port_runs:
            reg = self.port_register(q, mode, method, **kw)
            self.port_runs[key] = (reg, *reg.run(self.port_chunks()))
        return self.port_runs[key]

    def port_chunks(self):
        return [interop.triples_from_arrays(*c) for c in self.chunk_arrays]


@functools.lru_cache(maxsize=None)
def _world() -> PortWorld:
    return PortWorld()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are small.  With one intra-op thread pool
    over every core in each pytest-xdist worker, the workers' pools wait on
    one another: a 4-worker run of these modules took twice the CPU time.
    One thread a worker while a module's tests run; the count is restored
    after.  Only integer ids are compared here, so the thread count cannot
    change a result."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pworld():
    w = _world()
    assert len(w.chunks) >= 3
    return w


def _bytes(col) -> bytes:
    if torch.is_tensor(col):
        col = col.numpy()
    return np.asarray(col).astype(np.uint32).tobytes()


def check_against_reference(pworld, q, mode, method, expect_output=True,
                            **kw):
    """Run ``q`` through the port's and the reference's ``Session`` under
    the same config; the output streams must be the same ``np.uint32``
    bytes, with the same overflow totals, and hold triples unless
    ``expect_output`` is False.  The port's ``pipelined`` mode is held to
    the reference's ``single_program`` run (the reference pins its two
    modes equal).  Returns the port's registration and outputs."""
    ref_mode = "single_program" if mode == "pipelined" else mode
    _, ref_outs, ref_ovf, ref_totals = pworld.ref_run(q, ref_mode, method,
                                                      **kw)
    reg, outs, overflow = pworld.port_run(q, mode, method, **kw)
    assert len(outs) == len(ref_outs)
    for i, (ro, po) in enumerate(zip(ref_outs, outs)):
        for name, rc, pc in zip(po._fields, ro, po):
            assert _bytes(rc) == _bytes(pc), (q, mode, method, kw, i, name)
    assert overflow == dict(ref_ovf)
    assert reg.overflow_totals() == ref_totals
    assert (sum(int(o.valid.sum()) for o in outs) > 0) == expect_output
    return reg, outs


@pytest.mark.parametrize("q,mode,method", CASES)
def test_session_output_equals_reference(pworld, q, mode, method):
    check_against_reference(pworld, q, mode, method)


@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
def test_unfused_scan_session_equals_reference(pworld, mode):
    """``fuse_compaction=False``: every scan join writes the candidate
    matrix and compacts it; the bytes equal the reference's unfused run and
    the port's fused one."""
    reg, outs = check_against_reference(pworld, "q15", mode, "scan",
                                        fuse_compaction=False)
    steps = [s for op in reg.operators.values() for s in op.plan.steps
             if isinstance(s, pengine.KBJoin)]
    assert steps and not any(s.fuse_compaction for s in steps)
    fused = pworld.port_run("q15", mode, "scan")[1]
    for a, b in zip(outs, fused):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _norm(x):
    """A plan (or part of one) as plain tuples, keeping the fields both
    packages have (the reference's other Pallas knobs have no
    counterpart)."""
    if dataclasses.is_dataclass(x):
        names = [f.name for f in dataclasses.fields(x)
                 if f.name not in ("use_pallas", "bm", "bn", "interpret")]
        return (type(x).__name__,) + tuple(
            (n, _norm(getattr(x, n))) for n in names)
    if isinstance(x, (tuple, list)):
        return tuple(_norm(v) for v in x)
    if hasattr(x, "value") and hasattr(x, "name"):      # SlotMode
        return int(x)
    return x


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
def test_compiled_plans_equal_reference(pworld, q, mode):
    ref_reg = pworld.ref_run(q, mode, "auto")[0]
    reg = pworld.port_registered(q, mode, "auto")
    assert sorted(reg.operators) == sorted(ref_reg.operators)
    for name, op in reg.operators.items():
        ref_op = ref_reg.operators[name]
        # in single_program the sink's plan is the split sink's rewrite in
        # both packages, BindingJoin steps included
        ref_plan = ref_op.plan
        assert _norm(op.plan) == _norm(ref_plan), name
        assert pplanner.plan_caps(op.plan) == rplanner.plan_caps(ref_plan)
        assert sorted(op.env) == sorted(ref_op.env)
        for k in op.env:
            assert _bytes(op.env[k]) == _bytes(ref_op.env[k])
        assert (op.kb is None) == (ref_op.kb is None)
        if op.kb is not None:
            for f in op.kb._fields:
                assert _bytes(getattr(op.kb, f)) == _bytes(
                    getattr(ref_op.kb, f)), (name, f)
    if mode == "single_program":
        assert reg.runtime.sink_kind == "split"
        assert any(isinstance(s, pengine.BindingJoin)
                   for s in reg.operators[reg.dag.final].plan.steps)
    assert reg.text == ref_reg.text


def test_stream_generator_matches_run(pworld):
    reg = pworld.port_register("q15", "single_program", "auto")
    outs, _ = reg.run(pworld.port_chunks())
    streamed = list(reg.stream(pworld.port_chunks()))
    for a, b in zip(outs, streamed):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    out, ovf = reg.process_chunk(pworld.port_chunks()[0])
    assert all(torch.equal(x, y) for x, y in zip(out, outs[0]))
    assert set(ovf) == set(reg.operators)


def _knob(name, pkg):
    """A value of the trace/faults/recovery/mesh knobs, built by ``pkg``'s
    own classes (``"port"`` or ``"ref"``)."""
    from repro.core.faults import FaultEvent as RFE, FaultPlan as RFP
    from repro.core.recovery import RecoveryConfig as RRC
    from repro.obs.trace import TraceConfig as RTC
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.recovery import RecoveryConfig
    from repro_torch.obs.trace import TraceConfig

    port = pkg == "port"
    if name == "mesh":
        if port:
            from repro_torch.launch.mesh import Mesh
            return Mesh(np.array([torch.device("cpu")], dtype=object)
                        .reshape(1, 1), ("data", "model"))
        from repro.launch.mesh import make_host_mesh
        return make_host_mesh()
    return {
        "plan": (FaultPlan((FaultEvent("crash_stage", "source", 0),)) if port
                 else RFP((RFE("crash_stage", "source", 0),))),
        "recovery": RecoveryConfig() if port else RRC(),
        "trace_config": (TraceConfig(fence=False) if port
                         else RTC(fence=False)),
    }[name]


@pytest.mark.parametrize("mode,knob,error", [
    ("single_program", dict(trace="yes"), TypeError),
    ("monolithic", dict(trace=1), TypeError),
    ("pipelined", dict(faults="not a plan"), TypeError),
    ("pipelined", dict(recovery="not a config"), TypeError),
    ("monolithic", dict(faults="plan"), ValueError),
    ("single_program", dict(recovery="recovery"), ValueError),
    ("single_program", dict(faults="plan", recovery="recovery"), ValueError),
    ("pipelined", dict(faults="plan", recovery="recovery",
                       trace="trace_config"), None),
    ("monolithic", dict(trace="trace_config"), None),
    ("single_program", dict(trace=True), None),
    ("pipelined", dict(trace=False), None),
    ("pipelined", dict(mesh="mesh"), ValueError),
    ("monolithic", dict(mesh="mesh"), None),
    ("single_program", dict(mesh="mesh", data_axis="data"), None),
])
def test_knob_validation_matches_the_reference(mode, knob, error):
    """``trace=`` takes None, False, True or a TraceConfig; ``faults=`` a
    FaultPlan and ``recovery=`` a RecoveryConfig, in pipelined mode only;
    ``mesh=`` is refused in pipelined mode (placement= spreads it) and
    ignored by monolithic: the port raises what the reference raises, or
    accepts what it accepts."""
    names = ("plan", "recovery", "trace_config", "mesh")

    def build(pkg):
        kw = {k: (_knob(v, pkg) if v in names else v) for k, v in knob.items()}
        if pkg == "port":
            return ExecutionConfig(device="cpu", mode=mode, **kw)
        return RConfig(mode=mode, **kw)

    for pkg in ("ref", "port"):
        if error is None:
            build(pkg)
        else:
            with pytest.raises(error):
                build(pkg)


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecutionConfig()


def test_kb_touching_query_needs_a_kb(pworld):
    sess = Session(ExecutionConfig(device="cpu", **CAPS),
                   vocab=pworld.port_vocab())
    with pytest.raises(ValueError, match="kb="):
        sess.register(pworld.texts["q15"])


def test_duplicate_registration_raises(pworld):
    sess = Session(ExecutionConfig(device="cpu", **CAPS),
                   vocab=pworld.port_vocab(),
                   kb=interop.kb_from_arrays(pworld.kb_arrays))
    sess.register(pworld.texts["q16"])
    with pytest.raises(ValueError, match="already registered"):
        sess.register(pworld.texts["q16"])
    sess.register(pworld.texts["q16"], replace=True)


def test_plan_steps_carry_only_ported_knobs():
    fields = {f.name for f in dataclasses.fields(pengine.KBJoin)}
    assert fields == {"pat", "method", "k_max", "fuse_compaction"}
