"""PyTorch port vs the JAX reference: multi-query serving.

The port's ``ServeEngine`` (plan dedup, shared KB-join prefixes, constant
cohorts) must publish, for every query of a population, the bytes and
overflow totals of that query's own **reference** ``Session``, with dedup,
cohorts and the fused kernels each on and off: the engine is held to the
port's per-query sessions, and those, once, to the reference's.  Its
schedule must equal a
reference ``ServeEngine``'s where the reference batches, its plan-sharing
keys must equal the reference planner's, and its ``QueryAdmission`` must
count and answer as the reference's under the same submit/offer/tick
sequence.  The counterexample of ``diff_failures/serving.txt`` (two
queries that differ in a ``p*`` end constant) pins the closure-KB cache
key, where the reference's serving layer is at fault.

World: ``tests/test_serve_engine.py``'s (``serve_population(9)``: three
duplicates, three class variants, three thresholds) on the CPU.  The
population is parsed into one vocabulary before the port copies it, so
both packages number every term alike; the per-query sessions run once
per distinct query body.
"""
import copy
import dataclasses
import functools
import re
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core import planner as rplanner
from repro.core import query as RQ
from repro.core.faults import corrupt_batch as rcorrupt_batch
from repro.core.paper_queries import RQ_TEXTS
from repro.core.session import Session as RSession
from repro.core.sparql import parse_query as rparse
from repro.launch.dscep_run import serve_population as rserve_population
from repro.serve.batcher import QueryAdmission as RQueryAdmission
from repro.serve.batcher import QueryRequest as RQueryRequest
from repro_torch import interop
from repro_torch.core import operator as operator_mod
from repro_torch.core import planner as pplanner
from repro_torch.core import query as PQ
from repro_torch.core.faults import corrupt_batch
from repro_torch.core.rdf import NUM_BASE
from repro_torch.core.session import ExecutionConfig, Session
from repro_torch.core.sparql import parse_query as pparse
from repro_torch.launch.dscep_run import serve_population
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.batcher import QueryAdmission, QueryRequest
from repro_torch.serve.engine import ServeEngine

from test_differential import CFG as DIFF_CFG, DW, _chunks_for
from test_serve_engine import CFG as RCFG, ServeWorld
from test_torch_session import _bytes, _norm, one_torch_thread  # noqa: F401

CAPS = {f.name: getattr(RCFG, f.name) for f in dataclasses.fields(RCFG)
        if f.name in ("window_capacity", "max_windows", "bind_cap",
                      "scan_cap", "out_cap", "out_stream_cap",
                      "intermediate_cap")}
SCHEDULE_KEYS = ("queries", "dedup", "batch", "distinct_plans",
                 "prefix_groups", "cohorts", "batch_sizes", "singletons",
                 "shared_plan_hits", "shared_prefix_hits", "chunks")


def _body(text):
    """A population text without its name: the per-query key of the
    reference runs (outputs do not depend on the name)."""
    return re.sub(r"REGISTER QUERY \w+ AS", "", text)


def _out_bytes(o):
    return tuple(_bytes(np.asarray(c)) for c in o)


def _name(text):
    return re.search(r"REGISTER QUERY (\w+) AS", text).group(1)


def _per_query_runs(register, texts, chunks):
    """``({name: [chunk bytes]}, {name: overflow})`` of each text in its own
    session, one session a distinct query body (outputs do not depend on
    the name)."""
    outs, ovf, by_body = {}, {}, {}
    for text in texts:
        body = _body(text)
        if body not in by_body:
            reg = register(text)
            got, o = reg.run(chunks)
            by_body[body] = ([_out_bytes(c) for c in got], o[reg.query.name])
        outs[_name(text)], ovf[_name(text)] = by_body[body]
    return outs, ovf


class Population:
    """The serving world in both packages over one vocab state, KB and
    chunks; per-query sessions of both packages, each run once a process
    when first read."""

    def __init__(self):
        self.world = ServeWorld()
        self.texts = self.world.texts
        assert self.texts == rserve_population(9)
        # intern every term of the population before the port copies the
        # vocab, so both packages number them alike
        self.vocab = copy.deepcopy(self.world.vocab)
        for text in self.texts:
            rparse(text, self.vocab)
        self.kb_arrays = {f: np.asarray(getattr(self.world.kbd.kb, f))
                          for f in self.world.kbd.kb._fields}
        self.chunk_arrays = [[np.asarray(c) for c in ch]
                             for ch in self.world.chunks]

    @functools.cached_property
    def ref(self):
        """The reference's per-query ``Session`` runs (JAX compiles each)."""
        before = (self.vocab._next_pred, self.vocab._next_term)
        runs = _per_query_runs(
            lambda t: RSession(RCFG, vocab=self.vocab,
                               kb=self.world.kbd.kb).register(t),
            self.texts, self.world.chunks)
        assert (self.vocab._next_pred, self.vocab._next_term) == before
        return runs

    @functools.cached_property
    def own(self):
        """The port's per-query ``Session`` runs (monolithic, default
        config), which every engine run is held to."""
        return _per_query_runs(lambda t: self.session().register(t),
                               self.texts, self.chunks())

    def port_vocab(self):
        v = self.vocab
        return interop.vocab_from_state(v._pred_to_id, v._term_to_id,
                                        v._next_pred, v._next_term)

    def session(self, **kw):
        cfg = ExecutionConfig(mode="monolithic", device="cpu",
                              **dict(CAPS, **kw))
        return Session(cfg, vocab=self.port_vocab(),
                       kb=interop.kb_from_arrays(self.kb_arrays))

    def engine(self, texts=None, **kw):
        opts = {k: kw.pop(k) for k in ("dedup", "batch") if k in kw}
        eng = self.session(**kw).serve(**opts)
        for t in (self.texts if texts is None else texts):
            eng.register(t)
        return eng

    def ref_engine(self, texts=(), fuse=True, **opts):
        """A reference engine; ``fuse=True`` (the reference's fused jnp
        joins) keeps every registration on its own operator, whose compiled
        step outlives schedule changes."""
        eng = RSession(RCFG.replace(fuse_compaction=fuse), vocab=self.vocab,
                       kb=self.world.kbd.kb).serve(**opts)
        for t in texts:
            eng.register(t)
        return eng

    def chunks(self):
        return [interop.triples_from_arrays(*c) for c in self.chunk_arrays]


@functools.lru_cache(maxsize=None)
def _population() -> Population:
    return Population()


@pytest.fixture(scope="module")
def pop():
    return _population()


# --------------------------------------------------------------------------
# the plan-sharing helpers against the reference planner
# --------------------------------------------------------------------------

def _plans():
    """The paper queries, the population and the counterexample's queries,
    compiled by both planners from one vocab state."""
    pop = _population()
    rvocab = copy.deepcopy(pop.vocab)
    texts = list(RQ_TEXTS.values()) + pop.texts
    rq = [rparse(t, rvocab) for t in texts]
    v = rvocab
    pvocab = interop.vocab_from_state(v._pred_to_id, v._term_to_id,
                                      v._next_pred, v._next_term)
    pq = [pparse(t, pvocab) for t in texts]
    rq += list(_counterexample(RQ))
    pq += list(_counterexample(PQ))
    return ([rplanner.compile_query(q, fuse_compaction=True) for q in rq],
            [pplanner.compile_query(q, fuse_compaction=True) for q in pq])


def test_plan_helpers_equal_reference():
    rplans, pplans = _plans()
    for r, p in zip(rplans, pplans):
        assert _norm(pplanner.plan_fingerprint(p)) == _norm(
            rplanner.plan_fingerprint(r)), p.name
        assert _norm(pplanner.plan_shape(p)) == _norm(
            rplanner.plan_shape(r)), p.name
        assert np.array_equal(pplanner.plan_consts(p),
                              rplanner.plan_consts(r))
        assert pplanner.plan_consts(p).dtype == np.uint32
        assert pplanner.plan_set_names(p) == rplanner.plan_set_names(r)
        assert pplanner.count_kb_joins(p.steps) == rplanner.count_kb_joins(
            r.steps)
    for r1, p1 in zip(rplans, pplans):
        for r2, p2 in zip(rplans, pplans):
            assert pplanner.shared_prefix_len(p1, p2) == \
                rplanner.shared_prefix_len(r1, r2)


def test_bind_plan_consts_rebuilds_each_cohort_member():
    _, pplans = _plans()
    by_shape = {}
    for p in pplans:
        by_shape.setdefault(pplanner.plan_shape(p), []).append(p)
    cohorts = [ps for ps in by_shape.values() if len(ps) >= 2]
    assert len(cohorts) >= 2          # the class and the threshold variants
    for ps in cohorts:
        rep = ps[0]
        for p in ps:
            bound = pplanner.bind_plan_consts(rep, pplanner.plan_consts(p))
            # p's own steps, env keys renamed canonically
            own = pplanner.bind_plan_consts(p, pplanner.plan_consts(p))
            assert bound.steps == own.steps and bound.templates == p.templates
            if not pplanner.plan_set_names(p):
                assert bound.steps == p.steps
    thr = next(p for p in pplans if p.name == "thr2")
    consts = pplanner.plan_consts(thr).copy()
    consts[consts >= NUM_BASE] = 7    # a term id where the filter's number was
    with pytest.raises(ValueError, match="numeric literal"):
        pplanner.bind_plan_consts(thr, consts)


# --------------------------------------------------------------------------
# every query's bytes against its own reference session
# --------------------------------------------------------------------------

def test_port_sessions_equal_reference_sessions(pop):
    """Each population query in its own port session publishes the bytes
    and overflow of its own reference session: the per-query streams
    every engine configuration below is held to."""
    own, own_ovf = pop.own
    ref, ref_ovf = pop.ref
    assert set(own) == set(ref) == {_name(t) for t in pop.texts}
    for name in ref:
        assert own[name] == ref[name], name
        assert own_ovf[name] == ref_ovf[name], name
    assert sum(len(c[0]) for c in own.values()) > 0


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("batch", [True, False])
def test_serving_equals_per_query_sessions(pop, fuse, dedup, batch):
    """Every query's stream and overflow equal its own session's (and so,
    by the test above, its reference session's), in every combination of
    dedup, cohorts and the fused kernels."""
    own, own_ovf = pop.own
    eng = pop.engine(dedup=dedup, batch=batch, fuse_compaction=fuse)
    outs, ovf = eng.run(pop.chunks())
    assert set(outs) == set(own)
    for name, chunks in outs.items():
        assert [_out_bytes(o) for o in chunks] == own[name], name
        assert ovf[name] == own_ovf[name], name
    st = eng.last_stats
    assert st["chunks"] == len(pop.chunks())
    assert st["overflow_totals"] == ovf
    batched = batch and not fuse
    assert bool(st["cohorts"]) == batched
    assert bool(st["prefix_groups"]) == (batched and dedup)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("batch", [True, False])
def test_schedule_equals_reference_engine(pop, dedup, batch):
    """At ``fuse_compaction=False`` (where the reference batches) the
    schedule fields equal a reference engine's over the same population;
    reading either schedule runs nothing."""
    eng = pop.engine(dedup=dedup, batch=batch, fuse_compaction=False)
    ref = pop.ref_engine(pop.texts, fuse=False, dedup=dedup, batch=batch)
    got, want = eng.last_stats, ref.last_stats
    assert {k: got[k] for k in SCHEDULE_KEYS} == \
        {k: want[k] for k in SCHEDULE_KEYS}
    if dedup and batch:
        assert got["distinct_plans"] == 5
        assert got["prefix_groups"] == [{"queries": ["dup0", "cls4"],
                                         "prefix_len": 2,
                                         "kb_joins_shared": 1}]
        assert got["batch_sizes"] == [3]


# --------------------------------------------------------------------------
# the closure-KB cache: diff_failures/serving.txt
# --------------------------------------------------------------------------

def _counterexample(Q, names=("c", "e")):
    """dq0 and dq1 of ``diff_failures/serving.txt`` on the differential
    suite's world, templates rebuilt from ``select`` as its generator
    builds them.  ``names`` renames ?c and ?e."""
    c, e = names
    pred = lambda n: DW.vocab.pred("?:" + n)         # noqa: E731
    head = (Q.Pattern(Q.Var("t"), Q.Const(DW.mentions), Q.Var(e), Q.STREAM),
            Q.Pattern(Q.Var("t"), Q.Const(DW.score), Q.Var("s"), Q.STREAM),
            Q.Pattern(Q.Var(e), Q.Const(DW.type_pred), Q.Var(c), Q.KB))
    construct = tuple(Q.ConstructTemplate(Q.RowId(0), Q.Const(pred(v)),
                                          Q.Var(v)) for v in (c, e))
    dq0 = Q.Query(name="dq0", where=head + (
        Q.PathClosure(Q.Var(c), DW.sub_pred, Q.Const(DW.classes[1]),
                      min_hops=0),
        Q.FilterNum("s", "lt", 1073741872)),
        construct=construct, select=(c, e))
    dq1 = Q.Query(name="dq1", where=head + (
        Q.PathClosure(Q.Var(c), DW.sub_pred, Q.Const(DW.classes[0]),
                      min_hops=0),
        Q.FilterNum("s", "le", 1073741993),
        Q.OptionalGroup((Q.Pattern(Q.Var("t"), Q.Const(DW.tag), Q.Var("g"),
                                   Q.STREAM),))),
        construct=construct, select=(c, e))
    return dq0, dq1


@functools.lru_cache(maxsize=None)
def _counterexample_reference():
    _, chunks = _chunks_for(14597)
    cfg = DIFF_CFG.replace(mode="monolithic")
    ref = {}
    for q in _counterexample(RQ):
        reg = RSession(cfg, vocab=DW.vocab, kb=DW.kb).register(q)
        outs, ovf = reg.run(chunks)
        ref[q.name] = ([_out_bytes(o) for o in outs], ovf[q.name])
    return chunks, ref


def _diff_session(**kw):
    caps = {f.name: getattr(DIFF_CFG, f.name)
            for f in dataclasses.fields(DIFF_CFG)
            if f.name in CAPS}
    v = DW.vocab
    vocab = interop.vocab_from_state(v._pred_to_id, v._term_to_id,
                                     v._next_pred, v._next_term)
    kb = interop.kb_from_arrays({f: np.asarray(getattr(DW.kb, f))
                                 for f in DW.kb._fields})
    return Session(ExecutionConfig(mode="monolithic", device="cpu",
                                   **dict(caps, **kw)), vocab=vocab, kb=kb)


@pytest.mark.parametrize("fuse", [True, False])
def test_closure_constant_counterexample_equals_reference(fuse):
    """The saved failure (seed 14597, dedup on): ``?c :sub* C1`` and
    ``?c :sub* C0`` share their (pred, min_hops) spec but not their closure
    set.  Keyed by the spec alone, dq1 would run on dq0's augmented KB."""
    chunks, ref = _counterexample_reference()
    dq0, dq1 = _counterexample(PQ)
    assert DW.classes[:2] == [4096, 4097]     # the ids the saved run named
    eng = _diff_session(fuse_compaction=fuse).serve(dedup=True)
    eng.register(dq0)
    eng.register(dq1)
    outs, ovf = eng.run([interop.triples_from_arrays(
        *[np.asarray(c) for c in ch]) for ch in chunks])
    assert eng.units["dq0"].kb is not eng.units["dq1"].kb
    for name, (want, want_ovf) in ref.items():
        assert [_out_bytes(o) for o in outs[name]] == want, name
        assert ovf[name] == want_ovf
    assert sum(int(o.valid.sum()) for o in outs["dq1"]) > 0


def test_variable_names_alone_share_one_augmented_kb():
    dq0, _ = _counterexample(PQ)
    renamed, _ = _counterexample(PQ, names=("k", "x"))
    eng = _diff_session().serve()
    eng.register(dq0)
    eng.register(dataclasses.replace(renamed, name="dq0r"))
    assert eng.units["dq0"].kb is eng.units["dq0r"].kb
    assert len(eng._kb_cache) == 1
    assert pplanner.closure_kb_key(dq0) == pplanner.closure_kb_key(renamed)


# --------------------------------------------------------------------------
# the drive and registration surface
# --------------------------------------------------------------------------

def test_process_chunk_matches_run(pop):
    ref, _ = pop.engine().run(pop.chunks())
    eng = pop.engine()
    for i, chunk in enumerate(pop.chunks()):
        for name, o in eng.process_chunk(chunk).items():
            assert _out_bytes(o) == _out_bytes(ref[name][i]), (name, i)


def test_register_replace_and_unregister(pop):
    eng = pop.engine(pop.texts[:3])
    with pytest.raises(ValueError, match="already registered") as ei:
        eng.register(pop.texts[0])
    msg = str(ei.value)
    assert "existing:" in msg and "new:" in msg and "replace=True" in msg
    unit = eng.register(pop.texts[0], replace=True)
    assert eng.units["dup0"] is unit
    with pytest.raises(TypeError, match="register"):
        eng.register(42)
    chunks = pop.chunks()
    eng.process_chunk(chunks[0])
    eng.unregister("cls1")
    assert "cls1" not in eng.overflow_totals()
    outs = eng.process_chunk(chunks[1])
    assert set(outs) == {"dup0", "thr2"}
    for name, o in outs.items():
        assert _out_bytes(o) == pop.own[0][name][1], name
    with pytest.raises(KeyError):
        eng.unregister("cls1")


@pytest.mark.parametrize("incremental", [False, True])
def test_windows_pack_once_per_chunk(pop, incremental):
    """Every program of a geometry reads the windows (slides) the engine
    packed once for the chunk; no operator packs its own.  Incremental
    sliding windows publish each query's own port session's bytes."""
    kw = (dict(window_step=24, incremental=True, scan_cap=512)
          if incremental else {})
    eng = pop.engine(**kw)
    name = "count_slides" if incremental else "count_windows"
    real, calls = getattr(engine_mod, name), []

    def counted(*a):
        calls.append(1)
        return real(*a)

    chunk = pop.chunks()[0]
    with mock.patch.object(engine_mod, name, counted), \
            mock.patch.object(operator_mod, name, None):
        outs = eng.process_chunk(chunk)
    assert len(calls) == 1 and len(outs) == len(pop.texts)
    if incremental:
        for text in pop.texts[:3] + pop.texts[4:5]:
            reg = pop.session(**kw).register(text)
            own, _ = reg.process_chunk(chunk)
            assert _out_bytes(outs[reg.query.name]) == _out_bytes(own)


def test_kb_query_without_a_kb_raises(pop):
    eng = Session(ExecutionConfig(device="cpu"),
                  vocab=pop.port_vocab()).serve()
    with pytest.raises(ValueError, match="has no kb"):
        eng.register(pop.texts[0])


@pytest.mark.parametrize("fuse", [True, False])
def test_trace_metrics_equal_per_query_sessions(pop, fuse):
    """Under ``trace=True`` every evaluated plan's engine counters equal
    its own port session's (monolithic, traced) over the same chunks."""
    eng = pop.engine(trace=True, fuse_compaction=fuse)
    chunks = pop.chunks()
    eng.run(chunks)
    ops = eng.last_stats["operators"]
    assert sorted(ops) == sorted(g.rep.name for g in eng.schedule.groups)
    for name, rep in ops.items():
        reg = pop.session(trace=True, fuse_compaction=fuse).register(
            eng.units[name].text)
        reg.run(chunks)
        assert rep == reg.last_stats["operators"][name], name
        assert rep["counters"]["n_windows"] > 0
    assert not pop.engine(pop.texts[:1]).last_stats["operators"]


def test_session_serve_factory(pop):
    eng = pop.session().serve(dedup=False, batch=False)
    assert isinstance(eng, ServeEngine)
    assert (eng.dedup, eng.batch) == (False, False)
    assert eng.session.device == torch.device("cpu")


def test_serve_population_is_the_reference_population():
    for n in (0, 9, 64):
        assert serve_population(n) == rserve_population(n)


# --------------------------------------------------------------------------
# admission: the same sequence on both packages
# --------------------------------------------------------------------------

class _StubEngine:
    """The four methods QueryAdmission needs, with poison-chunk faults
    (``tests/test_faults.py``'s)."""

    def __init__(self):
        self.registered = {}
        self.processed = []
        self._n = 0

    def register(self, query, name=None):
        self._n += 1
        nm = name or "q%d" % self._n
        self.registered[nm] = query
        return types.SimpleNamespace(name=nm)

    def unregister(self, name):
        del self.registered[name]

    def process_chunk(self, chunk):
        if chunk == "poison":
            raise RuntimeError("poisoned feed")
        self.processed.append(chunk)
        return {}


def _outs(res):
    """A tick's (tenant, outputs) with the outputs as bytes."""
    if res is None:
        return None
    tenant, outs = res
    return tenant, {n: _out_bytes(o) for n, o in sorted(outs.items())}


def _slots_and_backpressure(k):
    eng = k.engine()
    adm = eng.admission(num_slots=2, queue_cap=2)
    reqs = [k.Request(t) for t in k.texts[:5]]
    obs = [adm.submit(reqs[0]), adm.submit(reqs[1]), adm.active(),
           adm.submit(reqs[2]), adm.submit(reqs[3]), len(adm.queue),
           adm.submit(reqs[4])]
    adm.retire(adm.active()[0])
    obs.append(adm.active())
    with pytest.raises(KeyError):
        adm.retire("nope")
    return obs + [adm.stats(), eng.last_stats["admission"]]


def _round_robin_and_drain(k):
    adm = k.engine().admission(num_slots=4, chunk_queue_cap=2)
    for t in k.texts[:3]:
        adm.submit(k.Request(t))
    obs = [adm.offer_chunk(k.chunks[0], tenant="a"),
           adm.offer_chunk(k.chunks[1], tenant="a"),
           adm.offer_chunk(k.chunks[2], tenant="a"),
           adm.offer_chunk(k.chunks[2], tenant="b")]
    while adm.pending_chunks():
        obs.append(_outs(adm.tick()))
    return obs + [adm.tick(), adm.stats()]


def _drain_all_tenants(k):
    adm = k.engine().admission(num_slots=2)
    adm.submit(k.Request(k.texts[0]))
    adm.offer_chunk(k.chunks[0], tenant="x")
    adm.offer_chunk(k.chunks[1], tenant="y")
    return [[_outs(r) for r in adm.drain()], adm.pending_chunks(),
            adm.stats()]


def _retire_tears_down_tenant(k):
    adm = k.engine().admission(num_slots=8, chunk_queue_cap=4)
    names = {}
    for tenant, text in zip(("a", "b", "c"), k.texts[:3]):
        adm.submit(k.Request(text, tenant=tenant))
        names[tenant] = adm.active()[-1]
    adm.submit(k.Request(k.texts[3], tenant="c"))
    second_c = adm.active()[-1]
    for t in ("a", "b", "c"):
        adm.offer_chunk(k.chunks[0], tenant=t)
        adm.offer_chunk(k.chunks[1], tenant=t)
    obs = [_outs(adm.tick())]
    adm.retire(names["a"], drain=False)
    obs += [sorted(adm.chunk_queues), list(adm._rr)]
    obs += [_outs(adm.tick()) for _ in range(5)]
    adm.offer_chunk(k.chunks[0], tenant="c")
    adm.retire(second_c)
    obs += [sorted(adm.chunk_queues), list(adm._rr), adm.pending_chunks()]
    adm.retire(names["c"], drain=True)
    return obs + [list(adm._rr), adm.pending_chunks(), adm.stats()]


def _quarantine(k):
    eng = _StubEngine()
    adm = k.Admission(eng, num_slots=4, max_tenant_faults=2)
    obs = [adm.submit(k.Request("qa", tenant="a", name="qa")),
           adm.submit(k.Request("qb", tenant="b", name="qb")),
           adm.offer_chunk("poison", tenant="a"),
           adm.offer_chunk("poison", tenant="a"),
           adm.offer_chunk("good", tenant="b")]
    while adm.pending_chunks() and "a" not in adm.quarantined:
        obs.append(adm.tick())
    obs += [sorted(eng.registered), adm.drain(), eng.processed,
            adm.offer_chunk("good", tenant="a"),
            adm.submit(k.Request("qa2", tenant="a"))]
    return obs + [adm.stats()]


def _validator(k):
    eng = _StubEngine()
    adm = k.Admission(eng,
                      validator=lambda c: ["bad band"] if c == "bad" else [])
    obs = [adm.submit(k.Request("qa", tenant="t")),
           adm.offer_chunk("bad", tenant="t"),
           adm.offer_chunk("ok", tenant="t"), adm.drain(), eng.processed,
           sorted(adm.quarantined)]
    return obs + [adm.stats()]


def _default_validator(k):
    adm = k.engine().admission(num_slots=2)
    obs = [adm.validator is not None,
           adm.offer_chunk(k.corrupt(k.chunks[0]), tenant="t"),
           adm.offer_chunk(k.chunks[0], tenant="t")]
    return obs + [adm.stats()]


ADMISSION_CASES = {f.__name__.lstrip("_"): f for f in (
    _slots_and_backpressure, _round_robin_and_drain, _drain_all_tenants,
    _retire_tears_down_tenant, _quarantine, _validator, _default_validator)}


# the cases that push chunks through an engine.  There the reference's
# front-end drives the port's engine: a reference engine compiles a
# program per registration, and the served bytes are held to the
# per-query sessions here and in the tests above
SERVING_CASES = ("drain_all_tenants", "retire_tears_down_tenant",
                 "round_robin_and_drain")


def _package(pop, port, case):
    serving = port or case in SERVING_CASES
    return types.SimpleNamespace(
        engine=(lambda: pop.session().serve()) if serving else pop.ref_engine,
        Admission=QueryAdmission if port else RQueryAdmission,
        Request=QueryRequest if port else RQueryRequest, texts=pop.texts,
        chunks=pop.chunks() if serving else pop.world.chunks,
        corrupt=corrupt_batch if port else rcorrupt_batch)


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_equals_reference(pop, case):
    """Both packages' front-ends driven alike: every return value, every
    ``stats()`` and every served chunk's bytes are equal, and the served
    chunks are each query's own session's."""
    run = ADMISSION_CASES[case]
    got = run(_package(pop, True, case))
    assert got == run(_package(pop, False, case))
    own = pop.own[0]
    if case == "round_robin_and_drain":
        # tenant a's two chunks and b's one, served a, b, a
        ticks, chunk_ids = got[4:7], (0, 2, 1)
        assert [t for t, _ in ticks] == ["a", "b", "a"]
    elif case == "drain_all_tenants":
        ticks, chunk_ids = got[0], (0, 1)
    else:
        return
    for (_, outs), i in zip(ticks, chunk_ids):
        assert outs and all(b == own[n][i] for n, b in outs.items())
