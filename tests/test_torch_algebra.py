"""PyTorch port vs the JAX reference: algebra, windows and the engine.

The port runs every window of a chunk in one batched op (``[W, cap, nv]``
binding tables); the reference runs one window at a time.  Each test feeds
W random tables (ids straddling ``2**31`` and the numeric band) to the
port and each table alone to the reference, and compares every window as
``np.uint32`` bytes, including the zeroed rows past the count and the
overflow flags.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algebra as ralg
from repro.core import pattern as rpat
from repro.core import rdf as rrdf
from repro.core import window as rwin
from repro.core.engine import run_plan_windows as r_run_plan_windows
from repro.core.planner import compile_query as r_compile
from repro_torch import interop
from repro_torch.core import algebra as palg
from repro_torch.core import window as pwin
from repro_torch.core.engine import run_plan_windows as p_run_plan_windows
from repro_torch.core.pattern import CompiledPattern, Slot
from repro_torch.core.planner import compile_query as p_compile
from repro_torch.core.rdf import NUM_BASE, Vocab
from repro_torch.core.sparql import parse_query

W = 3
IDS = np.array([1, 2, 3, 4096, 4097, 4098, (1 << 31) - 1, 1 << 31,
                (1 << 31) + 1, 0xFFFFFFFE, NUM_BASE + 10, NUM_BASE + 500,
                NUM_BASE + (1 << 29) + 300], np.uint64)


def u32(x):
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def _tables(seed, cap=24, nv=4, density=0.7):
    rng = np.random.default_rng(seed)
    cols = rng.choice(IDS, size=(W, cap, nv)).astype(np.uint32)
    cols[rng.random((W, cap, nv)) < 0.15] = 0          # unbound columns
    valid = rng.random((W, cap)) < density
    ovf = rng.random(W) < 0.3
    port = interop.bindings_from_arrays(cols, valid, ovf)
    ref = [rpat.Bindings(jnp.asarray(cols[w]), jnp.asarray(valid[w]),
                         jnp.asarray(ovf[w])) for w in range(W)]
    return ref, port


def _check(ref_list, port):
    for w, r in enumerate(ref_list):
        assert u32(r.cols).tobytes() == u32(port.cols[w]).tobytes(), w
        np.testing.assert_array_equal(np.asarray(r.valid), port.valid[w].numpy())
        assert bool(r.overflow) == bool(port.overflow[w])


@pytest.mark.parametrize("shared,out_cap", [((), 40), ((1,), 40), ((1, 2), 7),
                                            ((0,), 600)])
def test_join_union_optional(shared, out_cap):
    ra, pa = _tables(1)
    rb, pb = _tables(2, cap=16)
    _check([ralg.join(a, b, shared, out_cap) for a, b in zip(ra, rb)],
           palg.join(pa, pb, shared, out_cap))
    _check([ralg.optional_join(a, b, shared, out_cap) for a, b in zip(ra, rb)],
           palg.optional_join(pa, pb, shared, out_cap))
    rc, pc = _tables(3)
    _check([ralg.union(a, c, out_cap) for a, c in zip(ra, rc)],
           palg.union(pa, pc, out_cap))


@pytest.mark.parametrize("seed", [4, 5])
def test_filters_project_distinct_canonical(seed):
    ra, pa = _tables(seed, cap=40)
    for op, val in (("lt", NUM_BASE + 400), ("ge", NUM_BASE + 10),
                    ("eq", 4097), ("ne", 1 << 31)):
        _check([ralg.filter_num(a, 1, op, val) for a in ra],
               palg.filter_num(pa, 1, op, val))
    expr = ("or", ("cmp", 0, "ge", NUM_BASE + 400),
            ("and", ("cmp", 2, "lt", NUM_BASE + 500),
             ("not", ("cmp", 0, "lt", NUM_BASE + 20))))
    _check([ralg.filter_bool(a, expr) for a in ra], palg.filter_bool(pa, expr))
    ids = np.asarray([3, 4098, (1 << 31) + 1, 0xFFFFFFFE], np.uint32)
    _check([ralg.filter_in(a, 2, jnp.asarray(ids)) for a in ra],
           palg.filter_in(pa, 2, torch.from_numpy(ids.astype(np.int64))))
    _check([ralg.filter_bound(a, 3) for a in ra], palg.filter_bound(pa, 3))
    _check([ralg.project(a, (0, 2)) for a in ra], palg.project(pa, (0, 2)))
    _check([ralg.distinct(ralg.project(a, (1, 3))) for a in ra],
           palg.distinct(palg.project(pa, (1, 3))))
    _check([ralg.canonical_order(a, (2, 0, 1)) for a in ra],
           palg.canonical_order(pa, (2, 0, 1)))


def test_construct_with_row_nodes():
    ra, pa = _tables(6)
    templates = ((("row", 1 << 18), ("const", 7), ("var", 1)),
                 (("var", 0), ("const", 8), ("var", 3)))
    ts = np.asarray([5, 0, 1 << 31], np.uint32)
    base = np.arange(W, dtype=np.uint32) * 24
    for out_cap in (30, 200):
        got, ovf = palg.construct(pa, templates,
                                  torch.from_numpy(ts.astype(np.int64)),
                                  out_cap, torch.from_numpy(base.astype(np.int64)))
        for w, a in enumerate(ra):
            ref, r_ovf = ralg.construct(a, templates, jnp.uint32(ts[w]), out_cap,
                                        jnp.uint32(base[w]))
            for rc, pc in zip(ref, got):
                assert u32(rc).tobytes() == u32(pc[w]).tobytes()
            assert bool(r_ovf) == bool(ovf[w])


def test_scan_pattern_with_repeated_variable():
    rng = np.random.default_rng(7)
    n = 50
    s = rng.choice(IDS[:6], size=(W, n)).astype(np.uint32)
    o = np.where(rng.random((W, n)) < 0.3, s, rng.choice(IDS, size=(W, n)))
    p = rng.integers(1, 3, size=(W, n)).astype(np.uint32)
    valid = rng.random((W, n)) < 0.9
    zero = np.zeros((W, n), np.uint32)
    batch = interop.triples_from_arrays(s, p, o, zero, zero, valid)
    for pat in (CompiledPattern(Slot.free(0), Slot.const_(1), Slot.free(0)),
                CompiledPattern(Slot.free(1), Slot.free(2), Slot.free(0))):
        got = palg.scan_pattern(batch, pat, 3, 20)
        for w in range(W):
            win = rrdf.TripleBatch(*(jnp.asarray(c[w]) for c in
                                     (s, p, o.astype(np.uint32), zero, zero)),
                                   jnp.asarray(valid[w]))
            ref = ralg.scan_pattern(win, pat, 3, 20)
            assert u32(ref.cols).tobytes() == u32(got.cols[w]).tobytes()
            np.testing.assert_array_equal(np.asarray(ref.valid),
                                          got.valid[w].numpy())
            assert bool(ref.overflow) == bool(got.overflow[w])


def _stream(seed, n=120, graphs=40):
    rng = np.random.default_rng(seed)
    graph = np.sort(rng.integers(1, graphs, size=n)).astype(np.uint32)
    cols = [rng.choice(IDS, size=n).astype(np.uint32) for _ in range(3)]
    valid = np.arange(n) < n - 9
    return cols, graph.copy(), graph, valid


@pytest.mark.parametrize("cap,max_windows", [(16, 4), (10, 20), (5, 30)])
def test_count_windows_match_reference(cap, max_windows):
    cols, ts, graph, valid = _stream(cap)
    ref = rwin.count_windows_jit(rrdf.TripleBatch(
        *(jnp.asarray(c) for c in (*cols, ts, graph)), jnp.asarray(valid)),
        cap, max_windows)
    got = pwin.count_windows(
        interop.triples_from_arrays(*cols, ts, graph, valid), cap, max_windows)
    for rc, pc in zip(ref.triples, got.triples):
        assert u32(rc).tobytes() == u32(pc).tobytes()
    np.testing.assert_array_equal(np.asarray(ref.window_valid),
                                  got.window_valid.numpy())


def test_sliding_count_windows_match_reference():
    """Sliding windows (``step < capacity``) equal the reference's (more
    cases in test_torch_window.py)."""
    cols, ts, graph, valid = _stream(1)
    ref = rwin.count_windows_jit(rrdf.TripleBatch(
        *(jnp.asarray(c) for c in (*cols, ts, graph)), jnp.asarray(valid)),
        16, 4, 8)
    got = pwin.count_windows(interop.triples_from_arrays(
        *cols, ts, graph, valid), 16, 4, step=8)
    for rc, pc in zip(ref.triples, got.triples):
        assert u32(rc).tobytes() == u32(pc).tobytes()
    np.testing.assert_array_equal(np.asarray(ref.window_valid),
                                  got.window_valid.numpy())


def test_engine_runs_a_stream_only_plan_like_the_reference():
    text = """
    PREFIX ex: <urn:ex>
    CONSTRUCT { ?a ex:out ?c . }
    FROM STREAM <stream> [RANGE TRIPLES 16]
    WHERE { ?a ex:p ?b . ?b ex:q ?c . OPTIONAL { ?a ex:r ?d . }
            FILTER(?c >= 1.0) }
    """
    from repro.core import sparql as rsparql

    rv = rrdf.Vocab()
    rq = rsparql.parse_query(text, rv)
    pv = interop.vocab_from_state(rv._pred_to_id, rv._term_to_id,
                                  rv._next_pred, rv._next_term)
    pq = parse_query(text, pv)
    rng = np.random.default_rng(9)
    n, preds = 96, [rv.pred("ex:p"), rv.pred("ex:q"), rv.pred("ex:r")]
    s = rng.choice([4100, 4101, 4102, 4103], size=n).astype(np.uint32)
    o = np.where(rng.random(n) < 0.5, rng.choice([4101, 4102, 4103], size=n),
                 Vocab.number(1.0) + rng.integers(-200, 200, size=n))
    p = rng.choice(preds, size=n).astype(np.uint32)
    graph = np.repeat(np.arange(1, n // 3 + 1), 3).astype(np.uint32)
    valid = np.ones(n, bool)
    caps = dict(scan_cap=32, bind_cap=64, out_cap=64)
    ref_plan = r_compile(rq, **caps)
    port_plan = p_compile(pq, **caps)
    r_w = rwin.count_windows_jit(rrdf.TripleBatch(
        *(jnp.asarray(c.astype(np.uint32)) for c in (s, p, o, graph, graph)),
        jnp.asarray(valid)), 16, 6)
    p_w = pwin.count_windows(interop.triples_from_arrays(
        s, p, o, graph, graph, valid), 16, 6)
    r_out, r_ovf = jax.jit(r_run_plan_windows, static_argnums=(0,))(
        ref_plan, r_w, None, {})
    p_out, p_ovf = p_run_plan_windows(port_plan, p_w, None, {})
    for rc, pc in zip(r_out, p_out):
        assert u32(rc).tobytes() == u32(pc).tobytes()
    np.testing.assert_array_equal(np.asarray(r_ovf), p_ovf.numpy())
    assert int(p_out.valid.sum()) > 0
