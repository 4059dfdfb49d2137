"""PyTorch port vs the JAX reference: the four kernels' plain versions.

* each plain version against the reference ``ref.py`` oracles and the
  reference's fused jnp twins, byte for byte;
* one tiny case per kernel against the reference Pallas kernel in
  interpret mode, as the reference's own tests run it;
* the edge cases: past ``out_cap``, fan-out past ``k_max``, an empty
  binding table, sizes that are not tile multiples, duplicate keys,
  composite-key collisions and repeated variables;
* the probe join's edge worlds (``probe_edge_worlds.py``, which the card
  tests and ``chip_smoke.py`` hold the CUDA kernel to) and the descendants
  step at the card tests' sizes, against the reference.

The CUDA kernels against their plain versions are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kb as rkb
from repro.core import pattern as rpat
from repro.kernels.closure import kernel as r_cl_kernel
from repro.kernels.closure import ops as r_cl_ops
from repro.kernels.closure import ref as r_cl_ref
from repro.kernels.hash_join import ops as r_hj_ops
from repro.kernels.hash_join import ref as r_hj_ref
from repro_torch import interop
from repro_torch.core import kb as pkb
from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
from repro_torch.core.rdf import composite_key
from repro_torch.kernels import _cuda
from repro_torch.kernels.closure import kernel as p_cl_kernel
from repro_torch.kernels.closure import ops as p_cl_ops
from repro_torch.kernels.closure import ref as p_cl_ref
from repro_torch.kernels.hash_join import kernel as p_hj_kernel
from repro_torch.kernels.hash_join import ops as p_hj_ops
from repro_torch.kernels.hash_join import ref as p_hj_ref

import probe_edge_worlds as pew     # tests/ helper (on sys.path via conftest)

BASE = 5000
PATTERNS = {
    "bound_const_free": CompiledPattern(Slot.bound(0), Slot.const_(2), Slot.free(1)),
    "free_const_bound": CompiledPattern(Slot.free(1), Slot.const_(2), Slot.bound(0)),
    "bound_free_free": CompiledPattern(Slot.bound(0), Slot.free(1), Slot.free(2)),
    "const_const_free": CompiledPattern(Slot.const_(BASE + 3), Slot.const_(1), Slot.free(1)),
    "bound_const_bound": CompiledPattern(Slot.bound(0), Slot.const_(3), Slot.bound(2)),
    "repeated_free": CompiledPattern(Slot.free(1), Slot.const_(2), Slot.free(1)),
    # a predicate no KB row has, and ?a ?b ?c (no BOUND slot: a cross product)
    "absent_const": CompiledPattern(Slot.bound(0), Slot.const_(9), Slot.free(1)),
    "all_free": CompiledPattern(Slot.free(0), Slot.free(1), Slot.free(2)),
}
PROBE_PATTERNS = [k for k in PATTERNS if k not in ("bound_free_free",
                                                    "repeated_free",
                                                    "all_free")]


def u32(x):
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def _world(m=32, n=128, nv=3, seed=0, spread=30, windows=2):
    """Random bindings (``windows`` tables) and a KB over a small id range,
    so joins hit, repeat keys and (with ``spread`` small) fan out."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(BASE, BASE + spread, size=(windows, m, nv)).astype(np.uint32)
    bvalid = rng.random((windows, m)) < 0.9
    kb_rows = [(int(rng.integers(BASE, BASE + spread)), int(rng.integers(1, 4)),
                int(rng.integers(BASE, BASE + spread))) for _ in range(n - 4)]
    for i in range(4):                 # a few s == o rows for ?x p ?x
        kb_rows.append((BASE + i, 2, BASE + i))
    ref_kb = rkb.kb_from_triples(kb_rows, capacity=n + 5)
    port_kb = interop.kb_from_arrays({f: np.asarray(getattr(ref_kb, f))
                                      for f in ref_kb._fields})
    ref_binds = [rpat.Bindings(jnp.asarray(cols[w]), jnp.asarray(bvalid[w]),
                               jnp.zeros((), bool)) for w in range(windows)]
    port_bind = interop.bindings_from_arrays(cols, bvalid,
                                             np.zeros(windows, bool))
    return ref_binds, ref_kb, port_bind, port_kb


def _assert_window(ref, port: Bindings, w: int):
    rows, valid, ovf = ref
    assert u32(rows).tobytes() == u32(port.cols[w]).tobytes()
    np.testing.assert_array_equal(np.asarray(valid), port.valid[w].numpy())
    assert bool(ovf) == bool(port.overflow[w])


def _unbatched(port_ref):
    rows, valid, ovf = port_ref
    return Bindings(rows[None], valid[None], ovf.reshape(1))


@pytest.mark.parametrize("pat_name", sorted(PATTERNS))
@pytest.mark.parametrize("out_cap", [5, 64, 400])
def test_scan_join_plain_matches_reference(pat_name, out_cap):
    pat = PATTERNS[pat_name]
    ref_binds, ref_kb, port_bind, port_kb = _world(seed=len(pat_name) + out_cap)
    twin = p_hj_ops.join_compact_torch(port_bind, port_kb, pat, out_cap)
    for w, rb in enumerate(ref_binds):
        args = (rb.cols, rb.valid, ref_kb.s_ps, ref_kb.p_ps, ref_kb.o_ps,
                ref_kb.valid)
        oracle = r_hj_ref.join_compact_ref(*args, pat, out_cap)
        _assert_window(oracle, twin, w)
        jnp_twin = r_hj_ops.join_compact_jnp(rb, ref_kb, pat, out_cap)
        _assert_window((jnp_twin.cols, jnp_twin.valid, jnp_twin.overflow),
                       twin, w)
        port_oracle = p_hj_ref.join_compact_ref(
            port_bind.cols[w], port_bind.valid[w], port_kb.s_ps, port_kb.p_ps,
            port_kb.o_ps, port_kb.valid, pat, out_cap)
        _assert_window(oracle, _unbatched(port_oracle), 0)
        np.testing.assert_array_equal(
            np.asarray(r_hj_ref.match_matrix_ref(*args, pat)),
            p_hj_ref.match_matrix_ref(
                port_bind.cols[w], port_bind.valid[w], port_kb.s_ps,
                port_kb.p_ps, port_kb.o_ps, port_kb.valid, pat).numpy())


@pytest.mark.parametrize("pat_name", PROBE_PATTERNS)
@pytest.mark.parametrize("out_cap,k_max", [(6, 8), (300, 8), (300, 2)])
def test_probe_join_plain_matches_reference(pat_name, out_cap, k_max):
    pat = PATTERNS[pat_name]
    ref_binds, ref_kb, port_bind, port_kb = _world(seed=3 + out_cap + k_max)
    twin = p_hj_ops.probe_compact_torch(port_bind, port_kb, pat, out_cap, k_max)
    keys, (vs, vp, vo), _, anchor_is_s = rkb.probe_view(ref_kb, pat)
    pkeys, (pvs, pvp, pvo), _, _ = pkb.probe_view(port_kb, pat)
    for w, rb in enumerate(ref_binds):
        oracle = r_hj_ref.probe_compact_ref(
            rb.cols, rb.valid, vs, vp, vo, keys, pat, anchor_is_s, out_cap,
            k_max)
        _assert_window(oracle, twin, w)
        jnp_twin = r_hj_ops.probe_compact_jnp(rb, ref_kb, pat, out_cap, k_max)
        _assert_window((jnp_twin.cols, jnp_twin.valid, jnp_twin.overflow),
                       twin, w)
        port_oracle = p_hj_ref.probe_compact_ref(
            port_bind.cols[w], port_bind.valid[w], pvs, pvp, pvo, pkeys, pat,
            anchor_is_s, out_cap, k_max)
        _assert_window(oracle, _unbatched(port_oracle), 0)


def test_probe_overflow_sources_are_both_reported():
    pat = PATTERNS["bound_const_free"]
    _, ref_kb, port_bind, port_kb = _world(spread=4, n=200)
    stats = pkb.collect_kb_stats(port_kb)
    assert stats.preds[2].k_ps > 2
    fan_only = p_hj_ops.probe_compact_torch(port_bind, port_kb, pat, 4096, 2)
    clip_only = p_hj_ops.probe_compact_torch(port_bind, port_kb, pat, 3, 64)
    wide = p_hj_ops.probe_compact_torch(port_bind, port_kb, pat, 4096, 64)
    assert fan_only.overflow.all() and clip_only.overflow.all()
    assert not wide.overflow.any()


def test_empty_bindings_and_non_tile_sizes():
    for pat in (PATTERNS["bound_const_free"], PATTERNS["free_const_bound"]):
        ref_binds, ref_kb, port_bind, port_kb = _world(m=37, n=301, windows=3)
        empty = port_bind._replace(valid=torch.zeros_like(port_bind.valid))
        for fn in (lambda b: p_hj_ops.join_compact_torch(b, port_kb, pat, 50),
                   lambda b: p_hj_ops.probe_compact_torch(b, port_kb, pat, 50)):
            got = fn(empty)
            assert not got.valid.any() and not got.overflow.any()
            assert not got.cols.any()
        twin = p_hj_ops.join_compact_torch(port_bind, port_kb, pat, 97)
        for w, rb in enumerate(ref_binds):
            ref = r_hj_ops.join_compact_jnp(rb, ref_kb, pat, 97)
            _assert_window((ref.cols, ref.valid, ref.overflow), twin, w)


def test_probe_composite_key_collisions_are_rechecked():
    """Numeric literals whose composite keys collide: the probe gathers
    both and keeps only exact matches, as the reference does."""
    nums = [(1 << 30) + (1 << 29) + 77 + 5 * i for i in range(8)]
    mask = (1 << 20) - 1
    coll = []
    for t in nums:
        hi = t >> 20
        coll.append(((hi + 1) << 20) | ((t & mask) ^ (hi & mask) ^ ((hi + 1) & mask)))
    assert all(int(composite_key(3, a)) == int(composite_key(3, b))
               for a, b in zip(nums, coll))
    rows = [(BASE + i, 3, t) for i, t in enumerate(nums + coll + nums)]
    ref_kb = rkb.kb_from_triples(rows)
    port_kb = interop.kb_from_arrays({f: np.asarray(getattr(ref_kb, f))
                                      for f in ref_kb._fields})
    cols = np.asarray([[t, 0] for t in nums + coll], np.uint32)
    valid = np.ones(len(cols), bool)
    pat = CompiledPattern(Slot.free(1), Slot.const_(3), Slot.bound(0))
    ref = r_hj_ops.probe_compact_jnp(
        rpat.Bindings(jnp.asarray(cols), jnp.asarray(valid),
                      jnp.zeros((), bool)), ref_kb, pat, 64, 8)
    twin = p_hj_ops.probe_compact_torch(
        interop.bindings_from_arrays(cols, valid, False), port_kb, pat, 64, 8)
    _assert_window((ref.cols, ref.valid, ref.overflow), twin, 0)
    assert int(twin.valid.sum()) == 3 * len(nums)


def test_tiny_cases_match_the_pallas_kernels_in_interpret_mode():
    ref_binds, ref_kb, port_bind, port_kb = _world(m=16, n=128, windows=1)
    rb = ref_binds[0]
    pat = PATTERNS["bound_const_free"]
    pallas = r_hj_ops.join_compact(rb, ref_kb, pat, 40, bm=8, bn=128)
    _assert_window((pallas.cols, pallas.valid, pallas.overflow),
                   p_hj_ops.join_compact_torch(port_bind, port_kb, pat, 40), 0)
    pallas = r_hj_ops.probe_compact(rb, ref_kb, pat, 40, 8, bm=8)
    _assert_window((pallas.cols, pallas.valid, pallas.overflow),
                   p_hj_ops.probe_compact_torch(port_bind, port_kb, pat, 40, 8), 0)
    rng = np.random.default_rng(2)
    reach = np.minimum((rng.random((128, 128)) < 0.03) + np.eye(128), 1)
    reach = reach.astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(r_cl_kernel.closure_step_pallas(jnp.asarray(reach))),
        p_cl_ref.closure_step_ref(torch.from_numpy(reach)).numpy())
    for cap in (128, 5):
        ids, count = r_cl_kernel.descendants_pallas(
            jnp.asarray(reach), jnp.asarray(reach[:, 7]), cap)
        p_ids, p_count = p_cl_ref.descendants_step_ref(
            torch.from_numpy(reach), torch.from_numpy(reach[:, 7].copy()), cap)
        np.testing.assert_array_equal(np.asarray(ids), p_ids.numpy())
        assert int(count) == int(p_count)


def _hierarchy(n=150, seed=0):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), np.float32)
    for i in range(1, n):                   # a DAG: edges to earlier nodes
        for j in rng.choice(i, size=min(i, 2), replace=False):
            if rng.random() < 0.7:
                adj[i, j] = 1.0
    return adj


@pytest.mark.parametrize("root,out_cap", [(0, 150), (3, 150), (0, 20)])
def test_closure_ops_match_reference(root, out_cap):
    adj = _hierarchy()
    ref_ids, ref_count = r_cl_ops.closure_descendants(
        jnp.asarray(adj), root, out_cap, use_pallas=False)
    ids, count = p_cl_ops.closure_descendants(adj, root, out_cap)
    np.testing.assert_array_equal(np.asarray(ref_ids), ids.numpy())
    assert int(ref_count) == int(count)
    o_ids, o_count = r_cl_ref.descendants_ref(jnp.asarray(adj), root, 8, out_cap)
    p_ids, p_count = p_cl_ref.descendants_ref(torch.from_numpy(adj), root, 8,
                                              out_cap)
    np.testing.assert_array_equal(np.asarray(o_ids), p_ids.numpy())
    assert int(o_count) == int(p_count)
    a_ref = r_cl_ops.closure_ancestors(jnp.asarray(adj), root + 40, out_cap,
                                       use_pallas=False)
    a_port = p_cl_ops.closure_ancestors(adj, root + 40, out_cap)
    np.testing.assert_array_equal(np.asarray(a_ref[0]), a_port[0].numpy())
    assert int(a_ref[1]) == int(a_port[1])


def test_transitive_closure_matches_reference():
    adj = _hierarchy(n=90, seed=1)
    ref = r_cl_ops.transitive_closure(jnp.asarray(adj), use_pallas=False)
    port = p_cl_ops.transitive_closure(adj)
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
    r = np.minimum(adj + np.eye(90, dtype=np.float32), 1)
    np.testing.assert_array_equal(
        np.asarray(r_cl_ref.closure_step_ref(jnp.asarray(r))),
        p_cl_ref.closure_step_ref(torch.from_numpy(r)).numpy())


def test_cpu_tensors_take_the_plain_versions_and_kernels_refuse_them():
    before = dict(_cuda.LAUNCHES)
    _, _, port_bind, port_kb = _world()
    pat = PATTERNS["bound_const_free"]
    p_hj_ops.join_compact(port_bind, port_kb, pat, 32)
    p_hj_ops.probe_compact(port_bind, port_kb, pat, 32)
    p_hj_ops.match_matrix(port_bind, port_kb, pat)
    p_cl_ops.closure_descendants(_hierarchy(n=40), 0, 40)
    assert _cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        words = port_kb.words
        p_hj_kernel.join_compact_cuda(
            port_bind.cols, port_bind.valid, words.s_ps, words.p_ps,
            words.o_ps, words.valid, pat, 32)
    with pytest.raises(ValueError, match="CUDA"):
        p_hj_kernel.match_matrix_cuda(
            port_bind.cols, port_bind.valid, words.s_ps, words.p_ps,
            words.o_ps, words.valid, pat)
    with pytest.raises(ValueError, match="CUDA"):
        p_cl_kernel.closure_step_cuda(torch.zeros((64, 64)))


def test_pattern_args_encode_modes_and_repeats():
    args, eq = p_hj_kernel.pattern_args(PATTERNS["repeated_free"])
    assert args == [2, 0, 1, 0, 2, -1, 2, 0, 1] and eq == [0, 1, 0]
    args, eq = p_hj_kernel.pattern_args(
        CompiledPattern(Slot.const_(0xFFFFFFFF), Slot.const_(2), Slot.bound(4)))
    assert args[:3] == [0, 0xFFFFFFFF, -1] and eq == [0, 0, 0]


# the worlds with binding rows: at M = 0 neither the twin nor the reference
# has a row to gather from (the card test holds the kernel to the contract)
PROBE_EDGES = {e.tag: e for e in pew.probe_edge_worlds() if e.cols.shape[1]}


@pytest.fixture(scope="module")
def probe_edges():
    """Every probe edge world on both sides: the port's KB and batched
    bindings, and the reference's KB holding the same arrays (built from
    the port's, so no JAX program is compiled per KB size)."""
    built = {}
    for tag, e in PROBE_EDGES.items():
        r = e.kb_rows
        port_kb = pkb.build_kb(r[:, 0], r[:, 1], r[:, 2], e.capacity)
        ref_kb = rkb.KnowledgeBase(**{
            f: jnp.asarray(getattr(port_kb, f).numpy().astype(
                bool if f == "valid" else np.uint32))
            for f in rkb.KnowledgeBase._fields})
        port_bind = interop.bindings_from_arrays(e.cols, e.valid, e.overflow)
        built[tag] = ref_kb, port_bind, port_kb
    return built


@pytest.mark.parametrize("tag", sorted(PROBE_EDGES))
def test_probe_edge_worlds_twin_matches_reference(probe_edges, tag):
    """The plain twin against the reference's fused jnp probe (jitted once
    per world, vmapped over its windows) on every probe edge world."""
    import jax

    e = PROBE_EDGES[tag]
    ref_kb, port_bind, port_kb = probe_edges[tag]
    twin = p_hj_ops.probe_compact_torch(
        port_bind, port_kb, pew.pattern(e.pattern, Slot, CompiledPattern),
        e.out_cap, e.k_max)
    w, _, nv = e.cols.shape
    assert twin.cols.shape == (w, e.out_cap, nv)
    pat = pew.pattern(e.pattern, rpat.Slot, rpat.CompiledPattern)
    ref = jax.jit(jax.vmap(
        lambda c, v, o: r_hj_ops.probe_compact_jnp(
            rpat.Bindings(c, v, o), ref_kb, pat, e.out_cap, e.k_max)))(
        jnp.asarray(e.cols), jnp.asarray(e.valid), jnp.asarray(e.overflow))
    for i in range(w):
        _assert_window((ref.cols[i], ref.valid[i], ref.overflow[i]), twin, i)


def test_descendants_step_plain_matches_reference():
    """The plain step on ``R = min(adj + I, 1)`` and a column view of it is
    the reference's one-squaring descendants oracle, at the card tests'
    most ragged size (1100 rows: 35 words over a cluster of 8 blocks)."""
    n = 1100
    adj = _hierarchy(n=n, seed=n)
    reach = torch.clamp_max(torch.from_numpy(adj) + torch.eye(n), 1.0)
    import jax

    cap = 40
    oracle = jax.jit(r_cl_ref.descendants_ref, static_argnums=(2, 3))
    counts = []
    for root in (0, 7, n // 2, n - 1):
        ids, count = p_cl_ref.descendants_step_ref(reach, reach[:, root], cap)
        r_ids, r_count = oracle(jnp.asarray(adj), root, 1, cap)
        np.testing.assert_array_equal(np.asarray(r_ids), ids.numpy())
        assert int(r_count) == int(count)
        counts.append(int(count))
    assert min(counts) < cap < max(counts)      # both sides of out_cap
