"""PyTorch port vs the JAX reference: incremental (delta) evaluation and the
unfused scan join.

* the delta ops (span-tagged scans, eager retraction, window membership),
  with slide spans straddling ``2**31``, as ``np.uint32`` bytes;
* ``plan_supports_delta`` on every operator plan of the four queries;
* the match matrix's plain version against the reference's ``ref.py``
  oracle and its Pallas kernel in interpret mode, and the unfused
  ``kb_join_scan`` against the reference's unfused scan (plain and Pallas);
* whole ``Session`` runs under the queries' own ``RANGE ... STEP`` windows
  and tumbling windows, with and without incremental evaluation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algebra as ralg
from repro.core import pattern as rpat
from repro.core import planner as rplanner
from repro.core import rdf as rrdf
from repro.kernels.hash_join import kernel as r_hj_kernel
from repro.kernels.hash_join import ops as r_hj_ops
from repro.kernels.hash_join import ref as r_hj_ref
from repro_torch import interop
from repro_torch.core import algebra as palg
from repro_torch.core import kb as pkb
from repro_torch.core import planner as pplanner
from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
from repro_torch.kernels.hash_join import ops as p_hj_ops
from repro_torch.kernels.hash_join import ref as p_hj_ref

from test_torch_session import (  # noqa: F401
    CAPS, QUERIES, check_against_reference, one_torch_thread, pworld,
)

K = 0xFFFFFFFF
HIGH = np.array([4096, 4097, 4098, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                 0xFFFFFFFE], np.uint64)
PATTERNS = {
    "bound_const_free": CompiledPattern(Slot.bound(0), Slot.const_(2), Slot.free(1)),
    "free_const_bound": CompiledPattern(Slot.free(1), Slot.const_(2), Slot.bound(0)),
    "bound_free_free": CompiledPattern(Slot.bound(0), Slot.free(1), Slot.free(2)),
    "const_const_free": CompiledPattern(Slot.const_(1 << 31), Slot.const_(1), Slot.free(1)),
    "bound_const_bound": CompiledPattern(Slot.bound(0), Slot.const_(3), Slot.bound(2)),
    "repeated_free": CompiledPattern(Slot.free(1), Slot.const_(2), Slot.free(1)),
    "repeated_bound": CompiledPattern(Slot.bound(0), Slot.free(1), Slot.bound(0)),
}


def u32(x):
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def _same(ref, port: Bindings, w: int = 0):
    assert u32(ref.cols).tobytes() == u32(port.cols[w]).tobytes()
    np.testing.assert_array_equal(np.asarray(ref.valid), port.valid[w].numpy())
    assert bool(ref.overflow) == bool(port.overflow[w])


# --------------------------------------------------------------------------
# delta ops
# --------------------------------------------------------------------------

def _span_table(seed, cap=40, nv=3, base=0):
    """A span-tagged table: slides ``base + [0, 9)`` (``base`` near
    ``2**31`` puts the encoded spans across it), some span-free rows."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((cap, nv + 2), np.uint64)
    cols[:, :nv] = rng.choice(HIGH, size=(cap, nv))
    lo = base + rng.integers(0, 9, size=cap)
    hi = lo + rng.integers(0, 5, size=cap)
    cols[:, nv] = hi + 1
    cols[:, nv + 1] = K - (lo + 1)
    free = rng.random(cap) < 0.2
    cols[free, nv:] = 0
    valid = rng.random(cap) < 0.8
    ref = rpat.Bindings(jnp.asarray(cols.astype(np.uint32)), jnp.asarray(valid),
                        jnp.asarray(False))
    port = interop.bindings_from_arrays(cols.astype(np.uint32), valid, False)
    return ref, port


@pytest.mark.parametrize("base", [0, (1 << 31) - 4, 0xFFFFFFF0 - 8])
@pytest.mark.parametrize("max_span", [0, 2, 3])
def test_delta_retract_matches_reference(base, max_span):
    ref, port = _span_table(base % 97 + max_span, base=base)
    _same(ralg.delta_retract(ref, 3, max_span),
          palg.delta_retract(port, 3, max_span))


@pytest.mark.parametrize("base", [0, (1 << 31) - 4, 0xFFFFFFF0 - 8])
@pytest.mark.parametrize("r", [1, 4])
def test_delta_window_mask_matches_reference(base, r):
    ref, port = _span_table(base % 89 + r, base=base)
    windows = base + np.arange(-2, 12)
    windows = windows[(windows >= 0) & (windows <= 0xFFFFFFFF)]
    got = palg.delta_window_mask(port, 3, torch.from_numpy(windows), r)
    for i, w in enumerate(windows):
        want = ralg.delta_window_mask(ref, 3, jnp.uint32(w), r)
        np.testing.assert_array_equal(np.asarray(want), got[i].numpy())


SCAN_PATTERNS = {       # stream scans: CONST and FREE slots only
    "free_const_free": CompiledPattern(Slot.free(0), Slot.const_(2), Slot.free(1)),
    "free_free_free": CompiledPattern(Slot.free(0), Slot.free(1), Slot.free(2)),
    "repeated_free": PATTERNS["repeated_free"],
    "const_const_free": PATTERNS["const_const_free"],
}


@pytest.mark.parametrize("pat_name", sorted(SCAN_PATTERNS))
@pytest.mark.parametrize("out_cap", [7, 200])
def test_scan_pattern_delta_matches_reference(pat_name, out_cap):
    pat = SCAN_PATTERNS[pat_name]
    rng = np.random.default_rng(out_cap)
    n = 150
    s, o = (rng.choice(HIGH, size=n).astype(np.uint32) for _ in range(2))
    p = rng.integers(1, 4, size=n).astype(np.uint32)
    ts = graph = np.arange(n, dtype=np.uint32)
    valid = np.arange(n) < n - 7
    slide = np.where(rng.random(n) < 0.1, -1, np.arange(n) // 9)
    ref_stream = rrdf.TripleBatch(*(jnp.asarray(c) for c in (s, p, o, ts, graph)),
                                  jnp.asarray(valid))
    ref = ralg.scan_pattern_delta(ref_stream, pat, 3, out_cap,
                                  jnp.asarray(slide.astype(np.int32)))
    got = palg.scan_pattern_delta(
        interop.triples_from_arrays(s, p, o, ts, graph, valid), pat, 3,
        out_cap, torch.from_numpy(slide.astype(np.int64)))
    _same(ref, got)
    ref_u = ralg.delta_universe(16, 3)
    got_u = palg.delta_universe(16, 3)
    _same(ref_u, got_u)


def test_plan_supports_delta_per_operator(pworld):
    expected = {}
    for q in QUERIES:
        for mode in ("monolithic", "single_program"):
            ref_reg = pworld.ref_registered(q, mode, "auto")
            reg = pworld.port_register(q, mode, "auto")
            for name, op in reg.operators.items():
                ref_plan = ref_reg.operators[name].plan
                got = pplanner.plan_supports_delta(op.plan)
                assert got == rplanner.plan_supports_delta(ref_plan), (q, name)
                expected[(q, mode, name)] = got
    # CQuery1's OPTIONAL keeps its monolithic plan on recompute; Q15 runs
    # delta whole
    assert not expected[("cquery1", "monolithic", "cquery1")]
    assert expected[("q15", "monolithic", "q15")]


# --------------------------------------------------------------------------
# the match matrix and the unfused scan join
# --------------------------------------------------------------------------

def _world(m=24, n=130, nv=3, seed=0, windows=2, empty_kb=False):
    """Bindings and a KB over ids straddling ``2**31``; a few ``s == o``
    KB rows for the repeated-variable patterns."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(HIGH, size=(windows, m, nv)).astype(np.uint32)
    bvalid = rng.random((windows, m)) < 0.85
    rows = [(int(rng.choice(HIGH)), int(rng.integers(1, 4)), int(rng.choice(HIGH)))
            for _ in range(0 if empty_kb else n - 4)]
    if not empty_kb:
        rows += [(int(v), 2, int(v)) for v in HIGH[:4]]
    from repro.core import kb as rkb
    ref_kb = rkb.kb_from_triples(rows, capacity=n + 3)
    port_kb = interop.kb_from_arrays({f: np.asarray(getattr(ref_kb, f))
                                      for f in ref_kb._fields})
    ref_binds = [rpat.Bindings(jnp.asarray(cols[w]), jnp.asarray(bvalid[w]),
                               jnp.asarray(w == 1)) for w in range(windows)]
    port_bind = interop.bindings_from_arrays(cols, bvalid,
                                             np.arange(windows) == 1)
    return ref_binds, ref_kb, port_bind, port_kb


@pytest.mark.parametrize("pat_name", sorted(PATTERNS))
@pytest.mark.parametrize("empty_kb", [False, True])
def test_match_matrix_plain_matches_reference(pat_name, empty_kb):
    pat = PATTERNS[pat_name]
    ref_binds, ref_kb, port_bind, port_kb = _world(
        seed=len(pat_name), empty_kb=empty_kb)
    got = p_hj_ops.match_matrix(port_bind, port_kb, pat)
    assert got.dtype == torch.bool and got.shape == (2, 24, port_kb.capacity)
    for w, rb in enumerate(ref_binds):
        args = (rb.cols, rb.valid, ref_kb.s_ps, ref_kb.p_ps, ref_kb.o_ps,
                ref_kb.valid)
        want = np.asarray(r_hj_ref.match_matrix_ref(*args, pat))
        np.testing.assert_array_equal(want, got[w].numpy())
        np.testing.assert_array_equal(want, p_hj_ref.match_matrix_ref(
            port_bind.cols[w], port_bind.valid[w], port_kb.s_ps, port_kb.p_ps,
            port_kb.o_ps, port_kb.valid, pat).numpy())
    if not empty_kb:
        assert got.any()


@pytest.mark.parametrize("pat_name", ["bound_const_free", "repeated_free",
                                      "repeated_bound", "const_const_free"])
def test_match_matrix_matches_the_pallas_kernel_in_interpret_mode(pat_name):
    pat = PATTERNS[pat_name]
    ref_binds, ref_kb, port_bind, port_kb = _world(m=13, n=125, windows=1)
    rb = ref_binds[0]
    pallas = r_hj_kernel.match_matrix_pallas(
        jnp.pad(rb.cols, ((0, 3), (0, 0))), jnp.pad(rb.valid, (0, 3)),
        *(jnp.pad(c, (0, 128 - ref_kb.capacity)) for c in
          (ref_kb.s_ps, ref_kb.p_ps, ref_kb.o_ps, ref_kb.valid)),
        pat, bm=8, bn=128, interpret=True)
    assert pallas.dtype == jnp.int8
    got = p_hj_ops.match_matrix(port_bind, port_kb, pat)[0]
    np.testing.assert_array_equal(
        np.asarray(pallas)[:13, :ref_kb.capacity].astype(bool), got.numpy())


@pytest.mark.parametrize("pat_name", sorted(PATTERNS))
@pytest.mark.parametrize("out_cap", [5, 300])
def test_unfused_scan_join_matches_reference(pat_name, out_cap):
    pat = PATTERNS[pat_name]
    ref_binds, ref_kb, port_bind, port_kb = _world(seed=out_cap + len(pat_name))
    got = palg.kb_join_scan(port_bind, port_kb, pat, out_cap,
                            fuse_compaction=False)
    fused = palg.kb_join_scan(port_bind, port_kb, pat, out_cap)
    for a, b in zip(got, fused):
        assert torch.equal(a, b)
    for w, rb in enumerate(ref_binds):
        _same(ralg.kb_join_scan(rb, ref_kb, pat, out_cap), got, w)


@pytest.mark.parametrize("pat_name", ["bound_const_free", "repeated_free"])
def test_unfused_scan_join_matches_the_pallas_path(pat_name):
    pat = PATTERNS[pat_name]
    ref_binds, ref_kb, port_bind, port_kb = _world(m=16, n=125, windows=1)
    ref = ralg.kb_join_scan(ref_binds[0], ref_kb, pat, 40, use_pallas=True,
                            bm=8, bn=128, interpret=True)
    _same(ref, palg.kb_join_scan(port_bind, port_kb, pat, 40,
                                 fuse_compaction=False))


def test_unfused_compaction_scans_in_row_blocks(monkeypatch):
    """With the scan block cut to a few rows, the row-major matches and the
    early stop past ``out_cap`` give the same bytes."""
    pat = PATTERNS["bound_free_free"]
    _, _, port_bind, port_kb = _world(m=30, n=130)
    want = palg.kb_join_scan(port_bind, port_kb, pat, 25)
    monkeypatch.setattr(palg, "COMPACT_BLOCK", 3 * 130 + 7)
    got = palg.kb_join_scan(port_bind, port_kb, pat, 25,
                            fuse_compaction=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got.overflow.all())


@pytest.mark.parametrize("group", [1, 2, 5])
def test_unfused_join_launches_windows_in_groups(monkeypatch, group):
    """The match matrix covers ``MM_LAUNCH_BYTES // (M * N)`` windows per
    call: one call for every window when they fit, else ragged groups,
    with the same bytes as the fused join."""
    pat = PATTERNS["bound_const_free"]
    _, _, port_bind, port_kb = _world(m=20, n=130, windows=5)
    want = palg.kb_join_scan(port_bind, port_kb, pat, 60)
    calls = []
    mm = p_hj_ops.match_matrix

    def counted(bind, kb, p):
        calls.append(bind.cols.shape[0])
        return mm(bind, kb, p)

    monkeypatch.setattr(p_hj_ops, "match_matrix", counted)
    monkeypatch.setattr(palg, "MM_LAUNCH_BYTES",
                        group * 20 * port_kb.capacity + 19)
    got = palg.kb_join_scan(port_bind, port_kb, pat, 60,
                            fuse_compaction=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert calls == [min(group, 5 - g0) for g0 in range(0, 5, group)]


def test_delta_chain_carries_span_columns_through_kb_joins():
    """KB joins treat the two span columns as opaque words, values near
    ``2**32`` included, in every join route."""
    ref, port = _span_table(5, base=0xFFFFFFF0 - 8)
    kb_rows = [(int(v), 2, int(w)) for v in HIGH for w in HIGH[:3]]
    from repro.core import kb as rkb
    ref_kb = rkb.kb_from_triples(kb_rows, capacity=40)
    port_kb = interop.kb_from_arrays({f: np.asarray(getattr(ref_kb, f))
                                      for f in ref_kb._fields})
    pat = PATTERNS["bound_const_free"]
    want = ralg.kb_join_scan(ref, ref_kb, pat, 64, fuse_compaction=True)
    for fuse in (True, False):
        _same(want, palg.kb_join(port, port_kb, pat, 64, "scan",
                                 fuse_compaction=fuse))
    _same(ralg.kb_join_probe(ref, ref_kb, pat, 64, 8, fuse_compaction=True),
          palg.kb_join(port, port_kb, pat, 64, "probe", 8))


# --------------------------------------------------------------------------
# whole sessions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
@pytest.mark.parametrize("incremental", [False, True])
def test_window_from_query_session_equals_reference(pworld, q, mode,
                                                    incremental):
    """The queries' own windows: ``RANGE TRIPLES 1000 STEP 1`` (Q15, Q16,
    CQuery1) and ``RANGE TRIPLES 256 STEP 64`` (artist_classes).  Slides of
    one triple cut every tweet to its first triple, so CQuery1, which
    joins four triples of one tweet, finds nothing, in both packages."""
    reg, _ = check_against_reference(pworld, q, mode, "auto",
                                     expect_output=q != "cquery1",
                                     window_from_query=True,
                                     incremental=incremental)
    assert reg.config.window_step == (64 if q == "artist_classes" else 1)


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
def test_tumbling_incremental_session_equals_reference(pworld, q, mode):
    """Incremental evaluation over tumbling windows (one slide a window).
    single_program takes the delta split sink where the reference does: on
    every query but CQuery1, whose OPTIONAL keeps the augmented window."""
    reg, _ = check_against_reference(pworld, q, mode, "auto",
                                     incremental=True)
    if mode == "single_program":
        assert reg.runtime.sink_kind == (
            "augmented" if q == "cquery1" else "split-delta")
