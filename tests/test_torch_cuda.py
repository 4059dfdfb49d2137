"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips where no CUDA device
is visible (the kernels have no CPU mode).  The file imports neither JAX
nor the JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

The DSCEP kernels' outputs are integer ids and 0/1 matrices: those
comparisons are exact.  The attention kernels compare floats: float32
within 1e-4 absolute (sums in another order), bfloat16 within 2e-2
absolute plus 1e-2 relative (one bf16 rounding of the output: 2^-8 to
2^-7 of its magnitude, the two sides rounding the same f32 value on
either side of a boundary).  The SSD kernel's float32 outputs and final
state are held within 2e-4 absolute and relative (the reference's own SSD
tolerance: the chunked cumsum sums in another order), its bfloat16
outputs as the attention kernels'.
"""
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
from unittest import mock

import os

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import algebra as palg
from repro_torch.core import kb as pkb
from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
from repro_torch.kernels import _cuda
from repro_torch.kernels.closure import kernel as p_cl_kernel
from repro_torch.kernels.closure import ops as p_cl_ops
from repro_torch.kernels.closure import ref as p_cl_ref
from repro_torch.kernels.hash_join import kernel as p_hj_kernel
from repro_torch.kernels.hash_join import ops as p_hj_ops
from repro_torch.kernels.decode_attention import ops as p_da_ops
from repro_torch.kernels.decode_attention import ref as p_da_ref
from repro_torch.kernels.flash_attention import ops as p_fa_ops
from repro_torch.kernels.flash_attention import ref as p_fa_ref
from repro_torch.kernels.ssd import kernel as p_ssd_kernel
from repro_torch.kernels.ssd import ops as p_ssd_ops
from repro_torch.kernels.ssd import ref as p_ssd_ref

import probe_edge_worlds as pew     # tests/ helper, beside this file

BASE = 5000
PATTERNS = {
    "bound_const_free": CompiledPattern(Slot.bound(0), Slot.const_(2), Slot.free(1)),
    "free_const_bound": CompiledPattern(Slot.free(1), Slot.const_(2), Slot.bound(0)),
    "bound_free_free": CompiledPattern(Slot.bound(0), Slot.free(1), Slot.free(2)),
    "const_const_free": CompiledPattern(Slot.const_(BASE + 3), Slot.const_(1), Slot.free(1)),
    "bound_const_bound": CompiledPattern(Slot.bound(0), Slot.const_(3), Slot.bound(2)),
    "repeated_free": CompiledPattern(Slot.free(1), Slot.const_(2), Slot.free(1)),
    "repeated_bound": CompiledPattern(Slot.bound(0), Slot.free(1), Slot.bound(0)),
    # a predicate no KB row has, and ?a ?b ?c (no BOUND slot: a cross product)
    "absent_const": CompiledPattern(Slot.bound(0), Slot.const_(9), Slot.free(1)),
    "all_free": CompiledPattern(Slot.free(0), Slot.free(1), Slot.free(2)),
}
PROBE_PATTERNS = [k for k in PATTERNS if k not in ("bound_free_free",
                                                    "repeated_free",
                                                    "repeated_bound",
                                                    "all_free")]
HIGH = np.array([4096, 4097, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                 0xFFFFFFFE], np.uint64)
QUERY_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "queries")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _world(m=300, n=5000, nv=3, seed=0, spread=60, windows=3):
    """Random bindings and a KB over a small id range, so joins hit, repeat
    keys and fan out (the plain versions' inputs, on the CPU)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(BASE, BASE + spread, size=(windows, m, nv)).astype(np.uint32)
    bvalid = rng.random((windows, m)) < 0.9
    rows = np.stack([rng.integers(BASE, BASE + spread, n - 4),
                     rng.integers(1, 4, n - 4),
                     rng.integers(BASE, BASE + spread, n - 4)], axis=1)
    loops = [(BASE + i, 2, BASE + i) for i in range(4)]   # ?x p ?x rows
    kb = pkb.kb_from_triples(np.concatenate([rows, loops]), capacity=n + 5)
    bind = interop.bindings_from_arrays(cols, bvalid, np.zeros(windows, bool))
    return bind, kb


def _high_world(m=301, n=5003, windows=3, seed=1, kb_rows=None):
    """Bindings and a KB over ids straddling ``2**31`` (sizes off the
    kernel's tiles), with ``s == o`` rows for the repeated variables."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(HIGH, size=(windows, m, 3)).astype(np.uint32)
    bvalid = rng.random((windows, m)) < 0.9
    n = n if kb_rows is None else kb_rows
    rows = np.stack([rng.choice(HIGH, n), rng.integers(1, 4, n),
                     rng.choice(HIGH, n)], axis=1).astype(np.uint32)
    rows[: min(n, 6), 1] = 2
    rows[: min(n, 6), 2] = rows[: min(n, 6), 0]
    kb = pkb.kb_from_triples(rows, capacity=max(n, 1) + 5)
    return interop.bindings_from_arrays(cols, bvalid, np.zeros(windows, bool)), kb


def _to(b: Bindings, dev) -> Bindings:
    return Bindings(*(t.to(dev) for t in b))


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("pat_name", sorted(PATTERNS))
def test_scan_join_kernel_matches_plain(card, pat_name):
    bind, kb = _world()
    pat = PATTERNS[pat_name]
    for out_cap in (7, 2000):
        before = _cuda.LAUNCHES["join_compact"]
        _same(p_hj_ops.join_compact(_to(bind, card), kb.to(card), pat, out_cap),
              p_hj_ops.join_compact_torch(bind, kb, pat, out_cap))
        assert _cuda.LAUNCHES["join_compact"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("pat_name", PROBE_PATTERNS)
def test_probe_join_kernel_matches_plain(card, pat_name):
    bind, kb = _world()
    pat = PATTERNS[pat_name]
    for out_cap, k_max in ((7, 8), (2000, 2), (2000, 64)):
        before = _cuda.LAUNCHES["probe_compact"]
        _same(p_hj_ops.probe_compact(_to(bind, card), kb.to(card), pat,
                                     out_cap, k_max),
              p_hj_ops.probe_compact_torch(bind, kb, pat, out_cap, k_max))
        assert _cuda.LAUNCHES["probe_compact"] == before + 1


@pytest.mark.gpu
def test_empty_bindings_on_the_card(card):
    bind, kb = _world(windows=2)
    empty = _to(bind._replace(valid=torch.zeros_like(bind.valid)), card)
    pat = PATTERNS["bound_const_free"]
    for got in (p_hj_ops.join_compact(empty, kb.to(card), pat, 64),
                p_hj_ops.probe_compact(empty, kb.to(card), pat, 64)):
        assert not got.valid.any() and not got.overflow.any()
        assert not got.cols.any()


SCAN_TILE = 4096     # KB rows a block of the scan join holds in registers


def _tile_kb(n, seed=2, spread=60):
    """A KB of exactly ``n`` rows over the small id range of ``_world``."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(BASE, BASE + spread, n),
                     rng.integers(1, 4, n),
                     rng.integers(BASE, BASE + spread, n)], axis=1)
    return pkb.kb_from_triples(rows, capacity=n)


def _span_world():
    """Subject X's 3000 ``p = 2`` rows sit at 3000..5999 of the (p, s) view,
    across the first tile boundary; a window's second live row is X."""
    x = BASE + 100
    rows = [(BASE + i % 50, 2, 20000 + i) for i in range(3000)]
    rows += [(x, 2, 30000 + i) for i in range(3000)]
    rows += [(BASE + 200 + i % 7, 3, 40000 + i) for i in range(1000)]
    kb = pkb.kb_from_triples(np.asarray(rows, np.uint32))
    cols = np.full((2, 64, 3), BASE + 1, np.uint32)
    valid = np.zeros((2, 64), bool)
    cols[0, 1, 0] = x
    cols[1, 5, 0] = x
    valid[0, :3] = True
    valid[1, 5] = True
    return interop.bindings_from_arrays(cols, valid, np.zeros(2, bool)), kb


def _scan_edge(case):
    """(bindings, KB, pattern, out_caps) of one scan-join edge case."""
    pat = PATTERNS["bound_const_free"]
    if case.startswith("kb_tile"):
        n = SCAN_TILE + {"kb_tile_minus_1": -1, "kb_tile": 0,
                         "kb_tile_plus_1": 1}[case]
        return _world()[0], _tile_kb(n), pat, (7, 2000, 50000)
    if case == "span_tile_cut":
        bind, kb = _span_world()
        return bind, kb, pat, (1500, 3059, 3061, 7000)
    if case == "absent_const":
        return _world()[0], _world()[1], PATTERNS["absent_const"], (7, 2000)
    if case == "no_bound_overflow":
        return (*_world(), CompiledPattern(Slot.free(1), Slot.const_(2),
                                           Slot.free(2)), (7, 2000))
    if case == "scattered_valid":
        bind, kb = _world(m=4096, windows=2)
        rng = np.random.default_rng(5)
        valid = torch.from_numpy(rng.random((2, 4096)) < 0.1)
        return bind._replace(valid=valid), kb, pat, (7, 2000, 50000)
    if case == "one_window":
        return (*_world(windows=1), pat, (7, 2000, 50000))
    if case == "ragged_groups":      # 4500 rows: groups of 1024 span windows
        bind, kb = _world(m=1500, windows=3)
        rng = np.random.default_rng(6)
        valid = torch.zeros((3, 1500), dtype=torch.bool)
        for w in range(3):
            valid[w, rng.choice(1500, 1100, replace=False)] = True
        return bind._replace(valid=valid), kb, pat, (7, 5000, 50000)
    raise KeyError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "kb_tile_minus_1", "kb_tile", "kb_tile_plus_1", "span_tile_cut",
    "absent_const", "no_bound_overflow", "scattered_valid", "one_window",
    "ragged_groups"])
def test_scan_join_kernel_edge_cases(card, case):
    """KB sizes at the register tile's edges, matches across a tile with
    out_cap cutting inside one, no match at all, a cross product past
    out_cap, validity scattered over the row groups, one window, and live
    rows that fill no whole row group: byte for byte the plain twin."""
    bind, kb, pat, caps = _scan_edge(case)
    for out_cap in caps:
        got = p_hj_ops.join_compact(_to(bind, card), kb.to(card), pat, out_cap)
        want = p_hj_ops.join_compact_torch(bind, kb, pat, out_cap)
        _same(got, want)
        if case == "no_bound_overflow":
            assert want.overflow.all()
        if case == "absent_const":
            assert not want.valid.any()
        if case == "span_tile_cut" and out_cap == 1500:
            assert want.overflow[0] and int(want.valid[0].sum()) == 1500


@pytest.mark.gpu
@pytest.mark.parametrize("pat_name", sorted(PATTERNS))
def test_match_matrix_kernel_matches_plain(card, pat_name):
    pat = PATTERNS[pat_name]
    for bind, kb in (_world(), _high_world(), _high_world(kb_rows=0)):
        before = _cuda.LAUNCHES["match_matrix"]
        got = p_hj_ops.match_matrix(_to(bind, card), kb.to(card), pat)
        assert _cuda.LAUNCHES["match_matrix"] == before + 1
        assert got.dtype == torch.bool
        assert torch.equal(got.cpu(), p_hj_ops.match_matrix_torch(bind, kb, pat))


@pytest.mark.gpu
def test_match_matrix_kernel_past_int32_offsets(card):
    """One window of 4096 rows against 600,000 KB rows: ``M * N`` passes
    ``2**31``, so the rows past ~3579 sit at offsets only 64-bit indexing
    reaches."""
    bind, kb = _high_world(m=4096, windows=1, kb_rows=600_000)
    bind, kb = _to(bind, card), kb.to(card)
    pat = PATTERNS["bound_const_free"]
    got = p_hj_ops.match_matrix(bind, kb, pat)
    assert got.shape[1] * got.shape[2] > 2 ** 31
    want = p_hj_ops.match_matrix_torch(bind, kb, pat)
    assert torch.equal(got, want)
    assert got[0, -200:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("pat_name", ["bound_const_free", "repeated_free",
                                      "bound_free_free"])
def test_unfused_scan_join_on_the_card_equals_the_cpu(card, pat_name):
    bind, kb = _high_world()
    pat = PATTERNS[pat_name]
    for out_cap in (7, 2000):
        got = palg.kb_join_scan(_to(bind, card), kb.to(card), pat, out_cap,
                                fuse_compaction=False)
        _same(got, palg.kb_join_scan(bind, kb, pat, out_cap,
                                     fuse_compaction=False))
        _same(got, palg.kb_join_scan(bind, kb, pat, out_cap))


def _hierarchy(n=300, seed=0):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), np.float32)
    for i in range(1, n):                   # a DAG: edges to earlier nodes
        for j in rng.choice(i, size=min(i, 2), replace=False):
            if rng.random() < 0.7:
                adj[i, j] = 1.0
    return adj


@pytest.mark.gpu
def test_closure_kernels_match_plain(card):
    reach = p_cl_ops._reach(_hierarchy(), 128, "cpu")
    got = p_cl_kernel.closure_step_cuda(reach.to(card))
    assert torch.equal(got.cpu(), p_cl_ref.closure_step_ref(reach))
    for cap in (300, 9):
        ids, count = p_cl_kernel.descendants_cuda(
            reach.to(card), reach[:, 0].contiguous().to(card), cap)
        r_ids, r_count = p_cl_ref.descendants_step_ref(
            reach, reach[:, 0].contiguous(), cap)
        assert torch.equal(ids.cpu(), r_ids) and int(count) == int(r_count)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.01, 0.2, 1.0])
@pytest.mark.parametrize("n", [64, 128, 512, 1024])
def test_closure_step_kernel_matches_plain_bytes(card, n, density):
    rng = np.random.default_rng(n)
    reach = torch.from_numpy((rng.random((n, n)) < density).astype(np.float32))
    before = _cuda.LAUNCHES["closure_step"]
    got = p_cl_kernel.closure_step_cuda(reach.to(card))
    assert _cuda.LAUNCHES["closure_step"] == before + 1
    assert torch.equal(got.cpu(), p_cl_ref.closure_step_ref(reach))


@pytest.mark.gpu
def test_closure_ops_on_the_card_match_the_cpu(card):
    adj = _hierarchy(n=150, seed=1)
    for root, cap in ((0, 150), (3, 20)):
        got = p_cl_ops.closure_descendants(adj, root, cap, device=card)
        want = p_cl_ops.closure_descendants(adj, root, cap)
        _same(got, want)
    assert torch.equal(p_cl_ops.transitive_closure(adj, device=card).cpu(),
                       p_cl_ops.transitive_closure(adj))


PROBE_EDGES = {e.tag: e for e in pew.probe_edge_worlds()}


_ONE_CALL = r"""
import json, torch
from torch.profiler import ProfilerActivity, profile
{setup}
fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def _kernels_of_one_call(setup):
    """The device kernels that one ``fn()`` (defined by ``setup``) puts on
    the profiler, by name, profiled in a process of its own: on the card, a
    profiler session early in this long test process has left the later
    ones in it (test_decode_attention_is_one_kernel_launch's) recording no
    device event at all."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    res = subprocess.run([sys.executable, "-c", _ONE_CALL.format(setup=setup)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _edge_world(e):
    r = e.kb_rows
    kb = pkb.build_kb(r[:, 0], r[:, 1], r[:, 2], e.capacity)
    bind = interop.bindings_from_arrays(e.cols, e.valid, e.overflow)
    pat = pew.pattern(e.pattern, Slot, CompiledPattern)
    return bind, kb, pat


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(PROBE_EDGES))
def test_probe_join_kernel_edge_worlds(card, tag):
    """The probe join's edge worlds (the CPU tests hold the twin to the
    reference on the same worlds), byte for byte against the twin; at M = 0
    against the contract (zero rows, no valid slot, the bindings'
    overflow), as the twin has no row to gather from there."""
    e = PROBE_EDGES[tag]
    bind, kb, pat = _edge_world(e)
    before = _cuda.LAUNCHES["probe_compact"]
    got = p_hj_ops.probe_compact(_to(bind, card), kb.to(card), pat,
                                 e.out_cap, e.k_max)
    assert _cuda.LAUNCHES["probe_compact"] == before + 1
    if e.cols.shape[1]:
        want = p_hj_ops.probe_compact_torch(bind, kb, pat, e.out_cap, e.k_max)
    else:
        w, _, nv = e.cols.shape
        want = Bindings(torch.zeros((w, e.out_cap, nv), dtype=torch.int64),
                        torch.zeros((w, e.out_cap), dtype=torch.bool),
                        torch.from_numpy(e.overflow))
    _same(got, want)


@pytest.mark.gpu
def test_probe_join_without_windows(card):
    """W = 0: empty outputs of the right shapes and no launch."""
    e = PROBE_EDGES["M=0"]
    bind, kb, pat = _edge_world(e)
    none = _to(Bindings(torch.zeros((0, 5, 3), dtype=torch.int64),
                        torch.zeros((0, 5), dtype=torch.bool),
                        torch.zeros((0,), dtype=torch.bool)), card)
    before = _cuda.LAUNCHES["probe_compact"]
    got = p_hj_ops.probe_compact(none, kb.to(card), pat, 64, 8)
    assert _cuda.LAUNCHES["probe_compact"] == before
    assert [tuple(t.shape) for t in got] == [(0, 64, 3), (0, 64), (0,)]


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 2, 6, 8, 10])
def test_probe_join_kernel_takes_any_fence_stride(card, shift):
    """Fence tables other than the KB's (every 2^shift-th key): a stride
    below the 64-key segment, and strides whose segment is halved in device
    memory first, all give the twin's bytes."""
    bind, kb = _world(m=700, n=5000, spread=400)
    pat = PATTERNS["bound_const_free"]
    want = p_hj_ops.probe_compact_torch(bind, kb, pat, 3000, 8)
    words = kb.to(card).words
    keys = words.key_ps
    fences = keys[::1 << shift]
    fences = torch.cat([fences, fences.new_full(((-len(fences)) % 4,), -1)])
    b = _to(bind, card)
    before = _cuda.LAUNCHES["probe_compact"]
    got = p_hj_kernel.probe_compact_cuda(
        b.cols, b.valid, b.overflow, words.s_ps, words.p_ps, words.o_ps, keys,
        fences, shift, pat, True, 3000, 8)
    assert _cuda.LAUNCHES["probe_compact"] == before + 1
    _same(got, want)


@pytest.mark.gpu
def test_probe_join_is_one_kernel_launch(card):
    """One call at a 4096-row shape is one device kernel: no fill, copy,
    cast or scan around it."""
    names = _kernels_of_one_call("""
import probe_edge_worlds as pew
from repro_torch import interop
from repro_torch.core import kb as pkb
from repro_torch.core.pattern import CompiledPattern, Slot
from repro_torch.kernels.hash_join import ops
e = {w.tag: w for w in pew.probe_edge_worlds()}[
    "live rows only in the window's last 512 rows"]
r = e.kb_rows
kb = pkb.build_kb(r[:, 0], r[:, 1], r[:, 2], e.capacity).to("cuda")
b = interop.bindings_from_arrays(e.cols, e.valid, e.overflow, device="cuda")
pat = pew.pattern(e.pattern, Slot, CompiledPattern)
fn = lambda: ops.probe_compact(b, kb, pat, e.out_cap, e.k_max)
""")
    assert len(names) == 1 and "probe_join_kernel" in names[0], names


def _reach_cases(n):
    rng = np.random.default_rng(n)
    reach = np.minimum((rng.random((n, n)) < 3.0 / n) + np.eye(n), 1)
    reach = torch.from_numpy(reach.astype(np.float32))
    return {"column %d" % (n // 3): reach[:, n // 3],
            "zeros": torch.zeros(n), "ones": torch.ones(n)}, reach


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 512, 700, 1024, 1100])
def test_descendants_kernel_matches_plain_bytes(card, n):
    """Sizes ragged against the cluster's 32-row words, root columns of
    reach (passed as a strided view), of zeros and of ones, and out_cap
    both past and below the count; ids past the count are zero."""
    roots, reach = _reach_cases(n)
    r = reach.to(card)
    for tag, col in roots.items():
        col_card = r[:, n // 3] if tag.startswith("column") else col.to(card)
        assert tag.startswith("column") == (col_card.stride(0) == n)
        for cap in (n + 3, 17):
            before = _cuda.LAUNCHES["descendants"]
            got = p_cl_kernel.descendants_cuda(r, col_card, cap)
            assert _cuda.LAUNCHES["descendants"] == before + 1
            want = p_cl_ref.descendants_step_ref(reach, col, cap)
            _same(got, want)


@pytest.mark.gpu
def test_descendants_is_one_kernel_launch(card):
    """One call (a strided root column) is one device kernel: no fill or
    copy."""
    names = _kernels_of_one_call("""
import numpy as np
from repro_torch.kernels.closure import ops
rng = np.random.default_rng(512)
reach = np.minimum((rng.random((512, 512)) < 3.0 / 512) + np.eye(512), 1)
r = torch.from_numpy(reach.astype(np.float32)).cuda()
fn = lambda: ops.descendants_step(r, r[:, 170], 512)
""")
    assert len(names) == 1 and "descendants_kernel" in names[0], names


def _session_world():
    from repro_torch.core import paper_queries as PQ
    from repro_torch.core.rdf import Vocab
    from repro_torch.data.dbpedia import KBConfig, generate_kb
    from repro_torch.data.tweets import (
        TweetSchema, TweetStreamConfig, generate_tweets, stream_chunks)

    vocab = Vocab()
    kbd = generate_kb(vocab, KBConfig(num_artists=64, num_shows=32,
                                      filler_triples=400, seed=0))
    pool = np.concatenate([kbd.artist_ids, kbd.show_ids])
    rows = generate_tweets(vocab, TweetSchema.create(vocab), pool,
                           TweetStreamConfig(num_tweets=60, mentions_min=2,
                                             mentions_max=3, seed=0))
    chunks = list(stream_chunks(rows, 96))
    texts = dict(PQ.RQ_TEXTS)
    with open(os.path.join(QUERY_DIR, "artist_classes.rq")) as f:
        texts["artist_classes"] = f.read()
    return vocab, kbd, chunks, texts


def _gpu_equals_cpu(vocab, kbd, chunks, texts, **caps):
    from repro_torch.core.session import ExecutionConfig, Session

    caps = dict(dict(window_capacity=96, max_windows=4, bind_cap=1024,
                     scan_cap=128, out_cap=1024, intermediate_cap=512), **caps)
    for q, text in texts.items():
        outs = {}
        for dev in ("cuda", "cpu"):
            reg = Session(ExecutionConfig(device=dev, **caps), vocab=vocab,
                          kb=kbd.kb).register(text)
            outs[dev] = reg.run(chunks)
        (gpu_outs, gpu_ovf), (cpu_outs, cpu_ovf) = outs["cuda"], outs["cpu"]
        assert gpu_ovf == cpu_ovf, q
        assert not any(cpu_ovf.values()), q
        for a, b in zip(gpu_outs, cpu_outs):
            _same(a, b)
        assert sum(int(o.valid.sum()) for o in cpu_outs) > 0, q


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
@pytest.mark.parametrize("method", ["scan", "probe", "auto"])
def test_session_on_the_card_equals_the_cpu(card, mode, method):
    _cuda.reset_launches()
    _gpu_equals_cpu(*_session_world(), mode=mode, kb_method=method)
    assert _cuda.LAUNCHES["closure_step"] > 0 and _cuda.LAUNCHES["descendants"] > 0
    if method == "scan":
        assert _cuda.LAUNCHES["join_compact"] > 0
    else:
        assert _cuda.LAUNCHES["probe_compact"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
def test_incremental_session_on_the_card_equals_the_cpu(card, mode):
    """96-triple windows sliding by 24, evaluated incrementally."""
    _cuda.reset_launches()
    _gpu_equals_cpu(*_session_world(), mode=mode, kb_method="auto",
                    window_step=24, incremental=True, scan_cap=512)
    assert _cuda.LAUNCHES["probe_compact"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_serving_engine_on_the_card_equals_the_cpu(card, fuse):
    """``serve_population(9)`` in one ServeEngine: the fused kernels'
    operators (``fuse=True``), or the prefix group and the cohort over the
    match matrix (``fuse=False``), on the card byte for byte the CPU's."""
    from repro_torch.core.session import ExecutionConfig, Session
    from repro_torch.launch.dscep_run import serve_population

    vocab, kbd, chunks, _ = _session_world()
    texts = serve_population(9)
    caps = dict(mode="monolithic", window_capacity=96, max_windows=4,
                bind_cap=1024, scan_cap=128, out_cap=1024,
                kb_method="scan" if not fuse else "auto",
                fuse_compaction=fuse)
    runs = {}
    _cuda.reset_launches()
    for dev in ("cuda", "cpu"):
        eng = Session(ExecutionConfig(device=dev, **caps), vocab=vocab,
                      kb=kbd.kb).serve()
        for t in texts:
            eng.register(t)
        runs[dev] = eng.run(chunks) + (eng.last_stats,)
    (gpu, gpu_ovf, gpu_st), (cpu, cpu_ovf, cpu_st) = runs["cuda"], runs["cpu"]
    assert gpu_ovf == cpu_ovf and not any(cpu_ovf.values())
    assert gpu_st["prefix_groups"] == cpu_st["prefix_groups"]
    assert gpu_st["cohorts"] == cpu_st["cohorts"]
    assert bool(cpu_st["cohorts"]) == (not fuse)
    for name in cpu:
        for a, b in zip(gpu[name], cpu[name]):
            _same(a, b)
    assert sum(int(o.valid.sum()) for os in cpu.values() for o in os) > 0
    assert _cuda.LAUNCHES["descendants"] > 0
    if fuse:
        assert _cuda.LAUNCHES["probe_compact"] > 0
    else:
        assert _cuda.LAUNCHES["match_matrix"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q15", "cquery1"])
@pytest.mark.parametrize("incremental", [False, True])
def test_pipelined_on_the_card_equals_single_program(card, q, incremental):
    """The pipelined runtime on the card (channels in device memory, every
    operator placed on it) gives single_program's bytes on the card, which
    the tests above hold to the CPU, with two chunks or more in flight on
    every edge and the probe join launched by its stages."""
    from repro_torch.core.session import ExecutionConfig, Session

    vocab, kbd, chunks, texts = _session_world()
    caps = dict(window_capacity=96, max_windows=4, bind_cap=1024,
                scan_cap=128, out_cap=1024, intermediate_cap=512,
                kb_method="auto", incremental=incremental)
    runs = {}
    for mode in ("single_program", "pipelined"):
        reg = Session(ExecutionConfig(mode=mode, **caps), vocab=vocab,
                      kb=kbd.kb).register(texts[q])
        _cuda.reset_launches()
        runs[mode] = reg.run(chunks)
    (want, want_ovf), (got, ovf) = runs["single_program"], runs["pipelined"]
    assert _cuda.LAUNCHES["probe_compact"] > 0
    assert ovf == want_ovf and not any(ovf.values())
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _same(a, b)
    assert sum(int(o.valid.sum()) for o in got) > 0
    stats = reg.channel_stats()
    assert stats and all(st["depth_hw"] >= 2 and st["pushes"] == st["pops"]
                         and st["overflows"] == 0 for st in stats.values())


@pytest.mark.gpu
def test_kernel_launch_needs_its_tensors_card_current(card):
    """A launcher takes the CUDA runtime's current device: a tensor on
    another card raises instead of being read from the wrong one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    rng = np.random.default_rng(0)
    reach = torch.from_numpy((rng.random((64, 64)) < 0.2).astype(np.float32))
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        with pytest.raises(RuntimeError, match="cuda:1 while cuda:0"):
            p_cl_kernel.closure_step_cuda(reach.to(other))
    with torch.cuda.device(other):
        got = p_cl_kernel.closure_step_cuda(reach.to(other))
    assert got.device == other
    assert torch.equal(got.cpu(), p_cl_ref.closure_step_ref(reach))


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q15", "cquery1"])
@pytest.mark.parametrize("incremental", [False, True])
def test_pipelined_across_cards_equals_single_program(card, q, incremental):
    """The default placement (round robin over every visible card) puts
    the upstream operators on cards other than the current one: their
    stages must launch there, and the stream must stay single_program's
    bytes on one card."""
    from repro_torch.core.session import ExecutionConfig, Session

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    vocab, kbd, chunks, texts = _session_world()
    caps = dict(window_capacity=96, max_windows=4, bind_cap=1024,
                scan_cap=128, out_cap=1024, intermediate_cap=512,
                kb_method="auto", incremental=incremental)
    want, want_ovf = Session(
        ExecutionConfig(mode="single_program", device="cuda:0", **caps),
        vocab=vocab, kb=kbd.kb).register(texts[q]).run(chunks)
    reg = Session(ExecutionConfig(mode="pipelined", **caps), vocab=vocab,
                  kb=kbd.kb).register(texts[q])
    placement = reg.runtime.placement
    assert placement[reg.dag.final] == torch.device("cuda", 0)
    assert {d.index for n, d in placement.items() if n != reg.dag.final} \
        - {0}
    for name, op in reg.operators.items():
        if op.kb is not None:
            assert op.kb.device == placement[name]
    _cuda.reset_launches()
    got, ovf = reg.run(chunks)
    assert _cuda.LAUNCHES["probe_compact"] + _cuda.LAUNCHES["join_compact"] > 0
    assert ovf == want_ovf and not any(ovf.values())
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _same(a, b)
    assert sum(int(o.valid.sum()) for o in got) > 0
    assert all(st["depth_hw"] >= 2 and st["pushes"] == st["pops"]
               for st in reg.channel_stats().values())


def _sharded_join_world(seed=0):
    """A 5000-row KB over ids 5000..5199 (predicates 1..3) and 8 windows of
    256 binding rows (some dead), on the CPU."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(BASE, BASE + 200, 5000),
                     rng.integers(1, 4, 5000),
                     rng.integers(BASE, BASE + 200, 5000)], 1)
    kb = pkb.kb_from_triples(rows.astype(np.uint32), capacity=5003)
    cols = rng.integers(BASE, BASE + 200, size=(8, 256, 2))
    bind = interop.bindings_from_arrays(cols, rng.random((8, 256)) < 0.8,
                                        rng.random(8) < 0.25)
    return kb, bind


def _kb_sharded_equals_cpu(devices, method):
    """``kb_join_sharded`` over a model axis of ``devices`` against the
    same join over as many CPU copies, byte for byte, for both anchors."""
    from repro_torch.core import kb_dist
    from repro_torch.launch.mesh import Mesh

    kb, bind = _sharded_join_world()
    n = len(devices)
    cpu_mesh = Mesh(np.array([torch.device("cpu")] * n, dtype=object),
                    ("model",))
    mesh = Mesh(np.array(devices, dtype=object), ("model",))
    blocks = pkb.shard_rows(kb.to(devices[0]), n)
    cpu_blocks = pkb.shard_rows(kb, n)
    gpu_bind = Bindings(*(t.to(devices[0]) for t in bind))
    for name in ("bound_const_free", "free_const_bound"):
        pat = PATTERNS[name]
        _cuda.reset_launches()
        got = kb_dist.kb_join_sharded(gpu_bind, blocks, pat, 512 * n, mesh,
                                      method=method)
        key = "join_compact" if method == "scan" else "probe_compact"
        assert _cuda.LAUNCHES[key] >= n
        want = kb_dist.kb_join_sharded(bind, cpu_blocks, pat, 512 * n,
                                       cpu_mesh, method=method)
        assert got.cols.device == devices[0]
        _same(got, want)
        assert int(want.valid.sum()) > 0
        placed = kb_dist.placed_blocks(blocks, mesh.devices_along("model"))
        assert [b.device for b in placed] == list(devices)


def _sharded_session_equals_unsharded(devices, q):
    """Q15 / CQuery1 ``single_program`` with windows of 32 triples sharded
    over a data axis of ``devices`` (every slice holds windows with results)
    against the unsharded run on cuda:0."""
    from repro_torch.core.session import ExecutionConfig, Session
    from repro_torch.launch.mesh import Mesh

    vocab, kbd, chunks, texts = _session_world()
    caps = dict(window_capacity=32, max_windows=4, bind_cap=1024,
                scan_cap=128, out_cap=1024, intermediate_cap=512,
                kb_method="auto", device=str(devices[0]))
    want, want_ovf = Session(ExecutionConfig(**caps), vocab=vocab,
                             kb=kbd.kb).register(texts[q]).run(chunks)
    mesh = Mesh(np.array(devices, dtype=object).reshape(len(devices), 1),
                ("data", "model"))
    reg = Session(ExecutionConfig(mesh=mesh, **caps), vocab=vocab,
                  kb=kbd.kb).register(texts[q])
    assert reg.runtime.sink_kind == "augmented"
    _cuda.reset_launches()
    got, ovf = reg.run(chunks)
    assert _cuda.LAUNCHES["probe_compact"] > 0
    assert ovf == want_ovf and not any(ovf.values())
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _same(a, b)
    assert sum(int(o.valid.sum()) for o in got) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["scan", "probe"])
def test_kb_join_sharded_on_the_card_equals_the_cpu(card, method):
    """Four row blocks of the KB, all on cuda:0."""
    _kb_sharded_equals_cpu([torch.device("cuda", 0)] * 4, method)


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q15", "cquery1"])
def test_sharded_session_on_the_card_equals_unsharded(card, q):
    """A data axis of four copies of cuda:0 (slices of one window)."""
    _sharded_session_equals_unsharded([torch.device("cuda", 0)] * 4, q)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["scan", "probe"])
def test_kb_join_sharded_across_cards_equals_the_cpu(card, method):
    """One row block a visible card: each block's join launches on its
    card, and the union comes back to cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    _kb_sharded_equals_cpu([torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())],
                           method)


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q15", "cquery1"])
def test_sharded_session_across_cards_equals_unsharded(card, q):
    """One window slice a visible card (three cards: slices 2, 2, 0)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    _sharded_session_equals_unsharded(
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())],
        q)


# the spin kernel the observability and recovery tests wait on: ~0.1 s
# at the H100's clocks
SLEEP_CYCLES = 200_000_000


@pytest.mark.gpu
def test_fenced_span_covers_its_kernel(card):
    """A fenced span lasts at least the CUDA-event time of the kernel
    launched in it; an unfenced one returns while the kernel still runs."""
    from repro_torch.obs.trace import TraceConfig, Tracer

    x = torch.zeros(1, device=card)
    for fence in (True, False):
        tr = Tracer(TraceConfig(fence=fence))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with tr.span("sleep") as sp:
            start.record()
            torch.cuda._sleep(SLEEP_CYCLES)
            end.record()
            sp.fence(x)
        span_s = tr.stats()["sleep"]["first_s"]
        end.synchronize()
        kernel_s = start.elapsed_time(end) / 1e3
        assert kernel_s > 0.02
        if fence:
            assert span_s >= kernel_s
        else:
            assert span_s < kernel_s / 2


@pytest.mark.gpu
def test_wait_until_ready_times_out_then_completes(card):
    """The recovery ladder's timed wait: False within its budget while a
    long kernel runs, then True once it is done."""
    import time

    from repro_torch.core.recovery import wait_until_ready

    x = torch.zeros(1, device=card)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    assert wait_until_ready(x, 0.005) is False
    assert time.perf_counter() - t0 < 0.05
    assert wait_until_ready({"out": (x, None), "n": 1}, 30.0) is True
    assert wait_until_ready(x.cpu(), 0.001) is True   # CPU tensors: ready


@pytest.mark.gpu
def test_traced_chaotic_pipelined_across_cards_equals_single_program(card):
    """Pipelined CQuery1 over every visible card, traced and under a fault
    schedule of all five kinds with a stage timeout: single_program's bytes
    on one card, every event fired, the channels drained, spans for every
    stage."""
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.recovery import RecoveryConfig
    from repro_torch.core.session import ExecutionConfig, Session

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    vocab, kbd, chunks, texts = _session_world()
    caps = dict(window_capacity=96, max_windows=4, bind_cap=1024,
                scan_cap=128, out_cap=1024, intermediate_cap=512,
                kb_method="auto")
    want, want_ovf = Session(
        ExecutionConfig(mode="single_program", device="cuda:0", **caps),
        vocab=vocab, kb=kbd.kb).register(texts["cquery1"]).run(chunks)
    plain = Session(ExecutionConfig(mode="pipelined", **caps), vocab=vocab,
                    kb=kbd.kb).register(texts["cquery1"])
    dag = plain.dag
    up = [n for n in dag.subqueries if n != dag.final]
    plan = FaultPlan((FaultEvent("corrupt_chunk", "ingest", 0),
                      FaultEvent("stall_stage", dag.final, 0),
                      FaultEvent("drop_payload", up[0], 1),
                      FaultEvent("crash_stage", "source", 2),
                      FaultEvent("duplicate_payload", "source", 2)))
    reg = Session(ExecutionConfig(
        mode="pipelined", trace=True, faults=plan,
        recovery=RecoveryConfig(checkpoint_every=2, stage_timeout_s=30.0),
        **caps), vocab=vocab, kb=kbd.kb).register(texts["cquery1"])
    assert {d.index for d in reg.runtime.placement.values()} - {0}
    got, ovf = reg.run(chunks)
    assert ovf == want_ovf and not any(ovf.values())
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        _same(a, b)
    st = reg.last_stats
    assert st["recovery"]["injected"] == plan.counts()
    assert st["recovery"]["restarts"] >= 2 and not st["degraded"]
    assert all(c["size"] == 0 and c["overflows"] == 0
               for c in st["channels"].values())
    assert {p.split("/")[-1] for p in st["spans"]} == {"stage:source"} | {
        "stage:%s" % n for n in reg.operators}
    assert set(st["operators"]) == set(reg.operators)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
def test_unfused_session_on_the_card_equals_the_cpu(card, mode):
    _cuda.reset_launches()
    _gpu_equals_cpu(*_session_world(), mode=mode, kb_method="scan",
                    fuse_compaction=False)
    assert _cuda.LAUNCHES["match_matrix"] > 0
    assert _cuda.LAUNCHES["join_compact"] == 0


# --------------------------------------------------------------------------
# attention kernels and LM generation
# --------------------------------------------------------------------------

ATT_TOL = {torch.float32: dict(rtol=0, atol=1e-4),
           torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}

# (b, hq, hk, tq, tk, d, causal, window, q_offset)
FLASH_CASES = {
    "path_prefill": (4, 12, 2, 2048, 2112, 128, True, None, 0),
    "second_prefill_offset": (2, 12, 2, 300, 2112, 128, True, None, 1800),
    "ragged_g6": (1, 6, 1, 1000, 1077, 64, True, None, 77),
    "window_g3": (2, 6, 2, 700, 700, 32, True, 128, 0),
    "window_offset_g1": (1, 4, 4, 100, 612, 16, True, 50, 500),
    "g1_d64": (2, 4, 4, 333, 333, 64, True, None, 0),
    "noncausal_d16": (1, 4, 2, 65, 129, 16, False, None, 0),
    "no_live_key": (1, 2, 1, 70, 70, 16, True, 0, 0),
    # the bf16 tensor-core kernel's edges: 128-row query and KV tiles
    "tq127_g6_d128": (1, 6, 1, 127, 127, 128, True, None, 0),
    "tq128_tk200_offset72_g3_d64": (2, 6, 2, 128, 200, 64, True, None, 72),
    "tq129_g1_d32": (1, 2, 2, 129, 129, 32, True, None, 0),
    "tq129_window40_offset204_g3_d128": (1, 3, 1, 129, 333, 128, True, 40,
                                         204),
    "window100_offset700_g6_d16": (1, 6, 1, 300, 1000, 16, True, 100, 700),
    "noncausal_tq129_tk65_g1_d128": (1, 2, 2, 129, 65, 128, False, None, 0),
    "noncausal_window30_offset64_g6_d64": (1, 6, 1, 127, 191, 64, False, 30,
                                           64),
    # head dim 80 (H2O-Danube: 32/8 heads): D padded to 128 columns in the
    # bf16 kernel; the danube prefill crosses its 4096-row window
    "danube_prefill_window4096_d80": (1, 32, 8, 4600, 4672, 80, True, 4096,
                                      0),
    "tq129_window100_offset33_g4_d80": (2, 8, 2, 129, 333, 80, True, 100,
                                        33),
    "noncausal_g1_d80": (1, 2, 2, 70, 150, 80, False, None, 0),
    # Mixtral-8x22B's lane prefill: 48/8 heads of 128, window 4096
    "mixtral_prefill_window4096_g6_d128": (1, 48, 8, 4600, 4672, 128, True,
                                           4096, 0),
    # Qwen2-VL-7B's vision forward (28/4 heads of 128: group 7) and
    # MusicGen-large's prefill (32/32 heads of 64: group 1)
    "qwen2vl_forward_g7_d128": (2, 28, 4, 2048, 2048, 128, True, None, 0),
    "musicgen_prefill_g1_d64": (4, 32, 32, 500, 500, 64, True, None, 0),
}
# (b, hq, hk, s, d, lengths)
DECODE_CASES = {
    "path_step": (4, 12, 2, 2112, 128, [2080] * 4),
    "lengths_0_to_s": (4, 12, 2, 2112, 128, [0, 1, 2079, 2112]),
    "g1_d64": (3, 2, 2, 1000, 64, [1000, 513, 64]),
    "g3_d16": (2, 6, 2, 77, 16, [77, 0]),
    "g6_d32": (2, 12, 2, 130, 32, [65, 130]),
    # the one-launch kernel's edges, at 8 splits a (batch, KV head): rows
    # 128 and 1152 end a split, 129 and 1153 put one row in the next
    "split_edges": (4, 12, 2, 2112, 128, [128, 129, 1152, 1153]),
    "dead_but_first_split": (4, 12, 2, 2112, 128, [1, 1, 64, 2]),
    "g8": (2, 16, 2, 1000, 128, [1000, 517]),
    "g12_two_head_groups": (2, 24, 2, 300, 64, [300, 171]),
    "b1_s32768": (1, 12, 2, 32768, 128, [32768]),
    "g4_d80": (3, 32, 8, 4672, 80, [4672, 1, 2300]),
    # Qwen2-VL-7B's tick at group 7 (one slot of the kernel's 8 query heads
    # a block idles) and MusicGen-large's at group 1, 500 + 63 rows
    "qwen2vl_tick_g7_d128": (8, 28, 4, 4672, 128,
                             [4601, 257, 4649, 2001, 4098, 1001, 3501, 300]),
    "musicgen_tick_g1_d64": (4, 32, 32, 564, 64, [563] * 4),
}
# (b, hq, hk, s, d, window, lengths): the query at lengths[b] - 1, live rows
# [max(0, lengths[b] - window), min(lengths[b], S))
WINDOW_DECODE_CASES = {
    "window_below_len_d80": (4, 32, 8, 4672, 80, 4096, [4600, 4097, 4672,
                                                        4200]),
    "window_above_len_d80": (2, 32, 8, 4672, 80, 4096, [4096, 100]),
    "len0_d80": (2, 32, 8, 1000, 80, 16, [0, 17]),
    "past_s_d80": (3, 32, 8, 300, 80, 100, [301, 350, 410]),
    "ragged_lanes_d80": (8, 32, 8, 4672, 80, 4096,
                         [256, 4600, 1, 64, 4161, 65, 2000, 4672]),
    "window_mid_tile_g6_d128": (2, 12, 2, 2112, 128, 70, [2080, 1000]),
    "window1_g3_d64": (2, 6, 2, 300, 64, 1, [300, 5]),
    # Mixtral-8x22B's tick: 8 ragged lanes, 48/8 heads of 128, window 4096
    "mixtral_tick_g6_d128": (8, 48, 8, 4672, 128, 4096,
                             [4601, 257, 4649, 2001, 4098, 1001, 3501, 300]),
}


def _qkv(shape_q, shape_kv, dtype, seed, dv=None):
    """q, k and v drawn from one seeded generator; v of width ``dv`` (MLA)
    where given, else k's."""
    g = torch.Generator().manual_seed(seed)
    shape_v = shape_kv if dv is None else shape_kv[:-1] + (dv,)
    return [torch.randn(s, generator=g).to(dtype)
            for s in (shape_q, shape_kv, shape_v)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    b, hq, hk, tq, tk, d, causal, window, off = FLASH_CASES[case]
    q, k, v = (t.to(card) for t in _qkv((b, hq, tq, d), (b, hk, tk, d),
                                         dtype, seed=tq))
    before = _cuda.LAUNCHES["flash_attention"]
    got = p_fa_ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    want = p_fa_ref.attention_ref(q, k, v, causal, window, off)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **ATT_TOL[dtype])
    if case == "no_live_key":
        assert torch.all(got == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_kernel_matches_plain(card, case, dtype):
    b, hq, hk, s, d, lengths = DECODE_CASES[case]
    q, k, v = (t.to(card) for t in _qkv((b, hq, 1, d), (b, hk, s, d), dtype,
                                         seed=s))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = _cuda.LAUNCHES["decode_attention"]
    got = p_da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decode_attention"] == before + 1
    want = p_da_ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), **ATT_TOL[dtype])
    assert torch.all(got[lens == 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(WINDOW_DECODE_CASES))
def test_windowed_decode_attention_kernel_matches_plain(card, case, dtype):
    b, hq, hk, s, d, window, lengths = WINDOW_DECODE_CASES[case]
    q, k, v = (t.to(card) for t in _qkv((b, hq, 1, d), (b, hk, s, d), dtype,
                                         seed=s + window))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = _cuda.LAUNCHES["decode_attention"]
    got = p_da_ops.decode_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decode_attention"] == before + 1
    want = p_da_ref.decode_attention_ref(q, k, v, lens, window)
    torch.testing.assert_close(got.float(), want.float(), **ATT_TOL[dtype])
    assert torch.all(got[lens == 0] == 0)


# MLA's head dims: q and k of D = nope + rope, v of Dv below it (MiniCPM3-4B
# (96, 64), 40/40 heads; DeepSeek-V2 (192, 128), 128/128 heads).
# (b, hq, hk, tq, tk, d, dv, causal, window, q_offset)
MLA_FLASH_CASES = {
    "minicpm3_prefill_d96": (1, 40, 40, 4600, 4672, 96, 64, True, None, 0),
    "deepseek_prefill_h16_d192": (1, 16, 16, 4600, 4672, 192, 128, True,
                                  None, 0),
    "tq127_d96": (1, 4, 4, 127, 127, 96, 64, True, None, 0),
    "tq128_tk200_offset72_g2_d192": (2, 4, 2, 128, 200, 192, 128, True,
                                     None, 72),
    "tq129_d192": (1, 2, 2, 129, 129, 192, 128, True, None, 0),
    "noncausal_tq129_tk65_d96": (1, 2, 2, 129, 65, 96, 64, False, None, 0),
    "window40_offset204_g3_d192": (1, 3, 1, 129, 333, 192, 128, True, 40,
                                   204),
    "no_live_key_d96": (1, 2, 1, 70, 70, 96, 64, True, 0, 0),
}
# (b, hq, hk, s, d, dv, window, lengths)
MLA_DECODE_CASES = {
    "minicpm3_tick_d96": (8, 40, 40, 4672, 96, 64, None,
                          [4601, 257, 4649, 2001, 4098, 1001, 3501, 300]),
    "deepseek_tick_h32_d192": (8, 32, 32, 4672, 192, 128, None,
                               [4601, 257, 4649, 2001, 4098, 1001, 3501,
                                300]),
    "lengths_0_1_s_past_s_d192": (4, 8, 8, 300, 192, 128, None,
                                  [0, 1, 300, 301]),
    "split_edges_g6_d96": (4, 12, 2, 2112, 96, 64, None,
                           [128, 129, 1152, 1153]),
    "window70_g8_d192": (2, 16, 2, 1000, 192, 128, 70, [1000, 517]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MLA_FLASH_CASES))
def test_mla_flash_attention_kernel_matches_plain(card, case, dtype):
    b, hq, hk, tq, tk, d, dv, causal, window, off = MLA_FLASH_CASES[case]
    q, k, v = (t.to(card) for t in _qkv((b, hq, tq, d), (b, hk, tk, d),
                                         dtype, seed=tq, dv=dv))
    before = _cuda.LAUNCHES["flash_attention"]
    got = p_fa_ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    want = p_fa_ref.attention_ref(q, k, v, causal, window, off)
    assert got.dtype == dtype and got.shape == want.shape == (b, hq, tq, dv)
    torch.testing.assert_close(got.float(), want.float(), **ATT_TOL[dtype])
    if case == "no_live_key_d96":
        assert torch.all(got == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MLA_DECODE_CASES))
def test_mla_decode_attention_kernel_matches_plain(card, case, dtype):
    b, hq, hk, s, d, dv, window, lengths = MLA_DECODE_CASES[case]
    q, k, v = (t.to(card) for t in _qkv((b, hq, 1, d), (b, hk, s, d), dtype,
                                         seed=s, dv=dv))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = _cuda.LAUNCHES["decode_attention"]
    got = p_da_ops.decode_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decode_attention"] == before + 1
    want = p_da_ref.decode_attention_ref(q, k, v, lens, window)
    assert got.shape == want.shape == (b, hq, 1, dv)
    torch.testing.assert_close(got.float(), want.float(), **ATT_TOL[dtype])
    assert torch.all(got[lens == 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(96, 96), (96, 128), (192, 192),
                                  (128, 64), (192, 64)])
def test_attention_kernels_refuse_other_head_dim_pairs(card, dims):
    """A (D, Dv) pair no kernel is built for raises on the card: there is
    no padding fallback and no plain version there."""
    d, dv = dims
    q, k, v = (t.to(card) for t in _qkv((1, 2, 4, d), (1, 2, 8, d),
                                         torch.bfloat16, seed=0, dv=dv))
    with pytest.raises(ValueError, match="head dims"):
        p_fa_ops.flash_attention(q, k, v)
    lens = torch.full((1,), 8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        p_da_ops.decode_attention(q[:, :, :1].contiguous(), k, v, lens)


@pytest.mark.gpu
def test_decode_attention_is_one_kernel_launch(card):
    """One call at the decode path's shape puts exactly one ``decode_``
    kernel on the profiler and counts one launch."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (t.to(card) for t in _qkv((4, 12, 1, 128), (4, 2, 2112, 128),
                                         torch.bfloat16, seed=3))
    lens = torch.full((4,), 2080, dtype=torch.int32, device=card)
    p_da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    before = _cuda.LAUNCHES["decode_attention"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_da_ops.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decode_attention"] == before + 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len([n for n in names if "decode_" in n]) == 1, names


@contextlib.contextmanager
def _plain_attention():
    """The same model code with the attention kernels' plain versions."""
    from repro_torch.models import attention as p_attn

    with mock.patch.object(p_attn.fa_ops, "flash_attention",
                           p_fa_ref.attention_ref), \
            mock.patch.object(p_attn.da_ops, "decode_attention",
                              p_da_ref.decode_attention_ref):
        yield


def _teacher_forced(model, prompt, ids, max_len):
    """Logits of the prefill and of each step fed ``ids[:, i]``."""
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    prefill, step = p_serve.make_serve_fns(model)
    cache = p_lm.init_cache(model.cfg, prompt.shape[0], max_len,
                            model.device)
    with torch.no_grad():
        out = [prefill(prompt, cache)]
        out += [step(ids[:, i:i + 1], cache) for i in range(ids.shape[1] - 1)]
    return torch.stack(out, dim=1).float()


def _as_f32(model):
    m = copy.deepcopy(model).float()
    m.cfg = dataclasses.replace(model.cfg, dtype="float32")
    return m


@pytest.mark.gpu
def test_two_layer_generation_kernels_match_plain(card):
    """Qwen2-1.5B at full width, 2 layers: greedy generation through the
    kernels against the plain attention path, teacher-forced.  float32:
    equal ids, logits within 1e-3; bfloat16: the kernels move the logits
    by at most twice what bf16 arithmetic itself does (the plain bf16 path
    against the float32 one), in the largest and the mean difference."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    model = p_lm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 100))).to(card)
    f32 = _as_f32(model)
    _cuda.reset_launches()
    ids32 = p_serve.generate(f32, prompt, 8, max_len=120)
    assert _cuda.LAUNCHES["flash_attention"] == 2
    assert _cuda.LAUNCHES["decode_attention"] == 2 * 7
    with _plain_attention():
        plain32 = p_serve.generate(f32, prompt, 8, max_len=120)
        t_plain32 = _teacher_forced(f32, prompt, ids32, 120)
    assert torch.equal(ids32, plain32)
    torch.testing.assert_close(_teacher_forced(f32, prompt, ids32, 120),
                               t_plain32, rtol=0, atol=1e-3)

    ids = p_serve.generate(model, prompt, 8, max_len=120)
    kern = _teacher_forced(model, prompt, ids, 120)
    assert torch.equal(kern.argmax(-1).int(), ids)
    with _plain_attention():
        plain = _teacher_forced(model, prompt, ids, 120)
        f32_logits = _teacher_forced(f32, prompt, ids, 120)
    v = cfg.vocab_size      # the padded rows hold -1e30 in each dtype
    assert torch.equal(kern[..., v:], plain[..., v:])
    noise = (plain - f32_logits)[..., :v].abs()
    diff = (kern - plain)[..., :v].abs()
    assert float(diff.max()) <= 2 * float(noise.max())
    assert float(diff.mean()) <= 2 * float(noise.mean())


# --------------------------------------------------------------------------
# the SSD kernel and Mamba-2 generation
# --------------------------------------------------------------------------

SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}
STATE_TOL = dict(rtol=2e-4, atol=2e-4)

# (b, t, h, p, g, s, chunk, init_state)
SSD_CASES = {
    "full_width_t256_init": (2, 256, 24, 64, 1, 128, 128, True),
    "t96_one_chunk": (2, 96, 24, 64, 1, 128, 96, False),
    "t96_chunk128_ragged": (2, 96, 24, 64, 1, 128, 128, True),
    "t200_second_chunk_ragged": (1, 200, 8, 64, 1, 128, 128, True),
    "t40_below_tile": (2, 40, 8, 64, 1, 128, 40, False),
    "t40_chunk16_ragged": (2, 40, 8, 64, 1, 128, 16, True),
    "g2_h4": (2, 128, 4, 64, 2, 64, 64, True),
    "s16_p16": (1, 64, 2, 16, 1, 16, 32, False),
    "s32_p32_g2": (2, 128, 4, 32, 2, 32, 64, True),
    # the model's view of one [B, T, d_inner + 2GS] tensor at full width
    "model_view_t2048": (1, 2048, 24, 64, 1, 128, 128, False),
    "g1_h24_t512": (2, 512, 24, 64, 1, 128, 128, True),
    "chunk64_ragged_t300": (2, 300, 8, 64, 1, 128, 64, True),
    "init_g2_h8_s128": (2, 200, 8, 64, 2, 128, 128, True),
    "h_equals_g": (2, 160, 2, 64, 2, 128, 128, True),
}


def _ssd_inputs(b, t, h, p, g, s, dtype, seed, init, device):
    """The reference tests' distributions (dt in [0.01, 0.2], A in [-2,
    -0.5], x, B, C normal), with x, B and C slices of one [B, T, H*P +
    2*G*S] tensor on ``device``, as the model passes them (strided views:
    moving a view between devices would make it contiguous)."""
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    xbc = put(rng.standard_normal((b, t, h * p + 2 * g * s))).to(dtype)
    x = xbc[..., :h * p].reshape(b, t, h, p)
    Bm = xbc[..., h * p:h * p + g * s].reshape(b, t, g, s)
    Cm = xbc[..., h * p + g * s:].reshape(b, t, g, s)
    dt = put(rng.uniform(0.01, 0.2, (b, t, h)))
    A = put(-rng.uniform(0.5, 2.0, (h,)))
    s0 = put(rng.standard_normal((b, h, s, p))) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_kernel_matches_plain(card, case, dtype):
    b, t, h, p, g, s, chunk, init = SSD_CASES[case]
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(b, t, h, p, g, s, dtype, seed=t + h,
                                       init=init, device=card)
    assert not x.is_contiguous()
    before = _cuda.LAUNCHES["ssd"]
    y, state = p_ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, chunk, s0)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ssd"] == before + 1
    want_y, want_state = p_ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, chunk, s0)
    assert y.dtype == dtype and y.shape == (b, t, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, s, p)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(state, want_state, **STATE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_unaligned_views(card, dtype):
    """x, B and C sliced one element into a wider tensor: no row starts on
    16 bytes, so the kernel takes its element loads; same answer."""
    b, t, h, p, g, s = 2, 200, 4, 64, 1, 128
    rng = np.random.default_rng(11)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, t, 1 + h * p + 2 * g * s)).astype(np.float32)).to(card, dtype)
    x = xbc[..., 1:1 + h * p].reshape(b, t, h, p)
    Bm = xbc[..., 1 + h * p:1 + h * p + g * s].reshape(b, t, g, s)
    Cm = xbc[..., 1 + h * p + g * s:].reshape(b, t, g, s)
    assert x.data_ptr() % 16 and Bm.data_ptr() % 16
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, t, h)).astype(
        np.float32)).to(card)
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(
        np.float32)).to(card)
    s0 = torch.from_numpy(rng.standard_normal((b, h, s, p)).astype(
        np.float32)).to(card)
    y, state = p_ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, 128, s0)
    want_y, want_state = p_ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, 128, s0)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(state, want_state, **STATE_TOL)


@pytest.mark.gpu
def test_ssd_kernel_matches_the_sequential_oracle(card):
    """ops.ssd (kernel, D skip) against the step-by-step ssd_ref, float32,
    from a nonzero state, at a chunk that leaves a ragged tail."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(2, 100, 4, 32, 2, 32, torch.float32,
                                       seed=7, init=True, device=card)
    D = torch.linspace(-1, 1, 4, device=card)
    y, state = p_ssd_ops.ssd(x, dt, A, Bm, Cm, D, chunk=32, init_state=s0)
    want_y, want_state = p_ssd_ref.ssd_ref(x, dt, A, Bm, Cm, D, s0)
    torch.testing.assert_close(y, want_y, **SSD_TOL[torch.float32])
    torch.testing.assert_close(state, want_state, **STATE_TOL)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_does_not_take(card):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 16, 2, 16, 1, 16, torch.float32,
                                      seed=0, init=False, device=card)
    with pytest.raises(ValueError, match="chunk"):
        p_ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, 256)
    with pytest.raises(ValueError, match="d_state"):
        p_ssd_kernel.ssd_cuda(x[..., :8], dt, A, Bm, Cm, 16)
    with pytest.raises(TypeError):
        p_ssd_kernel.ssd_cuda(x, dt.double(), A, Bm, Cm, 16)


@contextlib.contextmanager
def _plain_ssd():
    """The same model code with the SSD kernel's plain version."""
    with mock.patch.object(p_ssd_ops.kernel, "ssd_cuda",
                           p_ssd_ref.ssd_chunked):
        yield


@pytest.mark.gpu
def test_two_layer_mamba_generation_kernel_matches_plain(card):
    """Mamba2-130M at full width, 2 layers: forward and greedy generation
    through the SSD kernel against its plain version.  float32: equal ids,
    logits within 1e-3; bfloat16: the kernel moves the teacher-forced
    logits by at most twice what bf16 arithmetic itself does."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=2)
    model = p_lm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 200))).to(card)
    f32 = _as_f32(model)
    _cuda.reset_launches()
    ids32 = p_serve.generate(f32, prompt, 8)
    with torch.no_grad():
        fwd = p_lm.forward(f32, prompt)
    assert _cuda.LAUNCHES["ssd"] == 2 + 2
    with _plain_ssd():
        plain32 = p_serve.generate(f32, prompt, 8)
        t_plain32 = _teacher_forced(f32, prompt, ids32, 208)
        with torch.no_grad():
            plain_fwd = p_lm.forward(f32, prompt)
    assert torch.equal(ids32, plain32)
    torch.testing.assert_close(_teacher_forced(f32, prompt, ids32, 208),
                               t_plain32, rtol=0, atol=1e-3)
    torch.testing.assert_close(fwd, plain_fwd, rtol=0, atol=1e-3)

    ids = p_serve.generate(model, prompt, 8)
    kern = _teacher_forced(model, prompt, ids, 208)
    assert torch.equal(kern.argmax(-1).int(), ids)
    with _plain_ssd():
        plain = _teacher_forced(model, prompt, ids, 208)
        f32_logits = _teacher_forced(f32, prompt, ids, 208)
    v = cfg.vocab_size
    noise = (plain - f32_logits)[..., :v].abs()
    diff = (kern - plain)[..., :v].abs()
    assert float(diff.max()) <= 2 * float(noise.max())
    assert float(diff.mean()) <= 2 * float(noise.mean())


# --------------------------------------------------------------------------
# per-sequence caches and the continuous batcher
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 3])
def test_per_sequence_gqa_forward_on_the_card_equals_the_cpu(card, t):
    """One H2O-Danube layer at full width (32/8 heads of 80, window 4096),
    float32, over a per-sequence cache whose lanes sit below, across and
    past the window and past the cache's end: the card's output and cache
    equal the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as p_attn

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    layer = p_attn.init_attention(cfg, gen, "cpu", torch.float32)
    s = 4672
    lens = torch.tensor([0, 3000, 4500, 4700], dtype=torch.int32)
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((4, t, cfg.d_model)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal(
        (4, cfg.num_kv_heads, s, 80)).astype(np.float32))
    outs = {}
    for dev in ("cpu", card):
        one = p_attn.gqa_cache_shape(cfg, 4, s, torch.float32, dev,
                                     per_seq=True)
        one["k"].copy_(kv.to(dev))
        one["v"].copy_((0.5 * kv).to(dev))
        one["len"].copy_(lens.to(dev))
        lay = copy.deepcopy(layer).to(dev)
        pos = (lens[:, None].long() + torch.arange(t)).to(dev)
        out, new = p_attn.gqa_forward(lay, cfg, x.to(dev), pos, one)
        outs[str(dev)] = (out.cpu(), new["k"].cpu(), new["v"].cpu(),
                          new["len"].cpu())
    # 2e-3: RoPE at positions up to 4700 turns by angles whose float32 ulp
    # is 4.9e-4 rad, and the card's sin/cos round them otherwise than the
    # CPU's (1e-4 failed by 5.6e-4 on an H100); the LM gates' CPU tolerance
    got, want = outs[str(card)], outs["cpu"]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=2e-3)
    assert got[3].tolist() == (lens + t).tolist()


def _batched(model, requests, slots, max_len):
    """The continuous batcher over ``requests`` ((prompt, max_new) pairs):
    the ids of each request and the logits of every lane it decoded in."""
    from repro_torch.launch import serve as p_launch
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    prefill, decode = p_launch.make_slot_fns(model, max_len)
    logits = {i: [] for i in range(len(requests))}
    admitted = []                      # requests are admitted in rid order
    batcher = None

    def prefill_rec(tokens, cache, slot):
        out, cache = prefill(tokens, cache, slot)
        logits[len(admitted)].append(out[0].float().cpu())
        admitted.append(slot)
        return out, cache

    def decode_rec(tokens, cache):
        out, cache = decode(tokens, cache)
        for i in batcher.active():
            logits[batcher.slots[i].request.rid].append(out[i].float().cpu())
        return out, cache

    batcher = p_serve.ContinuousBatcher(slots, prefill_rec, decode_rec)
    for rid, (prompt, new) in enumerate(requests):
        batcher.submit(p_serve.Request(rid, prompt, new))
    cache = p_lm.init_cache(model.cfg, slots, max_len, model.device,
                            per_seq=True)
    _, ticks = batcher.run_until_drained(cache)
    ids = {r.rid: r.generated for r in batcher.completed}
    return ids, {k: torch.stack(v) for k, v in logits.items()}, ticks


# Mixtral-8x22B runs 1 layer: its float32 layer holds 2.5 B parameters
BATCH_LAYERS = {"h2o-danube-1.8b": 2, "olmo-1b": 2, "mixtral-8x22b": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(BATCH_LAYERS))
def test_two_layer_batcher_on_the_card_equals_the_cpu(card, arch):
    """The continuous batcher at full width, 2 layers (Mixtral's MoE: 1),
    float32, 3 slots and 5 requests: the card's ids equal the CPU's, its
    lane logits within 2e-3 (``chip_smoke.LM_CPU_TOL``), and every
    request's prefill and every tick launch the attention kernels once a
    layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as p_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    layers = BATCH_LAYERS[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    model = p_lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32), 4)
                for n in rng.integers(64, 161, 5)]
    _cuda.reset_launches()
    ids, logits, ticks = _batched(copy.deepcopy(model).to(card), requests, 3,
                                  168)
    assert _cuda.LAUNCHES["flash_attention"] == layers * len(requests)
    assert _cuda.LAUNCHES["decode_attention"] == layers * ticks
    cpu_ids, cpu_logits, cpu_ticks = _batched(model, requests, 3, 168)
    assert ids == cpu_ids and ticks == cpu_ticks
    for rid in ids:
        torch.testing.assert_close(logits[rid][..., :cfg.vocab_size],
                                   cpu_logits[rid][..., :cfg.vocab_size],
                                   rtol=0, atol=2e-3)


# --------------------------------------------------------------------------
# multi-head latent attention (MLA): the real head dims at a narrow width
# --------------------------------------------------------------------------

def _narrow_mla(arch, absorbed=False):
    """The architecture's heads and MLA dims (MiniCPM3-4B: 40 heads, D 96,
    Dv 64; DeepSeek-V2: 128 heads, D 192, Dv 128, its MoE cut to 8
    experts of 256) at d_model 512, 2 layers, float32."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    moe = cfg.moe and dataclasses.replace(cfg.moe, num_experts=8,
                                          expert_ff=256, shared_ff=256)
    return dataclasses.replace(cfg, num_layers=2, d_model=512, d_ff=1024,
                               vocab_size=1000, dtype="float32", moe=moe,
                               mla_absorbed=absorbed)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b"])
def test_mla_batcher_on_the_card_equals_the_cpu(card, arch):
    """The continuous batcher over an MLA model at its real head dims:
    the card's ids equal the CPU's, lane logits within 2e-3, every prefill
    one flash launch a layer and every tick one decode launch a layer (the
    expanded latent at (D, Dv) = (96, 64) or (192, 128))."""
    from repro_torch.models import lm as p_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _narrow_mla(arch)
    model = p_lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32), 4)
                for n in rng.integers(64, 161, 5)]
    _cuda.reset_launches()
    ids, logits, ticks = _batched(copy.deepcopy(model).to(card), requests, 3,
                                  168)
    assert _cuda.LAUNCHES["flash_attention"] == 2 * len(requests)
    assert _cuda.LAUNCHES["decode_attention"] == 2 * ticks
    cpu_ids, cpu_logits, cpu_ticks = _batched(model, requests, 3, 168)
    assert ids == cpu_ids and ticks == cpu_ticks
    for rid in ids:
        torch.testing.assert_close(logits[rid][..., :cfg.vocab_size],
                                   cpu_logits[rid][..., :cfg.vocab_size],
                                   rtol=0, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b"])
def test_mla_absorbed_decode_on_the_card_equals_expanded(card, arch):
    """Absorbed (latent-space, torch products, no kernel) and expanded
    (the attention kernels) serving on the card: the same greedy ids and
    teacher-forced logits within 1e-3 (float32, TF32 off), and the
    absorbed path launches no attention kernel."""
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1000, size=(2, 100))).to(card)
    out = {}
    for absorbed in (False, True):
        cfg = _narrow_mla(arch, absorbed)
        model = p_lm.init_model(cfg, torch.Generator().manual_seed(0),
                                "cpu").to(card)
        _cuda.reset_launches()
        ids = p_serve.generate(model, prompt, 8, max_len=120)
        launched = (_cuda.LAUNCHES["flash_attention"],
                    _cuda.LAUNCHES["decode_attention"])
        assert launched == ((0, 0) if absorbed else (2, 2 * 7))
        out[absorbed] = ids, _teacher_forced(model, prompt, ids, 120)
    assert torch.equal(out[True][0], out[False][0])
    torch.testing.assert_close(out[True][1], out[False][1], rtol=0,
                               atol=1e-3)


# --------------------------------------------------------------------------
# the MoE FFN (no kernel of its own: torch ops on the card)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_forward_on_the_card_equals_the_cpu(card, dropless):
    """``moe_forward`` at Mixtral's expert count and top-k, d 512, 300
    tokens, float32, with capacity drops (factor 0.5) or dropless and a
    router with two equal columns: the same kept slots and outputs within
    1e-4 on the card and the CPU, the router float32 in a bf16 layer.
    Weights are normal / sqrt(fan_in), so the outputs are of order 1
    (``init_moe``'s 1 / sqrt(e) makes them ~1e3, where float32 sums in
    another order move them by ~1e-3)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as p_moe

    torch.backends.cuda.matmul.allow_tf32 = False
    mo = MoEConfig(num_experts=8, top_k=2, expert_ff=1024,
                   capacity_factor=0.5)
    g = torch.Generator().manual_seed(0)
    router, wi, wg, wo = (torch.randn(shape, generator=g) / shape[-2] ** 0.5
                          for shape in ((512, 8), (8, 512, 1024),
                                        (8, 512, 1024), (8, 1024, 512)))
    router[:, 1] = router[:, 0]
    layer = p_moe.MoE(router, wi, wg, wo)
    x = torch.randn((3, 100, 512), generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", card):
        lay = copy.deepcopy(layer).to(dev)
        xd = x.to(dev)
        probs = torch.softmax(xd.reshape(-1, 512) @ lay.router, -1)
        cap = (p_moe.dropless_capacity(300) if dropless else
               p_moe.capacity(300, mo))
        _, tok, _, sel = p_moe.dispatch_group(xd.reshape(1, 300, 512),
                                              probs[None], 2, 8, cap)
        y, aux = p_moe.moe_forward(lay, mo, xd, dropless=dropless)
        outs[str(dev)] = (tok.cpu(), sel.cpu(), y.cpu(), aux.cpu())
    (tok, sel, y, aux), (ctok, csel, cy, caux) = outs[str(card)], outs["cpu"]
    assert torch.equal(tok, ctok) and torch.equal(sel, csel)
    assert dropless == bool((tok >= 0).sum() == 600)
    torch.testing.assert_close(y, cy, rtol=0, atol=1e-4)
    torch.testing.assert_close(aux, caux, rtol=0, atol=1e-6)
    bf16 = p_moe.MoE(layer.router.to(card), *(
        w.to(card, torch.bfloat16) for w in (layer.wi, layer.wg, layer.wo)))
    y16, _ = p_moe.moe_forward(bf16, mo, x.to(card, torch.bfloat16),
                               dropless=dropless)
    assert y16.dtype == torch.bfloat16 and bool(torch.isfinite(y16).all())


# --------------------------------------------------------------------------
# Mamba-1 and the hybrid pattern (Jamba; no kernel of its own: the scan is
# torch ops on the card)
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_mamba1_forward_on_the_card_equals_the_cpu(card):
    """One Mamba-1 layer at Jamba's width (d_model 4096, d_inner 8192,
    d_state 16), float32, TF32 off, its scan cut into chunks of 64 steps:
    no cache (300 tokens), a cached prefill of 200 tokens from a nonzero
    state, then two one-token steps; outputs and the cache within 1e-4 on
    the card and the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as p_mamba

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), dtype="float32")
    layer = p_mamba.init_mamba(cfg, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn((2, t, 4096), generator=g) for t in (300, 200, 1, 1)]
    state = 0.5 * torch.randn((2, 8192, 16), generator=g)
    tail = torch.randn((2, 3, 8192), generator=g)
    outs = {}
    with mock.patch.object(p_mamba, "SCAN_BYTES",
                           64 * p_mamba.SCAN_LIVE * 4 * 2 * 8192 * 16):
        for dev in ("cpu", card):
            lay = copy.deepcopy(layer).to(dev)
            cache = {"conv": tail.clone().to(dev),
                     "ssm": state.clone().to(dev)}
            got = [p_mamba.mamba_forward(lay, cfg, xs[0].to(dev))[0].cpu()]
            for x in xs[1:]:
                got.append(p_mamba.mamba_forward(lay, cfg, x.to(dev),
                                                 cache)[0].cpu())
            outs[str(dev)] = got + [cache["conv"].cpu(), cache["ssm"].cpu()]
    for a, b in zip(outs[str(card)], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_two_layer_hybrid_generation_on_the_card_equals_the_cpu(card):
    """Jamba's layers 4 and 5 as a pattern (attention with a dense FFN,
    Mamba-1 with an MoE), its heads (32/8 of 128) and Mamba widths at
    d_model 1024, 16 experts top-2 of 512, float32, TF32 off: greedy
    generation gives the same ids on the card and the CPU, teacher-forced
    logits within 2e-3, and the attention kernels launch once in the
    prefill and once a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(
        full, layer_pattern=full.layer_pattern[4:6], num_layers=2,
        d_model=1024, d_ff=2048, vocab_size=1000, dtype="float32",
        moe=dataclasses.replace(full.moe, expert_ff=512))
    model = p_lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1000, size=(2, 100)))
    out = {}
    for dev in (card, "cpu"):
        m = copy.deepcopy(model).to(dev)
        _cuda.reset_launches()
        ids = p_serve.generate(m, prompt.to(dev), 8, max_len=112,
                               device=dev)
        launched = (_cuda.LAUNCHES["flash_attention"],
                    _cuda.LAUNCHES["decode_attention"])
        out[str(dev)] = ids.cpu(), _teacher_forced(m, prompt.to(dev), ids,
                                                   112).cpu(), launched
    (ids, logits, launched), (cids, clogits, _) = out[str(card)], out["cpu"]
    assert launched == (1, 7)
    assert torch.equal(ids, cids)
    torch.testing.assert_close(logits[..., :1000], clogits[..., :1000],
                               rtol=0, atol=2e-3)


# --------------------------------------------------------------------------
# M-RoPE (Qwen2-VL-7B) and codebook heads (MusicGen-large): the real heads
# at a narrow width, with the vision and audio frontend stubs
# --------------------------------------------------------------------------

def _narrow(arch):
    """The architecture's heads (Qwen2-VL: 28/4 of 128, M-RoPE (16, 24,
    24); MusicGen: 32/32 of 64, 4 codebooks) at d_model 512, 2 layers,
    vocab 1000 (padded to 1024), float32."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=2, d_model=512,
                               d_ff=1024, vocab_size=1000, dtype="float32")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-large"])
def test_mrope_and_codebook_models_on_the_card_equal_the_cpu(card, arch):
    """``lm.forward`` on the frontend stub (embeddings; Qwen2-VL with the
    position ids of text, an 8x8 image and text) and greedy ``generate``
    after 60 ids (``[B, T, 4]`` for MusicGen), float32, TF32 off: the
    card's ids equal the CPU's, logits within 2e-3, and the attention
    kernels launch once a layer in the forward and the prefill and once a
    layer a step."""
    from repro_torch.models import lm as p_lm
    from repro_torch.serve import lm as p_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _narrow(arch)
    model = p_lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    books = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = torch.from_numpy(rng.integers(0, 1000, (2, 60) + books))
    embeds = torch.from_numpy(rng.standard_normal((2, 100, 512)).astype(
        np.float32))
    positions = None
    if cfg.mrope_sections:
        # chip_smoke.rope_index: Qwen2-VL's image-grid position ids
        from test_torch_kernel_sources import _load_chip_smoke

        grid = _load_chip_smoke().rope_index(
            [("text", 20), ("image", 8, 8), ("text", 16)])
        positions = torch.from_numpy(np.stack([grid, grid], axis=1))
    out = {}
    for dev in (card, "cpu"):
        m = copy.deepcopy(model).to(dev)
        _cuda.reset_launches()
        with torch.no_grad():
            fwd = p_lm.forward(m, None, embeds=embeds.to(dev),
                               positions=None if positions is None
                               else positions.to(dev))
        ids = p_serve.generate(m, prompt.to(dev), 8, max_len=68, device=dev)
        launched = (_cuda.LAUNCHES["flash_attention"],
                    _cuda.LAUNCHES["decode_attention"])
        out[str(dev)] = (fwd.cpu(), ids.cpu(),
                         _teacher_forced(m, prompt.to(dev), ids, 68).cpu(),
                         launched)
    (fwd, ids, logits, launched), (cfwd, cids, clogits, _) = (
        out[str(card)], out["cpu"])
    assert launched == (4, 14)
    assert fwd.shape == (2, 100) + books + (1024,)
    assert ids.shape == (2, 8) + books and torch.equal(ids, cids)
    for a, b in ((fwd, cfwd), (logits, clogits)):
        assert torch.all(a[..., 1000:] == -1e30)
        torch.testing.assert_close(a[..., :1000], b[..., :1000], rtol=0,
                                   atol=2e-3)


@pytest.mark.gpu
def test_per_lane_mrope_tick_reads_nothing_back(card):
    """One token a lane over a per-sequence cache (lanes at 0, 37, 300
    and 511 of 512 rows, drawn keys and values), narrow Qwen2-VL: each
    lane's three M-RoPE streams come from its length on the card, so the
    whole ``decode_step`` runs under ``set_sync_debug_mode("error")``;
    logits and cache equal the CPU's within 2e-3."""
    from repro_torch.models import lm as p_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _narrow("qwen2-vl-7b")
    model = p_lm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    lens = torch.tensor([0, 37, 300, 511], dtype=torch.int32)
    rng = np.random.default_rng(5)
    kv = torch.from_numpy(rng.standard_normal(
        (2, 4, 4, 512, 128)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 1000, (4, 1)))
    out = {}
    for dev in (card, "cpu"):
        m = copy.deepcopy(model).to(dev)
        cache = p_lm.init_cache(cfg, 4, 512, dev, per_seq=True)
        cache["k"].copy_(kv.to(dev))
        cache["v"].copy_((0.5 * kv).to(dev))
        cache["len"].copy_(lens.to(dev))
        tokens = toks.to(dev)
        if str(dev) != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                logits = p_lm.decode_step(m, tokens, cache, last_only=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[str(dev)] = (logits.cpu(), cache["k"].cpu(), cache["v"].cpu(),
                         cache["len"].cpu())
    got, want = out[str(card)], out["cpu"]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-3)
    assert got[3].tolist() == (lens + 1).tolist()


# --------------------------------------------------------------------------
# LM training (no kernel of its own: impl="xla" is torch ops on the card)
# --------------------------------------------------------------------------

def _train_two_sides(card, arch, steps=1, lr=1e-3, microbatches=2):
    """A smoke model's train steps on the card and on the CPU from the
    same weights: ``{device: (model, opt_state, [metrics])}``."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    cpu = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    step_fn = make_train_step(cfg, TrainConfig(
        opt=AdamWConfig(peak_lr=lr, warmup_steps=1, total_steps=4),
        microbatches=microbatches))
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
                for k in ("tokens", "labels")} for _ in range(steps)]
    out = {}
    for dev, model in ((card, interop.lm_params_from_arrays(
            interop.lm_params_to_arrays(cpu), cfg, card)), ("cpu", cpu)):
        opt = init_opt_state(dict(model.named_parameters()))
        metrics = []
        for batch in batches:
            model, opt, m = step_fn(model, opt,
                                    {k: v.to(dev) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[str(dev)] = (model, opt, metrics)
    return out[str(card)], out["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b",
                                  "mamba2-130m"])
def test_train_step_on_the_card_equals_the_cpu(card, arch):
    """One ``make_train_step`` step (impl xla, 2 microbatches, remat
    dots, float32, TF32 off) of a dense, an MoE and a Mamba-2 smoke model:
    the metrics within 1e-5, the parameters within 2 lr elementwise and
    1e-6 on average, the moments within 1e-3 of each leaf's largest, on
    the card and the CPU."""
    lr = 1e-3
    (gm, gopt, gmet), (cm, copt, cmet) = _train_two_sides(card, arch, lr=lr)
    for g, c in zip(gmet, cmet):
        for k, v in c.items():
            assert abs(g[k] - v) <= 1e-5 * (1 + abs(v)), (k, g[k], v)
    diffs = [(a.detach().cpu() - b.detach()).abs()
             for a, b in zip(gm.parameters(), cm.parameters())]
    assert max(float(d.max()) for d in diffs) <= 2 * lr
    assert sum(float(d.sum()) for d in diffs) / sum(
        d.numel() for d in diffs) < 1e-6
    assert gopt.step == copt.step == 1
    for which in ("m", "v"):
        for name, want in getattr(copt, which).items():
            got = getattr(gopt, which)[name].cpu()
            assert float((got - want).abs().max()) <= \
                1e-3 * float(want.abs().max()) + 1e-12, (which, name)


@pytest.mark.gpu
def test_bf16_checkpoint_round_trips_from_the_card(card, tmp_path):
    """A bf16 Mamba-2 smoke model after one step on the card, saved from
    its CUDA tensors and restored onto the card and onto the CPU: every
    leaf's dtype and bits as saved."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import lm
    from repro_torch.train.checkpoint import CheckpointManager, _flatten_with_paths
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    cfg = dataclasses.replace(smoke_variant(get_config("mamba2-130m")),
                              dtype="bfloat16")
    model = lm.init_model(cfg, torch.Generator(device=card).manual_seed(0),
                          card)
    opt = init_opt_state(dict(model.named_parameters()))
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), device=card)
             for k in ("tokens", "labels")}
    model, opt, _ = make_train_step(cfg, TrainConfig())(model, opt, batch)
    tree = (interop.lm_params_to_arrays(model),
            interop.opt_state_to_arrays(opt, model))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    for dev in (card, None):
        got, manifest = mgr.restore(tree, device=dev)
        assert manifest["leaves"]["0/embed"]["dtype"] == "bfloat16"
        for (path, a), (_, b) in zip(_flatten_with_paths(got),
                                     _flatten_with_paths(tree)):
            assert a.dtype == b.dtype, path
            assert torch.equal(a.cpu(), b.cpu()), path
    restored = interop.lm_params_from_arrays(got[0], cfg, card)
    assert all(torch.equal(a, b) for a, b in zip(restored.parameters(),
                                                 model.parameters()))
