"""PyTorch port vs the JAX reference: the sharded paths.

* ``kb.shard_rows``: the ``[n, per]`` block layout, leaf for leaf.
* ``kb_dist``: the per-block join and union (``kb_join_blocks_reference``)
  and the mesh path (``kb_join_sharded``), under ``scan`` and ``probe``,
  fused and unfused, on subject- and object-anchored patterns (each sorted
  view is cut on its own), with blocks all padding and shorter than a
  fence stride, and shard-local overflow.  The port's bindings carry W
  windows, the reference takes one at a time.
* ``runtime.balance_windows`` and ``Session(mesh=...)``: window sharding
  over a data axis of CPU devices, uneven and empty slices included, held
  to the reference on its ``make_host_mesh()`` (bytes, ``last_stats``,
  ``explain()``) and to the unsharded reference (bytes).

Torch has one CPU device, so a port mesh names it several times.  All
compared as ``np.uint32`` bytes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh as r_make_mesh
from repro.core import kb as rkb
from repro.core import kb_dist as rdist
from repro.core import pattern as rpat
from repro.core import runtime as rruntime
from repro.core import stream as rstream
from repro.core.pipeline import PipelinedRuntime as RPipelined
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro_torch import interop
from repro_torch.core import kb as pkb
from repro_torch.core import kb_dist as pdist
from repro_torch.core import runtime as pruntime
from repro_torch.core import stream as pstream
from repro_torch.core.pattern import CompiledPattern, Slot
from repro_torch.core.pipeline import PipelinedRuntime
from repro_torch.core.session import ExecutionConfig
from repro_torch.launch.mesh import (
    Mesh, make_host_mesh, make_production_mesh, on_device,
)

from test_torch_obs import _close
from test_torch_session import CAPS, _bytes, one_torch_thread, pworld  # noqa: F401

CPU = torch.device("cpu")
W = 2
PATTERNS = {
    # ?s p2 ?o with ?s bound: the probe searches the (p,s) view
    "subject": (rpat.CompiledPattern(rpat.Slot.bound(0), rpat.Slot.const_(2),
                                     rpat.Slot.free(1)),
                CompiledPattern(Slot.bound(0), Slot.const_(2), Slot.free(1))),
    # ?s p2 ?o with ?o bound: the (p,o) view
    "object": (rpat.CompiledPattern(rpat.Slot.free(1), rpat.Slot.const_(2),
                                    rpat.Slot.bound(0)),
               CompiledPattern(Slot.free(1), Slot.const_(2), Slot.bound(0))),
}


def cpu_mesh(n, axes=("model",)):
    """``n`` copies of the CPU device along the first of ``axes``."""
    shape = (n,) + (1,) * (len(axes) - 1)
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), axes)


def _kb_world(seed=0, n_rows=96, cap=128):
    """The reference test's KB (ids 5000..5039, predicates 1..3) in both
    packages, and W binding tables of 16 rows (some dead rows, window 1's
    overflow set)."""
    rng = np.random.default_rng(seed)
    base = 5000
    rows = [(int(rng.integers(base, base + 40)), int(rng.integers(1, 4)),
             int(rng.integers(base, base + 40))) for _ in range(n_rows)]
    rkb_ = rkb.kb_from_triples(rows, capacity=cap)
    pkb_ = interop.kb_from_arrays({f: np.asarray(getattr(rkb_, f))
                                   for f in rkb_._fields})
    cols = rng.integers(base, base + 40, size=(W, 16, 2)).astype(np.uint32)
    valid = rng.random((W, 16)) < 0.8
    ovf = np.array([False, True])
    ref = [rpat.Bindings(jnp.asarray(cols[w]), jnp.asarray(valid[w]),
                         jnp.asarray(ovf[w])) for w in range(W)]
    return rkb_, pkb_, ref, interop.bindings_from_arrays(cols, valid, ovf)


def _ref_windows(fn, ref_list):
    """``fn`` over every window's bindings, jitted once (the windows share
    their shapes)."""
    jfn = jax.jit(fn)
    return [jfn(b) for b in ref_list]


def _same_as_ref(ref_list, port):
    for w, r in enumerate(ref_list):
        assert _bytes(r.cols) == _bytes(port.cols[w]), w
        assert np.array_equal(np.asarray(r.valid), port.valid[w].numpy()), w
        assert bool(r.overflow) == bool(port.overflow[w]), w


def _same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("cap,n", [(128, 4), (128, 8), (100, 8), (5, 8)])
def test_shard_rows_equals_reference(cap, n):
    """The block layout, padding included (100 and 5 rows over 8 blocks),
    leaf for leaf; each row block is a 1-D KB of its own whose fence table
    is its length's."""
    rkb_, pkb_, _, _ = _kb_world(n_rows=min(cap, 96), cap=cap)
    ref = rkb.shard_rows(rkb_, n)
    got = pkb.shard_rows(pkb_, n)
    for f in rkb_._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert r.shape == g.shape, f
        assert _bytes(r) == _bytes(g), f
    per = got.capacity
    for i in range(n):
        blk = pkb.row_block(got, i)
        assert blk.capacity == per and blk.valid.dim() == 1
        assert blk.fences.shift == pkb.fence_shift(per)
        assert all(c.is_contiguous() for c in blk)


# the scan reads the (p,s) view whatever the anchor; the probe searches
# the view of its anchor
BLOCK_JOINS = [("subject", "scan"), ("subject", "probe"), ("object", "probe")]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("anchor,method", BLOCK_JOINS)
def test_block_join_equals_reference(anchor, method, n):
    """The per-block joins and their shard-major union, fused and unfused,
    equal the reference's (its unfused run: the reference pins its fused
    run to it); n = 8 has blocks of 16 rows (shorter than a fence stride)
    and two blocks all padding."""
    rkb_, pkb_, rbind, pbind = _kb_world()
    rpat_, ppat = PATTERNS[anchor]
    rblocks = rkb.shard_rows(rkb_, n)
    want = _ref_windows(lambda b: rdist.kb_join_blocks_reference(
        b, rblocks, rpat_, 512, n, method=method), rbind)
    blocks = pkb.shard_rows(pkb_, n)
    for fuse in (False, True):
        got = pdist.kb_join_blocks_reference(pbind, blocks, ppat, 512, n,
                                             method=method,
                                             fuse_compaction=fuse)
        _same_as_ref(want, got)
        assert int(got.valid.sum()) > 0
        _same(pdist.kb_join_sharded(pbind, blocks, ppat, 512, cpu_mesh(n),
                                    method=method, fuse_compaction=fuse),
              got)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("method", ["scan", "probe"])
def test_shard_local_overflow_equals_reference(method, fuse):
    """out_cap 8 over 4 blocks: each shard clips at 2 rows, and the union
    reports it even where one join would have fit."""
    rkb_, pkb_, rbind, pbind = _kb_world(seed=5)
    rpat_, ppat = PATTERNS["subject"]
    rblocks = rkb.shard_rows(rkb_, 4)
    want = _ref_windows(lambda b: rdist.kb_join_blocks_reference(
        b, rblocks, rpat_, 8, 4, method=method, fuse_compaction=fuse), rbind)
    blocks = pkb.shard_rows(pkb_, 4)
    got = pdist.kb_join_blocks_reference(pbind, blocks, ppat, 8, 4,
                                         method=method, fuse_compaction=fuse)
    _same_as_ref(want, got)
    assert bool(got.overflow.all())
    _same(pdist.kb_join_sharded(pbind, blocks, ppat, 8, cpu_mesh(4),
                                method=method, fuse_compaction=fuse), got)


@pytest.mark.parametrize("method", ["scan", "probe"])
def test_kb_join_sharded_equals_reference_shard_map(method):
    """The reference's ``shard_map`` path on its host mesh (``model`` axis
    over every JAX device) against the port's on as many CPU copies, on a
    ``("data", "model")`` mesh whose model axis is the second."""
    rkb_, pkb_, rbind, pbind = _kb_world(seed=3)
    rpat_, ppat = PATTERNS["object"]
    n = jax.device_count()
    rmesh = r_make_mesh((n,), ("model",))
    rblocks = rkb.shard_rows(rkb_, n)
    want = _ref_windows(lambda b: rdist.kb_join_sharded(
        b, rblocks, rpat_, 512, rmesh, method=method), rbind)
    mesh = Mesh(np.array([CPU] * (2 * n), dtype=object).reshape(2, n),
                ("data", "model"))
    blocks = pkb.shard_rows(pkb_, n)
    got = pdist.kb_join_sharded(pbind, blocks, ppat, 512, mesh,
                                method=method, fuse_compaction=False)
    _same_as_ref(want, got)
    # the blocks were placed once, and the next call reuses them
    placed = pdist.placed_blocks(blocks, mesh.devices_along("model"))
    pdist.kb_join_sharded(pbind, blocks, ppat, 512, mesh, method=method)
    assert pdist.placed_blocks(blocks, mesh.devices_along("model")) is placed


def test_balance_windows_equals_reference(pworld):
    """Padded to a multiple of 3, 4 and 5 engines (W = 4: 6, 4, 5)."""
    ref_stream = rstream.merge_streams([pworld.chunks[0]])
    stream = pstream.merge_streams([pworld.port_chunks()[0]])
    for engines in (3, 4, 5):
        want = rruntime.balance_windows(ref_stream, engines,
                                        CAPS["window_capacity"],
                                        CAPS["max_windows"])
        got = pruntime.balance_windows(stream, engines,
                                       CAPS["window_capacity"],
                                       CAPS["max_windows"])
        assert got.num_windows % engines == 0
        for r, g in zip(want.triples, got.triples):
            assert _bytes(r) == _bytes(g)
        assert np.array_equal(np.asarray(want.window_valid),
                              got.window_valid.numpy())


@pytest.mark.parametrize("n,spans", [(1, [(0, 4)]), (3, [(0, 2), (2, 4), (4, 4)]),
                                     (4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
                                     (5, [(0, 1), (1, 2), (2, 3), (3, 4),
                                          (4, 4)])])
def test_window_slices(n, spans):
    """ceil(W / n) windows a slice; a slice past W is empty and is left out
    of ``shard_windows``."""
    mesh = cpu_mesh(n, ("data", "model"))
    got = pruntime.window_slices(4, mesh)
    assert [(lo, hi) for _, lo, hi in got] == spans


def test_mesh_builders():
    mesh = cpu_mesh(4, ("data", "model"))
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.devices_along("data") == [CPU] * 4
    assert mesh.devices_along("model") == [CPU]
    with pytest.raises(ValueError):
        mesh.devices_along("pod")
    with pytest.raises(ValueError):
        Mesh(np.array([CPU] * 4, dtype=object), ("data", "model"))
    assert on_device(CPU).__enter__() is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(ValueError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True)


def test_pipelined_runtime_refuses_a_mesh_as_the_reference_does():
    for cls in (PipelinedRuntime, RPipelined):
        with pytest.raises(NotImplementedError, match="placement="):
            cls(None, None, None, mesh=cpu_mesh(1))
    with pytest.raises(TypeError, match="Mesh"):
        pruntime.DSCEPRuntime(None, None, None, mesh="mesh")


# --------------------------------------------------------------------------
# Session(mesh=...): window sharding over a data axis
# --------------------------------------------------------------------------

SHARD_CASES = [(q, m) for q in ("q15", "cquery1") for m in ("scan", "auto")]
# windows of 32 triples: a 96-triple chunk fills 3 or 4 of its 4 windows,
# so every slice has windows with results
SHARD_WINDOW = dict(window_capacity=32)


@pytest.mark.parametrize("q,method", SHARD_CASES)
def test_sharded_session_equals_reference(pworld, q, method):
    """Windows sharded over n = 1, 3, 4 and 5 CPU devices (W = 4: slices
    of 4; 2, 2, 0; 1 each; 1 each and an empty one) give the reference's
    bytes on its host mesh and unsharded, and its ``last_stats`` and
    ``explain()``.  One test a configuration, so its two reference runs
    happen once, in one worker."""
    rmesh = r_make_host_mesh()
    ref_reg, ref_outs, ref_ovf, _ = pworld.ref_run(
        q, "single_program", method, mesh=rmesh, trace=True, **SHARD_WINDOW)
    plain_outs = pworld.ref_run(q, "single_program", method,
                                **SHARD_WINDOW)[1]
    ref_explain = json.loads(json.dumps(ref_reg.explain()))
    for n in (1, 3, 4, 5):
        _check_sharded(pworld, q, method, n, ref_reg, ref_outs, ref_ovf,
                       plain_outs, ref_explain)


def _check_sharded(pworld, q, method, n, ref_reg, ref_outs, ref_ovf,
                   plain_outs, ref_explain):
    reg, outs, overflow = pworld.port_run(
        q, "single_program", method, mesh=cpu_mesh(n, ("data", "model")),
        trace=True, **SHARD_WINDOW)
    assert reg.runtime.sink_kind == "augmented"
    assert len(outs) == len(ref_outs) == len(plain_outs)
    for po, ro, uo in zip(outs, ref_outs, plain_outs):
        for pc, rc, uc in zip(po, ro, uo):
            assert _bytes(pc) == _bytes(rc) == _bytes(uc)
    assert sum(int(o.valid.sum()) for o in outs) > 0
    assert overflow == dict(ref_ovf)
    got, want = reg.last_stats, ref_reg.last_stats
    assert got["operators"]
    assert got["operators"][reg.dag.final]["counters"]["n_windows"] > len(outs)
    for key in ("operators", "overflow_totals", "channels", "recovery",
                "degraded", "query", "mode"):
        assert got[key] == want[key], key
    assert set(got["spans"]) == set(want["spans"])
    _close(json.loads(json.dumps(reg.explain())), ref_explain)


def test_sharded_incremental_evaluates_windows_as_the_reference(pworld):
    """Under a mesh, incremental evaluation is off and the sink keeps the
    augmented window, as in the reference: sliding windows give the
    unsharded incremental bytes, and ``explain()`` still reports the
    configured ``incremental``."""
    kw = dict(incremental=True, window_step=24)
    base = pworld.port_run("q15", "single_program", "auto", **kw)
    reg, outs, overflow = pworld.port_run(
        "q15", "single_program", "auto",
        mesh=cpu_mesh(3, ("data", "model")), **kw)
    assert base[0].runtime.sink_kind == "split-delta"
    assert reg.runtime.sink_kind == "augmented"
    for a, b in zip(outs, base[1]):
        _same(a, b)
    assert overflow == base[2]
    assert reg.explain()["incremental"] is True


def test_monolithic_ignores_the_mesh(pworld):
    base = pworld.port_run("q15", "monolithic", "auto")
    reg, outs, overflow = pworld.port_run(
        "q15", "monolithic", "auto", mesh=cpu_mesh(3, ("data", "model")))
    assert type(reg.runtime) is type(base[0].runtime)
    for a, b in zip(outs, base[1]):
        _same(a, b)
    assert overflow == base[2]


def test_pipelined_with_a_mesh_raises():
    with pytest.raises(ValueError, match="placement="):
        ExecutionConfig(device="cpu", mode="pipelined", mesh=cpu_mesh(1))
