"""PyTorch port vs the JAX reference: sliding count windows and time windows.

The same streams (numpy arrays) go through the reference's window functions
and the port's; every field must be equal as ``np.uint32`` bytes: slide
views, materialized windows and their validity.  The edge cases are those
of ``tests/test_window.py``: a graph straddling a slide boundary, a graph
larger than the slide, empty slides, and ``STEP == RANGE`` as tumbling.
Last, whole ``Session`` runs with overlapping windows, with and without
incremental evaluation, against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rdf as rrdf
from repro.core import window as rwin
from repro_torch import interop
from repro_torch.core import window as pwin
from repro_torch.core.session import ExecutionConfig, Session

from test_torch_session import (  # noqa: F401
    QUERIES, check_against_reference, one_torch_thread, pworld,
)

r_count_slides = jax.jit(rwin.count_slides, static_argnums=(1, 2, 3))
r_windows_from_slides = jax.jit(rwin.windows_from_slides,
                                static_argnums=(1, 2, 3))


def u32(x):
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def _both(rows, capacity):
    """One merged stream, as the reference's and the port's TripleBatch."""
    ref = rrdf.sort_by_timestamp(rrdf.make_triples(rows, capacity=capacity))
    port = interop.triples_from_arrays(*(np.asarray(c) for c in ref))
    return ref, port


def _graph_stream(graph_sizes, ts_start=100):
    rows = []
    for gi, size in enumerate(graph_sizes):
        for k in range(size):
            rows.append((10 + gi, 1, 20 + k, ts_start + gi, gi + 1))
    return _both(rows, max(1, sum(graph_sizes)))


def _random_stream(seed, n=160, graphs=48, high_ts=False):
    """Graph events of 1-7 triples; with ``high_ts`` timestamps straddle
    ``2**31``.  A few invalid rows sit at the tail."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 8, size=graphs)
    base = (1 << 31) - 20 if high_ts else 1000
    rows = []
    for g, size in enumerate(sizes):
        ts = base + 2 * g + int(rng.integers(0, 2))
        for _ in range(size):
            rows.append((int(rng.integers(4096, 4200)), 1 + g % 3,
                         int(rng.integers(4096, 4200)), ts, g + 1))
    rows = rows[:n - 9]
    return _both(rows, n)


def _same_windows(ref, port):
    for rc, pc in zip(ref.triples, port.triples):
        assert u32(rc).tobytes() == u32(pc).tobytes()
    np.testing.assert_array_equal(np.asarray(ref.window_valid),
                                  port.window_valid.numpy())


GEOMETRY = [(16, 4, 6), (16, 5, 4), (12, 12, 5), (12, 20, 5), (10, 3, 12),
            (8, 1, 40)]


@pytest.mark.parametrize("cap,step,max_windows", GEOMETRY)
@pytest.mark.parametrize("high_ts", [False, True])
def test_count_slides_and_windows_match_reference(cap, step, max_windows,
                                                  high_ts):
    ref_s, port_s = _random_stream(cap * 7 + step, high_ts=high_ts)
    rv = r_count_slides(ref_s, cap, max_windows, step)
    pv = pwin.count_slides(port_s, cap, max_windows, step)
    for name in ("slide_of_row", "slide_col", "slide_valid", "slide_ts"):
        np.testing.assert_array_equal(np.asarray(getattr(rv, name)),
                                      getattr(pv, name).numpy(), err_msg=name)
    _same_windows(r_windows_from_slides(rv, cap, max_windows, step),
                  pwin.windows_from_slides(pv, cap, max_windows, step))
    _same_windows(rwin.count_windows_jit(ref_s, cap, max_windows, step),
                  pwin.count_windows(port_s, cap, max_windows, step))


@pytest.mark.parametrize("sizes,cap,step,max_windows", [
    ([2, 2, 2], 6, 3, 4),        # a graph straddling a slide boundary
    ([5, 2], 6, 3, 3),           # a graph larger than the slide
    ([2], 6, 3, 4),              # empty slides invalidate trailing windows
    ([3, 2, 4], 5, 5, 4),        # STEP == RANGE: tumbling
    ([7], 4, 4, 2),
    ([1, 6, 2, 1], 6, 6, 4),
])
def test_window_edge_cases_match_reference(sizes, cap, step, max_windows):
    ref_s, port_s = _graph_stream(sizes)
    got = pwin.count_windows(port_s, cap, max_windows, step)
    _same_windows(rwin.count_windows_jit(ref_s, cap, max_windows, step), got)
    if step >= cap:     # bit for bit the tumbling packing
        tumble = pwin.count_windows(port_s, cap, max_windows)
        for a, b in zip(tumble.triples, got.triples):
            assert torch.equal(a, b)
        assert torch.equal(tumble.window_valid, got.window_valid)


@pytest.mark.parametrize("t0,width,slide,cap,max_windows", [
    (1000, 8, 8, 40, 6), (1000, 8, 3, 12, 9), (990, 20, 5, 64, 4),
    (1000, 4, 4, 3, 7),
])
def test_time_windows_match_reference(t0, width, slide, cap, max_windows):
    ref_s, port_s = _random_stream(width + slide)
    _same_windows(
        rwin.time_windows_jit(ref_s, t0, width, slide, cap, max_windows),
        pwin.time_windows(port_s, t0, width, slide, cap, max_windows))


def test_window_slides_geometry():
    assert pwin.window_slides(1000) == (1000, 1)
    assert pwin.window_slides(1000, 1000) == (1000, 1)
    assert pwin.window_slides(1000, 250) == (250, 4)
    assert pwin.window_slides(256, 64) == (64, 4)
    assert pwin.window_slides(10, 3) == (3, 4)
    for cap, step in ((1000, 250), (10, 3), (8, 1)):
        assert pwin.window_slides(cap, step) == rwin.window_slides(cap, step)


def test_window_geometry_of_a_registration(pworld):
    reg = pworld.port_register("artist_classes", "monolithic", "auto")
    assert reg.window_geometry == (96, 64)
    assert reg.config.window_step is None
    reg = pworld.port_register("artist_classes", "monolithic", "auto",
                               window_from_query=True)
    assert reg.window_geometry == (256, 64)
    assert (reg.config.window_capacity, reg.config.window_step) == (256, 64)
    ref_reg = pworld.ref_register("artist_classes", "monolithic", "auto",
                                  window_from_query=True)
    assert reg.window_geometry == ref_reg.window_geometry


def test_sliding_knobs_construct():
    cfg = ExecutionConfig(device="cpu", window_step=16, incremental=True,
                          window_from_query=True, fuse_compaction=False)
    rc = cfg.runtime_config()
    assert (rc.window_step, rc.incremental, rc.fuse_compaction) == (
        16, True, False)
    with pytest.raises(ValueError, match="window_step"):
        ExecutionConfig(device="cpu", window_step=0)
    assert isinstance(Session(cfg).config, ExecutionConfig)


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("mode", ["monolithic", "single_program"])
@pytest.mark.parametrize("incremental", [False, True])
def test_sliding_session_equals_reference(pworld, q, mode, incremental):
    """96-triple windows sliding by 24 (four slides a window)."""
    check_against_reference(pworld, q, mode, "auto", window_step=24,
                            incremental=incremental)
