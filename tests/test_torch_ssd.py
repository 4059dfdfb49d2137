"""PyTorch port vs the JAX reference: the Mamba-2 SSD scan, on the CPU.

The same numpy inputs (the reference tests' distributions, from a seed)
feed both packages.  The port's ``ops.ssd`` on CPU tensors runs
``ref.ssd_chunked``, the plain version its CUDA kernel is held against on
the card; ``ref.ssd_ref`` is its sequential oracle.  Against the
reference's ``ssd_ops.ssd(use_pallas=True)`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it), its ``ssd_pallas``
final state and its ``ssd_ref``:

* the reference's three ``SSD_SHAPES`` and one T that leaves a ragged last
  chunk (padded with dt = 0), y and the final state;
* the same from a nonzero initial state (the reference's ``ssd_ref``
  ``init_state``, which its cached prefill runs);
* bfloat16 inputs, where the ``D`` skip rounds as the reference's;
* the dispatch: CPU tensors never reach the kernel wrapper, which refuses
  them.

Tolerance 2e-4 absolute and relative (the reference's own SSD tolerance,
``tests/test_kernels.py``: float32 sums in another order); bfloat16 2e-2
plus 1e-2 relative (one rounding of y and of the skip).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as r_ops
from repro.kernels.ssd.kernel import ssd_pallas as r_ssd_pallas
from repro.kernels.ssd.ref import ssd_ref as r_ssd_ref
from repro_torch.kernels import _cuda
from repro_torch.kernels.ssd import kernel as p_kernel
from repro_torch.kernels.ssd import ops as p_ops
from repro_torch.kernels.ssd import ref as p_ref
from test_torch_batcher import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)

# (b, t, h, p, g, s, chunk): the reference's SSD_SHAPES, then a ragged T
SHAPES = [
    (1, 64, 2, 16, 1, 16, 32),
    (2, 128, 4, 32, 2, 32, 64),
    (1, 96, 2, 64, 1, 128, 32),
    (2, 40, 4, 16, 2, 16, 16),
]


def _inputs(shape, seed=0):
    b, t, h, p, g, s, _ = shape
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((b, t, h, p)).astype(np.float32),
        "dt": rng.uniform(0.01, 0.2, (b, t, h)).astype(np.float32),
        "A": (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32),
        "Bm": rng.standard_normal((b, t, g, s)).astype(np.float32),
        "Cm": rng.standard_normal((b, t, g, s)).astype(np.float32),
        "D": rng.standard_normal((h,)).astype(np.float32),
        "init": rng.standard_normal((b, h, s, p)).astype(np.float32),
    }


ARGS = ("x", "dt", "A", "Bm", "Cm")


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "t%d_h%d_s%d_chunk%d"
                % (s[1], s[2], s[5], s[6]))
def case(request):
    """Inputs and the reference's results, computed once per shape."""
    shape = request.param
    a = _inputs(shape)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    args = [j[k] for k in ARGS]
    chunk = shape[6]
    ref = {"pallas_y": np.asarray(r_ops.ssd(*args, j["D"], chunk=chunk,
                                            use_pallas=True))}
    y, st = r_ssd_ref(*args, j["D"])
    ref["ref_y"], ref["ref_state"] = np.asarray(y), np.asarray(st)
    y, st = r_ssd_ref(*args, j["D"], init_state=j["init"])
    ref["init_y"], ref["init_state"] = np.asarray(y), np.asarray(st)
    if shape[1] % chunk == 0:
        ref["pallas_state"] = np.asarray(r_ssd_pallas(*args, chunk=chunk)[1])
    return shape, a, ref


def _torch(a, *names):
    return [torch.from_numpy(a[n]) for n in names]


def test_chunked_matches_the_pallas_kernel(case):
    shape, a, ref = case
    before = dict(_cuda.LAUNCHES)
    y, state = p_ops.ssd(*_torch(a, *ARGS, "D"), chunk=shape[6])
    assert _cuda.LAUNCHES == before          # CPU tensors: the plain version
    assert y.dtype == torch.float32 and state.shape == (
        shape[0], shape[2], shape[5], shape[3])
    np.testing.assert_allclose(y.numpy(), ref["pallas_y"], **TOL)
    np.testing.assert_allclose(y.numpy(), ref["ref_y"], **TOL)
    np.testing.assert_allclose(state.numpy(), ref["ref_state"], **TOL)
    if "pallas_state" in ref:
        np.testing.assert_allclose(state.numpy(), ref["pallas_state"], **TOL)


def test_chunked_from_an_initial_state_matches_the_reference(case):
    shape, a, ref = case
    y, state = p_ops.ssd(*_torch(a, *ARGS, "D"), chunk=shape[6],
                         init_state=torch.from_numpy(a["init"]))
    np.testing.assert_allclose(y.numpy(), ref["init_y"], **TOL)
    np.testing.assert_allclose(state.numpy(), ref["init_state"], **TOL)


def test_sequential_oracle_matches_the_reference(case):
    _, a, ref = case
    y, state = p_ref.ssd_ref(*_torch(a, *ARGS, "D"))
    np.testing.assert_allclose(y.numpy(), ref["ref_y"], **TOL)
    np.testing.assert_allclose(state.numpy(), ref["ref_state"], **TOL)
    y, state = p_ref.ssd_ref(*_torch(a, *ARGS, "D", "init"))
    np.testing.assert_allclose(y.numpy(), ref["init_y"], **TOL)
    np.testing.assert_allclose(state.numpy(), ref["init_state"], **TOL)


def test_default_chunk_is_min_128_t():
    a = _inputs((1, 96, 2, 16, 1, 16, 0), seed=1)
    y, state = p_ops.ssd(*_torch(a, *ARGS))
    want_y, want_state = p_ref.ssd_chunked(*_torch(a, *ARGS), chunk=96)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


def test_bf16_rounds_as_the_reference():
    """bf16 x, B, C: y in bf16, the D skip rounded to bf16 before the add
    (the reference's ops.ssd), against the Pallas path."""
    shape = (1, 64, 2, 16, 1, 16, 32)
    a = _inputs(shape, seed=2)
    bf = {k: (torch.from_numpy(v).to(torch.bfloat16)
              if k in ("x", "Bm", "Cm") else torch.from_numpy(v))
          for k, v in a.items()}
    y, _ = p_ops.ssd(*(bf[k] for k in ARGS), bf["D"], chunk=32)
    assert y.dtype == torch.bfloat16
    j = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if k in ("x", "Bm", "Cm") else jnp.float32)
        for k, v in bf.items()}
    want = r_ops.ssd(*(j[k] for k in ARGS), j["D"], chunk=32,
                     use_pallas=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    a = _inputs(SHAPES[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        p_kernel.ssd_cuda(*_torch(a, *ARGS), 32)
