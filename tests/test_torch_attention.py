"""PyTorch port vs the JAX reference: the two attention kernels' plain
versions (float32, on the CPU).

* the port's plain flash attention against the reference's
  ``flash_attention`` (Pallas, interpret mode, as its own tests run it) and
  ``attention_ref``: GQA groups 1, 3 and 6, sliding windows, ``q_offset >
  0``, query and key lengths off the kernel's 64-row tiles;
* the port's plain decode attention against the reference's
  ``decode_attention`` (interpret) and ``decode_attention_ref``, with
  lengths from 0 to S; head dim 80 (H2O-Danube) in both kernels;
* the port's windowed plain decode attention against the reference's
  masked ``_sdpa`` (``impl="xla"``, per-sequence ``q_offset``): windows
  below and above the length, lengths past S, ragged lanes;
* the CPU dispatch of the public wrappers, the CUDA wrappers' refusal of
  CPU tensors, and the decode kernel's split of the cache.

Tolerance 2e-5 absolute and relative (``tests/test_decode_attention_kernel.py``):
float32 sums taken in another order.  The CUDA kernels against these plain
versions are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as r_da_ops
from repro.kernels.decode_attention import ref as r_da_ref
from repro.kernels.flash_attention import ops as r_fa_ops
from repro.kernels.flash_attention import ref as r_fa_ref
from repro.models import attention as r_attn
from repro_torch.kernels import _cuda
from repro_torch.kernels.decode_attention import kernel as p_da_kernel
from repro_torch.kernels.decode_attention import ops as p_da_ops
from repro_torch.kernels.decode_attention import ref as p_da_ref
from repro_torch.kernels.flash_attention import kernel as p_fa_kernel
from repro_torch.kernels.flash_attention import ops as p_fa_ops
from repro_torch.kernels.flash_attention import ref as p_fa_ref
from test_torch_batcher import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, hq, hk, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d)).astype(np.float32),
            rng.standard_normal((b, hk, tk, d)).astype(np.float32),
            rng.standard_normal((b, hk, tk, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (b, hq, hk, tq, tk, d, causal, window, q_offset): group = hq / hk
FLASH_CASES = {
    "g1_causal": (2, 2, 2, 40, 40, 16, True, None, 0),
    "g3_causal_ragged": (1, 6, 2, 37, 37, 32, True, None, 0),
    "g6_causal": (2, 12, 2, 24, 24, 16, True, None, 0),
    "g2_window": (1, 4, 2, 45, 45, 16, True, 7, 0),
    "g3_window_offset": (1, 3, 1, 13, 50, 16, True, 9, 30),
    "g6_offset_prefill": (1, 6, 1, 21, 72, 32, True, None, 40),
    "g1_offset_ragged": (2, 2, 2, 9, 30, 64, True, None, 17),
    "g2_noncausal": (1, 4, 2, 16, 24, 16, False, None, 0),
    "g4_d80_window": (1, 8, 2, 40, 40, 80, True, 16, 0),
    "g1_d80_offset_ragged": (2, 2, 2, 11, 30, 80, True, None, 19),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_reference(case):
    b, hq, hk, tq, tk, d, causal, window, off = FLASH_CASES[case]
    q, k, v = _qkv(b, hq, hk, tq, tk, d, seed=tq + tk)
    got = p_fa_ref.attention_ref(*_t(q, k, v), causal=causal, window=window,
                                 q_offset=off).numpy()
    want = r_fa_ref.attention_ref(*_j(q, k, v), causal=causal, window=window,
                                  q_offset=off)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = r_fa_ops.flash_attention(*_j(q, k, v), causal=causal,
                                      window=window, q_offset=off, bq=8, bk=8)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_flash_row_with_no_live_key_is_zero():
    """A window of 0 leaves no key for any row: the output is 0, not NaN."""
    q, k, v = _qkv(1, 2, 1, 5, 5, 16, seed=3)
    got = p_fa_ref.attention_ref(*_t(q, k, v), causal=True, window=0)
    want = r_fa_ref.attention_ref(*_j(q, k, v), causal=True, window=0)
    assert torch.all(got == 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (b, hq, hk, s, d, lengths)
DECODE_CASES = {
    "g1": (3, 2, 2, 64, 32, [0, 1, 64]),
    "g3": (2, 6, 2, 100, 16, [37, 100]),
    "g6": (2, 12, 2, 72, 32, [72, 5]),
    "g2_d64": (4, 4, 2, 48, 64, [0, 17, 31, 48]),
    "g4_d80": (3, 8, 2, 40, 80, [0, 17, 40]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_reference(case):
    b, hq, hk, s, d, lengths = DECODE_CASES[case]
    q, k, v = _qkv(b, hq, hk, 1, s, d, seed=s + d)
    lens = np.asarray(lengths, np.int32)
    got = p_da_ref.decode_attention_ref(
        *_t(q, k, v), torch.from_numpy(lens)).numpy()
    want = r_da_ref.decode_attention_ref(*_j(q, k, v), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = r_da_ops.decode_attention(*_j(q, k, v), jnp.asarray(lens), bk=16)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    assert np.all(got[lens == 0] == 0)


def test_decode_every_length_matches_reference():
    """Lengths 0..S over one cache, and decode == the last row of causal
    flash attention over the live prefix."""
    s, d = 24, 16
    q, k, v = _qkv(s + 1, 6, 2, 1, s, d, seed=11)
    lens = np.arange(s + 1, dtype=np.int32)
    got = p_da_ref.decode_attention_ref(*_t(q, k, v), torch.from_numpy(lens))
    want = r_da_ref.decode_attention_ref(*_j(q, k, v), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for b in range(1, s + 1):
        row = p_fa_ref.attention_ref(
            *_t(q[b:b + 1], k[b:b + 1, :, :b], v[b:b + 1, :, :b]),
            causal=True, q_offset=b - 1)
        np.testing.assert_allclose(got[b:b + 1].numpy(), row.numpy(), **TOL)


def test_cpu_tensors_take_the_plain_versions():
    q, k, v = _t(*_qkv(2, 4, 2, 10, 10, 16, seed=5))
    lens = torch.tensor([3, 10], dtype=torch.int32)
    before = dict(_cuda.LAUNCHES)
    flash = p_fa_ops.flash_attention(q, k, v, causal=True, window=4,
                                     q_offset=0)
    dec = p_da_ops.decode_attention(q[:, :, -1:], k, v, lens)
    assert _cuda.LAUNCHES == before
    assert torch.equal(flash, p_fa_ref.attention_ref(q, k, v, True, 4, 0))
    assert torch.equal(dec, p_da_ref.decode_attention_ref(q[:, :, -1:], k, v,
                                                          lens))


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = _t(*_qkv(1, 2, 1, 4, 4, 16, seed=6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        p_fa_kernel.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        p_da_kernel.decode_attention_cuda(q[:, :, :1], k, v,
                                          torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("blocks,s,sms,want", [
    (8, 2112, 132, 8),       # the decode path's shape: 8 clusters of 8
    (1, 0, 132, 1),          # an empty cache: one dead split
    (256, 32768, 132, 2),
    (2, 100, 132, 2),        # no more splits than 64-row tiles
])
def test_decode_split_of_the_cache(blocks, s, sms, want):
    assert p_da_kernel.cluster_splits(blocks, s, sms) == want


@pytest.mark.parametrize("blocks", range(1, 65))
def test_decode_cluster_splits_fill_the_card(blocks):
    """B * Hk (* head groups) from 1 to 64 on 132 SMs: a cluster of 1 to 8
    splits, as many as about two blocks an SM allow."""
    sms, s = 132, 32768
    n = p_da_kernel.cluster_splits(blocks, s, sms)
    assert 1 <= n <= p_da_kernel.MAX_SPLIT
    assert n == p_da_kernel.MAX_SPLIT or blocks * n >= 2 * sms
    assert n == 1 or blocks * (n - 1) < 2 * sms


# (b, hq, hk, s, d, window, lengths): the query of sequence b at position
# lengths[b] - 1.  Every row keeps a live key: where none is left (length
# 0, or a length past S + window - 1) the port writes 0, as the
# reference's Pallas kernels do, while its masked _sdpa averages every row
WINDOW_DECODE_CASES = {
    "window_below_len": (3, 8, 2, 40, 80, 16, [40, 17, 30]),
    "window_above_len": (2, 6, 2, 40, 16, 64, [40, 9]),
    "past_s": (3, 4, 2, 24, 32, 16, [25, 30, 39]),
    "ragged_lanes_window1": (4, 8, 2, 48, 16, 1, [1, 48, 20, 33]),
}


@pytest.mark.parametrize("case", sorted(WINDOW_DECODE_CASES))
def test_windowed_decode_plain_matches_reference_sdpa(case):
    """Decode attention with a window: the rows [max(0, len - window),
    min(len, S)), against the reference's masked attention at per-sequence
    query positions len - 1 (the continuous batcher's step)."""
    b, hq, hk, s, d, window, lengths = WINDOW_DECODE_CASES[case]
    q, k, v = _qkv(b, hq, hk, 1, s, d, seed=s + window)
    lens = np.asarray(lengths, np.int32)
    got = p_da_ref.decode_attention_ref(*_t(q, k, v), torch.from_numpy(lens),
                                        window)
    want = r_attn._sdpa(*(jnp.asarray(a.transpose(0, 2, 1, 3))
                          for a in (q, k, v)), causal=True, window=window,
                        q_offset=jnp.asarray(lens - 1), impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(
        0, 2, 1, 3), **TOL)
    via_ops = p_da_ops.decode_attention(*_t(q, k, v), torch.from_numpy(lens),
                                        window)
    assert torch.equal(via_ops, got)


def test_windowed_decode_with_no_live_row_is_zero():
    """Length 0, and a length past S + window - 1 (an idle lane far past
    the cache's end): no live row, so 0."""
    q, k, v = _qkv(3, 4, 2, 1, 20, 80, seed=4)
    got = p_da_ref.decode_attention_ref(*_t(q, k, v),
                                        torch.tensor([0, 20, 28]), 8)
    assert torch.all(got[0] == 0) and torch.all(got[2] == 0)
    assert not torch.all(got[1] == 0)
    with pytest.raises(ValueError, match="at least one row"):
        p_da_kernel.decode_attention_cuda(
            *_t(q, k, v), torch.tensor([1, 1], dtype=torch.int32), 0)
