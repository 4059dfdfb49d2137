"""CUDA wrapper for the decode-attention kernel (``kernels/csrc/attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py``'s
``decode_attention_pallas``.  The kernel is bound by reading the live K
and V rows once; one block per (batch, KV head, split of the cache) serves
all the KV head's query heads, and a second kernel merges the splits'
partial softmax statistics (see the source's header).

The wrapper checks its arguments, picks the split (about two blocks per
SM), allocates the output and the float32 partials, launches both kernels
on PyTorch's current stream and counts one launch.  Nothing is built or
loaded at import time.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from .._cuda import I, P
from ..flash_attention.kernel import DTYPES, LOG2E, check_inputs

TILE = 64                  # cache rows a block stages at once
_READY = set()


def _lib():
    lib = _cuda.library("attention")
    if "decode" not in _READY:
        lib.decode_attention_launch.argtypes = (
            [P] * 7 + [I] * 8 + [ctypes.c_float, P])
        lib.decode_attention_launch.restype = I
        _READY.add("decode")
    return lib


def split_cache(b: int, hk: int, s: int, sms: int):
    """``(nsplit, chunk)``: cut ``s`` cache rows into splits of a multiple
    of ``TILE`` rows so that ``b * hk * nsplit`` is about ``2 * sms``."""
    tiles = max(1, -(-s // TILE))
    nsplit = min(tiles, max(1, -(-2 * sms // max(1, b * hk))))
    chunk = -(-tiles // nsplit) * TILE
    return -(-max(s, 1) // chunk), chunk


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """``q [B, Hq, 1, D]``, ``k, v [B, Hk, S, D]``, ``lengths [B]`` int32
    -> ``[B, Hq, 1, D]``."""
    check_inputs(q, k, v, "decode_attention")
    _cuda.require(lengths, torch.int32, 1, "decode_attention lengths")
    b, hq, tq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if tq != 1 or lengths.shape[0] != b:
        raise ValueError("decode_attention takes one query row per sequence "
                         "and one length per sequence, got q %s, lengths %s"
                         % (tuple(q.shape), tuple(lengths.shape)))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, chunk = split_cache(b, hk, s, sms)
    part_ml = torch.empty((b * hq * nsplit * 2,), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b * hq * nsplit * d,), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    _cuda.check(_lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, hq, hk,
        s, d, DTYPES[q.dtype], nsplit, chunk, LOG2E / math.sqrt(d),
        _cuda.stream_of(q)), "decode_attention")
    _cuda.count_launch("decode_attention")
    return out
