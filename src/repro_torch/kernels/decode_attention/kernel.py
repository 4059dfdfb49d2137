"""CUDA wrapper for the decode-attention kernel (``kernels/csrc/attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py``'s
``decode_attention_pallas``, which takes the first ``lengths[b]`` rows;
the port's kernel also takes a sliding window (the sequence's first live
row ``max(0, lengths[b] - window)``), which the reference sends to flash
attention.  The kernel is bound by reading the live K and V rows once.  It is one launch: the live rows of a (batch, KV head) are
cut into ``nsplit`` splits, one block each, and the splits form a
thread-block cluster that merges their softmax states in shared memory
(see the source's header).

The wrapper checks its arguments, picks ``nsplit`` (about two blocks per
SM, from the SM count cached per device), allocates the output and nothing
else, launches on PyTorch's current stream and counts one launch.  Nothing
is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .. import _cuda
from .._cuda import I, P
from ..flash_attention.kernel import DTYPES, LOG2E, check_inputs

TILE = 64                  # cache rows a split holds a multiple of (at least)
HEADS_PER_BLOCK = 8        # query heads a block serves
MAX_SPLIT = 8              # blocks of a cluster: the portable most (16,
                           # non-portable, ran slower on an H100)
_READY = set()
_SMS: Dict[int, int] = {}


def _lib():
    lib = _cuda.library("attention")
    if "decode" not in _READY:
        lib.decode_attention_launch.argtypes = (
            [P] * 5 + [I] * 9 + [ctypes.c_float, P])
        lib.decode_attention_launch.restype = I
        _READY.add("decode")
    return lib


def _sm_count(device: torch.device) -> int:
    """The SM count of a CUDA tensor's device, read once."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device.index).multi_processor_count
    return _SMS[device.index]


def cluster_splits(blocks: int, s: int, sms: int) -> int:
    """The splits of each (batch, KV head, head group), ``blocks`` of them:
    about ``2 * sms`` blocks in all, at most ``MAX_SPLIT`` (a cluster) and
    at most one a ``TILE`` rows of the ``s``-row cache."""
    tiles = max(1, -(-s // TILE))
    want = -(-2 * sms // max(1, blocks))
    return max(1, min(want, MAX_SPLIT, tiles))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """``q [B, Hq, 1, D]``, ``k [B, Hk, S, D]``, ``v [B, Hk, S, Dv]``,
    ``lengths [B]`` int32 -> ``[B, Hq, 1, Dv]``.  Lengths past S count as
    S; a window (at least 1) starts each sequence at row ``max(0,
    lengths[b] - window)``."""
    if window is not None and window < 1:
        raise ValueError("decode_attention: a window holds at least one row, "
                         "got %d" % window)
    check_inputs(q, k, v, "decode_attention")
    _cuda.require(lengths, torch.int32, 1, "decode_attention lengths")
    b, hq, tq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    if tq != 1 or lengths.shape[0] != b:
        raise ValueError("decode_attention takes one query row per sequence "
                         "and one length per sequence, got q %s, lengths %s"
                         % (tuple(q.shape), tuple(lengths.shape)))
    groups = -(-(hq // hk) // HEADS_PER_BLOCK)
    nsplit = cluster_splits(b * hk * groups, s, _sm_count(q.device))
    out = q.new_empty((b, hq, 1, v.shape[3]))
    _cuda.check(_lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, hq, hk, s, d, v.shape[3], DTYPES[q.dtype], nsplit,
        int(window or 0), LOG2E / math.sqrt(d), _cuda.stream_of(q)),
        "decode_attention")
    _cuda.count_launch("decode_attention")
    return out
