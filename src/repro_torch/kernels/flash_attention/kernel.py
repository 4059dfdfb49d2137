"""CUDA wrapper for the flash-attention kernel (``kernels/csrc/attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py``'s
``flash_attention_pallas``.  At the prefill's shapes the kernel is bound by
operations (2·(D + Dv) per live query-key pair: 4·D where the value
width equals the key's); one block per (batch, query head,
query tile) loops over the live KV tiles only, with the online softmax
statistics in registers (see the source's header).  The dtype picks the
kernel: bfloat16 runs on the tensor cores (``wgmma``, P rounded to bf16
before P·V), float32 on the CUDA cores.

The wrapper checks its arguments, allocates the output, launches on
PyTorch's current stream and counts one launch.  Nothing is built or
loaded at import time.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _cuda
from .._cuda import I, P

# (D of q and k, Dv of v): the head dims the kernels are built for; (96, 64)
# and (192, 128) are MLA's (MiniCPM3-4B, DeepSeek-V2: nope + rope columns
# against a narrower value)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (96, 64),
             (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634
_READY = set()


def _lib():
    lib = _cuda.library("attention")
    if "flash" not in _READY:
        lib.flash_attention_launch.argtypes = (
            [P, P, P, P] + [I] * 12 + [ctypes.c_float, P])
        lib.flash_attention_launch.restype = I
        _READY.add("flash")
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 what: str) -> None:
    """The contract both attention kernels hold their q, k, v to: ``q [B,
    Hq, T, D]``, ``k [B, Hk, S, D]``, ``v [B, Hk, S, Dv]``, Hq a multiple of
    Hk, (D, Dv) one of ``HEAD_DIMS``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t, q.dtype, 4, "%s %s" % (what, name))
        if t.data_ptr() % 16:
            raise ValueError("%s %s must be 16-byte aligned" % (what, name))
    if q.dtype not in DTYPES:
        raise TypeError("%s takes float32 or bfloat16, got %s"
                        % (what, q.dtype))
    b, hq, _, d = q.shape
    hk = k.shape[1]
    if (k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]
            or hk == 0 or hq % hk):
        raise ValueError("%s: q %s, k %s, v %s do not fit [B, Hq, T, D] x "
                         "[B, Hk, S, D], [B, Hk, S, Dv] with Hq a multiple "
                         "of Hk" % (what, tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if (d, v.shape[3]) not in HEAD_DIMS:
        raise ValueError("%s: head dims (D, Dv) = (%d, %d) not in %s"
                         % (what, d, v.shape[3], HEAD_DIMS))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """``q [B, Hq, Tq, D]``, ``k [B, Hk, Tk, D]``, ``v [B, Hk, Tk, Dv]`` ->
    ``[B, Hq, Tq, Dv]``."""
    check_inputs(q, k, v, "flash_attention")
    b, hq, tq, d = q.shape
    hk, tk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((b, hq, tq, dv))
    _cuda.check(_lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hk,
        tq, tk, d, dv, DTYPES[q.dtype], int(causal), int(window is not None),
        int(window or 0), int(q_offset), LOG2E / math.sqrt(d),
        _cuda.stream_of(q)), "flash_attention")
    _cuda.count_launch("flash_attention")
    return out
