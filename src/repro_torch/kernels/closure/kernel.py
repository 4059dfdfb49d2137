"""CUDA wrappers for the closure kernels (``kernels/csrc/closure.cu``).

* :func:`closure_step_cuda` — ``min(R @ R, 1)`` for a square float32 0/1
  matrix whose side is a multiple of 64, as a bit-packed boolean product
  (two launches: pack the rows and columns into bits, then AND/OR them).
* :func:`descendants_cuda` — the fused last squaring for one root column:
  ``ids[:min(count, out_cap)]`` are the ascending rows i with
  ``min(reach @ rootcol, 1)[i] > 0.5`` (one launch of a thread-block
  cluster; ``rootcol`` may be a strided column view of ``reach``).

Each wrapper checks its arguments, launches on PyTorch's current stream
and counts one launch.  Nothing is built or loaded at import time.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _cuda
from .._cuda import I, LL, P

_READY = set()


def _lib():
    lib = _cuda.library("closure")
    if "sig" not in _READY:
        lib.closure_step_launch.argtypes = [P, P, P, I, P]
        lib.closure_step_launch.restype = I
        lib.descendants_launch.argtypes = [P, P, LL, I, P, P, I, P]
        lib.descendants_launch.restype = I
        _READY.add("sig")
    return lib


def closure_step_cuda(reach: torch.Tensor) -> torch.Tensor:
    _cuda.require(reach, torch.float32, 2, "reach")
    n = reach.shape[0]
    if reach.shape != (n, n) or n % 64:
        raise ValueError("reach must be square with a side that is a "
                         "multiple of 64, got %s" % (tuple(reach.shape),))
    out = torch.empty_like(reach)
    bits = torch.empty((2 * n * (n // 32),), dtype=torch.int32,
                       device=reach.device)      # row bits, then column bits
    _cuda.check(_lib().closure_step_launch(
        reach.data_ptr(), bits.data_ptr(), out.data_ptr(), n,
        _cuda.stream_of(reach)), "closure_step")
    _cuda.count_launch("closure_step")
    return out


def descendants_cuda(reach: torch.Tensor, rootcol: torch.Tensor,
                     out_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(ids [out_cap] int32, count [] int32)``, both written whole
    by the kernel.  ``reach`` holds 0/1 entries (the closure's contract);
    ``rootcol`` is read with its own stride."""
    _cuda.require(reach, torch.float32, 2, "reach")
    n = reach.shape[0]
    if (not rootcol.is_cuda or rootcol.dtype != torch.float32
            or rootcol.dim() != 1):
        raise ValueError("rootcol must be a 1-D float32 CUDA tensor, got %s "
                         "%s on %s" % (rootcol.dtype, tuple(rootcol.shape),
                                       rootcol.device))
    if reach.shape != (n, n) or rootcol.shape != (n,):
        raise ValueError("reach [n, n] and rootcol [n] expected, got %s, %s"
                         % (tuple(reach.shape), tuple(rootcol.shape)))
    if rootcol.device != reach.device or not 0 <= out_cap < 1 << 31:
        raise ValueError("rootcol on reach's device and 0 <= out_cap < 2^31 "
                         "expected")
    ids = torch.empty((out_cap,), dtype=torch.int32, device=reach.device)
    count = torch.empty((), dtype=torch.int32, device=reach.device)
    _cuda.check(_lib().descendants_launch(
        reach.data_ptr(), rootcol.data_ptr(), rootcol.stride(0), n,
        ids.data_ptr(), count.data_ptr(), out_cap, _cuda.stream_of(reach)),
        "descendants")
    _cuda.count_launch("descendants")
    return ids, count
