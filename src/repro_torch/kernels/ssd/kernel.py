"""CUDA wrapper for the SSD chunked-scan kernel (``kernels/csrc/ssd.cu``).

Replaces ``src/repro/kernels/ssd/kernel.py``'s ``ssd_pallas`` and takes
an initial state as well.  The TPU kernel carried the state across a
sequential chunk axis; here three launches (each chunk's own state, the
carry across chunks, the outputs) run the chunks in parallel (see the
source's header).  At the full width the work is ~3.2e10 operations
against ~0.11 GB.

The wrapper checks its arguments, allocates the outputs and the float32
scratch of per-chunk states, launches on PyTorch's current stream and
counts one launch.  ``x``, ``Bm`` and ``Cm`` may be strided views with a
contiguous last dimension (the model's slices of one projection); they
are read in place.  Nothing is built or loaded at import time.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _cuda
from .._cuda import I, LL, P

MAX_CHUNK = 128
STATE_SHAPES = ((16, 16), (32, 32), (64, 64), (128, 64))   # (d_state, headdim)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_READY = set()


def _lib():
    lib = _cuda.library("ssd")
    if "ssd" not in _READY:
        lib.ssd_launch.argtypes = [P] * 10 + [I] * 7 + [LL] * 9 + [I, P]
        lib.ssd_launch.restype = I
        _READY.add("ssd")
    return lib


def _require_rows(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """A 4-D CUDA tensor of ``dtype`` whose last dimension is contiguous."""
    if not t.is_cuda:
        raise ValueError("%s must be a CUDA tensor" % what)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (what, dtype, t.dtype))
    if t.dim() != 4:
        raise ValueError("%s must have 4 dims, got shape %s"
                         % (what, tuple(t.shape)))
    if t.stride(-1) != 1:
        raise ValueError("%s must have a contiguous last dimension" % what)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ref.ssd_chunked`` on the card: ``x [B,T,H,P]``, ``dt [B,T,H]``
    float32, ``A [H]`` float32, ``Bm, Cm [B,T,G,S]`` in x's dtype,
    ``init_state [B,H,S,P]`` float32 or None -> ``(y [B,T,H,P]`` in x's
    dtype, ``final_state [B,H,S,P]`` float32)."""
    if x.dtype not in DTYPES:
        raise TypeError("ssd takes float32 or bfloat16, got %s" % x.dtype)
    _require_rows(x, x.dtype, "ssd x")
    _require_rows(Bm, x.dtype, "ssd B")
    _require_rows(Cm, x.dtype, "ssd C")
    _cuda.require(dt, torch.float32, 3, "ssd dt")
    _cuda.require(A, torch.float32, 1, "ssd A")
    b, t, h, p = x.shape
    g, s = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, t, h) or A.shape != (h,) or Bm.shape[:2] != (b, t)
            or Cm.shape != Bm.shape or g == 0 or h % g):
        raise ValueError(
            "ssd: x %s, dt %s, A %s, B %s, C %s do not fit [B,T,H,P], "
            "[B,T,H], [H], [B,T,G,S] with H a multiple of G"
            % (tuple(x.shape), tuple(dt.shape), tuple(A.shape),
               tuple(Bm.shape), tuple(Cm.shape)))
    if (s, p) not in STATE_SHAPES:
        raise ValueError("ssd: (d_state, headdim) = (%d, %d) not in %s"
                         % (s, p, STATE_SHAPES))
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError("ssd: chunk %d not in [1, %d]" % (chunk, MAX_CHUNK))
    if init_state is not None:
        _cuda.require(init_state, torch.float32, 4, "ssd init_state")
        if init_state.shape != (b, h, s, p):
            raise ValueError("ssd: init_state %s is not [B,H,S,P] = %s"
                             % (tuple(init_state.shape), (b, h, s, p)))
    nl = -(-t // chunk)
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, h, nl, s, p), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((b, h, nl), dtype=torch.float32, device=x.device)
    _cuda.check(_lib().ssd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), states.data_ptr(), decay.data_ptr(),
        b, t, h, g, s, p, chunk, *x.stride()[:3], *Bm.stride()[:3],
        *Cm.stride()[:3], DTYPES[x.dtype], _cuda.stream_of(x)), "ssd")
    _cuda.count_launch("ssd")
    return y, final
