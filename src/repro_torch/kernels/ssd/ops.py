"""Public SSD wrapper: the chunk size, the ``D`` skip and the dispatch.

CUDA tensors take the CUDA kernel, CPU tensors its plain version
(``ref.ssd_chunked``).  There is no fallback between the two: on a CUDA
tensor the kernel launches or the call raises.  Both pad T to a multiple
of the chunk with ``dt = 0`` (no decay, no update), so the final state is
the state after the last real step: the plain version pads, the kernel
masks the ragged tail of its last chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel, ref

DEFAULT_CHUNK = 128


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, D: Optional[torch.Tensor] = None,
        chunk: Optional[int] = None, init_state: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan: ``x [B,T,H,P]``, ``dt [B,T,H]`` float32, ``A [H]``,
    ``Bm, Cm [B,T,G,S]``, ``D [H]``, ``init_state [B,H,S,P]`` (zeros when
    None) -> ``(y [B,T,H,P]`` in x's dtype, ``final_state [B,H,S,P]``
    float32).  The chunk defaults to ``min(128, T)``.  The skip rounds as
    the reference's ``ops.ssd``: ``D * x`` in float32, cast to y's dtype,
    then added."""
    chunk = chunk or min(DEFAULT_CHUNK, x.shape[1])
    fn = kernel.ssd_cuda if x.is_cuda else ref.ssd_chunked
    y, state = fn(x, dt, A, Bm, Cm, chunk, init_state)
    if D is not None:
        y = y + (D.float()[None, None, :, None] * x.float()).to(y.dtype)
    return y, state
