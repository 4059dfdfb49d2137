"""Public flash-attention wrapper: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.  There is no fallback between the
two: on a CUDA tensor the kernel launches or the call raises."""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA attention, ``q [B, Hq, Tq, D]`` against ``k [B, Hk, Tk, D]``,
    ``v [B, Hk, Tk, Dv]`` -> ``[B, Hq, Tq, Dv]`` in ``q``'s dtype; query
    row ``i`` sits at absolute position ``q_offset + i`` (see
    ``ref.attention_ref``)."""
    if q.is_cuda:
        return kernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
