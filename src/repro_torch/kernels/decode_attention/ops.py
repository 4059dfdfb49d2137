"""Public decode-attention wrapper: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.  There is no fallback between the
two: on a CUDA tensor the kernel launches or the call raises."""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """GQA decode attention: ``q [B, Hq, 1, D]`` against the cache rows
    ``[max(0, lengths[b] - window), min(lengths[b], S))`` of ``k [B, Hk, S,
    D]`` and ``v [B, Hk, S, Dv]`` -> ``[B, Hq, 1, Dv]``; 0 where no row is
    live (see ``ref.decode_attention_ref``)."""
    if q.is_cuda:
        if lengths.dtype != torch.int32:
            lengths = lengths.to(torch.int32)
        return kernel.decode_attention_cuda(q, k, v, lengths, window)
    return ref.decode_attention_ref(q, k, v, lengths, window)
