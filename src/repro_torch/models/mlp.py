"""Dense SwiGLU MLP: ``silu(x @ wg) * (x @ wi) @ wo``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import dense, normal_param


class MLP(nn.Module):
    """Weights in the reference's layout: ``wi, wg [d_model, d_ff]``, ``wo
    [d_ff, d_model]``."""

    def __init__(self, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wi = nn.Parameter(wi, requires_grad=False)
        self.wg = nn.Parameter(wg, requires_grad=False)
        self.wo = nn.Parameter(wo, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.silu(dense(x, self.wg)) * dense(x, self.wi)
        return dense(h, self.wo)


def init_mlp(d_model: int, d_ff: int, generator: Optional[torch.Generator],
             device, dtype) -> MLP:
    return MLP(normal_param((d_model, d_ff), generator, device, dtype),
               normal_param((d_model, d_ff), generator, device, dtype),
               normal_param((d_ff, d_model), generator, device, dtype))
