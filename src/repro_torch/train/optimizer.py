"""AdamW with gradient clipping and a warmup + cosine schedule, the
reference's (``train/optimizer.py``).

The state mirrors the parameters, one float32 ``m`` and ``v`` a leaf
whatever the parameter's dtype (bf16 training with float32 statistics);
here the leaves are ``{name: tensor}`` dicts keyed as
``LM.named_parameters()`` (``interop.opt_state_to_arrays`` lays them out
as the reference's tree).  Weight decay applies to every leaf, norms and
embeddings included; the rate is taken at the old step and the bias
corrections at the new one, as the reference does.  The schedule and the
bias corrections are float32 host numbers (numpy), so a step reads
nothing back from the device.  The reference's ZeRO-1 shardings
(``zero1_shardings``, ``opt_state_shardings``) belong to ROADMAP.md queue
1 item 11 (e) and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Tuple

import numpy as np
import torch

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


class OptState(NamedTuple):
    """``step``: the updates taken (a host int); ``m``, ``v``: float32
    moments, ``{parameter name: tensor}``."""
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def lr_at(cfg: AdamWConfig, step: int) -> np.float32:
    """The rate at ``step``, in float32 as the reference computes it:
    linear warmup ``peak · (step + 1) / warmup`` below ``warmup_steps``,
    then a cosine from ``peak`` to ``peak · min_lr_ratio`` at
    ``total_steps``, flat after."""
    s = F32(step)
    warm = F32(cfg.peak_lr) * (s + F32(1.0)) / F32(max(1, cfg.warmup_steps))
    t = np.clip((s - F32(cfg.warmup_steps))
                / F32(max(1, cfg.total_steps - cfg.warmup_steps)),
                F32(0.0), F32(1.0))
    cos = F32(cfg.peak_lr) * (
        F32(cfg.min_lr_ratio) + F32((1 - cfg.min_lr_ratio) * 0.5)
        * (F32(1.0) + np.cos(F32(np.pi) * t)))
    return F32(warm if s < cfg.warmup_steps else cos)


def init_opt_state(params: Dict[str, torch.Tensor]) -> OptState:
    """Zero moments in float32 on each parameter's device, step 0."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return OptState(0, zeros(), zeros())


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of every leaf's squares)`` in float32, a 0-d tensor on
    the leaves' device."""
    return torch.sqrt(torch.stack(
        [torch.sum(g.float() ** 2) for g in leaves]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor],
                 state: OptState, params: Dict[str, torch.Tensor],
                 ) -> Tuple[Dict[str, torch.Tensor], OptState,
                            Dict[str, torch.Tensor]]:
    """One AdamW step, the reference's arithmetic leaf for leaf: the
    gradients scaled by ``min(1, clip / (norm + 1e-9))``, the moments
    updated, ``p - lr · (m̂ / (sqrt(v̂) + eps) + wd · p)`` in float32 cast
    back to the parameter's dtype.  ``params`` and the moments are updated
    in place (one leaf at a time, so no second copy of the state is held)
    -> ``(params, OptState(step + 1, m, v), {"grad_norm", "lr"})``."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = float(lr_at(cfg, state.step))
    b1c = float(F32(1.0) - F32(cfg.b1) ** F32(step))
    b2c = float(F32(1.0) - F32(cfg.b2) ** F32(step))
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, OptState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": torch.tensor(lr)}
