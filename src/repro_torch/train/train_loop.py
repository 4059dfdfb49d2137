"""The train step: loss, gradients and AdamW, with microbatch
accumulation and remat, the reference's ``make_train_step`` on one
device.

Gradients come from ``torch.autograd.grad`` through ``lm.loss_fn`` with
``impl="xla"`` by default (plain differentiable torch ops; the kernels
have no backward, nor has the reference's Pallas path).  The model's
parameters are built without gradients; :func:`trainable` turns them on
only while a step takes its gradients, so the model serves as before
between steps.  Microbatches are accumulated unrolled into float32 sums
(the reference's ``zeros(float32) + g`` per microbatch, then ``/ n``), not
in ``.grad``, which would sum in a bf16 parameter's own dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, not_ported
from ..models import lm
from .optimizer import AdamWConfig, OptState, adamw_update

# the reference's GSPMD fields (ROADMAP.md queue 1 item 11 (e))
SHARDING_FIELDS = ("act_shard", "moe_group_axes", "moe_combine_axes")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1            # gradient accumulation steps
    remat: str = "dots"              # none | dots | full
    impl: str = "xla"                # attention/ssm impl: xla | pallas
    # the reference feeds it to its period scan for XLA's cost accounting;
    # the port's layers are a Python loop, so it changes nothing here
    scan_unroll: int = 1
    act_shard: Optional[Tuple] = None
    moe_groups: int = 1              # MoE dispatch groups
    moe_group_axes: Optional[Tuple[str, ...]] = None
    moe_combine_axes: Optional[Tuple[str, ...]] = None


@contextlib.contextmanager
def trainable(params: Dict[str, torch.Tensor]):
    """Parameters that take gradients inside the block, and none after."""
    for p in params.values():
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in params.values():
            p.requires_grad_(False)


def value_and_grad(model: lm.LM, batch: Dict[str, torch.Tensor],
                   **loss_kw) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]:
    """``jax.value_and_grad(lm.loss_fn, has_aux=True)`` on the model's
    parameters: ``(loss, {"ce", "aux"}, {parameter name: gradient})``,
    detached, each gradient in its parameter's dtype (0 for a leaf the
    loss does not read, as the embedding under ``embeds``)."""
    params = dict(model.named_parameters())
    with trainable(params):
        loss, metrics = lm.loss_fn(model, batch, **loss_kw)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(params.items(), grads)})


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``batch`` a dict of tensors on the model's device (leading
    axis the batch, split into ``tcfg.microbatches``); the model's
    parameters and the state's moments are updated in place; ``metrics``
    holds the last microbatch's ``loss``, ``ce`` and ``aux`` (as the
    reference reports them), ``grad_norm`` and ``lr``.  The sharding
    fields of ``tcfg`` are not ported: set, they raise."""
    for name in SHARDING_FIELDS:
        if getattr(tcfg, name) is not None:
            raise not_ported("TrainConfig.%s" % name,
                             "LM training and sharding")
    grads_of = functools.partial(value_and_grad, impl=tcfg.impl,
                                 remat=tcfg.remat, moe_groups=tcfg.moe_groups)

    def compute_grads(model, batch):
        n = tcfg.microbatches
        if n <= 1:
            return grads_of(model, batch)
        mbs = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
               for k, v in batch.items()}
        grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                 for name, p in model.named_parameters()}
        for i in range(n):
            loss, metrics, g = grads_of(model,
                                        {k: v[i] for k, v in mbs.items()})
            for name, acc in grads.items():
                acc.add_(g[name])
            del g
        for acc in grads.values():
            acc.div_(n)
        return loss, metrics, grads

    def train_step(model: lm.LM, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = compute_grads(model, batch)
        _, opt_state, opt_metrics = adamw_update(
            tcfg.opt, grads, opt_state, dict(model.named_parameters()))
        return model, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step
