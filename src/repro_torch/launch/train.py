"""Training driver on one device: synthetic token batches -> the train
step (``impl="xla"``, AdamW) -> atomic async checkpoints -> an injected
failure, a restore and a resume; the reference's ``launch/train.py``
with its flags and printed lines.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 20 --batch 8 --seq 64
    # a crash at step 12, then a resume from the newest checkpoint
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 20 --fail-at 12 --retries 1

It runs on the card (``main(argv, device="cpu")`` from Python runs the
plain torch path on the CPU).  The manifest's ``mesh_shape`` is
``launch.mesh.make_host_mesh()``'s (a 1 x 1 mesh of the CPU there);
parameter and optimizer shardings are ROADMAP.md queue 1 item 11 (e).
Weights come from a seeded generator on the device, not the reference's
PRNG, so the two launchers start from other weights; a checkpoint of
either resumes in the other.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .. import interop
from ..configs import get_config, smoke_variant
from ..data.tokens import TokenDatasetConfig, batch_at_step
from ..models import lm
from ..models.common import resolve_device
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_loop import TrainConfig, make_train_step
from .mesh import Mesh, make_host_mesh


class InjectedFailure(RuntimeError):
    pass


def build(arch: str, smoke: bool, batch: int, seq: int, microbatches: int,
          remat: str, lr: float, steps: int, device="cuda"):
    """``(cfg, mesh, model, opt_state, step_fn, dcfg)``: the reference's
    build on one device (a seeded model, zero moments, the schedule's
    warmup ``max(2, steps // 10)``)."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    tcfg = TrainConfig(
        opt=AdamWConfig(peak_lr=lr, warmup_steps=max(2, steps // 10),
                        total_steps=steps),
        microbatches=microbatches, remat=remat)
    dev = resolve_device(device)
    mesh = (make_host_mesh() if dev.type == "cuda"
            else Mesh(np.array([[dev]], dtype=object), ("data", "model")))
    model = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    opt_state = init_opt_state(dict(model.named_parameters()))
    dcfg = TokenDatasetConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch)
    return cfg, mesh, model, opt_state, make_train_step(cfg, tcfg), dcfg


def train(args, device="cuda") -> dict:
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    attempt = 0
    while True:
        attempt += 1
        try:
            return _train_once(args, ckpt, attempt, device)
        except InjectedFailure as e:
            if attempt > args.retries:
                raise
            print(f"[train] node failure injected: {e}; "
                  f"restarting (attempt {attempt + 1}) from latest checkpoint")


def _state_tree(model, opt_state):
    return (interop.lm_params_to_arrays(model),
            interop.opt_state_to_arrays(opt_state, model))


def _train_once(args, ckpt: CheckpointManager, attempt: int,
                device="cuda") -> dict:
    cfg, mesh, model, opt_state, step_fn, dcfg = build(
        args.arch, args.smoke, args.batch, args.seq, args.microbatches,
        args.remat, args.lr, args.steps, device)
    n_params = sum(p.numel() for p in model.parameters())
    mesh_shape = dict(mesh.shape)
    start = 0
    ckpt.wait()       # a restart in this process sees its last save
    if ckpt.latest_step() is not None:
        (params, opt), manifest = ckpt.restore(_state_tree(model, opt_state))
        model = interop.lm_params_from_arrays(params, cfg, model.device)
        opt_state = interop.opt_state_from_arrays(opt, model)
        start = manifest["step"] + 1
        print(f"[train] restored step {manifest['step']} "
              f"(mesh then: {manifest.get('mesh_shape')}, "
              f"mesh now: {mesh_shape})")

    print(f"[train] {args.arch} params={n_params / 1e6:.1f}M "
          f"batch={args.batch}x{args.seq} steps={start}->{args.steps}")
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        if args.fail_at is not None and step == args.fail_at and attempt == 1:
            raise InjectedFailure(f"simulated node loss at step {step}")
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in batch_at_step(dcfg, step).items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"[train] step {step:5d} loss {loss:7.4f} "
                  f"grad_norm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}")
        if step % args.ckpt_every == 0 and step > start:
            ckpt.save(step, _state_tree(model, opt_state),
                      mesh_shape=mesh_shape)
    ckpt.save(args.steps - 1, _state_tree(model, opt_state),
              mesh_shape=mesh_shape, blocking=True)
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps_run": len(losses), "params": n_params,
              "losses": dict(zip(range(start, args.steps), losses))}
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return result


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (container scale)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (first attempt)")
    ap.add_argument("--retries", type=int, default=1)
    args = ap.parse_args(argv)
    return train(args, device)


if __name__ == "__main__":
    main()
