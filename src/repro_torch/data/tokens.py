"""Deterministic synthetic token batches for LM training, byte for byte
the reference's.

Each ``(seed, step, host_id)`` keys its own numpy ``SeedSequence``, so a
resumed run, or another data-parallel host, draws exactly the batches an
uninterrupted run would: no shuffle state to lose on a failure.  Host
only (numpy); the caller moves a batch to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDatasetConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def _batch_rng(cfg: TokenDatasetConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def host_batch_shape(cfg: TokenDatasetConfig) -> Tuple[int, int]:
    if cfg.global_batch % cfg.num_hosts:
        raise ValueError("batch %d must divide over %d hosts"
                         % (cfg.global_batch, cfg.num_hosts))
    return (cfg.global_batch // cfg.num_hosts, cfg.seq_len)


def batch_at_step(cfg: TokenDatasetConfig, step: int) -> dict:
    """This host's batch at absolute step ``step``: ``tokens`` int32 ``[B,
    T]`` drawn zipf(1.3) and clipped to the vocabulary (a natural-text-like
    marginal), ``labels`` the tokens shifted left by one, the last 0."""
    shape = host_batch_shape(cfg)
    rng = _batch_rng(cfg, step)
    z = rng.zipf(1.3, size=shape).astype(np.int64)
    tokens = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels}


def token_stream(cfg: TokenDatasetConfig,
                 start_step: int = 0) -> Iterator[dict]:
    """The batches from ``start_step`` on: resume a run at its checkpoint's
    step."""
    step = start_step
    while True:
        yield batch_at_step(cfg, step)
        step += 1
