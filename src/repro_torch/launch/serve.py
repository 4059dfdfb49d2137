"""Serving launcher: continuous-batched generation over the port's LM
architectures.

Synthetic ragged requests flow through the
:class:`~repro_torch.serve.lm.ContinuousBatcher`; each engine tick decodes
every slot lane in one fixed-shape step.  It runs on the card::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --requests 12 --slots 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b

The flags are the reference launcher's (``launch/serve.py``).  Its
``--smoke`` is a ``store_true`` flag whose default is already true, so it
cannot be turned off: the launcher always serves the smoke variant of the
architecture, as the reference's does (``ROADMAP.md`` queue 3).  Serving at
full width calls :func:`make_slot_fns` and the batcher directly.
``main``'s ``device`` argument is how a caller (the tests) asks for the
CPU.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..configs import get_config, smoke_variant
from ..models import lm
from ..models.common import resolve_device
from ..serve.lm import ContinuousBatcher, Request


def lane_view(cache: Dict, slot: int) -> Dict:
    """Lane ``slot`` of a per-sequence cache as a batch-1 cache sharing its
    memory, with a shared length of 0: every stacked tensor of the cache,
    whatever mix of attention and Mamba layers it holds."""
    view = {k: t[:, slot:slot + 1] for k, t in cache.items() if k != "len"}
    view["len"] = 0
    return view


def make_slot_fns(model: lm.LM, max_len: int) -> Tuple[Callable, Callable]:
    """``(prefill_one, decode_all)`` over the slot lanes of a cache from
    ``lm.init_cache(per_seq=True)``:

    * ``prefill_one(tokens [1, T], cache, slot)`` zeroes every cache
      tensor of lane ``slot`` (keys and values or MLA's latent rows of the
      attention layers, conv tails and SSM states of the Mamba layers),
      runs the prompt through the lane's view at a shared length of 0
      (the flash kernel with ``q_offset`` 0 in an attention layer, Mamba's
      scan from a zero state: the SSD kernel for Mamba-2, the chunked
      selective scan for Mamba-1), then sets the lane's length to T;
    * ``decode_all(tokens [num_slots, 1], cache)`` runs one step over all
      lanes, each at its own length (decode attention over its live rows
      in an attention layer, the one-token recurrence in a Mamba layer).

    Each returns ``(logits of the last position [B, Vp], cache)``; the
    cache is updated in place.  A prompt longer than ``max_len`` raises."""
    step = functools.partial(lm.decode_step, model, last_only=True)

    @torch.no_grad()
    def prefill_one(tokens: torch.Tensor, cache: Dict, slot: int):
        t = tokens.shape[1]
        if t > max_len:
            raise ValueError("a prompt of %d ids does not fit a lane of %d "
                             "rows" % (t, max_len))
        lane = lane_view(cache, slot)
        for name, tensor in lane.items():
            if name != "len":
                tensor.zero_()
        logits = step(tokens.to(model.device), lane)
        cache["len"][slot] = t
        return logits, cache

    @torch.no_grad()
    def decode_all(tokens: torch.Tensor, cache: Dict):
        return step(tokens.to(model.device), cache), cache

    return prefill_one, decode_all


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if cfg.num_codebooks:
        raise ValueError("the serving launcher serves token LMs")
    dev = resolve_device(device)
    model = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    cache = lm.init_cache(cfg, args.slots, args.max_len, device=dev,
                          per_seq=True)
    prefill_one, decode_all = make_slot_fns(model, args.max_len)
    batcher = ContinuousBatcher(args.slots, prefill_one, decode_all)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        batcher.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=int(rng.integers(4, args.max_new)),
        ))

    t0 = time.time()
    cache, ticks = batcher.run_until_drained(cache)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    done = len(batcher.completed)
    toks = sum(len(r.generated) for r in batcher.completed)
    print(f"[serve] {args.arch}: {done}/{args.requests} requests drained in "
          f"{ticks} ticks, {toks} tokens, {toks / max(dt, 1e-9):.1f} tok/s")
    for r in batcher.completed[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated[:8]}...")
    if done != args.requests:
        raise RuntimeError("%d of %d requests drained" % (done, args.requests))
    return done


if __name__ == "__main__":
    main()
