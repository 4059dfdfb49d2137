"""LM serving: cached prefill, one-token decode steps, batched generation.

``prefill`` consumes the whole prompt into an empty cache and projects
only the last position through the head; ``step`` feeds one token per
sequence.  Both update the cache in place and return logits ``[B, Vp]``.
For attention stacks the prefill runs flash attention over the KV cache
(``q_offset`` = the cache length) and a step decode attention; for
Mamba-2 stacks the prefill runs the SSD kernel from the cached state and
a step the one-token recurrence.

:func:`generate` runs on the card unless ``device="cpu"`` is passed, and
raises when it is asked for the card and none is visible.  The reference's
continuous batcher (per-sequence cache lengths) is not ported yet
(``ROADMAP.md`` queue 1: LM continuous batching).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ..models import lm
from ..models.common import resolve_device


def make_serve_fns(model: lm.LM) -> Tuple[Callable, Callable]:
    """``(prefill, step)``: ``prefill(tokens [B, T], cache)`` and
    ``step(tokens [B, 1], cache)``, each -> logits ``[B, Vp]`` of the last
    position, the cache advanced in place.  They are one call: the cache's
    length (0 for a prefill) sets the positions and the attention path."""
    fn = functools.partial(lm.decode_step, model, last_only=True)
    return fn, fn


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 1.0) -> torch.Tensor:
    """Greedy at temperature 0, else a draw from ``softmax(logits / T)``
    with ``generator`` (which must live on the logits' device)."""
    if temperature == 0.0:
        return greedy_token(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(model: lm.LM, prompt, max_new: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> torch.Tensor:
    """Batched generation (greedy by default): ``prompt [B, T]`` token ids
    -> ``[B, max_new]`` int32 on ``device``, where ``model`` must live.
    ``max_len`` (default: prompt + new tokens) sizes the KV cache; Mamba-2
    caches do not grow with it, but it is held to the same bound."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError("the model lives on %s, generate was asked for %s"
                         % (model.device, dev))
    prompt = torch.as_tensor(prompt).to(device=model.device,
                                        dtype=torch.int64)
    b, t = prompt.shape
    max_len = max_len or (t + max_new)
    if max_len < t + max_new - 1:
        raise ValueError("max_len %d cannot hold a %d-token prompt and %d "
                         "new tokens" % (max_len, t, max_new))
    cache = lm.init_cache(model.cfg, b, max_len, model.device)
    prefill, step = make_serve_fns(model)
    tok = sample_token(prefill(prompt, cache), generator, temperature)
    toks = [tok]
    for _ in range(max_new - 1):
        tok = sample_token(step(tok[:, None], cache), generator, temperature)
        toks.append(tok)
    return torch.stack(toks, dim=1)
