"""LM serving: cached prefill, one-token decode steps, batched generation
and the continuous batcher.

``prefill`` consumes the whole prompt into an empty cache and projects
only the last position through the head; ``step`` feeds one token per
sequence (K tokens, one a codebook, for MusicGen).  Both update the cache
in place and return logits ``[B, Vp]`` (``[B, K, Vp]`` for K codebooks).
For attention stacks the prefill runs flash attention over the KV cache
(``q_offset`` = the cache length) and a step decode attention; for
Mamba-2 stacks the prefill runs the SSD kernel from the cached state and
a step the one-token recurrence.

:func:`generate` runs on the card unless ``device="cpu"`` is passed, and
raises when it is asked for the card and none is visible.

:class:`ContinuousBatcher` owns ``num_slots`` decode lanes of one cache
with per-sequence lengths (``lm.init_cache(per_seq=True)``): queued
requests claim free lanes (a prefill each), every tick decodes all lanes
in one fixed-shape step, and finished sequences release their lanes.  Its
``(prefill_one, decode_all)`` callables come from
``launch.serve.make_slot_fns``.  The lifecycle is the reference's
(``serve/lm.py``), with one difference: each lane's positions come from
its own cache length, where the reference's batcher passes ``len(prompt)
+ 1`` after the prefill as the position of the token stored at
``len(prompt)`` (its every decoded token is rotated one position ahead of
its cache row; ``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import lm
from ..models.common import resolve_device


def make_serve_fns(model: lm.LM) -> Tuple[Callable, Callable]:
    """``(prefill, step)``: ``prefill(tokens [B, T], cache)`` and
    ``step(tokens [B, 1], cache)`` (``[B, T, K]`` and ``[B, 1, K]`` for K
    codebooks), each -> logits ``[B, Vp]`` (``[B, K, Vp]``) of the last
    position, the cache advanced in place.  They are one call: the cache's
    length (0 for a prefill) sets the positions and the attention path."""
    fn = functools.partial(lm.decode_step, model, last_only=True)
    return fn, fn


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 1.0) -> torch.Tensor:
    """Greedy at temperature 0, else a draw from ``softmax(logits / T)``
    over the last axis with ``generator`` (which must live on the logits'
    device): ``[B, Vp]`` -> ``[B]``, ``[B, K, Vp]`` -> ``[B, K]``."""
    if temperature == 0.0:
        return greedy_token(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


@torch.no_grad()
def generate(model: lm.LM, prompt, max_new: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> torch.Tensor:
    """Batched generation (greedy by default): ``prompt [B, T]`` token ids
    -> ``[B, max_new]`` int32 on ``device``, where ``model`` must live
    (``[B, T, K]`` -> ``[B, max_new, K]`` for K codebooks).
    ``max_len`` (default: prompt + new tokens) sizes the KV cache; Mamba
    caches do not grow with it, but it is held to the same bound."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError("the model lives on %s, generate was asked for %s"
                         % (model.device, dev))
    prompt = torch.as_tensor(prompt).to(device=model.device,
                                        dtype=torch.int64)
    b, t = prompt.shape[:2]
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


# --------------------------------------------------------------------------
# continuous batcher (slot lanes of one per-sequence cache)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class SlotState:
    request: Optional[Request] = None
    pos: int = 0                  # the lane's next cache row


class ContinuousBatcher:
    """Host-side slot manager around ``(prefill_one, decode_all)``:

    * ``prefill_one(tokens [1, T], cache, slot) -> (logits [1, Vp],
      cache)`` fills lane ``slot`` with a prompt;
    * ``decode_all(tokens [num_slots, 1], cache) -> (logits [num_slots,
      Vp], cache)`` advances every lane by one token, each at its own
      cache length.

    A caller may wrap either.  A tick admits queued requests into free
    lanes, then decodes all lanes (idle ones fed token 0, as the
    reference's); the next ids are the argmax on the device, read to the
    host once a tick.  A request is done at ``max_new`` ids or at
    ``eos_id``."""

    def __init__(self, num_slots: int, prefill_fn: Callable,
                 decode_fn: Callable, eos_id: int = -1):
        self.num_slots = num_slots
        self.slots = [SlotState() for _ in range(num_slots)]
        self.queue: Deque[Request] = deque()
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.eos_id = eos_id
        self.completed: List[Request] = []

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.request is None:
                return i
        return None

    def _admit(self, cache: Dict) -> Dict:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return cache
            req = self.queue.popleft()
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64))[None]
            logits, cache = self.prefill_fn(tokens, cache, slot)
            req.generated.append(int(torch.argmax(logits[0])))
            self.slots[slot] = SlotState(req, pos=len(req.prompt))
        return cache

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.request is not None]

    # -- one engine tick -----------------------------------------------------
    def step(self, cache: Dict) -> Tuple[Dict, bool]:
        cache = self._admit(cache)
        act = self.active()
        if not act:
            return cache, False
        tokens = np.zeros((self.num_slots, 1), np.int64)
        for i in act:
            tokens[i, 0] = self.slots[i].request.generated[-1]
        logits, cache = self.decode_fn(torch.from_numpy(tokens), cache)
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i in act:
            s = self.slots[i]
            tok = int(nxt[i])
            s.request.generated.append(tok)
            s.pos += 1
            if tok == self.eos_id or len(s.request.generated) >= s.request.max_new:
                s.request.done = True
                self.completed.append(s.request)
                self.slots[i] = SlotState()
        return cache, True

    def run_until_drained(self, cache: Dict, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or self.active()) and ticks < max_ticks:
            cache, _ = self.step(cache)
            ticks += 1
        return cache, ticks
