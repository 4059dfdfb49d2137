"""The reference's input shapes (one set, shared by every LM
architecture), field for field.

``train_*`` is a training step's batch; ``prefill_*`` a full-sequence
prefill; ``decode_*``/``long_*`` one new token against a cache of the
stated length.  ``long_500k`` needs a sub-quadratic mixer (SSM, hybrid or
a sliding window).  Host only.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = InputShape("train_4k", "train", 4_096, 256)
PREFILL_32K = InputShape("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = InputShape("decode_32k", "decode", 32_768, 128)
LONG_500K = InputShape("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)


def get_shape(name: str) -> InputShape:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
