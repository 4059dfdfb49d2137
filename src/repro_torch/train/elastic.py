"""The elastic runner, the reference's (``train/elastic.py``): host only.

* **Failures**: an exception from a step (an injected one, a lost device,
  a non-finite loss when ``nan_is_failure``) restores the newest
  checkpoint and resumes from it; after ``max_restarts`` restarts the
  runner moves down its list of mesh shapes (elastic downsizing) and
  counts again.
* **Stragglers**: an EWMA of step wall times; a step slower than
  ``straggler_factor`` times the EWMA before it is flagged.
* **Deterministic resume**: the data is keyed by absolute step
  (``data/tokens.py``), so a resumed run draws the batches the failed one
  would have.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ElasticConfig:
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    checkpoint_every: int = 50
    nan_is_failure: bool = True


@dataclasses.dataclass
class StepRecord:
    step: int
    wall_time: float
    loss: float
    straggler: bool
    restart_count: int


class ElasticRunner:
    """Drives a step function with checkpoint/restart and straggler
    accounting."""

    def __init__(self, cfg: ElasticConfig, ckpt_mgr,
                 mesh_shapes: List[Dict[str, int]]):
        """``mesh_shapes``: mesh shapes in order of preference; a resize
        moves one down the list."""
        self.cfg = cfg
        self.ckpt = ckpt_mgr
        self.mesh_shapes = mesh_shapes
        self.mesh_index = 0
        self.restart_count = 0
        self.ewma: Optional[float] = None
        self.history: List[StepRecord] = []

    def current_mesh_shape(self) -> Dict[str, int]:
        return self.mesh_shapes[self.mesh_index]

    def should_resize(self) -> bool:
        return (self.restart_count >= self.cfg.max_restarts
                and self.mesh_index + 1 < len(self.mesh_shapes))

    def resize(self) -> Dict[str, int]:
        self.mesh_index += 1
        self.restart_count = 0
        return self.current_mesh_shape()

    def run(self, state: Tuple,
            step_fn: Callable[[Tuple, int], Tuple[Tuple, Dict]],
            start_step: int, num_steps: int,
            save_fn: Callable[[Tuple, int], None],
            restore_fn: Callable[[], Tuple[Tuple, int]],
            failure_schedule: Optional[Dict[int, Exception]] = None,
            ) -> Tuple[Tuple, List[StepRecord]]:
        """Run ``num_steps`` steps from ``start_step`` with recovery.
        ``failure_schedule`` raises the given exception at a step, once
        each (node-failure simulation); a checkpoint is saved every
        ``checkpoint_every`` steps and after the last."""
        failure_schedule = dict(failure_schedule or {})
        step = start_step
        end = start_step + num_steps
        while step < end:
            t0 = time.monotonic()
            try:
                if step in failure_schedule:
                    raise failure_schedule.pop(step)
                state, metrics = step_fn(state, step)
                loss = float(metrics.get("loss", np.nan))
                if self.cfg.nan_is_failure and not np.isfinite(loss):
                    raise FloatingPointError("non-finite loss at step %d"
                                             % step)
            except Exception:
                self.restart_count += 1
                if self.should_resize():
                    self.resize()
                state, step = restore_fn()
                continue
            wall = time.monotonic() - t0
            prev = self.ewma
            self.ewma = wall if prev is None else (
                self.cfg.ewma_alpha * wall + (1 - self.cfg.ewma_alpha) * prev)
            straggler = prev is not None and wall > self.cfg.straggler_factor * prev
            self.history.append(
                StepRecord(step, wall, loss, straggler, self.restart_count))
            step += 1
            if step % self.cfg.checkpoint_every == 0 or step == end:
                save_fn(state, step)
        return state, self.history
