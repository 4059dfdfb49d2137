"""SCEP Operator = Aggregator -> RSP engine(s) -> Publisher (paper §2, Fig 2a).

The operator owns a compiled plan, its pruned KB partition and the static
window geometry.  ``process`` merges/orders input chunks, windows them,
runs the engine over every window at once (or, in incremental mode, once
over the chunk's slides) and publishes the constructed output stream.

Every ``process*`` method takes ``with_stats``: True also returns the
engine's chunk metrics (``repro_torch.obs.metrics``) as a last element.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .engine import (
    Plan, run_plan_slide_tables, run_plan_slides, run_plan_window_tables,
    run_plan_windows, run_sink_slides, run_sink_windows,
)
from .kb import KnowledgeBase
from .pattern import compact_rows
from .planner import plan_supports_delta
from .rdf import TripleBatch
from .stream import merge_streams
from .window import (
    SlideView, Windows, count_slides, count_windows, window_slides,
    windows_from_slides,
)


def publish_chunk(out_w: TripleBatch, out_stream_cap: int) -> TripleBatch:
    """Publisher: flatten ``[W, cap]`` window outputs into one ordered chunk
    (order-preserving compaction of valid triples to the front)."""
    flat = out_w.map(lambda col: col.reshape(-1))
    rows = torch.stack([flat.s, flat.p, flat.o, flat.ts, flat.graph], dim=1)
    out, valid, _ = compact_rows(rows[None], flat.valid[None], out_stream_cap)
    out, valid = out[0], valid[0]
    return TripleBatch(s=out[:, 0], p=out[:, 1], o=out[:, 2], ts=out[:, 3],
                       graph=out[:, 4], valid=valid)


@dataclasses.dataclass(frozen=True)
class OperatorConfig:
    window_capacity: int = 1000      # paper: "a maximum of 1000 RDF triples"
    max_windows: int = 8             # windows per processed chunk
    out_stream_cap: int = 2048       # published stream chunk capacity
    window_step: Optional[int] = None  # STEP m slide; None / >= capacity tumbles
    incremental: bool = False        # delta evaluation over slides (when
                                     # the plan allows it)


class SCEPOperator:
    """One deployable SCEP operator."""

    def __init__(self, name: str, plan: Plan, kb: Optional[KnowledgeBase],
                 env: Dict[str, torch.Tensor],
                 config: Optional[OperatorConfig] = None):
        self.name = name
        self.plan = plan
        self.kb = kb
        self.env = dict(env)
        self.config = config if config is not None else OperatorConfig()

    def to(self, device) -> "SCEPOperator":
        """This operator with its KB slice and env on ``device``: itself
        when they are there already, else a copy (whose KB builds its
        kernel words and fences there)."""
        device = torch.device(device)
        kb_dev = self.kb.device if self.kb is not None else None
        if kb_dev in (None, device) and all(
                v.device == device for v in self.env.values()):
            return self
        return SCEPOperator(
            self.name, self.plan,
            self.kb.to(device) if self.kb is not None else None,
            {k: v.to(device) for k, v in self.env.items()}, self.config)

    def process_windows(self, windows: Windows, with_stats: bool = False,
                        first_window: int = 0):
        """Window-aligned engine step: ``[W, C]`` in -> ``[W, out_cap]`` out
        (the DAG runtime keeps upstream results in their window);
        ``first_window`` offsets a slice of a chunk's windows."""
        return run_plan_windows(self.plan, windows, self.kb, self.env,
                                with_stats=with_stats,
                                first_window=first_window)

    def process_slides(self, view: SlideView, with_stats: bool = False):
        """Slide-aligned engine step for incremental mode: the chunk runs
        once with delta state when the plan is delta-safe, else the
        overlapping windows are materialized and recomputed one by one;
        either way the ``[W, out_cap]`` output is the same bytes."""
        cfg = self.config
        _, r = window_slides(cfg.window_capacity, cfg.window_step)
        if plan_supports_delta(self.plan):
            return run_plan_slides(self.plan, view, r, cfg.max_windows,
                                   self.kb, self.env, with_stats=with_stats)
        windows = windows_from_slides(view, cfg.window_capacity,
                                      cfg.max_windows, cfg.window_step)
        return self.process_windows(windows, with_stats)

    # -- split-sink surfaces (see the engine's split-sink section) -----------
    def process_window_tables(self, windows: Windows,
                              pub_cols: Tuple[int, ...], rows_cap: int,
                              with_stats: bool = False):
        """Table-producing twin of :meth:`process_windows`: the operator's
        final binding table per window instead of its triple publication,
        what the split aggregation sink joins directly."""
        return run_plan_window_tables(self.plan, windows, pub_cols, rows_cap,
                                      self.kb, self.env, with_stats)

    def process_slide_tables(self, view: SlideView,
                             pub_cols: Tuple[int, ...], rows_cap: int,
                             with_stats: bool = False):
        """Incremental table producer: one chunk-level span-tagged table
        (the plan must be delta-safe; the split-sink builder checks)."""
        _, r = window_slides(self.config.window_capacity,
                             self.config.window_step)
        return run_plan_slide_tables(self.plan, view, pub_cols, rows_cap, r,
                                     self.kb, self.env, with_stats)

    def process_sink_windows(self, windows: Windows, tables,
                             with_stats: bool = False):
        """Split-sink step over RAW windows and per-window upstream tables
        (``self.plan`` is the rewritten plan with BindingJoin steps)."""
        return run_sink_windows(self.plan, windows, tables, self.kb, self.env,
                                with_stats)

    def process_sink_slides(self, view: SlideView, tables,
                            with_stats: bool = False):
        """Split-sink step on the delta path: the sink's own chain runs once
        per chunk over span-tagged upstream tables, finalized per window."""
        cfg = self.config
        _, r = window_slides(cfg.window_capacity, cfg.window_step)
        return run_sink_slides(self.plan, view, tables, r, cfg.max_windows,
                               self.kb, self.env, with_stats)

    def process(self, chunks: Sequence[TripleBatch], with_stats: bool = False):
        """Process one round of input chunks; returns (output chunk,
        overflow[W]), and the chunk stats when ``with_stats``."""
        cfg = self.config
        merged = merge_streams(chunks)                       # Aggregator
        if cfg.incremental:
            view = count_slides(merged, cfg.window_capacity, cfg.max_windows,
                                cfg.window_step)
            res = self.process_slides(view, with_stats)
        else:
            windows = count_windows(merged, cfg.window_capacity,
                                    cfg.max_windows, cfg.window_step)
            res = self.process_windows(windows, with_stats)  # engines
        return (publish_chunk(res[0], cfg.out_stream_cap),) + tuple(res[1:])

    # -- checkpoint surface (repro_torch.core.recovery) ------------------
    def state(self) -> Dict[str, torch.Tensor]:
        """Deep host copy of the operator's device state: the env tables
        its steps read (closure sets).  The copy waits for the work that
        writes them, so a checkpoint is a consistent cut."""
        return {k: v.to("cpu", copy=True) for k, v in self.env.items()}

    def restore_state(self, snap: Dict[str, torch.Tensor], device) -> None:
        """Put a :meth:`state` copy back on ``device`` (the operator's
        placed device), as tensors of its own."""
        self.env = {k: v.to(device, copy=True) for k, v in snap.items()}
