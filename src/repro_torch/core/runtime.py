"""DSCEP runtimes: the decomposed operator DAG and the monolithic baseline.

* :class:`DSCEPRuntime` — every operator of the decomposed DAG runs on the
  same window batch; intermediate results stay **window-aligned**: the
  aggregation operator sees upstream outputs appended to the very window
  that produced them, which is what makes decomposed and monolithic results
  identical (paper: "All results are the same").  The aggregator always
  takes this augmented-window path (the split sink is not ported yet).
* :class:`MonolithicRuntime` — one operator, the whole query, the full KB
  (the paper's baseline).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .kb import KnowledgeBase, collect_kb_stats, pad_to
from .operator import OperatorConfig, SCEPOperator, publish_chunk
from .planner import (
    OperatorDAG, augment_kb_with_closures, compile_query, prepare_env,
    prune_kb_for,
)
from .rdf import TripleBatch, Vocab
from .stream import merge_streams
from .window import Windows, count_slides, count_windows, windows_from_slides


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    window_capacity: int = 1000
    max_windows: int = 8
    out_stream_cap: int = 2048
    # sliding count windows: STEP m slide size (None / >= capacity tumbles)
    window_step: Optional[int] = None
    # incremental (delta) evaluation: each chunk runs once with slide-span
    # tracking and every window selects its rows, instead of re-running the
    # join chain per window.  Same output bytes; plans with OPTIONAL
    # (non-monotone) fall back to recompute per operator.
    incremental: bool = False
    # KB-access method: "scan" | "probe" | "auto" (per-join cost model)
    kb_method: str = "scan"
    kb_capacity: Optional[int] = None
    scan_cap: int = 128
    bind_cap: int = 256
    out_cap: int = 512
    # capacity of window-aligned intermediate binding streams between
    # operators (the aggregator's window grows by the sum of these)
    intermediate_cap: int = 512
    # scan-method KB joins: fused (matches compacted where they are found)
    # or unfused (the [M, N] candidate matrix, then compaction)
    fuse_compaction: bool = True

    def operator_config(self) -> OperatorConfig:
        return OperatorConfig(self.window_capacity, self.max_windows,
                              self.out_stream_cap, self.window_step,
                              self.incremental)


def build_operators(dag: OperatorDAG, kb: KnowledgeBase,
                    config: RuntimeConfig) -> Dict[str, SCEPOperator]:
    """Compile one :class:`SCEPOperator` per DAG node, each with its own
    used-KB slice (pruned, closure-augmented, profiled under ``auto``)."""
    operators: Dict[str, SCEPOperator] = {}
    for name, sub in dag.subqueries.items():
        op_kb = None
        kb_stats = None
        if sub.touches_kb:
            op_kb = prune_kb_for(sub.query, kb)
            op_kb = augment_kb_with_closures(sub.query, op_kb)
            if config.kb_method == "auto":
                kb_stats = collect_kb_stats(op_kb)
            if config.kb_capacity:
                op_kb = pad_to(op_kb, config.kb_capacity)
        plan = compile_query(
            sub.query,
            kb_method=config.kb_method,
            scan_cap=config.scan_cap,
            bind_cap=config.bind_cap,
            out_cap=(config.out_cap if name == dag.final
                     else min(config.intermediate_cap, config.out_cap)),
            kb_stats=kb_stats,
            fuse_compaction=config.fuse_compaction,
        )
        env = prepare_env(sub.query, kb)
        operators[name] = SCEPOperator(name, plan, op_kb, env,
                                       config.operator_config())
    return operators


def augment_windows(dag: OperatorDAG, windows: Windows,
                    upstream_out: Dict[str, TripleBatch]) -> Windows:
    """Append upstream operator outputs to the very window that produced
    them, in the final sub-query's declared input order."""
    parts = [windows.triples] + [
        upstream_out[src]
        for src in dag.subqueries[dag.final].inputs
        if src != "stream"
    ]
    aug = TripleBatch(*(torch.cat(cols, dim=-1) for cols in zip(*parts)))
    return Windows(aug, windows.window_valid)


class _OverflowAccumulator:
    """Lifetime per-operator overflowed-window counts, kept on the device
    (the host syncs only when they are read)."""

    def __init__(self, names: Sequence[str], device):
        self._acc = {n: torch.zeros((), dtype=torch.int64, device=device)
                     for n in names}

    def add(self, name: str, flags: torch.Tensor) -> None:
        self._acc[name] = self._acc[name] + flags.sum()

    def totals(self) -> Dict[str, int]:
        return {n: int(v) for n, v in self._acc.items()}


class DSCEPRuntime:
    """Executes a decomposed query DAG over chunked input streams."""

    def __init__(self, dag: OperatorDAG, kb: KnowledgeBase, vocab: Vocab,
                 config: Optional[RuntimeConfig] = None):
        self.dag = dag
        self.config = config if config is not None else RuntimeConfig()
        self.vocab = vocab
        self.operators = build_operators(dag, kb, self.config)
        self._overflow = _OverflowAccumulator(self.operators, kb.device)

    def process_chunk(self, chunk: TripleBatch) -> Tuple[TripleBatch, Dict[str, torch.Tensor]]:
        """Push one stream chunk through the DAG; returns (final output,
        per-operator overflow flags [W])."""
        cfg = self.config
        merged = merge_streams([chunk])
        view = None
        if cfg.incremental:
            # upstreams run delta over the slides; the aggregator still gets
            # materialized windows (upstream outputs are window-aligned)
            view = count_slides(merged, cfg.window_capacity, cfg.max_windows,
                                cfg.window_step)
            windows = windows_from_slides(view, cfg.window_capacity,
                                          cfg.max_windows, cfg.window_step)
        else:
            windows = count_windows(merged, cfg.window_capacity,
                                    cfg.max_windows, cfg.window_step)
        final = self.dag.final
        overflow: Dict[str, torch.Tensor] = {}
        upstream_out: Dict[str, TripleBatch] = {}
        for name in self.dag.subqueries:
            if name == final:
                continue
            op = self.operators[name]
            upstream_out[name], overflow[name] = (
                op.process_slides(view) if view is not None
                else op.process_windows(windows))
        aug = augment_windows(self.dag, windows, upstream_out)
        out_w, overflow[final] = self.operators[final].process_windows(aug)
        for name, flags in overflow.items():
            self._overflow.add(name, flags)
        return publish_chunk(out_w, cfg.out_stream_cap), overflow

    def process_stream(self, chunks: Sequence[TripleBatch]
                       ) -> Tuple[List[TripleBatch], Dict[str, int]]:
        """Push all chunks through the DAG; returns (outputs, overflowed
        window counts per operator over this stream)."""
        before = self._overflow.totals()
        outs = [self.process_chunk(c)[0] for c in chunks]
        after = self._overflow.totals()
        return outs, {n: after[n] - before[n] for n in after}

    def overflow_totals(self) -> Dict[str, int]:
        return self._overflow.totals()


class MonolithicRuntime:
    """Single-operator execution of the *whole* query against the *full*
    KB: the paper's Table-2 baseline (no decomposition, no pruning)."""

    def __init__(self, q, kb: KnowledgeBase,
                 config: Optional[RuntimeConfig] = None):
        config = config if config is not None else RuntimeConfig()
        kb = augment_kb_with_closures(q, kb)
        plan = compile_query(
            q, kb_method=config.kb_method, scan_cap=config.scan_cap,
            bind_cap=config.bind_cap, out_cap=config.out_cap,
            kb_stats=(collect_kb_stats(kb) if config.kb_method == "auto"
                      else None),
            fuse_compaction=config.fuse_compaction,
        )
        env = prepare_env(q, kb)
        if config.kb_capacity:
            kb = pad_to(kb, config.kb_capacity)
        self.config = config
        self.operator = SCEPOperator(q.name, plan, kb, env,
                                     config.operator_config())
        self._overflow = _OverflowAccumulator([q.name], kb.device)

    def process_chunk(self, chunk: TripleBatch) -> Tuple[TripleBatch, torch.Tensor]:
        out, ovf = self.operator.process([chunk])
        self._overflow.add(self.operator.name, ovf)
        return out, ovf

    def process_stream(self, chunks: Sequence[TripleBatch]
                       ) -> Tuple[List[TripleBatch], Dict[str, int]]:
        before = self._overflow.totals()
        outs = [self.process_chunk(c)[0] for c in chunks]
        after = self._overflow.totals()
        return outs, {n: after[n] - before[n] for n in after}

    def overflow_totals(self) -> Dict[str, int]:
        return self._overflow.totals()
