"""Span-based host tracer with device-time fencing and a first-sample split.

Latency attribution in an eager CUDA program has two traps:

1. **Asynchronous launches**: a PyTorch call on a CUDA tensor returns once
   its kernels are enqueued, so a ``perf_counter`` pair around a stage
   times the enqueue, not the work.  A span can therefore carry a
   **fence**: tensors whose devices are waited for at span exit (a
   ``torch.cuda.Event`` recorded on each device's current stream, then
   synchronized), so the recorded duration covers the device work enqueued
   in the span.  Fencing serializes stages that would otherwise overlap:
   it changes *timing*, never *results*.  CPU tensors are ready when the
   call returns and need no wait.
2. **First use**: the first pass through a stage builds the CUDA kernels
   (``nvcc``) and warms the caching allocator, often orders of magnitude
   above steady state.  The tracer keeps the **first sample of every span
   path apart** (``first_s``) and aggregates only later samples into the
   steady statistics.

Spans nest: a span opened inside another records under ``outer/inner``.

The tracer also bridges to ``torch.profiler``: ``annotations=True`` wraps
every span in ``torch.profiler.record_function(path)`` (a named range on
the profiler's timeline), and ``profiler_dir=...`` brackets the stream in
a ``torch.profiler.profile`` of the CPU and CUDA activities, started by
:meth:`Tracer.start_profiler`; :meth:`Tracer.stop_profiler` exports a
Chrome trace into that directory.  Profiler errors are raised, not
swallowed: a trace that silently lost the device would mislead.

This module imports nothing from :mod:`repro_torch.core`; with tracing off
the runtimes never call into it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Frozen observability knobs (hashable, safe inside a frozen config).

    ``spans``       — record host wall-time spans;
    ``metrics``     — collect device-side engine metrics (binding/scan
                      occupancy high-water, probe widths, retractions) in
                      per-operator accumulators on the operator's device;
    ``fence``       — wait for the fenced tensors' devices at span exit so
                      durations cover device work (serializes stages);
    ``annotations`` — wrap spans in ``torch.profiler.record_function``;
    ``profiler_dir``— directory for the ``torch.profiler`` Chrome trace
                      (enables :meth:`Tracer.start_profiler`).
    """

    spans: bool = True
    metrics: bool = True
    fence: bool = True
    annotations: bool = False
    profiler_dir: Optional[str] = None


def resolve_trace(trace: Union[None, bool, TraceConfig]) -> Optional[TraceConfig]:
    """Normalize the ``ExecutionConfig.trace`` field: None/False = off,
    True = the default :class:`TraceConfig`, a config passes through."""
    if trace is None or trace is False:
        return None
    if trace is True:
        return TraceConfig()
    if isinstance(trace, TraceConfig):
        return trace
    raise TypeError(
        "trace= takes None/False, True, or a TraceConfig, got %r"
        % type(trace).__name__)


def _tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor inside tuples, named tuples, lists and dicts; other
    leaves (ints, None) are skipped."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def cuda_devices(tree: Any) -> List[torch.device]:
    """The distinct CUDA devices holding a tensor of ``tree``."""
    devs = {t.device for t in _tensors(tree) if t.is_cuda}
    return sorted(devs, key=lambda d: d.index)


def record_events(tree: Any) -> List[torch.cuda.Event]:
    """One event recorded on the current stream of each CUDA device that
    holds a tensor of ``tree``: it completes once the work enqueued there
    so far has.  None for CPU tensors, which are ready on return."""
    events = []
    for dev in cuda_devices(tree):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


class _SpanHandle:
    """The span in flight: ``fence(value)`` marks tensors whose devices are
    waited for at exit, so the span's duration covers their device work."""

    __slots__ = ("_fence",)

    def __init__(self) -> None:
        self._fence: Any = None

    def fence(self, value: Any) -> Any:
        self._fence = value
        return value


class _NullSpan:
    """A no-op span, its own context manager: what a runtime enters when it
    runs untraced (keeps call sites branch-free and calls no function)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def fence(self, value: Any) -> Any:
        return value


NULL_SPAN = _NullSpan()


def span_or_null(tracer: Optional["Tracer"], name: str, **meta):
    """A span on ``tracer`` when there is one, else the null span."""
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, **meta)


class Tracer:
    """Records nested host spans with the first sample of each path kept
    apart.  Samples are raw duration lists per span path (sample 0 is the
    first call); :meth:`stats` folds them into JSON-ready aggregates."""

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config if config is not None else TraceConfig()
        self._samples: Dict[str, List[float]] = {}
        self._meta: Dict[str, Dict[str, Any]] = {}
        self._stack: List[str] = []
        self._profiler: Optional[torch.profiler.profile] = None

    @property
    def enabled(self) -> bool:
        return self.config.spans

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **meta):
        """Context manager for one timed span; nests under the active span.

        Usage::

            with tracer.span("sink") as sp:
                out = sink_step(...)
                sp.fence(out)        # wait for out's devices at exit
        """
        if not self.config.spans:
            return NULL_SPAN
        return self._span_cm(name, meta)

    @contextlib.contextmanager
    def _span_cm(self, name: str, meta: Dict[str, Any]):
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        handle = _SpanHandle()
        ann = (torch.profiler.record_function(path)
               if self.config.annotations else contextlib.nullcontext())
        with ann:
            t0 = time.perf_counter()
            try:
                yield handle
            finally:
                if handle._fence is not None and self.config.fence:
                    for ev in record_events(handle._fence):
                        ev.synchronize()
                dur = time.perf_counter() - t0
                self._stack.pop()
                self._samples.setdefault(path, []).append(dur)
                if meta:
                    self._meta.setdefault(path, {}).update(meta)

    # -- torch.profiler bridge ----------------------------------------------
    def start_profiler(self) -> bool:
        """Start a ``torch.profiler`` session of the CPU and (where this
        build has it) CUDA activities; returns whether one started
        (``profiler_dir`` unset, or one already running: False)."""
        if not self.config.profiler_dir or self._profiler is not None:
            return False
        acts = [a for a in (torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA)
                if a in torch.profiler.supported_activities()]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._profiler = prof
        return True

    def stop_profiler(self) -> Optional[str]:
        """Stop the session and export its Chrome trace into
        ``profiler_dir``; returns the file written (None if none ran)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        prof.stop()
        os.makedirs(self.config.profiler_dir, exist_ok=True)
        path = os.path.join(self.config.profiler_dir,
                            "trace_%d.json" % time.time_ns())
        prof.export_chrome_trace(path)
        return path

    # -- aggregation ---------------------------------------------------------
    def reset(self) -> None:
        self._samples.clear()
        self._meta.clear()

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-path aggregates with the first/steady split.

        ``first_s`` is the path's first sample (kernel builds and allocator
        warm-up included when the span wraps a stage's first run);
        ``steady`` aggregates every later sample.  Plain floats and ints.
        """
        out: Dict[str, Dict[str, Any]] = {}
        for path, samples in self._samples.items():
            steady = samples[1:]
            entry: Dict[str, Any] = {
                "count": len(samples),
                "first_s": samples[0],
                "steady": {
                    "count": len(steady),
                    "total_s": sum(steady),
                    "mean_s": (sum(steady) / len(steady)) if steady else 0.0,
                    "min_s": min(steady) if steady else 0.0,
                    "max_s": max(steady) if steady else 0.0,
                },
            }
            if path in self._meta:
                entry["meta"] = dict(self._meta[path])
            out[path] = entry
        return out
