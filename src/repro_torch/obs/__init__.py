"""Observability: span tracing, engine metrics and plan EXPLAIN reporting.

Wire-in point: ``ExecutionConfig(trace=True)`` (or a custom
:class:`~repro_torch.obs.trace.TraceConfig`): every runtime then records
per-stage spans and device-side engine metrics, surfaced uniformly through
``RegisteredQuery.last_stats`` and ``RegisteredQuery.explain()``.  With
tracing off (the default) the runtimes run the same torch ops and kernel
launches as without this package, and call nothing in it
(``tests/test_torch_obs.py``).
"""
from .trace import NULL_SPAN, TraceConfig, Tracer, resolve_trace, span_or_null
from .metrics import (
    CATALOG, RECOVERY_CATALOG, finalize_stats, merge_stats, reduce_stats,
    saturation, stat_add, stat_max,
)
from .report import (
    attach_saturation, bottleneck_stage, format_explain,
    format_metrics_table, format_recovery_table, format_stage_table, to_json,
)

__all__ = [
    "NULL_SPAN", "TraceConfig", "Tracer", "resolve_trace", "span_or_null",
    "CATALOG", "RECOVERY_CATALOG", "finalize_stats", "merge_stats",
    "reduce_stats", "saturation", "stat_add", "stat_max",
    "attach_saturation", "bottleneck_stage", "format_explain",
    "format_metrics_table", "format_recovery_table", "format_stage_table",
    "to_json",
]
