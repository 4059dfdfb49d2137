"""Structured and human-readable reporting over tracer spans and metrics.

Pure host code.  Consumes the plain-dict surfaces the rest of the
subsystem produces — ``Tracer.stats()`` span aggregates, finalized
per-operator metric counters
(:func:`repro_torch.obs.metrics.finalize_stats` /
:func:`~repro_torch.obs.metrics.saturation`)
and the planner's ``explain`` artifact — and renders them as one JSON
payload (:func:`to_json`) or terminal tables (:func:`format_stage_table`,
:func:`format_metrics_table`, :func:`format_explain`).

:func:`bottleneck_stage` is the headline consumer: given span stats it
names the stage with the largest steady-state total — the measured answer
to "where does the pipelined runtime actually spend its time".
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Sequence

from .metrics import CATALOG, RECOVERY_CATALOG, saturation


def _table(title: str, headers: Sequence[str], rows: List[List[Any]]) -> str:
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
        for i, h in enumerate(headers)
    ]

    def fmt(vals):
        return " | ".join(str(v).ljust(w) for v, w in zip(vals, widths))

    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([f"== {title} ==", fmt(headers), sep]
                     + [fmt(r) for r in rows])


def _ms(x: float) -> str:
    return f"{x * 1e3:.1f}"


def bottleneck_stage(span_stats: Mapping[str, Dict[str, Any]],
                     prefix: Optional[str] = None) -> Optional[str]:
    """The span path with the largest steady-state total time.

    ``prefix`` restricts candidates (e.g. ``"stage"`` for the pipelined
    runtime's per-stage spans, skipping the enclosing chunk span).  Paths
    without steady samples (only a compile-inclusive first call) compete on
    that first sample so a single-pass trace still answers.
    """
    best, best_t = None, -1.0
    for path, s in span_stats.items():
        if prefix is not None and not path.split("/")[-1].startswith(prefix):
            continue
        t = s["steady"]["total_s"] if s["steady"]["count"] else s["first_s"]
        if t > best_t:
            best, best_t = path, t
    return best


def format_stage_table(span_stats: Mapping[str, Dict[str, Any]],
                       title: str = "stage latency") -> str:
    """Per-stage latency table with compile time in its own column."""
    rows = []
    for path in sorted(span_stats):
        s = span_stats[path]
        st = s["steady"]
        rows.append([
            path, s["count"], _ms(s["first_s"]),
            _ms(st["mean_s"]), _ms(st["min_s"]), _ms(st["max_s"]),
            _ms(st["total_s"]),
        ])
    return _table(title, ["stage", "samples", "first (compile) ms",
                          "steady mean ms", "min ms", "max ms", "total ms"],
                  rows)


def format_metrics_table(op_metrics: Mapping[str, Dict[str, Any]],
                         title: str = "engine metrics") -> str:
    """Per-operator counter/gauge table with saturation percentages."""
    rows = []
    for op in sorted(op_metrics):
        entry = op_metrics[op]
        counters = entry.get("counters", {})
        sat = entry.get("saturation", {})
        for key in sorted(counters):
            pct = ("%.0f%%" % (sat[key] * 100)) if key in sat else "--"
            rows.append([op, key, counters[key], pct,
                         CATALOG.get(key, "")])
    return _table(title, ["operator", "metric", "value", "saturation",
                          "meaning"], rows)


def format_explain(artifact: Mapping[str, Any]) -> str:
    """Render a planner ``explain`` artifact as per-operator step tables."""
    lines = [
        "EXPLAIN %s (mode=%s, kb_method=%s)"
        % (artifact.get("query"), artifact.get("mode"),
           artifact.get("kb_method")),
    ]
    for op_name, op in artifact.get("operators", {}).items():
        caps = op.get("caps", {})
        lines.append("")
        lines.append(
            "operator %s  (kb_rows=%s, scan_cap=%s, bind_cap=%s, out_cap=%s)"
            % (op_name, op.get("kb_rows", "--"), caps.get("scan_cap"),
               caps.get("bind_cap"), caps.get("out_cap")))
        rows = []
        for i, step in enumerate(op.get("steps", [])):
            est = step.get("est_fanout")
            rows.append([
                i, step["step"], step.get("pattern", ""),
                step.get("method", "--"),
                step.get("k_max", "--"),
                ("%.1f" % est) if est is not None else "--",
            ])
        lines.append(_table("join order", ["#", "step", "pattern", "method",
                                           "k_max", "est fan-out"], rows))
    return "\n".join(lines)


def format_recovery_table(recovery: Mapping[str, Any],
                          title: str = "recovery") -> str:
    """Render ``last_stats["recovery"]`` as a counter table.

    Injected-fault counts appear as ``injected:<kind>`` rows (with the
    scheduled count alongside, so a divergence — an event that never found
    its stage/chunk — is visible); the ladder counters carry their
    :data:`~repro_torch.obs.metrics.RECOVERY_CATALOG` legends."""
    rows: List[List[Any]] = []
    scheduled = recovery.get("scheduled", {})
    for kind in sorted(recovery.get("injected", {})):
        fired = recovery["injected"][kind]
        want = scheduled.get(kind, 0)
        if fired or want:
            rows.append(["injected:%s" % kind, fired,
                         "scheduled %d" % want])
    for key in sorted(RECOVERY_CATALOG):
        if key in recovery:
            rows.append([key, recovery[key], RECOVERY_CATALOG[key]])
    degraded = recovery.get("degraded_chunks", [])
    rows.append(["degraded_chunks", len(degraded),
                 ("seqs %s (lossless channel-free fallback)" % degraded)
                 if degraded else "none"])
    return _table(title, ["event", "count", "meaning"], rows)


def to_json(last_stats: Mapping[str, Any],
            explain: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """One JSON-ready observability payload: the uniform ``last_stats``
    surface (spans, per-operator metrics, channels, overflow) plus an
    optional planner explain artifact."""
    payload = dict(last_stats)
    if explain is not None:
        payload["explain"] = dict(explain)
    # round-trip through json to guarantee the payload is serializable
    return json.loads(json.dumps(payload, default=float))


def attach_saturation(counters: Dict[str, int],
                      caps: Mapping[str, int]) -> Dict[str, Any]:
    """Bundle finalized counters with their capacities and saturation —
    the per-operator entry shape ``format_metrics_table`` consumes."""
    return {
        "counters": counters,
        "caps": dict(caps),
        "saturation": saturation(counters, caps),
    }
