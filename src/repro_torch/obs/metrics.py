"""Counters and gauges for quantities the engine computes and discards.

The engine's fixed-capacity design means every step already knows the
numbers an operator wants on a dashboard: how full the binding table got
against ``bind_cap``, how wide the widest probe range was against the
derived ``k_max``, how many rows a retraction killed.  With
``TraceConfig.metrics`` on, the engine's ``with_stats`` paths
(:mod:`repro_torch.core.engine`) return them as a flat ``{key: int32
tensor}`` dict per step, and the runtimes fold those dicts into
**accumulators on the operator's device**, like the overflow counters:
merging a chunk is a few scalar ops enqueued on the device, and the host
reads once, when a report is built (:func:`finalize_stats`).  Nothing on
the per-chunk path reads a value back.

Key convention (the merge rule is in the name, so accumulators need no
schema):

* ``hw_*`` — high-water gauges, merged with ``max`` (``hw_bind``,
  ``hw_scan``, ``hw_out``, ``hw_probe_k``);
* ``n_*``  — monotone counters, merged with ``+`` (``n_windows``,
  ``n_retract``).

The same convention reduces per-window gauges ``[W]`` to chunk scalars
(:func:`reduce_stats`) and merges chunk scalars into lifetime accumulators
(:func:`merge_stats`).  :func:`saturation` relates the high-water marks to
their capacities: the number that says "this stage is about to clip"
before overflow fires.

Like :mod:`repro_torch.obs.trace`, this module imports nothing from
:mod:`repro_torch.core`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

# metric catalog: key -> what the value measures (report.py's legends)
CATALOG: Dict[str, str] = {
    "hw_bind": "binding-table occupancy high-water (rows, vs bind_cap)",
    "hw_scan": "pattern-scan result high-water (rows, vs scan_cap)",
    "hw_out": "pre-publish constructed-output high-water (rows, vs out_cap)",
    "hw_probe_k": "widest KB probe range encountered (rows, vs k_max)",
    "n_windows": "windows finalized (valid windows published)",
    "n_retract": "bindings eagerly retracted by the delta evaluator",
}

# recovery-counter legend (repro_torch.core.recovery): host-side facts in
# last_stats["recovery"], not device accumulators; listed here so
# report.py renders them with the same one-line meanings
RECOVERY_CATALOG: Dict[str, str] = {
    "retries": "stage dispatches retried after a timeout (with backoff)",
    "restarts": "checkpoint restores (crash / exhausted retries / desync)",
    "replayed": "chunks re-fed from the replay buffer during restores",
    "deduped": "replayed outputs discarded by sequence-number dedup",
    "checkpoints": "checkpoints taken (cadence: checkpoint_every emissions)",
    "checkpoint_bytes": "bytes in the latest checkpoint's device snapshots",
    "rejected": "chunks refused by the ingest validation gate",
    "corrupt_recovered": "in-transit corruptions healed from the replay buffer",
}

# the capacity each high-water gauge saturates against
_SATURATES_AGAINST = {
    "hw_bind": "bind_cap",
    "hw_scan": "scan_cap",
    "hw_out": "out_cap",
    "hw_probe_k": "k_max",
}


def _is_high_water(key: str) -> bool:
    return key.startswith("hw_")


def stat_max(stats: Optional[Dict[str, Any]], key: str, value) -> None:
    """Raise the high-water gauge ``key`` to at least ``value`` (a no-op
    when ``stats`` is None: the engine's stats-off path)."""
    if stats is None:
        return
    stats[key] = torch.maximum(stats[key], value) if key in stats else value


def stat_add(stats: Optional[Dict[str, Any]], key: str, value) -> None:
    """Add ``value`` to the counter ``key``."""
    if stats is None:
        return
    stats[key] = stats[key] + value if key in stats else value


def reduce_stats(stats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Collapse per-window stats ``[W]`` to chunk scalars (max for
    ``hw_*``, sum for ``n_*``), still on the device."""
    return {k: (v.amax() if _is_high_water(k) else v.sum()).to(torch.int32)
            for k, v in stats.items()}


def split_stats(stats: Mapping[str, torch.Tensor],
                index: int) -> Dict[str, torch.Tensor]:
    """One lane of a stats dict with a leading per-query axis ``[Q]``
    (per-query attribution of a batched step), still on the device."""
    return {k: v[index] for k, v in stats.items()}


def merge_stats(acc: Dict[str, torch.Tensor],
                stats: Mapping[str, Any]) -> None:
    """Fold one chunk's stat scalars into a lifetime accumulator dict, in
    place (device ops when the values are device tensors)."""
    for k, v in stats.items():
        if k not in acc:
            acc[k] = v
        elif _is_high_water(k):
            acc[k] = torch.maximum(acc[k], v)
        else:
            acc[k] = acc[k] + v


def finalize_stats(acc: Mapping[str, Any]) -> Dict[str, int]:
    """Read an accumulator dict as plain ints (the one host read)."""
    return {k: int(v) for k, v in acc.items()}


def saturation(counters: Mapping[str, int],
               caps: Mapping[str, int]) -> Dict[str, float]:
    """High-water marks as a fraction of their configured capacity.

    ``caps`` maps capacity names (``bind_cap``, ``scan_cap``, ``out_cap``,
    ``k_max``) to values; gauges whose capacity is absent or zero are
    skipped.  1.0 means the stage ran exactly full: the next row would
    have tripped overflow.
    """
    out: Dict[str, float] = {}
    for key, value in counters.items():
        cap_name = _SATURATES_AGAINST.get(key)
        if cap_name and caps.get(cap_name):
            out[key] = float(value) / float(caps[cap_name])
    return out
