"""Operator placement: the pipelined runtime's device assignment policy.

Only :func:`place_operators` is here; the mesh builders of the reference
come with the sharded paths (``ROADMAP.md`` queue 1: Sharded paths).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def place_operators(names: Sequence[str], final: str,
                    devices: Optional[Sequence[torch.device]] = None,
                    strategy: str = "round_robin") -> Dict[str, torch.device]:
    """Assign each SCEP operator of a decomposed DAG to a device.

    :class:`~repro_torch.core.pipeline.PipelinedRuntime` places each
    operator's step (KB slice, env, inbound channels) on its device;
    channel pushes across an edge become device-to-device copies, the
    analogue of the paper's one-container-per-operator deployment.

    Strategies:

    * ``"single"``      — everything on ``devices[0]`` (transport is a
      no-op).
    * ``"round_robin"`` — the aggregation operator (``final``) is pinned to
      ``devices[0]`` (it owns the sink the host waits on); the upstream
      enrichment operators cycle over the *remaining* devices, or over
      ``devices[0]`` when there is only one.

    ``devices`` defaults to every visible CUDA device; callers may pass CPU
    devices.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to place operators on")
    names = list(names)
    if final not in names:
        raise ValueError("final operator %r not in %r" % (final, names))
    if strategy == "single":
        return {n: devices[0] for n in names}
    if strategy != "round_robin":
        raise ValueError("unknown placement strategy %r" % strategy)
    placement = {final: devices[0]}
    workers = devices[1:] or devices
    for i, name in enumerate(n for n in names if n != final):
        placement[name] = workers[i % len(workers)]
    return placement
