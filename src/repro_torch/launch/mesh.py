"""Device meshes and operator placement.

* :class:`Mesh` — a named grid of devices, the counterpart of
  ``jax.sharding.Mesh``: the runtime shards the window batch over its
  ``data`` axis (``DSCEPRuntime(mesh=...)``) and ``core.kb_dist`` the KB's
  rows over its ``model`` axis.  One process drives every device of a mesh;
  nothing here uses ``torch.distributed``.
* :func:`make_host_mesh` / :func:`make_production_mesh` — the reference's
  mesh builders, over the visible CUDA devices.
* :func:`place_operators` — the pipelined runtime's device assignment.
* :func:`on_device` — the context a stage's launches run under.

Torch has one CPU device and no flag that splits it, so the reference's
``ensure_host_devices(n)`` (an XLA flag) has no counterpart: a
:class:`Mesh` may name one device more than once instead, as in
``Mesh(np.array([cpu] * 4).reshape(4, 1), ("data", "model"))``, and the
shards on one device run one after another.  A mesh of one card named four
times exercises the sharded paths on a single card the same way.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an object array of :class:`torch.device`, one axis per
    name in ``axis_names``; ``shape``: ``{axis name: size}``, as JAX's."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError("a %d-D device grid needs %d axis names, got %r"
                             % (grid.ndim, grid.ndim, axis_names))
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = torch.device(d)
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, grid.shape))

    def devices_along(self, axis: str) -> List[torch.device]:
        """One device for each position along ``axis``: the first device of
        that position's slice (the other axes replicate)."""
        if axis not in self.axis_names:
            raise ValueError("mesh axes are %r, not %r"
                             % (self.axis_names, axis))
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return "Mesh(%s, %r)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            sorted({str(d) for d in self.devices.flat}))


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_host_mesh(model: int = 1) -> Mesh:
    """A ``(n // model, model)`` mesh, axes ``("data", "model")``, over the
    visible CUDA devices (``model`` clipped to ``[1, n]``)."""
    devices = _cuda_devices()
    if not devices:
        raise ValueError("make_host_mesh: no CUDA device is visible")
    model = max(1, min(model, len(devices)))
    data = len(devices) // model
    return Mesh(np.array(devices[:data * model], dtype=object).reshape(
        data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    devices = _cuda_devices()
    if len(devices) < need:
        raise ValueError("make_production_mesh needs %d CUDA devices for %r "
                         "over %r; %d visible"
                         % (need, shape, axes, len(devices)))
    return Mesh(np.array(devices[:need], dtype=object).reshape(shape), axes)


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for the launches of a stage
    or a shard (a no-op for the CPU).  The kernel launchers take their
    device from the CUDA runtime, so work on a card runs with that card
    current."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
        devices = _cuda_devices()
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
