"""Distributed KB join: the KB partition itself divided across devices.

The paper's central deployment move is "divide the KB through different
machines".  Within one SCEP operator this becomes: row-shard the sorted
triple store over the ``model`` axis of a
:class:`~repro_torch.launch.mesh.Mesh` (``kb.shard_rows``), join the
window's bindings against each block **locally, on the block's device**,
and union the per-shard binding rows.  The union is a concatenation along
the row axis, so the join needs no collective: only the overflow flag is
reduced (an OR).  Both KB views are key-sorted, so each block is a
contiguous key range and a probe's search stays correct per block.

One process drives every device: each shard's join runs under
:func:`~repro_torch.launch.mesh.on_device` of its card (the kernel
launchers take their device from the CUDA runtime), the bindings are
copied to it, and the shards' rows come back to the bindings' device.
Nothing here uses ``torch.distributed``.

Capacity: each shard compacts its matches into ``out_cap // n`` rows, so a
shard-local overflow is reported even where one join over the whole KB
would have fit (the price of the static layout).

The arguments follow :func:`repro_torch.core.algebra.kb_join` (``method``,
``k_max``, ``fuse_compaction``).  The reference's ``use_pallas``,
``interpret``, ``bm`` and ``bn`` have no counterpart: the port's joins
always run its hand kernels on a card and their plain versions on the CPU.

Like the reference, this is a building block: ``Session`` and the
operators do not shard the KB.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..launch.mesh import Mesh, on_device
from . import algebra
from .kb import KnowledgeBase, row_block
from .pattern import Bindings, CompiledPattern


def placed_blocks(kb_blocks: KnowledgeBase,
                  devices: Sequence[torch.device]) -> Tuple[KnowledgeBase, ...]:
    """Block ``i`` of a ``shard_rows`` layout as a 1-D KB on
    ``devices[i]``.  Placed once per device list and kept with the layout
    (as ``KnowledgeBase.words`` is kept with a KB), so a join does not copy
    the blocks again."""
    devices = tuple(torch.device(d) for d in devices)
    if int(kb_blocks.valid.shape[0]) != len(devices):
        raise ValueError("%d KB blocks for %d devices"
                         % (int(kb_blocks.valid.shape[0]), len(devices)))
    cache = kb_blocks.__dict__.setdefault("_placed", {})
    if devices not in cache:
        cache[devices] = tuple(row_block(kb_blocks, i).to(d)
                               for i, d in enumerate(devices))
    return cache[devices]


def _union(parts: Sequence[Bindings], bind: Bindings) -> Bindings:
    """Shard-major union on ``bind``'s device: rows concatenated in shard
    order, overflow the OR of every shard's flag (each already holds the
    input's)."""
    home = bind.cols.device
    parts = [Bindings(*(t.to(home) for t in p)) for p in parts]
    return Bindings(
        torch.cat([p.cols for p in parts], dim=-2),
        torch.cat([p.valid for p in parts], dim=-1),
        functools.reduce(torch.logical_or, [p.overflow for p in parts],
                         bind.overflow))


def kb_join_sharded(bind: Bindings, kb_blocks: KnowledgeBase,
                    pat: CompiledPattern, out_cap: int, mesh: Mesh,
                    axis: str = "model", method: str = "scan",
                    k_max: int = 8,
                    fuse_compaction: bool = True) -> Bindings:
    """Join bindings against a row-sharded KB (``kb.shard_rows(kb, n)``,
    ``n`` the size of ``axis``): block ``i`` joins on the first device of
    position ``i`` along ``axis`` into ``out_cap // n`` rows, and the union
    lands on the bindings' device."""
    n = mesh.shape[axis]
    assert out_cap % n == 0, (out_cap, n)
    per_cap = out_cap // n
    parts = []
    for kb_local in placed_blocks(kb_blocks, mesh.devices_along(axis)):
        dev = kb_local.device
        with on_device(dev):
            local = Bindings(*(t.to(dev) for t in bind))
            parts.append(algebra.kb_join(local, kb_local, pat, per_cap,
                                         method=method, k_max=k_max,
                                         fuse_compaction=fuse_compaction))
    return _union(parts, bind)


def kb_join_blocks_reference(bind: Bindings, kb_blocks: KnowledgeBase,
                             pat: CompiledPattern, out_cap: int, n: int,
                             method: str = "scan", k_max: int = 8,
                             fuse_compaction: bool = True) -> Bindings:
    """Oracle: the same per-block joins and union, one block after another
    on the bindings' device."""
    per_cap = out_cap // n
    home = bind.cols.device
    with on_device(home):
        parts = [algebra.kb_join(bind, row_block(kb_blocks, i).to(home), pat,
                                 per_cap, method=method, k_max=k_max,
                                 fuse_compaction=fuse_compaction)
                 for i in range(n)]
    return _union(parts, bind)
