"""Public join wrappers: the CUDA kernel for CUDA tensors, the plain
PyTorch twin for CPU tensors.

* :func:`join_compact` / :func:`join_compact_torch` — the fused scan join:
  compacted, variable-extended :class:`Bindings` straight from the KB.
* :func:`probe_compact` / :func:`probe_compact_torch` — the fused probe
  join: composite-key binary search, bounded ``k_max`` gather, exact
  re-check and compaction.  On the card it is one kernel launch that
  writes the :class:`Bindings` whole (rows, valid, overflow), with no
  other device op in the call.
* :func:`match_matrix` / :func:`match_matrix_torch` — the unfused scan
  join's bool ``[W, M, N]`` candidate matrix, which the caller compacts.

Binding tables carry the window dimension ``[W, M, nv]``; the kernels put
``W`` on their grid.  Every path is bit-identical to compacting the
materialized candidate matrix (``ref.py``), including row order, zeroed
rows past the count and both overflow sources of the probe.  The device of
the bindings decides: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain twin.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from ...core.kb import KnowledgeBase, gather_matches, probe_range, probe_view
from ...core.pattern import (
    Bindings, CompiledPattern, SlotMode, compact_index, gather_rows,
)
from ...core.rdf import composite_key
from . import kernel

# candidate-matrix entries the plain scan twin materializes at once
PLAIN_BLOCK = 1 << 27


def _finish(rows, counts, out_cap, overflow):
    """Bindings from compacted ``rows`` and per-row match ``counts [W, M]``:
    valid up to the window's total, overflow past ``out_cap``."""
    total = counts.sum(dim=1)
    k = torch.arange(out_cap, device=rows.device)
    valid = k[None, :] < total.clamp(max=out_cap)[:, None]
    return Bindings(rows, valid, (total > out_cap) | overflow)


def join_compact(bind: Bindings, kb: KnowledgeBase, pat: CompiledPattern,
                 out_cap: int) -> Bindings:
    """Fused scan join of every window's bindings against the KB."""
    if not bind.cols.is_cuda:
        return join_compact_torch(bind, kb, pat, out_cap)
    w = kb.words
    rows, counts = kernel.join_compact_cuda(
        bind.cols, bind.valid, w.s_ps, w.p_ps, w.o_ps, w.valid, pat, out_cap)
    return _finish(rows, counts, out_cap, bind.overflow)


def probe_compact(bind: Bindings, kb: KnowledgeBase, pat: CompiledPattern,
                  out_cap: int, k_max: int = 8) -> Bindings:
    """Fused probe join of every window's bindings against the KB."""
    if not bind.cols.is_cuda:
        return probe_compact_torch(bind, kb, pat, out_cap, k_max)
    keys, (vs, vp, vo), _, anchor_is_s = probe_view(kb.words, pat)
    f = kb.fences
    return Bindings(*kernel.probe_compact_cuda(
        bind.cols, bind.valid, bind.overflow, vs, vp, vo, keys,
        f.ps if anchor_is_s else f.po, f.shift, pat, anchor_is_s,
        out_cap, k_max))


def match_matrix(bind: Bindings, kb: KnowledgeBase,
                 pat: CompiledPattern) -> torch.Tensor:
    """Candidate matrix of every window's bindings against the KB: bool
    ``[W, M, N]``.  The kernel writes 0/1 bytes, viewed as bool in place."""
    if not bind.cols.is_cuda:
        return match_matrix_torch(bind, kb, pat)
    w = kb.words
    return kernel.match_matrix_cuda(
        bind.cols, bind.valid, w.s_ps, w.p_ps, w.o_ps, w.valid,
        pat).view(torch.bool)


def match_matrix_torch(bind: Bindings, kb: KnowledgeBase,
                       pat: CompiledPattern) -> torch.Tensor:
    """Plain candidate matrix, built in row blocks of ``PLAIN_BLOCK``
    entries into one bool ``[W, M, N]`` output."""
    w, m, _ = bind.cols.shape
    n = kb.capacity
    kcols = (kb.s_ps, kb.p_ps, kb.o_ps)
    out = torch.empty((w, m, n), dtype=torch.bool, device=bind.cols.device)
    step = max(1, PLAIN_BLOCK // max(1, w * n))
    for r0 in range(0, m, step):
        out[:, r0:r0 + step] = _match(bind.cols[:, r0:r0 + step],
                                      bind.valid[:, r0:r0 + step], kcols,
                                      kb.valid, pat)
    return out


def _match(cols, bvalid, kcols, kvalid, pat: CompiledPattern):
    """Candidate matrix ``[W, b, N]`` of a block of binding rows."""
    kmask = kvalid
    slots = (pat.s, pat.p, pat.o)
    for i, slot in enumerate(slots):
        if slot.mode == SlotMode.CONST:
            kmask = kmask & (kcols[i] == int(slot.const))
    for i in range(3):
        for j in range(i + 1, 3):
            if (slots[i].mode != SlotMode.CONST
                    and slots[j].mode != SlotMode.CONST
                    and slots[i].var == slots[j].var):
                kmask = kmask & (kcols[i] == kcols[j])
    m = bvalid[..., None] & kmask
    for i, slot in enumerate(slots):
        if slot.mode == SlotMode.BOUND:
            m = m & (kcols[i] == cols[..., slot.var, None])
    return m


def join_compact_torch(bind: Bindings, kb: KnowledgeBase,
                       pat: CompiledPattern, out_cap: int) -> Bindings:
    """Plain scan twin: candidate matrix in row blocks, ``nonzero`` for the
    row-major matches, the first ``out_cap`` of each window gathered."""
    w, m, nv = bind.cols.shape
    kcols = (kb.s_ps, kb.p_ps, kb.o_ps)
    n = kb.capacity
    dev = bind.cols.device
    step = max(1, PLAIN_BLOCK // max(1, w * n))
    # rows past the last valid one of every window match nothing
    live = bind.valid.any(dim=0).nonzero()
    m_used = int(live[-1]) + 1 if live.numel() else 0
    hits = []
    for r0 in range(0, m_used, step):
        mm = _match(bind.cols[:, r0:r0 + step], bind.valid[:, r0:r0 + step],
                    kcols, kb.valid, pat)
        nz = mm.nonzero()
        nz[:, 1] += r0
        hits.append(nz)
    nz = torch.cat(hits) if hits else torch.zeros((0, 3), dtype=torch.int64,
                                                  device=dev)
    # blocks are in row order, each window-major: a stable sort by window
    # gives every window its row-major match order
    nz = nz[torch.sort(nz[:, 0], stable=True).indices]
    counts = torch.bincount(nz[:, 0], minlength=w)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(nz.shape[0], device=dev) - start[nz[:, 0]]
    keep = nz[rank < out_cap]
    rank = rank[rank < out_cap]
    rows = torch.zeros((w, out_cap, nv), dtype=bind.cols.dtype, device=dev)
    ext = bind.cols[keep[:, 0], keep[:, 1]].clone()
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        if slot.mode == SlotMode.FREE:
            ext[:, slot.var] = kcols[i][keep[:, 2]]
    rows[keep[:, 0], rank] = ext
    return _finish(rows, counts[:, None], out_cap, bind.overflow)


def probe_compact_torch(bind: Bindings, kb: KnowledgeBase,
                        pat: CompiledPattern, out_cap: int,
                        k_max: int = 8) -> Bindings:
    """Plain probe twin: gather the ``out_cap`` winners of the virtual
    row-major ``[M, k_max]`` candidate block of every window."""
    keys, kcols_v, anchor, _ = probe_view(kb, pat)
    w, m, nv = bind.cols.shape
    if anchor.mode == SlotMode.CONST:
        aval = torch.full((w, m), int(anchor.const), dtype=bind.cols.dtype,
                          device=bind.cols.device)
    else:
        aval = bind.cols[..., anchor.var]
    qk = composite_key(int(pat.p.const), aval)
    lo, hi = probe_range(keys, qk)
    gathered, ok, fan = gather_matches(kcols_v, lo, hi, k_max)
    match = ok & bind.valid[..., None]
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        if slot.mode == SlotMode.CONST:
            match = match & (gathered[i] == int(slot.const))
        elif slot.mode == SlotMode.BOUND:
            match = match & (gathered[i] == bind.cols[..., slot.var, None])
    src, valid, ovf = compact_index(match.reshape(w, m * k_max), out_cap)
    rows = gather_rows(bind.cols, src // k_max)
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        if slot.mode == SlotMode.FREE:
            rows[..., slot.var] = torch.gather(
                gathered[i].reshape(w, m * k_max), 1, src)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    fan_ovf = torch.any(fan & bind.valid, dim=1)
    return Bindings(rows, valid, ovf | fan_ovf | bind.overflow)
