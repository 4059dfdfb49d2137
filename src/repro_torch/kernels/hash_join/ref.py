"""Plain PyTorch oracles for the window-vs-KB join (one binding table).

Same signatures and semantics as the reference's ``hash_join/ref.py``:
``cols [M, nv]`` int64 (uint32 values), ``bvalid [M]``, KB columns ``[N]``
and a static :class:`CompiledPattern`.

* :func:`match_matrix_ref` — the boolean candidate matrix ``[M, N]``.
* :func:`join_compact_ref` — materialize the candidate matrix, extend
  matching rows with the FREE variables, compact in row-major order.
* :func:`probe_compact_ref` — the unfused probe: bounded ``[M, k_max]``
  gather over a sorted composite-key view, exact re-check, compaction;
  ``overflow`` includes probe ranges wider than ``k_max``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.pattern import CompiledPattern, SlotMode, compact_rows
from ...core.rdf import composite_key


def match_matrix_ref(cols, bvalid, ks, kp, ko, kvalid, pat: CompiledPattern):
    kcols = {0: ks, 1: kp, 2: ko}
    m = bvalid[:, None] & kvalid[None, :]
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        kv = kcols[i][None, :]
        if slot.mode == SlotMode.CONST:
            m = m & (kv == int(slot.const))
        elif slot.mode == SlotMode.BOUND:
            m = m & (kv == cols[:, slot.var][:, None])
    slots = (pat.s, pat.p, pat.o)
    for i in range(3):
        for j in range(i + 1, 3):
            if (slots[i].mode != SlotMode.CONST
                    and slots[j].mode != SlotMode.CONST
                    and slots[i].var == slots[j].var):
                m = m & (kcols[i][None, :] == kcols[j][None, :])
    return m


def _compact1(rows, mask, out_cap):
    out, valid, ovf = compact_rows(rows[None], mask[None], out_cap)
    return out[0], valid[0], ovf[0]


def probe_compact_ref(
    cols, bvalid, vs, vp, vo, keys, pat: CompiledPattern, anchor_is_s: bool,
    out_cap: int, k_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m, nv = cols.shape
    anchor = pat.s if anchor_is_s else pat.o
    if anchor.mode == SlotMode.CONST:
        aval = torch.full((m,), int(anchor.const), dtype=cols.dtype,
                          device=cols.device)
    else:
        aval = cols[:, anchor.var]
    qk = composite_key(int(pat.p.const), aval)
    lo = torch.searchsorted(keys, qk, side="left")
    hi = torch.searchsorted(keys, qk, side="right")
    idx = lo[:, None] + torch.arange(k_max, device=cols.device)
    ok = idx < hi[:, None]
    idx_safe = idx.clamp(max=keys.shape[0] - 1)
    gathered = {i: c[idx_safe] for i, c in enumerate((vs, vp, vo))}
    match = ok & bvalid[:, None]
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        if slot.mode == SlotMode.CONST:
            match = match & (gathered[i] == int(slot.const))
        elif slot.mode == SlotMode.BOUND:
            match = match & (gathered[i] == cols[:, slot.var][:, None])
    ext = cols[:, None, :].expand(m, k_max, nv).clone()
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        if slot.mode == SlotMode.FREE:
            ext[..., slot.var] = gathered[i]
    rows, valid, overflow = _compact1(
        ext.reshape(m * k_max, nv), match.reshape(m * k_max), out_cap)
    fan = torch.any(((hi - lo) > k_max) & bvalid)
    return rows, valid, overflow | fan


def join_compact_ref(
    cols, bvalid, ks, kp, ko, kvalid, pat: CompiledPattern, out_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m = match_matrix_ref(cols, bvalid, ks, kp, ko, kvalid, pat)
    ca, n = m.shape
    nv = cols.shape[1]
    ext = cols[:, None, :].expand(ca, n, nv).clone()
    kcols = {0: ks, 1: kp, 2: ko}
    for i, slot in enumerate((pat.s, pat.p, pat.o)):
        if slot.mode == SlotMode.FREE:
            ext[..., slot.var] = kcols[i][None, :].expand(ca, n)
    return _compact1(ext.reshape(ca * n, nv), m.reshape(ca * n), out_cap)
