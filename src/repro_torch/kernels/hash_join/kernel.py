"""CUDA wrappers for the fused scan join, the fused probe join and the
unfused scan join's match matrix.

The kernels live in ``kernels/csrc/hash_join.cu`` (see its header for the
TPU kernels they replace and what bounds them on the H100).  Each wrapper
checks its arguments, converts the int64-held uint32 binding ids to 32-bit
words (the KB columns arrive as words already: ``KnowledgeBase.words``),
launches its kernels on PyTorch's current stream (for the joins: count ->
``torch.cumsum`` -> scatter), and counts one launch.  Nothing is built or
loaded at import time.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _cuda
from .._cuda import I, P, U
from ...core.pattern import CompiledPattern, SlotMode
from ...core.rdf import from_u32_bits, to_u32_bits

_SIG_PATTERN = [I, U, I, I, U, I, I, U, I]
_READY = set()
_SCAN_ROWS = {}     # the scan join's KB rows a tile, binding rows a group


def _lib():
    lib = _cuda.library("hash_join")
    if "sig" not in _READY:
        lib.scan_join_launch.argtypes = (
            [I, P, P, I, I, I, P, P, P, P, I] + _SIG_PATTERN
            + [I, I, I, P, P, P, P, I, P])
        lib.scan_join_launch.restype = I
        _SCAN_ROWS["tile"] = lib.scan_join_tile_rows()
        _SCAN_ROWS["group"] = lib.scan_join_group_rows()
        lib.probe_join_launch.argtypes = (
            [I, P, P, I, I, I, P, P, P, P, I] + _SIG_PATTERN
            + [I, I, P, P, P, P, P, I, P])
        lib.probe_join_launch.restype = I
        lib.match_matrix_launch.argtypes = (
            [P, P, I, I, I, P, P, P, P, I] + _SIG_PATTERN + [I, I, I, P, P])
        lib.match_matrix_launch.restype = I
        _READY.add("sig")
    return lib


def pattern_args(pat: CompiledPattern):
    """The static pattern as the kernels' small int arguments: per slot
    (mode, const, var), then the repeated-variable agreement flags."""
    slots = (pat.s, pat.p, pat.o)
    args = []
    for sl in slots:
        args += [int(sl.mode), int(sl.const) & 0xFFFFFFFF, int(sl.var)]
    eq = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        eq.append(int(slots[i].mode != SlotMode.CONST
                      and slots[j].mode != SlotMode.CONST
                      and slots[i].var == slots[j].var))
    return args, eq


def _bind_words(cols: torch.Tensor, bvalid: torch.Tensor):
    if cols.dim() != 3 or bvalid.shape != cols.shape[:2]:
        raise ValueError("binding cols [W, M, nv] / valid [W, M] expected, "
                         "got %s / %s" % (tuple(cols.shape), tuple(bvalid.shape)))
    c32 = to_u32_bits(cols).contiguous()
    bv = bvalid.contiguous()
    _cuda.require(c32, torch.int32, 3, "binding cols")
    _cuda.require(bv, torch.bool, 2, "binding valid")
    return c32, bv


def _require_kb(*cols: torch.Tensor) -> None:
    for c in cols:
        _cuda.require(c, torch.int32, 1, "KB column (KnowledgeBase.words)")
        if c.shape != cols[0].shape or c.device != cols[0].device:
            raise ValueError("KB columns must share shape and device")


def join_compact_cuda(
    cols: torch.Tensor, bvalid: torch.Tensor,
    ks: torch.Tensor, kp: torch.Tensor, ko: torch.Tensor, kvalid: torch.Tensor,
    pat: CompiledPattern, out_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan join over int32 KB words.  Returns ``(rows [W, out_cap,
    nv] int64, counts [W, M] int64)``; ``rows[w, k]`` is the k-th match of
    window w's virtual row-major ``[M, N]`` candidate matrix, extended with
    the pattern's FREE variables, zero past ``min(sum(counts[w]),
    out_cap)``.  The grid is sized from the shapes (no host sync): KB tiles
    by groups of binding rows, ``W * M`` at most 65535 groups."""
    c32, bv = _bind_words(cols, bvalid)
    _require_kb(ks, kp, ko)
    _cuda.require(kvalid, torch.bool, 1, "KB valid")
    if c32.device != ks.device:
        raise ValueError("bindings and KB are on different devices")
    w, m, nv = c32.shape
    n = ks.shape[0]
    pargs, eq = pattern_args(pat)
    lib = _lib()
    tile, group = _SCAN_ROWS["tile"], _SCAN_ROWS["group"]
    if w * m > 65535 * group:
        raise ValueError("scan join takes W * M <= %d binding rows, got %d"
                         % (65535 * group, w * m))
    stream = _cuda.stream_of(c32)
    dev = c32.device
    counts = torch.zeros((w, m), dtype=torch.int32, device=dev)
    out = torch.zeros((w, out_cap, nv), dtype=torch.int32, device=dev)
    # per (KB tile, binding row) match counts; the count pass writes every
    # entry the scatter pass reads, so no fill
    part = torch.empty((-(-n // tile), w * m), dtype=torch.int32, device=dev)
    _cuda.check(lib.scan_join_launch(
        0, c32.data_ptr(), bv.data_ptr(), w, m, nv, ks.data_ptr(),
        kp.data_ptr(), ko.data_ptr(), kvalid.data_ptr(), n, *pargs, *eq,
        part.data_ptr(), counts.data_ptr(), None, None, out_cap, stream),
        "scan_join count")
    counts64 = counts.to(torch.int64)
    offsets = (torch.cumsum(counts64, dim=1) - counts64).contiguous()
    _cuda.check(lib.scan_join_launch(
        1, c32.data_ptr(), bv.data_ptr(), w, m, nv, ks.data_ptr(),
        kp.data_ptr(), ko.data_ptr(), kvalid.data_ptr(), n, *pargs, *eq,
        part.data_ptr(), None, offsets.data_ptr(), out.data_ptr(), out_cap,
        stream), "scan_join scatter")
    _cuda.count_launch("join_compact")
    return from_u32_bits(out), counts64


def probe_compact_cuda(
    cols: torch.Tensor, bvalid: torch.Tensor,
    vs: torch.Tensor, vp: torch.Tensor, vo: torch.Tensor, keys: torch.Tensor,
    pat: CompiledPattern, anchor_is_s: bool, out_cap: int, k_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused probe join over one sorted view of int32 KB words.  Returns ``(rows [W, out_cap,
    nv] int64, counts [W, M] int64, fan [W, M] int32)``; ``fan`` flags
    probe ranges wider than ``k_max`` (for every row, valid or not)."""
    if not 1 <= k_max <= 64:
        raise ValueError("k_max must be in [1, 64], got %d" % k_max)
    c32, bv = _bind_words(cols, bvalid)
    _require_kb(vs, vp, vo, keys)
    if c32.device != keys.device:
        raise ValueError("bindings and KB are on different devices")
    w, m, nv = c32.shape
    n = keys.shape[0]
    pargs, _ = pattern_args(pat)
    lib = _lib()
    stream = _cuda.stream_of(c32)
    dev = c32.device
    counts = torch.zeros((w, m), dtype=torch.int32, device=dev)
    fan = torch.zeros((w, m), dtype=torch.int32, device=dev)
    rng = torch.empty((w, m, 2), dtype=torch.int32, device=dev)
    out = torch.zeros((w, out_cap, nv), dtype=torch.int32, device=dev)
    anchor = 0 if anchor_is_s else 2
    _cuda.check(lib.probe_join_launch(
        0, c32.data_ptr(), bv.data_ptr(), w, m, nv, vs.data_ptr(),
        vp.data_ptr(), vo.data_ptr(), keys.data_ptr(), n, *pargs,
        anchor, k_max, counts.data_ptr(), fan.data_ptr(), rng.data_ptr(),
        None, None, out_cap, stream), "probe_join count")
    counts64 = counts.to(torch.int64)
    offsets = (torch.cumsum(counts64, dim=1) - counts64).contiguous()
    _cuda.check(lib.probe_join_launch(
        1, c32.data_ptr(), bv.data_ptr(), w, m, nv, vs.data_ptr(),
        vp.data_ptr(), vo.data_ptr(), keys.data_ptr(), n, *pargs,
        anchor, k_max, None, None, rng.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), out_cap, stream), "probe_join scatter")
    _cuda.count_launch("probe_compact")
    return from_u32_bits(out), counts64, fan



# grid limits of the match-matrix launch: W on grid.z, M / 64 on grid.y
_MM_MAX_W = 65535
_MM_MAX_M = 65535 * 64


def match_matrix_cuda(
    cols: torch.Tensor, bvalid: torch.Tensor,
    ks: torch.Tensor, kp: torch.Tensor, ko: torch.Tensor, kvalid: torch.Tensor,
    pat: CompiledPattern,
) -> torch.Tensor:
    """Candidate matrix over int32 KB words: int8 ``[W, M, N]``, 1 where
    binding row ``m`` of window ``w`` matches KB row ``n`` in every slot
    (valid rows only), else 0."""
    c32, bv = _bind_words(cols, bvalid)
    _require_kb(ks, kp, ko)
    _cuda.require(kvalid, torch.bool, 1, "KB valid")
    if c32.device != ks.device:
        raise ValueError("bindings and KB are on different devices")
    w, m, nv = c32.shape
    n = ks.shape[0]
    if w > _MM_MAX_W or m > _MM_MAX_M:
        raise ValueError("match matrix takes W <= %d and M <= %d, got W=%d "
                         "M=%d" % (_MM_MAX_W, _MM_MAX_M, w, m))
    pargs, eq = pattern_args(pat)
    lib = _lib()
    out = torch.empty((w, m, n), dtype=torch.int8, device=c32.device)
    _cuda.check(lib.match_matrix_launch(
        c32.data_ptr(), bv.data_ptr(), w, m, nv, ks.data_ptr(), kp.data_ptr(),
        ko.data_ptr(), kvalid.data_ptr(), n, *pargs, *eq, out.data_ptr(),
        _cuda.stream_of(c32)), "match_matrix")
    _cuda.count_launch("match_matrix")
    return out
