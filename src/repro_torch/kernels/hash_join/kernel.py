"""CUDA wrappers for the fused scan join, the fused probe join and the
unfused scan join's match matrix.

The kernels live in ``kernels/csrc/hash_join.cu`` (see its header for the
TPU kernels they replace and what bounds them on the H100).  Each wrapper
checks its arguments, launches its kernels on PyTorch's current stream and
counts one launch.  The scan join and the match matrix convert the
int64-held uint32 binding ids to 32-bit words (the KB columns arrive as
words already: ``KnowledgeBase.words``); the scan join runs count ->
``torch.cumsum`` -> scatter.  The probe join is one launch that reads the
int64 ids and writes its outputs whole, so its wrapper only allocates them.
Nothing is built or loaded at import time.
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
_PROBE = {}         # the most fences the probe kernel stages


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
            [P, P, P, I, I, I, P, P, P, P, I, P, I, I] + _SIG_PATTERN
            + [I, I, P, P, P, I, P])
        lib.probe_join_launch.restype = I
        _PROBE["fences"] = lib.probe_join_fence_limit()
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
    cols: torch.Tensor, bvalid: torch.Tensor, bovf: torch.Tensor,
    vs: torch.Tensor, vp: torch.Tensor, vo: torch.Tensor, keys: torch.Tensor,
    fences: torch.Tensor, shift: int,
    pat: CompiledPattern, anchor_is_s: bool, out_cap: int, k_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused probe join over one sorted view of int32 KB words, in one
    launch.  ``cols [W, M, nv]`` are the int64 binding ids, ``bvalid [W,
    M]`` and ``bovf [W]`` their validity and overflow; ``fences`` holds
    ``keys[i << shift]`` for ``i < ceil(N / 2**shift)``, padded to a
    multiple of 4 (``KnowledgeBase.fences``).
    Returns ``(rows [W, out_cap, nv] int64, valid [W, out_cap], overflow
    [W])``: window w's matches in row-major ``[M, k_max]`` candidate order,
    zero past ``min(total, out_cap)``; overflow is ``bovf | total > out_cap
    |`` a live row's key range wider than ``k_max``."""
    if not 1 <= k_max <= 64:
        raise ValueError("k_max must be in [1, 64], got %d" % k_max)
    cols, bvalid = cols.contiguous(), bvalid.contiguous()
    bovf = bovf.contiguous()
    _cuda.require(cols, torch.int64, 3, "binding cols")
    _cuda.require(bvalid, torch.bool, 2, "binding valid")
    _cuda.require(bovf, torch.bool, 1, "binding overflow")
    w, m, nv = cols.shape
    if bvalid.shape != (w, m) or bovf.shape != (w,):
        raise ValueError("binding cols [W, M, nv] / valid [W, M] / overflow "
                         "[W] expected, got %s / %s / %s" % (
                             tuple(cols.shape), tuple(bvalid.shape),
                             tuple(bovf.shape)))
    _require_kb(vs, vp, vo, keys)
    _cuda.require(fences, torch.int32, 1, "fence table")
    n = keys.shape[0]
    fence_count = -(-n >> shift)
    lib = _lib()
    if (fences.shape[0] % 4
            or not fence_count <= fences.shape[0] <= _PROBE["fences"]
            or fences.data_ptr() % 16):
        raise ValueError("fence table of %d words for %d keys at shift %d "
                         "(KnowledgeBase.fences) expected, got %d"
                         % (fence_count, n, shift, fences.shape[0]))
    if cols.device != keys.device or fences.device != keys.device:
        raise ValueError("bindings and KB are on different devices")
    if w > 65535 or m * k_max >= 1 << 31 or not 0 <= out_cap < 1 << 31:
        raise ValueError("probe join takes W <= 65535, M * k_max < 2^31 and "
                         "0 <= out_cap < 2^31, got W=%d M=%d out_cap=%d"
                         % (w, m, out_cap))
    dev = cols.device
    rows = torch.empty((w, out_cap, nv), dtype=torch.int64, device=dev)
    valid = torch.empty((w, out_cap), dtype=torch.bool, device=dev)
    overflow = torch.empty((w,), dtype=torch.bool, device=dev)
    if w == 0:                  # no window: the outputs hold no element
        return rows, valid, overflow
    pargs, _ = pattern_args(pat)
    _cuda.check(lib.probe_join_launch(
        cols.data_ptr(), bvalid.data_ptr(), bovf.data_ptr(), w, m, nv,
        vs.data_ptr(), vp.data_ptr(), vo.data_ptr(), keys.data_ptr(), n,
        fences.data_ptr(), fence_count, shift, *pargs,
        0 if anchor_is_s else 2, k_max, rows.data_ptr(), valid.data_ptr(),
        overflow.data_ptr(), out_cap, _cuda.stream_of(cols)), "probe_join")
    _cuda.count_launch("probe_compact")
    return rows, valid, overflow


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
