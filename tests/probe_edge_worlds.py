"""Edge worlds of the fused probe join, built with numpy alone.

One list serves three checks: ``test_torch_kernels.py`` holds the plain
twin against the JAX reference on every world (CPU), ``test_torch_cuda.py``
holds the CUDA kernel against the twin on the same worlds (card), and
``chip_smoke.py`` phase 2 repeats the card check.  The worlds aim at the
kernel's design: its 64-key fence segments, its one search (the run of
keys after ``lo`` decides both the candidates and the fan-out flag), its
cluster of up to 8 blocks a window sharing the live rows by rank in tiles
of 512, the 1024 rows with matches a block keeps, and the outputs it
writes whole.

Every world uses predicate 2 and ids from ``BASE`` up (below ``NUM_BASE``:
a subject's composite key orders as the id itself).  Patterns are given as
``((mode, value), ...)`` for s, p, o, mode one of "bound", "const", "free";
:func:`pattern` builds them with either package's ``Slot``.
"""
from typing import List, NamedTuple

import numpy as np

BASE = 5000
PRED = 2
B_C_F = (("bound", 0), ("const", PRED), ("free", 1))   # ?x p ?y, x bound
F_C_B = (("free", 1), ("const", PRED), ("bound", 0))   # ?y p ?x, x bound


class ProbeEdge(NamedTuple):
    tag: str
    kb_rows: np.ndarray     # uint32 [n, 3]
    capacity: int           # KB rows with the pads (pads sort last)
    cols: np.ndarray        # uint32 [W, M, nv]
    valid: np.ndarray       # bool [W, M]
    overflow: np.ndarray    # bool [W]
    pattern: tuple
    out_cap: int
    k_max: int


def pattern(spec, slot_cls, pattern_cls):
    """A ``CompiledPattern`` of ``spec`` from the given package's classes."""
    make = {"bound": slot_cls.bound, "const": slot_cls.const_,
            "free": slot_cls.free}
    return pattern_cls(*(make[m](v) for m, v in spec))


def _kb(runs, rng, mirror=False):
    """KB rows: ``runs`` maps a subject to its number of rows; objects are
    random ids (``mirror``: every row's object is its subject)."""
    subj = np.repeat(np.asarray(list(runs), np.int64),
                     np.asarray(list(runs.values())))
    obj = subj if mirror else rng.integers(BASE, BASE + 4000, subj.size)
    return np.stack([subj, np.full(subj.size, PRED), obj],
                    axis=1).astype(np.uint32)


def _binds(w, m, values, rng, live=0.9, nv=3):
    cols = rng.integers(BASE, BASE + 4000, size=(w, m, nv)).astype(np.uint32)
    cols[..., 0] = rng.choice(np.asarray(values, np.int64), size=(w, m))
    valid = rng.random((w, m)) < live
    return cols, valid, np.zeros(w, bool)


def probe_edge_worlds() -> List[ProbeEdge]:
    rng = np.random.default_rng(20)
    out = []

    def add(tag, rows, cap, binds, pat, out_cap, k_max):
        out.append(ProbeEdge(tag, rows, cap, *binds, pat, out_cap, k_max))

    # query keys below the first key and above the last real key (pads
    # follow it), by object (the (p, o) view)
    rows = _kb({BASE + 1000 + i: 1 + i % 3 for i in range(300)}, rng,
               mirror=True)
    vals = [BASE, BASE + 999, BASE + 1000, BASE + 1299, BASE + 1300,
            BASE + 3000, 0] + [BASE + 1000 + i for i in range(0, 300, 7)]
    add("keys below the first and above the last", rows, rows.shape[0] + 9,
        _binds(2, 150, vals, rng), F_C_B, 1000, 8)

    # views shorter than one fence stride, and one row
    rows = _kb({BASE + 2 * i: 1 + i % 2 for i in range(27)}, rng)
    add("N=%d, below one fence stride" % rows.shape[0], rows, rows.shape[0],
        _binds(2, 60, range(BASE - 1, BASE + 56), rng), B_C_F, 200, 8)
    rows = _kb({BASE + 7: 1}, rng)
    add("N=1", rows, 1, _binds(2, 40, (BASE + 6, BASE + 7, BASE + 8), rng),
        B_C_F, 100, 8)

    # runs of exactly k_max and k_max + 1 keys: window 0 meets only the
    # first (no overflow), window 1 the second (fan-out); behind 50 single
    # keys, a run of 40 over the fence at key 64, which window 0 also meets
    # under k_max 64
    runs = {BASE + i: 1 for i in range(50)}
    star = BASE + 50
    runs[star] = 40
    for k in (1, 8, 64):
        runs[BASE + 100 + k] = k
        runs[BASE + 200 + k] = k + 1
    runs.update({BASE + 300 + i: 2 for i in range(40)})
    rows = _kb(runs, rng)
    for k in (1, 8, 64):
        cols, valid, ovf = _binds(2, 80, [BASE + 100 + k], rng, live=0.8)
        cols[1, :, 0] = BASE + 200 + k
        if k == 64:
            cols[0, ::2, 0] = star
        add("runs of k_max and k_max+1, k_max %d" % k, rows, len(rows) + 3,
            (cols, valid, ovf), B_C_F, 4096, k)

    # out_cap inside block 1 of 4 (M = 2000) and inside row 700's 3 matches
    rows = _kb({BASE + i: 3 for i in range(500)}, rng)
    cols, valid, ovf = _binds(1, 2000, range(BASE, BASE + 500), rng, live=1.0)
    add("out_cap inside a block's range and a row's candidates", rows,
        rows.shape[0], (cols, valid, ovf), B_C_F, 3 * 700 + 1, 8)

    # M = 4096 (a cluster of 8): window 0's live rows all at its end
    rows = _kb({BASE + i: 1 + i % 4 for i in range(1000)}, rng)
    cols, valid, ovf = _binds(2, 4096, range(BASE, BASE + 1100), rng)
    valid[0, :3584] = False
    add("live rows only in the window's last 512 rows", rows, rows.shape[0],
        (cols, valid, ovf), B_C_F, 4096, 8)

    # one window, M off every block and tile size
    add("W=1, M=1537", rows, rows.shape[0],
        _binds(1, 1537, range(BASE, BASE + 1100), rng), B_C_F, 5000, 8)

    # M = 12293, every row live with one match: ~1537 live rows a block,
    # four tiles, more rows with matches than a block keeps; out_cap cuts
    # inside the last block's rows past those
    rows = _kb({BASE + i: 1 for i in range(1500)}, rng)
    cols, valid, ovf = _binds(1, 12293, range(BASE, BASE + 1500), rng,
                              live=1.0)
    for cap in (20000, 12000):
        add("M=12293, several tiles a block, out_cap %d" % cap, rows,
            rows.shape[0], (cols, valid, ovf), B_C_F, cap, 8)

    # the bindings' own overflow flags carried through, and dead rows whose
    # key's run is past k_max, which set no overflow
    runs = {BASE + i: 1 + i % 3 for i in range(100)}
    runs[BASE + 500] = 30
    rows = _kb(runs, rng)
    cols, valid, ovf = _binds(3, 120, range(BASE, BASE + 110), rng)
    cols[:, ::3, 0] = BASE + 500
    valid[:, ::3] = False
    ovf[:] = (True, False, True)
    add("bind.overflow set; dead rows with fan-out past k_max", rows,
        rows.shape[0], (cols, valid, ovf), B_C_F, 4096, 8)

    # nothing to join: no binding row, and no output slot
    empty = (np.zeros((2, 0, 3), np.uint32), np.zeros((2, 0), bool),
             np.asarray([True, False]))
    add("M=0", rows, rows.shape[0], empty, B_C_F, 64, 8)
    add("out_cap=0", rows, rows.shape[0],
        _binds(2, 120, range(BASE, BASE + 100), rng), B_C_F, 0, 8)
    return out
