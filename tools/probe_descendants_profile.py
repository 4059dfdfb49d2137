#!/usr/bin/env python3
"""Time the fused probe join and the descendants step at ``chip_smoke.py``
phase 2's main-path shapes, one source tree per process, on one NVIDIA GPU.

    python3 tools/probe_descendants_profile.py                  # this checkout
    python3 tools/probe_descendants_profile.py --src OTHER/src --label parent
    python3 tools/probe_descendants_profile.py --shifts 5,6,7,8

``--src`` names the ``src`` directory of the tree to time (its
``repro_torch`` builds its CUDA sources into its own ``build/cuda``), so
two commits compare inside one machine call: unpack the other commit with
``git archive`` into a git-ignored directory and run the script once per
tree, in turns (parent, change, change, parent).

The world is phase 2's: the ~0.86 M-row KB of ``chip_smoke.make_world``, 8
windows of 4096 binding rows with 425 live rows each (column 0 drawn from
the artist and show ids), the probe ``?ent rdf:type ?cls`` with out_cap
4096 and k_max 8; the descendants step on the KB's class hierarchy (the
reach matrix after all squarings but the last, root MusicalArtist).  For
each kernel it checks the bytes against the plain twin, then prints the
wrapper's time (CUDA events, mean of ``--iters`` after 2 warm-ups) and
each device kernel's time per call under ``torch.profiler``.  Where the
tree has fence tables (``KnowledgeBase.fences``), ``--shifts`` also times
the probe kernel with fence tables of other strides (every 2^s-th key),
each checked against the twin.  Prints the card's name and power limit; the
last line is one JSON object with those numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from scan_join_profile import cuda_ms, kernel_ms, smi_line   # same folder

ARTISTS = 100_000
FILLER = 600_000
W, M, NV, LIVE, OUT_CAP, K_MAX = 8, 4096, 4, 425, 4096, 8


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def timed(tag, fn, symbol, iters, smi):
    wrapper = cuda_ms(fn, iters)
    kernels = kernel_ms(fn, iters)
    alone = sum(v for k, v in kernels.items() if symbol in k)
    print("  %s: wrapper %.4f ms, launches alone %.4f ms, all device kernels "
          "%.4f ms [%s]" % (tag, wrapper, alone, sum(kernels.values()), smi))
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
        print("    %9.4f ms  %s" % (v, k[:110]))
    sys.stdout.flush()
    return {"wrapper_ms": wrapper, "launches_alone_ms": alone,
            "kernels_ms": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shifts", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_descendants_profile: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
    from repro_torch.core.reasoner import (
        adjacency_from_edges, build_class_index, subclass_edges)
    from repro_torch.core.rdf import Vocab
    from repro_torch.data.dbpedia import KBConfig, generate_kb
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.closure import ops as cl_ops
    from repro_torch.kernels.closure import ref as cl_ref
    from repro_torch.kernels.hash_join import kernel as hj_kernel
    from repro_torch.kernels.hash_join import ops as hj_ops

    smi = smi_line()
    t0 = time.time()
    _cuda.build_all()
    build_s = time.time() - t0
    vocab = Vocab()
    kbd = generate_kb(vocab, KBConfig(
        num_artist_classes=240, num_show_classes=60, num_artists=ARTISTS,
        num_shows=ARTISTS // 2, num_places=10_000, num_countries=200,
        filler_triples=FILLER, seed=0), device="cuda")
    kb, sch = kbd.kb, kbd.schema
    rng = np.random.default_rng(0)
    pool = np.concatenate([kbd.artist_ids, kbd.show_ids]).astype(np.int64)
    cols = np.zeros((W, M, NV), np.int64)
    valid = np.zeros((W, M), bool)
    for i in range(W):                  # as chip_smoke._bindings
        cols[i, :LIVE, 0] = rng.choice(pool, size=LIVE)
        cols[i, :LIVE, 1:] = rng.integers(1, 1 << 20, size=(LIVE, NV - 1))
        valid[i, :LIVE] = True
    bind = Bindings(torch.from_numpy(cols).cuda(),
                    torch.from_numpy(valid).cuda(),
                    torch.zeros((W,), dtype=torch.bool, device="cuda"))
    pat = CompiledPattern(Slot.bound(0), Slot.const_(sch.rdf_type),
                          Slot.free(1))
    print("%s (%s): build %.1f s, KB %d rows [%s]"
          % (args.label, args.src, build_s, kb.capacity, smi), flush=True)
    result = {"label": args.label, "card": smi}

    def probe():
        return hj_ops.probe_compact(bind, kb, pat, OUT_CAP, K_MAX)

    want = hj_ops.probe_compact_torch(bind, kb, pat, OUT_CAP, K_MAX)
    if not same(probe(), want):
        print("FAIL: the probe kernel disagrees with the plain twin")
        return 1
    result["probe"] = timed("probe join W=%d M=%d k_max=%d, %d matches"
                            % (W, M, K_MAX, int(want.valid.sum())), probe,
                            "probe_join", args.iters, smi)

    shifts = [int(x) for x in args.shifts.split(",") if x]
    if shifts and hasattr(kb, "fences"):
        words = kb.words
        result["shifts"] = {}
        for sh in shifts:
            f = words.key_ps[::1 << sh]
            f = torch.cat([f, f.new_full(((-len(f)) % 4,), -1)])
            cnt = -(-kb.capacity >> sh)

            def probe_at(f=f, sh=sh):
                return hj_kernel.probe_compact_cuda(
                    bind.cols, bind.valid, bind.overflow, words.s_ps,
                    words.p_ps, words.o_ps, words.key_ps, f, sh, pat, True,
                    OUT_CAP, K_MAX)

            if not same(probe_at(), want):
                print("FAIL: the probe kernel at shift %d disagrees" % sh)
                return 1
            result["shifts"][sh] = timed(
                "probe join, fences every %d keys (%d fences, %d KB)"
                % (1 << sh, cnt, 4 * len(f) // 1024), probe_at, "probe_join",
                args.iters, smi)

    edges = subclass_edges(kb, sch.subclass_of)
    idx, ids = build_class_index(edges)
    reach = cl_ops._reach(adjacency_from_edges(edges, idx), 128, "cuda")
    for _ in range(cl_ops._steps(len(ids), None) - 1):
        reach = cl_ops.closure_step(reach)
    root = idx[sch.musical_artist]
    col = reach[:, root].contiguous()
    want = cl_ref.descendants_step_ref(reach, col, len(ids))

    def desc():
        return cl_ops.descendants_step(reach, col, len(ids))

    if not same(desc(), want):
        print("FAIL: the descendants kernel disagrees with the plain twin")
        return 1
    n = reach.shape[0]
    result["descendants"] = timed(
        "descendants n=%d, %d of %d classes" % (n, int(want[1]), len(ids)),
        desc, "descendants", args.iters, smi)
    result["library_ms"] = {"descendants (mv + nonzero)": cuda_ms(
        lambda: torch.nonzero(torch.clamp_max(torch.mv(reach, col), 1.0)
                              > 0.5), args.iters)}
    print("  library: mv + nonzero %.4f ms"
          % result["library_ms"]["descendants (mv + nonzero)"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
