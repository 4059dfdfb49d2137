#!/usr/bin/env python3
"""Time the fused scan join at ``chip_smoke.py`` phase 2's main-path shape,
one source tree per process, on one NVIDIA GPU.

    python3 tools/scan_join_profile.py                  # this checkout
    python3 tools/scan_join_profile.py --src OTHER/src --label parent

``--src`` names the ``src`` directory of the tree to time (its
``repro_torch`` builds its CUDA sources into its own ``build/cuda``), so
two commits compare inside one machine call: unpack the other commit with
``git archive`` into a git-ignored directory and run the script once per
tree, in turns (parent, change, change, parent).

The world is phase 2's: the ~0.86 M-row KB of ``chip_smoke.make_world``,
8 windows of 4096 binding rows with 425 live rows each (column 0 drawn from
the artist and show ids), the pattern ``?ent rdf:type ?cls``, out_cap 4096;
the second case is the same bindings under ``?ent ?p ?o`` (every KB row
passes the KB-only conditions).  For each case it checks the kernel's
bytes against the plain twin, then prints the wrapper's time (CUDA events,
mean of 10 after 2 warm-ups), each device kernel's time per call under
``torch.profiler`` (mean of 10; the scan-join kernels and what the wrapper
launches around them, apart), and the card's name and power limit.  The
last line is one JSON object with those numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ARTISTS = 100_000
FILLER = 600_000
W, M, NV, LIVE, OUT_CAP = 8, 4096, 4, 425, 4096
ITERS = 10


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "?"


def cuda_ms(fn, iters=ITERS, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters=ITERS) -> dict:
    """Device milliseconds per ``fn()`` by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_join_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
    from repro_torch.core.rdf import Vocab
    from repro_torch.data.dbpedia import KBConfig, generate_kb
    from repro_torch.kernels import _cuda
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
    kb = kbd.kb
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
    sch = kbd.schema
    cases = {
        "?ent rdf:type ?cls": CompiledPattern(
            Slot.bound(0), Slot.const_(sch.rdf_type), Slot.free(1)),
        "?ent ?p ?o": CompiledPattern(Slot.bound(0), Slot.free(1),
                                      Slot.free(2)),
    }
    print("%s (%s): build %.1f s, KB %d rows [%s]"
          % (args.label, args.src, build_s, kb.capacity, smi), flush=True)
    result = {"label": args.label, "card": smi, "cases": {}}
    for tag, pat in cases.items():
        fn = lambda: hj_ops.join_compact(bind, kb, pat, OUT_CAP)  # noqa: E731
        got = fn()
        want = hj_ops.join_compact_torch(bind, kb, pat, OUT_CAP)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            print("FAIL: %s: the kernel disagrees with the plain twin" % tag)
            return 1
        wrapper = cuda_ms(fn)
        kernels = kernel_ms(fn)
        join = {k: v for k, v in kernels.items() if "scan_join" in k}
        print("  %s: matches %d, wrapper %.4f ms, scan-join launches alone "
              "%.4f ms, all device kernels %.4f ms [%s]"
              % (tag, int(got.valid.sum()), wrapper, sum(join.values()),
                 sum(kernels.values()), smi))
        for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print("    %9.4f ms  %s" % (v, k[:110]))
        result["cases"][tag] = {"wrapper_ms": wrapper,
                                "launches_alone_ms": sum(join.values()),
                                "kernels_ms": kernels}
        sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
