#!/usr/bin/env python3
"""Time decode attention and the SSD scan at ``chip_smoke.py``'s path
shapes on one NVIDIA GPU, apart from the rest of the smoke run.

    python3 tools/decode_ssd_profile.py [--splits 4,8] [--lengths 2080]
        [--iters 20] [--src OTHER/src --label parent]

Decode attention (Qwen2-1.5B's step: B=4, 12/2 heads, D=128, a 2112-row
bf16 cache, length 2080) once per cluster size in ``--splits``: the
wrapper's most splits (``kernel.MAX_SPLIT``) set to it, the split chosen,
the answer against the plain version, the wrapper (CUDA events) and its
launches alone (``torch.profiler``), beside SDPA on the live prefix.  The
SSD (Mamba2-130M's prefill: B=4, T=4096, H=24, P=64, G=1, S=128, chunk
128, bf16) against its plain chunked version, the wrapper, and each pass's
device time.  Prints the card's name and power limit, and as its last line
one JSON object with those numbers.  ``--lengths`` repeats the decode
timings at other live lengths (the tiles a split reads).  ``--src`` names
the ``src`` directory of another tree to time (it builds into its own
``build/cuda``), so two trees compare in one machine call, one process
each.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tools", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="8")
    ap.add_argument("--lengths", default="2080")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_ssd_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref

    cs = _chip_smoke()
    smi = cs.smi_line()
    print("card: %s | %s: %s" % (smi, args.label, args.src), flush=True)
    out = {"card": smi, "label": args.label, "decode": [], "ssd": {}}

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, hk, s, d = 4, 12, 2, 2112, 128
    q = torch.randn((b, hq, 1, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, hk, s, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, hk, s, d), generator=gen, device="cuda").bfloat16()
    default = da_kernel.MAX_SPLIT
    for length in [int(x) for x in args.lengths.split(",")]:
        lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
        want = da_ref.decode_attention_ref(q, k, v, lens).float()
        sdpa_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k[:, :, :length], v[:, :, :length], enable_gqa=True),
            iters=args.iters)
        for most in [int(x) for x in args.splits.split(",")]:
            da_kernel.MAX_SPLIT = most
            nsplit = da_kernel.cluster_splits(
                b * hk, s, da_kernel._sm_count(q.device))

            def call():
                return da_kernel.decode_attention_cuda(q, k, v, lens)

            err = float((call().float() - want).abs().max())
            row = {"length": length, "max_split": most, "nsplit": nsplit,
                   "max_abs_err": err,
                   "wrapper_ms": cs.cuda_ms(call, iters=args.iters),
                   "launch_ms": cs.launch_ms(call, "decode_",
                                             iters=args.iters),
                   "sdpa_ms": sdpa_ms}
            out["decode"].append(row)
            print("decode  length %5d, max split %2d -> %2d splits: "
                  "max_abs_err %.3g, wrapper %.4f ms, launches alone %.4f ms,"
                  " SDPA %.4f ms [%s]" % (length, most, nsplit, err,
                                          row["wrapper_ms"], row["launch_ms"],
                                          sdpa_ms, smi), flush=True)
    da_kernel.MAX_SPLIT = default

    x, dt, A, Bm, Cm, _ = cs._ssd_inputs(4, 4096, 24, 64, 1, 128,
                                         torch.bfloat16, False,
                                         np.random.default_rng(0))

    def ssd():
        return ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, 128)

    (y, st), (wy, wst) = ssd(), ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, 128)
    passes = {}
    alone = cs.launch_ms(ssd, "ssd_", iters=args.iters, by_kernel=passes)
    out["ssd"] = {"y_max_abs_err": float((y.float() - wy.float()).abs().max()),
                  "state_max_abs_err": float((st - wst).abs().max()),
                  "wrapper_ms": cs.cuda_ms(ssd, iters=args.iters),
                  "launch_ms": alone, "passes": passes}
    print("ssd     y max_abs_err %.3g, state %.3g: wrapper %.4f ms, launches "
          "alone %.4f ms [%s]" % (out["ssd"]["y_max_abs_err"],
                                  out["ssd"]["state_max_abs_err"],
                                  out["ssd"]["wrapper_ms"], alone, smi))
    for name, ms in sorted(passes.items(), key=lambda kv: -kv[1]):
        print("  %.4f ms  %s" % (ms, name[:100]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
