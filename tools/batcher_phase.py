#!/usr/bin/env python3
"""The attention kernels' phase-2 cases and phase 12 of ``chip_smoke.py``
(the continuous batcher at full width) alone.

    python3 tools/batcher_phase.py     # from the repository root, on a card
    python3 tools/batcher_phase.py --arch mixtral-8x22b   # one world only
    python3 tools/batcher_phase.py --arch minicpm3-4b --arch deepseek-v2-236b
    python3 tools/batcher_phase.py --arch jamba-v0.1-52b

Builds the kernels, holds flash and decode attention against their plain
versions (``chip_smoke.phase_attention``, the head-dim-80, windowed,
Mixtral, MLA and Jamba cases included, each timed), then runs
``chip_smoke.phase_batcher`` (over the ``BATCH_WORLDS`` entries of the
``--arch`` names given, all of them by default) and prints its launch
counts.  Needs a card.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append",
                    choices=[w[0] for w in cs.BATCH_WORLDS])
    args = ap.parse_args(argv)
    if args.arch:
        cs.BATCH_WORLDS = tuple(w for w in cs.BATCH_WORLDS
                                if w[0] in args.arch)
    if not torch.cuda.is_available():
        print("batcher_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    t0 = time.time()
    _cuda.build_all()
    built = time.time()
    smi = cs.smi_line()
    cs.log("card: " + smi)
    recs = cs.phase_attention(smi)
    t1 = time.time()
    cs.log("attention cases: %.1f s (build %.1f s)" % (t1 - built,
                                                       built - t0))
    total = cs.phase_batcher(smi)
    cs.log("phase 12 alone: %.1f s, launches %s" % (time.time() - t1,
                                                   json.dumps(total)))
    print(json.dumps({"kernels": [recs[k].row(total[k]) for k in recs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
