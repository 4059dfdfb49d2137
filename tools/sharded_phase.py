#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` (sharded paths and the launcher) alone.

    python3 tools/sharded_phase.py     # from the repository root, on a card

Builds the kernels and phase 3's world, runs the phase-3 configurations
phase 11 compares with (Q15 and CQuery1 ``single_program`` under ``auto``
and ``scan``, unsharded), then ``chip_smoke.phase_sharded``.  Needs a card;
on more than one, phase 11's "visible cards" mesh and ``make_host_mesh()``
span them all.
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    t0 = time.time()
    _cuda.build_all()
    smi = cs.smi_line()
    cs.log("card: " + smi)
    vocab, kbd, _, chunks = cs.make_world()
    texts = cs.query_texts()
    gpu = [c.to("cuda") for c in chunks]
    results = {}
    for q in cs.OBS_QUERIES:
        for method in ("auto", "scan"):
            results[(q, "single_program", method)] = cs.run_session(
                vocab, kbd.kb, gpu, texts[q],
                cs.exec_config("single_program", method, "cuda"))["outs"]
    t1 = time.time()
    cs.phase_sharded(vocab, kbd, chunks, results, smi)
    cs.log("phase 11 alone: %.1f s (set-up %.1f s)"
           % (time.time() - t1, t1 - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
