#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (LM training) alone.

    python3 tools/train_phase.py     # from the repository root, on a card

Builds the kernels, then runs ``chip_smoke.phase_train``: every
architecture's smoke model trained on the card against the CPU, Mamba2-130M
at full width through ``launch.train.main`` with a crash, a restore and a
resume, Qwen2-1.5B at full width in each remat mode, and the eval losses
through the flash and SSD kernels; prints their launch counts.  Needs a
card.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda

    t0 = time.time()
    _cuda.build_all()
    smi = cs.smi_line()
    cs.log("card: %s | torch %s, CUDA %s; build %.1f s"
           % (smi, torch.__version__, torch.version.cuda, time.time() - t0))
    t1 = time.time()
    launches = cs.phase_train(smi)
    cs.log("phase 14 alone: %.1f s, launches %s"
           % (time.time() - t1, json.dumps(launches)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
