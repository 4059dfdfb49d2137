#!/usr/bin/env python3
"""Time DSCEP configurations end to end, as ``chip_smoke.py`` phases 3 and
4 do, for one source tree a process, on one NVIDIA GPU.

    python3 tools/dscep_ab.py                                # this checkout
    python3 tools/dscep_ab.py --tree OTHER --label parent
    python3 tools/dscep_ab.py --configs cquery1:single_program:auto

``--tree`` names the root of the checkout to time.  Its ``chip_smoke.py``
supplies the world, the caps and the drive (``make_world``,
``exec_config``, ``run_session``), its ``src`` is imported, and its CUDA
sources build into its own ``build/cuda``.  So two commits compare inside
one machine call: unpack the other commit with ``git archive`` into a
git-ignored directory and run the script once per tree, in turns (parent,
change, change, parent).

For each configuration ``query:mode:method`` (tumbling windows, phase 3's
world and caps): the sink the DAG runs, plan time, chunks/s of phase 3
(one warm-up chunk, then the stream ``--repeats`` times; median with the
slowest and fastest) and phase 4's profile over two chunks (wall, device
busy from kernel events, idle share).  A mode the tree lacks is reported
and skipped.  Prints the card's name and power limit; the last line is one
JSON object with every number.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("cquery1:single_program:auto,cquery1:monolithic:auto,"
           "cquery1:pipelined:auto,q15:single_program:auto,"
           "q16:single_program:auto,artist_classes:single_program:auto")


def load_smoke(tree: str):
    """The tree's ``chip_smoke.py`` as a module, with its ``src`` first on
    the path."""
    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_two_chunks(cs, reg, chunks) -> dict:
    """Phase 4's window: one warm-up chunk, then two chunks profiled."""
    from torch.profiler import ProfilerActivity, profile

    reg.run(chunks[:1])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.sync()
        t0 = time.perf_counter()
        reg.run(chunks[1:3])
        cs.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(cs.device_times(prof).values()) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms) if busy_ms else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--configs", default=CONFIGS)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dscep_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    cs = load_smoke(tree)
    from repro_torch.core.session import MODES, Session
    from repro_torch.kernels import _cuda

    smi = cs.smi_line()
    print("card: %s | tree %s (%s)" % (smi, tree, args.label), flush=True)
    t0 = time.time()
    _cuda.build_all()
    print("build %.1f s" % (time.time() - t0), flush=True)
    vocab, kbd, _, chunks = cs.make_world()
    texts = cs.query_texts()
    gpu_chunks = [c.to("cuda") for c in chunks]
    rows = []
    for item in args.configs.split(","):
        q, mode, method = item.split(":")
        if mode not in MODES:
            print("  %-14s %-14s %-5s not in this tree" % (q, mode, method))
            continue
        cfg = cs.exec_config(mode, method, "cuda")
        res = cs.run_session(vocab, kbd.kb, gpu_chunks, texts[q], cfg,
                             args.repeats)
        rates = sorted(len(res["outs"]) / t for t in res["run_s"])
        reg = Session(cfg, vocab=vocab, kb=kbd.kb).register(texts[q])
        prof = profile_two_chunks(cs, reg, gpu_chunks)
        row = {"query": q, "mode": mode, "method": method,
               "sink": getattr(reg.runtime, "sink_kind", "augmented")
               if mode != "monolithic" else "-",
               "plan_s": res["plan_s"],
               "chunks_per_s": rates[len(rates) // 2],
               "chunks_per_s_range": [rates[0], rates[-1]],
               "overflow": sum(res["overflow"].values()),
               "output_triples": cs.n_triples(res["outs"]), **prof}
        rows.append(row)
        print("  %-14s %-14s %-5s sink %-11s %.2f chunks/s (%.2f-%.2f), "
              "plan %.3f s; 2 chunks: wall %.1f ms, device busy %.1f ms, "
              "idle share %s [%s]"
              % (q, mode, method, row["sink"], row["chunks_per_s"],
                 rates[0], rates[-1], row["plan_s"], prof["wall_ms"],
                 prof["busy_ms"], "%.3f" % prof["idle_share"]
                 if prof["idle_share"] is not None else "not measured", smi),
              flush=True)
        if row["overflow"]:
            print("  overflow in %s %s %s" % (q, mode, method))
            return 1
    print(json.dumps({"label": args.label, "tree": tree, "card": smi,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
