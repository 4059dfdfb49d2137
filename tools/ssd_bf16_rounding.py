#!/usr/bin/env python3
"""Which float32 operands of the bf16 SSD kernel's products must be kept to
~16 bits: a CPU emulation of the kernel's arithmetic against its plain
version.

    python3 tools/ssd_bf16_rounding.py [--batch 1] [--t 4096]

The bf16 passes of ``csrc/ssd.cu`` multiply on the tensor cores, where both
operands are bf16.  Three operands are float32 in the algebra: x o w in
the chunk state (w = dt o exp(la_L - la)), the entering state S_in in
C S_in, and the masked scores M = (C B^T) o Gamma o dt in M x.  This script
computes the chunked scan in float32 on the CPU (the products exact in
float32, as the tensor cores accumulate), rounding each of the three
either once to bf16 or as hi + lo (two bf16 terms), and holds y and the
final state to the card tests' tolerances against ``ref.ssd_chunked``: y
within 2e-2 + 1e-2 relative (bf16), the state within 2e-4 + 2e-4
relative.  Inputs are the card tests' distributions at Mamba2-130M's
widths (H 24, P 64, S 128, G 1, chunk 128) from seed 0.  Prints, for each
rounding choice, the y elements past tolerance and the state's largest
difference beyond its relative part.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf(t):
    return t.to(torch.bfloat16).float()


def _round(t, split):
    """t as the tensor cores see it: one bf16 term, or hi + lo."""
    hi = _bf(t)
    return hi + _bf(t - hi) if split else hi


def emulate(x, dt, A, Bm, Cm, L, s0, split_w, split_s, split_m):
    """The kernel's chunk algebra (G = 1), float32 with rounded operands."""
    b, t, h, p = x.shape
    s = Bm.shape[3]
    nl = t // L
    xc = x.float().reshape(b, nl, L, h, p)
    Bc = Bm.float().reshape(b, nl, L, s)
    Cc = Cm.float().reshape(b, nl, L, s)
    dtc = dt.reshape(b, nl, L, h).permute(0, 1, 3, 2)          # b c h L
    la = torch.cumsum(dtc * A[:, None], -1)
    w = torch.exp(la[..., -1:] - la) * dtc
    xw = _round(w.permute(0, 1, 3, 2)[..., None] * xc, split_w)
    own = torch.einsum("bcls,bclhp->bchsp", Bc, xw)
    state, entering = s0.clone(), []
    for c in range(nl):
        entering.append(state)
        state = torch.exp(la[:, c, :, -1])[..., None, None] * state + own[:, c]
    ent = _round(torch.stack(entering, 1), split_s)               # b c h s p
    y = torch.einsum("bcts,bchsp->bcthp", Cc, ent)
    y = y * torch.exp(la).permute(0, 1, 3, 2)[..., None]
    cb = torch.einsum("bcts,bcus->bctu", Cc, Bc)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    gamma = torch.where(causal, torch.exp(la[..., :, None] - la[..., None, :]),
                        torch.zeros(()))                          # b c h t u
    m = _round(cb[:, :, None] * gamma * dtc[..., None, :], split_m)
    y = y + torch.einsum("bchtu,bcuhp->bcthp", m, xc)
    return y.reshape(b, t, h, p).to(torch.bfloat16), state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--t", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels.ssd import ref

    rng = np.random.default_rng(0)
    b, t, h, p, s, L = args.batch, args.t, 24, 64, 128, 128
    xbc = torch.from_numpy(rng.standard_normal(
        (b, t, h * p + 2 * s)).astype(np.float32)).to(torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, t, h, p)
    Bm = xbc[..., h * p:h * p + s].reshape(b, t, 1, s)
    Cm = xbc[..., h * p + s:].reshape(b, t, 1, s)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, t, h)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, s, p)).astype(np.float32))
    want_y, want_s = ref.ssd_chunked(x, dt, A, Bm, Cm, L, s0)
    print("B %d, T %d, H %d, P %d, S %d, chunk %d: %d outputs"
          % (b, t, h, p, s, L, want_y.numel()))
    for split in ((True, True, True), (True, True, False),
                  (True, False, True), (False, True, True)):
        y, st = emulate(x, dt, A, Bm, Cm, L, s0, *split)
        d = (y.float() - want_y.float()).abs()
        past = int(((d - 1e-2 * want_y.float().abs()) > 2e-2).sum())
        excess = float(((st - want_s).abs() - 2e-4 * want_s.abs()).max())
        print("hi + lo for x o w %-5s S_in %-5s M %-5s: y past 2e-2 + 1e-2 "
              "rel: %d (largest |diff| %.4g); state: largest |diff| - 2e-4 "
              "|want| = %.3g (tolerance 2e-4)"
              % (*split, past, float(d.max()), excess))
    return 0


if __name__ == "__main__":
    sys.exit(main())
