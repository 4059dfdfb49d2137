"""Plain PyTorch versions of the Mamba-2 SSD scan.

State-space model with a scalar decay per head (the SSD restriction):

    a_t = exp(dt_t * A_h)                      (decay, A_h < 0)
    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T     (state [d_state, headdim])
    y_t = C_t^T S_t (+ D_h * x_t)

B and C are shared by the heads of a group (G groups, H heads, H % G ==
0): head ``h`` reads group ``h // (H / G)``.

:func:`ssd_ref` is the sequential oracle (the reference's ``ssd_ref``).
:func:`ssd_chunked` is the CUDA kernel's chunk algebra (the reference's
``ssd_pallas``) in plain torch: the version the kernel is held against on
the card, and the CPU path of ``ops.ssd``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _group_of_heads(h: int, g: int) -> int:
    if g == 0 or h % g:
        raise ValueError("heads %d are not a multiple of groups %d" % (h, g))
    return h // g


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            D: Optional[torch.Tensor] = None,
            init_state: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B,T,H,P]``, ``dt [B,T,H]``, ``A [H]``, ``Bm, Cm [B,T,G,S]``,
    ``D [H]``, ``init_state [B,H,S,P]`` -> ``(y [B,T,H,P]`` in x's dtype,
    ``final_state [B,H,S,P]`` float32), one step at a time in float32."""
    b, t, h, p = x.shape
    rep = _group_of_heads(h, Bm.shape[2])
    Bf = Bm.float().repeat_interleave(rep, dim=2)          # [B,T,H,S]
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = (init_state.float().clone() if init_state is not None
             else torch.zeros((b, h, Bm.shape[3], p), dtype=torch.float32,
                              device=x.device))
    ys = []
    for i in range(t):
        a = torch.exp(dtf[:, i] * Af)                       # [B,H]
        upd = (dtf[:, i, :, None] * Bf[:, i])[..., None] * xf[:, i, :, None, :]
        state = a[..., None, None] * state + upd
        ys.append(torch.einsum("bhs,bhsp->bhp", Cf[:, i], state))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan without the ``D`` skip: ``(y [B,T,H,P]`` in x's
    dtype, ``final_state [B,H,S,P]`` float32).  T is padded to a multiple
    of ``chunk`` with ``dt = 0`` (no decay, no update) and the padding
    dropped from y.  Per chunk of length L, all in float32:

        la    = cumsum(dt * A)
        y     = ((C B^T) * Gamma * dt) @ x + (C * exp(la)) @ state
                Gamma[t, s] = exp(la_t - la_s) for s <= t, else 0
        state = exp(la_L) * state + (B * dt * exp(la_L - la))^T @ x

    The state recurrence runs as the kernel's: every chunk's own state
    first, then the carry across chunks, then each chunk's output."""
    b, t, h, p = x.shape
    g, s = Bm.shape[2], Bm.shape[3]
    rep = _group_of_heads(h, g)
    pad = (-t) % chunk
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    nl, L = (t + pad) // chunk, chunk
    xc = xf.reshape(b, nl, L, g, rep, p)
    Bc = Bf.reshape(b, nl, L, g, s)
    Cc = Cf.reshape(b, nl, L, g, s)
    dtc = dtf.reshape(b, nl, L, g, rep).permute(0, 1, 3, 4, 2)   # [b,c,g,r,L]
    la = torch.cumsum(dtc * A.float().reshape(g, rep)[..., None], dim=-1)
    la_last = la[..., -1:]                                       # [b,c,g,r,1]

    # intra-chunk: masked decay attention
    scores = torch.einsum("bctgk,bcsgk->bcgts", Cc, Bc)          # [b,c,g,L,L]
    # exp of the masked differences: above the diagonal they can pass
    # float32's range, and a masked inf would turn a gradient into NaN
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    gamma = torch.exp(torch.where(causal, la[..., :, None] - la[..., None, :],
                                  float("-inf")))                # [b,c,g,r,L,L]
    m = scores[:, :, :, None] * gamma * dtc[..., None, :]
    y = torch.einsum("bcgrts,bcsgrp->bctgrp", m, xc)

    # each chunk's own state, then the carry across chunks
    w = torch.exp(la_last - la) * dtc                            # [b,c,g,r,L]
    own = torch.einsum("bclgk,bcgrl,bclgrp->bcgrkp", Bc, w, xc)
    decay = torch.exp(la_last[..., 0])                           # [b,c,g,r]
    state = (init_state.float().reshape(b, g, rep, s, p)
             if init_state is not None
             else torch.zeros((b, g, rep, s, p), dtype=torch.float32,
                              device=x.device))
    entering = []
    for c in range(nl):
        entering.append(state)
        state = decay[:, c, ..., None, None] * state + own[:, c]
    entering = torch.stack(entering, dim=1)                      # [b,c,g,r,S,P]

    # inter-chunk: the carried state's contribution
    y = y + torch.einsum("bctgk,bcgrt,bcgrkp->bctgrp", Cc, torch.exp(la),
                         entering)
    y = y.reshape(b, nl * L, h, p)[:, :t]
    return y.to(x.dtype), state.reshape(b, h, s, p)
