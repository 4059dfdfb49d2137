"""Carry state into the port from plain numpy arrays and dicts.

The same vocabulary, KB, stream chunks and LM parameters can feed both the
reference package and this port: extract them with ``np.asarray`` on one
side and rebuild them here.  Nothing in this module takes the reference's
objects.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.kb import KnowledgeBase
from .core.pattern import Bindings
from .core.rdf import ID_DTYPE, PAD_ID, TripleBatch, Vocab

KB_FIELDS = KnowledgeBase._fields


def vocab_from_state(pred_to_id: Mapping[str, int],
                     term_to_id: Mapping[str, int], next_pred: int,
                     next_term: int) -> Vocab:
    """A :class:`Vocab` holding exactly the given interning tables."""
    v = Vocab()
    v._pred_to_id = dict(pred_to_id)
    v._term_to_id = dict(term_to_id)
    v._id_to_str = {PAD_ID: "<pad>"}
    v._id_to_str.update({i: n for n, i in pred_to_id.items()})
    v._id_to_str.update({i: n for n, i in term_to_id.items()})
    v._next_pred = int(next_pred)
    v._next_term = int(next_term)
    return v


def _ids(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def _mask(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, bool).copy()).to(device)


def kb_from_arrays(arrays: Mapping[str, np.ndarray], device="cpu") -> KnowledgeBase:
    """A KB from its 9 field arrays (``s_ps`` ... ``key_po`` ids, ``valid``)."""
    missing = set(KB_FIELDS) - set(arrays)
    if missing:
        raise KeyError("KB arrays missing %s" % sorted(missing))
    return KnowledgeBase(*(
        _mask(arrays[f], device) if f == "valid" else _ids(arrays[f], device)
        for f in KB_FIELDS))


def triples_from_arrays(s, p, o, ts, graph, valid, device="cpu") -> TripleBatch:
    """A TripleBatch from uint32 id columns and a bool validity column."""
    return TripleBatch(_ids(s, device), _ids(p, device), _ids(o, device),
                       _ids(ts, device), _ids(graph, device),
                       _mask(valid, device))


def bindings_from_arrays(cols, valid, overflow, device="cpu") -> Bindings:
    """Bindings from ``cols [W, cap, nv]`` / ``valid [W, cap]`` / ``overflow
    [W]`` (2-D / 1-D / scalar inputs get a window dimension of 1)."""
    cols = np.asarray(cols)
    valid = np.asarray(valid, bool)
    overflow = np.asarray(overflow, bool)
    if cols.ndim == 2:
        cols, valid, overflow = cols[None], valid[None], overflow.reshape(1)
    return Bindings(_ids(cols, device).to(ID_DTYPE), _mask(valid, device),
                    _mask(overflow, device))


def _param(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        device=device, dtype=dtype)


def lm_params_from_arrays(params: Mapping, cfg: ModelConfig, device="cpu"):
    """An :class:`~repro_torch.models.lm.LM` from the reference's nested
    parameter dict as numpy arrays: ``embed`` (``[Vp, d]``, or ``[K, Vp,
    d]`` for K codebooks), ``final_norm``, optional ``lm_head`` (``[d,
    Vp]``, or ``[d, K * Vp]``), carried as they lie, and for each
    sub-layer ``i`` of the layer pattern ``blocks/sub{i}/{nm, attn/*}``
    (``attn`` holds ``wq, wk, wv, wo`` and the biases for GQA, ``wq_a,
    wq_b`` or ``wq``, ``wkv_a, wk_rope, wkv_b, wo`` for MLA) or
    ``blocks/sub{i}/{nm, mamba/*}`` (Mamba-1 or Mamba-2, the leaves of
    ``mamba.LEAVES`` by the configuration's version), and, where the
    sub-layer has an FFN, ``nf`` and ``mlp/{wi, wg, wo}`` (dense) or
    ``moe/{router, wi, wg, wo, shared/*}`` (an MoE; ``shared`` where it
    has shared experts), stacked on a leading period axis, which is
    unstacked here: layer ``j`` is period ``j // P`` of sub-layer ``j %
    P``, the reference's scan order.  A norm without weights (OLMo's) has
    no ``nm``, ``nf`` or ``final_norm`` leaf.  The port keeps the
    reference's weight layouts, so nothing is transposed; values are cast
    to ``cfg.dtype``, except what the reference keeps in float32: Mamba's
    ``A_log``, ``D`` and ``dt_bias`` and the MoE router."""
    from .models.attention import MLA, Attention
    from .models.common import dtype_of
    from .models.lm import LM, Block, check_supported
    from .models.mamba import FLOAT32_LEAVES, LEAVES, Mamba
    from .models.mlp import MLP
    from .models.moe import MoE

    check_supported(cfg)
    dtype = dtype_of(cfg.dtype)

    def t(a, dt=dtype):
        return _param(a, dt, device)

    def opt(tree, name, i=None):
        if name not in tree:
            return None
        return t(tree[name] if i is None else tree[name][i])

    def mlp(tree, i):
        return MLP(*(t(tree[n][i]) for n in ("wi", "wg", "wo")))

    def mixer(sub, i):
        if "mamba" in sub:
            mm, version = sub["mamba"], cfg.mamba.version
            return Mamba(*(t(mm[n][i], torch.float32 if n in FLOAT32_LEAVES
                             else dtype) for n in LEAVES[version]),
                         version=version)
        at = sub["attn"]
        if "wkv_a" in at:
            return MLA(*(t(at[n][i]) for n in ("wkv_a", "wk_rope", "wkv_b",
                                              "wo")),
                       **{n: opt(at, n, i) for n in ("wq", "wq_a", "wq_b")})
        return Attention(*(t(at[n][i]) for n in ("wq", "wk", "wv", "wo")),
                         *(opt(at, n, i) for n in ("bq", "bk", "bv")))

    def ffn(sub, i):
        if "mlp" in sub:
            return mlp(sub["mlp"], i)
        if "moe" in sub:
            mo = sub["moe"]
            return MoE(t(mo["router"][i], torch.float32),
                       *(t(mo[n][i]) for n in ("wi", "wg", "wo")),
                       mlp(mo["shared"], i) if "shared" in mo else None)
        return None

    blocks = []
    for j in range(cfg.num_layers):
        i, sub = j // cfg.period, params["blocks"]["sub%d" % (j % cfg.period)]
        blocks.append(Block(opt(sub, "nm", i), mixer(sub, i),
                            opt(sub, "nf", i), ffn(sub, i)))
    return LM(cfg, t(params["embed"]), blocks, opt(params, "final_norm"),
              opt(params, "lm_head"))
