"""LM assembly for dense GQA stacks: init, forward, KV cache, decode step.

The reference scans over stacked layer weights; here the stack is a
Python loop over :class:`Block` modules (the port runs eagerly).  Weights
keep the reference's layouts (``interop.lm_params_from_arrays`` carries
the reference's parameters in).  MoE, Mamba, codebook heads, vision/audio
frontends, MLA and M-RoPE raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.

The cache is ``{"k": [L, B, Hk, S, D], "v": [L, B, Hk, S, D], "len":
int}``; :func:`decode_step` writes the new rows into it and advances
``len`` in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import LayerSpec, ModelConfig, not_ported
from .attention import (
    Attention, check_attention, gqa_cache_shape, gqa_forward, init_attention,
)
from .common import (
    dtype_of, normal_param, ones_param, resolve_device, rms_norm,
)
from .mlp import MLP, init_mlp

NEG_INF = -1e30


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's LM does not run yet."""
    if cfg.layer_pattern != (LayerSpec("attn", "dense"),):
        item = ("Mamba-2 forward and the SSD kernel"
                if any(s.mixer == "mamba" for s in cfg.layer_pattern)
                else "Other LM architectures")
        raise not_ported("layer pattern %s (%s)" % (cfg.layer_pattern,
                                                    cfg.name), item)
    if cfg.moe is not None:
        raise not_ported("MoE (%s)" % cfg.name, "Other LM architectures")
    if cfg.num_codebooks or cfg.frontend is not None:
        raise not_ported("codebook heads and frontends (%s)" % cfg.name,
                         "Other LM architectures")
    if cfg.norm != "rmsnorm":
        raise not_ported("norm %r (%s)" % (cfg.norm, cfg.name),
                         "Other LM architectures")
    check_attention(cfg)


class Block(nn.Module):
    """norm -> attention -> residual -> norm -> MLP -> residual."""

    def __init__(self, nm: torch.Tensor, attn: Attention, nf: torch.Tensor,
                 mlp: MLP):
        super().__init__()
        self.nm = nn.Parameter(nm, requires_grad=False)
        self.attn = attn
        self.nf = nn.Parameter(nf, requires_grad=False)
        self.mlp = mlp

    def forward(self, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None):
        out, new_cache = gqa_forward(self.attn, cfg, rms_norm(h, self.nm),
                                     positions, cache)
        h = h + out
        h = h + self.mlp(rms_norm(h, self.nf))
        return h, new_cache


class LM(nn.Module):
    """Embedding ``[Vp, d]``, the blocks, the final norm and the head (tied
    to the embedding, or ``lm_head [d, Vp]``)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 blocks: List[Block], final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> LM:
    """Random weights with the reference's distributions: normal scaled by
    ``1/sqrt(fan_in)``, the embedding and untied head by 0.02, norms 1,
    biases 0.  ``generator`` must live on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    d, vp = cfg.d_model, cfg.padded_vocab
    embed = normal_param((vp, d), generator, dev, dtype, scale=0.02)
    blocks = [Block(ones_param((d,), dev, dtype),
                    init_attention(cfg, generator, dev, dtype),
                    ones_param((d,), dev, dtype),
                    init_mlp(d, cfg.d_ff, generator, dev, dtype))
              for _ in range(cfg.num_layers)]
    head = (None if cfg.tie_embeddings
            else normal_param((d, vp), generator, dev, dtype, scale=0.02))
    return LM(cfg, embed, blocks, ones_param((d,), dev, dtype), head)


def lm_logits(model: LM, h: torch.Tensor) -> torch.Tensor:
    """``h [B, T, d]`` -> ``[B, T, Vp]``; padded vocab rows are -1e30."""
    cfg = model.cfg
    w = model.embed.T if model.lm_head is None else model.lm_head
    logits = torch.matmul(h, w.to(h.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


def _positions(b: int, t: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(t, device=device))[None].expand(b, t)


def forward_hidden(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Backbone without a cache: embeddings -> blocks -> final norm,
    ``tokens [B, T]`` -> ``[B, T, d]``."""
    h = torch.nn.functional.embedding(tokens, model.embed)
    positions = _positions(h.shape[0], h.shape[1], 0, h.device)
    for blk in model.blocks:
        h, _ = blk(model.cfg, h, positions)
    return rms_norm(h, model.final_norm)


def forward(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward: logits ``[B, T, Vp]``."""
    return lm_logits(model, forward_hidden(model, tokens))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               per_seq: bool = False) -> Dict:
    """Zeros ``[L, batch, Hk, max_len, D]`` for keys and values, length 0.
    One length is shared by the batch (``per_seq`` raises)."""
    check_supported(cfg)
    one = gqa_cache_shape(cfg, batch, max_len, dtype_of(cfg.dtype),
                          resolve_device(device), per_seq)
    n = cfg.num_layers
    return {"k": one["k"][None].repeat(n, 1, 1, 1, 1),
            "v": one["v"][None].repeat(n, 1, 1, 1, 1), "len": 0}


def decode_step(model: LM, tokens: torch.Tensor, cache: Dict,
                last_only: bool = False) -> torch.Tensor:
    """New tokens ``[B, T]`` at positions ``cache["len"] + [0, T)`` ->
    logits ``[B, T, Vp]`` (``[B, Vp]`` of the last position with
    ``last_only``).  Writes the T new key/value rows of every layer into
    ``cache`` and advances ``cache["len"]`` by T, in place."""
    h = torch.nn.functional.embedding(tokens, model.embed)
    start = cache["len"]
    positions = _positions(h.shape[0], h.shape[1], start, h.device)
    for i, blk in enumerate(model.blocks):
        h, _ = blk(model.cfg, h, positions,
                   {"k": cache["k"][i], "v": cache["v"][i], "len": start})
    cache["len"] = start + h.shape[1]
    if last_only:
        h = h[:, -1:]
    logits = lm_logits(model, rms_norm(h, model.final_norm))
    return logits[:, 0] if last_only else logits
