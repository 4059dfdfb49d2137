"""LM assembly for dense GQA stacks and Mamba-2 (SSD) stacks: init,
forward, decode cache, decode step.

The reference scans over stacked layer weights; here the stack is a
Python loop over :class:`Block` modules (the port runs eagerly).  A block
is a mixer (GQA attention, sliding-window or not, or Mamba-2) and, where
the layer pattern has one, a dense FFN, each behind the configuration's
norm (RMSNorm with a weight, or OLMo's non-parametric LayerNorm, which
has none: the block and the model then carry no ``nm``/``nf``/
``final_norm``, as the reference's parameter tree has none).  Weights
keep the reference's layouts (``interop.lm_params_from_arrays`` carries
the reference's parameters in).  MoE, Mamba-1, hybrid patterns, codebook
heads, vision/audio frontends, MLA and M-RoPE raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.

The cache is ``{"k": [L, B, Hk, S, D], "v": [L, B, Hk, S, D], "len"}``
for attention stacks and ``{"conv": [L, B, K-1, C], "ssm": [L, B, H, S,
P], "len"}`` for Mamba-2 stacks; ``len`` is one host int shared by the
batch, or, with ``per_seq`` (the continuous batcher's slot lanes), an
int32 ``[B]`` tensor on the cache's device.  :func:`decode_step` takes
each sequence's positions from its own length, writes the new state into
the cache and advances ``len`` in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from ..configs.base import LayerSpec, ModelConfig, not_ported
from .attention import (
    Attention, check_attention, gqa_cache_shape, gqa_forward, init_attention,
    seq_lengths,
)
from .common import (
    NORMS, apply_norm, dtype_of, normal_param, ones_param, resolve_device,
)
from .mamba import (
    Mamba, check_mamba, init_mamba, mamba2_forward, mamba_cache_shape,
)
from .mlp import MLP, init_mlp

NEG_INF = -1e30
ATTN_LAYER = LayerSpec("attn", "dense")
MAMBA_LAYER = LayerSpec("mamba", None)


def is_mamba(cfg: ModelConfig) -> bool:
    return cfg.layer_pattern == (MAMBA_LAYER,)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's LM does not run yet (a Mamba layer with
    no ``MambaConfig`` is a ``ValueError``)."""
    if any(s.mixer == "mamba" for s in cfg.layer_pattern):
        check_mamba(cfg)
    if cfg.layer_pattern not in ((ATTN_LAYER,), (MAMBA_LAYER,)):
        raise not_ported("layer pattern %s (%s)" % (cfg.layer_pattern,
                                                    cfg.name),
                         "Other LM architectures")
    if cfg.moe is not None:
        raise not_ported("MoE (%s)" % cfg.name, "Other LM architectures")
    if cfg.num_codebooks or cfg.frontend is not None:
        raise not_ported("codebook heads and frontends (%s)" % cfg.name,
                         "Other LM architectures")
    if cfg.norm not in NORMS:
        raise not_ported("norm %r (%s)" % (cfg.norm, cfg.name),
                         "Other LM architectures")
    check_attention(cfg)


def _weight(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """norm -> mixer (attention or Mamba-2) -> residual, then, where the
    layer has an FFN, norm -> MLP -> residual.  The mixer is ``attn`` or
    ``mamba``, as in the reference's parameter tree; the norm weights
    ``nm``, ``nf`` are None for a norm without weights."""

    def __init__(self, nm: Optional[torch.Tensor],
                 mixer: Union[Attention, Mamba],
                 nf: Optional[torch.Tensor] = None, mlp: Optional[MLP] = None):
        super().__init__()
        self.nm = _weight(nm)
        self.kind = "attn" if isinstance(mixer, Attention) else "mamba"
        setattr(self, self.kind, mixer)
        if mlp is not None:
            self.nf = _weight(nf)
        self.mlp = mlp

    def forward(self, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None):
        hn = apply_norm(cfg.norm, h, self.nm)
        if self.kind == "attn":
            out, new_cache = gqa_forward(self.attn, cfg, hn, positions, cache)
        else:
            out, new_cache = mamba2_forward(self.mamba, cfg, hn, cache)
        h = h + out
        if self.mlp is not None:
            h = h + self.mlp(apply_norm(cfg.norm, h, self.nf))
        return h, new_cache


class LM(nn.Module):
    """Embedding ``[Vp, d]``, the blocks, the final norm's weight (None
    for a norm without weights) and the head (tied to the embedding, or
    ``lm_head [d, Vp]``)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 blocks: List[Block], final_norm: Optional[torch.Tensor],
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _weight(final_norm)
        self.lm_head = _weight(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> LM:
    """Random weights with the reference's distributions: normal scaled by
    ``1/sqrt(fan_in)``, the embedding and untied head by 0.02, RMSNorm
    weights 1 (the non-parametric LayerNorm has none), biases 0 (Mamba's
    own in ``mamba.init_mamba``).  ``generator`` must live on
    ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    d, vp = cfg.d_model, cfg.padded_vocab

    def norm():
        return ones_param((d,), dev, dtype) if cfg.norm == "rmsnorm" else None

    embed = normal_param((vp, d), generator, dev, dtype, scale=0.02)
    if is_mamba(cfg):
        blocks = [Block(norm(), init_mamba(cfg, generator, dev, dtype))
                  for _ in range(cfg.num_layers)]
    else:
        blocks = [Block(norm(), init_attention(cfg, generator, dev, dtype),
                        norm(), init_mlp(d, cfg.d_ff, generator, dev, dtype))
                  for _ in range(cfg.num_layers)]
    head = (None if cfg.tie_embeddings
            else normal_param((d, vp), generator, dev, dtype, scale=0.02))
    return LM(cfg, embed, blocks, norm(), head)


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
    return apply_norm(model.cfg.norm, h, model.final_norm)


def forward(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward: logits ``[B, T, Vp]``."""
    return lm_logits(model, forward_hidden(model, tokens))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               per_seq: bool = False) -> Dict:
    """An empty cache, length 0: zeros ``[L, batch, Hk, max_len, D]`` for
    keys and values, or, for Mamba-2 stacks (which ``max_len`` does not
    size), each layer's conv tail and SSM state.  One host length is shared
    by the batch, or, with ``per_seq``, each sequence (slot lane) has its
    own: an int32 ``[batch]`` tensor on ``device`` (Mamba-2 lanes carry one
    too, for uniformity)."""
    check_supported(cfg)
    dev, dtype = resolve_device(device), dtype_of(cfg.dtype)
    n = cfg.num_layers
    length = seq_lengths(batch, dev) if per_seq else 0
    if is_mamba(cfg):
        one = mamba_cache_shape(cfg, batch, dtype, dev)
        return {"conv": one["conv"][None].repeat(n, 1, 1, 1),
                "ssm": one["ssm"][None].repeat(n, 1, 1, 1, 1), "len": length}
    one = gqa_cache_shape(cfg, batch, max_len, dtype, dev)
    return {"k": one["k"][None].repeat(n, 1, 1, 1, 1),
            "v": one["v"][None].repeat(n, 1, 1, 1, 1), "len": length}


def _layer_cache(cache: Dict, i: int) -> Dict:
    """Layer ``i``'s view of the stacked cache."""
    if "ssm" in cache:
        return {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
    return {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}


def decode_step(model: LM, tokens: torch.Tensor, cache: Dict,
                last_only: bool = False) -> torch.Tensor:
    """New tokens ``[B, T]`` at positions ``cache["len"] + [0, T)`` (each
    sequence from its own length with ``per_seq``) -> logits ``[B, T, Vp]``
    (``[B, Vp]`` of the last position with ``last_only``).  Writes the T
    new key/value rows (or the new conv tail and SSM state) of every layer
    into ``cache`` and advances ``cache["len"]`` by T, in place; a
    one-token step reads no per-sequence length back to the host."""
    h = torch.nn.functional.embedding(tokens, model.embed)
    b, t = h.shape[:2]
    start = cache["len"]
    if torch.is_tensor(start):
        positions = start[:, None].long() + torch.arange(t, device=h.device)
    else:
        positions = _positions(b, t, start, h.device)
    for i, blk in enumerate(model.blocks):
        h, _ = blk(model.cfg, h, positions, _layer_cache(cache, i))
    cache["len"] = start + t
    if last_only:
        h = h[:, -1:]
    logits = lm_logits(model,
                       apply_norm(model.cfg.norm, h, model.final_norm))
    return logits[:, 0] if last_only else logits
