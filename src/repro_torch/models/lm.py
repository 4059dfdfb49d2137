"""LM assembly for any layer pattern of attention (GQA or MLA) and Mamba
(Mamba-1 or Mamba-2) mixers, each layer's FFN dense, MoE or none: init,
forward, decode cache, decode step.

The reference scans over stacked layer weights, one period of the layer
pattern at a time; here the stack is a Python loop over :class:`Block`
modules (the port runs eagerly), layer ``j`` built from
``layer_pattern[j % period]``.  A block is a mixer (GQA attention,
sliding-window or not, MLA, Mamba-1 or Mamba-2) and, where the layer
pattern has one, an FFN (a dense MLP or an MoE, ``models/moe.py``), each
behind the configuration's norm (RMSNorm with a weight, or OLMo's
non-parametric LayerNorm, which has none: the block and the model then
carry no ``nm``/``nf``/``final_norm``, as the reference's parameter tree
has none).  Weights keep the reference's layouts
(``interop.lm_params_from_arrays`` carries the reference's parameters
in).

Inputs are token ids ``[B, T]``, or ``[B, T, K]`` for a model of K
codebooks (MusicGen), whose embedding is ``[K, Vp, d]`` (the K lookups
summed) and whose head ``[d, K * Vp]`` gives logits ``[B, T, K, Vp]``; or
the frontend stub's ``embeds [B, T, d]`` (vision or audio features), which
take the place of the lookup.  Positions are ``[B, T]``, or ``[3, B, T]``
(temporal, height, width) with M-RoPE (Qwen2-VL); without given positions
every stream counts the sequence's positions.

:func:`forward` runs the MoE layers in capacity mode unless asked for
``dropless``, as the reference's ``forward`` does; :func:`decode_step` (the
serving path: prefills and ticks) is always dropless, so a sequence's
logits do not depend on which others share its batch.

Training: :func:`loss_fn` is the reference's (float32 cross entropy plus
the MoE aux loss) over :func:`forward_hidden`, which takes ``impl``
(``"xla"``: plain differentiable torch ops; ``"pallas"``, the default of
:func:`forward`: the kernels, which refuse a graph; ``models/common.py``)
and ``remat`` (``"none"``, ``"dots"`` or ``"full"``, each layer under
``torch.utils.checkpoint``).  Parameters are built without gradients;
the trainer (``train/train_loop.py``) turns them on while it takes
gradients.  :func:`decode_step` records no graph whatever the parameters
ask for, so the caches it writes in place never join one.

The cache holds one stack a mixer kind, over the layers of that kind in
layer order (:func:`cache_slots` maps a layer to its kind and its index
there): ``{"k": [La, B, Hk, S, D], "v": [La, B, Hk, S, D]}`` for GQA
layers or ``{"ckv": [La, B, S, r], "krope": [La, B, S, dr]}`` (the latent,
the reference's layout) for MLA layers, ``{"conv": [Lm, B, K-1, C],
"ssm": [Lm, B, ...]}`` for Mamba layers, and ``"len"``, which only the
attention layers read: one host int shared by the batch, or, with
``per_seq`` (the continuous batcher's slot lanes), an int32 ``[B]`` tensor
on the cache's device.  A pure stack's tensors are over all L layers.
:func:`decode_step` takes each sequence's positions from its own length,
writes the new state into the cache and advances ``len`` in place.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import LayerSpec, ModelConfig, not_ported
from .attention import (
    MLA, Attention, attn_cache_shape, attn_forward, check_attention,
    init_attention, seq_lengths,
)
from .common import (
    NORMS, apply_norm, check_impl, dtype_of, normal_param, ones_param,
    resolve_device,
)
from .mamba import (
    Mamba, check_mamba, init_mamba, mamba_cache_shape, mamba_forward,
)
from .mlp import MLP, init_mlp
from .moe import MoE, init_moe, moe_forward

NEG_INF = -1e30
MIXERS = ("attn", "mamba")
FFNS = ("dense", "moe", None)
MAMBA_CACHE = ("conv", "ssm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's LM does not run: a mixer other than
    ``attn`` or ``mamba``, or an FFN other than dense, MoE or none, and
    what ``check_attention`` refuses.  A Mamba layer with no
    ``MambaConfig``, an MoE layer with no ``MoEConfig``, a depth the
    pattern does not divide or codebook heads tied to the embedding is a
    ``ValueError``."""
    pattern = cfg.layer_pattern
    if any(s.mixer == "mamba" for s in pattern):
        check_mamba(cfg)
    if not all(s.mixer in MIXERS and s.ffn in FFNS for s in pattern):
        raise not_ported("layer pattern %s (%s)" % (pattern, cfg.name),
                         "Other LM architectures")
    if any(s.ffn == "moe" for s in pattern) and cfg.moe is None:
        raise ValueError("%s has an MoE layer but no MoEConfig" % cfg.name)
    if cfg.num_layers % cfg.period:
        raise ValueError("%s: %d layers are not whole periods of %d"
                         % (cfg.name, cfg.num_layers, cfg.period))
    if cfg.num_codebooks and cfg.tie_embeddings:
        raise ValueError("%s: codebook heads are not tied to the "
                         "embedding" % cfg.name)
    if cfg.norm not in NORMS:
        raise not_ported("norm %r (%s)" % (cfg.norm, cfg.name),
                         "Other LM architectures")
    check_attention(cfg)


def cache_slots(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Layer ``j``'s ``(mixer kind, index in that kind's cache stack)``:
    the kind's layers in layer order."""
    seen = {kind: 0 for kind in MIXERS}
    slots = []
    for j in range(cfg.num_layers):
        kind = cfg.layer_pattern[j % cfg.period].mixer
        slots.append((kind, seen[kind]))
        seen[kind] += 1
    return slots


def _weight(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """norm -> mixer (attention or Mamba) -> residual, then, where the
    layer has an FFN, norm -> FFN (a dense MLP or an MoE) -> residual.
    The mixer is ``attn`` or ``mamba`` and the FFN ``mlp`` or ``moe``
    (the other None), as in the reference's parameter tree; the norm
    weights ``nm``, ``nf`` are None for a norm without weights."""

    def __init__(self, nm: Optional[torch.Tensor],
                 mixer: Union[Attention, MLA, Mamba],
                 nf: Optional[torch.Tensor] = None,
                 ffn: Optional[Union[MLP, MoE]] = None):
        super().__init__()
        self.nm = _weight(nm)
        self.kind = "mamba" if isinstance(mixer, Mamba) else "attn"
        setattr(self, self.kind, mixer)
        if ffn is not None:
            self.nf = _weight(nf)
        self.mlp = ffn if isinstance(ffn, MLP) else None
        self.moe = ffn if isinstance(ffn, MoE) else None

    def forward(self, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                dropless: bool = False, moe_groups: int = 1,
                impl: str = "pallas"):
        """``(h, cache, aux)``: aux is the MoE's load-balancing loss, or
        None for a layer without one."""
        hn = apply_norm(cfg.norm, h, self.nm)
        if self.kind == "attn":
            out, new_cache = attn_forward(self.attn, cfg, hn, positions,
                                          cache, impl)
        else:
            out, new_cache = mamba_forward(self.mamba, cfg, hn, cache, impl)
        h = h + out
        aux = None
        if self.mlp is not None:
            h = h + self.mlp(apply_norm(cfg.norm, h, self.nf))
        elif self.moe is not None:
            y, aux = moe_forward(self.moe, cfg.moe,
                                 apply_norm(cfg.norm, h, self.nf),
                                 dropless=dropless,
                                 dispatch_groups=moe_groups)
            h = h + y
        return h, new_cache, aux


class LM(nn.Module):
    """Embedding ``[Vp, d]`` (``[K, Vp, d]`` for K codebooks), the blocks,
    the final norm's weight (None for a norm without weights) and the head
    (tied to the embedding, or ``lm_head [d, Vp]``, ``[d, K * Vp]`` for K
    codebooks)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 blocks: List[Block], final_norm: Optional[torch.Tensor],
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.cache_slots = cache_slots(cfg)
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
    own in ``mamba.init_mamba``), an MoE router in float32 whatever the
    model's dtype.  Layer ``j`` is ``layer_pattern[j % period]``.
    ``generator`` must live on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    d, vp = cfg.d_model, cfg.padded_vocab
    books = (cfg.num_codebooks,) if cfg.num_codebooks else ()

    def norm():
        return ones_param((d,), dev, dtype) if cfg.norm == "rmsnorm" else None

    def layer(spec: LayerSpec) -> Block:
        mixer = (init_attention(cfg, generator, dev, dtype)
                 if spec.mixer == "attn"
                 else init_mamba(cfg, generator, dev, dtype))
        if spec.ffn is None:
            return Block(norm(), mixer)
        ffn = (init_mlp(d, cfg.d_ff, generator, dev, dtype)
               if spec.ffn == "dense"
               else init_moe(d, cfg.moe, generator, dev, dtype))
        return Block(norm(), mixer, norm(), ffn)

    embed = normal_param(books + (vp, d), generator, dev, dtype, scale=0.02)
    blocks = [layer(cfg.layer_pattern[j % cfg.period])
              for j in range(cfg.num_layers)]
    head = (None if cfg.tie_embeddings
            else normal_param((d, vp * max(1, cfg.num_codebooks)), generator,
                              dev, dtype, scale=0.02))
    return LM(cfg, embed, blocks, norm(), head)


def embed_tokens(model: LM, tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, T, d]`` in the model's dtype: the frontend stub's ``embeds``
    where given, else the lookup of ``tokens [B, T]``, or for K codebooks
    the sum of the K lookups of ``tokens [B, T, K]``, codebook 0 first."""
    if embeds is not None:
        return embeds.to(device=model.device, dtype=dtype_of(model.cfg.dtype))
    emb = torch.nn.functional.embedding
    if not model.cfg.num_codebooks:
        return emb(tokens, model.embed)
    h = emb(tokens[..., 0], model.embed[0])
    for k in range(1, model.cfg.num_codebooks):
        h = h + emb(tokens[..., k], model.embed[k])
    return h


def lm_logits(model: LM, h: torch.Tensor) -> torch.Tensor:
    """``h [B, T, d]`` -> ``[B, T, Vp]`` (``[B, T, K, Vp]`` for K
    codebooks); padded vocab rows are -1e30 (in every codebook)."""
    cfg = model.cfg
    w = model.embed.T if model.lm_head is None else model.lm_head
    logits = torch.matmul(h, w.to(h.dtype))
    if cfg.num_codebooks:
        logits = logits.reshape(*logits.shape[:-1], cfg.num_codebooks,
                                cfg.padded_vocab)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


def _positions(cfg: ModelConfig, b: int, t: int,
               start: Union[int, torch.Tensor], device) -> torch.Tensor:
    """Positions ``start + [0, t)`` of each sequence, ``start`` a host int
    or an int32 ``[B]`` tensor (read on the device, not on the host):
    ``[B, t]``, or three equal streams ``[3, B, t]`` with M-RoPE."""
    steps = torch.arange(t, device=device)
    pos = (start[:, None].long() + steps if torch.is_tensor(start)
           else (start + steps)[None].expand(b, t))
    return pos if cfg.mrope_sections is None else pos[None].expand(3, b, t)


REMATS = ("none", "dots", "full")
# the matmuls whose outputs ``remat="dots"`` keeps: the products without a
# batch axis (``torch.matmul`` of [B, T, d] by a weight folds to ``mm``),
# the counterpart of the reference's ``dots_with_no_batch_dims_saveable``
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _run_layer(blk: Block, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, dropless: bool, moe_groups: int,
               impl: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h, _, aux = blk(cfg, h, positions, dropless=dropless,
                    moe_groups=moe_groups, impl=impl)
    return h, aux


def forward_hidden(model: LM, tokens: Optional[torch.Tensor],
                   dropless: bool = False, moe_groups: int = 1,
                   embeds: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   impl: str = "pallas", remat: str = "none",
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone without a cache: embeddings -> blocks -> final norm,
    ``tokens`` (or ``embeds``, see :func:`embed_tokens`) -> ``(h [B, T,
    d], aux)``, aux the float32 sum of the MoE layers' load-balancing
    losses (0 without MoE).  ``positions`` (``[B, T]``, ``[3, B, T]`` with
    M-RoPE) default to ``[0, T)`` in every stream.  MoE layers run in
    capacity mode unless ``dropless``, dispatched in ``moe_groups``
    groups.  ``impl`` picks the attention and SSD path; ``remat`` what
    backward recomputes: ``"full"`` each layer whole, ``"dots"`` all but
    the outputs of its matmuls without a batch axis (``DOTS``),
    ``"none"`` nothing."""
    check_impl(impl)
    if remat not in REMATS:
        raise ValueError("remat is one of %s, not %r" % (REMATS, remat))
    h = embed_tokens(model, tokens, embeds)
    positions = (_positions(model.cfg, h.shape[0], h.shape[1], 0, h.device)
                 if positions is None else positions.to(h.device))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in model.blocks:
        args = (blk, model.cfg, h, positions, dropless, moe_groups, impl)
        if remat == "none":
            h, a = _run_layer(*args)
        elif remat == "full":
            h, a = ckpt.checkpoint(_run_layer, *args, use_reentrant=False)
        else:
            h, a = ckpt.checkpoint(
                _run_layer, *args, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _save_dots))
        if a is not None:
            aux = aux + a
    return apply_norm(model.cfg.norm, h, model.final_norm), aux


def forward(model: LM, tokens: Optional[torch.Tensor],
            dropless: bool = False, moe_groups: int = 1,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            impl: str = "pallas", remat: str = "none") -> torch.Tensor:
    """Full-sequence causal forward: logits ``[B, T, Vp]`` (``[B, T, K,
    Vp]`` for K codebooks); inputs, positions, MoE layers, ``impl`` and
    ``remat`` as in :func:`forward_hidden`."""
    return lm_logits(model, forward_hidden(model, tokens, dropless,
                                           moe_groups, embeds, positions,
                                           impl, remat)[0])


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], impl: str = "xla",
            remat: str = "none", moe_groups: int = 1,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn``: ``batch`` holds ``tokens`` (``[B, T]``,
    ``[B, T, K]`` for K codebooks) or the frontend stub's ``embeds``, an
    optional ``positions``, and ``labels`` (``[B, T]``, ``[B, T, K]``).
    The logits in float32, log-softmax over the padded vocabulary, the
    mean negative log-likelihood of the labels (for codebooks over every
    ``(b, t, k)``: the reference's one-hot sum, whose other terms are
    zeros, is this gather), plus the MoE layers' aux loss (capacity mode,
    as the reference trains) -> ``(total, {"ce", "aux"})``."""
    h, aux = forward_hidden(model, batch.get("tokens"), False, moe_groups,
                            batch.get("embeds"), batch.get("positions"),
                            impl, remat)
    logp = F.log_softmax(lm_logits(model, h).float(), dim=-1)
    labels = batch["labels"].to(device=logp.device, dtype=torch.long)
    ce = -logp.gather(-1, labels[..., None])[..., 0].mean()
    return ce + aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               per_seq: bool = False) -> Dict:
    """An empty cache, length 0: for the attention layers zeros ``[La,
    batch, Hk, max_len, D]`` for keys and values, or ``[La, batch,
    max_len, r]`` and ``[La, batch, max_len, dr]`` for MLA's latent and
    rotary key; for the Mamba layers (which ``max_len`` does not size) each
    one's conv tail and SSM state, ``[Lm, batch, ...]``.  One host length
    is shared by the batch, or, with ``per_seq``, each sequence (slot
    lane) has its own: an int32 ``[batch]`` tensor on ``device`` (a Mamba
    stack's lanes carry one too, for uniformity)."""
    check_supported(cfg)
    dev, dtype = resolve_device(device), dtype_of(cfg.dtype)
    kinds = [kind for kind, _ in cache_slots(cfg)]
    one = {}
    if "attn" in kinds:
        one["attn"] = attn_cache_shape(cfg, batch, max_len, dtype, dev)
    if "mamba" in kinds:
        one["mamba"] = mamba_cache_shape(cfg, batch, dtype, dev)
    out = {name: torch.zeros((kinds.count(kind),) + t.shape, dtype=t.dtype,
                             device=dev)
           for kind, layer in one.items()
           for name, t in layer.items() if name != "len"}
    out["len"] = seq_lengths(batch, dev) if per_seq else 0
    return out


def _layer_cache(cache: Dict, kind: str, i: int) -> Dict:
    """The view of the stacked cache of the ``i``-th layer of mixer
    ``kind``: an attention view carries ``len``."""
    if kind == "mamba":
        return {name: cache[name][i] for name in MAMBA_CACHE}
    view = {name: t[i] for name, t in cache.items()
            if name != "len" and name not in MAMBA_CACHE}
    view["len"] = cache["len"]
    return view


@torch.no_grad()
def decode_step(model: LM, tokens: Optional[torch.Tensor], cache: Dict,
                last_only: bool = False,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New tokens ``[B, T]`` (``[B, T, K]`` for K codebooks; or the
    frontend stub's ``embeds [B, T, d]``) at positions ``cache["len"] +
    [0, T)`` (each sequence from its own length with ``per_seq``; every
    stream alike with M-RoPE, as the reference's ``decode_step``) ->
    logits ``[B, T, Vp]`` (``[B, T, K, Vp]``; ``[B, Vp]`` or ``[B, K,
    Vp]`` of the last position with ``last_only``).  Writes the T new
    key/value rows (or the new conv tail and SSM state) of every layer
    into ``cache`` and advances ``cache["len"]`` by T, in place; a
    one-token step of at most ``moe.TRIM_MIN_CAP`` sequences reads nothing
    back to the host.  MoE layers run dropless."""
    h = embed_tokens(model, tokens, embeds)
    b, t = h.shape[:2]
    start = cache["len"]
    positions = _positions(model.cfg, b, t, start, h.device)
    for blk, (kind, i) in zip(model.blocks, model.cache_slots):
        h, _, _ = blk(model.cfg, h, positions, _layer_cache(cache, kind, i),
                      dropless=True)
    cache["len"] = start + t
    if last_only:
        h = h[:, -1:]
    logits = lm_logits(model,
                       apply_norm(model.cfg.norm, h, model.final_norm))
    return logits[:, 0] if last_only else logits
