"""Model configuration schema and the architecture registry.

One :class:`ModelConfig` describes a decoder LM: dense / MoE / SSM /
hybrid stacks with GQA/MLA/SWA attention, M-RoPE, multi-codebook heads.
The schema is the whole of the reference's, so a configuration compares
field for field; the port runs every architecture the reference
registers (``models/``): any layer pattern of GQA or MLA attention and
Mamba-1 or Mamba-2 mixers whose layers carry a dense FFN, an MoE FFN or
none, sliding windows, the non-parametric LayerNorm, M-RoPE on GQA, and
codebook heads with the vision and audio frontend stubs.  What no
configuration uses (another mixer or norm) raises ``NotImplementedError``
where it is used.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        "%s is not in the PyTorch port yet (ROADMAP.md queue 1: %s)"
        % (what, item))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                   # intermediate size per routed expert
    num_shared: int = 0              # always-on shared experts (DeepSeek-V2)
    shared_ff: int = 0               # intermediate size of the shared block
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    kv_lora_rank: int                # compressed KV latent width (cache object)
    q_lora_rank: int = 0             # 0 = full-rank queries
    rope_head_dim: int = 64          # decoupled RoPE sub-dim (shared key)
    nope_head_dim: int = 128         # non-rotary sub-dim per head
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    version: int = 2                 # 1 = selective scan, 2 = SSD
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                       # "attn" | "mamba"
    ffn: Optional[str]               # "dense" | "moe" | None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    swa_window: Optional[int] = None # sliding-window attention size
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm_nonparam
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl M-RoPE
    num_codebooks: int = 0           # audio codebooks (0 = text LM)
    frontend: Optional[str] = None   # "vision" | "audio" stub frontends
    dtype: str = "bfloat16"
    supports_long_context: bool = False
    mla_absorbed: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; the head masks the padding."""
        return -(-self.vocab_size // 256) * 256

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        if self.num_layers % self.period:
            raise ValueError("num_layers %d must divide the layer pattern "
                             "period %d" % (self.num_layers, self.period))
        return self.num_layers // self.period

    def param_counts(self) -> Dict[str, float]:
        """Returns {'total': N, 'active': N_active} (active = per-token)."""
        d = self.d_model
        hd = self.resolved_head_dim
        total = 0.0
        active = 0.0

        def add(n, always_active=True):
            nonlocal total, active
            total += n
            if always_active:
                active += n

        add(self.vocab_size * d)                     # embed
        if not self.tie_embeddings:
            add(self.vocab_size * d)                 # lm head
        if self.num_codebooks:
            add((self.num_codebooks - 1) * self.vocab_size * d)

        for spec in self.layer_pattern:
            reps = self.num_periods
            if spec.mixer == "attn":
                if self.mla is not None:
                    m = self.mla
                    qdim = self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                    if m.q_lora_rank:
                        attn_p = d * m.q_lora_rank + m.q_lora_rank * qdim
                    else:
                        attn_p = d * qdim
                    attn_p += d * m.kv_lora_rank + d * m.rope_head_dim
                    attn_p += m.kv_lora_rank * self.num_heads * (
                        m.nope_head_dim + m.v_head_dim)
                    attn_p += self.num_heads * m.v_head_dim * d
                else:
                    attn_p = d * (self.num_heads * hd) \
                        + 2 * d * (self.num_kv_heads * hd) \
                        + (self.num_heads * hd) * d
                add(attn_p * reps)
            else:   # Mamba-1 layers too: the reference's Mamba-2 formula
                mc = self.mamba or MambaConfig()
                di = mc.d_inner(d)
                nh = mc.nheads(d)
                m_p = d * (2 * di + 2 * mc.ngroups * mc.d_state + nh)  # in_proj
                m_p += mc.d_conv * (di + 2 * mc.ngroups * mc.d_state)  # conv
                m_p += nh * 2 + di                                     # A, D, dt
                m_p += di * d                                          # out_proj
                add(m_p * reps)
            if spec.ffn == "dense":
                add(3 * d * self.d_ff * reps)
            elif spec.ffn == "moe":
                mo = self.moe
                routed = 3 * d * mo.expert_ff
                add(routed * mo.num_experts * reps, always_active=False)
                active += routed * mo.top_k * reps
                add(d * mo.num_experts * reps)       # router
                if mo.num_shared:
                    add(3 * d * (mo.shared_ff or mo.expert_ff)
                        * mo.num_shared * reps)
        return {"total": total, "active": active}


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _register_all() -> None:
    from . import (  # noqa: F401  (register themselves)
        deepseek_v2_236b, h2o_danube_1_8b, jamba_v0_1_52b, mamba2_130m,
        minicpm3_4b, mixtral_8x22b, musicgen_large, olmo_1b, qwen2_1_5b,
        qwen2_vl_7b)


def get_config(name: str) -> ModelConfig:
    _register_all()

    if name not in _REGISTRY:
        raise KeyError("unknown arch %r; known: %s" % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]()


def registered() -> Tuple[str, ...]:
    _register_all()

    return tuple(sorted(_REGISTRY))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's sizes)."""
    changes: Dict = dict(
        num_layers=cfg.period * 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        dtype="float32",
    )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, expert_ff=64,
            num_shared=min(cfg.moe.num_shared, 1), shared_ff=64)
    if cfg.mla:
        changes["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=(32 if cfg.mla.q_lora_rank else 0),
            rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    if cfg.mamba:
        changes["mamba"] = dataclasses.replace(
            cfg.mamba, d_state=16, headdim=16, ngroups=1)
    if cfg.swa_window:
        changes["swa_window"] = 16
    if cfg.mrope_sections:
        changes["mrope_sections"] = (2, 3, 3)   # sums to half of head_dim=16
    return dataclasses.replace(cfg, **changes)
