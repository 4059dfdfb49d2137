"""Jamba v0.1 52B [arXiv:2403.19887; hf]: a hybrid period of 8 layers,
Mamba-1 everywhere but one attention layer (index 4), an MoE FFN (16
experts, top-2) on the odd layers and a dense one on the even."""
from .base import LayerSpec, MambaConfig, ModelConfig, MoEConfig, register

_PERIOD = tuple(
    LayerSpec(mixer="attn" if i == 4 else "mamba",
              ffn="moe" if i % 2 == 1 else "dense")
    for i in range(8))


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe=MoEConfig(num_experts=16, top_k=2, expert_ff=14336),
        mamba=MambaConfig(version=1, d_state=16, d_conv=4, expand=2),
        layer_pattern=_PERIOD,
        supports_long_context=True,         # O(1) Mamba state, sparse attention
    )
