"""Mixtral 8x22B [arXiv:2401.04088; hf]: 8 experts top-2, SWA."""
from .base import LayerSpec, ModelConfig, MoEConfig, register


@register("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        swa_window=4096,
        rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=16384),
        layer_pattern=(LayerSpec("attn", "moe"),),
        supports_long_context=True,        # SWA -> bounded KV, sub-quadratic
    )
