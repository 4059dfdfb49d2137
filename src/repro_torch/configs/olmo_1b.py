"""OLMo-1B [arXiv:2402.00838; hf]: non-parametric LayerNorm, tied head."""
from .base import ModelConfig, register


@register("olmo-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        norm="layernorm_nonparam",
        rope_theta=10_000.0,
        tie_embeddings=True,
        supports_long_context=False,
    )
