"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense with MLA."""
from .base import MLAConfig, ModelConfig, register


@register("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=96,                       # nope 64 + rope 32
        d_ff=6400,
        vocab_size=73448,
        rope_theta=10_000.0,
        mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                      rope_head_dim=32, nope_head_dim=64, v_head_dim=64),
        supports_long_context=False,
    )
