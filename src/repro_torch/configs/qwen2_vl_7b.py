"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf]: GQA 28/4 heads of 128,
QKV bias, M-RoPE sections (16, 24, 24) over half the head dim.  The vision
frontend is a stub: callers pass patch embeddings (``embeds``) and the
``[3, B, T]`` (temporal, height, width) position ids."""
from .base import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        frontend="vision",
        supports_long_context=False,
    )
