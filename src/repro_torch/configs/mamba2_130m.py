"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD stack."""
from .base import LayerSpec, MambaConfig, ModelConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=1,                        # unused (attention-free)
        num_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        mamba=MambaConfig(version=2, d_state=128, d_conv=4, expand=2,
                          headdim=64, ngroups=1),
        layer_pattern=(LayerSpec("mamba", None),),
        supports_long_context=True,         # O(1) decode state
    )
