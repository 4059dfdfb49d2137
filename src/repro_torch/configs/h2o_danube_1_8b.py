"""H2O-Danube 1.8B [arXiv:2401.16818; hf]: llama+mistral mix, SWA, head
dim 80."""
from .base import ModelConfig, register


@register("h2o-danube-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        swa_window=4096,
        rope_theta=10_000.0,
        supports_long_context=True,        # SWA
    )
