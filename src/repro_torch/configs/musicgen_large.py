"""MusicGen-large [arXiv:2306.05284; hf]: a decoder over EnCodec tokens,
4 codebooks of 2048 ids, their embeddings summed at the input and one
head of 4 x 2048 outputs, MHA 32/32 heads of 64.  The audio frontend is a
stub: callers pass ``[B, T, 4]`` token ids or frame embeddings
(``embeds``).  RoPE takes the place of the original sinusoidal embedding,
as in the reference."""
from .base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        num_codebooks=4,
        frontend="audio",
        supports_long_context=False,
    )
