"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

MLA (kv_lora_rank=512, q_lora_rank=1536, decoupled rope dim 64) + MoE with
2 shared + 160 routed experts, top-6, expert d_ff=1536.  Every layer takes
the MoE pattern, as the reference's configuration has it (the HF model's
first layer is dense).
"""
from .base import LayerSpec, MLAConfig, ModelConfig, MoEConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,                      # nope 128 + rope 64
        d_ff=1536,
        vocab_size=102400,
        rope_theta=10_000.0,
        moe=MoEConfig(num_experts=160, top_k=6, expert_ff=1536,
                      num_shared=2, shared_ff=1536),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
        layer_pattern=(LayerSpec("attn", "moe"),),
        supports_long_context=False,       # full attention
    )
