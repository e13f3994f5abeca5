"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] -- MLA (no q-lora),
2 shared / 64 routed experts top-6."""

from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_v2_lite_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        citation="arXiv:2405.04434 (DeepSeek-V2)",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400,
        attention_kind="mla", rope_kind="full",
        mla_kv_lora=512, mla_q_lora=0, mla_rope_dim=64, mla_v_dim=128,
        mlp_kind="moe", moe_num_experts=64, moe_top_k=6,
        moe_num_shared=2, moe_d_ff=1408, first_dense_layers=1,
    )
