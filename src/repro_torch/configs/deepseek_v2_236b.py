"""DeepSeek-V2 (236B) [arXiv:2405.04434] -- MLA + 2 shared / 160 routed
experts top-6.  Optimizer m/v kept in bf16 (DESIGN.md): fp32 Adam states
for 236B do not fit a single 256-chip v5e pod."""

from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        citation="arXiv:2405.04434 (DeepSeek-V2)",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        head_dim=128, d_ff=12288, vocab_size=102400,
        attention_kind="mla", rope_kind="full",
        mla_kv_lora=512, mla_q_lora=1536, mla_rope_dim=64, mla_v_dim=128,
        mlp_kind="moe", moe_num_experts=160, moe_top_k=6,
        moe_num_shared=2, moe_d_ff=1536, first_dense_layers=1,
        optimizer_state_dtype="bfloat16",
    )
