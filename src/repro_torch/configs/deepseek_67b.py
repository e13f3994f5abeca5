"""DeepSeek-67B [arXiv:2401.02954] -- llama-arch, 95 layers, GQA kv=8."""

from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_67b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        citation="arXiv:2401.02954 (DeepSeek LLM)",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=102400,
        mlp_kind="swiglu", rope_kind="full",
        optimizer_state_dtype="bfloat16",
    )
