"""ChatGLM3-6B [arXiv:2406.12793] -- GQA kv=2, 2d (half-dim) RoPE."""

from repro_torch.configs.base import ModelConfig, register


@register
def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        citation="arXiv:2406.12793 (ChatGLM)",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        head_dim=128, d_ff=13696, vocab_size=65024,
        attention_kind="gqa", rope_kind="partial", rope_fraction=0.5,
        mlp_kind="swiglu",
    )
