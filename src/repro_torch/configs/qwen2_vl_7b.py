"""Qwen2-VL-7B backbone [arXiv:2409.12191]."""

from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_vl_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        citation="arXiv:2409.12191 (Qwen2-VL)",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18944, vocab_size=152064,
        attention_kind="gqa", rope_kind="mrope", rope_theta=1e6,
        mlp_kind="swiglu",
        vision_embeds=True, num_patches=1024,
    )
