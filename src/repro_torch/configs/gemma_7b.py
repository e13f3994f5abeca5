"""Gemma-7B [arXiv:2403.08295] -- GeGLU, head_dim=256, vocab 256k."""

from repro_torch.configs.base import ModelConfig, register


@register
def gemma_7b() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        citation="arXiv:2403.08295 (Gemma)",
        num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256000,
        mlp_kind="geglu", rope_kind="full",
        emb_scale=True, tie_embeddings=True,
    )
