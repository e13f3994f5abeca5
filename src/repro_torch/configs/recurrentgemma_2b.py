"""RecurrentGemma-2B [arXiv:2402.19427] (Griffin) -- RG-LRU + local
attention, pattern (recurrent, recurrent, local-attn), MQA kv=1."""

from repro_torch.configs.base import ModelConfig, register


@register
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        citation="arXiv:2402.19427 (Griffin / RecurrentGemma)",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        mlp_kind="geglu", rope_kind="full",
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048, rglru_width=2560,
        emb_scale=True, tie_embeddings=True,
    )
