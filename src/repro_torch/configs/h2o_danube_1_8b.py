"""H2O-Danube-1.8B [arXiv:2401.16818] -- llama/mistral mix with
sliding-window attention (the mistral-style 4096 window)."""

from repro_torch.configs.base import ModelConfig, register


@register
def h2o_danube_1_8b() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        citation="arXiv:2401.16818 (H2O-Danube)",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=80, d_ff=6912, vocab_size=32000,
        mlp_kind="swiglu", rope_kind="full", window=4096,
    )
