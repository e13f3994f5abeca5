"""xLSTM-125M [arXiv:2405.04517] -- alternating mLSTM / sLSTM blocks.

The blocks carry their own up/down projections (d_ff=0: no separate
FFN), matching the paper's pre-up-projection mLSTM and post-up sLSTM."""

from repro_torch.configs.base import ModelConfig, register


@register
def xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        citation="arXiv:2405.04517 (xLSTM)",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        head_dim=192, d_ff=0, vocab_size=50304,
        rope_kind="none",
        block_pattern=("mlstm", "slstm"),
        mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
    )
