"""Whisper-medium [arXiv:2212.04356] -- encoder-decoder.  The
mel-spectrogram + conv frontend is a STUB per the brief: input_specs
provides 1500 precomputed frame embeddings of width d_model."""

from repro_torch.configs.base import ModelConfig, register


@register
def whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        citation="arXiv:2212.04356 (Whisper)",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=51865,
        rope_kind="none",                 # sinusoidal positions
        is_encoder_decoder=True, enc_layers=24, enc_frames=1500,
    )
