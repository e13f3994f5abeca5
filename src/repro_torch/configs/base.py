"""ModelConfig: one declarative description per architecture.

Every assigned architecture registers itself via :func:`register`; the
launcher resolves ``--arch <id>`` with :func:`get_config`.  Each config
cites its source in ``citation``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ModelConfig"]] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    attention_kind: str = "gqa"    # gqa | mla
    rope_kind: str = "full"        # full | partial | mrope | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # fraction of head_dim rotated
    window: int = 0                # sliding-window size (0 = full attn)
    logits_softcap: float = 0.0
    qk_norm: bool = False
    # --- MLA (deepseek-v2) ---
    mla_kv_lora: int = 0
    mla_q_lora: int = 0
    mla_rope_dim: int = 0
    mla_v_dim: int = 0
    # --- mlp ---
    mlp_kind: str = "swiglu"       # swiglu | geglu | moe
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0              # per-(routed)-expert hidden
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0    # deepseek-v2: layer 0 is dense FFN
    # --- block pattern (period repeated over layers) ---
    block_pattern: tuple[str, ...] = ("attn",)
    local_window: int = 2048       # window for "local_attn" blocks
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_frames: int = 0
    # --- vlm ---
    vision_embeds: bool = False
    num_patches: int = 1024
    # --- ssm / hybrid ---
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    rglru_width: int = 0           # recurrence width (0 -> d_model)
    conv1d_width: int = 4
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    emb_scale: bool = False        # gemma: embeddings * sqrt(d_model)
    max_seq_len: int = 1 << 20
    # layer-stack lowering: scan (compact HLO; XLA cost_analysis counts
    # the body ONCE) vs unrolled (accurate per-step costs for roofline)
    scan_layers: bool = True
    # --- sharding knobs (EXPERIMENTS.md section Perf) ---
    # fsdp_params=False -> ZeRO-2: compute weights replicated over the
    # FSDP axes, optimizer states stay sharded (one gather per step)
    fsdp_params: bool = True
    # embed_fsdp=False -> embedding/lm_head sharded over vocab only
    embed_fsdp: bool = True
    # shard_acts=False -> keep the residual stream replicated across
    # 'model' at layer boundaries (skip the act_embed constraint).
    # Right when L x B_loc x S x D x 2B of scan checkpoints fits HBM;
    # saves the per-layer x all-gather/reduce-scatter round trips.
    shard_acts: bool = True
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer_state_dtype: str = "float32"   # bf16 for the huge configs

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (clean 16-way sharding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def supports_long_context(self) -> bool:
        """True iff serve cost per token is sub-linear in history
        (recurrent state or bounded sliding window)."""
        kinds = set(self.block_pattern)
        recurrent = kinds & {"mlstm", "slstm", "rglru"}
        attn_kinds = kinds & {"attn", "local_attn"}
        if "attn" in attn_kinds and self.window == 0:
            return False
        return bool(recurrent) or self.window > 0 or \
            attn_kinds <= {"local_attn"}

    def decode_supported(self) -> bool:
        return True   # all assigned archs are decoders (whisper: dec side)

    def reduced(self, *, layers: int = 2, d_model: int | None = None,
                vocab: int = 512, experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        period = self.pattern_period
        nl = max(layers, period)
        nl = -(-nl // period) * period
        dm = min(self.d_model, d_model or 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        hd = max(8, dm // heads)
        changes = dict(
            num_layers=nl, d_model=dm, num_heads=heads, num_kv_heads=kv,
            head_dim=hd, d_ff=max(8, dm * 2), vocab_size=vocab,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_frames=min(self.enc_frames, 64) if self.enc_frames else 0,
            num_patches=min(self.num_patches, 16),
            moe_num_experts=min(self.moe_num_experts, experts)
            if self.moe_num_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_num_shared=min(self.moe_num_shared, 1)
            if self.moe_num_shared else 0,
            moe_d_ff=min(self.moe_d_ff, dm) if self.moe_d_ff else 0,
            mla_kv_lora=min(self.mla_kv_lora, 32) if self.mla_kv_lora else 0,
            mla_q_lora=min(self.mla_q_lora, 32) if self.mla_q_lora else 0,
            mla_rope_dim=min(self.mla_rope_dim, hd // 2)
            if self.mla_rope_dim else 0,
            mla_v_dim=hd if self.mla_v_dim else 0,
            rglru_width=min(self.rglru_width, dm) if self.rglru_width else 0,
            window=min(self.window, 64) if self.window else 0,
            local_window=min(self.local_window, 32),
            first_dense_layers=min(self.first_dense_layers, 1),
            param_dtype="float32", compute_dtype="float32",
            max_seq_len=4096,
        )
        return dataclasses.replace(self, **changes)


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import every per-arch module once so registrations run
    from repro_torch.configs import (  # noqa: F401
        chatglm3_6b, deepseek_67b, deepseek_v2_236b, deepseek_v2_lite_16b,
        gemma_7b, h2o_danube_1_8b, qwen2_vl_7b, recurrentgemma_2b,
        variants, whisper_medium, xlstm_125m)
