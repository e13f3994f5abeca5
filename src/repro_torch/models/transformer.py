"""Model assembly for the dense decoder-only families: the counterpart of
``repro.models.transformer``.

The JAX package scans a stacked period of blocks; here the stack is an
``nn.ModuleList`` of per-layer ``Block``s in the same order (head, the
periods, tail), so each layer has its counterpart and
``repro_torch.convert.lm_params_from_jax`` unstacks the period axis into
it.  What the port cannot run yet (MLA, MoE, the recurrent blocks, the
encoder-decoder, vision inputs, M-RoPE and unrotated attention) is
refused when a model is built, never run as something that differs from
the JAX model.

Decode (one token a row against a cache) runs on a row-padded batch:
``decode_rows(B)`` rows, the rows after B zero-token padding.  With a
batch of up to ``DECODE_ROW_TILE`` rows every product, norm and softmax
then has the same shape for one row alone and for S lanes, so each lane
of ``serve.engine.decode_chunk_slots`` computes the bits of a solo
``generate``; attention's cache products run row by row
(``attention.decode_attention``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (GLUMLP, Embedding, RMSNorm,
                                      rope_tables)

DECODE_ROW_TILE = 8

_ROADMAP = "ROADMAP.md queue 1 item 6"


def decode_rows(batch: int) -> int:
    """Rows a decode step computes for ``batch`` rows: a multiple of
    ``DECODE_ROW_TILE``."""
    return -(-batch // DECODE_ROW_TILE) * DECODE_ROW_TILE


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a config the port cannot run yet."""
    why = []
    if cfg.attention_kind != "gqa":
        why.append(f"attention_kind={cfg.attention_kind!r}")
    if cfg.mlp_kind not in ("swiglu", "geglu"):
        why.append(f"mlp_kind={cfg.mlp_kind!r}")
    kinds = sorted(set(cfg.block_pattern) - {"attn"})
    if kinds:
        why.append(f"block kinds {kinds}")
    if cfg.is_encoder_decoder:
        why.append("an encoder-decoder")
    if cfg.vision_embeds:
        why.append("vision embeddings")
    if cfg.rope_kind not in ("full", "partial"):
        why.append(f"rope_kind={cfg.rope_kind!r}")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: the port does not run {', '.join(why)} yet "
            f"(dense GQA decoders only; see {_ROADMAP})")


class LayerPlan(NamedTuple):
    """Static layout of the layer stack (the JAX package's)."""
    head: tuple[tuple[str, str | None], ...]   # (kind, mlp) unscanned
    period: tuple[str, ...]                    # scanned pattern
    n_periods: int
    tail: tuple[str, ...]                      # remainder (kind only)
    scan_mlp: str | None                       # mlp kind inside the scan


def layer_plan(cfg) -> LayerPlan:
    head: list[tuple[str, str | None]] = []
    n_layers = cfg.num_layers
    if cfg.first_dense_layers:
        for _ in range(cfg.first_dense_layers):
            head.append((cfg.block_pattern[0], "dense"))
        n_layers -= cfg.first_dense_layers
    p = len(cfg.block_pattern)
    n_periods = n_layers // p
    rem = n_layers - n_periods * p
    tail = cfg.block_pattern[:rem]
    return LayerPlan(head=tuple(head), period=cfg.block_pattern,
                     n_periods=n_periods, tail=tail,
                     scan_mlp=cfg.mlp_kind)


def layer_kinds(cfg) -> list[str]:
    """Each layer's block kind in stack order: head, periods, tail."""
    plan = layer_plan(cfg)
    return ([kind for kind, _ in plan.head]
            + list(plan.period) * plan.n_periods + list(plan.tail))


class Block(nn.Module):
    """Pre-norm attention block with a GLU MLP (``apply_block`` for an
    ``attn`` block)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg, device)
        self.mixer = attn.GQAttention(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg, device)
        self.mlp = GLUMLP(cfg.d_model, cfg.d_ff,
                          "geglu" if cfg.mlp_kind == "geglu" else "swiglu",
                          cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, *, positions, rope, cache=None, index=None,
                lanes=None):
        x = x + self.mixer(self.norm1(x), positions=positions, rope=rope,
                           window=self.cfg.window, cache=cache, index=index,
                           lanes=lanes)
        return x + self.mlp(self.norm2(x))


class LM(nn.Module):
    """A dense decoder LM: embedding, ``num_layers`` blocks, final norm,
    LM head (tied to the embedding where the config says so)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg, dev)
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in layer_kinds(cfg))
        self.final_norm = RMSNorm(cfg.d_model, cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight, one tensor at a time (norm scales stay 0)."""
        self.embed.reset_parameters(generator)
        for block in self.layers:
            block.reset_parameters(generator)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, cache=None, positions=None):
        """Returns (logits (B, S, padded_vocab), cache).

        Without a cache: the causal forward at positions ``arange(S)``.  With a cache and S > 1: a prefill into an empty
        cache (its ``index`` becomes S).  With a cache and S == 1: one
        decode step; ``positions`` (B, 1) gives each row its own position
        (default: the cache's index), and every row writes at its own
        cache index, which then advances by one.  The cache is updated in
        place and returned."""
        b, s = tokens.shape
        if positions is None:
            if cache is not None and s == 1:
                positions = cache["index"][:, None]
            else:
                positions = torch.arange(
                    s, device=tokens.device)[None].expand(b, s)
        lanes = None
        if cache is not None and s == 1:
            # decode on the row-padded batch (module docstring)
            lanes, rows = b, decode_rows(b)
            tokens = torch.cat([tokens, tokens.new_zeros((rows - b, 1))])
            positions = torch.cat([positions,
                                   positions.new_zeros((rows - b, 1))])
        cfg = self.cfg
        rope = rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta,
                           fraction=(cfg.rope_fraction
                                     if cfg.rope_kind == "partial" else 1.0))
        x = self.embed.embed(tokens)
        for i, block in enumerate(self.layers):
            x = block(x, positions=positions, rope=rope,
                      cache=None if cache is None else cache["layers"][i],
                      index=None if cache is None else cache["index"],
                      lanes=lanes)
        logits = self.embed.unembed(self.final_norm(x))
        if cache is not None:
            cache["index"] += s
        if lanes is not None:
            logits = logits[:lanes]
        return logits, cache


def init_stack_cache(cfg, batch: int, t_max: int, *,
                     cache_dtype=torch.bfloat16, device=None) -> dict:
    """{"layers": one attention cache a layer, "index": (batch,) int32}."""
    dev = resolve_device(device)
    return {"layers": [attn.init_gqa_cache(cfg, batch, t_max,
                                           window=cfg.window,
                                           dtype=cache_dtype, device=dev)
                       for _ in layer_kinds(cfg)],
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def init_lm(cfg, seed: int = 0, device=None) -> LM:
    """A model with weights drawn from ``seed`` on ``device`` (cuda
    unless asked for the CPU), one tensor at a time: no float32 copy of
    the whole model ever exists.  The same seed and device give the same
    weights."""
    model = LM(cfg, device)
    model.reset_parameters(
        torch.Generator(device=model.device).manual_seed(seed))
    return model


def count_params(model: LM) -> int:
    return sum(p.numel() for p in model.parameters())
