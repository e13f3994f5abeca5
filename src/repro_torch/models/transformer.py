"""Model assembly for the decoder-only attention families (GQA or MLA
attention, dense or MoE MLPs): the counterpart of
``repro.models.transformer``.

The JAX package scans a stacked period of blocks; here the stack is an
``nn.ModuleList`` of per-layer ``Block``s in the same order (head, the
periods, tail), so each layer has its counterpart and
``repro_torch.convert.lm_params_from_jax`` unstacks the period axis into
it.  ``first_dense_layers`` head layers take a dense GLU of ``d_ff``, the
others ``cfg.mlp_kind`` (DeepSeek-V2: layer 0 dense, the rest MoE).  What
the port cannot run yet (the recurrent blocks, the encoder-decoder,
vision inputs, M-RoPE and unrotated attention) is refused when a model
is built, never run as something that differs from the JAX model.

Decode (one token a row against a cache) runs on a row-padded batch of
``rows`` rows (default ``decode_rows(B)``, a multiple of
``DECODE_ROW_TILE``), the rows after B zero-token padding.  Every
product, norm and softmax then has the shape of the padded batch whatever
the number of real rows, so a row's bits depend only on its own inputs
and the row count: each of the S lanes of
``serve.engine.decode_chunk_slots`` computes the bits of a solo
``generate`` run at the same ``rows`` (``LMService.rows``), for any S.
Attention's cache products run row by row
(``attention.decode_attention``, ``absorbed_attention``), and the MoE
routes each row as its own group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (GLUMLP, Embedding, RMSNorm,
                                      rope_tables)
from repro_torch.models.moe import MoE

DECODE_ROW_TILE = 8

_ROADMAP = "ROADMAP.md queue 1 items 4-5"


def decode_rows(batch: int) -> int:
    """Rows a decode step computes for ``batch`` rows: a multiple of
    ``DECODE_ROW_TILE``."""
    return -(-batch // DECODE_ROW_TILE) * DECODE_ROW_TILE


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a config the port cannot run yet."""
    why = []
    if cfg.attention_kind not in ("gqa", "mla"):
        why.append(f"attention_kind={cfg.attention_kind!r}")
    if cfg.mlp_kind not in ("swiglu", "geglu", "moe"):
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
            f"(GQA and MLA decoders only; see {_ROADMAP})")


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


def layer_mlps(cfg) -> list[str]:
    """Each layer's MLP kind in stack order (head, periods, tail):
    ``"dense"`` for the ``first_dense_layers``, else ``cfg.mlp_kind``."""
    plan = layer_plan(cfg)
    return ([mlp for _, mlp in plan.head]
            + [cfg.mlp_kind] * (plan.n_periods * len(plan.period)
                                + len(plan.tail)))


class Block(nn.Module):
    """Pre-norm attention block (GQA or MLA) with a GLU or MoE MLP
    (``apply_block`` for an ``attn`` block)."""

    def __init__(self, cfg, device, mlp: str):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg, device)
        self.mixer = (attn.MLAttention(cfg, device)
                      if cfg.attention_kind == "mla"
                      else attn.GQAttention(cfg, device))
        self.norm2 = RMSNorm(cfg.d_model, cfg, device)
        self.mlp = (MoE(cfg, device) if mlp == "moe" else
                    GLUMLP(cfg.d_model, cfg.d_ff,
                           "geglu" if cfg.mlp_kind == "geglu" else "swiglu",
                           cfg, device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, *, positions, rope, cache=None, index=None,
                lanes=None):
        kw = {} if self.cfg.attention_kind == "mla" else {
            "window": self.cfg.window}
        x = x + self.mixer(self.norm1(x), positions=positions, rope=rope,
                           cache=cache, index=index, lanes=lanes, **kw)
        h = self.norm2(x)
        if isinstance(self.mlp, MoE):
            # decode routes each row alone; else the JAX package's groups
            decode = cache is not None and x.shape[1] == 1
            out, _aux = self.mlp(h, groups=x.shape[0] if decode else None)
            return x + out
        return x + self.mlp(h)


class LM(nn.Module):
    """A dense decoder LM: embedding, ``num_layers`` blocks, final norm,
    LM head (tied to the embedding where the config says so)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg, dev)
        self.layers = nn.ModuleList(Block(cfg, dev, mlp)
                                    for mlp in layer_mlps(cfg))
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
    def forward(self, tokens: torch.Tensor, *, cache=None, positions=None,
                rows: int | None = None):
        """Returns (logits (B, S, padded_vocab), cache).

        Without a cache: the causal forward at positions ``arange(S)``.
        With a cache and S > 1: a prefill into an empty cache (its
        ``index`` becomes S).  With a cache and S == 1: one decode step on
        ``rows`` rows (default ``decode_rows(B)``; module docstring);
        ``positions`` (B, 1) gives each row its own position (default: the
        cache's index), and every row writes at its own cache index, which
        then advances by one.  The cache is updated in place and
        returned."""
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
            lanes, rows = b, decode_rows(b) if rows is None else rows
            if rows < b:
                raise ValueError(f"rows={rows} is fewer than the batch's "
                                 f"{b} rows")
            tokens = torch.cat([tokens, tokens.new_zeros((rows - b, 1))])
            positions = torch.cat([positions,
                                   positions.new_zeros((rows - b, 1))])
        cfg = self.cfg
        if cfg.attention_kind == "mla":     # only mla_rope_dim dims rotate
            rope = rope_tables(positions, cfg.mla_rope_dim,
                               theta=cfg.rope_theta)
        else:
            rope = rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta,
                               fraction=(cfg.rope_fraction
                                         if cfg.rope_kind == "partial"
                                         else 1.0))
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
    """{"layers": one attention cache a layer (GQA or MLA), "index":
    (batch,) int32}."""
    dev = resolve_device(device)
    if cfg.attention_kind == "mla":
        def layer():
            return attn.init_mla_cache(cfg, batch, t_max, dtype=cache_dtype,
                                       device=dev)
    else:
        def layer():
            return attn.init_gqa_cache(cfg, batch, t_max, window=cfg.window,
                                       dtype=cache_dtype, device=dev)
    return {"layers": [layer() for _ in layer_mlps(cfg)],
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
