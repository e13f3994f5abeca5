"""Model assembly, decoder-only (every family) and encoder-decoder
(whisper): the counterpart of ``repro.models.transformer``.

The JAX package scans a stacked period of blocks; here the stack is an
``nn.ModuleList`` of per-layer ``Block``s in the same order (head, the
periods, tail), so each layer has its counterpart and
``repro_torch.convert.lm_params_from_jax`` unstacks the period axis into
it.  Block kinds (``cfg.block_pattern``, ``layer_kinds``):

  attn        GQA or MLA self-attention + MLP   (window ``cfg.window``)
  local_attn  GQA with a ``cfg.local_window`` ring + MLP
  rglru       RG-LRU recurrent mixer + MLP      (Griffin residual pair)
  mlstm       mLSTM block (its own projections, no MLP)
  slstm       sLSTM block (ditto)

``first_dense_layers`` head layers take a dense GLU of ``d_ff``, the
others ``cfg.mlp_kind`` (DeepSeek-V2: layer 0 dense, the rest MoE).

An encoder-decoder (``cfg.is_encoder_decoder``, whisper) adds an
``Encoder`` (``enc_layers`` bidirectional attention blocks over stub frame
embeddings plus sinusoidal positions, no RoPE) and gives every decoder
block a cross attention (``norm_x``, ``cross``) between its mixer and its
MLP; the decoder adds sinusoidal rows at its positions after the token
embedding.  The cross K/V are computed from the encoder's output at a
prefill and kept in the cache for the decode.  A vision-language config
(``cfg.vision_embeds``, qwen2-vl) takes patch embeddings in place of the
token embeddings where a mask is set, and M-RoPE (``rope_kind="mrope"``)
rotates by (3, B, S) t/h/w positions; 1-D positions stand for three equal
streams, and the attention mask reads stream 0.

Training (``repro_torch.train``): the weights do not require grad until
a trainer turns that on; a forward then records the graph, checkpoints
every block (``run_block``, as the JAX package's ``jax.checkpoint`` of
each period) and, with ``return_aux``, returns the decoder's MoE
load-balance losses summed (the JAX package's ``aux``).  Serving runs
under ``torch.no_grad()`` (``serve.engine``) and is unchanged by it.

Sharded training (``models.sharding``, ``launch.train --ranks``): on a
mesh of ranks, ``init_lm(mesh=)`` gives each rank its blocks of the
parameters of the dense and DeepSeek-V2 families (GQA or MLA attention,
GLU or MoE MLPs; the same draw as the unsharded model), and
with ``cfg.shard_acts`` the residual stream between blocks is each rank's
block of d_model over ``model`` (the JAX package's ``act_embed``
constraint at each period boundary), so the checkpoints keep blocks.

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
routes each row as its own group.  The recurrent mixers (``ssm``) give
their padding rows a fresh state and write back the real rows' only, so
a real row never depends on them; but those families (and every ring
cache) take the service's solo fallback, so bit-equality across lane
counts is not a contract for them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import sharding as shd
from repro_torch.models import ssm
from repro_torch.models.layers import (GLUMLP, Embedding, RMSNorm,
                                      default_mrope_sections, rope_tables,
                                      sinusoidal_positions)
from repro_torch.models.moe import MoE

DECODE_ROW_TILE = 8

_HAS_MLP = {"attn", "local_attn", "rglru"}
# recurrent kind -> (mixer, its cache)
_RECURRENT = {"rglru": (ssm.RGLRU, ssm.init_rglru_cache),
              "mlstm": (ssm.MLSTM, ssm.init_mlstm_cache),
              "slstm": (ssm.SLSTM, ssm.init_slstm_cache)}


def decode_rows(batch: int) -> int:
    """Rows a decode step computes for ``batch`` rows: a multiple of
    ``DECODE_ROW_TILE``."""
    return -(-batch // DECODE_ROW_TILE) * DECODE_ROW_TILE


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
    """Each layer's block kind in stack order (head, periods, tail)."""
    plan = layer_plan(cfg)
    return ([kind for kind, _ in plan.head]
            + list(plan.period) * plan.n_periods + list(plan.tail))


def layer_mlps(cfg) -> list[str | None]:
    """Each layer's MLP kind in stack order (head, periods, tail):
    ``"dense"`` for the ``first_dense_layers``, else ``cfg.mlp_kind``;
    None for the kinds that carry no MLP (mLSTM, sLSTM)."""
    plan = layer_plan(cfg)
    mlps = ([mlp for _, mlp in plan.head]
            + [cfg.mlp_kind] * (plan.n_periods * len(plan.period)
                                + len(plan.tail)))
    return [mlp if kind in _HAS_MLP else None
            for kind, mlp in zip(layer_kinds(cfg), mlps)]


class Block(nn.Module):
    """Pre-norm block of one kind (``init_block`` / ``apply_block``): the
    mixer (GQA, MLA, RG-LRU, mLSTM or sLSTM) and its residual; with
    ``cross``, a cross attention to the encoder and its residual; then, for
    the kinds that have one, a GLU or MoE MLP and its residual.  Its
    forward returns (x, aux): the MoE's load-balance loss, None for any
    other block."""

    def __init__(self, cfg, device, kind: str, mlp: str | None,
                 cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, cfg, device)
        if kind in ("attn", "local_attn"):
            self.mixer = (attn.MLAttention(cfg, device)
                          if cfg.attention_kind == "mla" and kind == "attn"
                          else attn.GQAttention(cfg, device))
        elif kind in _RECURRENT:
            self.mixer = _RECURRENT[kind][0](cfg, device)
        else:
            raise ValueError(f"block kind {kind!r}")
        self.norm_x = self.cross = None
        if cross:
            self.norm_x = RMSNorm(cfg.d_model, cfg, device)
            self.cross = attn.CrossAttention(cfg, device)
        self.norm2 = self.mlp = None
        if kind in _HAS_MLP:
            self.norm2 = RMSNorm(cfg.d_model, cfg, device)
            self.mlp = (MoE(cfg, device) if mlp == "moe" else
                        GLUMLP(cfg.d_model, cfg.d_ff,
                               "geglu" if cfg.mlp_kind == "geglu"
                               else "swiglu", cfg, device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        if self.cross is not None:
            self.cross.reset_parameters(generator)
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)

    def forward(self, x, *, positions, rope, cache=None, index=None,
                lanes=None, enc_out=None, batch_size=None):
        h = self.norm1(x)
        if isinstance(self.mixer, attn.MLAttention):
            out = self.mixer(h, positions=positions, rope=rope, cache=cache,
                             index=index, lanes=lanes)
        elif isinstance(self.mixer, attn.GQAttention):
            window = (self.cfg.local_window if self.kind == "local_attn"
                      else self.cfg.window)
            out = self.mixer(h, positions=positions, rope=rope, cache=cache,
                             index=index, lanes=lanes, window=window)
        else:
            out = self.mixer(h, cache=cache)
        x = x + out
        if self.cross is not None:
            x = x + self.cross(self.norm_x(x), enc_out=enc_out, cache=cache,
                               lanes=lanes)
        if self.mlp is None:
            return x, None
        h = self.norm2(x)
        if isinstance(self.mlp, MoE):
            # decode routes each row alone; else the JAX package's groups
            decode = cache is not None and x.shape[1] == 1
            out, aux = self.mlp(h, groups=x.shape[0] if decode else None,
                                batch_size=batch_size)
            return x + out, aux
        return x + self.mlp(h), None


def grads_on(module: nn.Module) -> bool:
    """Whether a forward of ``module`` now records a graph for its
    weights: grad mode on and a parameter that requires grad."""
    return torch.is_grad_enabled() and any(p.requires_grad
                                           for p in module.parameters())


def run_block(block: Block, x, remat: bool, **kw):
    """``block(x, **kw)``; with ``remat``, checkpointed
    (``torch.utils.checkpoint``, non-reentrant): its activations are not
    kept for the backward but computed again there, as the JAX package's
    ``jax.checkpoint`` of each period does in training.  The values are
    the same either way.  On a mesh (:func:`_sharded_block`) the block's
    weights are gathered before the checkpoint, so its recomputation does
    not gather them again."""
    fn = block
    if shd.active() is not None:
        fn = functools.partial(_sharded_block, block,
                               shd.gathered(block) if remat else None)
    if remat:
        return checkpoint(fn, x, use_reentrant=False, **kw)
    return fn(x, **kw)


def _sharded_block(block: Block, weights, x, **kw):
    """``block`` on a mesh, with its weights already gathered (``weights``;
    None: gathered as it runs).  With ``cfg.shard_acts``, ``x`` is this
    rank's block of the residual stream's d_model, gathered whole here, and
    the output is cut to the block again (``act_embed``, JAX
    ``transformer.py:242, 269``): inside the checkpoint, so what it keeps
    for the backward is the block."""
    acts = block.cfg.shard_acts
    with shd.using(weights):
        if acts:
            x = shd.gather(x, "batch", None, "act_embed",
                           shape=(None, None, block.cfg.d_model))
        x, aux = block(x, **kw)
    return (shd.shard(x, "batch", None, "act_embed") if acts else x), aux


def encoder_cfg(cfg):
    """The encoder's config (``_encoder_cfg``): ``enc_layers`` attention
    blocks, no window, no RoPE."""
    return dataclasses.replace(cfg, num_layers=cfg.enc_layers,
                               block_pattern=("attn",),
                               first_dense_layers=0, window=0,
                               rope_kind="none")


class Encoder(nn.Module):
    """Whisper's encoder (``encode``): frames plus sinusoidal positions,
    ``enc_layers`` attention blocks with their MLPs, its own final norm.
    Bidirectional as in the JAX package: every query stands at position
    T - 1, so the causal mask hides nothing."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = encoder_cfg(cfg)
        self.layers = nn.ModuleList(
            Block(self.cfg, device, kind, mlp)
            for kind, mlp in zip(layer_kinds(self.cfg),
                                 layer_mlps(self.cfg)))
        self.final_norm = RMSNorm(cfg.d_model, self.cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for block in self.layers:
            block.reset_parameters(generator)

    def forward(self, frames: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        """(B, T_enc, D) frame embeddings -> (B, T_enc, D), in the
        frames' dtype where the weights' do not promote it; each block
        checkpointed with ``remat`` (``run_block``).  The blocks' aux is
        dropped, as the JAX package's ``encode`` drops it."""
        b, t, _ = frames.shape
        pe = sinusoidal_positions(torch.arange(t, device=frames.device),
                                  self.cfg.d_model)
        x = frames + pe.to(frames.dtype)
        positions = torch.full((b, t), t - 1, device=frames.device)
        for block in self.layers:
            x, _aux = run_block(block, x, remat, positions=positions,
                                rope=None)
        return self.final_norm(x)


class LM(nn.Module):
    """An LM: embedding, ``num_layers`` decoder blocks, final norm, LM
    head (tied to the embedding where the config says so), and for an
    encoder-decoder the ``encoder``.

    Its weights do not require grad (serving); a trainer turns that on
    (``repro_torch.train.steps``).  A forward then records the graph
    (``grads_on``) and, with ``remat`` (the default, as the JAX package
    trains), checkpoints every block of the decoder and the encoder
    (``run_block``).  Without grads, and with a cache, nothing is
    checkpointed."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.remat = True
        self.embed = Embedding(cfg, dev)
        self.layers = nn.ModuleList(
            Block(cfg, dev, kind, mlp, cross=cfg.is_encoder_decoder)
            for kind, mlp in zip(layer_kinds(cfg), layer_mlps(cfg)))
        self.final_norm = RMSNorm(cfg.d_model, cfg, dev)
        self.encoder = (Encoder(cfg, dev) if cfg.is_encoder_decoder
                        else None)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight, one tensor at a time (norm scales stay 0)."""
        self.embed.reset_parameters(generator)
        for block in self.layers:
            block.reset_parameters(generator)
        if self.encoder is not None:
            self.encoder.reset_parameters(generator)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output over (B, T_enc, D) frame embeddings."""
        if self.encoder is None:
            raise ValueError(f"{self.cfg.name} has no encoder")
        return self.encoder(frames, remat=self.remat and grads_on(self))

    def forward(self, tokens: torch.Tensor, *, cache=None, positions=None,
                rows: int | None = None, batch_size: int | None = None,
                enc_frames=None, vision_embeds=None, vision_mask=None,
                return_aux: bool = False):
        """Returns (logits (B, S, padded_vocab), cache), and with
        ``return_aux`` (logits, cache, aux) as the JAX package's
        ``forward``: aux the decoder's MoE load-balance losses summed in
        layer order, a float32 zero for a model without MoE.

        Without a cache: the causal forward at positions ``arange(S)``.
        With a cache and S > 1: a prefill into an empty cache (its
        ``index`` becomes S).  With a cache and S == 1: one decode step on
        ``rows`` rows (default ``decode_rows(B)``; module docstring);
        ``positions`` (B, 1) gives each row its own position (default: the
        cache's index), and every row writes at its own cache index, which
        then advances by one.  The cache is updated in place and
        returned.

        On a mesh, ``tokens`` are this rank's rows
        (``sharding.batch_rows``) of a batch of ``batch_size`` rows; a MoE
        model needs it there, to route the whole batch's groups.

        ``positions`` may be (3, B, S) t/h/w streams for M-RoPE.
        ``vision_embeds`` (B, S, D) replace the token embeddings where
        ``vision_mask`` (B, S) is set (a vision config; not in a decode).
        An encoder-decoder encodes ``enc_frames`` (B, T_enc, D) and fills
        the cache's cross K/V with them; without frames it attends the
        cache's cross K/V (zeros before any frames, as the JAX package's
        service decodes), and without frames or cache it raises
        ValueError."""
        cfg = self.cfg
        b, s = tokens.shape
        if cache is not None and shd.active() is not None:
            raise NotImplementedError(
                "a sharded cache (prefill, decode) is not ported: the "
                "sharded slice trains (ROADMAP.md queue 1 item 3)")
        if (cfg.is_encoder_decoder and enc_frames is None
                and cache is None):
            raise ValueError(f"{cfg.name}: a forward without a cache needs "
                             "enc_frames")
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
            positions = torch.cat([positions, positions.new_zeros(
                positions.shape[:-2] + (rows - b, 1))], dim=-2)
        if cfg.rope_kind == "mrope" and positions.dim() == 2:
            positions = positions[None].expand((3,) + positions.shape)
        pos1d = positions[0] if positions.dim() == 3 else positions
        if cfg.rope_kind == "none":         # nothing rotates
            rope = None
        elif cfg.attention_kind == "mla":   # only mla_rope_dim dims rotate
            rope = rope_tables(pos1d, cfg.mla_rope_dim,
                               theta=cfg.rope_theta)
        elif cfg.rope_kind == "mrope":
            rot = int(cfg.head_dim * cfg.rope_fraction)
            rope = rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta,
                               fraction=cfg.rope_fraction,
                               mrope_sections=default_mrope_sections(rot // 2))
        else:
            rope = rope_tables(pos1d, cfg.head_dim, theta=cfg.rope_theta,
                               fraction=(cfg.rope_fraction
                                         if cfg.rope_kind == "partial"
                                         else 1.0))
        x = self.embed.embed(tokens)
        if cfg.vision_embeds and vision_embeds is not None:
            x = torch.where(vision_mask[..., None],
                            vision_embeds.to(x.dtype), x)
        remat = cache is None and self.remat and grads_on(self)
        enc_out = None
        if cfg.is_encoder_decoder:
            x = x + sinusoidal_positions(pos1d, cfg.d_model).to(x.dtype)
            if enc_frames is not None:
                enc_out = self.encoder(enc_frames, remat=remat)
        aux_total = None
        acts = cfg.shard_acts and shd.active() is not None
        if acts:
            x = shd.shard(x, "batch", None, "act_embed")
        for i, block in enumerate(self.layers):
            x, aux = run_block(
                block, x, remat, positions=pos1d, rope=rope,
                cache=None if cache is None else cache["layers"][i],
                index=None if cache is None else cache["index"],
                lanes=lanes, enc_out=enc_out, batch_size=batch_size)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        if acts:
            x = shd.gather(x, "batch", None, "act_embed",
                           shape=(None, None, cfg.d_model))
        logits = self.embed.unembed(self.final_norm(x))
        if cache is not None:
            cache["index"] += s
        if lanes is not None:
            logits = logits[:lanes]
        if return_aux:
            if aux_total is None:
                aux_total = torch.zeros((), dtype=torch.float32,
                                        device=logits.device)
            return logits, cache, aux_total
        return logits, cache


def init_layer_cache(kind: str, cfg, batch: int, t_max: int, *,
                     cache_dtype=torch.bfloat16, device=None) -> dict:
    """One layer's cache by its kind (``init_block_cache``): K/V (or MLA's
    latent) in ``cache_dtype``, a ring of ``min(local_window, t_max)``
    slots for ``local_attn``; float32 recurrent states (``ssm``)."""
    if kind == "attn" and cfg.attention_kind == "mla":
        return attn.init_mla_cache(cfg, batch, t_max, dtype=cache_dtype,
                                   device=device)
    if kind in ("attn", "local_attn"):
        window = cfg.local_window if kind == "local_attn" else cfg.window
        return attn.init_gqa_cache(cfg, batch, t_max, window=window,
                                   dtype=cache_dtype, device=device)
    return _RECURRENT[kind][1](cfg, batch, device)


def init_stack_cache(cfg, batch: int, t_max: int, *, cross_len: int = 0,
                     cache_dtype=torch.bfloat16, device=None) -> dict:
    """{"layers": one cache a layer (``init_layer_cache``, with zero cross
    K/V of ``cross_len`` frames beside each layer's own when given),
    "index": (batch,) int32}."""
    dev = resolve_device(device)
    layers = [init_layer_cache(kind, cfg, batch, t_max,
                               cache_dtype=cache_dtype, device=dev)
              for kind in layer_kinds(cfg)]
    if cross_len:
        for layer in layers:
            layer.update(attn.init_cross_cache(cfg, batch, cross_len,
                                               dtype=cache_dtype, device=dev))
    return {"layers": layers,
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def init_lm(cfg, seed: int = 0, device=None, mesh=None) -> LM:
    """A model with weights drawn from ``seed`` on ``device`` (cuda
    unless asked for the CPU), one tensor at a time: no float32 copy of
    the whole model ever exists.  The same seed and device give the same
    weights.

    With ``mesh`` (a ``models.sharding.Mesh`` of more than one rank) the
    model is built on the meta device and each parameter is this rank's
    block of its ``sharding.param_spec`` (``cfg.fsdp_params``,
    ``cfg.embed_fsdp``) on ``device`` (default: the mesh's): every rank
    draws each whole tensor in turn, in float32, and keeps its block, so
    the blocks are the unsharded model's weights and no rank ever holds
    more than one whole tensor.  Only the dense and DeepSeek-V2 families
    are sharded (``sharding.check_supported`` raises for the others)."""
    if mesh is None or mesh.size == 1:
        model = LM(cfg, device)
    else:
        shd.check_supported(cfg)
        model = LM(cfg, "meta")
        shd.place(model, mesh, fsdp=cfg.fsdp_params,
                  embed_fsdp=cfg.embed_fsdp,
                  device=mesh.device if device is None
                  else resolve_device(device))
    model.reset_parameters(
        torch.Generator(device=model.device).manual_seed(seed))
    return model


def count_params(model: LM) -> int:
    """Parameters of the whole model (a placed parameter counts its whole
    shape)."""
    return sum(math.prod(shd.full_shape(p)) for p in model.parameters())
