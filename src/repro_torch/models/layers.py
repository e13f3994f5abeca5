"""Common layers: RMSNorm, rotary embeddings (full, partial and Qwen2-VL's
M-RoPE), whisper's sinusoidal positions, GLU MLPs and the token embedding
with its LM head.

The port of ``repro.models.layers``.  Parameters keep the JAX package's
layouts (``w_gate`` is ``(d_model, d_ff)``, the embedding ``(V, d_model)``)
so that a JAX pytree maps onto them one to one (``repro_torch.convert``).
The JAX package's sharding constraints sit at its sites
(``models.sharding.shard``): no-ops without a mesh.  On a mesh of ranks a
parameter is this rank's block (``sharding.place``), read in its compute
layout through ``sharding.param``; the GLU's hidden units and the
vocabulary split over ``model`` (Megatron's column- and row-parallel
pair, the vocabulary-parallel lookup and head).  Initialisers draw JAX's
scheme (a truncated normal on [-2, 2] in float32, scaled, then cast) from
an explicit ``torch.Generator``; they cannot reproduce JAX's bits, so
parity tests carry JAX's weights over instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as shd


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def empty_param(shape, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=param_dtype(cfg),
                                    device=device), requires_grad=False)


def zeros_param(shape, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=param_dtype(cfg),
                                    device=device), requires_grad=False)


@torch.no_grad()
def normal_(t: torch.Tensor, scale: float,
            generator: torch.Generator) -> torch.Tensor:
    """JAX's ``normal``: a truncated normal on [-2, 2] drawn in float32,
    times ``scale``, cast to ``t``'s dtype (in place).  One float32 buffer
    of ``t``'s size lives for the call.  A placed parameter
    (``sharding.place``) draws its whole shape and keeps its block, so the
    blocks of all ranks are the whole tensor's draw."""
    block = getattr(t, "block", None)
    buf = torch.empty(shd.full_shape(t), dtype=torch.float32,
                      device=t.device)
    nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_((buf if block is None else buf[block]).mul_(scale))
    return t


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype (JAX's promotion of mixed operands)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


# --------------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    """Scale stored as zeros and applied as ``1 + scale``, in float32."""

    def __init__(self, d: int, cfg, device):
        super().__init__()
        self.scale = zeros_param((d,), cfg, device)
        self.eps = cfg.norm_eps

    def forward(self, x: torch.Tensor, partial: bool = False) -> torch.Tensor:
        """``partial``: on a mesh each rank of ``model`` applies the norm to
        its own part of an activation (an SSM's heads), so the scale's grad
        is also summed over ``model`` (``sharding.copy_to``)."""
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        scale = shd.param(self.scale)
        if partial:
            scale = shd.copy_to(scale)
        return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope_frequencies(head_rot: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_rot, 2, dtype=torch.float32,
                            device=device) / head_rot
    return 1.0 / (theta ** exponent)                  # (head_rot/2,)


def default_mrope_sections(head_rot_half: int) -> tuple[int, int, int]:
    """M-RoPE's (t, h, w) split of the rotated half-dims: Qwen2-VL's (16,
    24, 24) at half-dim 64, scaled proportionally."""
    t = head_rot_half // 4
    h = (head_rot_half - t) // 2
    return (t, h, head_rot_half - t - h)


def rope_tables(positions: torch.Tensor, head_dim: int, *, theta: float,
                fraction: float = 1.0,
                mrope_sections: tuple[int, ...] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of the rotary angles, each (B, S, 1, rot/2), for the
    first ``fraction * head_dim`` dims (ChatGLM's partial RoPE).
    ``positions`` are (B, S) integers, or (3, B, S) t/h/w streams for
    M-RoPE with ``mrope_sections``, the k-th of which takes its run of
    the rotated half-dims' frequencies at stream k's positions (equal
    streams give the 1-D tables bit for bit).  A forward computes them
    once for all its layers."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv_freq = rope_frequencies(rot, theta, positions.device)
    if mrope_sections is None:
        angles = positions[..., None].float() * inv_freq
    else:
        parts, start = [], 0
        for sec, pos in zip(mrope_sections, positions):
            parts.append(pos[..., None].float() * inv_freq[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)
    angles = angles[:, :, None, :]
    return torch.sin(angles), torch.cos(angles)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Rows (..., d_model) float32 of the JAX package's sinusoidal table
    at integer ``positions``: sin at even columns, cos at odd, of
    ``pos * exp(2i * -ln(10000) / d_model)``, computed for these positions
    only (no table)."""
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / d_model))
    angles = positions[..., None].float() * div
    return torch.stack([torch.sin(angles), torch.cos(angles)],
                       dim=-1).reshape(positions.shape + (d_model,))


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on (B, S, H, Dh) with ``rope_tables``' (sin, cos):
    interleaved pairs ``(x[::2], x[1::2])`` of the first 2 * sin.shape[-1]
    dims rotate, the rest pass."""
    rot = 2 * sin.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------------- mlp
class GLUMLP(nn.Module):
    """SwiGLU or GeGLU (tanh-approximate GELU, as ``jax.nn.gelu``'s
    default).  With its hidden units split over ``model``, each rank runs
    its own units on the whole input and the ranks' down-projections are
    summed (``sharding.copy_to`` / ``reduce_from``)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, cfg, device):
        super().__init__()
        self.kind = kind
        self.w_gate = empty_param((d_model, d_ff), cfg, device)
        self.w_up = empty_param((d_model, d_ff), cfg, device)
        self.w_down = empty_param((d_ff, d_model), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d_model, d_ff = shd.full_shape(self.w_gate)
        normal_(self.w_gate, 1.0 / math.sqrt(d_model), generator)
        normal_(self.w_up, 1.0 / math.sqrt(d_model), generator)
        normal_(self.w_down, 1.0 / math.sqrt(d_ff), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = shd.split(self.w_gate, 1)
        if split:
            x = shd.copy_to(x)
        g = matmul(x, shd.param(self.w_gate))
        act = F.silu(g) if self.kind == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = act * matmul(x, shd.param(self.w_up))
        h = shd.shard(h, "batch", None, "mlp",
                      shape=(None, None, shd.full_shape(self.w_gate)[1]))
        out = matmul(h, shd.param(self.w_down))
        return shd.reduce_from(out) if split else out


# ----------------------------------------------------------------- embedding
class Embedding(nn.Module):
    """Token table (``padded_vocab`` rows) and, unless tied, the LM head.
    Logits cover ``padded_vocab`` and are never sliced.  With the
    vocabulary split over ``model``, each rank looks up the tokens in its
    rows (zeros for the others, summed over the ranks) and computes its
    block of the logits."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        v = cfg.padded_vocab
        self.embedding = empty_param((v, cfg.d_model), cfg, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else empty_param((v, cfg.d_model), cfg, device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.embedding, 1.0, generator)
        if self.lm_head is not None:
            normal_(self.lm_head, 1.0 / math.sqrt(self.cfg.d_model),
                    generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding, not ``embedding[tokens]``: the same rows, and a
        # backward that adds a repeated token's grads in a fixed order
        # (indexing's accumulating index_put_ on the CPU does not)
        table = shd.param(self.embedding)
        if shd.split(self.embedding, 0):
            local = tokens - shd.offset(self.embedding, 0)
            inside = (local >= 0) & (local < table.shape[0])
            x = F.embedding(torch.where(inside, local, 0), table)
            x = shd.reduce_from(x.masked_fill(~inside[..., None], 0))
        else:
            x = F.embedding(tokens, table)
        x = x.to(compute_dtype(self.cfg))
        if self.cfg.emb_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return shd.shard(x, "batch", None, "embed")

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embedding if self.lm_head is None else self.lm_head
        if shd.split(head, 0):
            x = shd.copy_to(x)
        logits = x @ shd.param(head).to(compute_dtype(self.cfg)).T
        if self.cfg.logits_softcap:
            c = self.cfg.logits_softcap
            logits = c * torch.tanh(logits / c)
        return shd.shard(logits, "batch", None, "vocab",
                         shape=(None, None, self.cfg.padded_vocab))
