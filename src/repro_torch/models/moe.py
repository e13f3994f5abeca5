"""Mixture-of-Experts block (DeepSeek-V2: shared and routed experts,
token-choice top-k routing) with grouped capacity dispatch: the port of
``repro.models.moe``.

Tokens are reshaped into G groups and each group routes on its own:

  router (float32) -> softmax -> top-k -> per-group stable sort of the
  choices by expert -> capacity gather -> the expert GLU over the expert
  axis -> each token's weighted expert outputs summed in slot order
  -> plus the shared experts.

Per-group capacity is C = ceil(Ng * K / E * cf); a choice past its
expert's first C in token order is dropped (the JAX package's dummy
slot).  The load-balance aux is E * sum_e f_e p_e, as in the JAX package.

Decode routes each row alone (``groups`` = the row count): one token a
group, so capacity never drops a token there and a lane's routing never
depends on its batch-mates, which is what the JAX package's service gets
by running every lane as a batch of one.

Every reduction is deterministic: the combine adds a token's up to K
contributions one after another in slot order (expert order), never by
an atomic scatter-add, so a row's bits do not change from run to run or
with the rows beside it.  The expert GLU reads every expert's weights on
every call, as the JAX package's einsum over the expert axis does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import GLUMLP, empty_param, matmul, normal_

GROUP_TARGET = 32


def num_groups(n: int, target: int = GROUP_TARGET) -> int:
    """The largest divisor of ``n`` that is at most ``target``."""
    g = min(target, n)
    while n % g:
        g -= 1
    return g


def capacity(tokens_per_group: int, cfg) -> int:
    return max(1, int(math.ceil(tokens_per_group * cfg.moe_top_k
                                / cfg.moe_num_experts
                                * cfg.moe_capacity_factor)))


def _one_hot_sum(index: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``one_hot(index, n).sum(dim)`` without ``F.one_hot``'s host-side
    range check (a device synchronisation on every call)."""
    hot = index[..., None] == torch.arange(n, device=index.device)
    return hot.sum(dim)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first on a tie (a stable descending sort)."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def dispatch(top_e: torch.Tensor, num_experts: int, cap: int):
    """Slots of each group's flat choices (G, Ng * K), in token order.

    The choices are stably sorted by expert; each expert keeps its first
    ``cap`` in token order.  A kept choice's slot is ``expert * cap +
    position``, a dropped one's the dummy slot ``num_experts * cap``."""
    g, nk = top_e.shape
    order = torch.argsort(top_e, dim=-1, stable=True)
    sorted_e = top_e.gather(-1, order)
    counts = _one_hot_sum(sorted_e, num_experts, 1)           # (G, E)
    start = counts.cumsum(-1) - counts
    pos = (torch.arange(nk, device=top_e.device)[None]
           - start.gather(-1, sorted_e))
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, num_experts * cap)
    # back to token order (order is a permutation: no duplicate index)
    return torch.empty_like(slot).scatter_(-1, order, slot)


class MoE(nn.Module):
    """Routed experts (JAX layouts: router (D, E) float32, expert_gate /
    expert_up (E, D, F), expert_down (E, F, D)) and, where the config has
    them, ``moe_num_shared`` shared experts as one SwiGLU of width
    ``moe_d_ff * moe_num_shared``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
        self.router = nn.Parameter(torch.empty((d, e), dtype=torch.float32,
                                               device=device),
                                   requires_grad=False)
        self.expert_gate = empty_param((e, d, f), cfg, device)
        self.expert_up = empty_param((e, d, f), cfg, device)
        self.expert_down = empty_param((e, f, d), cfg, device)
        self.shared = (GLUMLP(d, f * cfg.moe_num_shared, "swiglu", cfg,
                              device) if cfg.moe_num_shared else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.moe_d_ff
        for w in (self.router, self.expert_gate, self.expert_up):
            normal_(w, 1.0 / math.sqrt(d), generator)
        normal_(self.expert_down, 1.0 / math.sqrt(f), generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x: torch.Tensor, groups: int | None = None):
        """x: (B, S, D) -> (out (B, S, D), aux).  ``groups``: the number of
        routing groups (default ``num_groups(B * S)``, the JAX package's;
        decode passes the row count)."""
        b, s, d = x.shape
        e, k = self.cfg.moe_num_experts, self.cfg.moe_top_k
        n = b * s
        g = num_groups(n) if groups is None else groups
        ng = n // g
        cap = capacity(ng, self.cfg)
        xf = x.reshape(g, ng, d)

        probs = torch.softmax(xf.float() @ self.router, dim=-1)  # (G,Ng,E)
        top_w, top_e = top_k(probs, k)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        slot = dispatch(top_e.reshape(g, ng * k), e, cap)
        # load-balance aux (Switch): E * sum_e fraction_e * prob_e
        me = probs.mean(dim=(0, 1))
        ce = _one_hot_sum(top_e, e, 2).float().mean(dim=(0, 1)) / k
        aux = e * (me * ce).sum()

        # each slot's token; a slot no choice fills takes token 0 and
        # weight 0, as in the JAX package (its output is never added)
        tok = torch.zeros((g, e * cap + 1), dtype=torch.long,
                          device=x.device)
        tok.scatter_(-1, slot, torch.arange(ng * k, device=x.device)
                     .div(k, rounding_mode="floor").expand(g, -1))
        xs = xf.gather(1, tok[:, :-1, None].expand(-1, -1, d))
        xs = xs.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
        h = F.silu(matmul(xs, self.expert_gate)) * matmul(xs,
                                                          self.expert_up)
        ys = matmul(h, self.expert_down)                        # (E, G*C, D)
        ys = ys.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
        ys = torch.cat([ys, ys.new_zeros((g, 1, d))], dim=1)    # dummy slot

        # combine: each token's contributions in slot order, one add at a
        # time (a dropped choice adds the dummy slot's zeros)
        slot, perm = slot.reshape(g, ng, k).sort(dim=-1)
        w = top_w.reshape(g, ng, k).gather(-1, perm).to(x.dtype)
        contrib = ys.gather(1, slot.reshape(g, ng * k, 1).expand(-1, -1, d))
        contrib = contrib.reshape(g, ng, k, d) * w[..., None]
        out = torch.zeros((g, ng, d), dtype=contrib.dtype, device=x.device)
        for j in range(k):
            out = out + contrib[:, :, j]
        out = out.reshape(b, s, d)
        if self.shared is not None:
            out = out + self.shared(x)
        return out, aux
