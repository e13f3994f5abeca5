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

from repro_torch.models import sharding as shd
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

    def forward(self, x: torch.Tensor, groups: int | None = None,
                batch_size: int | None = None):
        """x: (B, S, D) -> (out (B, S, D), aux).  ``groups``: the number of
        routing groups (default ``num_groups(B * S)``, the JAX package's;
        decode passes the row count).

        On a mesh (``models.sharding``) ``x`` is this rank's rows
        (``sharding.batch_rows``) of a batch of ``batch_size`` rows, which
        is required there, and the groups are the whole batch's, as GSPMD
        keeps them: a rank routes its own groups where ``data`` divides
        them, else every rank routes all of them (its rows all-gathered
        over ``data``) and keeps its rows' outputs.  The router's logits are
        all-gathered over ``model`` where its experts split, so the
        softmax, ``top_k`` and the dispatch are whole and the same on
        every rank; each rank runs its own experts (or, where the experts
        do not divide ``model``, its hidden units of all of them) on its
        slots, and the ranks' partial sums are added by ``reduce_from``.
        The aux's sums over the tokens are added over ``data`` before its
        product."""
        b, s, d = x.shape
        cfg = self.cfg
        e, k = cfg.moe_num_experts, cfg.moe_top_k
        rows, first = shd.batch_layout(b, batch_size)
        n = rows * s
        g = num_groups(n) if groups is None else groups
        ng = n // g
        cap = capacity(ng, cfg)
        # experts (or their hidden units) and router split over model
        esplit = shd.split(self.expert_gate, 0) or shd.split(
            self.expert_gate, 2)
        rsplit = shd.split(self.router, 1)
        x_in = shd.copy_to(x) if esplit else x
        # the groups straddle the data ranks' rows: route every row
        gather = rows > b and g % (rows // b) != 0

        def routed(t):        # (G or this rank's G, Ng, D)
            if gather:
                t = shd.all_gather(t, "data", 0)
            return t.reshape(-1, ng, d)

        xr = routed(x_in if rsplit else x)
        xe = xr if rsplit == esplit else routed(x_in)
        gl = xr.shape[0]

        logits = xr.float() @ shd.param(self.router)
        if rsplit:
            logits = shd.all_gather(logits, "model", -1)
        probs = torch.softmax(logits, dim=-1)                  # (G,Ng,E)
        top_w, top_e = top_k(probs, k)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        if esplit:            # its grad is a partial sum on each rank
            top_w = shd.copy_to(top_w)
        slot = dispatch(top_e.reshape(gl, ng * k), e, cap)
        self.dropped = (slot == e * cap).detach()
        aux = self._aux(probs, top_e, n,
                        shd.batch_ways() if rows == b else 1,
                        first * s if gather else None, b * s)

        # each slot's token; a slot no choice fills takes token 0 and
        # weight 0, as in the JAX package (its output is never added)
        tok = torch.zeros((gl, e * cap + 1), dtype=torch.long,
                          device=x.device)
        tok.scatter_(-1, slot, torch.arange(ng * k, device=x.device)
                     .div(k, rounding_mode="floor").expand(gl, -1))
        gate = shd.param(self.expert_gate)
        ne, lo = gate.shape[0], shd.offset(self.expert_gate, 0) * cap
        xs = xe.gather(1, tok[:, lo:lo + ne * cap, None].expand(-1, -1, d))
        xs = xs.reshape(gl, ne, cap, d).transpose(0, 1).reshape(
            ne, gl * cap, d)
        h = F.silu(matmul(xs, gate)) * matmul(
            xs, shd.param(self.expert_up))
        ys = matmul(h, shd.param(self.expert_down))           # (E, G*C, D)
        ys = ys.reshape(ne, gl, cap, d).transpose(0, 1).reshape(
            gl, ne * cap, d)
        ys = torch.cat([ys, ys.new_zeros((gl, 1, d))], dim=1)  # dummy slot

        # combine: each token's contributions in slot order, one add at a
        # time (a dropped choice, or another rank's expert, adds the dummy
        # slot's zeros)
        slot, perm = slot.reshape(gl, ng, k).sort(dim=-1)
        if ne != e:
            slot = torch.where((slot >= lo) & (slot < lo + ne * cap),
                               slot - lo, ne * cap)
        w = top_w.reshape(gl, ng, k).gather(-1, perm).to(x.dtype)
        contrib = ys.gather(1, slot.reshape(gl, ng * k, 1).expand(-1, -1, d))
        contrib = contrib.reshape(gl, ng, k, d) * w[..., None]
        out = torch.zeros((gl, ng, d), dtype=contrib.dtype, device=x.device)
        for j in range(k):
            out = out + contrib[:, :, j]
        out = (out.reshape(rows, s, d).narrow(0, first, b) if gather
               else out.reshape(b, s, d))
        out = shd.reduce_from(out) if esplit else out
        if self.shared is not None:
            out = out + self.shared(x)
        return out, aux

    @staticmethod
    def _aux(probs, top_e, n: int, repeat: int, own: int | None,
             count: int):
        """The load-balance aux (Switch): E * sum_e fraction_e * prob_e,
        the means over the whole batch's ``n`` tokens.  On a mesh the
        sums of this rank's tokens (``count`` from token ``own`` of the
        routed ones, or all of them), over ``repeat`` where every data
        rank holds them, are added over ``data`` first."""
        e, k = probs.shape[-1], top_e.shape[-1]
        counts = _one_hot_sum(top_e, e, 2).float()
        parts = [t.reshape(-1, e) for t in (probs, counts)]
        if own is not None:
            parts = [t.narrow(0, own, count) for t in parts]
        sums = torch.stack([t.sum(0) for t in parts]) / repeat
        me, ce = shd.reduce_from(sums, "data") / n
        return e * (me * (ce / k)).sum()
