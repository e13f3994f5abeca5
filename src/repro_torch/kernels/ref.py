"""Plain PyTorch versions of the hand-written kernels.

Each computes exactly what ``repro.kernels.ref`` defines for the JAX
package, with the port's leading slot axis S on the packed kernels and an
optional leading client axis K on the unpacked ones.  They are what the
kernel wrappers run on a CPU tensor, and the oracle every kernel is held
against on the card.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


def fwht_ref(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Walsh--Hadamard transform along the last axis (a power of two):
    stage h pairs element i with i + h inside blocks of 2h, the same
    butterfly order as the JAX package's ``preprocess.fwht``; the
    normalized transform divides by sqrt(d) rounded to float32.  The
    divisor lies on x's device: PyTorch's CUDA division by a CPU scalar
    multiplies by its reciprocal instead, which can differ in the last
    bit from the division that the CPU and the kernel make."""
    d = x.shape[-1]
    if d <= 0 or d & (d - 1):
        raise ValueError(f"fwht needs a power-of-two axis, got {d}")
    shape = x.shape
    x = x.reshape(-1, d)
    h = 1
    while h < d:
        x = x.reshape(-1, d // (2 * h), 2, h)
        a, b = x[:, :, 0, :], x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2).reshape(-1, d)
        h *= 2
    if normalize:
        x = x / torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
    return x.reshape(shape)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A step scalar as a float32 tensor on ``like``'s device: the value
    the kernels receive as a C float."""
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def momentum_dot_ref(cols: torch.Tensor, log_lam: torch.Tensor,
                     log_prev: torch.Tensor, theta) -> torch.Tensor:
    """delta = cols^T (lam + theta (lam - lam_prev)), lam = exp(log_lam).

    cols (..., n, B), log vectors (..., n) with the same optional leading
    client axis; returns (..., B)."""
    lam = torch.exp(log_lam)
    lam_prev = torch.exp(log_prev)
    mom = lam + _f32(theta, cols) * (lam - lam_prev)
    return (cols * mom[..., None]).sum(dim=-2)


def mwu_update_ref(cols: torch.Tensor, log_lam: torch.Tensor,
                   u: torch.Tensor, dw: torch.Tensor, sign, gamma, tau,
                   d_eff, *, normalize: bool = True):
    """Fused per-class dual update (lines 5-6 of Algorithm 2) and the
    incremental u, over cols (..., n, B), dw (..., B) and point vectors
    (..., n).  The step scalars are taken as float32 and
    c = 1 / (gamma + d_eff / tau) is computed in float32, as the kernel
    does.

    Returns (log_new normalized, u_new), or with ``normalize=False``
    (log_new UNNORMALIZED, u_new, m, s) where lse = m + log(s) per
    client."""
    sign, gamma, tau, d_eff = (_f32(v, cols) for v in (sign, gamma, tau,
                                                        d_eff))
    dv = (cols * dw[..., None, :]).sum(dim=-1)
    v = sign * (u + d_eff * dv)
    ratio = d_eff / tau
    c = 1.0 / (gamma + ratio)
    log_new = c * (ratio * log_lam - v)
    u_new = u + dv
    m = log_new.amax(dim=-1)
    s = torch.exp(log_new - m[..., None]).sum(dim=-1)
    if not normalize:
        return log_new, u_new, m, s
    return log_new - (m + torch.log(s))[..., None], u_new


def _gather_rows(x_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, b, n_pad) rows x_t[s, idx[s, j]]."""
    return torch.gather(
        x_t, 1, idx.long()[:, :, None].expand(-1, -1, x_t.shape[-1]))


def momentum_dot_packed_ref(x_t: torch.Tensor, idx: torch.Tensor,
                            log_lam: torch.Tensor, log_prev: torch.Tensor,
                            sign: torch.Tensor,
                            theta: torch.Tensor) -> torch.Tensor:
    """delta[s, j] = sum_i sign_i (lam_i + theta_s (lam_i - lam_prev_i))
    x_t[s, idx[s, j], i], lam = exp(log_lam).  Shapes: x_t (S, d, n_pad),
    idx (S, b), vectors (S, n_pad), theta (S,) -> (S, b)."""
    lam = torch.exp(log_lam)
    lam_prev = torch.exp(log_prev)
    mom = sign * (lam + theta[:, None] * (lam - lam_prev))
    return torch.bmm(_gather_rows(x_t, idx), mom[:, :, None])[:, :, 0]


def mwu_update_packed_ref(x_t: torch.Tensor, idx: torch.Tensor,
                          log_lam: torch.Tensor, u: torch.Tensor,
                          dw: torch.Tensor, sign: torch.Tensor,
                          mwu_c: torch.Tensor, mwu_dot: torch.Tensor,
                          d_eff: float):
    """Packed dual update for both classes (lines 5-6 of Algorithm 2 plus
    the incremental u).  ``mwu_c`` = 1 / (gamma + d_eff / tau) and
    ``mwu_dot`` = d_eff / tau are the per-slot (S,) step scalars.

    Returns (log_new UNNORMALIZED, u_new, m, s), m and s (S, 2) with
    column 0 the class of sign +1 and column 1 that of sign -1: the
    per-class logsumexp is m + log(s), masked by the sign vector (padding,
    sign 0, belongs to neither class)."""
    dv = torch.bmm(dw[:, None, :], _gather_rows(x_t, idx))[:, 0, :]
    v = sign * (u + d_eff * dv)
    log_new = mwu_c[:, None] * (mwu_dot[:, None] * log_lam - v)
    masks = torch.stack([sign > 0, sign < 0], dim=1)        # (S, 2, n_pad)
    masked = torch.where(masks, log_new[:, None, :], NEG)
    m = masked.amax(dim=-1)
    s = torch.where(masks, torch.exp(masked - m[..., None]), 0.0).sum(-1)
    return log_new, u + dv, m, s


def class_partials(log_new: torch.Tensor, sign: torch.Tensor,
                   lane: int = 128) -> torch.Tensor:
    """Per-tile (m_p, s_p, m_m, s_m) (S, tiles, 4) of packed log weights
    (S, n_pad): each ``lane``-point tile's per-class max and sum of
    exp(log_new - max), masked by sign; a tile without a point of a class
    gives (NEG, 0) for it.  These are the partials the packed MWU kernel
    writes before its last block merges them."""
    rows, n_pad = log_new.shape
    ln = log_new.reshape(rows, n_pad // lane, 1, lane)
    sg = sign.reshape(rows, n_pad // lane, 1, lane)
    masks = torch.cat([sg > 0, sg < 0], dim=2)          # (S, tiles, 2, lane)
    masked = torch.where(masks, ln, NEG)
    m = masked.amax(dim=-1)
    s = torch.where(masks, torch.exp(masked - m[..., None]), 0.0).sum(-1)
    return torch.stack([m, s], dim=-1).reshape(rows, n_pad // lane, 4)


def merge_class_partials(parts: torch.Tensor):
    """Merge per-tile (m_p, s_p, m_m, s_m) partials (S, tiles, 4), in
    tile order, into the per-class (m, s) of the whole point axis, each
    (S, 2) as :func:`mwu_update_packed_ref` returns them: m the max of
    the tiles' m, s the sum of their s exp(m_tile - m)."""
    m_t, s_t = parts[..., 0::2], parts[..., 1::2]         # (S, tiles, 2)
    m = m_t.amax(dim=1)
    return m, (s_t * torch.exp(m_t - m[:, None, :])).sum(dim=1)


def block_partials(log_new: torch.Tensor, points: int):
    """Per-block (max, sum of exp(log_new - max)) of log weights (..., n)
    cut into blocks of ``points`` points along the last axis (the last
    block may be shorter): (pmax, psum), each (..., blocks).  These are
    the partials each point block of the unpacked MWU kernel writes
    before the client's last block merges them."""
    n = log_new.shape[-1]
    blocks = -(-n // points)
    x = torch.nn.functional.pad(log_new, (0, blocks * points - n),
                                value=-math.inf)
    x = x.reshape(*log_new.shape[:-1], blocks, points)
    pmax = x.amax(dim=-1)
    return pmax, torch.exp(x - pmax[..., None]).sum(dim=-1)


def merge_block_partials(pmax: torch.Tensor, psum: torch.Tensor):
    """Merge per-block (max, sum-exp) partials (..., blocks) into the
    (m, s) of the whole point axis, as the JAX wrapper of the unpacked
    MWU merges its per-tile partials: m the max of the blocks' m, s the
    sum of their s exp(m_block - m); lse = m + log(s)."""
    m = pmax.amax(dim=-1)
    return m, (psum * torch.exp(pmax - m[..., None])).sum(dim=-1)
