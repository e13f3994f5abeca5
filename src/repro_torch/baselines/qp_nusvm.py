"""Projected-gradient QP solver for the RC-Hull problem (6) -- the
stand-in for LIBSVM's NuSVC (QP-based, Omega(n^2 d) worst case).

    min_{eta, xi}  0.5 || A eta - B xi ||^2
    s.t.  ||eta||_1 = ||xi||_1 = 1,  0 <= eta_i, xi_j <= nu

Accelerated projected gradient (FISTA) with EXACT Euclidean projection
onto the capped simplex {0 <= v <= nu, sum v = 1} via bisection on the
shift lambda in  v_i = clip(y_i - lambda, 0, nu).

Setting nu >= 1 recovers plain C-Hull (hard-margin dual), so this also
serves as the generic QP oracle in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.preprocess import as_f32
from repro_torch.device import resolve_device


def project_capped_simplex(y: torch.Tensor, nu: float,
                           iters: int = 60) -> torch.Tensor:
    """Euclidean projection onto {0 <= v <= nu, sum v = 1} (bisection).
    The bracket stays on the device: no round reads it back."""
    lo = torch.min(y) - 1.0
    hi = torch.max(y)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = torch.sum(torch.clamp(y - mid, 0.0, nu))
        # s is decreasing in mid; want s == 1
        above = s > 1.0
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    return torch.clamp(y - 0.5 * (lo + hi), 0.0, nu)


class QPState(NamedTuple):
    eta: torch.Tensor
    xi: torch.Tensor
    eta_m: torch.Tensor    # FISTA extrapolation point
    xi_m: torch.Tensor
    tk: torch.Tensor


def run_chunk(state: QPState, xp: torch.Tensor, xm: torch.Tensor,
              nu: float, lr: float, num_steps: int) -> QPState:
    for _ in range(num_steps):
        diff = state.eta_m @ xp - state.xi_m @ xm      # A eta - B xi
        g_eta = xp @ diff
        g_xi = -(xm @ diff)
        eta_new = project_capped_simplex(state.eta_m - lr * g_eta, nu)
        xi_new = project_capped_simplex(state.xi_m - lr * g_xi, nu)
        tk_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.tk ** 2))
        mom = (state.tk - 1.0) / tk_new
        eta_m = eta_new + mom * (eta_new - state.eta)
        xi_m = xi_new + mom * (xi_new - state.xi)
        state = QPState(eta_new, xi_new, eta_m, xi_m, tk_new)
    return state


def default_lr(xp: torch.Tensor, xm: torch.Tensor) -> float:
    """1/L with L = lambda_max of [A;B]^T[A;B], by 20 power iterations in
    float32 (one host read, of L)."""
    d = xp.shape[1]
    v = torch.ones(d, device=xp.device) / torch.sqrt(
        torch.tensor(float(d), device=xp.device))
    for _ in range(20):
        v2 = xp.T @ (xp @ v) + xm.T @ (xm @ v)
        v = v2 / torch.clamp(torch.linalg.vector_norm(v2), min=1e-30)
    lmax = float(torch.dot(v, xp.T @ (xp @ v) + xm.T @ (xm @ v)))
    return 1.0 / max(lmax, 1e-12)


def solve(xp, xm, nu: float = 1.0, *, num_iters: int = 2000,
          lr: float | None = None, record_every: int | None = None,
          device: str | torch.device | None = None):
    """FISTA on RC-Hull.  lr defaults to :func:`default_lr`.  Returns
    (state, [(iteration, 0.5 ||A eta - B xi||^2)]), read once a chunk."""
    dev = resolve_device(device)
    xp, xm = as_f32(xp, dev), as_f32(xm, dev)
    n1, n2 = xp.shape[0], xm.shape[0]
    if lr is None:
        lr = default_lr(xp, xm)
    eta0 = torch.full((n1,), 1.0 / n1, device=dev)
    xi0 = torch.full((n2,), 1.0 / n2, device=dev)
    state = QPState(eta0, xi0, eta0, xi0, torch.ones((), device=dev))
    history = []
    chunk = record_every or num_iters
    done = 0
    while done < num_iters:
        ns = min(chunk, num_iters - done)
        state = run_chunk(state, xp, xm, float(nu), float(lr), ns)
        done += ns
        diff = state.eta @ xp - state.xi @ xm
        history.append((done, float(0.5 * torch.sum(diff * diff))))
    return state, history
