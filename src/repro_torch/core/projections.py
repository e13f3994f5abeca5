"""Projection / proximal steps for HM-Saddle and nu-Saddle, in PyTorch.

Counterpart of ``repro.core.projections`` for what the solver runs:

* :func:`entropy_prox` -- the closed form of Lemma 10, the entropy-prox
  (multiplicative-weights) step on the simplex, in log space.
* :func:`capped_bisect_masked` -- the sort-free O(n) projection onto the
  capped simplex D = {0 <= eta_i <= nu, sum eta = 1} that the solver hot
  loop runs: the KKT solution of the KL projection is ``min(c eta, nu)``
  for a scalar ``c >= 1``, located by a fixed-round geometric bisection
  on ``c`` (each round one masked O(n) reduction), followed by one exact
  rescale of the below-cap block.
* :func:`capped_simplex_project_bisect` -- its single-class view.
* :func:`capped_simplex_project_sorted` (Rule 2, one sort) and
  :func:`capped_simplex_project_loop` (Rule 3, the iterative rescale) --
  the projections of the unpacked reference step, serial and across
  clients -- and :func:`capped_entropy_prox`, the MWU step followed by
  Rule 2.

Plain torch, as it is plain jnp in the JAX package; leading batch axes
(the solver's slot axis) are carried through.
"""

from __future__ import annotations

import torch

# Geometric bisection rounds: the scale c lives in [1, e^BISECT_LOG_HI] and
# after R rounds the cap-set ambiguity band is BISECT_LOG_HI * 2^-R, which
# bounds the output error by nu times that band.  32 rounds (~2e-8) is
# oracle grade; the solver runs 24 (~5e-6 * nu < 1e-5 for any feasible
# nu <= 1), one reduction per round.
BISECT_ROUNDS = 32
BISECT_ROUNDS_SOLVER = 24
BISECT_LOG_HI = 80.0


def entropy_prox(log_lam: torch.Tensor, v: torch.Tensor, gamma, tau,
                 d) -> torch.Tensor:
    """One MWU step; returns *normalized* log weights on the simplex."""
    c = 1.0 / (gamma + d / tau)
    log_new = c * ((d / tau) * log_lam - v)
    return log_new - torch.logsumexp(log_new, dim=-1, keepdim=True)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def capped_bisect_masked(lam: torch.Tensor, nu, masks: torch.Tensor, *,
                         rounds: int, all_sum=_identity,
                         all_max=_identity) -> torch.Tensor:
    """THE sort-free capped-simplex projection core.

    Projects ``lam`` (..., n) restricted to each row of ``masks``
    (..., C, n) -- C disjoint index sets, each its own capped simplex --
    in ONE shared sweep per bisection round.  ``nu`` is a float or a
    tensor of the leading batch shape (...,).  ``all_sum``/``all_max``
    are the cross-client reduction hooks (identity in serial), applied
    to (..., C) and (..., 2C) statistics.  Entries outside every mask
    come back 0.  Feasible classes (max lam <= nu) are returned
    unchanged.
    """
    nu = torch.as_tensor(nu, dtype=lam.dtype, device=lam.device)
    nu_c = nu[..., None]                                   # (..., 1)
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    lam_c = lam[..., None, :]                              # (..., 1, n)
    # each class's entries, 0 elsewhere: min(c * 0, nu) is 0, so the
    # rounds need no mask of their own
    lam_m = torch.where(masks, lam_c, zero)                # (..., C, n)
    mx = all_max(lam_m.amax(dim=-1))                       # (..., C)
    feasible = mx <= nu_c

    lo = torch.zeros(masks.shape[:-1], dtype=lam.dtype, device=lam.device)
    hi = torch.full_like(lo, BISECT_LOG_HI)
    for _ in range(rounds):
        mid = 0.5 * (lo + hi)
        capped = torch.minimum(torch.exp(mid)[..., None] * lam_m,
                               nu_c[..., None])
        s = all_sum(capped.sum(dim=-1))
        under = s < 1.0
        lo = torch.where(under, mid, lo)
        hi = torch.where(under, hi, mid)
    # per-entry class scale (masks are disjoint; off-mask entries get 0)
    c_i = (masks * torch.exp(hi)[..., None]).sum(dim=-2)
    clamped = c_i * lam >= nu_c
    cap_set = masks & clamped[..., None, :]
    n_cl_loc = torch.where(cap_set, 1.0, 0.0).to(lam.dtype).sum(dim=-1)
    omega_loc = torch.where(masks & ~clamped[..., None, :], lam_c,
                            zero).sum(dim=-1)
    c = masks.shape[-2]
    stats = all_sum(torch.cat([n_cl_loc, omega_loc], dim=-1))
    n_cl, omega = stats[..., :c], stats[..., c:]
    alpha = (1.0 - nu_c * n_cl) / torch.clamp(omega, min=1e-30)
    alpha_i = (masks * alpha[..., None]).sum(dim=-2)
    proj = torch.where(clamped, nu_c, lam * alpha_i)
    feas_i = (masks & feasible[..., None]).any(dim=-2)
    return torch.where(feas_i, lam, proj)


def capped_simplex_project_bisect(eta: torch.Tensor, nu, *,
                                  rounds: int = BISECT_ROUNDS
                                  ) -> torch.Tensor:
    """Sort-free projection of ``eta`` (..., n) onto
    D = {0 <= x <= nu, sum x = 1}: the single-class view of
    :func:`capped_bisect_masked`."""
    masks = torch.ones(eta.shape[:-1] + (1, eta.shape[-1]), dtype=torch.bool,
                       device=eta.device)
    return capped_bisect_masked(eta, nu, masks, rounds=rounds)


def capped_simplex_project_sorted(eta: torch.Tensor, nu: float
                                  ) -> torch.Tensor:
    """Rule 2 (Lemma 11): sorted projection of ``eta`` (n,) onto the
    capped simplex.

    Finds the largest index i* (in ascending sorted order) such that
      varsigma_{i*} = sum_{j >= i*} (eta_j - nu) >= 0   and
      eta_{i*-1} (1 + varsigma_{i*} / Omega_{i*}) < nu,
      Omega_{i*} = sum_{j < i*} eta_j,
    then clamps the entries from i* on to nu and scales the rest.  One
    stable sort (``jnp.argsort`` is stable too), prefix sums and a max."""
    n = eta.shape[-1]
    order = torch.argsort(eta, dim=-1, stable=True)
    s = torch.gather(eta, -1, order)                  # ascending
    total = s.sum(dim=-1, keepdim=True)
    prefix = torch.cumsum(s, dim=-1)                  # sum_{j <= i}
    omega = prefix - s                                # sum_{j < i}
    suffix = total - omega                            # sum_{j >= i}
    idx = torch.arange(n, device=eta.device)
    varsig = suffix - nu * (n - idx).to(eta.dtype)    # sum_{j>=i}(s_j - nu)
    prev = torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)
    scale = 1.0 + varsig / torch.clamp(omega, min=1e-30)
    ok = (varsig >= 0) & (prev * scale < nu)
    # the largest index meeting both conditions
    i_star = torch.where(ok, idx, torch.full_like(idx, -1)).amax(
        dim=-1, keepdim=True)
    no_violation = eta.amax(dim=-1, keepdim=True) <= nu
    sc = torch.where(no_violation, torch.ones_like(total),
                     torch.gather(scale, -1, torch.clamp(i_star, min=0)))
    proj_sorted = torch.where(no_violation | (idx < i_star), s * sc,
                              torch.full_like(s, nu))
    return torch.zeros_like(eta).scatter(-1, order, proj_sorted)


def capped_simplex_project_loop(eta: torch.Tensor, nu: float,
                                max_iters: int | None = None, *,
                                all_sum=_identity) -> torch.Tensor:
    """Rule 3 (eq. 12): iterative projection of ``eta`` (..., n), at most
    ceil(1/nu) rounds (each round fixes at least one new entry at nu).
    ``all_sum`` is the cross-client sum of the per-client statistics
    (identity serially): the distributed Rule-3 loop of round 4.  The stop
    test reads one scalar back per round, as the JAX package's
    ``while_loop`` tests it on the device."""
    if max_iters is None:
        max_iters = int(1.0 / nu) + 2
    for _ in range(max_iters):
        varsig = all_sum(torch.where(eta > nu, eta - nu, 0.0).sum(dim=-1))
        if not float(varsig.reshape(-1)[0]) > 1e-12:
            break
        omega = all_sum(torch.where(eta < nu, eta, 0.0).sum(dim=-1))
        scale = 1.0 + varsig / torch.clamp(omega, min=1e-30)
        eta = torch.where(eta >= nu, nu, eta * scale[..., None])
    return eta


def capped_entropy_prox(log_lam: torch.Tensor, v: torch.Tensor, gamma, tau,
                        d, nu: float) -> torch.Tensor:
    """nu-Saddle update: the entropy-prox step followed by the Rule-2
    projection; normalized log weights on the capped simplex D_n."""
    log_eta = entropy_prox(log_lam, v, gamma, tau, d)
    eta = capped_simplex_project_sorted(torch.exp(log_eta), nu)
    return torch.log(torch.clamp(eta, min=1e-38))
