"""Saddle-SVC (Algorithm 2) in PyTorch: the stochastic primal--dual
coordinate solver for HM-Saddle (hard-margin SVM) and nu-Saddle (nu-SVM).

Counterpart of ``repro.core.saddle``.  User-facing point matrices are
row-major, ``xp[i] = x_i^+`` (n1, d); the solver runs on the packed layout
of :func:`repro_torch.core.preprocess.pack_points` and unpacks its final
state into the per-class :class:`SaddleState`.  :func:`solve` is the slot
driver of :mod:`repro_torch.core.engine` at S = 1.

The unpacked reference step -- :func:`init_state`, :func:`saddle_step`,
:func:`run_chunk` -- runs on the per-class state itself, as the JAX
package keeps it for the parity tests; there ``device`` takes the place
of ``use_kernels``: the kernels run on the card, the plain versions on
the CPU, so :func:`saddle_step` is the port of both the JAX
``saddle_step`` and ``saddle_step_kernels``.

With ``block_size=1`` this is exactly Algorithm 2; ``block_size=B > 1``
updates B coordinates per iteration, sampled without replacement so the
rank-B update of u stays exact.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core import preprocess as pp
from repro_torch.device import resolve_device


class SaddleParams(NamedTuple):
    gamma: float
    q: float
    tau: float
    sigma: float
    theta: float
    d: int
    block_size: int
    nu: float          # 0.0 => HM-Saddle (no cap)


class SaddleState(NamedTuple):
    w: torch.Tensor            # (d,)
    log_eta: torch.Tensor      # (n1,)
    log_eta_prev: torch.Tensor
    log_xi: torch.Tensor       # (n2,)
    log_xi_prev: torch.Tensor
    u_p: torch.Tensor          # (n1,)  <w, x_i^+> maintained incrementally
    u_m: torch.Tensor          # (n2,)
    t: torch.Tensor            # iteration counter


def make_params(n: int, d: int, eps: float, beta: float,
                nu: float = 0.0, block_size: int = 1,
                block_scaling: str = "lane") -> SaddleParams:
    """Line 4 of Algorithm 1 (with q = O(sqrt(log n))).  For block_size
    > 1, "lane" keeps the paper's (tau, sigma, theta); "scaled" rescales
    with d_eff = d / B."""
    if not 1 <= block_size <= d:
        raise ValueError(
            f"block_size={block_size} must be in [1, d={d}] (blocks are "
            "sampled without replacement)")
    gamma = eps * beta / (2.0 * math.log(max(n, 3)))
    q = max(1.0, math.sqrt(math.log(max(n, 3))))
    d_eff = d / block_size if block_scaling == "scaled" else d
    tau = 0.5 / q * math.sqrt(d_eff / gamma)
    sigma = 0.5 / q * math.sqrt(d_eff * gamma)
    theta = 1.0 - 1.0 / (d_eff + q * math.sqrt(d_eff) / math.sqrt(gamma))
    return SaddleParams(gamma=gamma, q=q, tau=tau, sigma=sigma, theta=theta,
                        d=d, block_size=block_size, nu=float(nu))


def default_iterations(d: int, eps: float, beta: float,
                       n: int = 1000) -> int:
    """Theorem 6 iteration count: O~(d + sqrt(d / (eps * beta)))."""
    logn = math.log(max(n, 3))
    return int(2 * (d + math.sqrt(2.0 * d / (eps * beta)) * logn))


def validate_nu(nu: float, n1: int, n2: int) -> None:
    """The nu-SVM cap is feasible only when nu >= 1/min(n1, n2)."""
    if nu > 0.0 and nu * min(n1, n2) < 1.0:
        raise ValueError(
            f"nu={nu} infeasible: need nu >= 1/min(n1,n2) = {1.0/min(n1,n2)}")


def resolve_num_iters(num_iters: int | None, d: int, eps: float,
                      beta: float, n: int, block_size: int) -> int:
    """The iteration budget in steps: the default budget when none is
    given, divided by the block size."""
    if num_iters is None:
        num_iters = default_iterations(d, eps, beta, n)
    return max(1, num_iters // block_size)


def init_state(n1: int, n2: int, d: int, xp=None, *,
               device: str | torch.device | None = None) -> SaddleState:
    """Line 5 of Algorithm 1: w = 0, eta = 1/n1, xi = 1/n2 (two copies),
    u = 0 because w = 0.  The state lies on ``xp``'s device when ``xp``
    is a tensor, else on ``device``."""
    dev = (xp.device if isinstance(xp, torch.Tensor)
           else resolve_device(device))
    log_eta = torch.full((n1,), -math.log(n1), dtype=torch.float32,
                         device=dev)
    log_xi = torch.full((n2,), -math.log(n2), dtype=torch.float32,
                        device=dev)
    return SaddleState(
        w=torch.zeros((d,), dtype=torch.float32, device=dev),
        log_eta=log_eta, log_eta_prev=log_eta.clone(),
        log_xi=log_xi, log_xi_prev=log_xi.clone(),
        u_p=torch.zeros((n1,), dtype=torch.float32, device=dev),
        u_m=torch.zeros((n2,), dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev))


def saddle_step(state: SaddleState, xp: torch.Tensor, xm: torch.Tensor,
                p: SaddleParams, *, idx: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> SaddleState:
    """One iteration of Algorithm 2 (the engine's reference step); the
    block ``idx`` (b,) is drawn from ``generator`` when not given."""
    return engine.step(state, xp, xm, p, idx=idx, generator=generator)



def run_chunk(state: SaddleState, xp: torch.Tensor, xm: torch.Tensor,
              params: SaddleParams, num_steps: int, *, idx_schedule=None,
              generator: torch.Generator | None = None) -> SaddleState:
    """Run exactly ``num_steps`` REFERENCE (unpacked) iterations, with the
    coordinate blocks ``idx_schedule`` (num_steps, b) or drawn from
    ``generator``.  Solves should use :func:`solve`, the packed step."""
    idx = (None if idx_schedule is None else
           _schedule(idx_schedule, num_steps, params.d, params.block_size,
                     xp.device)[:, 0])
    state, _ = engine.chunk_body(state, xp, xm, params, num_steps, idx=idx,
                                 generator=generator)
    return state


def objective(log_eta: torch.Tensor, log_xi: torch.Tensor, xp: torch.Tensor,
              xm: torch.Tensor) -> torch.Tensor:
    """C-Hull / RC-Hull objective 0.5 * ||A eta - B xi||^2."""
    diff = torch.exp(log_eta) @ xp - torch.exp(log_xi) @ xm
    return 0.5 * (diff * diff).sum()


def _capped_min(scores: torch.Tensor, nu: float) -> torch.Tensor:
    """min over the capped simplex of <scores, eta>: greedily put nu on
    the smallest scores."""
    n = scores.shape[0]
    s = torch.sort(scores).values
    k = int(math.floor(1.0 / nu))
    weights = torch.where(torch.arange(n, device=s.device) < k,
                          torch.full_like(s, nu), torch.zeros_like(s))
    weights[min(k, n - 1)] += max(1.0 - k * nu, 0.0)
    return torch.dot(s, weights)


def saddle_gap(state: SaddleState, xp: torch.Tensor, xm: torch.Tensor,
               nu: float = 0.0) -> torch.Tensor:
    """g(w) = min_{eta,xi} w^T A eta - w^T B xi - ||w||^2 / 2."""
    sp = xp @ state.w
    sm = xm @ state.w
    if nu <= 0.0:
        inner = sp.min() - sm.max()
    else:
        inner = _capped_min(sp, nu) - (-_capped_min(-sm, nu))
    return inner - 0.5 * (state.w * state.w).sum()


def unpack_state(pstate: engine.PackedState, n1: int,
                 n2: int) -> SaddleState:
    """Slice a packed solver state back into the per-class view."""
    return engine.unpack_state(pstate, n1, n2, SaddleState)


# Duality-gap checking cadence when gap_tol > 0 and no record_every is
# given (the JAX package's value, so both packages check at the same
# iterations).
GAP_CHECK_EVERY = 256


class SolveResult(NamedTuple):
    state: SaddleState
    history: list            # [(iteration, objective)]


def _warm_packed(warm_start, pts: pp.PackedPoints, n1: int, n2: int,
                 d: int) -> engine.PackedState:
    """Packed warm-start state from a previous per-class state (the port's
    SaddleState, or the JAX package's given as arrays)."""
    ws = convert.to_numpy(warm_start)
    n1_w, n2_w = ws["log_eta"].shape[0], ws["log_xi"].shape[0]
    lam_old = np.concatenate([ws["log_eta"], ws["log_xi"]])
    prev_old = np.concatenate([ws["log_eta_prev"], ws["log_xi_prev"]])
    lam = pp.repack_warm_duals(lam_old, n1_w, n2_w, n1, n2, pts.n_pad)
    prev = pp.repack_warm_duals(prev_old, n1_w, n2_w, n1, n2, pts.n_pad)
    w = np.zeros((d,), np.float32)
    w[: ws["w"].shape[0]] = ws["w"]
    dev = pts.x_t.device
    return engine.warm_packed_state(
        pts.x_t, torch.as_tensor(w, device=dev),
        torch.as_tensor(lam, device=dev), torch.as_tensor(prev, device=dev))


def _schedule(idx_schedule, num_iters: int, d: int, block_size: int,
              device: torch.device) -> torch.Tensor:
    """Validate an injected (num_iters, block_size) coordinate schedule and
    stage it as the (num_iters, 1, b) int32 tensor the slot driver reads."""
    idx = convert.to_numpy_array(idx_schedule)
    if idx.shape != (num_iters, block_size):
        raise ValueError(f"idx_schedule must have shape ({num_iters}, "
                         f"{block_size}), got {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= d):
        raise ValueError(f"idx_schedule entries must lie in [0, {d})")
    srt = np.sort(idx, axis=1)
    if block_size > 1 and (srt[:, 1:] == srt[:, :-1]).any():
        raise ValueError("idx_schedule rows must hold distinct coordinates")
    return torch.as_tensor(idx.astype(np.int32), device=device)[:, None, :]


def solve(xp, xm, *, eps: float = 1e-3, beta: float = 0.1, nu: float = 0.0,
          num_iters: int | None = None, block_size: int = 1, seed: int = 0,
          record_every: int | None = None, n_pad: int | None = None,
          d_pad: int | None = None, gap_tol: float = 0.0,
          driver: str = "device", warm_start=None, idx_schedule=None,
          device: str | torch.device | None = None) -> SolveResult:
    """Run Saddle-SVC on (already preprocessed) data.

    Args:
      xp, xm: (n1, d), (n2, d) transformed point matrices (tensors or
        arrays); they are moved to ``device``.
      nu: 0 for hard margin; else the nu-SVM cap (>= 1/min(n1, n2)).
      n_pad, d_pad: optional bucket shape (see preprocess.bucket_shape).
      gap_tol: relative duality-gap early stop, checked at chunk
        boundaries (0 disables).  With gap_tol > 0 and no record_every the
        chunk defaults to GAP_CHECK_EVERY iterations.
      driver: "device" or "host", accepted for parity with the JAX
        package (where "host" is the per-chunk oracle of its on-device
        loop).  Both run :func:`engine.run_solve_slots`, which is already
        a host loop over chunks that reads nothing back inside a chunk.
      warm_start: a previous per-class state (this package's SaddleState,
        or the JAX package's as arrays, see :mod:`repro_torch.convert`)
        of a prefix of this problem; the solve starts from its w and
        duals, with u recomputed and t = 0.
      idx_schedule: optional (num_iters, block_size) coordinate schedule
        (in steps, after the block-size division) that replaces the
        sampler, e.g. the JAX package's, replayed for parity.
      device: "cuda" (default: the hand-written kernels) or "cpu" (the
        plain PyTorch versions).

    The step's random coordinates come from a ``torch.Generator`` on the
    device seeded with ``seed``.
    """
    dev = resolve_device(device)
    xp = pp.as_f32(xp, dev)
    xm = pp.as_f32(xm, dev)
    n1, d = xp.shape
    n2 = xm.shape[0]
    validate_nu(nu, n1, n2)
    if driver not in ("device", "host"):
        raise ValueError(f"driver={driver!r} must be 'device' or 'host'")
    if d_pad is not None:
        d = d_pad
    params = make_params(n1 + n2, d, eps, beta, nu=nu, block_size=block_size)
    num_iters = resolve_num_iters(num_iters, d, eps, beta, n1 + n2,
                                  block_size)
    check_gap = gap_tol > 0.0
    if record_every is None and check_gap:
        record_every = GAP_CHECK_EVERY   # else the gap never fires
    chunk = min(record_every or num_iters, num_iters)
    idx = (None if idx_schedule is None else
           _schedule(idx_schedule, num_iters, d, block_size, dev))

    pts = pp.pack_points_to(xp, xm, n_pad or pp.packed_length(n1 + n2), d)
    if warm_start is None:
        pstate = engine.init_packed_state(pts.sign, n1, n2, d)
    else:
        pstate = _warm_packed(warm_start, pts, n1, n2, d)
    sstate = engine.init_slot_state(1, pts.n_pad, d, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sstate = engine.admit_into_slot(sstate, 0, pstate, gen, num_iters)
    sp = engine.stack_slot_params([engine.slot_params_row(params, gap_tol)],
                                  dev)
    sstate, objs_d, marks_d, _nc = engine.run_solve_slots(
        sstate, pts.x_t[None], pts.sign[None], sp, num_iters,
        chunk_steps=chunk, num_chunks=-(-num_iters // chunk), d=d,
        block_size=block_size, project=nu > 0.0, check_gap=check_gap,
        idx=idx)
    objs = [float(o) for o in objs_d[:, 0].tolist()]
    marks = [int(m) for m in marks_d[:, 0].tolist()]
    pstate = engine.PackedState(
        w=sstate.w[0], log_lam=sstate.log_lam[0],
        log_lam_prev=sstate.log_lam_prev[0], u=sstate.u[0], t=sstate.t[0])
    return SolveResult(state=unpack_state(pstate, n1, n2),
                       history=list(zip(marks, objs)))
