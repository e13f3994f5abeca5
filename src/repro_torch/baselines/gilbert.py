"""Gilbert's algorithm for the polytope distance / C-Hull problem, as
analyzed for hard-margin SVM by Gartner & Jaggi.

We seek the min-norm point of the Minkowski-difference polytope
S = conv{x_i^+} (-) conv{x_j^-}.  Gilbert iterates:

    z_t            current point (= A eta - B xi, weights maintained)
    v_t            support vertex: argmin_{s in S} <z_t, s>
                   = a_{i*} - b_{j*},  i* = argmin_i <z, a_i>,
                                       j* = argmax_j <z, b_j>
    z_{t+1}        nearest point to origin on segment [z_t, v_t]

Each iteration is O(nd) (the two argext scans) -- the paper's stated
O(nd / eps beta^2) total.  The convex weights (eta, xi) are carried so
the SVM (w, b, margin) can be reported exactly like Saddle-SVC.  Ties
of the scans go to the first index, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.preprocess import as_f32
from repro_torch.device import resolve_device


class GilbertState(NamedTuple):
    z: torch.Tensor       # (d,) current point of S
    eta: torch.Tensor     # (n1,)
    xi: torch.Tensor      # (n2,)
    t: torch.Tensor       # int32 iteration count


def row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d index tensor) of ``x``, read on the device."""
    return x.index_select(0, i.reshape(1))[0]


def line_search(z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The step to the point of segment [z, v] nearest the origin, in
    [0, 1]; 0 where the segment is a point."""
    dzv = z - v
    denom = torch.sum(dzv * dzv)
    t_step = torch.clamp(torch.dot(z, dzv) / denom, 0.0, 1.0)
    return torch.where(denom > 1e-30, t_step, 0.0)


def init_state(xp: torch.Tensor, xm: torch.Tensor) -> GilbertState:
    eta = torch.zeros(xp.shape[0], device=xp.device)
    xi = torch.zeros(xm.shape[0], device=xm.device)
    eta[0] = 1.0
    xi[0] = 1.0
    return GilbertState(z=xp[0] - xm[0], eta=eta, xi=xi,
                        t=torch.zeros((), dtype=torch.int32,
                                      device=xp.device))


def gilbert_step(state: GilbertState, xp: torch.Tensor,
                 xm: torch.Tensor) -> GilbertState:
    z = state.z
    i_star = torch.argmin(xp @ z)
    j_star = torch.argmax(xm @ z)
    v = row(xp, i_star) - row(xm, j_star)
    t_step = line_search(z, v)
    keep = 1.0 - t_step
    z_new = keep * z + t_step * v
    # scale first, then add the step at the chosen vertex
    t1 = t_step.reshape(1)
    eta = (keep * state.eta).index_add_(0, i_star.reshape(1), t1)
    xi = (keep * state.xi).index_add_(0, j_star.reshape(1), t1)
    return GilbertState(z=z_new, eta=eta, xi=xi, t=state.t + 1)


def run_chunk(state: GilbertState, xp: torch.Tensor, xm: torch.Tensor,
              num_steps: int) -> GilbertState:
    for _ in range(num_steps):
        state = gilbert_step(state, xp, xm)
    return state


class GilbertResult(NamedTuple):
    state: GilbertState
    history: list          # [(iter, objective)]


def solve(xp, xm, *, num_iters: int = 1000, tol: float = 0.0,
          record_every: int | None = None,
          device: str | torch.device | None = None) -> GilbertResult:
    """``num_iters`` Gilbert iterations in chunks of ``record_every``; the
    objective 0.5 ||z||^2 is read once a chunk, and with ``tol`` > 0 the
    solve stops after a chunk that lowered it by less than ``tol``."""
    dev = resolve_device(device)
    xp, xm = as_f32(xp, dev), as_f32(xm, dev)
    state = init_state(xp, xm)
    chunk = record_every or num_iters
    history = []
    done = 0
    prev_obj = float("inf")
    while done < num_iters:
        ns = min(chunk, num_iters - done)
        state = run_chunk(state, xp, xm, ns)
        done += ns
        obj = objective(state)
        history.append((done, obj))
        if tol > 0.0 and prev_obj - obj < tol:
            break
        prev_obj = obj
    return GilbertResult(state=state, history=history)


def objective(state: GilbertState) -> float:
    return float(0.5 * torch.sum(state.z ** 2))
