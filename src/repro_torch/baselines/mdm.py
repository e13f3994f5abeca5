"""MDM (Mitchell--Demyanov--Malozemov) for the min-norm-point problem
over a single polytope conv{p_1..p_n} -- the related-work baseline
analyzed by Lopez & Dorronsoro (O(n^2 d log 1/eps)).

Each iteration moves weight from the *support* vertex most aligned with
z to the vertex least aligned with z (a pairwise exchange), with an
exact line search.  For the two-class SVM experiments the paper's
baseline is Gilbert; MDM is validated against Gilbert on min-norm-point
instances (see tests).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.baselines.gilbert import row
from repro_torch.core.preprocess import as_f32
from repro_torch.device import resolve_device


class MDMState(NamedTuple):
    lam: torch.Tensor     # (n,) convex weights
    z: torch.Tensor       # (d,) = P^T lam
    t: torch.Tensor       # int32 iteration count


def init_state(points: torch.Tensor) -> MDMState:
    n = points.shape[0]
    lam = torch.full((n,), 1.0 / n, device=points.device)
    return MDMState(lam=lam, z=lam @ points,
                    t=torch.zeros((), dtype=torch.int32,
                                  device=points.device))


def mdm_step(state: MDMState, points: torch.Tensor) -> MDMState:
    z, lam = state.z, state.lam
    scores = points @ z                           # (n,)
    # worst support vertex (max score among lam > 0), best overall (min).
    masked = torch.where(lam > 1e-12, scores,
                         torch.full_like(scores, -torch.inf))
    i_max = torch.argmax(masked).reshape(1)
    i_min = torch.argmin(scores).reshape(1)
    diff = row(points, i_min[0]) - row(points, i_max[0])   # transfer
    denom = torch.sum(diff * diff)
    t_unc = torch.where(denom > 1e-30, -torch.dot(z, diff) / denom,
                        torch.zeros_like(denom))
    # cannot exceed the donor's mass
    t_step = torch.minimum(torch.clamp(t_unc, min=0.0),
                           lam.index_select(0, i_max)[0]).reshape(1)
    # the donor first, then the receiver (the same entry when i_max == i_min)
    lam = lam.index_add(0, i_max, -t_step).index_add_(0, i_min, t_step)
    return MDMState(lam=lam, z=z + t_step * diff, t=state.t + 1)


def run_chunk(state: MDMState, points: torch.Tensor,
              num_steps: int) -> MDMState:
    for _ in range(num_steps):
        state = mdm_step(state, points)
    return state


def solve(points, *, num_iters: int = 1000,
          record_every: int | None = None,
          device: str | torch.device | None = None):
    """Returns (state, [(iteration, 0.5 ||z||^2)]), read once a chunk."""
    dev = resolve_device(device)
    points = as_f32(points, dev)
    state = init_state(points)
    chunk = record_every or num_iters
    history = []
    done = 0
    while done < num_iters:
        ns = min(chunk, num_iters - done)
        state = run_chunk(state, points, ns)
        done += ns
        history.append((done, float(0.5 * torch.sum(state.z ** 2))))
    return state, history
