"""Distributed Gilbert algorithm (Liu et al.) -- the prior-art
distributed hard-margin baseline with O(kd / eps) communication.

Protocol per iteration (server/clients):
  1. server broadcasts the current point z           (k * d scalars)
  2. each client scans its local points and returns its best support
     candidates a_i* (argmin <z, a>) and b_j* (argmax <z, b>)
                                                     (k * 2d scalars)
  3. server picks the global extrema, line-searches, updates z (local)

So each iteration costs 3kd scalars -- contrast with Saddle-DSVC's O(k).
Implemented over stacked (k, m, d) client shards with masks (the k
clients simulated on one device, with the same partitioning helper as
Saddle-DSVC).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.baselines.gilbert import line_search, row
from repro_torch.core.distributed import shard_points
from repro_torch.core.preprocess import as_f32
from repro_torch.device import resolve_device


class DistGilbertState(NamedTuple):
    z: torch.Tensor
    t: torch.Tensor       # int32 iteration count


def run_chunk(state: DistGilbertState, xp_sh: torch.Tensor,
              mask_p: torch.Tensor, xm_sh: torch.Tensor,
              mask_m: torch.Tensor, num_steps: int) -> DistGilbertState:
    for _ in range(num_steps):
        z = state.z
        # each client: local candidates (masked scan)
        sp = torch.where(mask_p, xp_sh @ z, torch.inf)
        sm = torch.where(mask_m, xm_sh @ z, -torch.inf)
        # server: the client with the global extremum, then its point
        ip = torch.argmin(sp.amin(dim=1))
        jp = torch.argmin(row(sp, ip))
        im = torch.argmax(sm.amax(dim=1))
        jm = torch.argmax(row(sm, im))
        v = row(row(xp_sh, ip), jp) - row(row(xm_sh, im), jm)
        t_step = line_search(z, v)
        state = DistGilbertState(z=(1 - t_step) * z + t_step * v,
                                 t=state.t + 1)
    return state


def shard_problem(xp, xm, k: int, device: torch.device) -> tuple:
    """Both classes' round-robin (k, m, d) shards and (k, m) masks
    (``distributed.shard_points``), on ``device``."""
    out = []
    for x in (xp, xm):
        x_sh, mask = shard_points(as_f32(x, torch.device("cpu")).numpy(), k)
        out += [as_f32(x_sh, device), torch.as_tensor(mask, device=device)]
    return tuple(out)


def init_state(xp_sh: torch.Tensor, xm_sh: torch.Tensor) -> DistGilbertState:
    return DistGilbertState(z=xp_sh[0, 0] - xm_sh[0, 0],
                            t=torch.zeros((), dtype=torch.int32,
                                          device=xp_sh.device))


class CommModel(NamedTuple):
    k: int
    d: int

    def scalars_per_iteration(self) -> float:
        return 3.0 * self.k * self.d

    def total(self, iters: int) -> float:
        return self.scalars_per_iteration() * iters


def solve(xp, xm, *, k: int = 20, num_iters: int = 1000,
          record_every: int | None = None,
          device: str | torch.device | None = None):
    """Returns (state, [(iteration, scalars sent, 0.5 ||z||^2)],
    CommModel), read once a chunk."""
    dev = resolve_device(device)
    xp_sh, mask_p, xm_sh, mask_m = shard_problem(xp, xm, k, dev)
    state = init_state(xp_sh, xm_sh)
    comm = CommModel(k=k, d=xp_sh.shape[2])
    history = []
    chunk = record_every or num_iters
    done = 0
    while done < num_iters:
        ns = min(chunk, num_iters - done)
        state = run_chunk(state, xp_sh, mask_p, xm_sh, mask_m, ns)
        done += ns
        obj = float(0.5 * torch.sum(state.z ** 2))
        history.append((done, comm.total(done), obj))
    return state, history, comm
