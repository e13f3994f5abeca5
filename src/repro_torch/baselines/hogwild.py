"""HOGWILD!-style asynchronous SGD for C-SVM -- semantic port.

True HOGWILD! relies on lock-free shared-memory races between CPU
threads; a single device stream has no analogue.  We implement the
standard *stale-gradient simulation*: k workers each compute a
hinge-loss gradient against a parameter snapshot that is ``staleness``
updates old, and the server applies the k updates sequentially.
Communication per round: each worker ships a gradient (d scalars) and
reads w back (d scalars) -> 2kd scalars, the quantity plotted against
Saddle-DSVC's O(k) in Figure 6.

Draws as in :mod:`repro_torch.baselines.pegasos`: one generator on the
device draws the (num_iters, k, batch) schedule, or ``idx_schedule``
replays one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.baselines.pegasos import schedule
from repro_torch.core.preprocess import as_f32
from repro_torch.device import resolve_device


class HogwildState(NamedTuple):
    w: torch.Tensor          # (d,) current
    w_stale: torch.Tensor    # (d,) snapshot workers read
    b: torch.Tensor
    t: torch.Tensor          # float iteration count


def run_chunk(state: HogwildState, idx: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor, lam: float, staleness: int) -> HogwildState:
    """One round for each (k, batch) block of the draws ``idx``
    (num_steps, k, batch)."""
    k, batch = idx.shape[1], idx.shape[2]
    for ib in idx:
        # k workers compute gradients against the stale snapshot
        xb = x[ib]                       # (k, batch, d)
        yb = y[ib]
        margin = yb * (torch.einsum("kbd,d->kb", xb, state.w_stale)
                       - state.b)
        viol = (margin < 1.0).to(torch.float32)
        gw = lam * state.w_stale - torch.einsum("kb,kbd->kd", viol * yb,
                                                xb) / batch
        gb = torch.sum(viol * yb, dim=1) / batch
        step = 1.0 / (lam * (state.t + 1.0))
        # server applies the k updates sequentially (sum)
        w = state.w - step * torch.sum(gw, dim=0) / k
        b = state.b - step * torch.sum(gb) / k
        # snapshot refresh every `staleness` rounds
        refresh = torch.remainder(state.t, staleness) == staleness - 1
        w_stale = torch.where(refresh, w, state.w_stale)
        state = HogwildState(w, w_stale, b, state.t + 1.0)
    return state


class CommModel(NamedTuple):
    k: int
    d: int

    def scalars_per_iteration(self) -> float:
        return 2.0 * self.k * self.d

    def total(self, iters: int) -> float:
        return self.scalars_per_iteration() * iters


def solve(x, y, *, k: int = 20, lam: float = 1e-3, batch: int = 8,
          staleness: int = 4, num_iters: int = 2000, seed: int = 0,
          record_every: int | None = None, idx_schedule=None,
          device: str | torch.device | None = None):
    """Returns (state, [(iteration, scalars sent, training accuracy)],
    CommModel), read once a chunk.  ``idx_schedule``: (num_iters, k,
    batch) point indices that replace the draws."""
    dev = resolve_device(device)
    x, y = as_f32(x, dev), as_f32(y, dev)
    d = x.shape[1]
    idx = schedule(idx_schedule, (num_iters, k, batch), x.shape[0], seed,
                   dev)
    state = HogwildState(torch.zeros(d, device=dev),
                         torch.zeros(d, device=dev),
                         torch.zeros((), device=dev),
                         torch.zeros((), device=dev))
    comm = CommModel(k=k, d=d)
    history = []
    chunk = record_every or num_iters
    done = 0
    while done < num_iters:
        ns = min(chunk, num_iters - done)
        state = run_chunk(state, idx[done:done + ns], x, y, float(lam),
                          staleness)
        done += ns
        margin = y * (x @ state.w - state.b)
        acc = float(torch.mean((margin > 0).to(torch.float32)))
        history.append((done, comm.total(done), acc))
    return state, history, comm
