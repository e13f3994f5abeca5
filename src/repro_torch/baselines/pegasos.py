"""Pegasos: primal stochastic sub-gradient solver for C-SVM (hinge loss +
l2), the LinearSVC / primal-SGD stand-in.

    min_w  lambda/2 ||w||^2 + (1/n) sum_i max(0, 1 - y_i w.x_i)

Mini-batch variant with the 1/(lambda t) step size and the optional
1/sqrt(lambda) ball projection from the paper.

The JAX package draws each step's batch from ``jax.random``; here one
``torch.Generator`` on the solve's device, seeded by ``seed``, draws the
whole (num_iters, batch) schedule (:func:`draw_schedule`), and
``solve(idx_schedule=)`` replays a given one instead (JAX's draws in the
tests, the card's on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import to_numpy_array
from repro_torch.core.preprocess import as_f32
from repro_torch.device import resolve_device


class PegasosState(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor
    t: torch.Tensor       # float iteration count


def draw_schedule(n: int, shape: tuple, seed: int,
                  device: str | torch.device | None = None) -> torch.Tensor:
    """Point indices in [0, n) of the given shape (steps first), drawn by a
    generator on ``device`` seeded by ``seed``: what ``solve`` draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, n, shape, generator=gen, device=dev)


def schedule(idx_schedule, shape: tuple, n: int, seed: int,
             dev: torch.device) -> torch.Tensor:
    """The solve's draws: ``idx_schedule`` (validated) when given, else
    :func:`draw_schedule`'s."""
    if idx_schedule is None:
        return draw_schedule(n, shape, seed, dev)
    idx = to_numpy_array(idx_schedule)
    if idx.shape != shape:
        raise ValueError(f"idx_schedule must have shape {shape}, got "
                         f"{idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"idx_schedule entries must lie in [0, {n})")
    return torch.as_tensor(idx.astype(np.int64), device=dev)


def run_chunk(state: PegasosState, idx: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor, lam: float) -> PegasosState:
    """One step for each row of the (num_steps, batch) draws ``idx``."""
    batch = idx.shape[1]
    sqrt_lam = torch.sqrt(torch.tensor(lam, device=x.device))
    for ib in idx:
        xb, yb = x.index_select(0, ib), y.index_select(0, ib)
        margin = yb * (xb @ state.w - state.b)
        viol = (margin < 1.0).to(torch.float32)
        step = 1.0 / (lam * (state.t + 1.0))
        grad_w = lam * state.w - (viol * yb) @ xb / batch
        grad_b = torch.sum(viol * yb) / batch
        w = state.w - step * grad_w
        b = state.b - step * grad_b
        # optional projection onto the 1/sqrt(lam) ball
        norm = torch.linalg.vector_norm(w)
        w = w * torch.clamp(1.0 / (sqrt_lam * norm + 1e-30), max=1.0)
        state = PegasosState(w, b, state.t + 1.0)
    return state


def solve(x, y, *, lam: float = 1e-3, batch: int = 32,
          num_iters: int = 2000, seed: int = 0,
          record_every: int | None = None, idx_schedule=None,
          device: str | torch.device | None = None):
    """Returns (state, [(iteration, objective, training accuracy)]), read
    once a chunk.  ``idx_schedule``: (num_iters, batch) point indices that
    replace the draws."""
    dev = resolve_device(device)
    x, y = as_f32(x, dev), as_f32(y, dev)
    idx = schedule(idx_schedule, (num_iters, batch), x.shape[0], seed, dev)
    state = PegasosState(torch.zeros(x.shape[1], device=dev),
                         torch.zeros((), device=dev),
                         torch.zeros((), device=dev))
    history = []
    chunk = record_every or num_iters
    done = 0
    while done < num_iters:
        ns = min(chunk, num_iters - done)
        state = run_chunk(state, idx[done:done + ns], x, y, float(lam))
        done += ns
        margin = y * (x @ state.w - state.b)
        obj = (0.5 * lam * torch.sum(state.w ** 2)
               + torch.mean(torch.clamp(1.0 - margin, min=0.0)))
        acc = torch.mean((margin > 0).to(torch.float32))
        history.append((done, float(obj), float(acc)))
    return state, history


def predict(state: PegasosState, x) -> np.ndarray:
    s = to_numpy_array(as_f32(x, state.w.device) @ state.w - state.b)
    return np.where(s >= 0, 1, -1)
