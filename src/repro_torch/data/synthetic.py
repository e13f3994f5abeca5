"""Synthetic data sets of the paper's Appendix D (numpy only).

The port's own copy of the JAX package's generators, so that nothing of
the port needs the JAX package.  The same seed gives the same points:

  * separable      -- random hyperplane H through the unit ball; the
                      distance ratio to H is controlled by beta1; labels
                      by side of H.
  * non_separable  -- the same, with random labels inside the beta2 band.
  * sparse_non_separable -- non_separable with exactly nnz non-zero
                      coordinates a point.
  * blobs          -- two Gaussian blobs (quick fixtures for tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x: np.ndarray      # (n, d) float32
    y: np.ndarray      # (n,) in {+1, -1}

    def split(self, test_frac: float = 0.1, seed: int = 0):
        rng = np.random.default_rng(seed)
        n = len(self.y)
        perm = rng.permutation(n)
        k = int(n * (1.0 - test_frac))
        tr, te = perm[:k], perm[k:]
        return (Dataset(self.x[tr], self.y[tr]),
                Dataset(self.x[te], self.y[te]))


def _hyperplane(rng, d):
    w = rng.normal(size=d)
    return w / np.linalg.norm(w)


def separable(n: int, d: int, *, beta1: float = 0.1,
              seed: int = 0) -> Dataset:
    """Linearly separable set with margin/diameter ratio ~= beta1."""
    rng = np.random.default_rng(seed)
    w = _hyperplane(rng, d)
    # directions in the ball, then each point pushed away from H so that
    # distances lie in [beta1 * R, R] with R chosen to fit the ball
    x = rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= rng.uniform(0.0, 1.0, size=(n, 1)) ** (1.0 / d)
    side = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    r_max = 0.5
    dist = rng.uniform(beta1 * r_max, r_max, size=n)
    proj = x - np.outer(x @ w, w)                # component parallel to H
    proj *= 0.5                                  # keep inside the ball
    x = proj + np.outer(side * dist, w)
    y = side.astype(np.int64)
    return Dataset(x.astype(np.float32), y)


def non_separable(n: int, d: int, *, beta2: float = 0.1,
                  seed: int = 0) -> Dataset:
    """Separable construction + random labels inside the beta2 band."""
    rng = np.random.default_rng(seed)
    w = _hyperplane(rng, d)
    x = rng.normal(size=(n, d))
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    x *= rng.uniform(0.0, 1.0, size=(n, 1)) ** (1.0 / d)
    signed = x @ w
    y = np.where(signed > 0, 1, -1)
    band = np.abs(signed) < beta2 * 0.5
    flips = rng.random(n) < 0.5
    y = np.where(band & flips, -y, y).astype(np.int64)
    return Dataset(x.astype(np.float32), y)


def sparse_non_separable(n: int, d: int, *, nnz: int, beta2: float = 0.1,
                         seed: int = 0) -> Dataset:
    """Each point has exactly ``nnz`` non-zero coordinates."""
    rng = np.random.default_rng(seed)
    ds = non_separable(n, d, beta2=beta2, seed=seed)
    x = ds.x.copy()
    for i in range(n):
        keep = rng.choice(d, size=nnz, replace=False)
        mask = np.zeros(d, bool)
        mask[keep] = True
        x[i, ~mask] = 0.0
    return Dataset(x, ds.y)


def blobs(n1: int, n2: int, d: int, *, gap: float = 1.0,
          spread: float = 0.3, seed: int = 0) -> Dataset:
    """Two Gaussian blobs."""
    rng = np.random.default_rng(seed)
    c = np.zeros(d)
    c[0] = gap / 2
    xp = rng.normal(size=(n1, d)) * spread + c
    xm = rng.normal(size=(n2, d)) * spread - c
    x = np.vstack([xp, xm]).astype(np.float32)
    y = np.concatenate([np.ones(n1), -np.ones(n2)]).astype(np.int64)
    return Dataset(x, y)
