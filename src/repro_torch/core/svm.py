"""Scikit-learn-style front end for Saddle-SVC, in PyTorch.

``SaddleSVC``    -- hard-margin SVM (HM-Saddle).
``SaddleNuSVC``  -- nu-SVM (nu-Saddle).

Both run Algorithm 1 (pre-processing) and Algorithm 2 (the saddle solver)
on ``device`` -- the hand-written CUDA kernels on the card (the default),
the plain PyTorch versions on the CPU -- and expose ``w_``, ``b_`` in the
ORIGINAL input space.  The offset uses the paper's footnote 2:
b* = w*^T (A eta* + B xi*) / 2.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import preprocess as pp
from repro_torch.core import saddle
from repro_torch.device import resolve_device


def split_classes(x: np.ndarray, y: np.ndarray):
    """Split (x, y in {+-1}) into the P (+1) and Q (-1) point matrices;
    fails fast on a single-class ``y``."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    xp, xm = x[y > 0], x[y < 0]
    if len(xp) == 0 or len(xm) == 0:
        raise ValueError(
            "y must contain both classes (+1 and -1): got "
            f"{len(xp)} positive and {len(xm)} negative points "
            f"(labels seen: {np.unique(y).tolist()})")
    return xp, xm


def recover_hyperplane(pre: pp.Preprocessed, eta: torch.Tensor,
                       xi: torch.Tensor, xp_t: torch.Tensor,
                       xm_t: torch.Tensor):
    """Map final dual weights to the input-space hyperplane: w = A eta -
    B xi in transformed space, b = w.(A eta + B xi)/2, and w mapped back
    through the orthonormal WD transform.  ``xp_t``/``xm_t`` may carry
    inert zero-padding columns beyond ``pre``'s dimensionality.

    Returns (w_orig numpy, b, objective, margin, w_t)."""
    a_eta = eta @ xp_t
    b_xi = xi @ xm_t
    w_t = a_eta - b_xi                     # optimal w = A eta - B xi
    b_t = torch.dot(w_t, a_eta + b_xi) / 2.0
    w = pp.recover_direction(w_t[: pre.signs.shape[0]], pre).cpu().numpy()
    return (w, float(b_t), float(0.5 * (w_t * w_t).sum()),
            float(torch.linalg.vector_norm(w_t)), w_t)


def _preprocess_seed(seed: int) -> int:
    """The seed of the preprocessing signs' generator: a stream apart from
    the solver's sampler, which ``seed`` itself drives (as the JAX front
    end splits its key)."""
    return int(np.random.SeedSequence(seed).generate_state(1, np.uint64)[0])


class SaddleSVC:
    """Hard-margin SVM via HM-Saddle (paper Sections 2-3)."""

    nu = 0.0

    def __init__(self, eps: float = 1e-3, beta: float = 0.1,
                 num_iters: int | None = None, block_size: int = 1,
                 seed: int = 0, record_every: int | None = None,
                 device: str | torch.device = "cuda"):
        self.eps = eps
        self.beta = beta
        self.num_iters = num_iters
        self.block_size = block_size
        self.seed = seed
        self.record_every = record_every
        self.device = device

    def _nu_for(self, n1: int, n2: int) -> float:
        return 0.0

    def fit(self, x: np.ndarray, y: np.ndarray, *, signs=None,
            idx_schedule=None) -> "SaddleSVC":
        """Fit on (x, y).  ``signs`` (the transform's +-1 diagonal) and
        ``idx_schedule`` (the solver's coordinate blocks) replace the
        seeded draws, to replay another run exactly."""
        dev = resolve_device(self.device)
        xp, xm = split_classes(x, y)
        n1, n2 = len(xp), len(xm)
        gen = torch.Generator().manual_seed(_preprocess_seed(self.seed))
        pre = pp.preprocess(xp, xm, generator=gen, signs=signs, device=dev)
        res = saddle.solve(
            pre.xp, pre.xm, eps=self.eps, beta=self.beta,
            nu=self._nu_for(n1, n2), num_iters=self.num_iters,
            block_size=self.block_size, seed=self.seed,
            record_every=self.record_every, idx_schedule=idx_schedule,
            device=dev)
        st = res.state
        self.history_ = res.history
        eta = torch.exp(st.log_eta)
        xi = torch.exp(st.log_xi)
        (self.w_, self.b_, self.objective_, self.margin_,
         _w_t) = recover_hyperplane(pre, eta, xi, pre.xp, pre.xm)
        self.eta_ = eta.cpu().numpy()
        self.xi_ = xi.cpu().numpy()
        self.state_ = st
        return self

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float32) @ self.w_ - self.b_

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.where(self.decision_function(x) >= 0, 1, -1)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))


class SaddleNuSVC(SaddleSVC):
    """nu-SVM via nu-Saddle.  ``alpha`` parameterizes the paper's
    experiment convention nu = 1 / (alpha * min(n1, n2))."""

    def __init__(self, nu: float | None = None, alpha: float = 0.85,
                 **kw):
        super().__init__(**kw)
        self._nu = nu
        self.alpha = alpha

    def _nu_for(self, n1: int, n2: int) -> float:
        if self._nu is not None:
            return self._nu
        return 1.0 / (self.alpha * min(n1, n2))
