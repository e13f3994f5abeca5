"""Pre-processing for Saddle-SVC (Algorithm 1 of the paper), in PyTorch.

Counterpart of ``repro.core.preprocess``:

  1. scale all points by 1/max_i ||x_i||  (footnote 3),
  2. apply the randomized Walsh--Hadamard transform ``WD`` so that every
     coordinate of every point is O(sqrt(log n / d)) with high
     probability, which makes uniform coordinate sampling effective.

``W`` is the normalized d x d Walsh--Hadamard matrix (W W^T = I) and ``D``
a random +-1 diagonal, so the map is orthonormal and ``w`` maps back by
the inverse transform.  Dimensions that are not a power of two are
zero-padded.  The transform runs through :func:`repro_torch.kernels.ops.fwht`:
the CUDA kernel on the card, the plain version on the CPU.

The packed layout (:func:`pack_points`) is the solver's view of the data:
both classes in one lane-padded point set, stored column-major as
``x_t`` (d, n_pad), with a +-1/0 sign vector.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

LANE = 128  # packed point counts are padded to this (the kernels' tile)
NEG_INF = -1e30  # log weight of padding points (engine.NEG_INF)


def next_pow2(d: int) -> int:
    p = 1
    while p < d:
        p *= 2
    return p


def fwht(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Fast Walsh--Hadamard transform along the LAST axis (a power of
    two) of a vector or of the rows of a matrix."""
    return ops.fwht(x, normalize=normalize)


def packed_length(n: int, lane: int = LANE) -> int:
    """Smallest multiple of ``lane`` >= n (at least ``lane``)."""
    return max(-(-n // lane), 1) * lane


def bucket_length(n: int, lane: int = LANE) -> int:
    """The pow-2 bucket ladder of the point axis, ``lane * 2^k``: the
    smallest rung >= n (at most 2x padding, O(log n) distinct shapes)."""
    return lane * next_pow2(max(-(-n // lane), 1))


def bucket_shape(n: int, d: int) -> tuple[int, int]:
    """(n_bucket, d_bucket) for a problem with n points in d dims."""
    return bucket_length(n), next_pow2(d)


class PackedPoints(NamedTuple):
    """Both classes packed into ONE lane-padded operand.

    Slots ``[0, n1)`` hold the +1 class, ``[n1, n1+n2)`` the -1 class and
    the tail is all-zero padding; ``sign`` is +1 / -1 / 0 accordingly."""

    x_t: torch.Tensor    # (d, n_pad) column-major: x_t[c] is coordinate c
                         #   of every packed point, so a sampled block is
                         #   b contiguous rows
    sign: torch.Tensor   # (n_pad,) +1 class P, -1 class Q, 0 padding
    n1: int
    n2: int

    @property
    def n_pad(self) -> int:
        return self.x_t.shape[-1]


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array) as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def pack_points(xp, xm, pad_to: int | None = None) -> PackedPoints:
    """Pack the two row-major class matrices (tensors, on the device the
    solve runs on) into the single-sweep layout."""
    n1, d = xp.shape
    n2 = xm.shape[0]
    if xm.shape[1] != d:
        raise ValueError("class matrices must share dimensionality")
    n_pad = packed_length(n1 + n2) if pad_to is None else pad_to
    if n_pad < n1 + n2:
        raise ValueError(f"pad_to={pad_to} < n1+n2={n1 + n2}")
    if n_pad % LANE:
        raise ValueError(f"pad_to={pad_to} must be a multiple of the "
                         f"lane width {LANE}")
    x_t = torch.zeros((d, n_pad), dtype=torch.float32, device=xp.device)
    x_t[:, :n1] = xp.T
    x_t[:, n1:n1 + n2] = xm.T
    sign = torch.zeros((n_pad,), dtype=torch.float32, device=xp.device)
    sign[:n1] = 1.0
    sign[n1:n1 + n2] = -1.0
    return PackedPoints(x_t=x_t, sign=sign, n1=n1, n2=n2)


def pack_points_to(xp, xm, n_pad: int, d_pad: int) -> PackedPoints:
    """Bucketed packing into an exact (d_pad, n_pad) shape: the coordinate
    axis is zero-padded to ``d_pad`` (inert all-zero rows of ``x_t``)."""
    d = xp.shape[1]
    if d_pad < d:
        raise ValueError(f"d_pad={d_pad} < d={d}")
    if d_pad > d:
        xp = torch.nn.functional.pad(xp, (0, d_pad - d))
        xm = torch.nn.functional.pad(xm, (0, d_pad - d))
    return pack_points(xp, xm, pad_to=n_pad)


class Preprocessed(NamedTuple):
    """Output of :func:`preprocess`: the transformed problem."""

    xp: torch.Tensor      # (n1, d_pad) transformed +1 points (rows)
    xm: torch.Tensor      # (n2, d_pad) transformed -1 points (rows)
    signs: torch.Tensor   # (d_pad,) the +-1 diagonal of D
    scale: torch.Tensor   # scalar: 1 / max ||x_i||
    d_orig: int           # original dimensionality before padding


def hadamard_transform(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Apply ``W D`` to rows of ``x`` (already padded to len(signs))."""
    return fwht(x * signs[None, :])


def inverse_hadamard_transform(v: torch.Tensor,
                               signs: torch.Tensor) -> torch.Tensor:
    """Apply ``(W D)^-1 = D W^T`` to a vector in transformed space."""
    return fwht(v) * signs


def rademacher_signs(d: int, generator: torch.Generator) -> torch.Tensor:
    """(d,) float32 +-1 drawn from ``generator`` (on the generator's
    device)."""
    bits = torch.randint(0, 2, (d,), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(torch.float32)


def preprocess(xp, xm, *, generator: torch.Generator | None = None,
               signs=None, device: str | torch.device | None = None
               ) -> Preprocessed:
    """Algorithm 1: scale to the unit ball and apply the WD transform.

    The +-1 diagonal comes from ``signs`` (d_pad values) when given,
    else from ``generator``."""
    dev = resolve_device(device)
    xp, xm = as_f32(xp, dev), as_f32(xm, dev)
    d = xp.shape[1]
    if xm.shape[1] != d:
        raise ValueError("class matrices must share dimensionality")
    d_pad = next_pow2(d)
    if signs is None:
        if generator is None:
            raise ValueError("preprocess needs a generator or signs")
        signs = rademacher_signs(d_pad, generator)
    signs = as_f32(signs, dev)
    if tuple(signs.shape) != (d_pad,):
        raise ValueError(f"signs must have shape ({d_pad},), got "
                         f"{tuple(signs.shape)}")
    xp = torch.nn.functional.pad(xp, (0, d_pad - d))
    xm = torch.nn.functional.pad(xm, (0, d_pad - d))
    norms = torch.cat([torch.linalg.vector_norm(xp, dim=1),
                       torch.linalg.vector_norm(xm, dim=1)])
    scale = 1.0 / torch.clamp(norms.max(), min=1e-30)
    return Preprocessed(xp=hadamard_transform(xp * scale, signs),
                        xm=hadamard_transform(xm * scale, signs),
                        signs=signs, scale=scale, d_orig=d)


def transform_like(pre: Preprocessed, x) -> torch.Tensor:
    """Apply a problem's FIXED transform (its ``D`` and unit-ball scale)
    to new raw points (m, d_orig), as a streaming update must."""
    x = as_f32(x, pre.signs.device)
    if x.ndim != 2 or x.shape[1] != pre.d_orig:
        raise ValueError(
            f"transform_like expects (m, d_orig={pre.d_orig}) points; "
            f"got shape {tuple(x.shape)}")
    x = torch.nn.functional.pad(x, (0, pre.signs.shape[0] - x.shape[1]))
    return hadamard_transform(x * pre.scale, pre.signs)


def repack_warm_duals(log_lam: np.ndarray, n1_old: int, n2_old: int,
                      n1_new: int, n2_new: int,
                      n_pad_new: int) -> np.ndarray:
    """Transfer packed per-class log dual mass across bucket shapes.

    The layout is ``[eta (n1) | xi (n2) | NEG_INF pad]``: carried entries
    keep their log weights at their class's new offset, new points start
    at the new uniform level ``-log(n_class_new)``, and the next MWU
    normalizer round renormalizes each class.  ``n1_old = n2_old = 0``
    gives the uniform init on the new shape."""
    if not (0 <= n1_old <= n1_new and 0 <= n2_old <= n2_new):
        raise ValueError(
            f"warm dual transfer needs old class sizes within new ones; "
            f"got ({n1_old}, {n2_old}) -> ({n1_new}, {n2_new})")
    if n1_new + n2_new > n_pad_new:
        raise ValueError(
            f"n1_new+n2_new={n1_new + n2_new} > n_pad_new={n_pad_new}")
    lam = np.asarray(log_lam, np.float32)
    out = np.full((n_pad_new,), NEG_INF, np.float32)
    out[:n1_old] = lam[:n1_old]
    out[n1_old:n1_new] = -math.log(n1_new)
    out[n1_new:n1_new + n2_old] = lam[n1_old:n1_old + n2_old]
    out[n1_new + n2_old:n1_new + n2_new] = -math.log(n2_new)
    return out


def recover_direction(w: torch.Tensor, pre: Preprocessed) -> torch.Tensor:
    """Map a direction from transformed space back to the input space:
    w_orig = scale * (WD)^T w, cut to the original dimensionality."""
    return inverse_hadamard_transform(w, pre.signs)[: pre.d_orig] * pre.scale
