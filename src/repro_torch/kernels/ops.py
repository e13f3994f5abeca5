"""Entry points of the port's kernels, as the solver core calls them.

Each runs the hand-written CUDA kernel on CUDA tensors and the plain
PyTorch version on CPU tensors (see the wrappers in
:mod:`repro_torch.kernels.fwht` and :mod:`repro_torch.kernels.saddle_update`).
``launch_counts`` tallies CUDA launches by name: the packed solver step
makes exactly two, ``momentum_dot_packed`` and ``mwu_update_packed``; the
unpacked reference step four, two each of ``momentum_dot`` and
``mwu_update`` (one per class), for any number of clients.

The packed kernels' ``idx`` must lie in [0, d): out of range it raises on
the CPU and gives NaN outputs on CUDA (see
:mod:`repro_torch.kernels.saddle_update`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch_counts  # noqa: F401  (re-exported)
from repro_torch.kernels import ref  # noqa: F401  (re-exported oracle)
from repro_torch.kernels.fwht import fwht_rows
from repro_torch.kernels.saddle_update import (  # noqa: F401
    momentum_dot, momentum_dot_packed, mwu_update, mwu_update_packed)


def fwht(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Walsh--Hadamard transform along the last axis of a vector or of
    the rows of an (n, d) matrix, d a power of two."""
    if x.ndim == 1:
        return fwht_rows(x[None, :].contiguous(), normalize=normalize)[0]
    return fwht_rows(x.contiguous(), normalize=normalize)
