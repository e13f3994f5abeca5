"""Wrapper of the CUDA Walsh--Hadamard kernel (``csrc/fwht.cu``).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version :func:`repro_torch.kernels.ref.fwht_ref`.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels import ref

# The kernel holds whole rows in one block's shared memory; an H100 block
# can have at most 227 KB of it.
MAX_SMEM_BYTES = 232_448


def check_fwht(x: torch.Tensor) -> int:
    """Validate an (n, d) float32 contiguous input; returns d."""
    if x.ndim != 2:
        raise ValueError(f"fwht expects an (n, d) matrix, got shape "
                         f"{tuple(x.shape)}")
    d = x.shape[1]
    if d <= 0 or d & (d - 1):
        raise ValueError(f"d must be a power of two, got {d}")
    if x.dtype != torch.float32:
        raise TypeError(f"fwht takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fwht needs a contiguous input")
    return d


def fwht_rows(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Walsh--Hadamard transform of every row of ``x`` (n, d), d a power
    of two, divided by sqrt(d) when ``normalize``."""
    d = check_fwht(x)
    if x.device.type == "cpu":
        return ref.fwht_ref(x, normalize=normalize)
    if x.device.type != "cuda":
        raise ValueError(f"fwht runs on cuda or cpu, not {x.device}")
    if d * 4 > MAX_SMEM_BYTES:
        raise ValueError(
            f"d={d}: a row of {d * 4} bytes exceeds the {MAX_SMEM_BYTES}-byte "
            "shared memory of one block; the multi-pass FWHT is not written")
    from repro_torch.kernels import build
    lib = build.library("fwht")
    out = torch.empty_like(x)
    norm = math.sqrt(d) if normalize else 1.0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.fwht_rows_f32(x.data_ptr(), out.data_ptr(),
                                      x.shape[0], d, norm, stream), "fwht")
    launch_counts["fwht"] += 1
    return out
