"""Wrapper of the CUDA Walsh--Hadamard kernels (``csrc/fwht.cu``).

On a CUDA tensor it launches the kernels or raises; on a CPU tensor it runs
the plain version :func:`repro_torch.kernels.ref.fwht_ref`.  There is no
fallback from one to the other.

Every power-of-two d is taken.  :func:`fwht_plan` picks the kernel for a
row length d: a thread per row (d <= 16), a warp per row (d <= 1,024) or a
block per row (d <= 32,768) in one pass; above that the row kernel runs
over rows of d2 = 32,768 and one strided pass (two above d = 2^20) runs the
remaining stages in place.  Every variant keeps the plain version's stage
order and its one final division, so the card's output equals
``fwht_ref``'s bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels import ref

THREAD_ROWS = 256   # rows a block of the thread variant (a thread each)
WARP_ROWS = 8       # rows a block of the warp variant (a warp each)
MAX_ROW = 32_768    # the longest row one pass transforms: the block
                    # variant's row in 128 KB of one block's shared memory
STRIDED_LOG = 5     # a strided pass combines at most 2^5 values
MAX_GRID = 2**31 - 1  # blocks of a launch (the row kernels' grid is 1-D)
VARIANTS = {"thread": 0, "warp": 1, "block": 2}   # codes of csrc/fwht.cu


class FwhtPlan(NamedTuple):
    """How the card transforms rows of length d = d1 * d2: the row kernel
    ``variant`` (``rows_per_block`` rows a block) over the n * d1 rows of
    length d2, then, when d1 > 1, the strided passes over the d1 values
    at stride d2."""

    variant: str
    rows_per_block: int
    d1: int
    d2: int

    @property
    def strided(self) -> tuple[int, ...]:
        """log2 of the values each strided pass combines, in stage
        order (empty for one pass)."""
        bits = self.d1.bit_length() - 1
        return tuple(min(STRIDED_LOG, bits - i)
                     for i in range(0, bits, STRIDED_LOG))

    @property
    def device_launches(self) -> int:
        """Kernels one wrapper call launches."""
        return 1 + len(self.strided)


def fwht_plan(d: int) -> FwhtPlan:
    """The kernel plan for rows of length d, a power of two."""
    if d <= 0 or d & (d - 1):
        raise ValueError(f"d must be a power of two, got {d}")
    d2 = min(d, MAX_ROW)
    if d2 <= 16:
        return FwhtPlan("thread", THREAD_ROWS, d // d2, d2)
    if d2 <= 1024:
        return FwhtPlan("warp", WARP_ROWS, d // d2, d2)
    return FwhtPlan("block", 1, d // d2, d2)


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


def check_grid(n: int, plan: FwhtPlan) -> None:
    """Raise if the n * d1 rows of the row kernel need more blocks than a
    launch's 32-bit grid holds (element offsets are 64-bit)."""
    blocks = -(-n * plan.d1 // plan.rows_per_block)
    if blocks > MAX_GRID:
        raise ValueError(f"fwht: {n} rows of {plan.d1 * plan.d2} need "
                         f"{blocks} blocks, more than {MAX_GRID}")


def fwht_rows(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Walsh--Hadamard transform of every row of ``x`` (n, d), d a power
    of two, divided by sqrt(d) when ``normalize``."""
    d = check_fwht(x)
    if x.device.type == "cpu":
        return ref.fwht_ref(x, normalize=normalize)
    if x.device.type != "cuda":
        raise ValueError(f"fwht runs on cuda or cpu, not {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("fwht needs a 16-byte aligned input (float4 "
                         "loads)")
    n = x.shape[0]
    plan = fwht_plan(d)
    check_grid(n, plan)
    from repro_torch.kernels import build
    lib = build.library("fwht")
    out = torch.empty_like(x)
    norm = math.sqrt(d) if normalize else 1.0
    last = len(plan.strided)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.fwht_rows_f32(
            x.data_ptr(), out.data_ptr(), n * plan.d1, plan.d2,
            VARIANTS[plan.variant], plan.rows_per_block,
            norm if last == 0 else 1.0, stream), "fwht")
        log_s = plan.d2.bit_length() - 1
        for i, log_m in enumerate(plan.strided):
            build.check(lib.fwht_strided_f32(
                out.data_ptr(), (n * d) >> log_m, log_s, log_m,
                norm if i == last - 1 else 1.0, stream), "fwht strided pass")
            log_s += log_m
    launch_counts["fwht"] += 1
    return out
