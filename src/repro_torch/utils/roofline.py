"""Roofline terms for an NVIDIA H100 SXM from one run of a function.

Counterpart of ``repro.utils.roofline``, which reads XLA's cost analysis of
a compiled TPU program.  Eager PyTorch compiles nothing, so
:func:`analyze` runs the function once and counts what it dispatched:

    compute term    = FLOPs / peak FLOP/s            (FlopCounterMode)
    memory term     = bytes / HBM rate               (every op's tensor
                                                      inputs + outputs)
    collective term = collective bytes / NVLink rate (the c10d ops of
                                                      ``dispatch_trace``)

The peaks are the H100 SXM data sheet's (dense, no sparsity).  The
framework-free choosers (:func:`delta`, :func:`pick_block_size`,
:func:`gap_check_cadence`) and the model-FLOP counts
(:func:`model_flops`, :func:`active_param_count`) are copies of the JAX
package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.utils.dispatch_trace import CollectiveStats, Trace

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s, tensor cores (data sheet)
F32_FLOPS = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s (data sheet)
NVLINK_BW = 450e9            # NVLink 4 bytes/s a direction (data sheet)


class Roofline(NamedTuple):
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collectives: CollectiveStats | None
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def mfu(self, model_flops_per_device: float) -> float:
        """model FLOPs utilization against the roofline step time."""
        t = self.step_time_s
        return model_flops_per_device / (t * PEAK_FLOPS) if t else 0.0


def delta(a: Roofline, b: Roofline) -> Roofline:
    """Roofline of the work ``a`` does beyond ``b`` (clamped at 0):
    isolate the cost of an optional stage by differencing two runs --
    e.g. the per-boundary duality-gap check as analyze(chunk with
    check_gap) - analyze(chunk without)."""
    flops = max(a.flops - b.flops, 0.0)
    hbm = max(a.hbm_bytes - b.hbm_bytes, 0.0)
    coll = max(a.collective_bytes - b.collective_bytes, 0.0)
    return Roofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=coll,
        collectives=a.collectives,
        compute_s=flops / PEAK_FLOPS, memory_s=hbm / HBM_BW,
        collective_s=coll / NVLINK_BW)


def pick_block_size(per_iter_s: dict[int, float]) -> int:
    """Choose B from {B: per-iteration cost}: at a FIXED total
    coordinate budget (iters x B held constant) the best block size
    minimizes the per-COORDINATE time step(B) / B.  Works on predicted
    (``Roofline.step_time_s``) and measured costs alike."""
    if not per_iter_s:
        raise ValueError("no block-size candidates")
    return min(per_iter_s, key=lambda b: per_iter_s[b] / b)


def gap_check_cadence(step_s: float, check_s: float, total_iters: int,
                      ladder: tuple[int, ...] = (32, 64, 128, 256, 512,
                                                 1024, 2048)) -> int:
    """Choose the duality-gap check cadence c minimizing the expected
    overhead of a run that converges after ~``total_iters`` steps:

        cost(c) = (total_iters / c) * check_s   (boundary evaluations)
                + (c / 2) * step_s              (mean post-convergence
                                                 overshoot to the next
                                                 boundary)

    The unconstrained optimum is sqrt(2 * T * check / step); the ladder
    keeps the choice a power of 2.  Like :func:`pick_block_size` this is
    cost-source agnostic."""
    if step_s <= 0 or check_s < 0 or total_iters <= 0:
        raise ValueError("costs must be positive")
    return min(ladder, key=lambda c: total_iters / c * check_s
               + 0.5 * c * step_s)


def analyze(fn, *args, **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once and return its roofline terms.

    FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count (the
    ops it has formulas for: products, convolutions, attention); they are
    priced at the bf16 peak unless one of those ops gives a float32
    output, then at the float32 peak.  Bytes are every dispatched op's
    tensor inputs plus outputs: eager ops do not fuse, so an intermediate
    is counted where it is written and again where it is read, and the
    figure is an upper bound on HBM traffic (a fused kernel moves less).
    Collective bytes are the payloads of the ``c10d`` ops the region
    issued (``dispatch_trace.Trace``)."""
    counter = FlopCounterMode(display=False)
    with counter, Trace() as tr:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    f32 = any(r.name.startswith("aten.") and torch.float32 in r.dtypes
              and _packet(r.name) in flop_registry for r in tr.ops)
    coll = tr.collective_stats()
    return Roofline(
        flops=flops, hbm_bytes=float(tr.nbytes),
        collective_bytes=float(coll.total_bytes), collectives=coll,
        compute_s=flops / (F32_FLOPS if f32 else PEAK_FLOPS),
        memory_s=tr.nbytes / HBM_BW,
        collective_s=coll.total_bytes / NVLINK_BW)


def _packet(name: str):
    return getattr(torch.ops.aten, name.split(".", 1)[1], None)


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6 * N_active * tokens (training) or 2 * N_active * tokens
    (forward-only: prefill/decode)."""
    n = active_param_count(cfg)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens


def active_param_count(cfg) -> float:
    """Approximate active parameters per token (MoE: top-k + shared)."""
    d, l = cfg.d_model, cfg.num_layers
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    kinds = list(cfg.block_pattern)
    for i in range(l):
        kind = kinds[i % len(kinds)] if i >= cfg.first_dense_layers \
            else kinds[0]
        if kind in ("attn", "local_attn"):
            if cfg.attention_kind == "mla" and kind == "attn":
                lora, rope = cfg.mla_kv_lora, cfg.mla_rope_dim
                vd = cfg.mla_v_dim or cfg.head_dim
                h = cfg.num_heads
                qp = (d * cfg.mla_q_lora
                      + cfg.mla_q_lora * h * (cfg.head_dim + rope)) \
                    if cfg.mla_q_lora else d * h * (cfg.head_dim + rope)
                per_layer += (qp + d * (lora + rope)
                              + lora * h * (cfg.head_dim + vd)
                              + h * vd * d)
            else:
                per_layer += d * cfg.head_dim * (
                    cfg.num_heads * 2 + cfg.num_kv_heads * 2)
            if i < cfg.first_dense_layers or cfg.mlp_kind != "moe":
                per_layer += 3 * d * cfg.d_ff
            else:
                active_e = cfg.moe_top_k + cfg.moe_num_shared
                per_layer += 3 * d * cfg.moe_d_ff * active_e
        elif kind == "rglru":
            w = cfg.rglru_width or d
            per_layer += d * w * 2 + w * w * 2 + w * d + 3 * d * cfg.d_ff
        elif kind == "mlstm":
            inner = int(d * cfg.mlstm_proj_factor)
            per_layer += d * 2 * inner + 3 * inner * inner // max(
                cfg.num_heads, 1) * cfg.num_heads + inner * d
        elif kind == "slstm":
            dh = d // cfg.num_heads
            up = int(d * cfg.slstm_proj_factor)
            per_layer += d * 4 * d + cfg.num_heads * dh * 4 * dh \
                + d * 2 * up + up * d
    if cfg.is_encoder_decoder:
        enc = cfg.enc_layers * (4 * d * cfg.num_heads * cfg.head_dim
                                + 3 * d * cfg.d_ff)
    else:
        enc = 0
    return emb + per_layer + enc
