#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and there is
no CPU fallback):

  1. build     -- compile every kernel from ``src/repro_torch/kernels/csrc``
                  with nvcc for sm_90a into ``build/repro_torch_kernels/``.
  2. main path -- a nu-SVM fit at the paper's Figure 2 size (n=50,000,
                  d=512, B=1) and a hard-margin fit in block mode
                  (n=20,000, d=256, B=128), through ``SaddleNuSVC.fit`` /
                  ``SaddleSVC.fit``, with the launch counts reset just
                  before and read just after: each step makes exactly one
                  launch of each packed kernel, the FWHT runs for the
                  preprocessing and the recovery, the history is finite
                  and falls.  The shape of every kernel call, the packed
                  operands and the sampled coordinates are recorded.
  3. kernels   -- each kernel against its plain PyTorch version on the
                  card, at every shape the main path gave it (the packed
                  kernels on the main path's own x_t and sign), and at a
                  synthetic layout with an all-padding tile and
                  single-class tiles; its time, the plain version's time,
                  a one-call PyTorch yardstick and its bound.  An
                  out-of-range row index gives NaN, not a fault.
  4. profile   -- a short window of the nu-SVM solve under torch.profiler:
                  the device's busy share and kernel time by name.
  5. card vs CPU -- one fit (n=4,000, d=128, 2,000 iterations) on the card
                  and on the CPU with the same signs and coordinate
                  schedule; then both main-path fits replayed on the CPU
                  with the coordinates the card sampled.

The next-to-last line of standard output is a JSON object listing every
kernel at every main-path shape with its launches, error, times and bound;
the last line is ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = ("fwht", "momentum_dot_packed", "mwu_update_packed")
REPLACES = {
    "fwht": "src/repro/kernels/fwht.py:96",
    "momentum_dot_packed": "src/repro/kernels/saddle_update.py:359",
    "mwu_update_packed": "src/repro/kernels/saddle_update.py:432",
}
SOURCES = {"fwht": f"{CSRC}/fwht.cu",
           "momentum_dot_packed": f"{CSRC}/saddle_update.cu",
           "mwu_update_packed": f"{CSRC}/saddle_update.cu"}
# Card vs CPU: a fit's w_ and b_ agree to 1e-4, its objective history to
# 1e-3 relative.
FIT_ATOL, HIST_RTOL = 1e-4, 1e-3


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
class Timer:
    """Median time of a call on the card with CUDA events, warm, with the
    50 MB L2 flushed before every repeat (the solver's x_t is larger than
    L2, so a step finds its rows cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")   # 256 MiB

    def __call__(self, fn, reps: int = 15, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(self, fn, kernel: str, reps: int = 20) -> float:
        """Mean device time of one launch of the CUDA kernel whose name
        holds ``kernel``, from torch.profiler over ``reps`` calls of
        ``fn``: the kernel alone, without the host's launch cost and the
        wrapper's other ops."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and kernel in ev.key:
                total = getattr(ev, "self_device_time_total", None)
                if total is None:
                    total = ev.self_cuda_time_total
                return total / ev.count / 1e3
        raise PhaseError(f"the profiler saw no launch of {kernel}")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, label, err, ms, plain_ms, library_ms, nbytes, ops):
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(name=label, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=None, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def print_entry(e, dev_ms: float) -> None:
    lib = "null" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
    print(f"  {e['name']}: err {e['max_abs_err']:.3e}  kernel "
          f"{e['ms']:.4f} ms (device only {dev_ms:.4f} ms)  plain "
          f"{e['plain_ms']:.4f} ms  library {lib} ms  bound "
          f"{e['bound_ms']:.4f} ms ({e['bound_by']})  launches "
          f"{e['launches']}")


# ---------------------------------------------------------------- phase 2
class PathRecorder:
    """Host-side bookkeeping of the main path: the shape of every kernel
    call, the packed operands (x_t, sign) of each packed shape, and the
    coordinate block of every step.  It wraps the entry points of
    ``repro_torch.kernels.ops`` that the solver calls; the wrappers
    underneath still count their own launches."""

    def __init__(self):
        self.calls = Counter()     # (kernel, shape) -> calls
        self.operands = {}         # (S, d, n_pad, b) -> (x_t, sign)
        self.blocks = []           # idx (S, b) of every step, in order

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = {name: getattr(ops, name) for name in KERNELS}

        def fwht(x, **kw):
            n = 1 if x.ndim == 1 else x.shape[0]
            self.calls["fwht", (n, x.shape[-1])] += 1
            return self.saved["fwht"](x, **kw)

        def momentum_dot_packed(x_t, idx, *args):
            shape = (*x_t.shape, idx.shape[1])
            self.calls["momentum_dot_packed", shape] += 1
            self.operands.setdefault(shape, (x_t, args[2]))
            self.blocks.append(idx)
            return self.saved["momentum_dot_packed"](x_t, idx, *args)

        def mwu_update_packed(x_t, idx, *args):
            self.calls["mwu_update_packed", (*x_t.shape, idx.shape[1])] += 1
            return self.saved["mwu_update_packed"](x_t, idx, *args)

        for name, fn in (("fwht", fwht),
                         ("momentum_dot_packed", momentum_dot_packed),
                         ("mwu_update_packed", mwu_update_packed)):
            setattr(ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def take_schedule(self):
        """The (steps, b) coordinate schedule of the fit just run."""
        import torch
        sched = torch.stack(self.blocks)[:, 0, :].cpu().numpy()
        self.blocks = []
        return sched


FITS = (
    # label, estimator, constructor arguments, data
    ("nu-SVM n=50000 d=512 B=1", "SaddleNuSVC",
     dict(alpha=0.85, eps=1e-3, beta=0.1, num_iters=8000,
          record_every=2000),
     ("non_separable", (50_000, 512), dict(beta2=0.2, seed=50_000))),
    ("hard-margin n=20000 d=256 B=128", "SaddleSVC",
     dict(eps=1e-3, beta=0.1, block_size=128, record_every=50),
     ("separable", (20_000, 256), dict(seed=256))),
)


def make_fit(spec, device):
    from repro_torch.core import svm
    from repro_torch.data import synthetic

    _label, cls, kw, (gen, args, gkw) = spec
    return (getattr(svm, cls)(device=device, **kw),
            getattr(synthetic, gen)(*args, **gkw))


def rises(objs) -> list[bool]:
    return [b >= a for a, b in zip(objs, objs[1:])]


def run_fit(torch, label, clf, ds, steps_want):
    from repro_torch.kernels import ops

    before = Counter(ops.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.fit(ds.x, ds.y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = Counter(ops.launch_counts) - before
    steps = clf.history_[-1][0]
    objs = [o for _, o in clf.history_]
    acc = clf.score(ds.x, ds.y)
    print(f"{label}: {secs:.3f} s fit, {secs / steps * 1e3:.4f} ms/step "
          f"over {steps} steps, train accuracy {acc:.4f}, margin "
          f"{clf.margin_:.6g}")
    print(f"  history {clf.history_}")
    print(f"  launches {dict(counts)}")
    require(steps == steps_want, f"{label}: ran {steps} steps, want "
            f"{steps_want}")
    require(counts["momentum_dot_packed"] == steps
            and counts["mwu_update_packed"] == steps,
            f"{label}: want one launch of each packed kernel per step")
    require(counts["fwht"] == 3,
            f"{label}: want 3 fwht launches (2 preprocessing, 1 recovery)")
    require(all(math.isfinite(o) for o in objs), f"{label}: non-finite")
    # The dual objective of this primal-dual method falls overall but is
    # not monotone once near its floor, so the check is that it falls from
    # the first chunk to the last and never rises above the first; phase 5
    # replays the fit on the CPU's plain path and must find the same
    # history.
    print(f"  objective rose at {sum(rises(objs))} of {len(objs) - 1} "
          f"boundaries")
    require(objs[-1] < objs[0] and max(objs) <= objs[0],
            f"{label}: objective does not fall")
    require(all(math.isfinite(v) for v in clf.w_) and math.isfinite(clf.b_),
            f"{label}: non-finite hyperplane")


def main_path(torch, rec: PathRecorder):
    """Both fits, with the launch counts reset just before and read just
    after.  Returns [(spec, fitted estimator, data, schedule)]."""
    from repro_torch.core import saddle
    from repro_torch.kernels import ops

    fits = [(spec,) + make_fit(spec, "cuda") for spec in FITS]
    ops.launch_counts.clear()
    done = []
    with rec:
        for spec, clf, ds in fits:
            steps = saddle.resolve_num_iters(
                clf.num_iters, ds.x.shape[1], clf.eps, clf.beta, len(ds.y),
                clf.block_size)
            run_fit(torch, spec[0], clf, ds, steps)
            done.append((spec, clf, ds, rec.take_schedule()))
    counts = dict(ops.launch_counts)
    print(f"main path launches {counts}")
    for name in KERNELS:
        require(counts.get(name, 0) > 0, f"{name} was never launched on "
                "the main path")
        seen = sum(c for (k, _), c in rec.calls.items() if k == name)
        require(seen == counts[name], f"{name}: {counts[name]} launches "
                f"counted, {seen} calls recorded")
    return done


# ---------------------------------------------------------------- phase 3
def check_fwht(torch, timer, g, n, d, launches):
    from repro_torch.kernels import ops, ref

    x = torch.randn((n, d), generator=g, device="cuda")
    out = ops.fwht(x)
    want = ref.fwht_ref(x)
    err = (out - want).abs().max().item()
    require(err <= 1e-4, f"fwht n={n} d={d} disagrees with its plain "
            f"version: {err}")
    require(torch.equal(out, ops.fwht(x)), "fwht is not deterministic")
    had = ref.fwht_ref(torch.eye(d, device="cuda"))   # normalized H
    e = entry("fwht", f"fwht[n={n},d={d}]", err, timer(lambda: ops.fwht(x)),
              timer(lambda: ref.fwht_ref(x)), timer(lambda: x @ had),
              nbytes=2 * 4 * n * d, ops=n * d * (math.log2(d) + 1))
    e["launches"] = launches
    print_entry(e, timer.device_ms(lambda: ops.fwht(x), "fwht_rows_kernel"))
    return e


def step_inputs(torch, g, x_t, sign, b, main_path: bool = True):
    """Duals, u and the step's scalars for a packed call on (x_t, sign):
    per-class log weights near uniform, -1e30 on padding.  The scalars are
    the main path's for this n, d and b, or else the fixed ones of the JAX
    package's kernel tests (gamma = 1e-3, tau = 40, d_eff = d, theta =
    0.95), which go with their unscaled Gaussian rows."""
    from repro_torch.core import engine, saddle

    _, d, n_pad = x_t.shape
    dev = x_t.device
    n1, n2 = int((sign > 0).sum()), int((sign < 0).sum())
    noise = 0.1 * torch.randn((1, n_pad), generator=g, device=dev)
    ll = torch.where(sign > 0, -math.log(n1) + noise,
                     torch.where(sign < 0, -math.log(n2) + noise,
                                 torch.full_like(noise, -1e30)))
    lp = ll + 0.05 * torch.randn((1, n_pad), generator=g, device=dev) * (
        sign != 0)
    u = 0.1 * torch.randn((1, n_pad), generator=g, device=dev)
    if main_path:
        sp = engine.stack_slot_params([engine.slot_params_row(
            saddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=b))], dev)
        theta, mwu_c, mwu_dot, d_eff = sp.theta, sp.mwu_c, sp.mwu_dot, d / b
    else:
        gamma, tau, d_eff = 1e-3, 40.0, float(d)
        theta = torch.tensor([0.95], device=dev)
        mwu_c = torch.tensor([1.0 / (gamma + d_eff / tau)], device=dev)
        mwu_dot = torch.tensor([d_eff / tau], device=dev)
    idx = torch.randperm(d, generator=g, device=dev)[:b].to(
        torch.int32)[None]
    dw = 0.01 * torch.randn((1, b), generator=g, device=dev)
    return dict(ll=ll, lp=lp, u=u, theta=theta, mwu_c=mwu_c,
                mwu_dot=mwu_dot, d_eff=d_eff, idx=idx, dw=dw)


def check_packed(torch, timer, g, x_t, sign, b, launches,
                 main_path: bool = True):
    """Both packed kernels on (x_t, sign) with b sampled rows."""
    from repro_torch.kernels import ops, ref

    _, d, n_pad = x_t.shape
    a = step_inputs(torch, g, x_t, sign, b, main_path)
    ll, lp, u, idx, dw, theta, mwu_c, mwu_dot, d_eff = (a[k] for k in (
        "ll", "lp", "u", "idx", "dw", "theta", "mwu_c", "mwu_dot", "d_eff"))
    tag = ",main-path operands" if main_path else ",synthetic layout"
    real = sign[0] != 0
    label = f"[d={d},n_pad={n_pad},b={b}{tag}]"
    entries = []

    def dot():
        return ops.momentum_dot_packed(x_t, idx, ll, lp, sign, theta)

    got = dot()
    want = ref.momentum_dot_packed_ref(x_t, idx, ll, lp, sign, theta)
    err = (got - want).abs().max().item()
    require(err <= 1e-4, f"momentum_dot_packed{label}: err {err}")
    require(torch.equal(got, dot()), "momentum_dot_packed is not "
            "deterministic")
    lam = torch.exp(ll[0])
    mom = sign[0] * (lam + theta[0] * (lam - torch.exp(lp[0])))
    idx_l = idx[0].long()
    e = entry("momentum_dot_packed", "momentum_dot_packed" + label, err,
              timer(dot), timer(lambda: ref.momentum_dot_packed_ref(
                  x_t, idx, ll, lp, sign, theta)),
              timer(lambda: x_t[0][idx_l] @ mom),
              nbytes=4 * (n_pad * (b + 3) + 2 * b + 1),
              ops=n_pad * (2 * b + 6))
    e["launches"] = launches
    print_entry(e, timer.device_ms(dot, "momentum_dot_packed_kernel"))
    entries.append(e)

    def mwu():
        return ops.mwu_update_packed(x_t, idx, ll, u, dw, sign, mwu_c,
                                     mwu_dot, d_eff)

    got = mwu()
    want = ref.mwu_update_packed_ref(x_t, idx, ll, u, dw, sign, mwu_c,
                                     mwu_dot, d_eff)
    errs = [(got[0][0][real] - want[0][0][real]).abs().max().item()]
    require((got[0][0][~real] < -1e20).all().item(),
            f"mwu_update_packed{label}: padding lanes not below -1e20")
    u_err = (got[1] - want[1]).abs().max().item()
    require(u_err <= 1e-5, f"mwu_update_packed{label}: u err {u_err}")
    for m_i, s_i in ((2, 3), (4, 5)):
        lse_g = got[m_i] + torch.log(got[s_i])
        lse_w = want[m_i] + torch.log(want[s_i])
        errs.append((lse_g - lse_w).abs().max().item())
    require(max(errs) <= 1e-4, f"mwu_update_packed{label}: err {errs}")
    require(all(torch.equal(p, q) for p, q in zip(got, mwu())),
            "mwu_update_packed is not deterministic")
    e = entry("mwu_update_packed", "mwu_update_packed" + label,
              max(errs + [u_err]), timer(mwu),
              timer(lambda: ref.mwu_update_packed_ref(
                  x_t, idx, ll, u, dw, sign, mwu_c, mwu_dot, d_eff)),
              None, nbytes=4 * (n_pad * (b + 5) + 2 * b + 2),
              ops=n_pad * (2 * b + 12))
    e["launches"] = launches
    print_entry(e, timer.device_ms(mwu, "mwu_update_packed_kernel"))
    entries.append(e)
    return entries


def synthetic_layout(torch, g):
    """x_t (1, 512, 50,048) of Gaussian rows and its sign: a single-class
    first tile, a mixed tile at the class boundary and an all-padding last
    tile."""
    n_pad, d, n1, n2 = 50_048, 512, 24_000, 25_900
    x_t = torch.randn((1, d, n_pad), generator=g, device="cuda")
    x_t[:, :, n1 + n2:] = 0.0
    sign = torch.zeros((1, n_pad), device="cuda")
    sign[:, :n1], sign[:, n1:n1 + n2] = 1.0, -1.0
    return x_t, sign


def check_bad_index(torch, g, x_t, sign):
    """A row index outside [0, d) is skipped by the kernels: its dot and
    the whole dual update come out NaN, with no CUDA error."""
    from repro_torch.kernels import ops

    d = x_t.shape[1]
    a = step_inputs(torch, g, x_t, sign, 2)
    idx = torch.tensor([[0, d]], dtype=torch.int32, device="cuda")
    delta = ops.momentum_dot_packed(x_t, idx, a["ll"], a["lp"], sign,
                                    a["theta"])
    log_new, u_new, *_ = ops.mwu_update_packed(
        x_t, idx, a["ll"], a["u"], a["dw"], sign, a["mwu_c"], a["mwu_dot"],
        a["d_eff"])
    torch.cuda.synchronize()
    require(math.isfinite(delta[0, 0].item())
            and math.isnan(delta[0, 1].item()),
            "momentum_dot_packed: want NaN for the out-of-range row only")
    require(torch.isnan(log_new).all().item()
            and torch.isnan(u_new).all().item(),
            "mwu_update_packed: want NaN outputs for an out-of-range row")
    print("  out-of-range row index: NaN outputs, no CUDA error")


def check_kernels(torch, timer, rec: PathRecorder) -> list[dict]:
    """Every kernel at every shape of the main path (the JSON entries),
    then at the synthetic layout (printed only)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    entries = []
    for (name, shape), calls in sorted(rec.calls.items()):
        if name == "fwht":
            entries.append(check_fwht(torch, timer, g, *shape, calls))
    for shape, (x_t, sign) in sorted(rec.operands.items()):
        entries += check_packed(torch, timer, g, x_t, sign, shape[3],
                                rec.calls["momentum_dot_packed", shape])
    print("  not on the main path (launches null):")
    check_fwht(torch, timer, g, 50_000, 512, None)
    x_t, sign = synthetic_layout(torch, g)
    for b in (1, 128):
        check_packed(torch, timer, g, x_t, sign, b, None, main_path=False)
    check_bad_index(torch, g, x_t, sign)
    return entries


# ---------------------------------------------------------------- phase 4
def profile_window(torch):
    """Device busy share and kernel time by name over 300 steps of the
    nu-SVM solve at the Figure 2 shape."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    ds = synthetic.non_separable(50_000, 512, beta2=0.2, seed=50_000)
    xp, xm = split_classes(ds.x, ds.y)
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    kw = dict(eps=1e-3, beta=0.1, nu=nu, num_iters=300, device="cuda")
    saddle.solve(pre.xp, pre.xm, **kw)                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        saddle.solve(pre.xp, pre.xm, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows = []                           # device-side rows: kernels, copies
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if busy == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    launches = sum(r[2] for r in rows)
    print(f"profile (300 nu-SVM steps, n=50000 d=512): wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, "
          f"{wall / 300 * 1e3:.4f} ms/step, {launches / 300:.1f} device "
          f"launches/step")
    for dev_us, key, count in rows[:12]:
        print(f"  {dev_us / 1e3:10.3f} ms  {count:7d}x  {key[:90]}")


# ---------------------------------------------------------------- phase 5
def compare_fits(label, card, cpu, history: bool) -> None:
    import numpy as np

    dw = float(np.abs(card.w_ - cpu.w_).max())
    db = abs(card.b_ - cpu.b_)
    print(f"{label}: max|dw| {dw:.3e}, |db| {db:.3e}, |dobj| "
          f"{abs(card.objective_ - cpu.objective_):.3e} (tol {FIT_ATOL})")
    require(max(dw, db) <= FIT_ATOL, f"{label}: card and CPU disagree")
    if not history:
        return
    marks = [m for m, _ in card.history_]
    oc = [o for _, o in card.history_]
    oh = [o for _, o in cpu.history_]
    rel = max(abs(a - b) / abs(b) for a, b in zip(oc, oh))
    print(f"  card history {list(zip(marks, oc))}")
    print(f"  CPU history  {cpu.history_}")
    print(f"  max relative objective difference {rel:.3e}; rises at "
          f"boundaries: card {rises(oc)}, CPU {rises(oh)}")
    require(marks == [m for m, _ in cpu.history_], f"{label}: marks differ")
    require(rel <= HIST_RTOL, f"{label}: histories disagree")


def card_vs_cpu(torch, fits):
    import numpy as np

    from repro_torch.core.svm import SaddleSVC
    from repro_torch.data import synthetic

    ds = synthetic.separable(4000, 128, seed=4000)
    rng = np.random.default_rng(4000)
    signs = rng.choice([-1.0, 1.0], size=128).astype(np.float32)
    sched = rng.integers(0, 128, size=(2000, 1)).astype(np.int32)
    card, cpu = (SaddleSVC(eps=1e-3, beta=0.1, num_iters=2000,
                           device=dev).fit(ds.x, ds.y, signs=signs,
                                           idx_schedule=sched)
                 for dev in ("cuda", "cpu"))
    compare_fits("card vs CPU (n=4000 d=128, 2000 steps)", card, cpu,
                 history=False)
    require(abs(card.objective_ - cpu.objective_) <= FIT_ATOL,
            "card and CPU objectives disagree")

    for spec, card, ds, sched in fits:
        clf, _ = make_fit(spec, "cpu")
        t0 = time.perf_counter()
        clf.fit(ds.x, ds.y, idx_schedule=sched)
        print(f"main-path {spec[0]} replayed on the CPU with the card's "
              f"coordinates: {time.perf_counter() - t0:.1f} s")
        compare_fits(f"  card vs CPU, {spec[0]}", card, clf, history=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(build.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"card: {card}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    rec = PathRecorder()
    fits = main_path(torch, rec)
    entries = check_kernels(torch, Timer(torch), rec)
    profile_window(torch)
    card_vs_cpu(torch, fits)

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
