#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and there is
no CPU fallback):

  1. build      -- compile every kernel from ``src/repro_torch/kernels/csrc``
                   with nvcc for sm_90a into ``build/repro_torch_kernels/``.
  2. paths      -- four paths, each driven with the launch counts reset
                   just before it and read just after, recording the
                   shape (and the operands) of every kernel call and the
                   sampled coordinates:
       a. serial fits: a nu-SVM fit at the paper's Figure 2 size
          (n=50,000, d=512, B=1) and a hard-margin fit in block mode
          (n=20,000, d=256, B=128), through ``SaddleNuSVC.fit`` /
          ``SaddleSVC.fit``: one launch of each packed kernel per step,
          3 FWHTs per fit, a finite history that falls.
       b. distributed fits (Algorithm 4, k=20 clients on the card):
          Figure 3's hard-margin shape (n=10,000, d=256, 6,000 steps) and
          Figure 4's gisette-like nu-SVM (n=6,000, d=512, 5,000 steps),
          through ``preprocess`` and ``distributed.solve_distributed``:
          the packed kernels at S=20, 2 launches per step, 3 (HM) or 29
          (nu) tallied client reductions per step, the objective falls,
          every client holds the same w.
       c. reference step: the unpacked kernels (4 launches per step, for
          k=20 and serially) against the packed solves on the same
          coordinates, 80 steps on the Figure 3 data, 1e-5 on w, the dual
          weights and u, with the reference chunk's ms per step; and one
          block of 4 steps at B=128.
       d. above 32,768 features: a hard-margin fit on separable(1500,
          40000), padded to d_pad = 65,536, through ``SaddleSVC.fit``
          (300 steps): its 3 FWHTs take two device passes each (a row
          no longer fits one block's shared memory).
  3. serial vs distributed -- each distributed fit refit serially on the
                   coordinates it drew: w within 1e-4.
  4. profile    -- short windows of the serial nu-SVM solve and of both
                   distributed fits under torch.profiler: the device's busy
                   share and kernel time by name.
  5. kernels    -- each kernel against its plain PyTorch version on the
                   card, at every shape the paths gave it (on the paths'
                   own data and step scalars, with fresh duals and u), and
                   at the JAX kernel tests' shapes (ragged B = 3 and 130
                   too), a synthetic packed layout and FWHT rows of d =
                   1,024 to 131,072; its time, its device-only time (one
                   profiler session per group), the plain version's, a
                   one-call PyTorch yardstick and its bound, and the
                   device launches of one call (exactly 1 for a packed
                   wrapper and the unpacked dot and MWU, 1 or 2 passes
                   for the FWHT as its plan says).  The FWHT also prints its
                   variant, whether it equals the plain version bit for
                   bit, and a copy of the same bytes (``out.copy_(x)``)
                   under the same events.
                   The unpacked MWU is also checked normalized, and its
                   (m, s) against the plain merge of the per-block
                   partials of its own log_new.  Planted faults must
                   break the tolerance: at the path shapes for the
                   unpacked kernels, and at K = 20, n = 2,048, B = 128
                   for the MWU, whose clients take several blocks
                   (momentum or u dropped, a client's last point left
                   out, the last block left out of the merge, log_new
                   left unnormalized), and at every shape for the packed
                   ones (theta = 0, the last row group left out of delta,
                   u = 0, the last tile with a real point left out of the
                   merged (m, s)), whose (m, s) must also match the plain
                   merge of the per-tile partials of their own log_new.
                   Every wrapper's host time but the FWHT's is split into
                   validation, allocation, the ctypes call and the rest
                   (1,000 calls each).  The packed kernels alternate with
                   the unpacked ones, which share their ticket counters,
                   for three rounds: the same bits each round and every
                   ticket counter back at 0.  An out-of-range row index
                   gives NaN, not a fault.
  6. card vs CPU -- a serial fit (n=4,000, d=128, 2,000 iterations) on the
                   card and on the CPU with the same signs and schedule;
                   the serial fits of paths a and d and 1,000 steps of the
                   Figure 4 distributed fit replayed on the CPU with the
                   coordinates the card sampled.

The next-to-last line of standard output is a JSON object listing every
kernel at every path shape with its launches, error, times and bound;
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
KERNELS = ("fwht", "momentum_dot_packed", "mwu_update_packed",
           "momentum_dot", "mwu_update")
PACKED = ("momentum_dot_packed", "mwu_update_packed")
UNPACKED = ("momentum_dot", "mwu_update")
REPLACES = {
    "fwht": "src/repro/kernels/fwht.py:96",
    "momentum_dot_packed": "src/repro/kernels/saddle_update.py:359",
    "mwu_update_packed": "src/repro/kernels/saddle_update.py:432",
    "momentum_dot": "src/repro/kernels/saddle_update.py:233",
    "mwu_update": "src/repro/kernels/saddle_update.py:287",
}
SOURCES = {"fwht": f"{CSRC}/fwht.cu",
           **{name: f"{CSRC}/saddle_update.cu" for name in KERNELS[1:]}}
# Card vs CPU: a fit's w_ and b_ agree to 1e-4, its objective history to
# 1e-3 relative.  Serial vs distributed: w to 1e-4, every client's w to
# 1e-6 of the first's (tests/test_distributed.py); reference vs packed:
# 1e-5 (tests/test_engine.py).
FIT_ATOL, HIST_RTOL = 1e-4, 1e-3
CLIENT_ATOL, REF_ATOL = 1e-6, 1e-5


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
    L2, so a step finds its rows cold).  The flush is queued before the
    first event, so the events hide the wrapper's host time as long as it
    is shorter than the flush: 512 MiB, ~0.17 ms on an H100, above every
    wrapper's host time (0.03-0.08 ms, ``host_split``)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.float32,
                                 device="cuda")   # 512 MiB

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

    def device_ms(self, jobs, reps: int = 20) -> list[tuple]:
        """Mean device time of one launch of each job's CUDA kernel, from
        ONE torch.profiler session over ``reps`` calls of every job
        ``(fn, kernel)`` in turn: the kernel alone, without the host's
        launch cost and the wrapper's other ops.  Each job runs inside a
        labelled range, which the profiler also records on the device's
        clock; the launches of the kernel whose name holds ``kernel``
        that start inside the device range are that job's.  (A second
        session in one process has been seen to offset the device clock
        from the host's by milliseconds, and to lose the device events of
        its first milliseconds: so ranges are read on the device side, and
        the session first spends ~50 ms zeroing the flush buffer.)  The
        mean is over the launches recorded, returned with their count; a
        job with fewer than half of ``reps`` fails.  Third in each tuple:
        the device launches of one call of the job's function (kernels,
        copies, fills), read from the same session."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        for fn, _ in jobs:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(300):
                self.flush.zero_()
            torch.cuda.synchronize()
            for i, (fn, _) in enumerate(jobs):
                with record_function(f"chip_smoke job {i}"):
                    for _ in range(reps):
                        self.flush.zero_()
                        fn()
                    torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        ranges = {ev.name: ev.time_range for ev in events
                  if ev.name.startswith("chip_smoke job ")}
        launches = [(ev.time_range.start, ev.name,
                     ev.time_range.elapsed_us()) for ev in events
                    if not ev.name.startswith("chip_smoke job ")]
        out = []
        for i, (_, kernel) in enumerate(jobs):
            span = ranges.get(f"chip_smoke job {i}")
            require(span is not None, f"profiler: no device range for job "
                    f"{i} ({kernel})")
            inside = [(name, t) for start, name, t in launches
                      if span.start <= start <= span.end]
            us = [t for name, t in inside if kernel in name]
            require(2 * len(us) >= reps, f"profiler: {len(us)} launches of "
                    f"{kernel} recorded for job {i}, want {reps}")
            # every device launch of a call but the flush's one fill
            per_call = (len(inside) - reps) / reps
            out.append((statistics.fmean(us) / 1e3, len(us), per_call))
        return out


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


def report(timer, jobs) -> list[dict]:
    """Print each checked kernel's entry with its device-only time per
    call, all from one profiler session; ``jobs`` are (entry, fn, kernel
    name, device launches one call must make, or None where the wrapper
    runs torch ops beside its kernel)."""
    dev = timer.device_ms([(fn, kernel) for _, fn, kernel, _ in jobs])
    for (e, _, _, want), (dev_ms, n, per_call) in zip(jobs, dev):
        lib = "null" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
        print(f"  {e['name']}: err {e['max_abs_err']:.3e}  kernel "
              f"{e['ms']:.4f} ms (device only {dev_ms * (want or 1):.4f} ms "
              f"a call, over {n} launches, {per_call:.2f} device launches "
              f"a call)  plain {e['plain_ms']:.4f} ms  library {lib} ms  "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  launches "
              f"{e['launches']}")
        if want is not None:
            require(per_call == want, f"{e['name']}: {per_call} device "
                    f"launches a call, want {want}")
    return [e for e, _, _, _ in jobs]


# ---------------------------------------------------------------- phase 2
class PathRecorder:
    """Host-side bookkeeping of one path: the shape of every kernel call,
    the packed operands (x_t, sign) of each packed shape, the arguments of
    the first unpacked call at each shape, and the coordinate block of
    every packed step.  It wraps the entry points of
    ``repro_torch.kernels.ops`` that the solver calls; the wrappers
    underneath still count their own launches."""

    def __init__(self, name: str):
        self.name = name
        self.calls = Counter()     # (kernel, shape) -> calls
        self.operands = {}         # (S, d, n_pad, b) -> (x_t, sign)
        self.unpacked = {}         # (kernel, shape) -> first call's args
        self.blocks = []           # idx (S, b) of every packed step

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

        def unpacked(name):
            def call(cols, *args, **kw):
                key = (name, tuple(cols.shape))
                self.calls[key] += 1
                self.unpacked.setdefault(key, (cols, *args))
                return self.saved[name](cols, *args, **kw)
            return call

        for name, fn in (("fwht", fwht),
                         ("momentum_dot_packed", momentum_dot_packed),
                         ("mwu_update_packed", mwu_update_packed),
                         ("momentum_dot", unpacked("momentum_dot")),
                         ("mwu_update", unpacked("mwu_update"))):
            setattr(ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def take_schedule(self):
        """The (steps, b) coordinate schedule of the packed fit just run
        (every client's row is the server's one draw)."""
        import torch
        sched = torch.stack(self.blocks)[:, 0, :].cpu().numpy()
        self.blocks = []
        return sched

    def check_counts(self, counts: dict, kernels) -> None:
        """Every kernel of the path was launched, and each launch was a
        call this recorder saw."""
        for name in kernels:
            require(counts.get(name, 0) > 0, f"{self.name}: {name} was "
                    "never launched")
        for name in KERNELS:
            seen = sum(c for (k, _), c in self.calls.items() if k == name)
            require(seen == counts.get(name, 0), f"{self.name}: {name}: "
                    f"{counts.get(name, 0)} launches counted, {seen} calls "
                    "recorded")


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
    """Path a: both serial fits, with the launch counts reset just before
    and read just after.  Returns [(spec, fitted estimator, data,
    schedule)]."""
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
    print(f"path a launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    return done


DIST_FITS = (
    # label, data, solver arguments, alpha (nu = 1/(alpha min(n1, n2)))
    ("Figure 3 hard margin k=20 n=10000 d=256",
     ("separable", (10_000, 256), dict(seed=0)),
     dict(k=20, eps=1e-3, beta=0.1, num_iters=6000, record_every=1000),
     None),
    ("Figure 4 nu-SVM k=20 n=6000 d=512",
     ("non_separable", (6000, 512), dict(beta2=0.25, seed=512)),
     dict(k=20, eps=1e-3, beta=0.1, num_iters=5000, record_every=1000),
     0.85),
)


def dist_problem(spec):
    """The two classes and nu of a distributed fit, as
    benchmarks/fig3_dist_hard_margin.py and fig4_dist_nusvm.py build
    them."""
    from repro_torch.core import preprocess as pp
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    _label, (gen, args, gkw), _kw, alpha = spec
    ds = getattr(synthetic, gen)(*args, **gkw)
    xp, xm = split_classes(ds.x, ds.y)
    nu = 0.0 if alpha is None else 1.0 / (alpha * min(len(xp), len(xm)))
    return xp, xm, nu


def expected_collectives(res, steps: int, d: int):
    """The client reductions a B = 1 distributed solve must tally: the
    model's per-iteration multiset for every step, and one (d,) sum per
    chunk for the objective."""
    expect = Counter({key: n * steps for key, n in
                      res.comm.collective_multiset().items()})
    expect["all-reduce", "add", d] += len(res.history)
    return expect


def run_dist_fit(torch, spec):
    """One distributed fit through preprocess, solve_distributed and the
    recovery of w, checked; returns its record."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine
    from repro_torch.core import preprocess as pp
    from repro_torch.kernels import ops

    label, _data, kw, _alpha = spec
    xp, xm, nu = dist_problem(spec)
    launches = Counter(ops.launch_counts)
    colls = Counter(engine.collective_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    res = dist.solve_distributed(pre.xp, pre.xm, nu=nu, device="cuda", **kw)
    w = pp.recover_direction(res.state.w[0], pre)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = Counter(ops.launch_counts) - launches
    colls = Counter(engine.collective_counts) - colls
    steps = res.history[-1][0]
    objs = [o for *_, o in res.history]
    d = pre.xp.shape[1]
    per_step = res.comm.collectives_per_iteration()
    client_spread = (res.state.w - res.state.w[0]).abs().max().item()
    print(f"{label}: {secs:.3f} s fit, {secs / steps * 1e3:.4f} ms/step "
          f"over {steps} steps, k={kw['k']}, nu={nu:.6g}, "
          f"{res.scalars_sent:.0f} scalars sent ({per_step} collectives "
          f"per step)")
    print(f"  history {[(m, o) for m, _, o in res.history]}")
    print(f"  launches {dict(launches)}")
    print(f"  client reductions {dict(colls)}")
    require(steps == kw["num_iters"], f"{label}: ran {steps} steps")
    require(all(launches[k] == steps for k in PACKED)
            and not any(launches[k] for k in UNPACKED),
            f"{label}: want one launch of each packed kernel per step")
    require(launches["fwht"] == 3,
            f"{label}: want 3 fwht launches (2 preprocessing, 1 recovery)")
    require(per_step == (29 if nu > 0 else 3),
            f"{label}: the model counts {per_step} collectives per step")
    require(colls == expected_collectives(res, steps, d),
            f"{label}: tallied client reductions differ from the model")
    require(all(math.isfinite(o) for o in objs), f"{label}: non-finite")
    require(objs[-1] < objs[0], f"{label}: objective does not fall")
    require(torch.isfinite(w).all().item(), f"{label}: non-finite w")
    print(f"  every client's w within {client_spread:.3e} of client 0's "
          f"(tol {CLIENT_ATOL})")
    require(client_spread <= CLIENT_ATOL, f"{label}: clients' w differ")
    return dict(spec=spec, pre=pre, nu=nu, res=res, secs=secs)


def dist_path(torch, rec: PathRecorder):
    """Path b: both distributed fits, counts reset just before and read
    just after.  Returns their records, each with its schedule."""
    from repro_torch.kernels import ops

    ops.launch_counts.clear()
    done = []
    with rec:
        for spec in DIST_FITS:
            fit = run_dist_fit(torch, spec)
            fit["sched"] = rec.take_schedule()
            done.append(fit)
    counts = dict(ops.launch_counts)
    print(f"path b launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    return done


def max_state_diff(a, b) -> dict:
    """Largest differences of two per-class states: w, u, and the dual
    weights exp(log)."""
    import torch
    return {
        "w": (a.w - b.w).abs().max().item(),
        "weights": max((torch.exp(x) - torch.exp(y)).abs().max().item()
                       for x, y in ((a.log_eta, b.log_eta),
                                    (a.log_xi, b.log_xi))),
        "u": max((x - y).abs().max().item()
                 for x, y in ((a.u_p, b.u_p), (a.u_m, b.u_m))),
    }


def reference_path(torch, rec: PathRecorder, fig3):
    """Path c: the unpacked reference step against the packed solves on
    the Figure 3 data and coordinates, k=20 and serially, 80 steps; then
    4 steps at B=128.  4 unpacked launches per step, 2 packed."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine, saddle
    from repro_torch.kernels import ops

    pre, sched, k = fig3["pre"], fig3["sched"], fig3["spec"][2]["k"]
    n1, d = pre.xp.shape
    n2 = pre.xm.shape[0]
    iters = 80
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1)
    host = [t.cpu().numpy() for t in (pre.xp, pre.xm)]
    xp_sh, mask_p = dist.shard_points(host[0], k)
    xm_sh, mask_m = dist.shard_points(host[1], k)
    xps = torch.as_tensor(xp_sh, device="cuda")
    xms = torch.as_tensor(xm_sh, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(128)
    idx128 = engine.draw_blocks(g, d, 128, 4, torch.device("cuda"))
    params128 = saddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=128)

    def counted(fn, label=None, steps=None):
        before = Counter(ops.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if label is not None:
            print(f"  {label}: {(time.perf_counter() - t0) / steps * 1e3:.4f}"
                  f" ms/step over {steps} steps")
        return out, Counter(ops.launch_counts) - before

    def compare(label, got, want, steps, unpacked):
        diff = max_state_diff(got, want)
        print(f"  {label}: {diff} (tol {REF_ATOL}); reference launches "
              f"{dict(unpacked)}")
        require(max(diff.values()) <= REF_ATOL, f"{label}: differ")
        require(unpacked == Counter({"momentum_dot": 2 * steps,
                                     "mwu_update": 2 * steps}),
                f"{label}: want 4 unpacked launches per step")

    def packed_launches(label, counts, steps):
        require(counts == Counter({"momentum_dot_packed": steps,
                                   "mwu_update_packed": steps}),
                f"{label}: want 2 packed launches per step, got "
                f"{dict(counts)}")

    ops.launch_counts.clear()
    t0 = time.perf_counter()
    with rec:
        sched_t = torch.as_tensor(sched[:iters], device="cuda")
        (ref, _), c_ref = counted(lambda: dist.run_chunk_sim(
            dist.init_sharded_state(n1, n2, d, mask_p, mask_m,
                                    device="cuda"),
            xps, xms, iters, params=params, idx=sched_t),
            f"reference chunk, k={k}", iters)
        pk, c_pk = counted(lambda: dist.solve_distributed(
            pre.xp, pre.xm, k=k, num_iters=iters,
            idx_schedule=sched[:iters], device="cuda"))
        packed_launches("packed k=20", c_pk, iters)
        compare(f"reference vs packed, k={k}, {iters} steps", ref,
                pk.state, iters, c_ref)

        (sref, _), c_sref = counted(lambda: engine.run_chunk(
            saddle.init_state(n1, n2, d, pre.xp), pre.xp, pre.xm,
            iters, params=params, idx=sched_t), "reference chunk, serial",
            iters)
        spk, c_spk = counted(lambda: saddle.solve(
            pre.xp, pre.xm, num_iters=iters, idx_schedule=sched[:iters],
            device="cuda"))
        packed_launches("packed serial", c_spk, iters)
        compare(f"reference vs packed, serial, {iters} steps", sref,
                spk.state, iters, c_sref)

        (ref128, _), c_ref128 = counted(lambda: dist.run_chunk_sim(
            dist.init_sharded_state(n1, n2, d, mask_p, mask_m,
                                    device="cuda"),
            xps, xms, 4, params=params128, idx=idx128))
        pk128, c_pk128 = counted(lambda: dist.solve_distributed(
            pre.xp, pre.xm, k=k, num_iters=4 * 128, block_size=128,
            idx_schedule=idx128.cpu().numpy(), device="cuda"))
        packed_launches("packed k=20 B=128", c_pk128, 4)
        compare(f"reference vs packed, k={k}, B=128, 4 steps", ref128,
                pk128.state, 4, c_ref128)
    rec.blocks = []
    counts = dict(ops.launch_counts)
    print(f"path c: {time.perf_counter() - t0:.2f} s, launches {counts}")
    rec.check_counts(counts, UNPACKED + PACKED)


# above 32,768 features: d = 40,000 pads to d_pad = 65,536, where a row
# no longer fits one block's shared memory and the FWHT takes two passes;
# n = 1,500 keeps x_t (65,536 x 1,536 floats) at 403 MB
WIDE_FIT = ("hard-margin n=1500 d=40000 (d_pad=65536) B=1", "SaddleSVC",
            dict(eps=1e-3, beta=0.1, num_iters=300, record_every=100),
            ("separable", (1500, 40_000), dict(seed=40_000)))


def wide_path(torch, rec: PathRecorder):
    """Path d: the fit above 32,768 features, counts reset just before and
    read just after; every FWHT of it takes two passes.  Returns [(spec,
    fitted estimator, data, schedule)]."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import fwht_plan

    clf, ds = make_fit(WIDE_FIT, "cuda")
    ops.launch_counts.clear()
    t0 = time.perf_counter()
    with rec:
        run_fit(torch, WIDE_FIT[0], clf, ds, WIDE_FIT[2]["num_iters"])
        done = [(WIDE_FIT, clf, ds, rec.take_schedule())]
    counts = dict(ops.launch_counts)
    print(f"path d: {time.perf_counter() - t0:.2f} s, launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    shapes = [shape for (name, shape) in rec.calls if name == "fwht"]
    print(f"  fwht shapes {shapes}: device passes "
          f"{[fwht_plan(d).device_launches for _, d in shapes]}")
    require(shapes and all(fwht_plan(d).device_launches == 2
                           for _, d in shapes),
            "path d: want every FWHT in two passes")
    return done


def serial_vs_dist(torch, fits):
    """Each distributed fit refit serially on the coordinates it drew."""
    from repro_torch.core import saddle

    for fit in fits:
        label, _data, kw, _alpha = fit["spec"]
        pre, res = fit["pre"], fit["res"]
        t0 = time.perf_counter()
        ser = saddle.solve(pre.xp, pre.xm, nu=fit["nu"], eps=kw["eps"],
                           beta=kw["beta"], num_iters=kw["num_iters"],
                           record_every=kw["record_every"],
                           idx_schedule=fit["sched"], device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dw = (ser.state.w - res.state.w[0]).abs().max().item()
        objs = [(m, o) for m, _, o in res.history]
        print(f"{label}: serial on the same coordinates {secs:.3f} s "
              f"({secs / kw['num_iters'] * 1e3:.4f} ms/step); max|dw| "
              f"{dw:.3e} (tol {FIT_ATOL})")
        print(f"  serial history      {ser.history}")
        print(f"  distributed history {objs}")
        require(dw <= FIT_ATOL, f"{label}: serial and distributed differ")


# ---------------------------------------------------------------- phase 3
def check_fwht(torch, timer, g, n, d, launches, path):
    """The FWHT at (n, d) against its plain version (1e-4; bit-equality
    printed), with its times beside ``x @ H`` (H the normalized Hadamard
    matrix, where it fits: d < 32,768) and a copy of the same bytes under
    the same events; one call must be as many device launches as its plan
    has passes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fwht import fwht_plan

    x = torch.randn((n, d), generator=g, device="cuda")
    out = ops.fwht(x)
    want = ref.fwht_ref(x)
    err = (out - want).abs().max().item()
    require(err <= 1e-4, f"fwht n={n} d={d} disagrees with its plain "
            f"version: {err}")
    require(torch.equal(out, ops.fwht(x)), "fwht is not deterministic")
    plan = fwht_plan(d)
    library = None
    if d < 32_768:
        had = ref.fwht_ref(torch.eye(d, device="cuda"))   # normalized H
        library = timer(lambda: x @ had)
        del had
    copy = torch.empty_like(x)
    copy_ms = timer(lambda: copy.copy_(x))
    e = entry("fwht", f"fwht[n={n},d={d},path {path}]", err,
              timer(lambda: ops.fwht(x)), timer(lambda: ref.fwht_ref(x)),
              library, nbytes=2 * 4 * n * d, ops=n * d * (math.log2(d) + 1))
    e["launches"] = launches
    print(f"  fwht[n={n},d={d}]: variant {plan.variant} ({plan.d1} x "
          f"{plan.d2}, {plan.device_launches} pass(es)), max error "
          f"{err:.3e}, bit-equal to the plain version "
          f"{torch.equal(out, want)}; wrapper {e['ms']:.4f} ms, copy of the "
          f"same bytes {copy_ms:.4f} ms, bound {e['bound_ms']:.4f} ms, "
          f"x @ H {'null' if library is None else f'{library:.4f}'} ms")
    return e, lambda: ops.fwht(x), "fwht_", plan.device_launches


def step_inputs(torch, g, x_t, sign, b, main_path: bool = True):
    """Duals, u and the step's scalars for a packed call on (x_t, sign):
    per-class log weights near uniform, -1e30 on padding.  The scalars are
    the main path's for this n, d and b, or else the fixed ones of the JAX
    package's kernel tests (gamma = 1e-3, tau = 40, d_eff = d, theta =
    0.95), which go with their unscaled Gaussian rows."""
    from repro_torch.core import engine, saddle

    rows, d, n_pad = x_t.shape
    dev = x_t.device
    n1, n2 = int((sign > 0).sum()), int((sign < 0).sum())
    noise = 0.1 * torch.randn((rows, n_pad), generator=g, device=dev)
    ll = torch.where(sign > 0, -math.log(n1) + noise,
                     torch.where(sign < 0, -math.log(n2) + noise,
                                 torch.full_like(noise, -1e30)))
    lp = ll + 0.05 * torch.randn((rows, n_pad), generator=g,
                                 device=dev) * (sign != 0)
    u = 0.1 * torch.randn((rows, n_pad), generator=g, device=dev)
    if main_path:
        sp = engine.stack_slot_params([engine.slot_params_row(
            saddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=b))]
            * rows, dev)
        theta, mwu_c, mwu_dot, d_eff = sp.theta, sp.mwu_c, sp.mwu_dot, d / b
    else:
        gamma, tau, d_eff = 1e-3, 40.0, float(d)
        theta = torch.full((rows,), 0.95, device=dev)
        mwu_c = torch.full((rows,), 1.0 / (gamma + d_eff / tau), device=dev)
        mwu_dot = torch.full((rows,), d_eff / tau, device=dev)
    # one draw for every row, as the server broadcasts it to the clients
    idx = torch.randperm(d, generator=g, device=dev)[:b].to(
        torch.int32)[None].expand(rows, b).contiguous()
    dw = (0.01 * torch.randn((1, b), generator=g, device=dev)).expand(
        rows, b).contiguous()
    return dict(ll=ll, lp=lp, u=u, theta=theta, mwu_c=mwu_c,
                mwu_dot=mwu_dot, d_eff=d_eff, idx=idx, dw=dw)


def packed_errors(torch, name, got, want, real) -> dict:
    """{output: (error, tolerance)} of a packed kernel's result: delta
    within 1e-4 of its largest value (and 1e-4 at most); log_new on real
    points and each class's lse = m + log(s) within 1e-4, u within 1e-5
    (tests/test_kernels.py)."""
    if name == "momentum_dot_packed":
        scale = want.abs().max().item()
        return {"delta": ((got - want).abs().max().item(),
                          min(1e-4, 1e-4 * scale))}
    lse = [r[2] + torch.log(r[3]) for r in (got, want)]
    return {"log_new": ((got[0][real] - want[0][real]).abs().max().item(),
                        1e-4),
            "lse": ((lse[0] - lse[1]).abs().max().item(), 1e-4),
            "u": ((got[1] - want[1]).abs().max().item(), 1e-5)}


def merged_partials(torch, log_new, sign, leave_out_last: bool = False):
    """(m, s) (S, 2) of packed log weights by the plain per-tile partials
    merged in tile order (``ref.merge_class_partials``): the oracle of the
    kernel's in-kernel merge.  With ``leave_out_last`` each slot's last
    tile that holds a real point is left out (given (NEG, 0))."""
    from repro_torch.kernels import ref

    parts = ref.class_partials(log_new, sign)
    if leave_out_last:
        real = (sign != 0).reshape(parts.shape[0], parts.shape[1], -1)
        tiles = torch.arange(parts.shape[1], device=parts.device)
        last = (real.any(-1) * tiles).argmax(-1)
        gone = torch.tensor([-1e30, 0.0, -1e30, 0.0], device=parts.device)
        parts = parts.clone()
        parts[torch.arange(parts.shape[0]), last] = gone
    return ref.merge_class_partials(parts)


def packed_faults(torch, name, b, args, got, sign) -> dict:
    """What a faulty packed kernel would return on these operands:
    momentum_dot_packed with theta taken as 0, or with the kernel's last
    row group (rows j = G - 1 mod G, G = 8 / tiles per block) left out of
    delta; mwu_update_packed with u left out, or with each slot's last
    tile that holds a real point left out of the merged (m, s)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.saddle_update import packed_tiles_per_block

    if name == "momentum_dot_packed":
        x_t, idx, ll, lp, sign, theta = args
        groups = 8 // packed_tiles_per_block(b)
        gone = got.clone()
        gone[:, groups - 1::groups] = 0.0
        return {"theta = 0": ref.momentum_dot_packed_ref(
                    x_t, idx, ll, lp, sign, torch.zeros_like(theta)),
                "last row group left out": gone}
    x_t, idx, ll, u, *rest = args
    return {"u = 0": ref.mwu_update_packed_ref(
                x_t, idx, ll, torch.zeros_like(u), *rest),
            "last tile left out": (got[0], got[1]) + merged_partials(
                torch, got[0], sign, leave_out_last=True)}


def host_split(torch, name, args, calls: int = 1000) -> dict:
    """A wrapper's host time per call (the unpacked MWU's with
    ``normalize=False``, as the reference step calls it), split: its
    validation (``check_packed`` / ``check_unpacked``), its
    allocations (the same ``torch.empty`` calls and workspace look-up),
    the ctypes call of the C launcher with the pointers ready, and the
    rest (geometry, pointers, stream, device check, launch count, views),
    the whole wrapper's time less the three.  Each is the mean over
    ``calls`` calls between two synchronisations, by time.perf_counter,
    in ms."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import saddle_update as su

    lib = build.library("saddle_update")
    if name == "momentum_dot":
        cols, ll, lp, theta = args
        lead, n, b = su.check_unpacked(cols, dict(log_lam=ll, log_prev=lp))
        dev = cols.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        k = lead[0] if lead else 1
        lanes, points, blocks, chunks = su.momentum_dot_geometry(k, n, b)
        floats = k * chunks * blocks * su.DOT_COLS

        def validate():
            su.check_unpacked(cols, dict(log_lam=ll, log_prev=lp))

        def allocate():
            torch.empty(lead + (b,), dtype=torch.float32, device=dev)
            su.workspace(dev, k * chunks, floats)

        out = torch.empty(lead + (b,), dtype=torch.float32, device=dev)
        counters, parts = su.workspace(dev, k * chunks, floats)
        ptrs = [t.data_ptr() for t in (cols, ll, lp)]
        ptrs2 = [t.data_ptr() for t in (out, parts, counters)]
        vec4 = int(b % 4 == 0 and cols.data_ptr() % 16 == 0)

        def call():
            lib.momentum_dot_f32(*ptrs, float(theta), *ptrs2, k, n, b, lanes,
                                 points, vec4, stream)

        def whole():
            ops.momentum_dot(*args)

        return _split(torch, calls, validate, allocate, call, whole)
    if name == "mwu_update":
        cols, ll, u, dw, *scalars = args
        vecs = dict(log_lam=ll, u=u)
        lead, n, b = su.check_unpacked(cols, vecs, dw)
        dev = cols.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        k = lead[0] if lead else 1
        lanes, points, blocks = su.mwu_update_geometry(k, n, b)

        def validate():
            su.check_unpacked(cols, vecs, dw)

        def allocate():
            torch.empty_like(ll)
            torch.empty_like(u)
            torch.empty((2, k), dtype=torch.float32, device=dev)
            su.workspace(dev, k, 2 * k * blocks)

        outs = [torch.empty_like(ll), torch.empty_like(u),
                torch.empty((2, k), dtype=torch.float32, device=dev)]
        counters, parts = su.workspace(dev, k, 2 * k * blocks)
        ptrs = [t.data_ptr() for t in (cols, ll, u, dw)]
        ptrs2 = [t.data_ptr() for t in (*outs, parts, counters)]
        scal = [float(v) for v in scalars]
        vec4 = int(b % 4 == 0 and cols.data_ptr() % 16 == 0)

        def call():
            lib.mwu_update_f32(*ptrs, *scal, 0, *ptrs2, k, n, b, lanes,
                               points, vec4, stream)

        def whole():
            ops.mwu_update(*args, normalize=False)

        return _split(torch, calls, validate, allocate, call, whole)

    x_t, idx = args[:2]
    s, d, n_pad = x_t.shape
    b = idx.shape[1]
    tiles = n_pad // su.LANE
    dev = x_t.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tpb = su.packed_tiles_per_block(b)
    if name == "momentum_dot_packed":
        _, _, ll, lp, sign, theta = args

        def validate():
            su.check_packed(x_t, idx, dict(log_lam=ll, log_prev=lp,
                                           sign=sign), dict(theta=theta))

        def allocate():
            torch.empty((s, b), dtype=torch.float32, device=dev)
            su.workspace(dev, s, s * tiles * (-(-b // 4) * 4))

        out = torch.empty((s, b), dtype=torch.float32, device=dev)
        counters, parts = su.workspace(dev, s, s * tiles * (-(-b // 4) * 4))
        ptrs = [t.data_ptr() for t in (x_t, idx, ll, lp, sign, theta, out,
                                       parts, counters)]

        def call():
            lib.momentum_dot_packed_f32(*ptrs, s, d, n_pad, b, tpb, stream)

        def whole():
            ops.momentum_dot_packed(*args)
    else:
        _, _, ll, u, dw, sign, mwu_c, mwu_dot, d_eff = args

        def validate():
            su.check_packed(x_t, idx, dict(log_lam=ll, u=u, sign=sign),
                            dict(mwu_c=mwu_c, mwu_dot=mwu_dot),
                            rows=dict(dw=dw))

        def allocate():
            torch.empty_like(ll)
            torch.empty_like(u)
            torch.empty((2, s, 2), dtype=torch.float32, device=dev)
            su.workspace(dev, s, s * tiles * 4)

        outs = [torch.empty_like(ll), torch.empty_like(u),
                torch.empty((2, s, 2), dtype=torch.float32, device=dev)]
        counters, parts = su.workspace(dev, s, s * tiles * 4)
        ptrs = [t.data_ptr() for t in (x_t, idx, dw, ll, u, sign, mwu_c,
                                       mwu_dot)]
        ptrs2 = [t.data_ptr() for t in (*outs, parts, counters)]

        def call():
            lib.mwu_update_packed_f32(*ptrs, float(d_eff), *ptrs2, s, d,
                                      n_pad, b, tpb, stream)

        def whole():
            ops.mwu_update_packed(*args)

    return _split(torch, calls, validate, allocate, call, whole)


def _split(torch, calls, validate, allocate, call, whole) -> dict:
    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    split = {part: per_call(fn) for part, fn in (
        ("validation", validate), ("allocation", allocate),
        ("ctypes call", call), ("wrapper", whole))}
    split["rest"] = split["wrapper"] - sum(
        split[k] for k in ("validation", "allocation", "ctypes call"))
    return split


def check_packed(torch, timer, g, x_t, sign, b, launches,
                 main_path: bool = True, path: str = ""):
    """Both packed kernels on (x_t, sign) with b sampled rows, every row
    (slot or client) given the same block: each against its plain
    version (``packed_errors``), the MWU's (m, s) also against the plain
    merge of the per-tile partials of its own log_new, the same bits on a
    repeat call, every planted fault (``packed_faults``) breaking a
    tolerance, the wrapper's host time split (``host_split``); returns
    their timing jobs."""
    from repro_torch.kernels import ops, ref

    rows, d, n_pad = x_t.shape
    a = step_inputs(torch, g, x_t, sign, b, main_path)
    ll, lp, u, idx, dw, theta, mwu_c, mwu_dot, d_eff = (a[k] for k in (
        "ll", "lp", "u", "idx", "dw", "theta", "mwu_c", "mwu_dot", "d_eff"))
    tag = f",{path} operands" if main_path else ",synthetic layout"
    real = sign != 0
    label = f"[S={rows},d={d},n_pad={n_pad},b={b}{tag}]"
    dot_args = (x_t, idx, ll, lp, sign, theta)
    # The MWU's log_new spreads over hundreds at b = 128, so that one
    # point carries a class: each slot's last real point is raised to 1
    # above the largest log_new of its class (log_new is affine in its
    # log weight with slope mwu_c * mwu_dot), so a merge that leaves out
    # the last tile shows.
    log0 = ref.mwu_update_packed_ref(x_t, idx, ll, u, dw, sign, mwu_c,
                                     mwu_dot, d_eff)[0]
    last = last_real(torch, ll)
    same = sign == sign.gather(-1, last)
    top = torch.where(same, log0, -math.inf).amax(-1, keepdim=True)
    ll_m = ll.scatter_add(-1, last, (top + 1 - log0.gather(-1, last))
                          / (mwu_c * mwu_dot)[:, None])
    mwu_args = (x_t, idx, ll_m, u, dw, sign, mwu_c, mwu_dot, d_eff)
    lam = torch.exp(ll)
    mom = sign * (lam + theta[:, None] * (lam - torch.exp(lp)))
    idx_l = idx[0].long()
    # a practical floor beside the bound: one contiguous read of as many
    # bytes as the sampled rows (b rows of every slot), by torch.sum
    stream_ms = timer(lambda: x_t[:, :b].sum())
    jobs = []
    for name, args, plain, library, nbytes, ops_ in (
            ("momentum_dot_packed", dot_args, ref.momentum_dot_packed_ref,
             lambda: x_t[:, idx_l] @ mom[..., None],
             4 * rows * (n_pad * (b + 3) + 2 * b + 1),
             rows * n_pad * (2 * b + 6)),
            ("mwu_update_packed", mwu_args, ref.mwu_update_packed_ref, None,
             4 * rows * (n_pad * (b + 5) + 2 * b + 6),
             rows * n_pad * (2 * b + 12))):
        kernel = getattr(ops, name)

        def fn(kernel=kernel, args=args):
            return kernel(*args)

        got, want = fn(), plain(*args)
        errs = packed_errors(torch, name, got, want, real)
        if name == "mwu_update_packed":
            require((got[0][~real] < -1e20).all().item(),
                    f"{name}{label}: padding lanes not below -1e20")
            merged = merged_partials(torch, got[0], sign)
            merge_err = (got[2] + torch.log(got[3]) - merged[0]
                         - torch.log(merged[1])).abs().max().item()
            errs["merge"] = (merge_err, 1e-4)
        require(all(e <= tol for e, tol in errs.values()),
                f"{name}{label}: {errs}")
        again = fn()
        same = (torch.equal(got, again) if name == "momentum_dot_packed"
                else all(torch.equal(p, q) for p, q in zip(got, again)))
        require(same, f"{name}{label}: not deterministic")
        caught = {}
        for fault, out in packed_faults(torch, name, b, args, got,
                                        sign).items():
            ferrs = packed_errors(torch, name, out, want, real)
            caught[fault] = max(e / tol for e, tol in ferrs.values())
            require(caught[fault] > 1, f"{name}{label}: the check would "
                    f"pass a kernel with {fault}: {ferrs}")
        split = host_split(torch, name, args)
        print(f"  {name}{label}: errors " + ", ".join(
            f"{k} {e:.3e} (tol {tol:.1e})" for k, (e, tol) in errs.items())
            + "; planted faults break the tolerance by " + ", ".join(
                f"{f} {r:.3g}x" for f, r in caught.items())
            + "; host ms per call " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items())
            + f"; a contiguous read of the rows' bytes {stream_ms:.4f} ms")
        e = entry(name, name + label, max(err for err, _ in errs.values()),
                  timer(fn), timer(lambda: plain(*args)),
                  None if library is None else timer(library),
                  nbytes=nbytes, ops=ops_)
        e["launches"] = launches
        jobs.append((e, fn, name + "_kernel", 1))
    return jobs


def ticket_rounds(torch, g, recs, rounds: int = 3):
    """The kernels that share the ticket counters, alternating for
    ``rounds`` rounds: the packed kernels at the path shapes S = 1, b = 1;
    S = 1, b = 128 and S = 20, b = 1, and between them the unpacked
    momentum dot and MWU (both values of ``normalize``) at every shape
    path c gave them and at K = 20, n = 2,048, B = 128, where every
    client takes several blocks and a ticket.  The same bits in every
    round and every ticket counter back at 0 after each round, so a
    launch leaves the counters as it found them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import saddle_update as su

    operands = {shape: xs for rec in recs for shape, xs in
                rec.operands.items()}
    shapes = [min(k for k in operands if k[0] == 1 and k[3] == b)
              for b in (1, 128)]
    shapes.append(min(k for k in operands if k[0] == 20 and k[3] == 1))
    calls = []
    for shape in shapes:
        x_t, sign = operands[shape]
        a = step_inputs(torch, g, x_t, sign, shape[3])
        calls.append(lambda x_t=x_t, sign=sign, a=a: (
            ops.momentum_dot_packed(x_t, a["idx"], a["ll"], a["lp"], sign,
                                    a["theta"]),
            *ops.mwu_update_packed(x_t, a["idx"], a["ll"], a["u"], a["dw"],
                                   sign, a["mwu_c"], a["mwu_dot"],
                                   a["d_eff"])))
    unpacked = [args for rec in recs for (name, _), args in
                rec.unpacked.items() if name == "mwu_update"]
    cols = torch.randn((20, 2048, 128), generator=g, device="cuda")
    unpacked.append((cols, torch.full((20, 2048), -math.log(2048),
                                      device="cuda"),
                     0.1 * torch.randn((20, 2048), generator=g,
                                       device="cuda"),
                     0.01 * torch.randn((20, 128), generator=g,
                                        device="cuda"),
                     1.0, 1e-3, 40.0, 128.0))
    for i, args in enumerate(unpacked):
        calls.insert(min(2 * i + 1, len(calls)), lambda args=args: (
            ops.momentum_dot(args[0], args[1], args[1], 0.5),
            *ops.mwu_update(*args, normalize=False),
            *ops.mwu_update(*args, normalize=True)))
    first = None
    dev = operands[shapes[0]][0].device
    for r in range(rounds):
        outs = [call() for call in calls]
        counters = su.workspace(dev, 1, 1)[0]
        require(not counters.any().item(), f"round {r}: a ticket counter "
                "was not reset")
        if first is None:
            first = outs
        require(all(torch.equal(p, q) for o, f in zip(outs, first)
                    for p, q in zip(o, f)),
                f"round {r}: the ticket kernels gave other bits")
    blocks = [su.mwu_update_geometry(a[0].shape[0] if a[0].ndim == 3 else 1,
                                     *a[0].shape[-2:])[2] for a in unpacked]
    print(f"  ticket counters: {rounds} rounds alternating the packed "
          f"kernels at {shapes} with the unpacked ones at "
          f"{[tuple(a[0].shape) for a in unpacked]} (MWU blocks a client "
          f"{blocks}): same bits every round, every counter 0 after each")


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


def unpacked_state(torch, g, name, args):
    """Fresh state on a recorded unpacked call: its cols, dw and step
    scalars kept, its duals and u drawn anew.  The call the path made
    first saw the starting state (log_prev = log_lam, u = 0, uniform
    weights), on which a kernel that drops the momentum term or u would
    pass; here every point's log weight is near -log(n) with a spread of
    0.5, log_prev differs from it by as much, u is 0.1 N(0, 1), and each
    client's last real point carries the largest weight (of lam for
    momentum_dot, of the updated weights for mwu_update), so that a kernel
    that leaves out the tail of its last tile shows.  Padding (log weight
    -1e30, the round-robin padding of a client shard) stays padding, with
    u = 0."""
    from repro_torch.kernels import ref

    cols, ll_rec = args[0], args[1]
    pad = ll_rec < -1e29

    def noise(scale):
        return scale * torch.randn(ll_rec.shape, generator=g,
                                   device=ll_rec.device)

    def lift(ll, new):
        # raise the last real point's log weight until its ``new`` (affine
        # in it with slope ``slope``) is e times the largest
        last = last_real(torch, ll)
        top = new.amax(-1, keepdim=True) + 1 - new.gather(-1, last)
        return ll.scatter_add(-1, last, top / slope)

    n_real = (~pad).sum(-1, keepdim=True).float()
    ll = torch.where(pad, -1e30, -torch.log(n_real) + noise(0.5))
    if name == "momentum_dot":
        slope = 1.0
        ll = lift(ll, ll)
        lp = torch.where(pad, -1e30, ll + noise(0.5))
        return (cols, ll, lp, args[3])
    u = torch.where(pad, 0.0, noise(0.1))
    _sign, gamma, tau, d_eff = args[4:]
    slope = (d_eff / tau) / (gamma + d_eff / tau)
    new = ref.mwu_update_ref(cols, ll, u, *args[3:], normalize=False)[0]
    return (cols, lift(ll, new), u, *args[3:])


def last_real(torch, ll):
    """Index (..., 1) of each client's last point that is not padding."""
    real = (ll > -1e29).to(torch.int64)
    return (real * torch.arange(ll.shape[-1], device=ll.device)).argmax(
        -1, keepdim=True)


def unpacked_errors(torch, name, got, want, real) -> dict:
    """{output: (error, tolerance)} of an unpacked kernel's result:
    delta within 1e-4 of its largest value (and 1e-4 at most); log_new on
    real points and lse = m + log(s) within 1e-4, u within 1e-5
    (tests/test_kernels.py)."""
    if name == "momentum_dot":
        scale = want.abs().max().item()
        return {"delta": ((got - want).abs().max().item(),
                          min(1e-4, 1e-4 * scale))}
    lse = [r[2] + torch.log(r[3]) for r in (got, want)]
    return {"log_new": ((got[0][real] - want[0][real]).abs().max().item(),
                        1e-4),
            "lse": ((lse[0] - lse[1]).abs().max().item(), 1e-4),
            "u": ((got[1] - want[1]).abs().max().item(), 1e-5)}


def merged_blocks(torch, cols, log_new, leave_out_last: bool = False):
    """(m, s) of the unnormalized log weights (..., n) of an unpacked MWU
    call on ``cols`` by the plain per-block partials of the kernel's
    geometry merged in block order (``ref.merge_block_partials``): the
    oracle of the kernel's in-launch merge.  With ``leave_out_last`` each
    client's last block is left out (given (-1e30, 0)); a client of one
    block then has nothing left."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.saddle_update import mwu_update_geometry

    n, b = cols.shape[-2:]
    k = cols.shape[0] if cols.ndim == 3 else 1
    _, points, _ = mwu_update_geometry(k, n, b)
    pmax, psum = ref.block_partials(log_new, points)
    if leave_out_last:
        pmax, psum = pmax.clone(), psum.clone()
        pmax[..., -1], psum[..., -1] = -1e30, 0.0
    return ref.merge_block_partials(pmax, psum)


def planted_faults(torch, name, args, want) -> dict:
    """What a faulty kernel would return on these operands, from the
    plain version: momentum_dot with theta taken as 0, or with each
    client's last real point left out; mwu_update with u left out, with
    each client's last real point left out of its block's (max,
    sum-exp), or with the merge of its blocks' partials leaving out the
    last block's."""
    from repro_torch.kernels import ref

    last = last_real(torch, args[1])

    def drop(t):
        return t.scatter(-1, last, -1e30)

    if name == "momentum_dot":
        cols, ll, lp, theta = args
        return {"theta = 0": ref.momentum_dot_ref(cols, ll, lp, 0.0),
                "last point left out": ref.momentum_dot_ref(
                    cols, drop(ll), drop(lp), theta)}
    cols, ll, u, *rest = args
    lo = drop(want[0])
    m = lo.amax(-1)
    return {"u = 0": ref.mwu_update_ref(cols, ll, torch.zeros_like(u),
                                        *rest, normalize=False),
            "last point left out": (want[0], want[1], m,
                                    torch.exp(lo - m[..., None]).sum(-1)),
            "last block left out of the merge": (want[0], want[1]) +
            merged_blocks(torch, cols, want[0], leave_out_last=True)}


def check_unpacked(torch, timer, g, name, args, launches, label,
                   on_path: bool, faults: bool | None = None):
    """One unpacked kernel on cols (K, n, B) or (n, B) against its plain
    version (``unpacked_errors``), the same bits on a repeat call, its
    host time split (``host_split``) and its times; the MWU also
    normalized (log_new within 1e-4, u 1e-5), and its (m, s) against the
    plain merge of its own log_new cut by the kernel's blocks
    (``merged_blocks``).  Points at log weight -1e30 (round-robin padding
    of a client shard) are held below -1e20 and left out of the log_new
    error.  On a path's shape (``on_path``) the recorded call's cols, dw
    and step scalars get fresh state (``unpacked_state``); there, and
    wherever ``faults`` asks, each planted fault (``planted_faults``, and
    for the MWU a log_new left unnormalized) must break a tolerance."""
    from repro_torch.kernels import ops, ref

    faults = on_path if faults is None else faults
    if faults:
        args = unpacked_state(torch, g, name, args)
    cols, ll = args[:2]
    k = cols.shape[0] if cols.ndim == 3 else 1
    n, b = cols.shape[-2:]
    label = f"{name}[{'K=%d,' % k if cols.ndim == 3 else ''}n={n},b={b}" \
            f"{label}]"
    if name == "momentum_dot":
        def fn():
            return ops.momentum_dot(*args)

        def plain():
            return ref.momentum_dot_ref(*args)

        lam = torch.exp(ll)
        mom = lam + args[3] * (lam - torch.exp(args[2]))
        library = timer(lambda: cols.transpose(-1, -2) @ mom[..., None])
        nbytes, ops_ = 4 * k * (n * (b + 2) + b), k * n * (2 * b + 6)
        kernel = "momentum_dot_kernel"
    else:
        def fn():
            return ops.mwu_update(*args, normalize=False)

        def plain():
            return ref.mwu_update_ref(*args, normalize=False)

        library = None
        nbytes, ops_ = 4 * k * (n * (b + 4) + b + 2), k * n * (2 * b + 12)
        kernel = "mwu_update_kernel"
    got, want = fn(), plain()
    real = ll > -1e29
    errs = unpacked_errors(torch, name, got, want, real)
    if name == "mwu_update":
        require((got[0][~real] < -1e20).all().item(),
                f"{label}: padding not below -1e20")
        merged = merged_blocks(torch, cols, got[0])
        errs["merge"] = ((got[2] + torch.log(got[3]) - merged[0]
                          - torch.log(merged[1])).abs().max().item(), 1e-4)
        norm = ops.mwu_update(*args, normalize=True)
        norm_want = ref.mwu_update_ref(*args, normalize=True)
        require((norm[0][~real] < -1e20).all().item(),
                f"{label}: normalized padding not below -1e20")
        require(all(torch.equal(p, q) for p, q in zip(
            norm, ops.mwu_update(*args, normalize=True))),
            f"{label}: normalized, not deterministic")

        def norm_errors(out):
            return {"normalized log_new": (
                        (out[0][real] - norm_want[0][real]).abs().max()
                        .item(), 1e-4),
                    "normalized u": ((out[1] - norm_want[1]).abs().max()
                                     .item(), 1e-5)}
        errs.update(norm_errors(norm))
    require(all(e <= tol for e, tol in errs.values()), f"{label}: {errs}")
    same = (torch.equal(got, fn()) if name == "momentum_dot" else
            all(torch.equal(p, q) for p, q in zip(got, fn())))
    require(same, f"{label}: not deterministic")
    if faults:
        caught = {}
        for fault, out in planted_faults(torch, name, args, want).items():
            ferrs = unpacked_errors(torch, name, out, want, real)
            caught[fault] = max(e / tol for e, tol in ferrs.values())
            require(caught[fault] > 1, f"{label}: the check would pass a "
                    f"kernel with {fault}: {ferrs}")
        if name == "mwu_update":
            ferrs = norm_errors((want[0], want[1]))
            caught["log_new left unnormalized"] = max(
                e / tol for e, tol in ferrs.values())
            require(caught["log_new left unnormalized"] > 1,
                    f"{label}: the check would pass a kernel that leaves "
                    f"log_new unnormalized: {ferrs}")
        print(f"  {label}: planted faults break the tolerance by "
              + ", ".join(f"{f} {r:.3g}x" for f, r in caught.items()))
    split = host_split(torch, name, args)
    print(f"  {label}: errors " + ", ".join(
        f"{k_} {e:.3e} (tol {tol:.1e})" for k_, (e, tol) in errs.items())
        + "; host ms per call " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in split.items()))
    e = entry(name, label, max(err for err, _ in errs.values()), timer(fn),
              timer(plain), library, nbytes=nbytes, ops=ops_)
    e["launches"] = launches
    if name == "mwu_update":
        print(f"  {label}: normalized, wrapper "
              f"{timer(lambda: ops.mwu_update(*args, normalize=True)):.4f} "
              f"ms by events")
    return e, fn, kernel, 1


def jax_test_shapes(torch, timer, g):
    """The unpacked kernels at the JAX kernel tests' shapes and scalars
    (tests/test_kernels.py) and at ragged B = 3 and 130, with one client
    and with 20."""
    jobs = []
    for lead in ((), (20,)):
        for n, b in ((17, 1), (513, 128), (1025, 8), (2048, 128), (100, 3),
                     (300, 130)):
            def randn(*shape):
                return torch.randn(lead + shape, generator=g, device="cuda")
            cols = randn(n, b)
            ll, lp = randn(n) - 3, randn(n) - 3
            jobs.append(check_unpacked(torch, timer, g, "momentum_dot",
                                       (cols, ll, lp, 0.95), None,
                                       ",JAX test", False))
            u, dw = 0.1 * randn(n), 0.01 * randn(b)
            lu = torch.full(lead + (n,), -math.log(n), device="cuda")
            for sign in (1.0, -1.0):
                jobs.append(check_unpacked(
                    torch, timer, g, "mwu_update",
                    (cols, lu, u, dw, sign, 1e-3, 40.0, 128.0), None,
                    f",JAX test,sign={sign:+.0f}", False))
            if lead and (n, b) == (2048, 128):
                # several blocks a client (the ticket path), with the
                # planted faults on fresh state
                jobs.append(check_unpacked(
                    torch, timer, g, "mwu_update",
                    (cols, lu, u, dw, 1.0, 1e-3, 40.0, 128.0), None,
                    ",JAX test,fresh state", False, faults=True))
    return jobs


def check_kernels(torch, timer, recs) -> list[dict]:
    """Every kernel at every shape of every path (the JSON entries), then
    at the JAX tests' shapes and the synthetic layout (printed only); the
    device-only times of each group from one profiler session."""
    g = torch.Generator(device="cuda").manual_seed(0)
    entries = []
    for rec in recs:
        print(f"  path {rec.name}:")
        jobs = []
        for (name, shape), calls in sorted(rec.calls.items()):
            if name == "fwht":
                jobs.append(check_fwht(torch, timer, g, *shape, calls,
                                       rec.name))
        for shape, (x_t, sign) in sorted(rec.operands.items()):
            jobs += check_packed(torch, timer, g, x_t, sign, shape[3],
                                 rec.calls["momentum_dot_packed", shape],
                                 path=f"path {rec.name}")
        for (name, shape), args in sorted(rec.unpacked.items(),
                                          key=lambda kv: str(kv[0])):
            jobs.append(check_unpacked(
                torch, timer, g, name, args, rec.calls[name, shape],
                f",path {rec.name}", on_path=True))
        entries += report(timer, jobs)
    ticket_rounds(torch, g, recs)
    print("  not on a path (launches null):")
    jobs = [check_fwht(torch, timer, g, max(1, 12_800_000 // d), d, None,
                       "none")
            for d in (1024, 4096, 32_768, 65_536, 131_072)]
    jobs.append(check_fwht(torch, timer, g, 50_000, 512, None, "none"))
    report(timer, jobs)
    jobs = []
    x_t, sign = synthetic_layout(torch, g)
    # b = 3 and 300: a ragged last block of 4 tiles, and a row ring that
    # is refilled (10 stages of 32 rows through 4 buffers)
    for b in (1, 3, 128, 300):
        jobs += check_packed(torch, timer, g, x_t, sign, b, None,
                             main_path=False)
    check_bad_index(torch, g, x_t, sign)
    report(timer, jobs + jax_test_shapes(torch, timer, g))
    return entries


# ---------------------------------------------------------------- phase 4
def profile_window(torch, label, steps, fn):
    """Device busy share and kernel time by name over one call of ``fn``
    (``steps`` solver steps), warm."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                               # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        print(f"profile {label}: the profiler saw no device time (not "
              "measured)")
        return
    launches = sum(r[2] for r in rows)
    print(f"profile ({steps} steps, {label}): wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, "
          f"{wall / steps * 1e3:.4f} ms/step, {launches / steps:.1f} device "
          f"launches/step")
    for dev_us, key, count in rows[:12]:
        print(f"  {dev_us / 1e3:10.3f} ms  {count:7d}x  {key[:90]}")


def profiles(torch, dist_fits):
    """300 steps of the serial nu-SVM solve at the Figure 2 shape, and of
    each distributed fit on its own data and coordinates."""
    from repro_torch.core import distributed as dist
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
    profile_window(torch, "serial nu-SVM n=50000 d=512", 300,
                   lambda: saddle.solve(pre.xp, pre.xm, **kw))
    for fit in dist_fits:
        label, _data, fkw, _alpha = fit["spec"]
        fkw = dict(fkw, num_iters=300, record_every=300)
        profile_window(torch, label, 300, lambda: dist.solve_distributed(
            fit["pre"].xp, fit["pre"].xm, nu=fit["nu"], device="cuda",
            idx_schedule=fit["sched"][:300], **fkw))


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
        print(f"{spec[0]} replayed on the CPU with the card's "
              f"coordinates: {time.perf_counter() - t0:.1f} s")
        compare_fits(f"  card vs CPU, {spec[0]}", card, clf, history=True)


def dist_card_vs_cpu(torch, fit):
    """The first 1,000 steps of a distributed fit on the card and on the
    CPU's plain path, with the coordinates the card drew and the card's
    preprocessed data: w within 1e-4, histories within 1e-3 relative."""
    from repro_torch.core import distributed as dist

    label, _data, kw, _alpha = fit["spec"]
    steps = 1000
    kw = dict(kw, num_iters=steps, record_every=200)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = dist.solve_distributed(
            fit["pre"].xp.to(dev), fit["pre"].xm.to(dev), nu=fit["nu"],
            idx_schedule=fit["sched"][:steps], device=dev, **kw)
        print(f"{label}, {steps} steps on {dev}: "
              f"{time.perf_counter() - t0:.2f} s")
    card, cpu = runs["cuda"], runs["cpu"]
    dw = (card.state.w.cpu() - cpu.state.w).abs().max().item()
    marks = [m for m, *_ in card.history]
    oc = [o for *_, o in card.history]
    oh = [o for *_, o in cpu.history]
    rel = max(abs(a - b) / abs(b) for a, b in zip(oc, oh))
    print(f"  card history {list(zip(marks, oc))}")
    print(f"  CPU history  {list(zip(marks, oh))}")
    print(f"  max|dw| {dw:.3e} (tol {FIT_ATOL}), max relative objective "
          f"difference {rel:.3e} (tol {HIST_RTOL})")
    require(marks == [m for m, *_ in cpu.history], f"{label}: marks differ")
    require(dw <= FIT_ATOL, f"{label}: card and CPU w disagree")
    require(rel <= HIST_RTOL, f"{label}: histories disagree")


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

    recs = [PathRecorder(name) for name in ("a", "b", "c", "d")]
    fits = main_path(torch, recs[0])
    dist_fits = dist_path(torch, recs[1])
    reference_path(torch, recs[2], dist_fits[0])
    fits += wide_path(torch, recs[3])
    serial_vs_dist(torch, dist_fits)
    profiles(torch, dist_fits)
    entries = check_kernels(torch, Timer(torch), recs)
    card_vs_cpu(torch, fits)
    dist_card_vs_cpu(torch, dist_fits[1])

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
