#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and there is
no CPU fallback):

  1. build      -- compile every kernel from ``src/repro_torch/kernels/csrc``
                   with nvcc for sm_90a into ``build/repro_torch_kernels/``.
  2. paths      -- six paths, each driven with the launch counts reset
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
       d. above 32,768 features: two hard-margin fits on
          separable(1500, 40000), padded to d_pad = 65,536, through
          ``SaddleSVC.fit``: 300 steps at B=1 and 200 steps at B=40,000
          (more sampled rows than a packed block holds at once: two
          chunks a call); their 3 FWHTs take two device passes each (a
          row no longer fits one block's shared memory).
       e. the fit service: ``SolverService(num_slots=8, chunk_steps=64)``
          with 12 hard-margin tenants (separable(n, 256), n = 3,000,
          5,000, 8,000: buckets of 4,096 and 8,192 points), 4 nu-SVM
          tenants on Figure 4's data (bucket 8,192 x 512), one with a
          duality-gap stop and a streaming tenant (an append inside its
          rung, then one across it), budgets of 640-1,280 steps; run 1
          cancels a request mid-run, run 2 poisons one lane at its chunk
          2 instead.  Every other request is bit-equal across the runs;
          each completed one equals its solo ``saddle.solve`` on the card
          within 1e-5 (the stream's rounds the solve warm-started from
          the previous round); no chunk after a bucket's first sets up a
          new ``engine.trace_counts`` key; device memory returns to its
          level after the drain; requests per second, ms per chunk and
          step, launches per step and the sampler's host time are
          printed.
       f. real collectives: ``distributed.solve_distributed(mesh=...)``
          with one client a process.  NCCL at world size 1 in this
          process on Figure 3's data (600 steps, bit-equal to the serial
          ``saddle.solve``); then one spawn of 20 gloo ranks over CUDA
          tensors on the one card (NCCL refuses two ranks on one card):
          Figure 3 at k = 20 on path b's first 120 draws, Figure 3 (600
          steps) and Figure 4 (200 steps) at k = 4 on ranks 0-3, each
          within 1e-4 of the simulated solve with the same draws; on
          ranks 0-1 two chunks of 64 steps of an 8-lane 8,192 x 256
          serving bucket point-sharded (within 1e-5 of the unsharded
          chunk), lane-placed (bit-equal) and point-sharded after
          ``drop_slot_shard`` (batch-mates bit-equal).  Every run: 2 packed
          launches a step on every rank, the tallied collectives equal
          to ``CommModel`` / ``ServeCommModel``, the same from the
          profiler's events (``utils.comm_audit``), ms a step and the
          collectives' host time printed (each all-reduce between two
          device synchronisations, so NCCL's is timed to its end; the
          first NCCL run is not timed so, for its ms a step).  The
          packed calls here are recorded by shape as on every path, and
          rank 0 records its own and copies one step's arguments of each
          run to the host, for phase 5.
  3. serial vs distributed -- each distributed fit refit serially on the
                   coordinates it drew: w within 1e-4.
  4. profile    -- short windows of the serial nu-SVM solve, of both
                   distributed fits and of the service (4 chunks of its
                   8,192 x 256 bucket) under torch.profiler: the device's
                   busy share and kernel time by name.
  5. kernels    -- each kernel against its plain PyTorch version on the
                   card, at every shape the paths gave it (on the paths'
                   own data and step scalars, with fresh duals and u), and
                   at the JAX kernel tests' shapes (ragged B = 3 and 130
                   too), a synthetic packed layout and FWHT rows of d =
                   1,024 to 131,072, and the packed kernels at b = 32,769
                   and 65,536 on path d's operands and on path e's
                   recorded calls (8 lanes with their own blocks and
                   scalars, free lanes, a NaN lane after the poison: held
                   on the live lanes, whose bits must equal a call on
                   them alone); path f's too: its references' and NCCL
                   run's shapes here, and rank 0's (one client of k = 20
                   and of k = 4 on Figures 3 and 4, the 8 lanes' point
                   shards, its 4 placed lanes), on their operands with
                   fresh duals and on each run's copied step; its time, its device-only time (one
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
                   the serial fits of paths a and d (the B=40,000 one,
                   whose rounding a block of most of d amplifies, over
                   its first 8 steps, run again on the card), 1,000
                   steps of the Figure 4 distributed fit and one lane of
                   path e replayed on the CPU with the coordinates the
                   card sampled.

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

    def __init__(self, name: str, keep: bool = True,
                 on_device: bool = False):
        self.name = name
        self.keep = keep           # keep operands and blocks (device refs)
        self.on_device = on_device  # capture to device copies (host_copy)
        self.calls = Counter()     # (kernel, shape) -> calls
        self.operands = {}         # (S, d, n_pad, b) -> (x_t, sign)
        self.unpacked = {}         # (kernel, shape) -> first call's args
        self.blocks = []           # idx (S, b) of every packed step
        self.armed = None          # (label, packed steps still to skip)
        self.captured = []         # {label, kernel: host copy of args}

    def arm(self, label: str, skip: int = 1) -> None:
        """Copy to the host the arguments of the packed step ``skip``
        steps on from the next one (the momentum dot's and the MWU's)."""
        self.armed = (label, skip)

    def _capture(self, name, args) -> None:
        host = self.captured[-1].setdefault("host", {})
        self.captured[-1][name] = tuple(
            host.setdefault(a.data_ptr(),
                            a.clone() if self.on_device else a.cpu())
            if hasattr(a, "data_ptr") else a for a in args)

    def host_copy(self) -> dict:
        """What the parent needs to hold this recorder's calls (from a
        spawned rank, whose results travel pickled): the calls by shape
        and the captures as numpy arrays, each tensor copied once."""
        memo = {}
        return dict(calls=dict(self.calls), captured=[
            {key: tuple(memo.setdefault(id(a), a.cpu().numpy())
                        if hasattr(a, "cpu") else a for a in val)
             if key in PACKED else val for key, val in cap.items()}
            for cap in self.captured])

    @classmethod
    def from_host_copy(cls, name: str, copy: dict) -> "PathRecorder":
        """A rank's recorder in the parent: its calls and captures (host
        tensors again), and each captured shape's (x_t, sign) on the card
        as its operands."""
        import numpy as np
        import torch

        rec = cls(name, keep=False)
        rec.calls = Counter(copy["calls"])
        memo = {}
        rec.captured = [
            {key: tuple(memo.setdefault(id(a), torch.from_numpy(a))
                        if isinstance(a, np.ndarray) else a for a in val)
             if key in PACKED else val for key, val in cap.items()}
            for cap in copy["captured"]]
        dev = {}
        for cap in rec.captured:
            x_t, *_, sign, _theta = cap["momentum_dot_packed"]
            rec.operands.setdefault(cap["shape"], tuple(
                dev.setdefault(id(a), a.cuda()) for a in (x_t, sign)))
        return rec

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
            if self.keep:
                self.operands.setdefault(shape, (x_t, args[2]))
                self.blocks.append(idx)
            if self.armed is not None:
                label, skip = self.armed
                self.armed = (label, skip - 1) if skip else None
                if not skip:
                    self.captured.append(dict(label=label, shape=shape))
                    self._capture("momentum_dot_packed", (x_t, idx) + args)
            return self.saved["momentum_dot_packed"](x_t, idx, *args)

        def mwu_update_packed(x_t, idx, *args):
            self.calls["mwu_update_packed", (*x_t.shape, idx.shape[1])] += 1
            last = self.captured[-1] if self.captured else {}
            if "momentum_dot_packed" in last and \
                    "mwu_update_packed" not in last:
                self._capture("mwu_update_packed", (x_t, idx) + args)
                del last["host"]
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


def make_fit(spec, device, ds=None):
    """(estimator, data) of a fit spec; ``ds`` reuses data already made."""
    from repro_torch.core import svm
    from repro_torch.data import synthetic

    _label, cls, kw, (gen, args, gkw) = spec
    return (getattr(svm, cls)(device=device, **kw),
            ds if ds is not None else getattr(synthetic, gen)(*args, **gkw))


def rises(objs) -> list[bool]:
    return [b >= a for a, b in zip(objs, objs[1:])]


def run_fit(torch, label, clf, ds, steps_want, falls: bool = True):
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
    # history.  ``falls=False``: a fit whose block is most of d, where
    # the paper's step sizes (set for one coordinate a step) do not
    # settle in either package; its check is that replay alone.
    print(f"  objective rose at {sum(rises(objs))} of {len(objs) - 1} "
          f"boundaries")
    require(not falls or (objs[-1] < objs[0] and max(objs) <= objs[0]),
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
# n = 1,500 keeps x_t (65,536 x 1,536 floats) at 403 MB.  The second fit
# samples B = 40,000 rows a step, more than a packed block holds in
# shared memory at once (CHUNK_ROWS = 32,768), so both packed kernels
# walk them in two chunks; num_iters counts coordinates (200 steps).  With
# a block of 61 % of the coordinates the paper's step sizes do not settle
# (the JAX package's SaddleSVC on separable(300, 4000) at B = 2,500 of
# 4,096 rises too), so this fit is held to its CPU replay, not to a
# falling objective.
WIDE_DATA = ("separable", (1500, 40_000), dict(seed=40_000))
WIDE_FITS = (
    ("hard-margin n=1500 d=40000 (d_pad=65536) B=1", "SaddleSVC",
     dict(eps=1e-3, beta=0.1, num_iters=300, record_every=100), WIDE_DATA),
    ("hard-margin n=1500 d=40000 (d_pad=65536) B=40000", "SaddleSVC",
     dict(eps=1e-3, beta=0.1, block_size=40_000, num_iters=200 * 40_000,
          record_every=50), WIDE_DATA),
)


# Fits held to the CPU over their first steps only: with a block of most
# of the coordinates the solve amplifies rounding (a relative change of
# 1e-7 in the data moves w by more than 1e-3 over 200 steps,
# tests/test_torch_svm.py::test_large_block_solve_amplifies_rounding),
# and at B = 40,000 of d_pad = 65,536 the MWU's unnormalised log weights
# reach the thousands (mwu_c ~ 1e4), where a float32 step is 2.4e-4 to
# 4.9e-4 and the card and the CPU, rounding in different orders, part
# from the first step; so the card's fit cannot be replayed to 1e-4 over
# its 200 steps.  Over its first 8 it is held to w within 1e-4 and the
# history within 1e-3 relative; b, which sums the weights of every point
# (1e-4 apart after 8 steps), is printed.
REPLAY_PREFIX = {WIDE_FITS[1][0]: 8}


def wide_path(torch, rec: PathRecorder):
    """Path d: both fits above 32,768 features on the same data, counts
    reset just before and read just after; every FWHT of them takes two
    passes.  Returns [(spec, fitted estimator, data, schedule)]."""
    from repro_torch.core import saddle
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import fwht_plan

    ds = make_fit(WIDE_FITS[0], "cuda")[1]
    fits = [make_fit(spec, "cuda", ds) for spec in WIDE_FITS]
    ops.launch_counts.clear()
    t0 = time.perf_counter()
    done = []
    with rec:
        for spec, (clf, _) in zip(WIDE_FITS, fits):
            steps = saddle.resolve_num_iters(
                clf.num_iters, 65_536, clf.eps, clf.beta, len(ds.y),
                clf.block_size)
            run_fit(torch, spec[0], clf, ds, steps,
                    falls=clf.block_size == 1)
            done.append((spec, clf, ds, rec.take_schedule()))
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


# ---------------------------------------------------------------- path e
# The fit service: SolverService(num_slots=8, chunk_steps=64) on the card.
# Hard-margin tenants at Figure 3's width in two point buckets (4,096 and
# 8,192), nu-SVM tenants on Figure 4's data (bucket 8,192 x 512), one with
# a duality-gap stop and one streaming tenant (an append inside its rung,
# then one that jumps to the next rung); budgets of 640 to 1,280 steps, a
# multiple of the chunk as the parity contract wants.
SERVE_SLOTS, SERVE_CHUNK = 8, 64
SERVE_HM = [(n, 100 + i, 640 + 128 * (i % 6))     # n, seed, budget
            for i, n in enumerate((3000, 5000, 8000) * 4)]
SERVE_NU = [(200 + i, 640 + 128 * i) for i in range(4)]   # seed, budget
SERVE_GAP = (3000, 150, 1280, 0.05)       # n, seed, budget, gap_tol
SERVE_STREAM = (300, 640, (3900, 4000, 4200))   # seed, budget, sizes
SERVE_CANCEL = 1      # index of the request cancelled mid-run (n = 5,000)
SERVE_VICTIM = 4      # index of the request poisoned at its chunk 2
SERVE_REPLAY = 0      # index of the request replayed on the CPU
SERVE_ATOL = 1e-5     # service vs solo solve (tests/test_solver_service.py)


def serve_requests():
    """Path e's tenants in submission order, (label, data, FitRequest
    keyword arguments), and the streaming tenant's data."""
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    reqs = [(f"hard-margin #{i} n={n} d=256", synthetic.separable(
                n, 256, seed=i), dict(seed=seed, num_iters=iters))
            for i, (n, seed, iters) in enumerate(SERVE_HM)]
    fig4 = synthetic.non_separable(6000, 512, beta2=0.25, seed=512)
    xp, xm = split_classes(fig4.x, fig4.y)
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    reqs += [(f"nu-SVM seed={seed} n=6000 d=512", fig4,
              dict(seed=seed, num_iters=iters, nu=nu))
             for seed, iters in SERVE_NU]
    n, seed, iters, tol = SERVE_GAP
    reqs.append((f"hard-margin gap_tol={tol} n={n} d=256",
                 synthetic.separable(n, 256, seed=50),
                 dict(seed=seed, num_iters=iters, gap_tol=tol)))
    return reqs, synthetic.separable(SERVE_STREAM[2][-1], 256, seed=77)


def drive_mix(torch, svc, reqs, stream, cancel: bool):
    """Submit path e's requests and the streaming tenant, and step the
    service until it is drained, submitting the tenant's next update when
    its last round is done and, with ``cancel``, cancelling request
    SERVE_CANCEL once it has been running for three steps.  Returns
    ({label: rid}, {label: outcome}, seconds, tenant rid)."""
    from repro_torch.serve.scheduler import Status
    from repro_torch.serve.solver_service import FitRequest, UpdateRequest

    seed, iters, sizes = SERVE_STREAM
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = {label: svc.submit(FitRequest(x=ds.x, y=ds.y, **kw))
            for label, ds, kw in reqs}
    target = rids[reqs[SERVE_CANCEL][0]] if cancel else None
    tenant = svc.submit(FitRequest(x=stream.x[:sizes[0]],
                                   y=stream.y[:sizes[0]], seed=seed,
                                   num_iters=iters, stream=True))
    rids["stream round 0"] = live = tenant
    rounds, running = 1, 0
    while svc._sched.has_work():
        svc.step()
        if target is not None and svc.status(target) is Status.RUNNING:
            running += 1
            if running == 3:
                require(svc.cancel(target), "path e: cancel failed")
                target = None
        if rounds < len(sizes) and svc.status(live) is Status.DONE:
            lo, hi = sizes[rounds - 1], sizes[rounds]
            live = svc.submit_update(UpdateRequest(
                tenant=tenant, x=stream.x[lo:hi], y=stream.y[lo:hi],
                num_iters=iters))
            rids[f"stream round {rounds}"] = live
            rounds += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require(rounds == len(sizes) and target is None,
            "path e: the stream or the cancel did not happen")
    out = svc.run()
    return rids, {label: out[rid] for label, rid in rids.items()}, secs, \
        tenant


def workspace_bytes() -> int:
    """Bytes of the packed kernels' workspaces (grown on first use and
    kept for the process, so left out of the memory check)."""
    from repro_torch.kernels import saddle_update as su
    return sum(t.numel() * t.element_size()
               for ws in su._workspace.values() for t in ws)


def service_path(torch, rec: PathRecorder):
    """Path e: the mix run twice through a fresh service each time, counts
    reset just before the first run and read just after the second.  Run
    1 cancels one request mid-run and records every chunk's host time,
    sampler draws and set-up keys; run 2 poisons one lane at its chunk 2,
    leaves the cancel out, and copies to the host the packed calls of the
    second step of each bucket's first chunk and of the chunk after the
    poison.  Every other request must be bit-equal across the two runs,
    so each run's cancelled or poisoned lane left its batch-mates alone.
    Returns the record of both runs."""
    import numpy as np

    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serve.scheduler import RequestFailure, Status
    from repro_torch.serve.solver_service import SolverService

    reqs, stream = serve_requests()
    labels = [label for label, _, _ in reqs]
    run_chunk, sample_blocks = engine.run_chunk_slots, engine.sample_blocks
    rec_ = dict(chunk_s=[], sample_s=[], draws=[], inj=None)

    def chunk(state, x_t, sign, sp, num_steps, **kw):
        cfg = (tuple(x_t.shape), kw["project"], kw["check_gap"])
        first = cfg not in rec_["seen"]
        rec_["seen"].add(cfg)
        inj = rec_["inj"]
        if inj is not None:
            if first:
                rec.arm(f"first chunk of n_pad={x_t.shape[2]},d="
                        f"{x_t.shape[1]}{',nu' if kw['project'] else ''}"
                        f"{',gap' if kw['check_gap'] else ''}")
            elif len(inj.fired) > rec_["fired"]:
                rec.arm("chunk after the poison")
            rec_["fired"] = len(inj.fired)
        keys = set(engine.trace_counts)
        t = time.perf_counter()
        out = run_chunk(state, x_t, sign, sp, num_steps, **kw)
        rec_["chunk_s"].append((cfg, time.perf_counter() - t))
        require(first or set(engine.trace_counts) == keys,
                "path e: a chunk after its bucket's first set up a key")
        return out

    def sample(gens, d, b, steps, device):
        t = time.perf_counter()
        out = sample_blocks(gens, d, b, steps, device)
        rec_["sample_s"].append(time.perf_counter() - t)
        rec_["draws"].append(([g.initial_seed() for g in gens], out))
        return out

    runs = []
    ops.launch_counts.clear()
    engine.run_chunk_slots = chunk
    try:
        with rec:
            for poison in (False, True):
                rec_.update(seen=set(), fired=0, chunk_s=[], sample_s=[])
                inj = None
                if poison:
                    victim = runs[0]["rids"][labels[SERVE_VICTIM]]
                    inj = FaultInjector(FaultPlan(seed=0, faults=(
                        Fault("poison", rid=victim, at_chunk=2),)))
                rec_["inj"] = inj
                engine.sample_blocks = sample if not poison else \
                    sample_blocks
                keys = set(engine.trace_counts)
                before = Counter(ops.launch_counts)
                base = torch.cuda.memory_allocated() - workspace_bytes()
                svc = SolverService(num_slots=SERVE_SLOTS,
                                    chunk_steps=SERVE_CHUNK,
                                    fault_injector=inj)
                rids, res, secs, tenant = drive_mix(torch, svc, reqs,
                                                    stream, not poison)
                engine.sample_blocks = sample_blocks
                draws = [(seeds, out.cpu()) for seeds, out in
                         rec_.pop("draws")] if not poison else None
                rec_["draws"] = []
                svc.close_stream(tenant)
                mem = torch.cuda.memory_allocated() - workspace_bytes()
                runs.append(dict(
                    rids=rids, res=res, secs=secs, stats=svc.stats,
                    new_keys=set(engine.trace_counts) - keys,
                    launches=Counter(ops.launch_counts) - before,
                    chunk_s=rec_["chunk_s"], sample_s=rec_["sample_s"],
                    draws=draws, mem=(base, mem), inj=inj))
                del svc
    finally:
        engine.run_chunk_slots = run_chunk
        engine.sample_blocks = sample_blocks
    counts = dict(ops.launch_counts)
    print(f"path e launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)

    card = card_line()
    for i, run in enumerate(runs):
        st, done = run["stats"], run["res"]
        ok = [r for r in done.values() if not isinstance(r, RequestFailure)]
        steps = st["chunk_calls"] * SERVE_CHUNK
        lc = run["launches"]
        per_cfg = {}
        for cfg, secs in run["chunk_s"]:
            per_cfg.setdefault(cfg, []).append(secs)
        chunk_ms = statistics.fmean(t for _, t in run["chunk_s"]) * 1e3
        print(f"path e run {i + 1} ({'poison at chunk 2' if i else 'cancel'}"
              f", {card}): {len(done)} requests, {len(ok)} completed in "
              f"{run['secs']:.3f} s: {len(ok) / run['secs']:.3f} requests/s,"
              f" {st['chunk_calls']} chunks of {SERVE_SLOTS} lanes x "
              f"{SERVE_CHUNK} steps: "
              f"{run['secs'] / st['chunk_calls'] * 1e3:.3f} ms/chunk, "
              f"{run['secs'] / steps * 1e3:.4f} ms/step "
              f"(wall, intake and recovery included); launches {dict(lc)}: "
              f"{lc['momentum_dot_packed'] / steps:.3f} + "
              f"{lc['mwu_update_packed'] / steps:.3f} packed a step; set-ups"
              f" {st['compiles']} (new keys {sorted(run['new_keys'])})")
        sampler = (f"{statistics.fmean(run['sample_s']) * 1e3:.3f}"
                   if run["sample_s"] else "not recorded")
        print(f"  host ms a chunk: the chunk call {chunk_ms:.3f} (enqueue, no "
              f"sync; " + ", ".join(
                  f"n_pad={c[0][2]},d={c[0][1]}{',nu' if c[1] else ''}"
                  f"{',gap' if c[2] else ''}: {statistics.fmean(v) * 1e3:.3f}"
                  f" x {len(v)}" for c, v in sorted(per_cfg.items()))
              + f"), its sampler {sampler} ({SERVE_SLOTS} generators drawn "
              "one by one)")
        require(lc["momentum_dot_packed"] == steps
                and lc["mwu_update_packed"] == steps,
                f"path e run {i + 1}: want one launch of each packed kernel"
                f" a step")
        base, mem = run["mem"]
        print(f"  device memory (workspace left out): {base} bytes before "
              f"the first submit, {mem} after the drain")
        require(mem == base, f"path e run {i + 1}: device memory not "
                "released after the drain")
    require(runs[0]["stats"]["compiles"] == len(runs[0]["new_keys"]) == 4,
            "path e: want one set-up for each of the 4 batch configurations")
    require(runs[1]["stats"]["compiles"] == 0 and not runs[1]["new_keys"],
            "path e: the second run set up something new")
    one, two = runs[0]["res"], runs[1]["res"]
    cancelled, victim = labels[SERVE_CANCEL], labels[SERVE_VICTIM]
    require(isinstance(one[cancelled], RequestFailure)
            and one[cancelled].status is Status.CANCELLED
            and "running" in one[cancelled].reason,
            f"path e: {cancelled} was not cancelled while running")
    require(isinstance(two[victim], RequestFailure)
            and two[victim].status is Status.FAILED
            and "non-finite solver state" in two[victim].reason,
            f"path e: {victim} was not quarantined: {two[victim]}")
    require(len(runs[1]["inj"].fired) == 1, "path e: the poison never fired")
    same = 0
    for label in one:
        if label in (cancelled, victim):
            continue
        a, b = one[label], two[label]
        require(not isinstance(a, RequestFailure)
                and not isinstance(b, RequestFailure),
                f"path e: {label} failed: {a} {b}")
        require(np.array_equal(a.w, b.w)
                and (a.b, a.objective, a.iterations)
                == (b.b, b.objective, b.iterations),
                f"path e: {label} differs between the cancel and the "
                "poison run")
        same += 1
    print(f"  {same} requests bit-equal in both runs: the cancelled "
          f"({cancelled}) and the poisoned ({victim}, {two[victim].reason})"
          f" lanes left their batch-mates alone")
    return dict(reqs=reqs, stream=stream, runs=runs)


def serve_vs_solo(torch, serve):
    """Every completed request of path e against the port's solo
    saddle.solve on the card at its seed, bucket and chunk (w within
    1e-5, the same iterations); the streaming tenant's rounds against the
    solo chain warm-started from the previous round."""
    import numpy as np

    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import (_preprocess_seed, recover_hyperplane,
                                      split_classes)

    def pre_of(x, y, seed):
        xp, xm = split_classes(x, y)
        return pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(
            _preprocess_seed(seed)), device="cuda")

    def solo(pre, xp, xm, kw, warm=None, seed=None):
        n_b, d_b = pp.bucket_shape(len(xp) + len(xm), xp.shape[1])
        res = saddle.solve(xp, xm, nu=kw.get("nu", 0.0),
                           num_iters=kw["num_iters"],
                           seed=kw["seed"] if seed is None else seed,
                           gap_tol=kw.get("gap_tol", 0.0),
                           record_every=SERVE_CHUNK, n_pad=n_b, d_pad=d_b,
                           warm_start=warm, device="cuda")
        st = res.state
        w, b, *_ = recover_hyperplane(pre, torch.exp(st.log_eta),
                                      torch.exp(st.log_xi), xp, xm)
        return res, w, b

    t0 = time.perf_counter()
    one, two = (run["res"] for run in serve["runs"])
    labels = [label for label, _, _ in serve["reqs"]]
    worst = 0.0
    for i, (label, ds, kw) in enumerate(serve["reqs"]):
        got = two[label] if i == SERVE_CANCEL else one[label]
        pre = pre_of(ds.x, ds.y, kw["seed"])
        res, w, b = solo(pre, pre.xp, pre.xm, kw)
        dw = float(np.abs(got.w - w).max())
        worst = max(worst, dw)
        require(dw <= SERVE_ATOL and got.iterations == res.history[-1][0],
                f"path e: {label} vs its solo solve: max|dw| {dw:.3e}, "
                f"{got.iterations} vs {res.history[-1][0]} iterations")
    seed, iters, sizes = SERVE_STREAM
    stream = serve["stream"]
    pre = pre_of(stream.x[:sizes[0]], stream.y[:sizes[0]], seed)
    xp, xm = pre.xp, pre.xm
    warm = None
    for k in range(len(sizes)):
        if k:
            lo, hi = sizes[k - 1], sizes[k]
            x, y = stream.x[lo:hi], stream.y[lo:hi]
            xp = torch.cat([xp, pp.transform_like(pre, x[y > 0])])
            xm = torch.cat([xm, pp.transform_like(pre, x[y < 0])])
        res, w, b = solo(pre, xp, xm, dict(num_iters=iters, seed=seed),
                         warm=warm, seed=seed + 1000003 * k)
        warm = res.state
        got = one[f"stream round {k}"]
        dw = float(np.abs(got.w - w).max())
        worst = max(worst, dw)
        print(f"  stream round {k}: {len(xp) + len(xm)} points, bucket "
              f"{got.bucket}, max|dw| vs the warm-started solo solve "
              f"{dw:.3e}")
        require(dw <= SERVE_ATOL and got.iterations == iters,
                f"path e: stream round {k} vs its solo solve: {dw:.3e}")
    print(f"path e vs solo solves on the card ({len(labels) + len(sizes)} "
          f"requests, {time.perf_counter() - t0:.1f} s): max|dw| {worst:.3e}"
          f" (tol {SERVE_ATOL}), iterations equal")


def serve_replay_cpu(torch, serve):
    """Request SERVE_REPLAY of path e's first run replayed on the CPU's
    plain path from the coordinates its lane drew on the card."""
    import numpy as np

    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import (_preprocess_seed, recover_hyperplane,
                                      split_classes)

    label, ds, kw = serve["reqs"][SERVE_REPLAY]
    run = serve["runs"][0]
    rows = [out[:, lane] for seeds, out in run["draws"]
            for lane, s in enumerate(seeds) if s == kw["seed"]]
    sched = torch.cat(rows)[:kw["num_iters"]].numpy()
    require(len(sched) == kw["num_iters"], f"{label}: draws not recorded")
    xp, xm = split_classes(ds.x, ds.y)
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(
        _preprocess_seed(kw["seed"])), device="cuda")
    pre = pp.Preprocessed(*(t.cpu() if hasattr(t, "cpu") else t
                            for t in pre))
    n_b, d_b = pp.bucket_shape(len(ds.y), pre.xp.shape[1])
    t0 = time.perf_counter()
    res = saddle.solve(pre.xp, pre.xm, num_iters=kw["num_iters"],
                       record_every=SERVE_CHUNK, n_pad=n_b, d_pad=d_b,
                       idx_schedule=sched, device="cpu")
    w, b, *_ = recover_hyperplane(pre, torch.exp(res.state.log_eta),
                                  torch.exp(res.state.log_xi), pre.xp,
                                  pre.xm)
    got = run["res"][label]
    dw = float(np.abs(got.w - w).max())
    db = abs(got.b - b)
    print(f"path e, {label} replayed on the CPU from its lane's "
          f"coordinates ({time.perf_counter() - t0:.1f} s): max|dw| "
          f"{dw:.3e}, |db| {db:.3e} (tol {FIT_ATOL})")
    require(max(dw, db) <= FIT_ATOL, f"path e: {label}: card and CPU "
            "disagree")


def check_service_calls(torch, timer, rec) -> list:
    """A path's copied packed calls (path e's: S = 8 lanes, a block and
    step scalars each, free lanes, and after the poison a NaN lane; path
    f's: one step of each run, here and on rank 0) on the card: each
    kernel against its plain version on the live lanes (a
    lane with a point and finite duals, u and dw) at the packed
    tolerances, the MWU's (m, s) also against the plain merge of its own
    log_new, the live lanes' bits equal to a call on the live lanes
    alone (the other lanes leave them alone), the same bits on a repeat
    call; returns their timing jobs (one device launch a call)."""
    from repro_torch.kernels import ops, ref

    jobs = []
    for cap in rec.captured:
        dev = {}

        def cuda(args):
            return [dev.setdefault(id(a), a.cuda()) if hasattr(a, "cuda")
                    else a for a in args]

        dot = cuda(cap["momentum_dot_packed"])
        mwu = cuda(cap["mwu_update_packed"])
        x_t, idx, ll, lp, sign, theta = dot
        s, d, n_pad = x_t.shape
        b = idx.shape[1]
        shape = (s, d, n_pad, b)
        label = (f"[S={s},d={d},n_pad={n_pad},b={b},path {rec.name} "
                 f"{cap['label']}]")
        real = sign != 0

        def finite(*ts):
            return torch.stack([torch.isfinite(t).all(-1) for t in ts]
                               ).all(0)

        lam = torch.exp(ll)
        mom = sign * (lam + theta[:, None] * (lam - torch.exp(lp)))
        rows = torch.arange(s, device=x_t.device)[:, None]
        for name, args, live, library, nbytes, ops_ in (
                ("momentum_dot_packed", dot, real.any(-1) & finite(ll, lp),
                 lambda: x_t[rows, idx.long()] @ mom[..., None],
                 4 * s * (n_pad * (b + 3) + 2 * b + 1),
                 s * n_pad * (2 * b + 6)),
                ("mwu_update_packed", mwu,
                 real.any(-1) & finite(mwu[2], mwu[3], mwu[4]), None,
                 4 * s * (n_pad * (b + 5) + 2 * b + 6),
                 s * n_pad * (2 * b + 12))):
            kernel = getattr(ops, name)
            plain = getattr(ref, name + "_ref")

            def fn(kernel=kernel, args=args):
                return kernel(*args)

            def lanes(out, live=live):
                return (out[live] if isinstance(out, torch.Tensor)
                        else tuple(t[live] for t in out))

            got, want = fn(), plain(*args)
            errs = packed_errors(torch, name, lanes(got), lanes(want),
                                 real[live])
            if name == "mwu_update_packed":
                merged = merged_partials(torch, got[0][live], sign[live])
                errs["merge"] = ((got[2][live] + torch.log(got[3][live])
                                  - merged[0] - torch.log(merged[1])
                                  ).abs().max().item(), 1e-4)
            require(all(e <= tol for e, tol in errs.values()),
                    f"{name}{label}: {errs}")
            alone = kernel(*(a[live].contiguous()
                             if isinstance(a, torch.Tensor) else a
                             for a in args))
            same = [torch.equal(p, q) for p, q in zip(
                (alone,) if name == "momentum_dot_packed" else alone,
                (lanes(got),) if name == "momentum_dot_packed"
                else lanes(got))]
            require(all(same), f"{name}{label}: the other lanes moved the "
                    "live lanes' bits")
            again = lanes(fn())
            require(all(torch.equal(p, q) for p, q in zip(
                (again,) if name == "momentum_dot_packed" else again,
                (lanes(got),) if name == "momentum_dot_packed"
                else lanes(got))), f"{name}{label}: not deterministic")
            print(f"  {name}{label}: {int(live.sum())} live lanes of {s}, "
                  f"{len(set(map(tuple, idx.tolist())))} distinct blocks "
                  f"over the {s} lanes; errors "
                  + ", ".join(f"{k} {e:.3e} (tol {tol:.1e})"
                              for k, (e, tol) in errs.items())
                  + "; live lanes bit-equal to a call on them alone")
            e = entry(name, name + label,
                      max(err for err, _ in errs.values()), timer(fn),
                      timer(lambda: plain(*args)),
                      None if library is None else timer(library),
                      nbytes=nbytes, ops=ops_)
            e["launches"] = rec.calls[name, shape]
            jobs.append((e, fn, name + "_kernel", 1))
    return jobs


# ---------------------------------------------------------------- path f
# Algorithm 4 over real collectives: solve_distributed(mesh=ClientGroup),
# one client a process.  The ranks share the one card, where NCCL refuses
# two ranks ("Duplicate GPU detected"), so they talk through gloo over CUDA
# tensors (copied to the host and back) and NCCL runs at world size 1, in
# this process.  One spawn of F_RANKS gloo ranks runs every gloo case: the
# whole group is Figure 3 at the paper's k = 20, ranks 0-3 the k = 4 fits,
# ranks 0-1 the serving chunk's two placements.  Cut to fit ~2 minutes:
# 600 / 200 / 120 steps (paths b's 6,000 / 5,000), 2 chunks of the bucket.
F_RANKS = 20
F_K4 = (("Figure 3 hard margin k=4", 0, dict(num_iters=600,
                                              record_every=200)),
        ("Figure 4 nu-SVM k=4", 1, dict(num_iters=200, record_every=100)))
F_K20_STEPS = 120
F_SERVE = dict(k=2, lanes=8, n_pad=8192, d=256, chunk_steps=64, chunks=2,
               drop=(3, 1), ns=[5000 + 400 * i for i in range(8)])
F_TIMEOUT_S = 600


def f_solve(group, xp, xm, k, timed: bool = True, **kw) -> dict:
    """One solve on this rank with its launches and tallied collectives,
    each counted from just before it, and with ``timed`` the host time of
    its collectives (each between two device synchronisations: a
    ``comm_audit.Recorder`` on the group)."""
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.utils import comm_audit

    rec = comm_audit.Recorder()
    launches = Counter(ops.launch_counts)
    counts = Counter(engine.collective_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dist.solve_distributed(
        xp, xm, k=k, mesh=group._replace(recorder=rec) if timed else group,
        device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(
        w=res.state.w.cpu().numpy(), history=res.history, wall=wall,
        log_eta=res.state.log_eta.cpu().numpy(),
        launches=dict(Counter(ops.launch_counts) - launches),
        tally=Counter(engine.collective_counts) - counts,
        coll_s=rec.seconds if timed else None)


def f_serve_batch(torch, lanes, dev):
    """Path f's serving bucket (F_SERVE) from the preprocessed lanes."""
    from repro_torch.core import engine, saddle
    from repro_torch.utils import comm_audit

    rows = [engine.slot_params_row(saddle.make_params(
        len(xp) + len(xm), F_SERVE["d"], 1e-3, 0.1, block_size=1))
        for xp, xm in lanes]
    return comm_audit.fresh_slot_batch(
        [(torch.as_tensor(xp, device=dev), torch.as_tensor(xm, device=dev))
         for xp, xm in lanes], F_SERVE["n_pad"], F_SERVE["d"], rows,
        [100 + i for i in range(len(lanes))], 1 << 20, dev)


def f_serve_run(torch, group, placement, batch, drop=None) -> dict:
    """F_SERVE's chunks of the bucket: unsharded without a group, else
    this rank's shard in ``placement`` (after dropping ``drop``)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.utils import comm_audit

    state, x_t, sign, sp = batch
    rec = comm_audit.Recorder()
    if drop is not None:
        state, sign = dist.drop_slot_shard(state, sign, *drop,
                                           num_shards=group.size)
    if group is not None:
        state, x_t, sign, sp = engine.shard_slot_batch(group, placement,
                                                       state, x_t, sign, sp)
    kw = dict(chunk_steps=F_SERVE["chunk_steps"], d=F_SERVE["d"],
              block_size=1, project=False, check_gap=False)
    launches = Counter(ops.launch_counts)
    counts = Counter(engine.collective_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objs = []
    for _ in range(F_SERVE["chunks"]):
        if group is None:
            state, obj, healthy = engine.run_chunk_slots(
                state, x_t, sign, sp, F_SERVE["chunk_steps"], **kw)
        else:
            state, obj, healthy = engine.run_chunk_slots_sharded(
                state, x_t, sign, sp, F_SERVE["chunk_steps"],
                mesh=group._replace(recorder=rec), placement=placement, **kw)
        objs.append(obj)
    torch.cuda.synchronize()
    return dict(
        wall=time.perf_counter() - t0, w=state.w.cpu().numpy(),
        weights=torch.exp(state.log_lam).cpu().numpy(),
        u=state.u.cpu().numpy(), obj=torch.stack(objs).cpu().numpy(),
        healthy=healthy.cpu().numpy(),
        launches=dict(Counter(ops.launch_counts) - launches),
        tally=Counter(engine.collective_counts) - counts,
        coll_s=rec.seconds)


def f_rank(world, data_path: str) -> dict:
    """What each of path f's spawned ranks runs (see F_RANKS).  Rank 0
    records its packed calls by shape and copies one step's arguments of
    each run (on the card during the run, to the host after it), which the
    parent holds against the plain versions."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.utils import comm_audit

    data = np.load(data_path)
    g4 = meshlib.sub_group(world, range(4))
    g2 = meshlib.sub_group(world, range(F_SERVE["k"]))
    rec = (PathRecorder("f rank 0", keep=False, on_device=True)
           if world.rank == 0 else None)

    def arm(label):
        if rec is not None:
            rec.arm(label)

    ops.launch_counts.clear()
    out = {}
    with rec if rec is not None else contextlib.nullcontext():
        xp, xm = data["xp0"], data["xm0"]
        arm(f"Figure 3 k={F_RANKS}")
        out["k20"] = f_solve(world, xp, xm, F_RANKS, num_iters=F_K20_STEPS,
                             record_every=F_K20_STEPS,
                             idx_schedule=data["sched0"])
        out["k20 audit"] = comm_audit.audit_runner(
            world, n1=len(xp), n2=len(xm), d=xp.shape[1], nu=0.0)
        if g4 is not None:
            for label, i, kw in F_K4:
                xp, xm = data[f"xp{i}"], data[f"xm{i}"]
                nu = float(data[f"nu{i}"])
                arm(label)
                out[label] = f_solve(g4, xp, xm, 4, nu=nu, **kw)
                out[label + " audit"] = comm_audit.audit_runner(
                    g4, n1=len(xp), n2=len(xm), d=xp.shape[1], nu=nu)
        if g2 is not None:
            lanes = [(data[f"sxp{i}"], data[f"sxm{i}"])
                     for i in range(F_SERVE["lanes"])]
            for placement in ("points", "lanes"):
                arm(f"serving {placement}")
                out[placement] = f_serve_run(
                    torch, g2, placement,
                    f_serve_batch(torch, lanes, g2.device))
                n = F_SERVE["ns"][-1]
                out[placement + " audit"] = comm_audit.audit_serve(
                    g2, placement=placement, num_slots=F_SERVE["lanes"],
                    n1=n // 2, n2=n - n // 2, d=F_SERVE["d"], nu=0.0,
                    chunk_steps=8)
            out["dropped"] = f_serve_run(
                torch, g2, "points", f_serve_batch(torch, lanes, g2.device),
                drop=F_SERVE["drop"])
    if rec is not None:
        out["rec"] = rec.host_copy()
        out["rec"]["counts"] = dict(ops.launch_counts)
    return out


def f_check_run(label, runs, steps: int, want_colls: dict, diff: float,
                tol: float) -> None:
    """A run on several ranks: ``diff`` (its largest difference from the
    reference) within ``tol``, 2 packed launches a step on every rank, the
    tally equal to the model; prints ms a step and the collectives' host
    time."""
    wall = max(r["wall"] for r in runs)
    ncoll = sum(want_colls.values())
    if any(r["coll_s"] is None for r in runs):
        timed = "collectives not timed"
    else:
        coll = max(r["coll_s"] for r in runs)
        timed = (f"collectives' host time {coll / steps * 1e3:.4f} ms a step "
                 f"({coll / max(ncoll, 1) * 1e3:.4f} ms each)")
    print(f"path f {label}: {len(runs)} ranks, {wall / steps * 1e3:.4f} ms "
          f"a step ({wall:.3f} s, {steps} steps); {timed}, {ncoll} calls; "
          f"max|w - reference| {diff:.3e} (tol {tol:g})")
    for r in runs:
        require(r["launches"] == {k: steps for k in PACKED},
                f"path f {label}: launches {r['launches']}, want {steps} "
                "of each packed kernel")
        require(r["tally"] == Counter(want_colls),
                f"path f {label}: tallied {dict(r['tally'])}, model "
                f"{want_colls}")
    require(diff <= tol, f"path f {label}: w differs from the reference")


def f_check_audit(label, rec, want_count: int | None) -> None:
    print(f"  audit {label}: backend {rec['backend']}, measured "
          f"{rec['measured']} an iteration, "
          f"{rec.get('measured_per_chunk', rec.get('runner_per_chunk'))} a "
          f"chunk, match {rec['match']}")
    require(rec["match"] is True and rec["hooks_agree"] is True,
            f"path f {label}: the profiler's collectives differ from the "
            "model or the hooks")
    require(rec.get("runner_match", True) is True
            and rec.get("runner_matches_step", True) is True,
            f"path f {label}: the runner chunk differs from the step")
    if want_count is not None:
        require(rec["per_iteration_count"] == want_count,
                f"path f {label}: {rec['per_iteration_count']} collectives "
                f"an iteration, want {want_count}")


def model_colls(k: int, nu: float, steps: int, chunks: int, d: int) -> dict:
    from repro_torch.core import distributed as dist
    from repro_torch.core import projections

    comm = dist.CommModel(k=k, nu_rounds_per_iter=(
        float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0))
    want = Counter({key: n * steps
                    for key, n in comm.collective_multiset().items()})
    want["all-reduce", "add", d] += chunks
    return dict(want)


def collectives_path(torch, dist_fits, rec: PathRecorder) -> PathRecorder:
    """Path f: the references on the card, NCCL at world size 1 here, then
    the spawned gloo ranks; counts reset just before and read after, the
    calls here recorded by ``rec``.  Returns rank 0's recorder."""
    from repro_torch.kernels import ops

    t_path = time.perf_counter()
    ops.launch_counts.clear()
    with rec:
        ranks, spawn_s, arrays, refs = f_parent(torch, dist_fits, rec)
    counts = dict(ops.launch_counts)
    print(f"path f launches here {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    rank0 = PathRecorder.from_host_copy("f rank 0", ranks[0]["rec"])
    print(f"path f launches on rank 0 {ranks[0]['rec']['counts']}")
    rank0.check_counts(ranks[0]["rec"]["counts"], PACKED)
    f_check(ranks, spawn_s, arrays, refs)
    print(f"path f: {time.perf_counter() - t_path:.2f} s in all")
    return rank0


def f_parent(torch, dist_fits, rec):
    """Path f's data, its references on the card and the NCCL runs here,
    then the spawn; returns (the ranks' results, the spawn's seconds, the
    data, the references)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import distributed as dist
    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as meshlib
    from repro_torch.utils import comm_audit

    arrays = {"sched0": dist_fits[0]["sched"][:F_K20_STEPS]}
    for i, spec in enumerate(DIST_FITS):
        xp, xm, nu = dist_problem(spec)
        pre = pp.preprocess(xp, xm,
                            generator=torch.Generator().manual_seed(0),
                            device="cuda")
        arrays.update({f"xp{i}": pre.xp.cpu().numpy(),
                       f"xm{i}": pre.xm.cpu().numpy(), f"nu{i}": nu})
    lanes = []
    for i, n in enumerate(F_SERVE["ns"]):
        ds = synthetic.separable(n, F_SERVE["d"], seed=100 + i)
        pre = pp.preprocess(*split_classes(ds.x, ds.y),
                            generator=torch.Generator().manual_seed(i),
                            device="cuda")
        lanes.append((pre.xp.cpu().numpy(), pre.xm.cpu().numpy()))
        arrays[f"sxp{i}"], arrays[f"sxm{i}"] = lanes[-1]

    # the references, on the card
    xp, xm = arrays["xp0"], arrays["xm0"]
    sims = {label: dist.solve_distributed(
        arrays[f"xp{i}"], arrays[f"xm{i}"], k=4, nu=arrays[f"nu{i}"],
        device="cuda", **kw) for label, i, kw in F_K4}
    sim20 = dist.solve_distributed(xp, xm, k=F_RANKS,
                                   num_iters=F_K20_STEPS,
                                   record_every=F_K20_STEPS,
                                   idx_schedule=arrays["sched0"],
                                   device="cuda")
    serial_kw = F_K4[0][2]
    serial = saddle.solve(xp, xm, device="cuda", **serial_kw)
    whole = f_serve_run(torch, None, None,
                        f_serve_batch(torch, lanes, torch.device("cuda")))

    # NCCL at world size 1 in this process, then the spawned gloo ranks
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_f_"))
    try:
        g1 = meshlib.init_client_group(
            backend="nccl", init_method=f"file://{tmp / 'nccl'}", rank=0,
            world_size=1, device="cuda", timeout_s=F_TIMEOUT_S)
        try:
            # NCCL sets its communicator up at the first collective: do
            # that before the timed solves; the first one's ms a step has
            # no device synchronisation around its collectives
            torch.distributed.all_reduce(torch.zeros(1, device=g1.device))
            nccl = [f_solve(g1, xp, xm, 1, timed=False, **serial_kw)]
            rec.arm("NCCL k=1")
            nccl.append(f_solve(g1, xp, xm, 1, **serial_kw))
            nccl_audit = comm_audit.audit_runner(
                g1, n1=len(xp), n2=len(xm), d=xp.shape[1], nu=0.0)
        finally:
            torch.distributed.destroy_process_group()
        np.savez(tmp / "data.npz", **arrays)
        t0 = time.perf_counter()
        ranks = meshlib.spawn_clients(f_rank, F_RANKS, backend="gloo",
                                      device="cuda", timeout_s=F_TIMEOUT_S,
                                      args=(str(tmp / "data.npz"),))
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    refs = dict(sims=sims, sim20=sim20, serial=serial, whole=whole,
                nccl=nccl, nccl_audit=nccl_audit)
    return ranks, spawn_s, arrays, refs


def f_check(ranks, spawn_s, arrays, refs) -> None:
    """Path f's holds: every run against its reference and the models."""
    import numpy as np

    from repro_torch.core import distributed as dist

    sims, sim20, serial, whole = (refs[k] for k in ("sims", "sim20",
                                                    "serial", "whole"))
    xp = arrays["xp0"]
    serial_kw = F_K4[0][2]
    steps = serial_kw["num_iters"]
    for nccl, label in zip(refs["nccl"], ("", ", collectives timed")):
        f_check_run(f"NCCL k=1 vs serial{label}", [nccl], steps,
                    model_colls(1, 0.0, steps,
                                -(-steps // serial_kw["record_every"]),
                                xp.shape[1]),
                    float(abs(nccl["w"] - serial.state.w.cpu().numpy()
                              ).max()), 0.0)
        require(np.array_equal(serial.state.log_eta.cpu().numpy(),
                               nccl["log_eta"][0])
                and [(m, o) for m, _, o in nccl["history"]]
                == serial.history, "path f NCCL k=1: duals or history "
                "differ from the serial solve")
    f_check_audit("NCCL k=1", refs["nccl_audit"], 3)
    print(f"path f: {F_RANKS} gloo ranks on the card, {spawn_s:.2f} s from "
          "spawn to the last result")
    d = xp.shape[1]

    def w_diff(runs, ref):
        return max(float(abs(r["w"] - ref.state.w.cpu().numpy()).max())
                   for r in runs)

    runs = [r["k20"] for r in ranks]
    f_check_run(f"Figure 3 k={F_RANKS}", runs, F_K20_STEPS,
                model_colls(F_RANKS, 0.0, F_K20_STEPS, 1, d),
                w_diff(runs, sim20), FIT_ATOL)
    f_check_audit(f"Figure 3 k={F_RANKS}", ranks[0]["k20 audit"], 3)
    for label, i, kw in F_K4:
        nu = arrays[f"nu{i}"]
        chunks = -(-kw["num_iters"] // kw["record_every"])
        runs = [r[label] for r in ranks[:4]]
        f_check_run(label, runs, kw["num_iters"],
                    model_colls(4, nu, kw["num_iters"], chunks,
                                arrays[f"xp{i}"].shape[1]),
                    w_diff(runs, sims[label]), FIT_ATOL)
        f_check_audit(label, ranks[0][label + " audit"], 29 if nu else 3)

    # the serving chunk's placements
    steps = F_SERVE["chunks"] * F_SERVE["chunk_steps"]
    s, k, m = F_SERVE["lanes"], F_SERVE["k"], F_SERVE["n_pad"] // F_SERVE["k"]
    serve_model = dist.ServeCommModel(k=k, num_slots=s, nu_rounds_per_iter=0)
    want = Counter({key: n * steps for key, n in
                    serve_model.collective_multiset().items()})
    for key, n in serve_model.per_chunk_multiset(F_SERVE["d"]).items():
        want[key] += n * F_SERVE["chunks"]
    pts = [r["points"] for r in ranks[:k]]
    weights = np.concatenate([p["weights"] for p in pts], axis=1)
    u = np.concatenate([p["u"] for p in pts], axis=1)
    errs = {"w": max(float(abs(p["w"] - whole["w"]).max()) for p in pts),
            "dual weights": float(abs(weights - whole["weights"]).max()),
            "u": float(abs(u - whole["u"]).max())}
    print(f"  points vs unsharded: max differences {errs}")
    f_check_run("serving chunk, points", pts, steps, dict(want),
                max(errs.values()), REF_ATOL)
    f_check_audit("serving points", ranks[0]["points audit"],
                  serve_model.collectives_per_iteration())
    lanes_ = [r["lanes"] for r in ranks[:k]]
    same = {f: np.array_equal(np.concatenate([q[f] for q in lanes_]),
                              whole[f])
            for f in ("w", "weights", "u", "healthy")}
    same["obj"] = np.array_equal(
        np.concatenate([q["obj"] for q in lanes_], axis=1), whole["obj"])
    print(f"  lanes vs unsharded, bit for bit: {same}")
    f_check_run("serving chunk, lanes", lanes_, steps, {},
                0.0 if all(same.values()) else math.inf, 0.0)
    f_check_audit("serving lanes", ranks[0]["lanes audit"], 0)
    drop = [r["dropped"] for r in ranks[:k]]
    lane, shard = F_SERVE["drop"]
    mates = [i for i in range(s) if i != lane]
    dw = np.concatenate([q["weights"] for q in drop], axis=1)
    kept = (np.array_equal(drop[0]["w"][mates], pts[0]["w"][mates])
            and np.array_equal(dw[mates], weights[mates])
            and np.array_equal(drop[0]["obj"][:, mates],
                               pts[0]["obj"][:, mates]))
    print(f"  drop_slot_shard lane {lane} shard {shard}: batch-mates "
          f"bit-equal {kept}; the lane's dropped weights all 0 "
          f"{bool((dw[lane, shard * m:(shard + 1) * m] == 0).all())}")
    require(kept and (dw[lane, shard * m:(shard + 1) * m] == 0).all(),
            "path f drop_slot_shard")


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
    if main_path and b > 128:
        # path d's b = 32,769-65,536 at d_pad = 65,536: the MWU multiplies
        # u by mwu_c ~ 1e4 and dv by mwu_c d_eff ~ 1.7e4, so u of 0.1 and
        # dw of 0.01 put log_new in the thousands, where one float32 step
        # (1.2e-4 - 4.9e-4) is above the 1e-4 tolerance and two orders of
        # summing 40,000 rows differ by 1e-3.  There u is 0.1 / mwu_c and
        # dw 0.01 * 128 / b: mwu_c u and the dv term of order 1.
        u = u / torch.clamp(mwu_c, min=1.0)[:, None]
        dw = dw * (128 / b)
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
    tile that holds a real point left out of the merged (m, s); and above
    CHUNK_ROWS sampled rows, either kernel with the rows past the first
    chunk left out."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.saddle_update import (CHUNK_ROWS,
                                                   packed_tiles_per_block)

    if name == "momentum_dot_packed":
        x_t, idx, ll, lp, sign, theta = args
        groups = 8 // packed_tiles_per_block(b)
        gone = got.clone()
        gone[:, groups - 1::groups] = 0.0
        faults = {"theta = 0": ref.momentum_dot_packed_ref(
                      x_t, idx, ll, lp, sign, torch.zeros_like(theta)),
                  "last row group left out": gone}
        if b > CHUNK_ROWS:
            later = got.clone()
            later[:, CHUNK_ROWS:] = 0.0
            faults["rows past the first chunk left out"] = later
        return faults
    x_t, idx, ll, u, dw, *rest = args
    faults = {"u = 0": ref.mwu_update_packed_ref(
                  x_t, idx, ll, torch.zeros_like(u), dw, *rest),
              "last tile left out": (got[0], got[1]) + merged_partials(
                  torch, got[0], sign, leave_out_last=True)}
    if b > CHUNK_ROWS:
        faults["rows past the first chunk left out"] = \
            ref.mwu_update_packed_ref(
                x_t, idx[:, :CHUNK_ROWS].contiguous(), ll, u,
                dw[:, :CHUNK_ROWS].contiguous(), *rest)
    return faults


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
        # above b = 1,024 a call is milliseconds of device: 50 calls time
        # the host's share as well as 1,000 would
        split = host_split(torch, name, args, 1000 if b <= 1024 else 50)
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


def fwht_shapes(rec) -> set:
    """The FWHT shapes of a path held against the plain version: all of
    them, but for paths e and f (two class matrices a problem) the longest
    class matrix and the recovery's vector of each d."""
    shapes = {shape for (name, shape) in rec.calls if name == "fwht"}
    if rec.name not in ("e", "f"):
        return shapes
    return {max(sh for sh in shapes if sh[1] == d) for _, d in shapes} | {
        sh for sh in shapes if sh[0] == 1}


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
            if name == "fwht" and shape in fwht_shapes(rec):
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
        jobs += check_service_calls(torch, timer, rec)
        entries += report(timer, jobs)
    ticket_rounds(torch, g, recs)
    print("  not on a path (launches null):")
    jobs = [check_fwht(torch, timer, g, max(1, 12_800_000 // d), d, None,
                       "none")
            for d in (1024, 4096, 32_768, 65_536, 131_072)]
    jobs.append(check_fwht(torch, timer, g, 50_000, 512, None, "none"))
    # more sampled rows than a block holds at once (b > 32,768: two chunks
    # of indices or dw) and every row of d, on path d's operands
    x_t, sign = next(xs for shape, xs in recs[3].operands.items()
                     if shape[3] == 1)
    for b in (32_769, 65_536):
        jobs += check_packed(torch, timer, g, x_t, sign, b, None,
                             path="path d")
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


def profiles(torch, dist_fits, serve):
    """300 steps of the serial nu-SVM solve at the Figure 2 shape, and of
    each distributed fit on its own data and coordinates; 4 chunks of
    path e's service over its 8 requests of bucket (8,192, 256): intake,
    the chunks and the recovery."""
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

    from repro_torch.serve.solver_service import FitRequest, SolverService
    mates = [(ds, kw) for label, ds, kw in serve["reqs"]
             if label.startswith("hard-margin #") and len(ds.y) > 4096]

    def service():
        svc = SolverService(num_slots=SERVE_SLOTS, chunk_steps=SERVE_CHUNK)
        for ds, kw in mates:
            svc.submit(FitRequest(x=ds.x, y=ds.y, seed=kw["seed"],
                                  num_iters=4 * SERVE_CHUNK))
        require(len(svc.run()) == SERVE_SLOTS, "service window")

    profile_window(torch, f"path e service, {len(mates)} lanes of bucket "
                   f"(8192, 256), 4 chunks", 4 * SERVE_CHUNK, service)


# ---------------------------------------------------------------- phase 5
def compare_fits(label, card, cpu, history: bool,
                 offset: bool = True) -> None:
    """w (and with ``offset`` b) within FIT_ATOL, and with ``history`` the
    objective at every mark within HIST_RTOL relative."""
    import numpy as np

    dw = float(np.abs(card.w_ - cpu.w_).max())
    db = abs(card.b_ - cpu.b_)
    print(f"{label}: max|dw| {dw:.3e}, |db| {db:.3e}, |dobj| "
          f"{abs(card.objective_ - cpu.objective_):.3e} (tol {FIT_ATOL} on "
          f"{'w and b' if offset else 'w'})")
    require(max(dw, db if offset else 0.0) <= FIT_ATOL,
            f"{label}: card and CPU disagree")
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
        label, cls, kw, data = spec
        steps = REPLAY_PREFIX.get(label)
        if steps is not None:
            # a chaotic fit: its first steps again on the card, against
            # the same steps on the CPU
            kw = dict(kw, num_iters=steps * kw["block_size"],
                      record_every=steps // 4)
            label = f"{label}, its first {steps} steps"
            card, _ = make_fit((label, cls, kw, data), "cuda", ds)
            card.fit(ds.x, ds.y, idx_schedule=sched[:steps])
            sched = sched[:steps]
        clf, _ = make_fit((label, cls, kw, data), "cpu", ds)
        t0 = time.perf_counter()
        clf.fit(ds.x, ds.y, idx_schedule=sched)
        print(f"{label} replayed on the CPU with the card's "
              f"coordinates: {time.perf_counter() - t0:.1f} s")
        compare_fits(f"  card vs CPU, {label}", card, clf, history=True,
                     offset=steps is None)


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
    recs += [PathRecorder("e", keep=False), PathRecorder("f")]
    fits = main_path(torch, recs[0])
    dist_fits = dist_path(torch, recs[1])
    reference_path(torch, recs[2], dist_fits[0])
    fits += wide_path(torch, recs[3])
    serve = service_path(torch, recs[4])
    serve_vs_solo(torch, serve)
    recs.append(collectives_path(torch, dist_fits, recs[5]))
    serial_vs_dist(torch, dist_fits)
    profiles(torch, dist_fits, serve)
    entries = check_kernels(torch, Timer(torch), recs)
    card_vs_cpu(torch, fits)
    dist_card_vs_cpu(torch, dist_fits[1])
    serve_replay_cpu(torch, serve)

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
