#!/usr/bin/env python3
"""Times the port's FWHT, its unpacked kernels, the reference step and
path a's preprocessing on one NVIDIA GPU, for a source tree given on the
command line, so that two trees can be compared in turns on one card.

    python3 chip_bench.py [--src DIR] [--tag NAME]

``DIR`` is the ``src`` directory that holds ``repro_torch`` (default: this
checkout's).  The harness (``chip_smoke.Timer``: CUDA events around each
call with the 50 MB L2 flushed before it, and one torch.profiler session
for device-only times) is this checkout's for every tree.  Printed, with
the card's name and power limit:

  * the FWHT at the shapes of ``chip_smoke.py``'s path a (both classes and
    the n = 1 recovery of each serial fit), at d = 65,536 (n = 195 and
    path d's 747 / 753), at d = 131,072, at the other paths' shapes and
    at n = 128 for d = 2 to 32,768:
    wrapper ms by events, kernel device ms a call, device launches a call,
    a copy of the same bytes (``out.copy_(x)``) and ``x @ H`` by the same
    events (``chip_smoke.fwht_library``: H built from Kronecker factors,
    or the error that refused its allocation), and the bound; a tree that
    refuses a shape says so;
  * the unpacked momentum dot at the reference step's shapes (path c),
    the JAX kernel tests' shapes with 20 clients and K = 20, n = 5,001:
    wrapper ms by events, kernel device ms, device launches a call,
    ``cols.T @ mom`` by events;
  * the unpacked MWU at the same shapes, as the reference step calls it
    (``normalize=False``): wrapper ms by events, kernel device ms, device
    launches a call, and ``cols @ dw`` by events, a yardstick that is not
    the same function (the row dot alone, no dual update or logsumexp);
    its SHA-1 covers the outputs with and without ``normalize``;
  * path c's reference chunk on the Figure 3 data (80 steps of the
    unpacked step at k = 20 and serially): ms per step, host clock,
    synchronised (median of 5 after a warm run);
  * path a's set-up: ``preprocess.preprocess`` of each serial fit's data
    on the card, wall seconds (median of 5, synchronised);
  * the main path's ms per step: path a's two serial fits
    (``saddle.solve``) and Figure 3 at k = 20 (``solve_distributed``),
    SOLVE_STEPS steps each, and path d's B = 40,000 fit, 200 steps, on
    preprocessed data, host clock, synchronised (median of 3 after a warm
    run);
  * the packed momentum dot and MWU at the shapes of ``chip_smoke.py``'s
    paths a-e and at b = 32,768 / 32,769 / 40,000 / 65,536 of d = 65,536,
    each with its row splits R (1 in a tree that has no split axis):
    wrapper ms by events, kernel device ms, device launches a call, the
    plain version's ms by events (the tree's ``kernels.ref``), and for
    the dot where every slot shares one block the one-call yardstick
    ``x_t[:, idx] @ mom`` by events; a tree that refuses a shape says so.

Every kernel row also gives the SHA-1 of the call's output bytes (inputs
drawn from a fixed seed), so that two trees' outputs can be held bit for
bit, and the unpacked and packed rows the wrapper's host ms a call (the
mean time to return of 200 calls issued back to back, no synchronisation
between them).  The shapes are those ``PERF.md`` section 6 lists.

The last line is the same numbers as one JSON object.  It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate (data sheet)
SOLVE_STEPS = 2_000


def sha1(torch, out) -> str:
    """SHA-1 of a call's output bytes (a tensor or a tuple of them)."""
    outs = (out,) if isinstance(out, torch.Tensor) else out
    torch.cuda.synchronize()
    return hashlib.sha1(b"".join(o.cpu().numpy().tobytes()
                                 for o in outs)).hexdigest()


def host_ms(torch, fn, calls: int = 200) -> float:
    """A wrapper's host ms a call: the mean time to return of ``calls``
    calls issued back to back after a synchronisation, none between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e3


def solve_steps(torch) -> list[dict]:
    """ms per step of the main path's solves on the card: path a's two
    serial fits and Figure 3 at k = 20, SOLVE_STEPS steps each, and path
    d's B = 40,000 fit, its 200 steps (the budget is in rows, so B times
    as many) on data preprocessed once (median of 3 after a warm run)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    runs = []
    for label, ds, kw in (
            ("path a nu-SVM n=50000 d=512 B=1",
             synthetic.non_separable(50_000, 512, beta2=0.2, seed=50_000),
             dict(alpha=0.85)),
            ("path a hard-margin n=20000 d=256 B=128",
             synthetic.separable(20_000, 256, seed=256),
             dict(block_size=128)),
            ("Figure 3 k=20 n=10000 d=256",
             synthetic.separable(10_000, 256, seed=0), dict(k=20)),
            ("path d hard-margin n=1500 d=40000 B=40000",
             synthetic.separable(1_500, 40_000, seed=40_000),
             dict(block_size=40_000, steps=200))):
        xp, xm = split_classes(ds.x, ds.y)
        pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                            device="cuda")
        alpha = kw.pop("alpha", None)
        steps = kw.pop("steps", SOLVE_STEPS)
        nu = 0.0 if alpha is None else 1.0 / (alpha * min(len(xp), len(xm)))
        common = dict(eps=1e-3, beta=0.1, nu=nu,
                      num_iters=steps * kw.get("block_size", 1),
                      record_every=steps, device="cuda", **kw)
        solve = dist.solve_distributed if "k" in kw else saddle.solve
        runs.append((label, steps, lambda pre=pre, solve=solve,
                     common=common: solve(pre.xp, pre.xm, **common)))
    out = []
    for label, steps, fn in runs:
        secs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if res.history[-1][0] != steps:
                raise RuntimeError(f"{label}: ran {res.history[-1][0]} "
                                   f"steps, not {steps}")
        ms = statistics.median(secs[1:]) / steps * 1e3
        print(f"  solve {label}: {ms:.4f} ms/step ({steps} steps, "
              f"median of 3 after a warm run)")
        out.append(dict(run=label, steps=steps, ms_per_step=ms))
    return out


def reference_chunk(torch, steps: int = 80) -> list[dict]:
    """ms per step of path c's reference chunk (the unpacked step, 4
    kernel calls a step) on the Figure 3 data, k = 20 and serially."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine, saddle
    from repro_torch.core import preprocess as pp
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    ds = synthetic.separable(10_000, 256, seed=0)
    xp, xm = split_classes(ds.x, ds.y)
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    n1, d = pre.xp.shape
    n2 = pre.xm.shape[0]
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1)
    idx = engine.draw_blocks(torch.Generator(device="cuda").manual_seed(3),
                             d, 1, steps, torch.device("cuda"))
    host = [t.cpu().numpy() for t in (pre.xp, pre.xm)]
    xp_sh, mask_p = dist.shard_points(host[0], 20)
    xm_sh, mask_m = dist.shard_points(host[1], 20)
    xps = torch.as_tensor(xp_sh, device="cuda")
    xms = torch.as_tensor(xm_sh, device="cuda")
    runs = {
        "k=20": lambda: dist.run_chunk_sim(
            dist.init_sharded_state(n1, n2, d, mask_p, mask_m,
                                    device="cuda"),
            xps, xms, steps, params=params, idx=idx),
        "serial": lambda: engine.run_chunk(
            saddle.init_state(n1, n2, d, pre.xp), pre.xp, pre.xm, steps,
            params=params, idx=idx),
    }
    out = []
    for label, fn in runs.items():
        secs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ms = statistics.median(secs[1:]) / steps * 1e3
        print(f"  reference chunk {label}: {ms:.4f} ms/step ({steps} steps, "
              f"median of 5 after a warm run)")
        out.append(dict(run=label, steps=steps, ms_per_step=ms))
    return out


# (S, d, n_pad, b, distinct blocks per slot): paths a-d, b above and at
# a packed block's chunk of rows, and path e's service buckets
PACKED_SHAPES = ((1, 512, 50_048, 1, False), (1, 256, 20_096, 128, False),
                 (20, 256, 512, 1, False), (20, 512, 384, 1, False),
                 (20, 256, 512, 128, False), (1, 256, 10_112, 1, False),
                 (1, 65_536, 1_536, 1, False),
                 (1, 65_536, 1_536, 32_768, False),
                 (1, 65_536, 1_536, 32_769, False),
                 (1, 65_536, 1_536, 40_000, False),
                 (1, 65_536, 1_536, 65_536, False),
                 (8, 256, 4_096, 1, True), (8, 256, 8_192, 1, True),
                 (8, 512, 8_192, 1, True), (1, 128, 18_048, 1, False),
                 (1, 128, 256, 1, False), (1, 256, 18_048, 1, False),
                 (1, 512, 10_112, 1, False), (2, 256, 16_384, 1, True),
                 (2, 512, 32_768, 1, True), (4, 256, 32_768, 1, True))


def packed_kernels(torch, timer) -> list[dict]:
    """Both packed kernels at PACKED_SHAPES on seeded inputs (points in
    the unit ball, per-class log weights near uniform, the main path's
    step scalars): wrapper ms, device ms and launches a call, the
    wrapper's host ms a call, and the SHA-1 of each call's outputs."""
    import math

    from repro_torch.core import engine, saddle
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import saddle_update as su

    # a tree from before the row splits has none: R = 1 everywhere
    splits_of = getattr(su, "packed_row_splits", lambda n_pad, b: 1)
    rows, jobs = [], []
    for k, (s, d, n_pad, b, distinct) in enumerate(PACKED_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(k)
        dev = torch.device("cuda")
        n1, n2 = n_pad // 3, n_pad // 2
        x_t = torch.randn((s, d, n_pad), generator=g, device=dev)
        x_t *= 1.0 / math.sqrt(d)
        x_t[:, :, n1 + n2:] = 0.0
        sign = torch.zeros((s, n_pad), device=dev)
        sign[:, :n1], sign[:, n1:n1 + n2] = 1.0, -1.0
        noise = 0.1 * torch.randn((s, n_pad), generator=g, device=dev)
        ll = torch.where(sign > 0, -math.log(n1) + noise,
                         torch.where(sign < 0, -math.log(n2) + noise,
                                     torch.full_like(noise, -1e30)))
        lp = ll + 0.05 * torch.randn((s, n_pad), generator=g,
                                     device=dev) * (sign != 0)
        u = 0.1 * torch.randn((s, n_pad), generator=g, device=dev)
        dw = 0.01 * math.sqrt(min(1.0, 128 / b)) * torch.randn(
            (s, b), generator=g, device=dev)
        perms = [torch.randperm(d, generator=g, device=dev)[:b]
                 for _ in range(s if distinct else 1)]
        idx = torch.stack(perms).expand(s, b).to(torch.int32).contiguous()
        sp = engine.stack_slot_params([engine.slot_params_row(
            saddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=b))] * s,
            dev)
        lam = torch.exp(ll)
        mom = sign * (lam + sp.theta[:, None] * (lam - torch.exp(lp)))
        for name, args, library in (
                ("momentum_dot_packed", (x_t, idx, ll, lp, sign, sp.theta),
                 None if distinct else
                 (lambda x_t=x_t, i=idx[0].long(), mom=mom:
                  x_t[:, i] @ mom[..., None])),
                ("mwu_update_packed", (x_t, idx, ll, u, dw, sign, sp.mwu_c,
                                       sp.mwu_dot, d / b), None)):
            fn = getattr(ops, name)
            row = dict(kernel=name, s=s, d=d, n_pad=n_pad, b=b,
                       splits=splits_of(n_pad, b))
            try:
                out = fn(*args)
            except ValueError as err:
                print(f"  {name} S={s} d={d} n_pad={n_pad} b={b}: refused "
                      f"({err})")
                rows.append(dict(row, refused=str(err)))
                continue
            row["sha1"] = sha1(torch, out)
            row["ms"] = timer(lambda fn=fn, args=args: fn(*args))
            row["host_ms"] = host_ms(torch, lambda fn=fn, args=args:
                                     fn(*args))
            plain = getattr(ref, name + "_ref")
            row["plain_ms"] = timer(lambda p=plain, args=args: p(*args))
            row["library_ms"] = None if library is None else timer(library)
            rows.append(row)
            jobs.append((lambda fn=fn, args=args: fn(*args),
                         name + "_kernel", row))
        del x_t
    dev_ms = timer.device_ms([(fn, kernel) for fn, kernel, _ in jobs])
    for (_, _, row), (ms, _, per_call) in zip(jobs, dev_ms):
        row["device_ms"], row["device_launches"] = ms, per_call
        lib = row["library_ms"]
        print(f"  {row['kernel']} S={row['s']} d={row['d']} n_pad="
              f"{row['n_pad']} b={row['b']} R={row['splits']}: wrapper "
              f"{row['ms']:.4f} ms "
              f"(host {row['host_ms']:.4f} ms), kernel device {ms:.4f} ms ({per_call:.2f} device launches a"
              f" call), plain {row['plain_ms']:.4f} ms, x_t[:, idx] @ mom "
              f"{'null' if lib is None else f'{lib:.4f}'} ms, output sha1 "
              f"{row['sha1'][:16]}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_bench: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.core import preprocess as pp
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ops

    card = chip_smoke.card_line()
    build.build_all()
    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = dict(tag=args.tag, card=card, fwht=[], momentum_dot=[],
               mwu_update=[], reference_chunk=[], setup=[], packed=[],
               solve=[])
    print(f"{args.tag}: {card}, torch {torch.__version__}")

    data = [synthetic.non_separable(50_000, 512, beta2=0.2, seed=50_000),
            synthetic.separable(20_000, 256, seed=256)]
    shapes = []
    for ds in data:
        xp, _ = split_classes(ds.x, ds.y)
        d = ds.x.shape[1]
        shapes += [(len(xp), d), (len(ds.y) - len(xp), d), (1, d)]
    shapes += [(195, 65_536), (747, 65_536), (753, 65_536), (97, 131_072),
               (3_032, 256), (5_037, 512), (9_042, 128), (5_001, 256),
               (1_000, 32), (80, 128), (8_934, 256)]
    shapes += [(128, 2 ** j) for j in range(1, 16)]
    jobs, rows = [], []
    for n, d in shapes:
        x = torch.randn((n, d), generator=g, device="cuda")
        try:
            ops.fwht(x)
        except ValueError as err:
            print(f"  fwht n={n} d={d}: refused ({err})")
            out["fwht"].append(dict(n=n, d=d, refused=str(err)))
            continue
        copy = torch.empty_like(x)
        lib, lib_err = chip_smoke.fwht_library(torch, timer, x)
        row = dict(n=n, d=d, sha1=sha1(torch, ops.fwht(x)),
                   ms=timer(lambda x=x: ops.fwht(x)),
                   copy_ms=timer(lambda x=x, c=copy: c.copy_(x)),
                   library_ms=lib, library_error=lib_err,
                   bound_ms=8 * n * d / HBM_BYTES_PER_S * 1e3)
        rows.append(row)
        jobs.append((lambda x=x: ops.fwht(x), "fwht"))

    dots = [((20,), 250, 1), ((20,), 251, 128), ((), 4_999, 1),
            ((), 5_001, 1), ((20,), 17, 1), ((20,), 513, 128),
            ((20,), 1_025, 8), ((20,), 2_048, 128), ((20,), 100, 3),
            ((20,), 300, 130), ((20,), 250, 128), ((20,), 251, 1),
            ((20,), 5_001, 1)]
    dot_rows = []
    for lead, n, b in dots:
        cols = torch.randn(lead + (n, b), generator=g, device="cuda")
        ll = torch.randn(lead + (n,), generator=g, device="cuda") - 3
        lp = torch.randn(lead + (n,), generator=g, device="cuda") - 3
        lam = torch.exp(ll)
        mom = lam + 0.95 * (lam - torch.exp(lp))

        def fn(cols=cols, ll=ll, lp=lp):
            return ops.momentum_dot(cols, ll, lp, 0.95)

        dot_rows.append(dict(k=lead[0] if lead else 1, n=n, b=b,
                             sha1=sha1(torch, fn()), host_ms=host_ms(torch,
                                                                     fn),
                             ms=timer(fn), library_ms=timer(
                                 lambda c=cols, m=mom:
                                 c.transpose(-1, -2) @ m[..., None])))
        jobs.append((fn, "momentum_dot_kernel"))

    mwu_rows = []
    for lead, n, b in dots:
        cols = torch.randn(lead + (n, b), generator=g, device="cuda")
        ll = torch.randn(lead + (n,), generator=g, device="cuda") - 3
        u = 0.1 * torch.randn(lead + (n,), generator=g, device="cuda")
        dw = 0.01 * torch.randn(lead + (b,), generator=g, device="cuda")

        def fn(cols=cols, ll=ll, u=u, dw=dw):
            return ops.mwu_update(cols, ll, u, dw, 1.0, 1e-3, 40.0, 128.0,
                                  normalize=False)

        both = fn() + ops.mwu_update(cols, ll, u, dw, 1.0, 1e-3, 40.0,
                                     128.0)
        mwu_rows.append(dict(k=lead[0] if lead else 1, n=n, b=b,
                             sha1=sha1(torch, both), host_ms=host_ms(torch,
                                                                     fn),
                             ms=timer(fn), yardstick_ms=timer(
                                 lambda c=cols, w=dw: c @ w[..., None])))
        jobs.append((fn, "mwu_update_kernel"))

    dev = timer.device_ms(jobs, reps=20)
    for row, (dev_ms, _, per_call) in zip(rows, dev):
        row["device_ms"] = dev_ms * per_call     # every launch a pass
        row["device_launches"] = per_call
    for row, (dev_ms, _, per_call) in zip(dot_rows + mwu_rows,
                                          dev[len(rows):]):
        row["device_ms"] = dev_ms                # the kernel alone
        row["device_launches"] = per_call
    for row in rows:
        lib = row["library_ms"]
        print(f"  fwht n={row['n']} d={row['d']}: wrapper {row['ms']:.4f} "
              f"ms, device {row['device_ms']:.4f} ms a call "
              f"({row['device_launches']:.2f} device launches a call), copy "
              f"{row['copy_ms']:.4f} ms, x @ H "
              f"{'null' if lib is None else f'{lib:.4f}'} ms"
              + (f" (H not allocated: {row['library_error']})"
                 if row["library_error"] else "")
              + f", bound {row['bound_ms']:.4f} ms, output sha1 "
              f"{row['sha1'][:16]}")
    for row in dot_rows:
        print(f"  momentum_dot K={row['k']} n={row['n']} b={row['b']}: "
              f"wrapper {row['ms']:.4f} ms (host {row['host_ms']:.4f} ms), "
              f"kernel device {row['device_ms']:.4f} ms "
              f"({row['device_launches']:.2f} device launches a call), "
              f"cols.T @ mom {row['library_ms']:.4f} ms, output sha1 "
              f"{row['sha1'][:16]}")
    for row in mwu_rows:
        print(f"  mwu_update K={row['k']} n={row['n']} b={row['b']}: "
              f"wrapper {row['ms']:.4f} ms (host {row['host_ms']:.4f} ms), "
              f"kernel device {row['device_ms']:.4f} ms "
              f"({row['device_launches']:.2f} device launches a call), "
              f"cols @ dw (not the same function) "
              f"{row['yardstick_ms']:.4f} ms, output sha1 "
              f"{row['sha1'][:16]}")
    out["fwht"] += rows
    out["momentum_dot"] = dot_rows
    out["mwu_update"] = mwu_rows
    out["reference_chunk"] = reference_chunk(torch)

    for ds in data:
        xp, xm = split_classes(ds.x, ds.y)
        signs = torch.ones(pp.next_pow2(ds.x.shape[1]))
        secs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pp.preprocess(xp, xm, signs=signs, device="cuda")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs[1:])
        print(f"  preprocess n={len(ds.y)} d={ds.x.shape[1]}: {med:.4f} s "
              f"(median of 5 after a warm call)")
        out["setup"].append(dict(n=len(ds.y), d=ds.x.shape[1], s=med))
    out["packed"] = packed_kernels(torch, timer)
    out["solve"] = solve_steps(torch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
