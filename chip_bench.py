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
    the n = 1 recovery of each serial fit) and at d = 65,536 / 131,072:
    wrapper ms by events, kernel device ms a call, device launches a call,
    a copy of the same bytes (``out.copy_(x)``) and ``x @ H`` by the same
    events, and the bound; a tree that refuses a shape says so;
  * the unpacked momentum dot at the reference step's shapes (path c) and
    the JAX kernel tests' shapes with 20 clients: wrapper ms by events,
    kernel device ms, device launches a call, ``cols.T @ mom`` by events;
  * the unpacked MWU at the same shapes, as the reference step calls it
    (``normalize=False``): wrapper ms by events, kernel device ms, device
    launches a call, and ``cols @ dw`` by events, a yardstick that is not
    the same function (the row dot alone, no dual update or logsumexp);
  * path c's reference chunk on the Figure 3 data (80 steps of the
    unpacked step at k = 20 and serially): ms per step, host clock,
    synchronised (median of 5 after a warm run);
  * path a's set-up: ``preprocess.preprocess`` of each serial fit's data
    on the card, wall seconds (median of 5, synchronised).

The last line is the same numbers as one JSON object.  It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate (data sheet)


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
    from repro_torch.kernels import build, ops, ref

    card = chip_smoke.card_line()
    build.build_all()
    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = dict(tag=args.tag, card=card, fwht=[], momentum_dot=[],
               mwu_update=[], reference_chunk=[], setup=[])
    print(f"{args.tag}: {card}, torch {torch.__version__}")

    data = [synthetic.non_separable(50_000, 512, beta2=0.2, seed=50_000),
            synthetic.separable(20_000, 256, seed=256)]
    shapes = []
    for ds in data:
        xp, _ = split_classes(ds.x, ds.y)
        d = ds.x.shape[1]
        shapes += [(len(xp), d), (len(ds.y) - len(xp), d), (1, d)]
    shapes += [(195, 65_536), (97, 131_072)]
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
        lib = None
        if d < 32_768:
            had = ref.fwht_ref(torch.eye(d, device="cuda"))
            lib = timer(lambda x=x, had=had: x @ had)
        row = dict(n=n, d=d, ms=timer(lambda x=x: ops.fwht(x)),
                   copy_ms=timer(lambda x=x, c=copy: c.copy_(x)),
                   library_ms=lib, bound_ms=8 * n * d / HBM_BYTES_PER_S * 1e3)
        rows.append(row)
        jobs.append((lambda x=x: ops.fwht(x), "fwht"))

    dots = [((20,), 250, 1), ((20,), 251, 128), ((), 4_999, 1),
            ((), 5_001, 1), ((20,), 17, 1), ((20,), 513, 128),
            ((20,), 1_025, 8), ((20,), 2_048, 128), ((20,), 100, 3),
            ((20,), 300, 130)]
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

        mwu_rows.append(dict(k=lead[0] if lead else 1, n=n, b=b,
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
              f"{'null' if lib is None else f'{lib:.4f}'} ms, bound "
              f"{row['bound_ms']:.4f} ms")
    for row in dot_rows:
        print(f"  momentum_dot K={row['k']} n={row['n']} b={row['b']}: "
              f"wrapper {row['ms']:.4f} ms, kernel device "
              f"{row['device_ms']:.4f} ms ({row['device_launches']:.2f} "
              f"device launches a call), cols.T @ mom "
              f"{row['library_ms']:.4f} ms")
    for row in mwu_rows:
        print(f"  mwu_update K={row['k']} n={row['n']} b={row['b']}: "
              f"wrapper {row['ms']:.4f} ms, kernel device "
              f"{row['device_ms']:.4f} ms ({row['device_launches']:.2f} "
              f"device launches a call), cols @ dw (not the same function) "
              f"{row['yardstick_ms']:.4f} ms")
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
