"""Saddle-DSVC (Algorithm 4) on the port: k = 20 clients with the paper's
communication accounting, and the comparison against distributed Gilbert
(Liu et al.), the Figure 3 setup (the counterpart of the JAX package's
``examples/distributed_svm.py``).

    PYTHONPATH=src python -m repro_torch.examples.distributed_svm \\
        [--device cpu]

The clients are simulated on one device (a leading client axis).  Comm is
printed in the paper's unit of k * d scalars.  It runs on the card unless
``--device cpu`` is given.  :func:`run` takes the sizes and iteration
counts; :func:`saddle_dsvc` and :func:`dist_gilbert` run one solver on
preprocessed arrays (a test replays the JAX package's draws through
``idx_schedule``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.baselines import dist_gilbert as dgilbert
from repro_torch.core import distributed as dist
from repro_torch.core import preprocess as pp
from repro_torch.data import synthetic

K = 20


def saddle_dsvc(xp, xm, *, k: int = K, nu: float = 0.0, num_iters: int,
                record_every: int, device=None, idx_schedule=None):
    """One Saddle-DSVC solve; returns (result, [(iteration, comm in k d
    units, objective)])."""
    res = dist.solve_distributed(xp, xm, k=k, eps=1e-3, beta=0.1, nu=nu,
                                 num_iters=num_iters,
                                 record_every=record_every,
                                 idx_schedule=idx_schedule, device=device)
    unit = k * np.shape(xp)[1]
    return res, [(it, comm / unit, obj) for it, comm, obj in res.history]


def dist_gilbert(xp, xm, *, k: int = K, num_iters: int, record_every: int,
                 device=None):
    """Distributed Gilbert; returns (state, [(iteration, comm in k d
    units, objective)], comm model)."""
    st, hist, comm = dgilbert.solve(xp, xm, k=k, num_iters=num_iters,
                                    record_every=record_every, device=device)
    unit = k * np.shape(xp)[1]
    return st, [(it, c / unit, obj) for it, c, obj in hist], comm


def _print(rows) -> None:
    for it, units, obj in rows:
        print(f"  iter {it:6d}  comm {units:8.1f} units   obj {obj:.6f}")


def run(device=None, *, n: int = 4000, d: int = 128, k: int = K,
        hm_iters: int = 8000, gilbert_iters: int = 2000,
        nu_iters: int = 6000, record_every: int = 2000,
        gilbert_every: int = 500) -> dict:
    """The three solves of the JAX script.  Returns each one's rows and
    result, the preprocessed classes and each solve's seconds."""
    ds = synthetic.separable(n, d, seed=0)
    xp, xm = ds.x[ds.y > 0], ds.x[ds.y < 0]
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                        device=device)
    out = dict(pre=pre, k=k)
    print(f"n={len(ds.y)} d={d} k={k}   (one comm unit = k*d scalars)")
    print("== Saddle-DSVC (this paper: O(k) scalars/iteration) ==")
    t0 = time.perf_counter()
    out["hm"], out["hm_rows"] = saddle_dsvc(
        pre.xp, pre.xm, k=k, num_iters=hm_iters, record_every=record_every,
        device=device)
    out["hm_seconds"] = time.perf_counter() - t0
    _print(out["hm_rows"])

    print("== distributed Gilbert (Liu et al.: O(kd)/iteration) ==")
    t0 = time.perf_counter()
    out["gilbert"], out["gilbert_rows"], _ = dist_gilbert(
        pre.xp, pre.xm, k=k, num_iters=gilbert_iters,
        record_every=gilbert_every, device=device)
    out["gilbert_seconds"] = time.perf_counter() - t0
    _print(out["gilbert_rows"])

    # nu-SVM, the first practical distributed algorithm (paper claim)
    print("== Saddle-DSVC nu-SVM ==")
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    t0 = time.perf_counter()
    out["nu"], out["nu_rows"] = saddle_dsvc(
        pre.xp, pre.xm, k=k, nu=nu, num_iters=nu_iters,
        record_every=record_every, device=device)
    out["nu_seconds"] = time.perf_counter() - t0
    _print(out["nu_rows"])
    return out


def main(argv=None, device=None) -> dict:
    """The JAX script's run (``device`` overrides ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device if device is not None else args.device)


if __name__ == "__main__":
    main()
