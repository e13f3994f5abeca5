"""End-to-end SVM training on the port (the counterpart of the JAX
package's ``examples/train_svm_e2e.py``; the paper's kind of training):
Saddle-SVC at the paper's experimental scale on synthetic data with the
full pipeline -- generation, preprocessing (the Hadamard transform), the
solver with its iteration budget, evaluation, checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.train_svm_e2e \\
        --n 20000 --d 256 --variant nu [--device cpu]

It runs on the card (the FWHT and the packed step's kernels) unless
``--device cpu`` is given; the checkpoint goes where ``--ckpt`` says.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.svm import SaddleNuSVC, SaddleSVC
from repro_torch.data import synthetic
from repro_torch.train import checkpoint


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--variant", choices=("hard", "nu"), default="nu")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--block-size", type=int, default=1,
                    help=">1 samples a block of coordinates a step")
    ap.add_argument("--ckpt", default="experiments/svm_e2e.npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Fits as the flags say (``device`` overrides ``--device``); returns
    the fitted estimator, its history, the fit's seconds, train and test
    accuracy and the checkpoint's path."""
    args = parse_args(argv)
    device = device if device is not None else args.device
    kw = dict(eps=args.eps, beta=args.beta, num_iters=args.iters,
              block_size=args.block_size,
              record_every=max(args.iters // 10, 1), device=device)
    if args.variant == "hard":
        ds = synthetic.separable(args.n, args.d, seed=0)
        clf = SaddleSVC(**kw)
    else:
        ds = synthetic.non_separable(args.n, args.d, beta2=0.2, seed=0)
        clf = SaddleNuSVC(alpha=0.85, **kw)
    tr, te = ds.split(0.1, seed=0)
    print(f"n={len(tr.y)} d={args.d} variant={args.variant} "
          f"block_size={args.block_size}")

    t0 = time.perf_counter()
    clf.fit(tr.x, tr.y)
    secs = time.perf_counter() - t0
    for it, obj in clf.history_:
        print(f"  iter {it:7d}   objective {obj:.6f}")
    train_acc, test_acc = clf.score(tr.x, tr.y), clf.score(te.x, te.y)
    print(f"trained in {secs:.1f}s   train acc {train_acc:.3f}   test acc "
          f"{test_acc:.3f}")

    checkpoint.save(args.ckpt, {"w": clf.w_, "b": np.asarray(clf.b_)})
    print(f"checkpoint -> {args.ckpt}")
    return {"clf": clf, "history": clf.history_, "seconds": secs,
            "train_acc": train_acc, "test_acc": test_acc,
            "ckpt": args.ckpt}


if __name__ == "__main__":
    main()
