"""Quickstart on the port: train the paper's two SVM variants on synthetic
data (the counterpart of the JAX package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

A hard-margin Saddle-SVC on separable(2000, 64), its margin held beside
Gilbert's distance between the two hulls (the paper's baseline, which it
should match), then a nu-Saddle-SVC on non_separable(3000, 64).  It runs
on the card (the FWHT and the packed step's kernels) unless ``--device
cpu`` is given.  :func:`run` takes the sizes and iteration counts, so that
tests and ``chip_smoke.py`` can run it cut; each fit records its objective
ten times (``history_``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.baselines import gilbert
from repro_torch.core.svm import SaddleNuSVC, SaddleSVC
from repro_torch.data import synthetic


def run(device=None, *, n_hm: int = 2000, n_nu: int = 3000, d: int = 64,
        hm_iters: int = 20000, gilbert_iters: int = 3000,
        nu_iters: int = 10000) -> dict:
    """Both fits and Gilbert's cross-check.  Returns the estimators, their
    training sets, test accuracies, the margin, Gilbert's distance and
    each fit's seconds."""
    out = {}
    # --- hard-margin SVM (linearly separable) ------------------------
    ds = synthetic.separable(n_hm, d, seed=0)
    tr, te = ds.split(0.2, seed=0)
    clf = SaddleSVC(eps=1e-3, beta=0.1, num_iters=hm_iters,
                    record_every=max(hm_iters // 10, 1), device=device)
    t0 = time.perf_counter()
    clf.fit(tr.x, tr.y)
    out["hm_seconds"] = time.perf_counter() - t0
    out.update(hm=clf, hm_train=tr, hm_acc=clf.score(te.x, te.y))
    print(f"[hard-margin] test acc {out['hm_acc']:.3f}  "
          f"margin {clf.margin_:.4f}")

    # cross-check against Gilbert (the paper's baseline)
    scale = 1.0 / np.linalg.norm(tr.x, axis=1).max()
    g = gilbert.solve(tr.x[tr.y > 0] * scale, tr.x[tr.y < 0] * scale,
                      num_iters=gilbert_iters, device=device)
    out["gilbert_distance"] = float(np.sqrt(2 * g.history[-1][1]))
    print(f"[hard-margin] gilbert distance {out['gilbert_distance']:.4f} "
          "(should match margin)")

    # --- nu-SVM (non-separable) --------------------------------------
    ds = synthetic.non_separable(n_nu, d, beta2=0.1, seed=1)
    tr, te = ds.split(0.2, seed=0)
    clf = SaddleNuSVC(alpha=0.85, eps=1e-3, beta=0.1, num_iters=nu_iters,
                      record_every=max(nu_iters // 10, 1), device=device)
    t0 = time.perf_counter()
    clf.fit(tr.x, tr.y)
    out["nu_seconds"] = time.perf_counter() - t0
    out.update(nu=clf, nu_train=tr, nu_acc=clf.score(te.x, te.y))
    print(f"[nu-svm]      test acc {out['nu_acc']:.3f}  "
          f"objective {clf.objective_:.5f}")
    return out


def main(argv=None, device=None) -> dict:
    """The JAX script's run (``device`` overrides ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device if device is not None else args.device)


if __name__ == "__main__":
    main()
