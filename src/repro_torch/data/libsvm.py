"""Reader and writer for the LIBSVM text format of the paper's real data
sets ("a9a", "ijcnn1", "phishing", ... from the LIBSVM site):

    <label> <index>:<value> <index>:<value> ...

Labels are mapped to {+1, -1}; indices are 1-based.  The port's own copy
of the JAX package's reader (numpy only), returning the port's
``Dataset``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import Dataset


def load_libsvm(path: str, *, n_features: int | None = None) -> Dataset:
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    max_idx = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            feats = []
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break
                idx, val = tok.split(":")
                j = int(idx) - 1
                feats.append((j, float(val)))
                max_idx = max(max_idx, j + 1)
            rows.append(feats)
    d = n_features or max_idx
    x = np.zeros((len(rows), d), np.float32)
    for i, feats in enumerate(rows):
        for j, v in feats:
            if j < d:
                x[i, j] = v
    y_raw = np.asarray(labels)
    uniq = np.unique(y_raw)
    if set(uniq.tolist()) <= {-1.0, 1.0}:
        y = y_raw.astype(np.int64)
    else:
        # the larger of the labels is +1, every other one -1
        pos = uniq[-1]
        y = np.where(y_raw == pos, 1, -1).astype(np.int64)
    return Dataset(x, y)


def save_libsvm(path: str, ds: Dataset) -> None:
    with open(path, "w") as f:
        for xi, yi in zip(ds.x, ds.y):
            nz = np.nonzero(xi)[0]
            feats = " ".join(f"{j + 1}:{xi[j]:.6g}" for j in nz)
            f.write(f"{int(yi)} {feats}\n")
