"""The integration example on the port: a nu-SVM probe (Saddle-SVC)
trained on frozen transformer features -- the "linear probe on LM
representations" workflow, with the paper's solver as the probe trainer
(the counterpart of the JAX package's ``examples/svm_probe_lm.py``).

Any of the registered architectures can produce the features (``--arch``,
reduced as in the JAX script), so the solver composes with the whole model
zoo.

    PYTHONPATH=src python -m repro_torch.examples.svm_probe_lm \\
        --arch xlstm-125m [--device cpu]

It runs on the card unless ``--device cpu`` is given.  :func:`tokens`,
:func:`features` and :func:`fit_probe` take a model or its features and a
device, so that ``chip_smoke.py`` runs them at full width.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.svm import SaddleNuSVC
from repro_torch.models import transformer as tf

SEQ = 24        # tokens a sequence
FEATS = 128     # pooled logits kept as features
PROBE = dict(alpha=0.6, eps=1e-3, beta=0.1)


def tokens(cfg, n: int, rng: np.random.Generator):
    """Two synthetic "topics": class A draws its tokens from the first
    quarter of the vocabulary, class B from the second half.  Returns
    (tokens (2n, SEQ) int64, labels (2n,) +-1)."""
    toks_a = rng.integers(0, cfg.vocab_size // 4, size=(n, SEQ))
    toks_b = rng.integers(cfg.vocab_size // 2, cfg.vocab_size - 1,
                          size=(n, SEQ))
    return np.vstack([toks_a, toks_b]), np.r_[np.ones(n), -np.ones(n)]


@torch.no_grad()
def features(model, toks, device=None) -> np.ndarray:
    """The model's logits averaged over each sequence, the first FEATS
    kept, as float32 numpy (zero vision inputs or encoder frames where
    the architecture takes them, as the JAX script passes)."""
    cfg = model.cfg
    t = torch.as_tensor(np.asarray(toks), dtype=torch.long,
                        device=device if device is not None
                        else model.device)
    kw = {}
    b, s = t.shape
    if cfg.vision_embeds:
        kw["vision_embeds"] = torch.zeros((b, s, cfg.d_model),
                                          device=t.device)
        kw["vision_mask"] = torch.zeros((b, s), dtype=torch.bool,
                                        device=t.device)
    if cfg.is_encoder_decoder:
        kw["enc_frames"] = torch.zeros((b, cfg.enc_frames, cfg.d_model),
                                       device=t.device)
    logits, _ = model(t, **kw)
    return logits.mean(dim=1)[:, :FEATS].float().cpu().numpy()


def split(n_total: int, rng: np.random.Generator):
    """The JAX script's train / test split: 80 % / 20 % of a permutation."""
    perm = rng.permutation(n_total)
    cut = int(0.8 * n_total)
    return perm[:cut], perm[cut:]


def fit_probe(feats, y, tr, te, *, device=None, num_iters: int = 6000,
              signs=None, idx_schedule=None) -> dict:
    """The nu-SVM probe on the training rows; returns the estimator and
    its train and test accuracy.  ``signs`` and ``idx_schedule`` replay
    another run's preprocessing signs and coordinate draws."""
    clf = SaddleNuSVC(num_iters=num_iters, device=device, **PROBE)
    clf.fit(feats[tr], y[tr], signs=signs, idx_schedule=idx_schedule)
    return dict(clf=clf, train_acc=clf.score(feats[tr], y[tr]),
                test_acc=clf.score(feats[te], y[te]))


def main(argv=None, device=None) -> dict:
    """The JAX script's run (``device`` overrides ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--n-per-class", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = device if device is not None else args.device

    cfg = get_config(args.arch).reduced()
    model = tf.init_lm(cfg, seed=0, device=device)
    print(f"feature producer: {cfg.name} (reduced, "
          f"{tf.count_params(model):,} params)")
    rng = np.random.default_rng(0)
    toks, y = tokens(cfg, args.n_per_class, rng)
    feats = features(model, toks)
    tr, te = split(len(y), rng)
    out = fit_probe(feats, y, tr, te, device=device)
    print(f"probe train acc {out['train_acc']:.3f}   "
          f"test acc {out['test_acc']:.3f}")
    return dict(out, feats=feats, y=y, tr=tr, te=te)


if __name__ == "__main__":
    main()
