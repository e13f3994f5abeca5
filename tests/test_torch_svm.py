"""The port's front end on the CPU: whole SaddleSVC / SaddleNuSVC fits
replaying the JAX package's signs and coordinate schedule, convergence to
the QP optimum, the device contract, and the package's isolation from JAX
and from the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import saddle as jsaddle
from repro.core import svm as jsvm
from repro_torch.core import saddle
from repro_torch.core import preprocess as pp
from repro_torch.core.svm import SaddleNuSVC, SaddleSVC
from repro_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _jax_schedule(seed, d, b, num_iters, chunk):
    """The coordinate blocks JAX's slot driver draws for a solve at
    ``seed``: the slot key chain is split once per chunk and the chunk
    key into ``chunk`` step keys (engine.chunk_body_slots)."""
    key = jax.random.key(seed)
    out, done = [], 0
    draw = jax.jit(jax.vmap(lambda k: jengine.sample_block(k, d, b)))
    while done < num_iters:
        key, chunk_key = jax.random.split(key)
        ns = min(chunk, num_iters - done)
        out.append(np.asarray(draw(jax.random.split(chunk_key, chunk)))[:ns])
        done += ns
    return np.concatenate(out).astype(np.int32)


def _replay(jclf, clf, ds, seed):
    """Fit the JAX estimator, then the port's with JAX's signs (from the
    key split of the JAX front end) and JAX's coordinate schedule."""
    jclf.fit(ds.x, ds.y)
    d_pad = pp.next_pow2(ds.x.shape[1])
    k_pre, _ = jax.random.split(jax.random.key(seed))
    signs = np.asarray(jax.random.rademacher(k_pre, (d_pad,),
                                             dtype=np.float32))
    n = len(ds.y)
    steps = saddle.resolve_num_iters(jclf.num_iters, d_pad, jclf.eps,
                                     jclf.beta, n, jclf.block_size)
    chunk = min(jclf.record_every or steps, steps)
    sched = _jax_schedule(seed, d_pad, jclf.block_size, steps, chunk)
    clf.fit(ds.x, ds.y, signs=signs, idx_schedule=sched)
    return jclf, clf


@pytest.mark.parametrize("block_size", [1, 4])
def test_svc_fit_replays_jax(blobs_separable, block_size):
    kw = dict(eps=1e-2, beta=0.1, seed=3, block_size=block_size,
              record_every=400 // block_size)
    jclf, clf = _replay(jsvm.SaddleSVC(**kw), SaddleSVC(device=CPU, **kw),
                        blobs_separable, seed=3)
    np.testing.assert_allclose(clf.w_, jclf.w_, atol=1e-4)
    np.testing.assert_allclose(clf.b_, jclf.b_, atol=1e-4)
    np.testing.assert_allclose(clf.objective_, jclf.objective_, atol=1e-4)
    assert [m for m, _ in clf.history_] == [m for m, _ in jclf.history_]
    np.testing.assert_allclose([o for _, o in clf.history_],
                               [o for _, o in jclf.history_], atol=1e-4)


def test_nusvc_fit_replays_jax(blobs_overlapping):
    kw = dict(alpha=0.85, eps=1e-2, beta=0.1, seed=1)
    jclf, clf = _replay(jsvm.SaddleNuSVC(**kw),
                        SaddleNuSVC(device=CPU, **kw),
                        blobs_overlapping, seed=1)
    np.testing.assert_allclose(clf.w_, jclf.w_, atol=1e-4)
    np.testing.assert_allclose(clf.b_, jclf.b_, atol=1e-4)
    np.testing.assert_allclose(clf.objective_, jclf.objective_, atol=1e-4)
    np.testing.assert_allclose(clf.eta_, jclf.eta_, atol=1e-4)


@pytest.fixture(scope="module")
def small_problem():
    """tests/test_saddle.py's problem, preprocessed by the port."""
    rng = np.random.default_rng(0)
    d = 16
    xp = rng.normal(size=(30, d)).astype(np.float32) * 0.25 + 0.4
    xm = rng.normal(size=(40, d)).astype(np.float32) * 0.25 - 0.4
    import torch
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(1),
                        device=CPU)
    return pre.xp.numpy(), pre.xm.numpy()


def test_hm_converges_to_qp(small_problem, qp_oracle):
    xp, xm = small_problem
    opt = qp_oracle(xp, xm, nu=1.0)
    res = saddle.solve(xp, xm, eps=1e-3, beta=0.1, num_iters=6000,
                       device=CPU)
    obj = res.history[-1][1]
    assert obj >= opt - 1e-6                   # primal feasible
    assert obj <= opt * 1.10 + 1e-6            # within 10%


def test_nu_converges_to_qp(small_problem, qp_oracle):
    xp, xm = small_problem
    nu = 1.0 / (0.8 * 30)
    opt = qp_oracle(xp, xm, nu=nu)
    res = saddle.solve(xp, xm, eps=1e-3, beta=0.1, nu=nu, num_iters=6000,
                       device=CPU)
    obj = res.history[-1][1]
    assert obj >= opt - 1e-6
    assert obj <= opt * 1.15 + 1e-5
    eta = np.exp(res.state.log_eta.numpy())
    assert abs(eta.sum() - 1) < 1e-4 and eta.max() <= nu + 1e-5


def test_block_mode_converges(small_problem, qp_oracle):
    xp, xm = small_problem
    opt = qp_oracle(xp, xm, nu=1.0)
    res = saddle.solve(xp, xm, eps=1e-3, beta=0.1, block_size=4,
                       num_iters=6000, device=CPU)
    assert res.history[-1][1] <= opt * 1.10 + 1e-6


def test_fit_predicts_and_offsets(blobs_separable):
    """Footnote 2: the boundary sits midway between the two closest
    weighted hull points; the fit separates the separable blobs."""
    ds = blobs_separable
    clf = SaddleSVC(eps=1e-3, beta=0.1, num_iters=8000, device=CPU).fit(
        ds.x, ds.y)
    assert clf.score(ds.x, ds.y) >= 0.99 and clf.margin_ > 0
    fp = (clf.eta_ @ ds.x[ds.y > 0]) @ clf.w_ - clf.b_
    fm = (clf.xi_ @ ds.x[ds.y < 0]) @ clf.w_ - clf.b_
    np.testing.assert_allclose(fp, -fm, rtol=0.05, atol=1e-4)
    assert fp > 0 > fm


def test_single_class_y_fails_fast():
    x = np.random.default_rng(0).normal(size=(20, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="both classes"):
        SaddleSVC(num_iters=10, device=CPU).fit(x, -np.ones(20))


def test_synthetic_copies_match_the_jax_package():
    from repro.data import synthetic as jsyn
    for name, args in [("separable", (50, 8)), ("non_separable", (50, 8)),
                       ("blobs", (10, 12, 4))]:
        a = getattr(synthetic, name)(*args, seed=7)
        b = getattr(jsyn, name)(*args, seed=7)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)


def test_cuda_without_a_card_raises_instead_of_falling_back():
    """Asking for the card where there is none raises: nothing carries on
    quietly on the CPU.  (Skipped nowhere: on a machine with a card the
    same calls must succeed instead, which chip_smoke.py exercises.)"""
    import torch
    if torch.cuda.is_available():
        from repro_torch.device import resolve_device
        assert resolve_device().type == "cuda"
        return
    ds = synthetic.blobs(10, 10, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SaddleSVC(num_iters=10).fit(ds.x, ds.y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        saddle.solve(ds.x[:10], ds.x[10:], num_iters=10, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.preprocess(ds.x[:10], ds.x[10:], signs=np.ones(4))


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.core.svm, "
            "repro_torch.convert, repro_torch.data.synthetic; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
IMPORT_REPRO = re.compile(r"^\s*(import\s+repro\b(?!_torch)|"
                          r"from\s+repro\b(?!_torch)|"
                          r"from\s+repro\.|import\s+repro\.)", re.M)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_bench.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not IMPORT_JAX.search(text), f"{f} imports jax"
        assert not IMPORT_REPRO.search(text), f"{f} imports repro"
        assert "importlib" not in text, f"{f} imports dynamically"


def test_fit_above_32768_features_replays_jax():
    """d = 40,000 pads to d_pad = 65,536, where the card's FWHT takes two
    passes (a row no longer fits one block's shared memory): the port's
    preprocessing and a short hard-margin fit replaying JAX's signs and
    schedule match the JAX package's."""
    from repro.core import preprocess as jpp
    ds = synthetic.separable(24, 40_000, seed=40_000)
    xp, xm = ds.x[ds.y > 0], ds.x[ds.y < 0]
    jpre = jpp.preprocess(xp, xm, jax.random.key(0))
    assert jpre.signs.shape == (65_536,)
    pre = pp.preprocess(xp, xm, signs=np.asarray(jpre.signs), device=CPU)
    np.testing.assert_allclose(pre.xp.numpy(), np.asarray(jpre.xp),
                               atol=1e-5)
    np.testing.assert_allclose(pre.xm.numpy(), np.asarray(jpre.xm),
                               atol=1e-5)
    kw = dict(eps=1e-2, beta=0.1, seed=5, num_iters=300, record_every=100)
    jclf, clf = _replay(jsvm.SaddleSVC(**kw), SaddleSVC(device=CPU, **kw),
                        ds, seed=5)
    assert clf.w_.shape == (40_000,)
    np.testing.assert_allclose(clf.w_, jclf.w_, atol=1e-4)
    np.testing.assert_allclose(clf.b_, jclf.b_, atol=1e-4)
    np.testing.assert_allclose(clf.objective_, jclf.objective_, atol=1e-4)
    assert [m for m, _ in clf.history_] == [m for m, _ in jclf.history_]
    np.testing.assert_allclose([o for _, o in clf.history_],
                               [o for _, o in jclf.history_], atol=1e-4)
