"""The port's walkthroughs (``repro_torch.examples``) run end to end on the
CPU and check what they claim: ``serve_lm`` exact against solo decodes,
``quickstart``'s fits at the QP optimum and Gilbert's distance,
``distributed_svm`` and ``svm_probe_lm`` replaying the JAX package's
scripts on JAX's arrays, weights and draws."""

import numpy as np
import pytest

from _torch_launch_workers import one_thread  # noqa: F401

pytestmark = [pytest.mark.serve, pytest.mark.usefixtures("one_thread")]


def test_serve_lm_example_exact_and_falls_back(capsys):
    """``python -m repro_torch.examples.serve_lm --device cpu``: four
    staggered requests to reduced gemma-7b, two admitted mid-decode, each
    EXACT against its solo ``generate``; reduced recurrentgemma-2b on the
    service's fallback path, EXACT too."""
    from repro_torch.examples import serve_lm

    out = serve_lm.main(device="cpu")
    assert len(out["staggered"]) == len(serve_lm.REQS)
    assert all(ok for _, _, ok in out["staggered"])
    assert sum(chunk > 0 for _, chunk, _ in out["staggered"]) >= 2
    assert out["fallback"] == (False, True)
    assert "MISMATCH" not in capsys.readouterr().out


# ------------------------------------------------- quickstart.py
@pytest.fixture(scope="module")
def quickstart_run():
    from repro_torch.examples import quickstart

    return quickstart.run("cpu", n_hm=100, n_nu=100, d=8, hm_iters=10000,
                          gilbert_iters=3000, nu_iters=3000)


def _scaled_classes(ds):
    scale = 1.0 / np.linalg.norm(ds.x, axis=1).max()
    return ds.x[ds.y > 0] * scale, ds.x[ds.y < 0] * scale


def test_quickstart_fits_reach_the_qp_optimum(quickstart_run, qp_oracle):
    """Both fits of ``repro_torch.examples.quickstart`` (cut to 100 points
    in d = 8) within 1e-2 of the QP oracle's optimum on the same scaled
    training points, never below it."""
    out = quickstart_run
    xp, xm = _scaled_classes(out["hm_train"])
    opt = qp_oracle(xp, xm, nu=1.0)
    assert opt - 1e-6 <= out["hm"].objective_ <= opt * (1 + 1e-2)
    xp, xm = _scaled_classes(out["nu_train"])
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    opt = qp_oracle(xp, xm, nu=nu)
    assert opt - 1e-6 <= out["nu"].objective_ <= opt * (1 + 1e-2)
    assert out["hm_acc"] >= 0.9 and out["nu_acc"] >= 0.7


def test_quickstart_margin_matches_gilbert(quickstart_run):
    out = quickstart_run
    assert out["hm"].margin_ == pytest.approx(out["gilbert_distance"],
                                              rel=1e-2)


# -------------------------------------------- distributed_svm.py
def _jax_schedule(seed, d, b, num_iters, chunk):
    """The coordinate blocks of a JAX solve (tests/test_torch_distributed.py)."""
    import jax
    from repro.core import engine as jengine

    key = jax.random.key(seed)
    out, done = [], 0
    draw = jax.jit(jax.vmap(lambda k: jengine.sample_block(k, d, b)))
    while done < num_iters:
        key, chunk_key = jax.random.split(key)
        ns = min(chunk, num_iters - done)
        out.append(np.asarray(draw(jax.random.split(chunk_key, chunk)))[:ns])
        done += ns
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def dist_problem():
    """The example's data cut to 400 points in d = 16, preprocessed by
    the JAX package as its script does."""
    import jax
    from repro.core import preprocess as jpp
    from repro_torch.data import synthetic

    ds = synthetic.separable(400, 16, seed=0)
    xp, xm = ds.x[ds.y > 0], ds.x[ds.y < 0]
    pre = jpp.preprocess(xp, xm, jax.random.key(0))
    return np.asarray(pre.xp), np.asarray(pre.xm), len(xp), len(xm)


@pytest.mark.parametrize("nu_frac", [0.0, 0.85])
def test_distributed_svm_replays_jax(dist_problem, nu_frac):
    """Saddle-DSVC as the example runs it (k = 20): comm in k d units
    equal to the JAX example's history exactly (both analytic), the
    objective history within 1e-5, on JAX's arrays and draws."""
    from repro.core import distributed as jdist
    from repro_torch.examples import distributed_svm as ex

    xp, xm, n1, n2 = dist_problem
    nu = nu_frac and 1.0 / (nu_frac * min(n1, n2))
    iters, every = 300, 100
    want = jdist.solve_distributed(xp, xm, k=ex.K, eps=1e-3, beta=0.1, nu=nu,
                                   num_iters=iters, record_every=every)
    _, rows = ex.saddle_dsvc(
        xp, xm, nu=nu, num_iters=iters, record_every=every, device="cpu",
        idx_schedule=_jax_schedule(0, xp.shape[1], 1, iters, every))
    unit = ex.K * xp.shape[1]
    assert [(it, units) for it, units, _ in rows] == \
        [(it, comm / unit) for it, comm, _ in want.history]
    np.testing.assert_allclose([o for *_, o in rows],
                               [o for *_, o in want.history], atol=1e-5)


def test_distributed_svm_gilbert_replays_jax(dist_problem):
    from repro.baselines import dist_gilbert as jdg
    from repro_torch.examples import distributed_svm as ex

    xp, xm, _, _ = dist_problem
    jst, jhist, jcomm = jdg.solve(xp, xm, k=ex.K, num_iters=200,
                                  record_every=50)
    st, rows, comm = ex.dist_gilbert(xp, xm, num_iters=200, record_every=50,
                                     device="cpu")
    unit = ex.K * xp.shape[1]
    assert [(it, units) for it, units, _ in rows] == \
        [(it, c / unit) for it, c, _ in jhist]
    np.testing.assert_allclose([o for *_, o in rows],
                               [o for *_, o in jhist], atol=1e-5)
    np.testing.assert_allclose(st.z.numpy(), np.asarray(jst.z), atol=1e-5)
    assert comm == tuple(jcomm)


# ----------------------------------------------- svm_probe_lm.py
@pytest.mark.parametrize("arch", ["gemma-7b", "xlstm-125m"])
def test_svm_probe_lm_replays_jax(arch):
    """The probe's features from a reduced model with JAX's weights
    (``convert.lm_params_from_jax``) within 1e-4 of max |logit| of the JAX
    script's, and the probe's fit replayed on JAX's features with JAX's
    signs and draws within 1e-4."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.core import svm as jsvm
    from repro.models import transformer as jtf
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import preprocess as pp
    from repro_torch.examples import svm_probe_lm as ex

    cfg = get_config(arch).reduced()
    jcfg = dataclasses.replace(jget_config(arch),
                               **dataclasses.asdict(cfg))
    params = jtf.init_lm(jax.random.key(0), jcfg)
    model = convert.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks, y = ex.tokens(cfg, 30, rng)
    logits, _, _ = jtf.forward(params, jcfg, jnp.asarray(toks, jnp.int32))
    want = np.asarray(logits.mean(axis=1))[:, :ex.FEATS]
    got = ex.features(model, toks, "cpu")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    tr, te = ex.split(len(y), rng)
    iters, seed = 600, 0
    jclf = jsvm.SaddleNuSVC(num_iters=iters, seed=seed, **ex.PROBE)
    jclf.fit(want[tr], y[tr])
    k_pre, _ = jax.random.split(jax.random.key(seed))
    d_pad = pp.next_pow2(ex.FEATS)
    signs = np.asarray(jax.random.rademacher(k_pre, (d_pad,),
                                             dtype=np.float32))
    out = ex.fit_probe(want, y, tr, te, device="cpu", num_iters=iters,
                       signs=signs,
                       idx_schedule=_jax_schedule(seed, d_pad, 1, iters,
                                                  iters))
    np.testing.assert_allclose(out["clf"].w_, jclf.w_, atol=1e-4)
    np.testing.assert_allclose(out["clf"].b_, jclf.b_, atol=1e-4)
    assert out["test_acc"] == jclf.score(want[te], y[te])
