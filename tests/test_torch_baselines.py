"""The port's baselines (``repro_torch.baselines``) against the JAX
package's on the CPU: the same numpy inputs through both, the
deterministic ones replayed step for step, Pegasos and HOGWILD on JAX's
own draws (rebuilt here from ``jax.random`` and passed as
``idx_schedule``), states carried across by ``convert.to_port``, and the
contracts of tests/test_baselines.py (QP oracle, accuracy, communication
models) held by the port on its own."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import dist_gilbert as jdist_gilbert
from repro.baselines import gilbert as jgilbert
from repro.baselines import hogwild as jhogwild
from repro.baselines import mdm as jmdm
from repro.baselines import pegasos as jpegasos
from repro.baselines import qp_nusvm as jqp
from repro_torch import convert
from repro_torch.baselines import (dist_gilbert, gilbert, hogwild, mdm,
                                   pegasos, qp_nusvm)
from repro_torch.core.svm import SaddleSVC
from repro_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ATOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    """tests/test_baselines.py's problem (50 + 60 points, d = 24), in
    float32 as both packages' solves read it."""
    rng = np.random.default_rng(0)
    d = 24
    xp = rng.normal(size=(50, d)).astype(np.float32) * 0.1 + 0.3 / np.sqrt(d)
    xm = rng.normal(size=(60, d)).astype(np.float32) * 0.1 - 0.3 / np.sqrt(d)
    return xp.astype(np.float32), xm.astype(np.float32)


@pytest.fixture(scope="module")
def labelled(problem):
    xp, xm = problem
    return (np.vstack([xp, xm]),
            np.r_[np.ones(len(xp)), -np.ones(len(xm))].astype(np.float32))


def _np(x):
    return convert.to_numpy_array(x)


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol,
                               err_msg=what)


def _hist_close(got, want, rtol):
    assert [h[:-1] for h in got] == [h[:-1] for h in want]
    for (*_, a), (*_, b) in zip(got, want):
        assert abs(a - b) <= rtol * abs(b), (a, b)


# ------------------------------------------------------------- Gilbert
def _gilbert_lockstep(xp, xm, steps):
    """Both packages' Gilbert steps in lockstep, each from its own state.
    Returns the first iteration at which they choose another vertex pair
    (None if they never do), with both packages' scores there, and the
    largest state difference before it."""
    jxp, jxm = jnp.asarray(xp), jnp.asarray(xm)
    txp, txm = torch.from_numpy(xp), torch.from_numpy(xm)
    jstep = jax.jit(jgilbert.gilbert_step)
    jscores = jax.jit(lambda z: (jxp @ z, jxm @ z))
    js = jgilbert.init_state(jxp, jxm)
    ts = gilbert.init_state(txp, txm)
    worst = 0.0
    for it in range(steps):
        sp_j, sm_j = (np.asarray(s) for s in jscores(js.z))
        sp_t, sm_t = (txp @ ts.z).numpy(), (txm @ ts.z).numpy()
        pick_j = (int(np.argmin(sp_j)), int(np.argmax(sm_j)))
        pick_t = (int(np.argmin(sp_t)), int(np.argmax(sm_t)))
        if pick_j != pick_t:
            return it, dict(jax=pick_j, port=pick_t, sp_jax=sp_j,
                            sm_jax=sm_j, sp_port=sp_t, sm_port=sm_t), worst
        js = jstep(js, jxp, jxm)
        ts = gilbert.gilbert_step(ts, txp, txm)
        worst = max(worst, *(float(np.abs(np.asarray(getattr(js, f))
                                          - getattr(ts, f).numpy()).max())
                             for f in ("z", "eta", "xi")))
    return None, None, worst


def test_gilbert_replays_jax(problem, qp_oracle):
    """3,000 iterations: the port's Gilbert against JAX's, z, eta and xi
    at 1e-5 and the history at 1e-6 relative.  Where the two packages'
    float32 scans part at a near-tie of two vertices' scores, the part is
    reported (iteration and both packages' scores), it must be a genuine
    tie (the two candidates' scores within 1e-6 in both packages), the
    iterations before it are held at 1e-5 (states absolute, history
    relative), and the end is held to the QP oracle as
    tests/test_baselines.py holds JAX's.  On this problem they part at
    iteration 2,488; before it the history agrees within 1.3e-6 relative
    (every step's products and sums round differently in the two
    packages)."""
    xp, xm = problem
    steps = 3000
    part, where, worst = _gilbert_lockstep(xp, xm, steps)
    assert worst <= ATOL, worst
    want = jgilbert.solve(xp, xm, num_iters=steps, record_every=100)
    got = gilbert.solve(xp, xm, num_iters=steps, record_every=100,
                        device=CPU)
    if part is None:
        for f in ("z", "eta", "xi"):
            _close(getattr(got.state, f), getattr(want.state, f), what=f)
        _hist_close(got.history, want.history, 1e-6)
    else:
        print(f"Gilbert: the packages part at iteration {part}: JAX picks "
              f"{where['jax']}, the port {where['port']}")
        for side in ("jax", "port"):
            sp, sm = where[f"sp_{side}"], where[f"sm_{side}"]
            i = sorted({where["jax"][0], where["port"][0]})
            j = sorted({where["jax"][1], where["port"][1]})
            print(f"  {side}: sp{i} = {sp[i].tolist()}, sm{j} = "
                  f"{sm[j].tolist()}")
            assert np.ptp(sp[i]) <= 1e-6 and np.ptp(sm[j]) <= 1e-6
        before = [(a, b) for a, b in zip(got.history, want.history)
                  if a[0] <= part]
        _hist_close([a for a, _ in before], [b for _, b in before], ATOL)
    opt = qp_oracle(xp, xm, nu=1.0)
    assert got.history[-1][1] <= opt * 1.05 + 1e-8
    assert got.history[-1][1] >= opt - 1e-6


def test_gilbert_vs_qp(problem, qp_oracle):
    xp, xm = problem
    opt = qp_oracle(xp, xm, nu=1.0)
    res = gilbert.solve(xp, xm, num_iters=3000, device=CPU)
    assert res.history[-1][1] <= opt * 1.05 + 1e-8
    assert res.history[-1][1] >= opt - 1e-6


def test_gilbert_weights_track_z(problem):
    xp, xm = problem
    st = gilbert.solve(xp, xm, num_iters=200, device=CPU).state
    z_from_weights = st.eta.numpy() @ xp - st.xi.numpy() @ xm
    np.testing.assert_allclose(z_from_weights, st.z.numpy(), atol=1e-4)
    assert abs(st.eta.sum().item() - 1) < 1e-5
    assert abs(st.xi.sum().item() - 1) < 1e-5
    assert st.t.dtype == torch.int32 and int(st.t) == 200


def test_gilbert_tol_stops_between_chunks(problem):
    """``tol`` stops after the first chunk that gains less, at the same
    chunk as JAX's (before the packages part: the history within 1e-5
    relative, see test_gilbert_replays_jax)."""
    xp, xm = problem
    want = jgilbert.solve(xp, xm, num_iters=3000, tol=1e-4,
                          record_every=100)
    got = gilbert.solve(xp, xm, num_iters=3000, tol=1e-4, record_every=100,
                        device=CPU)
    assert len(got.history) < 30
    _hist_close(got.history, want.history, ATOL)


def test_table1_saddle_matches_gilbert_end_to_end():
    """Paper Table 1, as tests/test_system.py holds the JAX package: at
    matched epsilon the port's Saddle-SVC margin and the port's Gilbert
    distance agree within 5 %."""
    ds = synthetic.separable(300, 32, seed=0)
    xp = ds.x[ds.y > 0]
    xm = ds.x[ds.y < 0]
    clf = SaddleSVC(eps=1e-3, beta=0.1, num_iters=10000,
                    device=CPU).fit(ds.x, ds.y)
    scale = 1.0 / np.linalg.norm(ds.x, axis=1).max()
    res = gilbert.solve(xp * scale, xm * scale, num_iters=4000, device=CPU)
    d_gilbert = np.sqrt(2 * res.history[-1][1])
    assert abs(clf.margin_ - d_gilbert) / d_gilbert < 0.05


# ------------------------------------------------------------------ MDM
def test_mdm_replays_jax(problem):
    xp, xm = problem
    pts = xp - xm.mean(0)
    jst, jhist = jmdm.solve(pts, num_iters=3000, record_every=500)
    st, hist = mdm.solve(pts, num_iters=3000, record_every=500, device=CPU)
    _close(st.lam, jst.lam, what="lam")
    _close(st.z, jst.z, what="z")
    _hist_close(hist, jhist, 1e-5)


def test_mdm_vs_gilbert_min_norm(problem):
    xp, xm = problem
    pts = xp - xm.mean(0)
    _, hist_m = mdm.solve(pts, num_iters=3000, device=CPU)
    res_g = gilbert.solve(pts, np.zeros((1, pts.shape[1]), np.float32),
                          num_iters=3000, device=CPU)
    assert abs(hist_m[-1][1] - res_g.history[-1][1]) < 2e-3


# ------------------------------------------------------------------- QP
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("n,nu", [(40, 0.08), (257, 0.01), (16, 1.0)])
def test_project_capped_simplex_matches_jax(seed, n, nu):
    y = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    want = np.asarray(jqp.project_capped_simplex(jnp.asarray(y), nu))
    got = qp_nusvm.project_capped_simplex(torch.from_numpy(y), nu)
    _close(got, want, atol=1e-6)


def test_project_capped_simplex_exact():
    """tests/test_baselines.py's KKT property, for the port."""
    rng = np.random.default_rng(1)
    y = rng.normal(size=40)
    nu = 0.08
    v = qp_nusvm.project_capped_simplex(
        torch.tensor(y, dtype=torch.float32), nu).numpy()
    assert abs(v.sum() - 1) < 1e-5
    assert v.min() >= -1e-7 and v.max() <= nu + 1e-6
    # KKT: entries strictly inside (0, nu) share a common shift y_i - v_i
    inner = (v > 1e-6) & (v < nu - 1e-6)
    assert inner.sum() >= 2
    shifts = y[inner] - v[inner]
    assert np.ptp(shifts) < 1e-4


def test_qp_default_lr_matches_jax(problem):
    """The step size from 20 power iterations, against the value JAX's
    solve derives (1/L from the same iteration in float32)."""
    xp, xm = problem
    jxp, jxm = jnp.asarray(xp), jnp.asarray(xm)
    v = jnp.ones((xp.shape[1],)) / jnp.sqrt(xp.shape[1])
    for _ in range(20):
        v2 = jxp.T @ (jxp @ v) + jxm.T @ (jxm @ v)
        v = v2 / jnp.maximum(jnp.linalg.norm(v2), 1e-30)
    lmax = float(jnp.dot(v, jxp.T @ (jxp @ v) + jxm.T @ (jxm @ v)))
    got = qp_nusvm.default_lr(torch.from_numpy(xp), torch.from_numpy(xm))
    assert abs(got - 1.0 / lmax) <= 1e-6 * (1.0 / lmax)


def test_qp_replays_jax(problem):
    """FISTA with the default lr: eta and xi within 1e-5 of JAX's."""
    xp, xm = problem
    nu = 1.0 / (0.75 * 50)
    jst, jhist = jqp.solve(xp, xm, nu=nu, num_iters=400, record_every=100)
    st, hist = qp_nusvm.solve(xp, xm, nu=nu, num_iters=400,
                              record_every=100, device=CPU)
    _close(st.eta, jst.eta, what="eta")
    _close(st.xi, jst.xi, what="xi")
    _hist_close(hist, jhist, 1e-5)


def test_qp_nusvm_capped(problem, qp_oracle):
    xp, xm = problem
    nu = 1.0 / (0.75 * 50)
    opt = qp_oracle(xp, xm, nu=nu)
    st, hist = qp_nusvm.solve(xp, xm, nu=nu, num_iters=3000, device=CPU)
    assert hist[-1][1] <= opt * 1.03 + 1e-8
    eta = st.eta.numpy()
    assert eta.max() <= nu + 1e-6 and abs(eta.sum() - 1) < 1e-5


# ------------------------------------------------------ Pegasos, HOGWILD
def _jax_draws(seed, num_iters, chunk, shape, n):
    """The draws of JAX's pegasos / hogwild ``solve``: the key split once
    a chunk, the chunk key split into a key a step, and one ``randint`` a
    step (pegasos.py:52-73, hogwild.py:72-94)."""
    key = jax.random.key(seed)
    draw = jax.jit(jax.vmap(lambda k: jax.random.randint(k, shape, 0, n)))
    out, done = [], 0
    while done < num_iters:
        key, sub = jax.random.split(key)
        ns = min(chunk, num_iters - done)
        out.append(np.asarray(draw(jax.random.split(sub, ns))))
        done += ns
    return np.concatenate(out)


def test_pegasos_replays_jax_draws(labelled):
    x, y = labelled
    kw = dict(num_iters=3000, lam=1e-3, seed=3, record_every=1000)
    jst, jhist = jpegasos.solve(x, y, **kw)
    idx = _jax_draws(3, 3000, 1000, (32,), len(y))
    st, hist = pegasos.solve(x, y, idx_schedule=idx, device=CPU, **kw)
    _close(st.w, jst.w, what="w")
    _close(st.b, jst.b, what="b")
    assert float(st.t) == 3000.0
    for (i, o, a), (ji, jo, ja) in zip(hist, jhist):
        assert i == ji and abs(o - jo) <= ATOL and abs(a - ja) <= ATOL
    np.testing.assert_array_equal(pegasos.predict(st, x),
                                  jpegasos.predict(jst, x))


def test_pegasos_separates(labelled):
    """tests/test_baselines.py's contract, on the port's own draws."""
    x, y = labelled
    st, hist = pegasos.solve(x, y, num_iters=3000, lam=1e-3, device=CPU)
    assert hist[-1][2] >= 0.95      # training accuracy


def test_hogwild_replays_jax_draws(labelled):
    x, y = labelled
    kw = dict(k=4, num_iters=2000, seed=5, record_every=500)
    jst, jhist, jcomm = jhogwild.solve(x, y, **kw)
    idx = _jax_draws(5, 2000, 500, (4, 8), len(y))
    st, hist, comm = hogwild.solve(x, y, idx_schedule=idx, device=CPU, **kw)
    for f in ("w", "w_stale", "b", "t"):
        _close(getattr(st, f), getattr(jst, f), what=f)
    for (i, c, a), (ji, jc, ja) in zip(hist, jhist):
        assert (i, c) == (ji, jc) and abs(a - ja) <= ATOL
    assert comm == tuple(jcomm)


def test_hogwild_learns(labelled):
    x, y = labelled
    st, hist, comm = hogwild.solve(x, y, k=4, num_iters=2000, device=CPU)
    assert hist[-1][2] >= 0.9
    assert comm.scalars_per_iteration() == 2 * 4 * x.shape[1]


def test_schedule_is_drawn_on_the_device_from_the_seed(labelled):
    """Without ``idx_schedule`` a solve draws ``draw_schedule(seed)``:
    replaying that schedule gives the same bits."""
    x, y = labelled
    st, _ = pegasos.solve(x, y, num_iters=50, seed=9, device=CPU)
    idx = pegasos.draw_schedule(len(y), (50, 32), 9, CPU)
    again, _ = pegasos.solve(x, y, num_iters=50, idx_schedule=idx,
                             device=CPU)
    assert torch.equal(st.w, again.w) and torch.equal(st.b, again.b)
    with pytest.raises(ValueError, match="shape"):
        pegasos.solve(x, y, num_iters=50, idx_schedule=idx[:10], device=CPU)
    with pytest.raises(ValueError, match="lie in"):
        pegasos.solve(x, y, num_iters=50, idx_schedule=idx + len(y),
                      device=CPU)


# --------------------------------------------------- distributed Gilbert
def test_dist_gilbert_replays_jax(problem):
    xp, xm = problem
    jst, jhist, jcomm = jdist_gilbert.solve(xp, xm, k=6, num_iters=500,
                                            record_every=100)
    st, hist, comm = dist_gilbert.solve(xp, xm, k=6, num_iters=500,
                                        record_every=100, device=CPU)
    _close(st.z, jst.z, what="z")
    assert int(st.t) == int(jst.t) == 500
    _hist_close(hist, jhist, 1e-5)
    assert comm == tuple(jcomm)


def test_dist_gilbert_matches_serial(problem):
    xp, xm = problem
    res = gilbert.solve(xp, xm, num_iters=500, device=CPU)
    st, hist, comm = dist_gilbert.solve(xp, xm, k=6, num_iters=500,
                                        device=CPU)
    assert abs(hist[-1][2] - res.history[-1][1]) < 1e-4
    # O(kd) per iteration (Liu et al.) -- vs Saddle-DSVC's O(k)
    assert comm.scalars_per_iteration() == 3 * 6 * xp.shape[1]


def test_dist_gilbert_picks_the_client_first():
    """The server's two-stage choice: the client by the argmin of the
    per-client minima, then the point within it.  Points 1 (client 1) and
    2 (client 0 of k = 2, round robin) tie at the least score: the
    two-stage choice takes point 2, as JAX's does, where the serial scan
    takes point 1."""
    xp = np.array([[1.0, 0.0], [0.5, 1.0], [0.5, -1.0]], np.float32)
    xm = np.array([[-1.0, 0.0]], np.float32)
    jst, _, _ = jdist_gilbert.solve(xp, xm, k=2, num_iters=1)
    st, _, _ = dist_gilbert.solve(xp, xm, k=2, num_iters=1, device=CPU)
    _close(st.z, jst.z, atol=0)
    serial = gilbert.solve(xp, xm, num_iters=1, device=CPU).state
    assert st.z[1] < 0 < serial.z[1]


# ------------------------------------------------------- crossing states
def _crossing_cases(problem):
    xp, xm = problem
    pts = xp - xm.mean(0)
    nu = 1.0 / (0.75 * 50)
    lr = 0.05
    xp_sh, mask_p = jdist_gilbert.shard_points(xp, 6)
    xm_sh, mask_m = jdist_gilbert.shard_points(xm, 6)
    t = {name: torch.from_numpy(np.asarray(a)) for name, a in dict(
        xp=xp, xm=xm, pts=pts, xp_sh=xp_sh, xm_sh=xm_sh, mask_p=mask_p,
        mask_m=mask_m).items()}
    j = {name: jnp.asarray(a) for name, a in dict(
        xp=xp, xm=xm, pts=pts, xp_sh=xp_sh, xm_sh=xm_sh, mask_p=mask_p,
        mask_m=mask_m).items()}
    eta0, xi0 = jnp.full((50,), 1 / 50), jnp.full((60,), 1 / 60)
    return {
        "gilbert": (gilbert.GilbertState,
                    jgilbert.init_state(j["xp"], j["xm"]),
                    lambda s, n: jgilbert.run_chunk(s, j["xp"], j["xm"], n),
                    lambda s, n: gilbert.run_chunk(s, t["xp"], t["xm"], n)),
        "mdm": (mdm.MDMState, jmdm.init_state(j["pts"]),
                lambda s, n: jmdm.run_chunk(s, j["pts"], n),
                lambda s, n: mdm.run_chunk(s, t["pts"], n)),
        "qp": (qp_nusvm.QPState,
               jqp.QPState(eta0, xi0, eta0, xi0, jnp.ones(())),
               lambda s, n: jqp.run_chunk(s, j["xp"], j["xm"], nu, lr, n),
               lambda s, n: qp_nusvm.run_chunk(s, t["xp"], t["xm"], nu, lr,
                                               n)),
        "dist_gilbert": (
            dist_gilbert.DistGilbertState,
            jdist_gilbert.DistGilbertState(
                z=j["xp_sh"][0, 0] - j["xm_sh"][0, 0],
                t=jnp.zeros((), jnp.int32)),
            lambda s, n: jdist_gilbert.run_chunk(
                s, j["xp_sh"], j["mask_p"], j["xm_sh"], j["mask_m"], n),
            lambda s, n: dist_gilbert.run_chunk(
                s, t["xp_sh"], t["mask_p"], t["xm_sh"], t["mask_m"], n)),
    }


@pytest.mark.parametrize("name", ["gilbert", "mdm", "qp", "dist_gilbert"])
def test_run_chunk_continues_a_jax_state(problem, name):
    """A JAX state after 100 steps, carried into the port by
    ``convert.to_port``: 100 more steps of the port's ``run_chunk`` agree
    with 100 more of JAX's at 1e-5, field by field."""
    cls, state, jrun, trun = _crossing_cases(problem)[name]
    state = jrun(state, 100)
    port = convert.to_port(cls, convert.to_numpy(state), device=CPU)
    want = jrun(state, 100)
    got = trun(port, 100)
    for f in cls._fields:
        assert getattr(got, f).dtype == getattr(port, f).dtype
        if f == "tk":
            # FISTA's momentum scalar grows like t / 2 (about 100 here,
            # where a float32 ulp is 7.6e-6): held relative
            np.testing.assert_allclose(_np(got.tk), _np(want.tk), rtol=1e-6)
        else:
            _close(getattr(got, f), getattr(want, f), what=f)


# --------------------------------------------------------------- devices
def _solves(x, y, xp, xm):
    return {
        "gilbert": lambda dev: gilbert.solve(xp, xm, num_iters=5,
                                             device=dev),
        "mdm": lambda dev: mdm.solve(xp, num_iters=5, device=dev),
        "qp_nusvm": lambda dev: qp_nusvm.solve(xp, xm, num_iters=5,
                                               device=dev),
        "pegasos": lambda dev: pegasos.solve(x, y, num_iters=5, device=dev),
        "hogwild": lambda dev: hogwild.solve(x, y, k=2, num_iters=5,
                                             device=dev),
        "dist_gilbert": lambda dev: dist_gilbert.solve(xp, xm, k=2,
                                                       num_iters=5,
                                                       device=dev),
    }


@pytest.mark.parametrize("name", ["gilbert", "mdm", "qp_nusvm", "pegasos",
                                  "hogwild", "dist_gilbert"])
def test_solve_runs_on_cuda_unless_asked(problem, labelled, monkeypatch,
                                         name):
    """Every solve defaults to the card: without one, ``cuda`` (asked for or
    by default) raises, and ``cpu`` runs."""
    run = _solves(*labelled, *problem)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("cuda", None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(dev)
    out = run(CPU)
    state = out.state if hasattr(out, "state") else out[0]
    assert all(v.device.type == "cpu" for v in state)


def test_importing_the_baselines_loads_no_jax():
    mods = ", ".join(f"repro_torch.baselines.{m}" for m in (
        "dist_gilbert", "gilbert", "hogwild", "mdm", "pegasos", "qp_nusvm"))
    code = (f"import sys; import {mods}, repro_torch.data.libsvm; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
