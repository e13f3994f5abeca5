"""The port's solver core on the CPU against the JAX package:
preprocessing with the JAX signs fed in, the packed layout, the capped
simplex bisection, the packed step replaying JAX's coordinate blocks, the
slot driver's lifecycle and history invariants, and the state conversion
between the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.core import engine as jengine
from repro.core import preprocess as jpp
from repro.core import projections as jproj
from repro.core import saddle as jsaddle
from repro_torch import convert
from repro_torch.core import engine, projections, saddle
from repro_torch.core import preprocess as pp

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = "cpu"


def _classes(seed, n1, n2, d, shift=0.4, spread=0.3):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(n1, d)).astype(np.float32) * spread + shift
    xm = rng.normal(size=(n2, d)).astype(np.float32) * spread - shift
    return xp, xm


@pytest.fixture(scope="module")
def problem():
    """A preprocessed problem with n1 + n2 = 90 (lane padding active)."""
    xp, xm = _classes(0, 37, 53, 16)
    pre = jpp.preprocess(xp, xm, jax.random.key(1))
    return np.array(pre.xp), np.array(pre.xm)


# ------------------------------------------------------------ preprocess
@pytest.mark.parametrize("d", [12, 16, 32])
def test_preprocess_matches_jax_with_its_signs(d):
    xp, xm = _classes(d, 20, 30, d)
    want = jpp.preprocess(xp, xm, jax.random.key(d))
    got = pp.preprocess(xp, xm, signs=np.asarray(want.signs), device=CPU)
    assert got.d_orig == want.d_orig == d
    np.testing.assert_array_equal(got.signs.numpy(), np.asarray(want.signs))
    np.testing.assert_allclose(float(got.scale), float(want.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(got.xp.numpy(), np.asarray(want.xp),
                               atol=1e-5)
    np.testing.assert_allclose(got.xm.numpy(), np.asarray(want.xm),
                               atol=1e-5)
    # recover_direction and transform_like through the same transform
    w = np.random.default_rng(d).normal(size=got.signs.shape[0]).astype(
        np.float32)
    np.testing.assert_allclose(
        pp.recover_direction(torch.from_numpy(w), got).numpy(),
        np.asarray(jpp.recover_direction(jnp.asarray(w), want)), atol=1e-5)
    new = _classes(d + 1, 5, 1, d)[0]
    np.testing.assert_allclose(pp.transform_like(got, new).numpy(),
                               np.asarray(jpp.transform_like(want, new)),
                               atol=1e-5)


def test_preprocess_draws_signs_from_generator():
    xp, xm = _classes(3, 10, 12, 12)
    a = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(5),
                      device=CPU)
    b = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(5),
                      device=CPU)
    assert a.signs.shape == (16,)
    assert set(a.signs.tolist()) <= {-1.0, 1.0}
    np.testing.assert_array_equal(a.xp.numpy(), b.xp.numpy())
    with pytest.raises(ValueError, match="generator or signs"):
        pp.preprocess(xp, xm, device=CPU)


@pytest.mark.parametrize("n_pad,d_pad", [(128, 16), (256, 32), (512, 16)])
def test_pack_points_to_matches_jax(n_pad, d_pad):
    xp, xm = _classes(1, 37, 53, 16)
    want = jpp.pack_points_to(xp, xm, n_pad, d_pad)
    got = pp.pack_points_to(torch.from_numpy(xp), torch.from_numpy(xm),
                            n_pad, d_pad)
    assert (got.n1, got.n2, got.n_pad) == (want.n1, want.n2, want.n_pad)
    np.testing.assert_array_equal(got.x_t.numpy(), np.asarray(want.x_t))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))


def test_pack_points_rejects_bad_pads():
    xp, xm = (torch.zeros((5, 4)), torch.zeros((6, 4)))
    with pytest.raises(ValueError):
        pp.pack_points(xp, xm, pad_to=8)
    with pytest.raises(ValueError):
        pp.pack_points(xp, xm, pad_to=200)
    with pytest.raises(ValueError):
        pp.pack_points_to(xp, xm, 128, 2)


def test_bucket_helpers_and_warm_repack_match_jax():
    for n in (1, 127, 128, 129, 1000, 50_000):
        assert pp.packed_length(n) == jpp.packed_length(n)
        assert pp.bucket_length(n) == jpp.bucket_length(n)
        assert pp.bucket_shape(n, 37) == jpp.bucket_shape(n, 37)
    lam = np.random.default_rng(0).normal(size=30).astype(np.float32)
    for args in [(10, 20, 15, 25, 128), (0, 0, 5, 7, 128)]:
        np.testing.assert_array_equal(pp.repack_warm_duals(lam, *args),
                                      jpp.repack_warm_duals(lam, *args))


# ------------------------------------------------------------ projections
@pytest.mark.parametrize("rounds", [projections.BISECT_ROUNDS,
                                    projections.BISECT_ROUNDS_SOLVER])
@pytest.mark.parametrize("nu_frac", [0.05, 0.3, 0.8])
def test_capped_bisect_masked_matches_jax(rounds, nu_frac):
    rng = np.random.default_rng(int(nu_frac * 10) + rounds)
    n, n1, n2 = 256, 90, 110
    lam = np.zeros(n, np.float32)
    lam[:n1] = rng.exponential(size=n1) ** 3
    lam[:n1] /= lam[:n1].sum()
    lam[n1:n1 + n2] = rng.exponential(size=n2) ** 3
    lam[n1:n1 + n2] /= lam[n1:n1 + n2].sum()
    sign = np.zeros(n, np.float32)
    sign[:n1], sign[n1:n1 + n2] = 1.0, -1.0
    masks = np.stack([sign > 0, sign < 0])
    nu = np.float32(1.0 / (nu_frac * n1))
    want = jproj.capped_bisect_masked(jnp.asarray(lam), nu,
                                      jnp.asarray(masks), rounds=rounds)
    got = projections.capped_bisect_masked(
        torch.from_numpy(lam)[None], torch.tensor([nu]),
        torch.from_numpy(masks)[None], rounds=rounds)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for m in masks:
        assert abs(float(got[torch.from_numpy(m)].sum()) - 1.0) < 1e-5
    assert float(got.max()) <= nu + 1e-6


def test_capped_simplex_project_bisect_single_class():
    rng = np.random.default_rng(2)
    eta = rng.exponential(size=64).astype(np.float32) ** 2
    eta /= eta.sum()
    got = projections.capped_simplex_project_bisect(torch.from_numpy(eta),
                                                    0.05)
    want = jproj.capped_simplex_project_bisect(jnp.asarray(eta), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_entropy_prox_matches_jax():
    rng = np.random.default_rng(4)
    ll = np.log(rng.dirichlet(np.ones(50))).astype(np.float32)
    v = rng.normal(size=50).astype(np.float32)
    got = projections.entropy_prox(torch.from_numpy(ll), torch.from_numpy(v),
                                   1e-3, 40.0, 16)
    want = jproj.entropy_prox(jnp.asarray(ll), jnp.asarray(v), 1e-3, 40.0, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------ packed step
def _staged(xp, xm, nu, block_size, eps=1e-3):
    """The same packed problem staged for both packages (S = 1 here)."""
    n1, n2, d = len(xp), len(xm), xp.shape[1]
    params = jsaddle.make_params(n1 + n2, d, eps, 0.1, nu=nu,
                                 block_size=block_size)
    row = jengine.slot_params_row(params)
    jpts = jpp.pack_points(xp, xm)
    jstate = jengine.init_packed_state(jpts.sign, n1, n2, d)
    pts = pp.pack_points(torch.from_numpy(xp), torch.from_numpy(xm))
    state = engine.init_packed_state(pts.sign[None], n1, n2, d)
    sp = engine.stack_slot_params([row], torch.device(CPU))
    return params, row, jpts, jstate, pts, state, sp


@pytest.mark.parametrize("nu_frac,block_size", [(0.0, 1), (0.8, 1),
                                                (0.0, 4), (0.8, 4)])
def test_step_packed_core_replays_jax(problem, nu_frac, block_size):
    """50 packed steps, each fed JAX's sample_block indices, stay within
    1e-5 of the JAX step (jnp backend) in every state field."""
    xp, xm = problem
    nu = nu_frac and 1.0 / (nu_frac * len(xp))
    params, row, jpts, jstate, pts, state, sp = _staged(xp, xm, nu,
                                                        block_size)
    d = xp.shape[1]
    jrow = jengine.SlotParams(*(jnp.float32(v) for v in row))
    jstep = jax.jit(lambda st, k: jengine._step_packed_core(
        st, k, jpts.x_t, jpts.sign, jrow, d=d, block_size=block_size,
        project=nu > 0.0))
    keys = jax.random.split(jax.random.key(7), 50)
    for k in keys:
        idx = np.array(jengine.sample_block(k, d, block_size), np.int32)
        jstate = jstep(jstate, k)
        state = engine._step_packed_core(
            state, pts.x_t[None], pts.sign[None], sp, d=d,
            block_size=block_size, project=nu > 0.0,
            idx=torch.from_numpy(idx)[None])
    # duals compared as weights, as tests/test_engine.py does
    n = len(xp) + len(xm)
    for name, f in (("w", None), ("u", None), ("log_lam", np.exp),
                    ("log_lam_prev", np.exp)):
        got = getattr(state, name)[0].numpy()
        want = np.asarray(getattr(jstate, name))
        if f is not None:
            got, want = f(got[:n]), f(want[:n])
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
    assert int(state.t[0]) == int(jstate.t) == 50
    assert (state.log_lam[0, len(xp) + len(xm):] < -1e20).all()
    # the diagnostics on the state reached
    np.testing.assert_allclose(
        float(engine.objective_from_duals(state.log_lam, pts.x_t[None],
                                          pts.sign[None])[0]),
        float(jengine.objective_from_duals(jstate.log_lam, jpts.x_t,
                                           jpts.sign)), rtol=1e-5)
    np.testing.assert_allclose(
        float(engine.saddle_gap_packed(state.w, pts.x_t[None],
                                       pts.sign[None], sp.nu)[0]),
        float(jengine.saddle_gap_packed(jstate.w, jpts.x_t, jpts.sign,
                                        jnp.float32(row.nu))), atol=1e-5)


def test_sampler_draws_distinct_uniform_blocks():
    gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
    idx = engine.sample_blocks(gens, 16, 4, 2000, torch.device(CPU))
    assert idx.shape == (2000, 2, 4) and idx.dtype == torch.int32
    srt = idx.sort(dim=-1).values
    assert (srt[..., 1:] != srt[..., :-1]).all()
    counts = torch.bincount(idx[:, 0].reshape(-1).long(), minlength=16)
    assert counts.min() > 0.8 * 500 and counts.max() < 1.2 * 500
    again = engine.sample_blocks([torch.Generator().manual_seed(0)], 16, 4,
                                 2000, torch.device(CPU))
    assert torch.equal(again[:, 0], idx[:, 0])   # a slot's own stream


# ------------------------------------------------------------ slot driver
def _slot_batch(problem, num_slots, max_t):
    xp, xm = problem
    params, row, _, _, pts, _, _ = _staged(xp, xm, 0.0, 1)
    d = xp.shape[1]
    dev = torch.device(CPU)
    st = engine.init_slot_state(num_slots, pts.n_pad, d, dev)
    for s in range(num_slots):
        ps = engine.init_packed_state(pts.sign, pts.n1, pts.n2, d)
        st = engine.admit_into_slot(st, s, ps,
                                    torch.Generator().manual_seed(s), max_t)
    sp = engine.stack_slot_params([row] * num_slots, dev)
    x_t = pts.x_t[None].repeat(num_slots, 1, 1)
    sign = pts.sign[None].repeat(num_slots, 1)
    return st, x_t, sign, sp, d


def test_slot_budget_freezes_lane_mid_chunk(problem):
    st, x_t, sign, sp, d = _slot_batch(problem, 2, max_t=30)
    st.max_t[1] = 7
    st, obj, healthy = engine.run_chunk_slots(
        st, x_t, sign, sp, 25, chunk_steps=25, d=d, block_size=1,
        project=False, check_gap=False)
    assert st.t.tolist() == [25, 7]
    assert st.active.tolist() == [True, False]
    assert healthy.all() and torch.isfinite(obj).all()


def test_frozen_lane_leaves_batch_mate_bit_equal(problem):
    runs = []
    for freeze in (False, True):
        st, x_t, sign, sp, d = _slot_batch(problem, 2, max_t=40)
        if freeze:
            st = engine.deactivate_slot(st, 1)
        st, _, _ = engine.run_chunk_slots(
            st, x_t, sign, sp, 40, chunk_steps=40, d=d, block_size=1,
            project=False, check_gap=False)
        runs.append(st)
    for name in ("w", "log_lam", "u"):
        assert torch.equal(getattr(runs[0], name)[0],
                           getattr(runs[1], name)[0])
    assert runs[1].t.tolist() == [40, 0]


def test_unhealthy_lane_is_deactivated(problem):
    st, x_t, sign, sp, d = _slot_batch(problem, 2, max_t=100)
    st.u[1, 0] = float("nan")
    st, _, healthy = engine.run_chunk_slots(
        st, x_t, sign, sp, 10, chunk_steps=10, d=d, block_size=1,
        project=False, check_gap=False)
    assert healthy.tolist() == [True, False]
    assert st.active.tolist() == [True, False]


def test_admit_overwrites_every_field(problem):
    st, x_t, sign, sp, d = _slot_batch(problem, 1, max_t=10)
    st, _, _ = engine.run_chunk_slots(st, x_t, sign, sp, 10, chunk_steps=10,
                                      d=d, block_size=1, project=False,
                                      check_gap=False)
    xp, xm = problem
    ps = engine.init_packed_state(sign[0], len(xp), len(xm), d)
    st = engine.admit_into_slot(st, 0, ps, torch.Generator().manual_seed(0),
                                5)
    assert torch.equal(st.w[0], ps.w) and torch.equal(st.u[0], ps.u)
    assert torch.equal(st.log_lam[0], ps.log_lam)
    assert st.t.tolist() == [0] and st.max_t.tolist() == [5]
    assert st.active.tolist() == [True]


def _hist(res):
    return [(int(m), float(o)) for m, o in res.history]


@pytest.mark.parametrize("driver", ["host", "device"])
def test_history_marks_with_partial_final_chunk(problem, driver):
    xp, xm = problem
    res = saddle.solve(xp, xm, num_iters=103, record_every=25,
                       driver=driver, device=CPU)
    assert [m for m, _ in res.history] == [25, 50, 75, 100, 103]
    assert all(np.isfinite(o) for _, o in res.history)
    assert int(res.state.t) == 103


@pytest.mark.parametrize("kw", [
    dict(num_iters=103, record_every=25),
    dict(num_iters=60, record_every=100),
    dict(num_iters=5000, record_every=256, gap_tol=0.5),
    dict(num_iters=160, record_every=32, block_size=4, nu=1.0 / (0.8 * 37)),
])
def test_solve_history_matches_jax(problem, kw):
    """The slot driver's history (marks at chunk boundaries, the partial
    final chunk, the gap stop) and final state, against JAX's solve with
    its coordinate schedule replayed."""
    xp, xm = problem
    want = jsaddle.solve(xp, xm, **kw)
    b = kw.get("block_size", 1)
    steps = saddle.resolve_num_iters(kw["num_iters"], xp.shape[1], 1e-3,
                                     0.1, len(xp) + len(xm), b)
    chunk = min(kw["record_every"], steps)
    got = saddle.solve(xp, xm, device=CPU, **kw, idx_schedule=_jax_schedule(
        0, xp.shape[1], b, steps, chunk))
    assert [m for m, _ in got.history] == [m for m, _ in want.history]
    np.testing.assert_allclose([o for _, o in got.history],
                               [o for _, o in want.history], atol=1e-6)
    assert int(got.state.t) == int(want.state.t)
    np.testing.assert_allclose(got.state.w.numpy(), np.asarray(want.state.w),
                               atol=1e-5)


def test_gap_stop_is_a_prefix_of_the_full_run(problem):
    xp, xm = problem
    stopped = saddle.solve(xp, xm, num_iters=5000, record_every=256,
                           gap_tol=0.5, device=CPU)
    stop_at = stopped.history[-1][0]
    assert stop_at < 5000 and stop_at % 256 == 0
    assert stop_at == int(stopped.state.t)
    full = saddle.solve(xp, xm, num_iters=stop_at, record_every=256,
                        device=CPU)
    assert _hist(stopped) == _hist(full)


def test_seeded_solve_is_reproducible_and_warm_solve_sets_up_nothing(problem):
    xp, xm = problem
    a = saddle.solve(xp, xm, num_iters=103, record_every=25, seed=3,
                     device=CPU)
    before = dict(engine.trace_counts)
    b = saddle.solve(xp, xm, num_iters=103, record_every=25, seed=3,
                     device=CPU)
    assert dict(engine.trace_counts) == before
    assert _hist(a) == _hist(b)
    c = saddle.solve(xp, xm, num_iters=103, record_every=25, seed=4,
                     device=CPU)
    assert _hist(a) != _hist(c)


def test_solve_rejects_bad_inputs(problem):
    xp, xm = problem
    with pytest.raises(ValueError):
        saddle.solve(xp, xm, nu=1.0 / (2 * len(xp)), device=CPU)
    with pytest.raises(ValueError, match="driver"):
        saddle.solve(xp, xm, driver="other", device=CPU)
    with pytest.raises(ValueError, match="idx_schedule"):
        saddle.solve(xp, xm, num_iters=4, device=CPU,
                     idx_schedule=np.full((4, 1), 16))
    with pytest.raises(ValueError, match="idx_schedule"):
        saddle.solve(xp, xm, num_iters=4, device=CPU,
                     idx_schedule=np.zeros((3, 1)))


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


def test_warm_start_from_jax_state_matches_jax(problem):
    """A JAX solve of a prefix problem, carried over by convert, warm-starts
    the port's solve of the full problem as it warm-starts JAX's."""
    xp, xm = problem
    first = jsaddle.solve(xp[:30], xm[:40], num_iters=200)
    kw = dict(num_iters=60, record_every=20, seed=5)
    want = jsaddle.solve(xp, xm, warm_start=first.state, **kw)
    warm = convert.to_port(saddle.SaddleState, first.state, CPU)
    got = saddle.solve(xp, xm, warm_start=warm, device=CPU,
                       idx_schedule=_jax_schedule(5, xp.shape[1], 1, 60, 20),
                       **kw)
    np.testing.assert_allclose(got.state.w.numpy(), np.asarray(want.state.w),
                               atol=1e-5)
    np.testing.assert_allclose(np.exp(got.state.log_eta.numpy()),
                               np.exp(np.asarray(want.state.log_eta)),
                               atol=1e-5)
    np.testing.assert_allclose([o for _, o in got.history],
                               [o for _, o in want.history], atol=1e-6)


# ------------------------------------------------------------ conversion
def test_convert_round_trip(problem):
    xp, xm = problem
    res = jsaddle.solve(xp, xm, num_iters=50)
    st = convert.to_port(saddle.SaddleState, res.state, CPU)
    assert st.t.dtype == torch.int32 and st.w.dtype == torch.float32
    for name, value in convert.to_numpy(st).items():
        np.testing.assert_array_equal(value, np.asarray(
            getattr(res.state, name)))
    pre = jpp.preprocess(xp[:, :12], xm[:, :12], jax.random.key(0))
    ppre = convert.to_port(pp.Preprocessed, pre, CPU)
    assert ppre.d_orig == 12 and ppre.scale.shape == ()
    back = convert.to_numpy(ppre)
    np.testing.assert_array_equal(back["xp"], np.asarray(pre.xp))
    np.testing.assert_array_equal(back["signs"], np.asarray(pre.signs))
    jps = jengine.init_packed_state(jpp.pack_points(xp, xm).sign, 37, 53, 16)
    ps = convert.to_port(engine.PackedState, jps._asdict(), CPU)
    np.testing.assert_array_equal(ps.log_lam.numpy(),
                                  np.asarray(jps.log_lam))


@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_per_class_objective_and_gap_match_jax(problem, nu_frac):
    """saddle.objective / saddle.saddle_gap on a JAX solve's state carried
    over by convert."""
    xp, xm = problem
    nu = nu_frac and 1.0 / (nu_frac * len(xp))
    res = jsaddle.solve(xp, xm, nu=nu, num_iters=300)
    st = convert.to_port(saddle.SaddleState, res.state, CPU)
    txp, txm = torch.from_numpy(xp), torch.from_numpy(xm)
    np.testing.assert_allclose(
        float(saddle.objective(st.log_eta, st.log_xi, txp, txm)),
        float(jsaddle.objective(res.state.log_eta, res.state.log_xi,
                                jnp.asarray(xp), jnp.asarray(xm))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(saddle.saddle_gap(st, txp, txm, nu)),
        float(jsaddle.saddle_gap(res.state, jnp.asarray(xp),
                                 jnp.asarray(xm), nu)), atol=1e-6)


# ------------------------------------------------ reference projections
def _dirichlet_like(seed, n, power=3):
    rng = np.random.default_rng(seed)
    eta = rng.exponential(size=n).astype(np.float32) ** power
    return eta / eta.sum()


@pytest.mark.parametrize("n,nu_frac", [(50, 0.3), (200, 0.05), (64, 0.5),
                                       (37, 0.8), (5, 1.0)])
def test_capped_simplex_project_sorted_matches_jax(n, nu_frac):
    """Rule 2 (one stable sort) against the JAX package's."""
    eta = _dirichlet_like(n, n)
    nu = float(np.float32(1.0 / (nu_frac * n)))
    got = projections.capped_simplex_project_sorted(torch.from_numpy(eta),
                                                    nu)
    want = jproj.capped_simplex_project_sorted(jnp.asarray(eta), nu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-5
    assert float(got.max()) <= nu + 1e-6


def test_capped_simplex_project_sorted_keeps_feasible_and_ties():
    """A feasible eta is returned as it is; equal entries (ties) project
    as the JAX package's stable argsort projects them."""
    eta = np.full(10, 0.1, np.float32)
    got = projections.capped_simplex_project_sorted(torch.from_numpy(eta),
                                                    0.2)
    np.testing.assert_array_equal(got.numpy(), eta)
    tied = np.array([0.3, 0.3, 0.1, 0.1, 0.1, 0.1], np.float32)
    got = projections.capped_simplex_project_sorted(torch.from_numpy(tied),
                                                    0.25)
    want = jproj.capped_simplex_project_sorted(jnp.asarray(tied), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("n,nu_frac", [(50, 0.3), (200, 0.05), (64, 0.5)])
def test_capped_simplex_project_loop_matches_jax(n, nu_frac):
    """Rule 3 (the iterative rescale) against the JAX package's, and
    against Rule 2 on the same input."""
    eta = _dirichlet_like(n + 1, n)
    nu = float(np.float32(1.0 / (nu_frac * n)))
    got = projections.capped_simplex_project_loop(torch.from_numpy(eta), nu)
    want = jproj.capped_simplex_project_loop(jnp.asarray(eta), nu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    sorted_ = projections.capped_simplex_project_sorted(
        torch.from_numpy(eta), nu)
    np.testing.assert_allclose(got.numpy(), sorted_.numpy(), atol=1e-5)


@pytest.mark.parametrize("nu_frac", [0.1, 0.5])
def test_capped_entropy_prox_matches_jax(nu_frac):
    rng = np.random.default_rng(int(nu_frac * 10))
    n = 60
    ll = np.log(rng.dirichlet(np.ones(n))).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    nu = 1.0 / (nu_frac * n)
    got = projections.capped_entropy_prox(torch.from_numpy(ll),
                                          torch.from_numpy(v), 1e-3, 40.0,
                                          16, nu)
    want = jproj.capped_entropy_prox(jnp.asarray(ll), jnp.asarray(v), 1e-3,
                                     40.0, 16, nu)
    np.testing.assert_allclose(np.exp(got.numpy()), np.exp(np.asarray(want)),
                               atol=1e-6)


# ------------------------------------------------ reference step
def test_init_state_matches_jax(problem):
    xp, xm = problem
    got = saddle.init_state(37, 53, 16, torch.from_numpy(xp))
    want = jsaddle.init_state(37, 53, 16, xp, xm)
    for name, value in convert.to_numpy(got).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(want, name)))
    assert saddle.init_state(2, 3, 4, device=CPU).w.device.type == "cpu"


def _ref_replay(problem, nu_frac, block_size, iters=80, seed=0):
    """JAX's reference chunk and the blocks it draws for ``iters`` steps
    from the key solve() would split off at ``seed``."""
    xp, xm = problem
    n1, n2, d = xp.shape[0], xm.shape[0], xp.shape[1]
    nu = nu_frac and 1.0 / (nu_frac * n1)
    params = jsaddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu,
                                 block_size=block_size)
    key = jax.random.split(jax.random.key(seed))[1]
    idx = np.array(jax.vmap(lambda k: jengine.sample_block(
        k, d, block_size))(jax.random.split(key, iters)), np.int32)
    return params, key, idx


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_reference_run_chunk_replays_jax(problem, backend, nu_frac):
    """The port's engine.run_chunk and saddle.run_chunk (the unpacked
    reference, Rule 2 for nu > 0) replay JAX's engine.run_chunk for
    either JAX backend, at the 1e-5 of
    test_packed_matches_reference_serial."""
    xp, xm = problem
    n1, n2, d = xp.shape[0], xm.shape[0], xp.shape[1]
    iters = 80
    params, key, idx = _ref_replay(problem, nu_frac, 1, iters)
    want = jsaddle.init_state(n1, n2, d, xp, xm)
    want, want_obj = jengine.run_chunk(
        want, key, jnp.asarray(xp), jnp.asarray(xm), iters, params=params,
        chunk_steps=iters, backend=backend)
    txp, txm = torch.from_numpy(xp), torch.from_numpy(xm)
    p = saddle.SaddleParams(*params)
    got, obj = engine.run_chunk(saddle.init_state(n1, n2, d, txp), txp,
                                txm, iters, params=p,
                                idx=torch.from_numpy(idx))
    got2 = saddle.run_chunk(saddle.init_state(n1, n2, d, txp), txp,
                            txm, p, iters, idx_schedule=idx)
    for st in (got, got2):
        np.testing.assert_allclose(st.w.numpy(), np.asarray(want.w),
                                   atol=1e-5)
        for a, b in [(st.log_eta, want.log_eta), (st.log_xi, want.log_xi)]:
            np.testing.assert_allclose(np.exp(a.numpy()),
                                       np.exp(np.asarray(b)), atol=1e-5)
        np.testing.assert_allclose(st.u_p.numpy(), np.asarray(want.u_p),
                                   atol=1e-5)
        np.testing.assert_allclose(st.u_m.numpy(), np.asarray(want.u_m),
                                   atol=1e-5)
        assert int(st.t) == iters
    np.testing.assert_allclose(float(obj), float(want_obj), rtol=1e-5)


@pytest.mark.parametrize("block_size", [1, 4])
def test_saddle_step_matches_jax(problem, block_size):
    """Single reference steps (saddle_step: the port of both JAX names)
    against JAX's saddle_step_kernels (Pallas in interpret mode)."""
    xp, xm = problem
    params, _key, _ = _ref_replay(problem, 0.0, block_size, 1)
    p = saddle.SaddleParams(*params)
    txp, txm = torch.from_numpy(xp), torch.from_numpy(xm)
    st = saddle.init_state(37, 53, 16, txp)
    jst = jsaddle.init_state(37, 53, 16, xp, xm)
    for i, key in enumerate(jax.random.split(jax.random.key(3), 6)):
        idx = torch.from_numpy(np.array(
            jengine.sample_block(key, 16, block_size), np.int32))
        jst = jsaddle.saddle_step_kernels(jst, key, jnp.asarray(xp),
                                          jnp.asarray(xm), params)
        st = saddle.saddle_step(st, txp, txm, p, idx=idx)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(jst.w), atol=1e-6)
    np.testing.assert_allclose(np.exp(st.log_eta.numpy()),
                               np.exp(np.asarray(jst.log_eta)), atol=1e-6)


def test_reference_step_draws_from_generator(problem):
    """Without a schedule the reference step draws its block from the
    given generator: the same seed gives the same state."""
    xp, xm = problem
    txp, txm = torch.from_numpy(xp), torch.from_numpy(xm)
    params = saddle.make_params(90, 16, 1e-3, 0.1, block_size=4)
    runs = [saddle.run_chunk(saddle.init_state(37, 53, 16, txp), txp,
                             txm, params, 20,
                             generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0].w, runs[1].w)
    assert int((runs[0].w != 0).sum()) > 4
    with pytest.raises(ValueError, match="idx_schedule"):
        saddle.run_chunk(saddle.init_state(37, 53, 16, txp), txp, txm,
                         params, 3, idx_schedule=np.zeros((3, 4)))


@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_packed_matches_reference_serial(problem, nu_frac):
    """The packed solve against the port's unpacked reference on the same
    blocks, 80 steps, 1e-5 (the JAX test of the same name)."""
    xp, xm = problem
    iters = 80
    params, _key, idx = _ref_replay(problem, nu_frac, 1, iters)
    txp, txm = torch.from_numpy(xp), torch.from_numpy(xm)
    ref, _ = engine.run_chunk(saddle.init_state(37, 53, 16, txp), txp,
                              txm, iters, params=saddle.SaddleParams(*params),
                              idx=torch.from_numpy(idx))
    got = saddle.solve(xp, xm, nu=params.nu, num_iters=iters,
                       idx_schedule=idx, device=CPU).state
    np.testing.assert_allclose(got.w.numpy(), ref.w.numpy(), atol=1e-5)
    for a, b in [(got.log_eta, ref.log_eta), (got.log_xi, ref.log_xi)]:
        np.testing.assert_allclose(np.exp(a.numpy()), np.exp(b.numpy()),
                                   atol=1e-5)
    np.testing.assert_allclose(got.u_p.numpy(), ref.u_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.u_m.numpy(), ref.u_m.numpy(), atol=1e-5)


@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_serial_dist_kernel_parity(problem, nu_frac):
    """Serial, distributed (k = 5, round-robin padding active) and the
    JAX package's Pallas-backed serial solve, all on JAX's schedule:
    one iterate within 1e-5."""
    from repro_torch.core import distributed as dist
    xp, xm = problem
    nu = nu_frac and 1.0 / (nu_frac * xp.shape[0])
    sched = _jax_schedule(0, 16, 1, 200, 200)
    ker = jsaddle.solve(xp, xm, nu=nu, num_iters=200, use_kernels=True)
    ser = saddle.solve(xp, xm, nu=nu, num_iters=200, idx_schedule=sched,
                       device=CPU)
    d5 = dist.solve_distributed(xp, xm, k=5, nu=nu, num_iters=200,
                                idx_schedule=sched, device=CPU)
    w = ser.state.w.numpy()
    np.testing.assert_allclose(w, np.asarray(ker.state.w), atol=1e-5)
    np.testing.assert_allclose(w, d5.state.w[0].numpy(), atol=1e-5)
    eta, xi = dist.gather_duals(d5.state, 37, 53, 5)
    np.testing.assert_allclose(np.exp(ser.state.log_eta.numpy()), eta,
                               atol=1e-5)
    np.testing.assert_allclose(np.exp(ser.state.log_xi.numpy()), xi,
                               atol=1e-5)
    np.testing.assert_allclose(np.exp(ser.state.log_xi.numpy()),
                               np.exp(np.asarray(ker.state.log_xi)),
                               atol=1e-5)


def test_run_chunk_packed_keeps_lane_padding_and_matches_jax(problem):
    """The serial packed chunk with nu > 0: lane padding stays NEG_INF,
    each class sums to 1 under the cap, and the state replays JAX's
    run_chunk_packed on its blocks."""
    xp, xm = problem
    n1, n2 = 37, 53
    nu = 1.0 / (0.6 * n1)
    params = jsaddle.make_params(n1 + n2, 16, 1e-3, 0.1, nu=nu)
    jpts = jpp.pack_points(xp, xm)
    key = jax.random.key(3)
    want, want_obj = jengine.run_chunk_packed(
        jengine.init_packed_state(jpts.sign, n1, n2, 16), key, jpts.x_t,
        jpts.sign, 150, params=params, chunk_steps=150)
    idx = np.array(jax.vmap(lambda k: jengine.sample_block(k, 16, 1))(
        jax.random.split(key, 150)), np.int32)
    pts = pp.pack_points(torch.from_numpy(xp), torch.from_numpy(xm))
    st = engine.init_packed_state(pts.sign[None], n1, n2, 16)
    st, obj = engine.run_chunk_packed(st, pts.x_t[None], pts.sign[None],
                                      150, params=params,
                                      idx=torch.from_numpy(idx))
    lam = st.log_lam[0]
    assert (lam[n1 + n2:] == engine.NEG_INF).all()
    eta, xi = torch.exp(lam[:n1]), torch.exp(lam[n1:n1 + n2])
    assert abs(float(eta.sum()) - 1) < 1e-4 and abs(float(xi.sum()) - 1) < 1e-4
    assert float(eta.max()) <= nu + 1e-5 and float(xi.max()) <= nu + 1e-5
    np.testing.assert_allclose(torch.exp(lam).numpy(),
                               np.exp(np.asarray(want.log_lam)), atol=1e-5)
    np.testing.assert_allclose(st.w[0].numpy(), np.asarray(want.w),
                               atol=1e-5)
    np.testing.assert_allclose(float(obj[0]), float(want_obj), rtol=1e-5)


def test_drive_marks_and_one_transfer(problem):
    """engine.drive: chunk marks with a partial final chunk, each chunk
    given its slice of the blocks."""
    xp, xm = problem
    seen = []

    def run(st, idx):
        seen.append(idx.shape[0])
        return st + idx.shape[0], torch.tensor([float(st), -1.0])

    def draw(done, ns):
        return torch.zeros((ns, 1), dtype=torch.int32)

    st, hist = engine.drive(0, 250, 97, run, draw)
    assert st == 250 and seen == [97, 97, 56]
    assert hist == [(97, 0.0), (194, 97.0), (250, 194.0)]
