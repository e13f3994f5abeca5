"""The port's Algorithm 4 (``repro_torch.core.distributed``) on the CPU:
k clients simulated as a leading client axis, held against the port's own
serial solve and against the JAX package's ``solve_distributed`` /
``run_chunk_sim`` on the data of tests/test_distributed.py (37 + 53
points, d = 16).  The port replays JAX's coordinate blocks as a schedule:
``engine.drive`` splits one key per chunk and the chunk key into one key
per step, each drawn by ``engine.sample_block``."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.core import preprocess as jpp
from repro.core import saddle as jsaddle
from repro_torch import convert
from repro_torch.core import distributed as dist
from repro_torch.core import engine, projections, saddle
from repro_torch.core import preprocess as pp

CPU = "cpu"


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    d = 16
    xp = rng.normal(size=(37, d)).astype(np.float32) * 0.3 + 0.4
    xm = rng.normal(size=(53, d)).astype(np.float32) * 0.3 - 0.4
    pre = jpp.preprocess(xp, xm, jax.random.key(1))
    return np.array(pre.xp), np.array(pre.xm)


def _jax_schedule(seed, d, b, num_iters, chunk):
    """The coordinate blocks of a JAX solve at ``seed`` whose chunks are
    ``chunk`` steps: one key split off per chunk, the chunk key split
    into ``chunk`` step keys."""
    key = jax.random.key(seed)
    out, done = [], 0
    draw = jax.jit(jax.vmap(lambda k: jengine.sample_block(k, d, b)))
    while done < num_iters:
        key, chunk_key = jax.random.split(key)
        ns = min(chunk, num_iters - done)
        out.append(np.asarray(draw(jax.random.split(chunk_key, chunk)))[:ns])
        done += ns
    return np.concatenate(out).astype(np.int32)


def _nu(frac, n1):
    return frac and 1.0 / (frac * n1)


def _assert_weights_close(got_log, want_log, atol):
    np.testing.assert_allclose(np.exp(convert.to_numpy_array(got_log)),
                               np.exp(np.asarray(want_log)), atol=atol)


# ------------------------------------------------ distributed == serial
@pytest.mark.parametrize("k", [1, 4, 7])
def test_distributed_matches_serial_hm(problem, k):
    xp, xm = problem
    ser = saddle.solve(xp, xm, num_iters=400, device=CPU)
    d = dist.solve_distributed(xp, xm, k=k, num_iters=400, device=CPU)
    np.testing.assert_allclose(ser.state.w.numpy(), d.state.w[0].numpy(),
                               atol=1e-4)
    # every client holds the same w (the server broadcasts)
    for c in range(1, k):
        np.testing.assert_allclose(d.state.w[0].numpy(),
                                   d.state.w[c].numpy(), atol=1e-6)


def test_distributed_matches_serial_nu(problem):
    xp, xm = problem
    nu = 1.0 / (0.8 * 37)
    ser = saddle.solve(xp, xm, nu=nu, num_iters=300, device=CPU)
    d = dist.solve_distributed(xp, xm, k=5, nu=nu, num_iters=300,
                               device=CPU)
    np.testing.assert_allclose(ser.state.w.numpy(), d.state.w[0].numpy(),
                               atol=1e-4)
    eta, _xi = dist.gather_duals(d.state, 37, 53, 5)
    np.testing.assert_allclose(np.exp(ser.state.log_eta.numpy()), eta,
                               atol=1e-4)


@pytest.mark.parametrize("k", [2, 3, 7])
def test_parity_n_not_divisible_by_k(problem, k):
    """Neither class count (37, 53) divides by k, so every shard carries
    round-robin padding; nu > 0, so the projection runs over it."""
    xp, xm = problem
    nu = 1.0 / (0.8 * xp.shape[0])
    ser = saddle.solve(xp, xm, nu=nu, num_iters=120, device=CPU)
    dk = dist.solve_distributed(xp, xm, k=k, nu=nu, num_iters=120,
                                device=CPU)
    np.testing.assert_allclose(ser.state.w.numpy(), dk.state.w[0].numpy(),
                               atol=1e-5)
    eta, xi = dist.gather_duals(dk.state, xp.shape[0], xm.shape[0], k)
    np.testing.assert_allclose(np.exp(ser.state.log_eta.numpy()), eta,
                               atol=1e-5)
    np.testing.assert_allclose(np.exp(ser.state.log_xi.numpy()), xi,
                               atol=1e-5)


def test_k1_distributed_equals_serial_bit_for_bit(problem):
    """k = 1 is the degenerate client: the only difference from the serial
    solve is the sum and max over a client axis of size 1, which are
    exact -- every state field bit for bit, nu = 0 and nu > 0."""
    xp, xm = problem
    for nu_frac in (0.0, 0.8):
        nu = _nu(nu_frac, xp.shape[0])
        ser = saddle.solve(xp, xm, nu=nu, num_iters=120, record_every=50,
                           device=CPU)
        d1 = dist.solve_distributed(xp, xm, k=1, nu=nu, num_iters=120,
                                    record_every=50, device=CPU)
        assert torch.equal(ser.state.w, d1.state.w[0])
        for a, b in [(ser.state.log_eta, d1.state.log_eta[0]),
                     (ser.state.log_xi, d1.state.log_xi[0]),
                     (ser.state.u_p, d1.state.u_p[0]),
                     (ser.state.u_m, d1.state.u_m[0])]:
            assert torch.equal(a, b)
        assert [o for _, o in ser.history] == [o for *_, o in d1.history]


# ------------------------------------------------ port against JAX
@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_solve_distributed_matches_jax(problem, nu_frac):
    """Port and JAX package at k = 5 on JAX's coordinate schedule: state
    within 1e-5 (w, dual weights, u), history within 1e-6."""
    xp, xm = problem
    nu = _nu(nu_frac, xp.shape[0])
    kw = dict(k=5, nu=nu, num_iters=150, record_every=60, seed=4)
    want = jdist.solve_distributed(xp, xm, **kw)
    got = dist.solve_distributed(
        xp, xm, device=CPU, **kw,
        idx_schedule=_jax_schedule(4, xp.shape[1], 1, 150, 60))
    np.testing.assert_allclose(got.state.w.numpy(), np.asarray(want.state.w),
                               atol=1e-5)
    _assert_weights_close(got.state.log_eta, want.state.log_eta, 1e-5)
    _assert_weights_close(got.state.log_xi, want.state.log_xi, 1e-5)
    np.testing.assert_allclose(got.state.u_m.numpy(),
                               np.asarray(want.state.u_m), atol=1e-5)
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    np.testing.assert_allclose([h[2] for h in got.history],
                               [h[2] for h in want.history], atol=1e-6)
    assert got.scalars_sent == want.scalars_sent


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_reference_chunk_sim_matches_jax(problem, backend, nu_frac):
    """The unpacked reference across k = 5 clients (the Rule-3 loop for
    nu > 0) replays JAX's run_chunk_sim for either JAX backend."""
    xp, xm = problem
    n1, n2, d = xp.shape[0], xm.shape[0], xp.shape[1]
    nu = _nu(nu_frac, n1)
    params = jsaddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu)
    k, iters = 5, 60
    key = jax.random.key(11)
    idx = np.array(jax.vmap(lambda kk: jengine.sample_block(kk, d, 1))(
        jax.random.split(key, iters)), np.int32)
    xp_sh, mask_p = jdist.shard_points(xp, k)
    xm_sh, mask_m = jdist.shard_points(xm, k)
    want = jdist.init_sharded_state(n1, n2, d, mask_p, mask_m)
    want, want_obj = jdist.run_chunk_sim(
        want, key, jnp.asarray(xp_sh), jnp.asarray(xm_sh), iters,
        params=params, chunk_steps=iters, backend=backend)
    got = dist.init_sharded_state(n1, n2, d, mask_p, mask_m, device=CPU)
    got, obj = dist.run_chunk_sim(
        got, torch.from_numpy(xp_sh), torch.from_numpy(xm_sh), iters,
        params=saddle.SaddleParams(*params), idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=1e-5)
    _assert_weights_close(got.log_eta, want.log_eta, 1e-5)
    _assert_weights_close(got.log_xi, want.log_xi, 1e-5)
    np.testing.assert_allclose(got.u_p.numpy(), np.asarray(want.u_p),
                               atol=1e-5)
    np.testing.assert_allclose(obj.numpy(), np.asarray(want_obj),
                               rtol=1e-5)
    assert got.t.tolist() == [iters] * k


@pytest.mark.parametrize("nu_frac", [0.0, 0.8])
def test_packed_matches_reference_distributed(problem, nu_frac):
    """The packed client chunk against the unpacked reference one, k = 5
    with round-robin padding, on one schedule (the JAX test's 80 steps,
    1e-5)."""
    xp, xm = problem
    n1, n2, d = xp.shape[0], xm.shape[0], xp.shape[1]
    nu = _nu(nu_frac, n1)
    iters, k = 80, 5
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu)
    sched = _jax_schedule(0, d, 1, iters, iters)
    xp_sh, mask_p = dist.shard_points(xp, k)
    xm_sh, mask_m = dist.shard_points(xm, k)
    ref = dist.init_sharded_state(n1, n2, d, mask_p, mask_m, device=CPU)
    ref, _ = dist.run_chunk_sim(ref, torch.from_numpy(xp_sh),
                                torch.from_numpy(xm_sh), iters,
                                params=params,
                                idx=torch.from_numpy(sched))
    res = dist.solve_distributed(xp, xm, k=k, nu=nu, num_iters=iters,
                                 idx_schedule=sched, device=CPU)
    np.testing.assert_allclose(res.state.w.numpy(), ref.w.numpy(),
                               atol=1e-5)
    for a, b in [(res.state.log_eta, ref.log_eta),
                 (res.state.log_xi, ref.log_xi)]:
        np.testing.assert_allclose(np.exp(a.numpy()), np.exp(b.numpy()),
                                   atol=1e-5)
    np.testing.assert_allclose(res.state.u_p.numpy(), ref.u_p.numpy(),
                               atol=1e-5)


def test_dual_update_packed_clients_match_jax():
    """engine._dual_update_packed takes the packed MWU's (m, s) as (S, 2)
    and combines them across k = 3 clients with the client hooks (one
    (2,) max, one (2,) sum): against the JAX package's
    _dual_update_packed (its Pallas kernel in interpret mode) under vmap
    over the client axis.  Client 1 holds no point of class -, client 2
    none of class +: their (NEG, 0) must drop out of the merge."""
    rng = np.random.default_rng(5)
    k, n_pad, d, b = 3, 256, 16, 4
    sign = np.zeros((k, n_pad), np.float32)
    for c, (n1, n2) in enumerate([(40, 50), (128, 0), (0, 90)]):
        sign[c, :n1], sign[c, n1:n1 + n2] = 1.0, -1.0
    x_t = (rng.normal(size=(k, d, n_pad)) * (sign != 0)[:, None, :]).astype(
        np.float32)
    ll = np.where(sign != 0, rng.normal(size=(k, n_pad)) * 0.1 - 5.0,
                  engine.NEG_INF).astype(np.float32)
    u = (rng.normal(size=(k, n_pad)) * 0.1).astype(np.float32)
    idx = rng.choice(d, b, replace=False).astype(np.int32)
    dw = (rng.normal(size=b) * 0.01).astype(np.float32)
    params = jsaddle.make_params(300, d, 1e-3, 0.1, block_size=b)
    jsc = jengine.scalarize_params(params)

    def client(xt, lg, uu, sg):
        return jengine._dual_update_packed(
            xt, jnp.asarray(idx), xt[idx], lg, uu, jnp.asarray(dw), sg, jsc,
            d / b, jengine.CLIENT_AXIS, "pallas")

    want = jax.vmap(client, axis_name=jengine.CLIENT_AXIS)(
        x_t, ll, u, sign)
    sc = engine.stack_slot_params(
        [engine.slot_params_row(saddle.SaddleParams(*params))] * k, CPU)
    before = dict(engine.collective_counts)
    got = engine._dual_update_packed(
        torch.from_numpy(x_t), torch.from_numpy(np.tile(idx, (k, 1))),
        torch.from_numpy(ll), torch.from_numpy(u),
        torch.from_numpy(np.tile(dw, (k, 1))), torch.from_numpy(sign), sc,
        d / b, *engine.client_hooks(True))
    real = sign != 0
    np.testing.assert_allclose(got[0].numpy()[real],
                               np.asarray(want[0])[real], atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    # the weights of each class sum to 1 over all clients
    for cls in (1.0, -1.0):
        mass = np.exp(got[0].numpy().astype(np.float64))[sign == cls].sum()
        np.testing.assert_allclose(mass, 1.0, atol=1e-5)
    tally = collections.Counter(engine.collective_counts)
    tally.subtract(before)
    assert +tally == {("all-reduce", "max", 2): 1, ("all-reduce", "add", 2): 1}


def test_dsvc_step_matches_jax(problem):
    """One reference client step with the block the server broadcasts."""
    xp, xm = problem
    n1, n2, d = xp.shape[0], xm.shape[0], xp.shape[1]
    params = jsaddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=4)
    key = jax.random.key(2)
    idx = np.array(jengine.sample_block(key, d, 4), np.int32)
    xp_sh, mask_p = jdist.shard_points(xp, 3)
    xm_sh, mask_m = jdist.shard_points(xm, 3)
    want = jax.vmap(lambda st, a, b: jdist.dsvc_step(st, key, a, b, params),
                    axis_name=jengine.CLIENT_AXIS)(
        jdist.init_sharded_state(n1, n2, d, mask_p, mask_m),
        jnp.asarray(xp_sh), jnp.asarray(xm_sh))
    got = dist.dsvc_step(
        dist.init_sharded_state(n1, n2, d, mask_p, mask_m, device=CPU),
        torch.from_numpy(xp_sh), torch.from_numpy(xm_sh),
        saddle.SaddleParams(*params), idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=1e-6)
    np.testing.assert_allclose(got.u_m.numpy(), np.asarray(want.u_m),
                               atol=1e-6)
    _assert_weights_close(got.log_xi, want.log_xi, 1e-6)


# ------------------------------------------------ layout helpers
def test_shard_points_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(23, 4)).astype(np.float32)
    sh, mask = dist.shard_points(x, 5)
    assert sh.shape == (5, 5, 4) and mask.shape == (5, 5)
    assert mask.sum() == 23
    # shard c, slot j holds original index j*5 + c
    recovered = np.transpose(sh, (1, 0, 2)).reshape(-1, 4)[:23]
    np.testing.assert_allclose(recovered, x)
    rec_mask = np.transpose(mask, (1, 0)).reshape(-1)
    assert rec_mask[:23].all() and not rec_mask[23:].any()
    want_sh, want_mask = jdist.shard_points(x, 5)
    np.testing.assert_array_equal(sh, want_sh)
    np.testing.assert_array_equal(mask, want_mask)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_pack_shards_and_init_match_jax(problem, k):
    xp, xm = problem
    xp_sh, mask_p = dist.shard_points(xp, k)
    xm_sh, mask_m = dist.shard_points(xm, k)
    got = dist.pack_shards(xp_sh, mask_p, xm_sh, mask_m)
    want = jdist.pack_shards(xp_sh, mask_p, xm_sh, mask_m)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    st = dist.init_sharded_state(37, 53, 16, mask_p, mask_m, device=CPU)
    jst = jdist.init_sharded_state(37, 53, 16, mask_p, mask_m)
    for name, value in convert.to_numpy(st).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(jst, name)))


def test_gather_duals_rejects_wrong_k(problem):
    xp, xm = problem
    d5 = dist.solve_distributed(xp, xm, k=5, num_iters=10, device=CPU)
    with pytest.raises(ValueError):
        dist.gather_duals(d5.state, xp.shape[0], xm.shape[0], 4)


def test_convert_carries_sharded_states_with_client_axis(problem):
    """convert.to_port carries the JAX package's ShardedState (and a
    SaddleState) with the leading client axis; the port continues the
    JAX solve's state as the JAX package does."""
    xp, xm = problem
    jres = jdist.solve_distributed(xp, xm, k=3, num_iters=30)
    st = convert.to_port(dist.ShardedState, jres.state, CPU)
    assert st.w.shape == (3, 16) and st.t.shape == (3,)
    assert st.t.dtype == torch.int32
    for name, value in convert.to_numpy(st).items():
        np.testing.assert_array_equal(value,
                                      np.asarray(getattr(jres.state, name)))
    sst = convert.to_port(saddle.SaddleState, jres.state, CPU)
    assert sst.log_eta.shape == jres.state.log_eta.shape
    # one more reference step from the carried state agrees with JAX's
    params = jsaddle.make_params(90, 16, 1e-3, 0.1)
    key = jax.random.key(5)
    idx = np.array(jengine.sample_block(key, 16, 1), np.int32)
    xp_sh, _ = jdist.shard_points(xp, 3)
    xm_sh, _ = jdist.shard_points(xm, 3)
    want = jax.vmap(lambda s, a, b: jdist.dsvc_step(s, key, a, b, params),
                    axis_name=jengine.CLIENT_AXIS)(
        jres.state, jnp.asarray(xp_sh), jnp.asarray(xm_sh))
    got = dist.dsvc_step(st, torch.from_numpy(xp_sh),
                         torch.from_numpy(xm_sh),
                         saddle.SaddleParams(*params),
                         idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=1e-6)


def test_block_mode_u_invariant_distributed(problem):
    """u_p == xp_shard @ w per client after block steps: the rank-B
    update stays exact because blocks are sampled without replacement."""
    xp, xm = problem
    res = dist.solve_distributed(xp, xm, k=5, num_iters=200, block_size=4,
                                 device=CPU)
    xp_sh, _ = dist.shard_points(xp, 5)
    w = res.state.w[0].numpy()
    for c in range(5):
        np.testing.assert_allclose(res.state.u_p[c].numpy(), xp_sh[c] @ w,
                                   atol=2e-4)


def test_nu_caps_no_mass_leak_into_lane_padding_distributed(problem):
    """Round-robin padding points (sign 0) stay at NEG_INF exactly under
    the capped projection, each class sums to 1 over its real points, and
    no weight exceeds the cap."""
    xp, xm = problem
    n1, n2 = xp.shape[0], xm.shape[0]
    nu = 1.0 / (0.6 * n1)
    params = saddle.make_params(n1 + n2, xp.shape[1], 1e-3, 0.1, nu=nu)
    xp_sh, mask_p = dist.shard_points(xp, 3)
    xm_sh, mask_m = dist.shard_points(xm, 3)
    x_t, sign = (torch.from_numpy(a) for a in
                 dist.pack_shards(xp_sh, mask_p, xm_sh, mask_m))
    st = engine.init_packed_state(sign, n1, n2, xp.shape[1])
    st, obj = dist.run_chunk_sim_packed(
        st, x_t, sign, 150, params=params,
        generator=torch.Generator().manual_seed(3))
    lam = st.log_lam
    assert (lam[sign == 0] == engine.NEG_INF).all()
    assert abs(float(torch.exp(lam[sign > 0]).sum()) - 1.0) < 1e-4
    assert abs(float(torch.exp(lam[sign < 0]).sum()) - 1.0) < 1e-4
    assert float(torch.exp(lam[sign != 0]).max()) <= nu + 1e-5
    assert torch.equal(obj, obj[:1].expand(3))


# ------------------------------------------------ client drop
@pytest.mark.faults
@pytest.mark.dist
def test_drop_client_survivors_converge(problem):
    """Losing one client mid-solve: the dropped shard's dual mass goes to
    exactly zero, the survivors' mass is renormalized to 1 by the next
    normalizer round, and the k-1 solve converges on the survivor
    problem (the round-robin complement of the dropped shard) as well as
    a survivor-only serial solve of the same budget."""
    xp, xm = problem
    n1, n2 = xp.shape[0], xm.shape[0]
    k, c, iters = 5, 2, 4800
    res = dist.solve_distributed(xp, xm, k=k, num_iters=iters,
                                 record_every=800,
                                 drop_client=(c, iters // 3), device=CPU)
    assert [h[0] for h in res.history] == [800, 1600, 2400, 3200, 4000,
                                           4800]
    eta, xi = dist.gather_duals(res.state, n1, n2, k)
    drop_p = np.arange(n1) % k == c
    drop_m = np.arange(n2) % k == c
    assert eta[drop_p].sum() == 0.0 and xi[drop_m].sum() == 0.0
    np.testing.assert_allclose(eta[~drop_p].sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(xi[~drop_m].sum(), 1.0, rtol=1e-5)
    pts = pp.pack_points(torch.from_numpy(xp[~drop_p]),
                         torch.from_numpy(xm[~drop_m]))

    def rel_gap(w, lam):
        log_lam = torch.full((1, pts.n_pad), engine.NEG_INF)
        log_lam[0, :lam.shape[0]] = torch.log(
            torch.clamp(torch.as_tensor(lam, dtype=torch.float32),
                        min=1e-30))
        obj = float(engine.objective_from_duals(log_lam, pts.x_t[None],
                                                pts.sign[None])[0])
        gap = float(engine.saddle_gap_packed(
            torch.as_tensor(w)[None], pts.x_t[None], pts.sign[None],
            torch.ones(1))[0])
        return (obj - gap) / max(obj, 1e-12)

    r_drop = rel_gap(res.state.w[(c + 1) % k].numpy(),
                     np.concatenate([eta[~drop_p], xi[~drop_m]]))
    assert r_drop <= 0.25
    ser = saddle.solve(xp[~drop_p], xm[~drop_m], num_iters=iters,
                       device=CPU)
    lam_ser = np.concatenate([np.exp(ser.state.log_eta.numpy()),
                              np.exp(ser.state.log_xi.numpy())])
    r_ser = rel_gap(ser.state.w.numpy(), lam_ser)
    assert r_drop <= 1.5 * r_ser


def test_drop_client_matches_jax(problem):
    """The drop path replays JAX's on JAX's schedule (the drop adds one
    chunk boundary, so the schedule is drawn with it)."""
    xp, xm = problem
    kw = dict(k=4, num_iters=90, record_every=40, drop_client=(1, 30))
    want = jdist.solve_distributed(xp, xm, **kw)
    d = xp.shape[1]
    # chunk boundaries: 30 (drop), 70, 90 -- one key per chunk of 40
    key = jax.random.key(0)
    sched = []
    for ns in (30, 40, 20):
        key, sub = jax.random.split(key)
        sched.append(np.asarray(jax.vmap(
            lambda kk: jengine.sample_block(kk, d, 1))(
                jax.random.split(sub, 40)))[:ns])
    got = dist.solve_distributed(xp, xm, device=CPU, **kw,
                                 idx_schedule=np.concatenate(sched))
    np.testing.assert_allclose(got.state.w.numpy(), np.asarray(want.state.w),
                               atol=1e-5)
    _assert_weights_close(got.state.log_xi, want.state.log_xi, 1e-5)
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    np.testing.assert_allclose([h[2] for h in got.history],
                               [h[2] for h in want.history], atol=1e-6)


def test_drop_client_rejects_mesh_mode(problem):
    xp, xm = problem
    with pytest.raises(ValueError, match="simulation-only"):
        dist.solve_distributed(xp, xm, k=2, num_iters=10, device=CPU,
                               mesh="not-none", drop_client=(0, 5))


def test_mesh_mode_is_not_ported(problem):
    xp, xm = problem
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dist.solve_distributed(xp, xm, k=2, num_iters=10, device=CPU,
                               mesh="not-none")


# ------------------------------------------------ communication
@pytest.mark.parametrize("k", [1, 5, 20, 64])
@pytest.mark.parametrize("nu_rounds", [
    0.0, 2.0, float(projections.BISECT_ROUNDS_SOLVER)])
def test_comm_model_matches_jax(k, nu_rounds):
    got = dist.CommModel(k=k, nu_rounds_per_iter=nu_rounds)
    want = jdist.CommModel(k=k, nu_rounds_per_iter=nu_rounds)
    assert got.scalars_per_iteration() == want.scalars_per_iteration()
    assert got.total(37) == want.total(37)
    for b in (1, 4, 128):
        assert got.collective_multiset(b) == want.collective_multiset(b)
        assert (got.collectives_per_iteration(b)
                == want.collectives_per_iteration(b))
        assert (got.payload_elements_per_iteration(b)
                == want.payload_elements_per_iteration(b))


def test_comm_model_matches_theorem8():
    """O(k) scalars per iteration, independent of n and d."""
    c10 = dist.CommModel(k=10, nu_rounds_per_iter=0)
    c20 = dist.CommModel(k=20, nu_rounds_per_iter=0)
    assert c20.scalars_per_iteration() == 2 * c10.scalars_per_iteration()
    cn = dist.CommModel(k=10, nu_rounds_per_iter=2)
    assert cn.scalars_per_iteration() > c10.scalars_per_iteration()
    assert c10.total(100) == 100 * c10.scalars_per_iteration()


@pytest.mark.parametrize("nu_frac,block_size,want", [(0.0, 1, 3),
                                                     (0.8, 1, 29),
                                                     (0.0, 4, 3),
                                                     (0.8, 4, 29)])
def test_tallied_collectives_equal_the_model(problem, nu_frac, block_size,
                                             want):
    """The client hooks called in a distributed solve, per iteration, are
    CommModel's collectives -- 3 for HM, 29 for nu -- with the same
    multiset of payload sizes; the chunk boundary adds one (d,) sum for
    the objective.  The port's counterpart of
    test_comm_audit.py::test_measured_equals_model."""
    xp, xm = problem
    nu = _nu(nu_frac, xp.shape[0])
    before = engine.collective_counts.copy()
    res = dist.solve_distributed(xp, xm, k=5, nu=nu, num_iters=12,
                                 record_every=5, block_size=block_size,
                                 device=CPU)
    counts = engine.collective_counts - before
    steps, chunks = 12 // block_size, len(res.history)
    ms = res.comm.collective_multiset(block_size)
    assert res.comm.collectives_per_iteration(block_size) == want
    expect = {key: n * steps for key, n in ms.items()}
    obj_key = ("all-reduce", "add", xp.shape[1])
    expect[obj_key] = expect.get(obj_key, 0) + chunks
    assert dict(counts) == expect


def test_serial_solve_tallies_no_collectives(problem):
    xp, xm = problem
    before = engine.collective_counts.copy()
    saddle.solve(xp, xm, nu=_nu(0.8, 37), num_iters=5, device=CPU)
    assert engine.collective_counts == before
