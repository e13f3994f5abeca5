"""Algorithm 4 over real ``torch.distributed`` collectives on the CPU:
``solve_distributed(mesh=ClientGroup)`` with one client a gloo process, and
the serving chunk's two placements over a group, held against the port's
simulation, its serial solve and the JAX package.

One module-scoped spawn of 8 gloo ranks runs every case at once
(``_torch_collective_workers.runner_cases``): k = 8 on the data of
tests/test_distributed.py::test_shard_map_runner_multidevice, k = 4 on
ranks 0-3 and k = 1 on rank 0.  Every spawn has a gloo and a join
timeout, so a hang fails a test instead of the suite.  Bit-equality with
the simulation is not promised at k > 1: gloo's ring sums the clients'
partials in another order than the simulation's sum over a client axis.
"""

import multiprocessing
import time

import jax
import numpy as np
import pytest
import torch

import _torch_collective_workers as workers
from _torch_launch_workers import one_thread  # noqa: F401
from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.core import preprocess as jpp
from repro.core import saddle as jsaddle
from repro_torch.core import distributed as dist
from repro_torch.core import engine, saddle
from repro_torch.launch import mesh as meshlib

pytestmark = [pytest.mark.dist, pytest.mark.usefixtures("one_thread")]

CPU = "cpu"
SPAWN_TIMEOUT_S = 240
HM = dict(num_iters=400, record_every=100)
NU_FRAC = 0.8


def _jax_schedule(seed, d, b, num_iters, chunk):
    """The coordinate blocks of a JAX solve at ``seed`` whose chunks are
    ``chunk`` steps (see tests/test_torch_distributed.py)."""
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
def problem():
    """37 + 53 points in d = 16, preprocessed by the JAX package (the
    data of tests/test_torch_distributed.py)."""
    rng = np.random.default_rng(0)
    xp = rng.normal(size=(37, 16)).astype(np.float32) * 0.3 + 0.4
    xm = rng.normal(size=(53, 16)).astype(np.float32) * 0.3 - 0.4
    pre = jpp.preprocess(xp, xm, jax.random.key(1))
    return np.array(pre.xp), np.array(pre.xm)


@pytest.fixture(scope="module")
def jax_k8():
    """tests/test_distributed.py::test_shard_map_runner_multidevice's data
    and JAX's serial and simulated k = 8 solves of 200 iterations."""
    rng = np.random.default_rng(0)
    xp = rng.normal(size=(32, 8)).astype(np.float32) * 0.3 + 0.4
    xm = rng.normal(size=(40, 8)).astype(np.float32) * 0.3 - 0.4
    pre = jpp.preprocess(xp, xm, jax.random.key(1))
    xp, xm = np.array(pre.xp), np.array(pre.xm)
    ser = jsaddle.solve(xp, xm, num_iters=200)
    sim = jdist.solve_distributed(xp, xm, k=8, num_iters=200)
    return dict(xp=xp, xm=xm, sched=_jax_schedule(0, 8, 1, 200, 200),
                w_serial=np.asarray(ser.state.w),
                w_sim=np.asarray(sim.state.w))


def _nu(n1):
    return 1.0 / (NU_FRAC * n1)


def serve_problems():
    """8 lanes of 300-480 points in d = 16 (a 512-point bucket, 128
    points a rank at k = 4), classes apart by 0.8."""
    out = []
    for lane in range(8):
        rng = np.random.default_rng(100 + lane)
        n1, n2 = 150 + 10 * lane, 150 + 20 * lane
        out.append(((rng.normal(size=(n1, 16)) * 0.3 + 0.4)
                    .astype(np.float32) / 4,
                    (rng.normal(size=(n2, 16)) * 0.3 - 0.4)
                    .astype(np.float32) / 4))
    return out


SERVE = dict(problems=serve_problems(), n_pad=512, d=16, block_size=2,
             chunk_steps=16, chunks=2, nu=1.0 / (0.8 * 150), drop=(3, 1))


@pytest.fixture(scope="module")
def ranks(problem, jax_k8):
    """The 8 ranks' results of every case (one spawn)."""
    cases = dict(
        jax=(jax_k8["xp"], jax_k8["xm"], jax_k8["sched"]),
        problem=problem,
        k4=dict(hm=HM, nu=dict(nu=_nu(37), num_iters=300,
                                record_every=100)),
        k1=dict(k1_hm=dict(num_iters=120, record_every=50),
                k1_nu=dict(nu=_nu(37), num_iters=120, record_every=50)),
        serve=SERVE)
    return meshlib.spawn_clients(workers.runner_cases, 8, backend="gloo",
                                 device=CPU, timeout_s=SPAWN_TIMEOUT_S,
                                 args=(cases,))


def _w_rows(res):
    return res["state"]["w"]


# ------------------------------------------------ the runner at k = 4
@pytest.mark.parametrize("label", ["hm", "nu"])
def test_runner_matches_simulation_and_serial(problem, ranks, label):
    """Every rank's w within 1e-5 of the simulation (``run_chunk_sim_packed``
    on the same draws) and within 1e-4 of the serial solve; every rank
    ends with the same gathered (k, ...) state."""
    xp, xm = problem
    kw = HM if label == "hm" else dict(nu=_nu(37), num_iters=300,
                                        record_every=100)
    sim = dist.solve_distributed(xp, xm, k=4, device=CPU, **kw)
    ser = saddle.solve(xp, xm, device=CPU, **kw)
    got = [r[label] for r in ranks[:4]]
    for r in got:
        np.testing.assert_array_equal(_w_rows(r), _w_rows(got[0]))
    w = _w_rows(got[0])
    np.testing.assert_allclose(w, sim.state.w.numpy(), atol=1e-5)
    for row in w:
        np.testing.assert_allclose(row, ser.state.w.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.exp(got[0]["state"]["log_eta"]),
                               np.exp(sim.state.log_eta.numpy()), atol=1e-5)
    np.testing.assert_allclose(np.exp(got[0]["state"]["log_xi"]),
                               np.exp(sim.state.log_xi.numpy()), atol=1e-5)
    assert [h[:2] for h in got[0]["history"]] == \
        [h[:2] for h in sim.history]
    np.testing.assert_allclose([h[2] for h in got[0]["history"]],
                               [h[2] for h in sim.history], rtol=1e-5)


@pytest.mark.parametrize("label,want", [("hm", 3), ("nu", 29)])
def test_runner_tally_is_the_model(problem, ranks, label, want):
    """Each rank's hooks issued CommModel's all-reduces every step (3 for
    hard margin, 29 for nu) and one (d,) objective sum a chunk."""
    xp, xm = problem
    model = dist.CommModel(k=4, nu_rounds_per_iter=24.0 if label == "nu"
                           else 0.0)
    assert model.collectives_per_iteration() == want
    steps, chunks = (400, 4) if label == "hm" else (300, 3)
    expect = {key: n * steps for key, n in model.collective_multiset().items()}
    key = ("all-reduce", "add", xp.shape[1])
    expect[key] = expect.get(key, 0) + chunks
    for r in ranks[:4]:
        assert r[label]["tally"] == expect


def test_runner_rejects_k_other_than_group_size(ranks):
    for r in ranks[:4]:
        assert "k=3 clients on a group of 4 ranks" in r["k_mismatch"]


def test_drop_client_rejects_mesh_mode(problem):
    xp, xm = problem
    group = meshlib.ClientGroup(None, 0, 2, torch.device(CPU))
    with pytest.raises(ValueError, match="simulation-only"):
        dist.solve_distributed(xp, xm, k=2, num_iters=10, device=CPU,
                               mesh=group, drop_client=(0, 5))


# ------------------------------------------------ k = 1 and k = 8
@pytest.mark.parametrize("label", ["k1_hm", "k1_nu"])
def test_runner_k1_equals_serial_bit_for_bit(problem, ranks, label):
    xp, xm = problem
    nu = _nu(37) if label == "k1_nu" else 0.0
    ser = saddle.solve(xp, xm, nu=nu, num_iters=120, record_every=50,
                       device=CPU)
    got = ranks[0][label]
    np.testing.assert_array_equal(got["state"]["w"][0], ser.state.w.numpy())
    np.testing.assert_array_equal(got["state"]["log_eta"][0],
                                  ser.state.log_eta.numpy())
    np.testing.assert_array_equal(got["state"]["u_m"][0],
                                  ser.state.u_m.numpy())
    assert [(m, o) for m, _, o in got["history"]] == ser.history
    assert all(label not in r for r in ranks[1:])


def test_runner_k8_matches_jax(jax_k8, ranks):
    """The port's k = 8 runner on JAX's block schedule: every rank's w
    within 1e-4 of JAX's serial solve and of its simulated k = 8 solve
    (tests/test_distributed.py::test_shard_map_runner_multidevice)."""
    for r in ranks:
        w = _w_rows(r["jax_k8"])
        assert w.shape == (8, 8)
        for row in w:
            np.testing.assert_allclose(row, jax_k8["w_serial"], atol=1e-4)
        np.testing.assert_allclose(w, jax_k8["w_sim"], atol=1e-4)


# ------------------------------------------------ serving placements
def _points(ranks, label, which):
    """The whole batch from the 4 ranks' point shards."""
    parts = [r["serve"][label, which] for r in ranks[:4]]
    for p in parts[1:]:
        for f in ("w", "t", "active", "obj", "healthy"):
            np.testing.assert_array_equal(p[f], parts[0][f])
    return dict(parts[0], log_lam=np.concatenate([p["log_lam"] for p in parts],
                                                 axis=1),
                u=np.concatenate([p["u"] for p in parts], axis=1))


@pytest.mark.parametrize("label", ["hm", "nu"])
def test_points_placement_matches_unsharded_chunk(ranks, label):
    whole = ranks[0]["serve"][label, "whole"]
    got = _points(ranks, label, "points")
    np.testing.assert_allclose(got["w"], whole["w"], atol=1e-5)
    np.testing.assert_allclose(np.exp(got["log_lam"]),
                               np.exp(whole["log_lam"]), atol=1e-5)
    np.testing.assert_allclose(got["u"], whole["u"], atol=1e-5)
    np.testing.assert_allclose(got["obj"], whole["obj"], rtol=1e-5)
    np.testing.assert_array_equal(got["t"], whole["t"])
    assert got["healthy"].all() and got["active"].all()


@pytest.mark.parametrize("label", ["hm", "nu"])
def test_lanes_placement_equals_unsharded_chunk_bit_for_bit(ranks, label):
    whole = ranks[0]["serve"][label, "whole"]
    parts = [r["serve"][label, "lanes"] for r in ranks[:4]]
    for f in ("w", "log_lam", "u", "t", "active", "healthy"):
        np.testing.assert_array_equal(np.concatenate([p[f] for p in parts]),
                                      whole[f])
    np.testing.assert_array_equal(
        np.concatenate([p["obj"] for p in parts], axis=1), whole["obj"])
    assert all(r["serve"][label, "lanes_tally"] == {} for r in ranks[:4])


@pytest.mark.parametrize("label", ["hm", "nu"])
def test_points_tally_is_serve_comm_model(ranks, label):
    s, b, d = 8, SERVE["block_size"], SERVE["d"]
    model = dist.ServeCommModel(k=4, num_slots=s, nu_rounds_per_iter=(
        24.0 if label == "nu" else 0.0))
    steps = SERVE["chunks"] * SERVE["chunk_steps"]
    expect = {key: n * steps
              for key, n in model.collective_multiset(b).items()}
    for key, n in model.per_chunk_multiset(d).items():
        expect[key] = expect.get(key, 0) + n * SERVE["chunks"]
    for r in ranks[:4]:
        assert r["serve"][label, "points_tally"] == expect


@pytest.mark.parametrize("label", ["hm", "nu"])
def test_drop_slot_shard_leaves_batch_mates_bit_equal(ranks, label):
    """A shard of lane 3 dropped before the point-sharded chunks: every
    other lane's w, duals, u and objective are those of the run without
    the drop, bit for bit; lane 3 goes on over its surviving points."""
    full = _points(ranks, label, "points")
    drop = _points(ranks, label, "dropped")
    lane, shard = SERVE["drop"]
    mates = [i for i in range(8) if i != lane]
    for f in ("w", "log_lam", "u"):
        np.testing.assert_array_equal(drop[f][mates], full[f][mates])
    np.testing.assert_array_equal(drop["obj"][:, mates],
                                  full["obj"][:, mates])
    m = SERVE["n_pad"] // 4
    assert (np.exp(drop["log_lam"][lane, shard * m:(shard + 1) * m])
            == 0.0).all()
    assert np.isfinite(drop["w"][lane]).all()
    assert not np.array_equal(drop["w"][lane], full["w"][lane])


def test_drop_slot_shard_matches_jax():
    rng = np.random.default_rng(3)
    s, n_pad, d = 4, 512, 8
    ll = rng.normal(size=(s, n_pad)).astype(np.float32)
    prev = rng.normal(size=(s, n_pad)).astype(np.float32)
    u = rng.normal(size=(s, n_pad)).astype(np.float32)
    sign = np.sign(rng.normal(size=(s, n_pad))).astype(np.float32)
    w = rng.normal(size=(s, d)).astype(np.float32)
    t = np.arange(s, dtype=np.int32)
    jstate = jengine.SlotState(
        w=jax.numpy.asarray(w), log_lam=jax.numpy.asarray(ll),
        log_lam_prev=jax.numpy.asarray(prev), u=jax.numpy.asarray(u),
        t=jax.numpy.asarray(t), max_t=jax.numpy.asarray(t + 10),
        key=jax.random.split(jax.random.key(0), s),
        active=jax.numpy.ones(s, bool))
    jst, jsign = jdist.drop_slot_shard(jstate, jax.numpy.asarray(sign), 2, 1,
                                       num_shards=4)
    state = engine.init_slot_state(s, n_pad, d, torch.device(CPU))._replace(
        w=torch.as_tensor(w), log_lam=torch.as_tensor(ll),
        log_lam_prev=torch.as_tensor(prev), u=torch.as_tensor(u))
    got, gsign = dist.drop_slot_shard(state, torch.as_tensor(sign), 2, 1,
                                      num_shards=4)
    np.testing.assert_array_equal(gsign.numpy(), np.asarray(jsign))
    for f in ("w", "log_lam", "log_lam_prev", "u"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    mates = [0, 1, 3]
    np.testing.assert_array_equal(got.log_lam.numpy()[mates], ll[mates])
    np.testing.assert_array_equal(got.u.numpy()[mates], u[mates])


def test_check_gap_under_a_group_raises():
    batch = workers._serve_batch(SERVE["problems"][:2], 512, 16, 0.0, 1)
    with pytest.raises(ValueError, match="check_gap"):
        engine.chunk_body_slots(*batch, 4, chunk_steps=4, d=16, block_size=1,
                                project=False, check_gap=True,
                                group=object())


def test_point_shards_must_be_multiples_of_128():
    batch = workers._serve_batch(SERVE["problems"][:2], 512, 16, 0.0, 1)
    group = meshlib.ClientGroup(None, 0, 8, torch.device(CPU))
    with pytest.raises(ValueError, match="multiple of 128"):
        engine.shard_slot_batch(group, "points", *batch)
    with pytest.raises(ValueError, match="k | num_slots"):
        engine.shard_slot_batch(group._replace(size=3), "lanes", *batch)
    with pytest.raises(ValueError, match="placement"):
        engine.shard_slot_batch(group, "rows", *batch)


# ------------------------------------------------ ServeCommModel
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("num_slots", [1, 4])
@pytest.mark.parametrize("block_size", [1, 4, 128])
def test_serve_comm_model_matches_jax(k, num_slots, block_size):
    for rounds in (0.0, 24.0):
        got = dist.ServeCommModel(k=k, num_slots=num_slots,
                                  nu_rounds_per_iter=rounds)
        want = jdist.ServeCommModel(k=k, num_slots=num_slots,
                                    nu_rounds_per_iter=rounds)
        assert got.collective_multiset(block_size) == \
            want.collective_multiset(block_size)
        assert got.per_chunk_multiset(16) == want.per_chunk_multiset(16)
        assert got.collectives_per_iteration(block_size) == \
            want.collectives_per_iteration(block_size)
        assert got.payload_elements_per_iteration(block_size) == \
            want.payload_elements_per_iteration(block_size)


# ------------------------------------------------ spawn_clients itself
def test_spawn_reraises_a_child_failure_and_stops_the_rest():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure on rank 0"):
        meshlib.spawn_clients(workers.fail_or_hang, 2, backend="gloo",
                              device=CPU, timeout_s=120)
    assert time.monotonic() - t0 < 100
    assert not multiprocessing.active_children()


def test_spawn_timeout_kills_every_child():
    with pytest.raises(TimeoutError, match="killed"):
        meshlib.spawn_clients(workers.hang, 1, backend="gloo", device=CPU,
                              timeout_s=5)
    assert not multiprocessing.active_children()


def test_refused_backends_raise():
    kw = dict(init_method="file:///nonexistent", rank=0, world_size=1)
    with pytest.raises(ValueError, match="nccl backend needs"):
        meshlib.init_client_group(backend="nccl", device=CPU, **kw)
    with pytest.raises(ValueError, match="backend must be"):
        meshlib.init_client_group(backend="mpi", device=CPU, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.init_client_group(backend="gloo", device="cuda", **kw)
