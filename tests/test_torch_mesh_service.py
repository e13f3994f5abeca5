"""The port's fit service over a process group (``SolverService(mesh=
ClientGroup)``, one process a rank, rank 0 the front end) on the CPU, held
to the JAX service's documented contract (tests/test_mesh_service.py), to
the port's meshless service and to the solo solves of both packages.

The JAX mesh service cannot be replayed here: under JAX 0.9 its lanes
placement raises a ``ShardingTypeError`` at admission (``x_t_b.at[slot]
.set(...)`` into a slot-sharded buffer), so its tests' assertions are the
contract, not its output.  One module-scoped spawn of 4 gloo ranks runs
every case (``_torch_collective_workers.mesh_service_cases``): a one-rank
group on rank 0, two ranks 0-1, four the whole group.  Tolerances: a
group of one rank and the lanes placement at k = 2 and 4 are bit-equal to
the meshless service (every lane steps alone); the points placement is
held within 1e-4 of a solo solve at its bucket, as the JAX test holds it
(gloo's sums associate otherwise than a solve's)."""

import jax
import numpy as np
import pytest
import torch

import _torch_collective_workers as workers
from repro.core import engine as jengine
from repro.core import preprocess as jpp
from repro.core import saddle as jsaddle
from repro.core.svm import recover_hyperplane as jrecover
from repro.core.svm import split_classes as jsplit
from repro_torch.core import engine
from repro_torch.core import preprocess as pp
from repro_torch.core import saddle
from repro_torch.core.svm import (_preprocess_seed, recover_hyperplane,
                                  split_classes)
from repro_torch.data import synthetic
from repro_torch.launch import mesh as meshlib
from repro_torch.serve.scheduler import RequestFailure, Status
from repro_torch.serve.solver_service import FitRequest, SolverService
from repro_torch.utils import comm_audit

pytestmark = [pytest.mark.serve, pytest.mark.dist]

C = workers.C
CPU = "cpu"
SPAWN_TIMEOUT_S = 240
NU_BIG = 1.0 / (0.8 * 300)
BUCKET_BIG = (1024, 16)      # 4 * bucket_length(ceil(580 / 4)) = 4 * 256


def _xy(ds):
    return (np.asarray(ds.x), np.asarray(ds.y))


def _jax_schedule(seed, d, b, num_iters, chunk):
    """The coordinate blocks of a JAX solve (or service lane) at ``seed``
    whose chunks are ``chunk`` steps (tests/test_torch_serve.py)."""
    key = jax.random.key(seed)
    out, done = [], 0
    draw = jax.jit(jax.vmap(lambda k: jengine.sample_block(k, d, b)))
    while done < num_iters:
        key, chunk_key = jax.random.split(key)
        out.append(np.asarray(draw(jax.random.split(chunk_key, chunk))))
        done += chunk
    return np.concatenate(out)[:num_iters].astype(np.int32)


def _jax_signs(seed, d_pad):
    k_pre, _ = jax.random.split(jax.random.key(seed))
    return np.asarray(jax.random.rademacher(k_pre, (d_pad,),
                                            dtype=np.float32))


@pytest.fixture(scope="module")
def data():
    ds1 = synthetic.blobs(40, 50, 16, gap=1.2, spread=0.15, seed=0)
    ds2 = synthetic.blobs(35, 45, 16, gap=0.8, spread=0.3, seed=2)
    big = synthetic.blobs(300, 280, 16, gap=1.0, spread=0.25, seed=5)
    extra = synthetic.blobs(3, 3, 16, gap=1.2, spread=0.15, seed=9)
    rng = np.random.default_rng(7)
    return dict(ds1=_xy(ds1), ds2=_xy(ds2), big=_xy(big), extra=_xy(extra),
                nu_big=NU_BIG, jax_signs=_jax_signs(5, 16),
                jax_schedule=_jax_schedule(5, 16, 1, 3 * C, C),
                signs=np.where(rng.random(16) < 0.5, -1.0, 1.0)
                .astype(np.float32),
                schedule=rng.integers(0, 16, size=(2 * C, 1))
                .astype(np.int32))


@pytest.fixture(scope="module")
def ranks(data):
    return meshlib.spawn_clients(workers.mesh_service_cases, 4,
                                 backend="gloo", device=CPU,
                                 timeout_s=SPAWN_TIMEOUT_S, args=(data,))


def _records(ranks):
    """Every (rank, label, record) of a service run."""
    return [(r["rank"], label, rec) for r in ranks for label, rec in r.items()
            if isinstance(rec, dict) and "held" in rec]


def _assert_bitexact(a, b):
    """tests/test_mesh_service.py's equality of two FitResults."""
    assert np.array_equal(np.asarray(a.w), np.asarray(b.w))
    assert float(a.b) == float(b.b)
    assert float(a.objective) == float(b.objective)
    assert a.iterations == b.iterations
    assert a.bucket == b.bucket
    assert np.array_equal(np.asarray(a.history, dtype=np.float64),
                          np.asarray(b.history, dtype=np.float64))


# ------------------------------------------------ bit-equal placements
@pytest.mark.parametrize("nu_frac", [0.0, 0.85])
def test_one_rank_group_bit_equal_to_meshless(ranks, nu_frac):
    """test_one_device_mesh_bitexact's contract: a one-rank group's
    service is the meshless service, bit for bit."""
    plain = ranks[0]["k1 plain", nu_frac]
    mesh = ranks[0]["k1 lanes", nu_frac]["res"]
    for a, b in zip(plain, mesh):
        _assert_bitexact(a, b)


def test_point_sharded_one_rank_bit_equal_to_meshless(ranks):
    """test_point_sharded_k1_bitexact's: shard_points_above=0 sends every
    request to a point-sharded group, whose bucket at k = 1 is the plain
    one and whose all-reduces over one rank change no bit."""
    plain = ranks[0]["k1 plain points"]
    rec = ranks[0]["k1 points"]
    for a, b in zip(plain, rec["res"]):
        _assert_bitexact(a, b)
    assert all(key[-2:] == ("points", 1) for key in rec["stats"]["keys"])


@pytest.mark.parametrize("label", ["lanes k2", "points k4", "base"])
def test_lanes_bit_equal_to_meshless(ranks, label):
    """The lanes placement over 2 and 4 ranks (whole lanes a rank; the
    kernels and the chunk work lane by lane) equals the meshless service
    bit for bit, also beside a point-sharded group."""
    got = ranks[0][label]["res"]
    for a, b in zip(ranks[0]["plain"], got[:2]):
        _assert_bitexact(a, b)


def test_lifecycle_over_two_ranks_matches_meshless(ranks):
    """Every lifecycle path over ranks 0-1 -- a stream and its warm append,
    a poisoned request retried, a deadline shed, a running request
    cancelled, a gap stop, a replayed schedule -- equals the meshless
    service's run of the same script bit for bit; the point-sharded
    stream (400 points, then 580: a rung jump) within 1e-4 of the
    meshless one, whose buckets are the same."""
    plain_first, plain_state, plain_second = ranks[0]["plain life"]
    first, state, second = ranks[0]["life k2"]["res"]
    assert state == plain_state == Status.RUNNING.value
    statuses = [r.status if isinstance(r, RequestFailure) else Status.DONE
                for r in first]
    assert statuses == [Status.DONE, Status.DONE, Status.CANCELLED,
                        Status.DONE, Status.DONE, Status.DONE,
                        Status.DEADLINE_EXCEEDED]
    assert first[3].iterations < 20 * C                 # the gap stop
    for i, (a, b) in enumerate(zip(plain_first, first)):
        if isinstance(a, RequestFailure):
            assert a == b
        elif i == 5:
            np.testing.assert_allclose(b.w, a.w, atol=1e-4)
            assert b.bucket == a.bucket == (512, 16)
        else:
            _assert_bitexact(a, b)
    _assert_bitexact(plain_second[0], second[0])
    np.testing.assert_allclose(second[1].w, plain_second[1].w, atol=1e-4)
    np.testing.assert_allclose(second[1].b, plain_second[1].b, atol=1e-4)
    assert second[1].bucket == plain_second[1].bucket == (1024, 16)
    keys = ranks[1]["life k2"]["stats"]["keys"]
    assert {k[-2:] == ("points", 2) for k in keys} == {False, True}


# ------------------------------------------------ points vs solo solves
def _port_solo(data, seed, nu, num_iters):
    xp, xm = split_classes(*data["big"])
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(
        _preprocess_seed(seed)), device=CPU)
    res = saddle.solve(pre.xp, pre.xm, nu=nu, num_iters=num_iters,
                       record_every=C, seed=seed, n_pad=BUCKET_BIG[0],
                       d_pad=BUCKET_BIG[1], device=CPU)
    st = res.state
    return recover_hyperplane(pre, torch.exp(st.log_eta),
                              torch.exp(st.log_xi), pre.xp, pre.xm)[:2]


def test_points_k4_matches_solo_solve(data, ranks):
    """test_mesh_service_multidevice_parity's: the 580-point fit in a
    point-sharded group of 4 ranks (its last shard, points 768-1,023, all
    padding) within 1e-4 of the port's solo solve at the same bucket."""
    res = ranks[0]["points k4"]["res"][2]
    assert res.bucket == BUCKET_BIG
    assert res.iterations == 3 * C
    w, b = _port_solo(data, 5, NU_BIG, 3 * C)
    np.testing.assert_allclose(res.w, w, atol=1e-4)
    np.testing.assert_allclose(res.b, b, atol=1e-4)


def test_points_k4_replays_jax_solo_solve(data, ranks):
    """The same fit fed JAX's signs and draws (the other lane of its
    group): within 1e-4 of the JAX package's solo saddle.solve at the
    bucket (w and b)."""
    res = ranks[0]["points k4"]["res"][3]
    xp, xm = jsplit(*data["big"])
    k_pre, _ = jax.random.split(jax.random.key(5))
    pre = jpp.preprocess(xp, xm, k_pre)
    ser = jsaddle.solve(pre.xp, pre.xm, nu=NU_BIG, num_iters=3 * C,
                        record_every=C, seed=5, n_pad=BUCKET_BIG[0],
                        d_pad=BUCKET_BIG[1])
    w, b, *_ = jrecover(pre, np.exp(np.asarray(ser.state.log_eta)),
                        np.exp(np.asarray(ser.state.log_xi)), pre.xp,
                        pre.xm)
    assert res.bucket == BUCKET_BIG
    np.testing.assert_allclose(res.w, np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(res.b, float(b), atol=1e-4)


# ------------------------------------------------ fault isolation
def test_poisoned_sharded_request_fails_and_batch_mates_stay(ranks):
    """test_sharded_slot_fault_paths' poison: the point-sharded request
    (rid 2) poisoned at its chunk 1 with max_retries=0 ends FAILED; the
    lane-placed batch-mates are bit-equal to a run without it."""
    base = ranks[0]["base"]["res"]
    res = ranks[0]["poison"]["res"]
    assert isinstance(res[2], RequestFailure)
    assert res[2].status is Status.FAILED
    assert "non-finite" in res[2].reason
    for a, b in zip(base, res[:2]):
        _assert_bitexact(a, b)


def test_cancelled_sharded_request_and_batch_mates_stay(ranks):
    """...and its cancel: cancelled once it runs, it ends CANCELLED; the
    batch-mates are bit-equal to the run without it."""
    res, status = ranks[0]["cancel"]["res"]
    assert status == Status.RUNNING.value
    assert isinstance(res[2], RequestFailure)
    assert res[2].status is Status.CANCELLED
    assert "running" in res[2].reason
    for a, b in zip(ranks[0]["base"]["res"], res[:2]):
        _assert_bitexact(a, b)


# ------------------------------------------------ collectives, set-ups
@pytest.mark.parametrize("label", ["lanes k4 audit",
                                   "points k4 short audit"])
def test_profiled_all_reduces_are_the_model(ranks, label):
    """By torch.profiler on every rank: a lane-placed chunk issues no
    all-reduce, a point-sharded one exactly ServeCommModel's; the
    service's other backend calls (plan broadcasts, admission data,
    harvest gathers) are the ones its helpers tallied."""
    for r in ranks:
        rec = r[label]
        assert rec["match"] and rec["hooks_agree"], rec
        assert rec["service_match"] and rec["service_calls"], rec
        if label.startswith("lanes"):
            assert rec["measured"] == rec["predicted"] == {}
        else:
            assert rec["measured"] == rec["predicted"] != {}
    calls = ranks[1][label]["service_calls"]
    assert set(calls) <= {"broadcast", "recv", "send"}


def test_tallied_all_reduces_are_the_model(ranks):
    """By the hooks' tally of every run on every rank: none for the lanes
    placement (and a group of one), ServeCommModel's for each
    point-sharded chunk (two rounds of the chunk boundary)."""
    for _rank, label, rec in _records(ranks):
        want = comm_audit.service_model(rec["stats"]["keys"])
        assert rec["tally"] == want, (label, rec["tally"], want)
        if str(label).startswith(("lanes", "('k1 lanes")):
            assert want == {}
    rec = ranks[3]["points k4"]
    model = engine.slot_trace_key(2, 256, 16, 1, C, True, False,
                                  point_shards=4)
    assert rec["stats"]["keys"][model] == 3
    assert ranks[3]["lanes k4"]["tally"] == {}


def test_no_new_set_up_after_warm_up(ranks):
    """Every rank's set-ups are the new trace keys of its run (the
    service keys its chunk as the chunk does), and a run whose
    configurations ran before sets up nothing on any rank."""
    for rank, label, rec in _records(ranks):
        assert rec["stats"]["compiles"] == len(rec["new_keys"]), \
            (rank, label)
    for r in ranks:
        for label in ("base", "poison", "cancel"):
            assert r[label]["new_keys"] == [], (r["rank"], label)
            assert r[label]["stats"]["compiles"] == 0


def test_device_memory_back_to_base(ranks):
    """Every rank holds no device buffer before the first request and none
    once the service has drained (the other ranks evict with rank 0's
    last plan)."""
    for rank, label, rec in _records(ranks):
        assert rec["held"] == (0, 0) and rec["batches"] == 0, (rank, label)


def test_traffic_is_counted_apart_from_theorem_8(ranks):
    """The service's own traffic: the plan each step, the admission data
    where a rank holds an admitted lane, and a harvest gather each lanes
    chunk (or a points chunk where a lane finished)."""
    rec = ranks[1]["points k4"]["stats"]["traffic"]
    assert rec["plan"]["calls"] > 0 and rec["plan"]["bytes"] > 0
    assert rec["data"]["calls"] > 0 and rec["harvest"]["calls"] > 0
    assert ranks[0]["k1 lanes", 0.0]["stats"]["traffic"] == {
        kind: dict(calls=0, bytes=0, seconds=0.0)
        for kind in ("plan", "data", "harvest")}


# ------------------------------------------------ validation (in process)
def _group(rank, size):
    return meshlib.ClientGroup(None, rank, size, torch.device(CPU))


def test_validation_raises(data):
    with pytest.raises(ValueError, match="divisible"):
        SolverService(num_slots=6, mesh=_group(0, 4))
    with pytest.raises(ValueError, match="differs"):
        SolverService(mesh=_group(0, 2), device="cuda")
    svc = SolverService(num_slots=2, mesh=_group(0, 2),
                        shard_points_above=256)
    x, y = data["big"]
    with pytest.raises(ValueError, match="gap_tol"):
        svc.submit(FitRequest(x=x, y=y, gap_tol=0.1))
    other = SolverService(num_slots=2, mesh=_group(1, 2))
    for call in (lambda: other.submit(FitRequest(x=x, y=y)),
                 lambda: other.status(0), lambda: other.result(0),
                 lambda: other.cancel(0), lambda: other.stats,
                 lambda: other.fit(x, y)):
        with pytest.raises(RuntimeError, match="rank 0"):
            call()
    assert other.rank_stats["rank"] == 1


def test_sharded_slot_trace_key_is_the_ranks_chunk_key():
    """engine.sharded_slot_trace_key (the JAX package's, from the whole
    batch's shapes) keys what one rank's chunk sets up."""
    group = _group(0, 4)
    assert engine.sharded_slot_trace_key(8, 1024, 16, 1, C, True, False,
                                         group, "points") == \
        engine.slot_trace_key(8, 256, 16, 1, C, True, False, point_shards=4)
    assert engine.sharded_slot_trace_key(8, 1024, 16, 1, C, False, True,
                                         group, "lanes") == \
        engine.slot_trace_key(2, 1024, 16, 1, C, False, True)
    with pytest.raises(ValueError, match="placement"):
        engine.sharded_slot_trace_key(8, 1024, 16, 1, C, False, False,
                                      group, "rows")
