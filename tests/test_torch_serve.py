"""The port's fit service (repro_torch.serve.solver_service) on the CPU:
continuous batching over the slot-batched engine held to the port's own
solo ``saddle.solve`` at the same seed, bucket and chunk schedule (atol
1e-5, the JAX service tests' tolerance), streaming warm starts held to
``saddle.solve(warm_start=...)``, the set-up discipline, and one replay of
a JAX-service scenario with the JAX package's signs and coordinates."""

import jax
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.core import engine as jengine
from repro.serve.solver_service import FitRequest as JFitRequest
from repro.serve.solver_service import SolverService as JSolverService
from repro_torch.core import engine
from repro_torch.core import preprocess as pp
from repro_torch.core import saddle
from repro_torch.core.svm import (_preprocess_seed, recover_hyperplane,
                                  split_classes)
from repro_torch.data import synthetic
from repro_torch.serve.scheduler import RequestFailure, Status
from repro_torch.serve.solver_service import (FitRequest, SolverService,
                                              UpdateRequest)

pytestmark = [pytest.mark.serve, pytest.mark.usefixtures("one_thread")]

C = 40      # service chunk length == solo record_every (parity contract)
CPU = "cpu"


def _svc(**kw):
    return SolverService(device=CPU, **kw)


def _pre(x, y, seed):
    """The service's preprocessing of a request at ``seed`` (SaddleSVC's
    seeding of the transform's signs)."""
    xp, xm = split_classes(x, y)
    gen = torch.Generator().manual_seed(_preprocess_seed(seed))
    return pp.preprocess(xp, xm, generator=gen, device=CPU)


def _solo_fit(pre, xp_t, xm_t, seed, nu, num_iters, *, eps=1e-3,
              warm_start=None, chunk=C):
    """Reference: the port's solo saddle.solve at the SAME bucket and
    chunk schedule as the service, through the same svm.py recovery
    path.  Returns (SolveResult, w, b)."""
    n_b, d_b = pp.bucket_shape(len(xp_t) + len(xm_t), xp_t.shape[1])
    res = saddle.solve(xp_t, xm_t, nu=nu, eps=eps, num_iters=num_iters,
                       record_every=chunk, seed=seed, n_pad=n_b, d_pad=d_b,
                       warm_start=warm_start, device=CPU)
    st = res.state
    w, b, *_ = recover_hyperplane(pre, torch.exp(st.log_eta),
                                  torch.exp(st.log_xi), xp_t, xm_t)
    return res, w, b


def _solo(x, y, seed, nu, num_iters):
    pre = _pre(x, y, seed)
    _, w, b = _solo_fit(pre, pre.xp, pre.xm, seed, nu, num_iters)
    return w, b


@pytest.fixture(scope="module")
def two_problems():
    ds1 = synthetic.blobs(40, 50, 16, gap=1.2, spread=0.15, seed=0)
    ds2 = synthetic.blobs(35, 45, 16, gap=0.8, spread=0.3, seed=2)
    return ds1, ds2       # both land in the (128, 16) bucket


@pytest.mark.parametrize("nu_frac", [0.0, 0.85])
def test_midrun_admission_parity(two_problems, nu_frac):
    """A request admitted into a PARTIALLY-BUSY batch mid-run returns
    the same (w, b) as a solo saddle.solve at the same seed and bucket --
    for hard margin and nu-SVM."""
    ds1, ds2 = two_problems
    nu1 = nu_frac and 1.0 / (nu_frac * 40)
    nu2 = nu_frac and 1.0 / (nu_frac * 35)
    svc = _svc(num_slots=4, chunk_steps=C)
    rid1 = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=6 * C,
                                 seed=1, nu=nu1))
    assert svc.step() == []               # chunk 1: only request 1 runs
    rid2 = svc.submit(FitRequest(x=ds2.x, y=ds2.y, num_iters=3 * C,
                                 seed=9, nu=nu2))
    results = svc.run()
    for rid, ds, seed, nu, iters in [(rid1, ds1, 1, nu1, 6 * C),
                                     (rid2, ds2, 9, nu2, 3 * C)]:
        w, b = _solo(ds.x, ds.y, seed, nu, iters)
        np.testing.assert_allclose(results[rid].w, w, atol=1e-5)
        np.testing.assert_allclose(results[rid].b, b, atol=1e-5)
        assert results[rid].iterations == iters


def test_freed_slot_reuse_leaks_no_state(two_problems):
    """A lane freed by a finished request and reused by a NEW request
    behaves exactly like a fresh lane: same (w, b) as solo."""
    ds1, ds2 = two_problems
    svc = _svc(num_slots=1, chunk_steps=C)            # forces reuse
    r1 = svc.fit(ds1.x, ds1.y, num_iters=2 * C, seed=11)
    r2 = svc.fit(ds2.x, ds2.y, num_iters=2 * C, seed=12)
    w2, b2 = _solo(ds2.x, ds2.y, 12, 0.0, 2 * C)
    np.testing.assert_allclose(r2.w, w2, atol=1e-5)
    np.testing.assert_allclose(r2.b, b2, atol=1e-5)
    w1, _ = _solo(ds1.x, ds1.y, 11, 0.0, 2 * C)
    np.testing.assert_allclose(r1.w, w1, atol=1e-5)
    # reuse rode the same chunk configuration: at most one set-up for
    # the whole session (zero when another run already set up the key)
    assert svc.stats["compiles"] <= 1
    assert svc.stats["cache_hits"] >= svc.stats["chunk_calls"] - 1


def test_slot_batched_equals_sequential_batch(two_problems):
    """S requests solved CONCURRENTLY (one slot-batched chunk) equal the
    same requests solved one at a time."""
    ds1, ds2 = two_problems
    specs = [(ds1, 0), (ds2, 1), (ds1, 2), (ds2, 3)]
    svc = _svc(num_slots=4, chunk_steps=C)
    rids = [svc.submit(FitRequest(x=ds.x, y=ds.y, num_iters=3 * C,
                                  seed=s)) for ds, s in specs]
    results = svc.run()
    for rid, (ds, s) in zip(rids, specs):
        w, _ = _solo(ds.x, ds.y, s, 0.0, 3 * C)
        np.testing.assert_allclose(results[rid].w, w, atol=1e-5)


def test_gap_early_stop_frees_slot(two_problems):
    """gap_tol > 0: an easy request converges and frees its lane well
    before its iteration budget; the result is still a good fit."""
    ds1, _ = two_problems
    svc = _svc(num_slots=2, chunk_steps=C)
    res = svc.fit(ds1.x, ds1.y, num_iters=200 * C, seed=0, gap_tol=0.2)
    assert res.iterations < 200 * C
    acc = np.mean(np.where(ds1.x @ res.w - res.b >= 0, 1, -1) == ds1.y)
    assert acc >= 0.95


def test_fit_preserves_co_drained_results(two_problems):
    """fit() drains the whole queue; results of OTHER requests completed
    by that drain stay claimable via result()."""
    ds1, ds2 = two_problems
    svc = _svc(num_slots=2, chunk_steps=C)
    rid1 = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=C, seed=4))
    r2 = svc.fit(ds2.x, ds2.y, num_iters=C, seed=5)
    r1 = svc.result(rid1)                   # must not raise
    assert r1.request_id == rid1 and r2.request_id != rid1
    # batches drained -> their device buffers were evicted
    assert not svc._batches


def test_single_class_rejected_at_submit(two_problems):
    ds1, _ = two_problems
    svc = _svc(num_slots=2, chunk_steps=C)
    with pytest.raises(ValueError, match="both classes"):
        svc.submit(FitRequest(x=ds1.x, y=np.ones(len(ds1.y))))


def test_infeasible_nu_rejected_at_submit(two_problems):
    ds1, _ = two_problems
    svc = _svc(num_slots=2, chunk_steps=C)
    with pytest.raises(ValueError, match="infeasible"):
        svc.submit(FitRequest(x=ds1.x, y=ds1.y, nu=1.0 / 200))


def test_service_runs_on_cuda_by_default_and_validates_its_mesh(
        two_problems):
    """The device contract: cuda unless the caller asks for the CPU (here,
    without a card, asking for cuda raises); ``mesh=`` takes a process
    group (``launch.mesh.ClientGroup``, whose device is the service's)
    and ``shard_points_above`` needs one."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverService()
    with pytest.raises(TypeError, match="ClientGroup"):
        SolverService(device=CPU, mesh=object())
    with pytest.raises(ValueError, match="pass mesh="):
        SolverService(device=CPU, shard_points_above=1000)
    assert _svc().device == torch.device("cpu")


# ================================================================
# Streaming updates (warm starts)
# ================================================================
#
# The JAX tests hold a warm update to a COLD re-fit, which needs long
# converged runs.  Here the contract is held directly: the service's warm
# update equals the port's solo saddle.solve warm-started from the solo
# fit of the previous revision, at the update's seed (tenant seed +
# 1000003 * version), bucket and chunk schedule, within 1e-5.

def _stream_case(case):
    if case in ("nu0", "nu_pin"):
        ds = synthetic.blobs(20 if case == "nu0" else 24, 24, 8,
                             gap=1.5, spread=0.12, seed=1)
        extra = synthetic.blobs(2, 2, 8, gap=1.5, spread=0.12, seed=7)
    else:
        ds = synthetic.blobs(60, 64, 8, gap=1.5, spread=0.12, seed=1)
        extra = synthetic.blobs(3, 3, 8, gap=1.5, spread=0.12, seed=7)
        assert pp.bucket_length(len(ds.x)) == 128            # rung 0
        assert pp.bucket_length(len(ds.x) + len(extra.x)) == 256
    cfg = {
        "nu0": dict(nu0=0.0, nu1=None, eps=1e-2),
        "nu0_jump": dict(nu0=0.0, nu1=None, eps=1e-2),
        "nu_pin": dict(nu0=1 / 24, nu1=1 / 26, eps=1e-3),
        "nu_pin_jump": dict(nu0=1 / 60, nu1=1 / 63, eps=1e-2),
    }[case]
    return ds, extra, cfg


def _solo_update(ds, extra, seed, nu0, nu1, eps, iters, *, replace=False):
    """The solo chain of a stream: the first fit, then the edited problem
    warm-started from it (w carried and the duals reset to uniform when
    ``replace``).  Returns (w, b) of the update."""
    pre = _pre(ds.x, ds.y, seed)
    first, *_ = _solo_fit(pre, pre.xp, pre.xm, seed, nu0, iters, eps=eps)
    tp = pp.transform_like(pre, extra.x[extra.y > 0])
    tm = pp.transform_like(pre, extra.x[extra.y < 0])
    warm = first.state
    if replace:
        xp_t, xm_t = tp, tm
        empty = torch.zeros(0)
        warm = warm._replace(log_eta=empty, log_eta_prev=empty,
                             log_xi=empty, log_xi_prev=empty)
    else:
        xp_t, xm_t = torch.cat([pre.xp, tp]), torch.cat([pre.xm, tm])
    _, w, b = _solo_fit(pre, xp_t, xm_t, seed + 1000003,
                        nu0 if nu1 is None else nu1, iters, eps=eps,
                        warm_start=warm)
    return w, b


@pytest.mark.parametrize("case", ["nu0", "nu0_jump", "nu_pin",
                                  "nu_pin_jump"])
def test_streaming_warm_parity(case):
    """A warm-started update equals the solo solve warm-started from the
    previous revision (atol 1e-5), for nu=0 and nu>0, in-bucket AND
    across a pow-2 rung jump (the *_jump cases start at 124 points on
    the 128 rung and the append crosses into the 256 rung)."""
    ds, extra, cfg = _stream_case(case)
    iters, seed = 6 * C, 5
    svc = _svc(num_slots=2, chunk_steps=C)
    rid = svc.submit(FitRequest(x=ds.x, y=ds.y, seed=seed, nu=cfg["nu0"],
                                eps=cfg["eps"], num_iters=iters,
                                stream=True))
    first = svc.run()[rid]
    ru = svc.submit_update(UpdateRequest(tenant=rid, x=extra.x, y=extra.y,
                                         nu=cfg["nu1"], num_iters=iters))
    res = svc.run()[ru]
    w, b = _solo_update(ds, extra, seed, iters=iters, **cfg)
    np.testing.assert_allclose(res.w, w, atol=1e-5)
    np.testing.assert_allclose(res.b, b, atol=1e-5)
    # the update ran its own full budget (t was reset) in its own rung
    assert res.iterations == iters
    assert res.bucket[0] == pp.bucket_length(len(ds.x) + len(extra.x))
    assert first.bucket[0] == pp.bucket_length(len(ds.x))


def test_streaming_update_zero_recompile_contract():
    """trace_counts is UNCHANGED across update rounds: an in-bucket
    re-pack adds no set-up; a rung jump sets up its target-rung chunk
    once and every later round -- in either rung -- adds nothing.  Also:
    an update landing EXACTLY on the bucket boundary stays in its rung."""
    ds = synthetic.blobs(60, 64, 8, gap=1.5, spread=0.12, seed=1)
    svc = _svc(num_slots=2, chunk_steps=C)

    def upd(rid, m, seed):
        ex = synthetic.blobs(m, m, 8, gap=1.5, spread=0.12, seed=seed)
        ru = svc.submit_update(UpdateRequest(tenant=rid, x=ex.x,
                                             y=ex.y, num_iters=2 * C))
        res = svc.run()[ru]
        assert not isinstance(res, RequestFailure)
        return res

    rid = svc.submit(FitRequest(x=ds.x, y=ds.y, seed=3, num_iters=2 * C,
                                stream=True))
    svc.run()
    snap0 = dict(engine.trace_counts)
    upd(rid, 1, 11)                     # 124 + 2 = 126: in-bucket
    assert upd(rid, 1, 12).bucket[0] == 128     # 128 EXACTLY: no jump
    assert dict(engine.trace_counts) == snap0, \
        "in-bucket update rounds must not set up anything new"
    assert upd(rid, 1, 13).bucket[0] == 256     # 130: jumps a rung
    snap1 = dict(engine.trace_counts)
    upd(rid, 2, 14)                     # post-jump rounds: pinned again
    upd(rid, 2, 15)
    assert dict(engine.trace_counts) == snap1, \
        "post-rung-jump update rounds must not set up anything new"


def test_streaming_warm_update_converges_faster():
    """With a duality-gap stop, a warm-started small append converges in
    far fewer iterations than a cold re-fit of the same edited problem."""
    ds = synthetic.blobs(20, 24, 8, gap=1.5, spread=0.12, seed=1)
    extra = synthetic.blobs(1, 1, 8, gap=1.5, spread=0.12, seed=7)
    iters = {}
    for warm in (True, False):
        svc = _svc(num_slots=2, chunk_steps=256)
        rid = svc.submit(FitRequest(x=ds.x, y=ds.y, seed=5,
                                    num_iters=40_960, gap_tol=0.05,
                                    stream=True))
        svc.run()
        ru = svc.submit_update(UpdateRequest(tenant=rid, x=extra.x,
                                             y=extra.y, warm=warm))
        iters[warm] = svc.run()[ru].iterations
    assert iters[False] > 2 * iters[True], iters
    assert iters[True] < 40_960 and iters[False] < 40_960, \
        f"gap stop never fired, ratio is meaningless: {iters}"


def test_update_overflowing_ladder_fails_fast(two_problems):
    """An update that would overflow the bucket ladder is a fail-fast
    ValueError NAMING max_points at submit_update -- nothing is enqueued
    and the tenant keeps serving (its dataset unchanged)."""
    ds1, _ = two_problems                      # 90 points, d=16
    svc = _svc(num_slots=2, chunk_steps=C, max_points=128)
    rid = svc.submit(FitRequest(x=ds1.x, y=ds1.y, seed=1,
                                num_iters=2 * C, stream=True))
    svc.run()
    big = synthetic.blobs(30, 30, 16, gap=1.2, spread=0.15, seed=9)
    with pytest.raises(ValueError, match="max_points"):
        svc.submit_update(UpdateRequest(tenant=rid, x=big.x, y=big.y))
    assert not svc._sched.has_work()           # nothing enqueued
    small = synthetic.blobs(2, 2, 16, gap=1.2, spread=0.15, seed=9)
    ru = svc.submit_update(UpdateRequest(tenant=rid, x=small.x,
                                         y=small.y, num_iters=2 * C))
    assert not isinstance(svc.run()[ru], RequestFailure)


def test_update_nu_refeasibility(two_problems):
    """nu feasibility is RE-validated against the post-edit class sizes:
    an infeasible per-update override fails fast, and a replace that
    shrinks a class under the tenant's inherited cap fails fast; the
    rejected edit leaves the dataset untouched."""
    ds1, _ = two_problems                      # (40, 50)
    svc = _svc(num_slots=2, chunk_steps=C)
    rid = svc.submit(FitRequest(x=ds1.x, y=ds1.y, seed=1, num_iters=C,
                                nu=1.0 / (0.85 * 40), stream=True))
    svc.run()
    ex = synthetic.blobs(2, 2, 16, gap=1.2, spread=0.15, seed=9)
    with pytest.raises(ValueError, match="infeasible"):
        svc.submit_update(UpdateRequest(tenant=rid, x=ex.x, y=ex.y,
                                        nu=1.0 / 200))
    tiny = synthetic.blobs(5, 5, 16, gap=1.2, spread=0.15, seed=9)
    with pytest.raises(ValueError, match="infeasible"):
        svc.submit_update(UpdateRequest(tenant=rid, x=tiny.x, y=tiny.y,
                                        mode="replace"))
    assert not svc._sched.has_work()
    # the tenant still serves a pure warm re-fit of its ORIGINAL data
    ru = svc.submit_update(UpdateRequest(tenant=rid, num_iters=C))
    res = svc.run()[ru]
    assert not isinstance(res, RequestFailure)
    assert res.bucket == (128, 16)


def test_update_supersedes_inflight_request(two_problems):
    """A new update SUPERSEDES the tenant's in-flight request -- queued
    or already running -- with a terminal SUPERSEDED status whose
    failure record names the superseding rid; the newest revision
    completes normally."""
    ds1, _ = two_problems
    ex = synthetic.blobs(2, 2, 16, gap=1.2, spread=0.15, seed=9)
    svc = _svc(num_slots=1, chunk_steps=C)
    rid = svc.submit(FitRequest(x=ds1.x, y=ds1.y, seed=1,
                                num_iters=4 * C, stream=True))
    r2 = svc.submit_update(UpdateRequest(tenant=rid, x=ex.x, y=ex.y,
                                         num_iters=4 * C))
    assert svc.status(rid) is Status.SUPERSEDED
    f = svc.result(rid)
    assert isinstance(f, RequestFailure)
    assert f.status is Status.SUPERSEDED and f.attempts == 0
    assert f"superseded by update request {r2}" in f.reason
    assert svc.step() == []                    # r2 RUNNING mid-budget
    assert svc.status(r2) is Status.RUNNING
    r3 = svc.submit_update(UpdateRequest(tenant=rid, num_iters=C))
    assert svc.status(r2) is Status.SUPERSEDED
    assert f"superseded by update request {r3}" in svc.result(r2).reason
    res = svc.run()[r3]
    assert not isinstance(res, RequestFailure)
    assert res.iterations == C                 # newest revision ran


def test_update_unknown_tenant_and_close_stream(two_problems):
    ds1, _ = two_problems
    svc = _svc(num_slots=2, chunk_steps=C)
    with pytest.raises(KeyError, match="tenant"):
        svc.submit_update(UpdateRequest(tenant=123))
    # a NON-stream fit is not a tenant
    rid = svc.submit(FitRequest(x=ds1.x, y=ds1.y, seed=1, num_iters=C))
    svc.run()
    with pytest.raises(KeyError, match="tenant"):
        svc.submit_update(UpdateRequest(tenant=rid))
    # close_stream forgets the tenant's retained transform + state
    rs = svc.submit(FitRequest(x=ds1.x, y=ds1.y, seed=1, num_iters=C,
                               stream=True))
    svc.run()
    assert svc.close_stream(rs)
    assert not svc.close_stream(rs)
    with pytest.raises(KeyError, match="tenant"):
        svc.submit_update(UpdateRequest(tenant=rs))


def test_replace_mode_resets_to_new_problem():
    """mode="replace" swaps the whole dataset under the tenant's FIXED
    transform: the re-fit carries w and resets the dual mass to uniform,
    so it equals the solo solve of the new points warm-started from the
    previous w alone (atol 1e-5); it converges on the new problem, which
    it classifies perfectly."""
    ds_a = synthetic.blobs(20, 24, 8, gap=1.5, spread=0.12, seed=1)
    ds_b = synthetic.blobs(22, 20, 8, gap=1.5, spread=0.12, seed=4)
    iters, seed = 64 * C, 5
    svc = _svc(num_slots=2, chunk_steps=C)
    rid = svc.submit(FitRequest(x=ds_a.x, y=ds_a.y, seed=seed, eps=1e-2,
                                num_iters=iters, stream=True))
    svc.run()
    ru = svc.submit_update(UpdateRequest(tenant=rid, x=ds_b.x, y=ds_b.y,
                                         mode="replace"))
    got = svc.run()[ru]
    w, b = _solo_update(ds_a, ds_b, seed, 0.0, None, 1e-2, iters,
                        replace=True)
    np.testing.assert_allclose(got.w, w, atol=1e-5)
    np.testing.assert_allclose(got.b, b, atol=1e-5)
    assert got.iterations == iters
    acc = np.mean(np.where(ds_b.x @ got.w - got.b >= 0, 1, -1) == ds_b.y)
    assert acc == 1.0


# ================================================================
# One scenario replayed against the JAX package's service
# ================================================================

def _jax_schedule(seed, d, b, num_iters, chunk):
    """The coordinate blocks the JAX service's lane draws for a request
    at ``seed``: the lane's key chain is split once per chunk and the
    chunk key into ``chunk`` step keys (engine.chunk_body_slots)."""
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


def test_midrun_admission_replays_jax_service(two_problems):
    """Two requests, the second admitted mid-run into an S = 4 batch,
    through the JAX package's SolverService and through the port's, the
    port fed the JAX requests' preprocessing signs and per-lane
    coordinate schedules: the FitResults agree within 1e-4 in w, b and
    the objective, with the same iterations and chunk marks."""
    ds1, ds2 = two_problems
    runs = [(ds1, 1, 6 * C), (ds2, 9, 3 * C)]
    jsvc = JSolverService(num_slots=4, chunk_steps=C)
    svc = _svc(num_slots=4, chunk_steps=C)
    rids = []
    for i, (ds, seed, iters) in enumerate(runs):
        if i:
            assert jsvc.step() == [] and svc.step() == []
        rids.append((
            jsvc.submit(JFitRequest(x=ds.x, y=ds.y, num_iters=iters,
                                    seed=seed)),
            svc.submit(FitRequest(
                x=ds.x, y=ds.y, num_iters=iters, seed=seed,
                signs=_jax_signs(seed, 16),
                idx_schedule=_jax_schedule(seed, 16, 1, iters, C)))))
    jres, res = jsvc.run(), svc.run()
    for jrid, rid in rids:
        want, got = jres[jrid], res[rid]
        np.testing.assert_allclose(got.w, np.asarray(want.w), atol=1e-4)
        np.testing.assert_allclose(got.b, want.b, atol=1e-4)
        np.testing.assert_allclose(got.objective, want.objective,
                                   atol=1e-4)
        assert got.iterations == want.iterations
        assert [m for m, _ in got.history] == [m for m, _ in want.history]
