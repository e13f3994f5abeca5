"""Fault-tolerant serving in the port (repro_torch.serve.faults and the
fit service's status contract) on the CPU: deterministic fault plans (the
JAX package's, from the same seed), the scheduler copy, slot quarantine
with bit-for-bit batch-mate invariance, bounded retry with backoff
ordering, deadline shedding, cancellation, intake validation and the
status API.  The LM service's fault paths are in test_torch_lm_serve.py."""

import ast
import inspect

import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.serve import faults as jfaults
from repro.serve import scheduler as jscheduler
from repro_torch.core import engine
from repro_torch.data import synthetic
from repro_torch.serve import faults, scheduler
from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan
from repro_torch.serve.scheduler import (RequestFailure, ResultNotReady,
                                         Scheduler, Status)
from repro_torch.serve.solver_service import (FitRequest, SolverService,
                                              UpdateRequest)

pytestmark = [pytest.mark.faults, pytest.mark.serve,
              pytest.mark.usefixtures("one_thread")]

C = 40      # service chunk length (as tests/test_torch_serve.py)
CPU = "cpu"


def _svc(**kw):
    return SolverService(device=CPU, **kw)


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def two_problems():
    ds1 = synthetic.blobs(40, 50, 16, gap=1.2, spread=0.15, seed=0)
    ds2 = synthetic.blobs(35, 45, 16, gap=0.8, spread=0.3, seed=2)
    return ds1, ds2       # both land in the (128, 16) bucket


def _nu(nu_frac, n1):
    return nu_frac and 1.0 / (nu_frac * n1)


def _run4(two_problems, nu_frac, injector=None, max_retries=0,
          cancel=None):
    """Four same-bucket requests through an S=3 service (the fourth
    waits for a freed lane); ``cancel`` = (request index, after how many
    steps) cancels one while it runs.  Returns (rids, drained results,
    svc)."""
    ds1, ds2 = two_problems
    specs = [(ds1, 1, 40), (ds2, 9, 35), (ds1, 5, 40), (ds2, 13, 35)]
    svc = _svc(num_slots=3, chunk_steps=C, fault_injector=injector)
    rids = [svc.submit(FitRequest(x=ds.x, y=ds.y, num_iters=4 * C,
                                  seed=s, nu=_nu(nu_frac, n1),
                                  max_retries=max_retries))
            for ds, s, n1 in specs]
    if cancel is not None:
        for _ in range(cancel[1]):
            svc.step()
        assert svc.cancel(rids[cancel[0]])
    return rids, svc.run(), svc


@pytest.fixture(scope="module")
def clean4(two_problems):
    """Fault-free reference runs of the _run4 workload, cached per
    nu_frac -- the bit-for-bit baseline survivors are held to."""
    cache = {}

    def get(nu_frac):
        if nu_frac not in cache:
            rids, res, _ = _run4(two_problems, nu_frac)
            cache[nu_frac] = (rids, res)
        return cache[nu_frac]

    return get


def _assert_same_result(a, b):
    """Bit-for-bit equality of two FitResults (not allclose: every op of
    the step is per lane, so a batch-mate's divergence must not move a
    single bit of anyone else's trajectory)."""
    np.testing.assert_array_equal(np.asarray(a.w), np.asarray(b.w))
    assert a.b == b.b
    assert a.objective == b.objective
    assert a.iterations == b.iterations


# ----------------------------------------------------- fault plan/injector
def test_fault_plan_deterministic():
    """Same seed -> same plan, every time (replayable chaos); a
    different seed gives a different plan; and the same seed gives the
    JAX package's plan."""
    rids = list(range(24))
    kw = dict(poison_frac=0.5, delay_frac=0.5, max_chunk=3, max_delay=3)
    p1 = FaultPlan.generate(5, rids, **kw)
    assert p1 == FaultPlan.generate(5, rids, **kw)
    assert p1 != FaultPlan.generate(6, rids, **kw)
    assert p1.poisoned_rids() <= set(rids)
    for f in p1.faults:
        if f.kind == "poison":
            assert 0 <= f.at_chunk <= 3
    for delay in p1.delays().values():
        assert 1 <= delay <= 3
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("explode")
    jp = jfaults.FaultPlan.generate(5, rids, **kw)
    assert [tuple(vars(f).values()) for f in p1.faults] == \
        [tuple(vars(f).values()) for f in jp.faults]


def test_injector_poison_fires_exactly_once():
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=7, at_chunk=1),)))
    assert not inj.poison_due(7, 0)          # before its chunk
    assert not inj.poison_due(8, 5)          # untargeted rid
    assert inj.poison_due(7, 1)              # fires...
    assert not inj.poison_due(7, 2)          # ...once (one-shot)
    assert [f.rid for f in inj.fired] == [7]


def test_poison_slot_state_writes_nan_in_place_and_sets_up_nothing():
    """The poison helper writes NaN into one lane's w and u, in place,
    and adds no chunk set-up key."""
    st = engine.init_slot_state(3, 128, 16, torch.device(CPU))
    w, u = st.w, st.u
    before = dict(engine.trace_counts)
    assert faults.poison_slot_state(st, 1) is st
    assert st.w is w and st.u is u
    assert torch.isnan(w[1]).all() and torch.isnan(u[1]).all()
    assert not torch.isnan(w[[0, 2]]).any()
    assert not torch.isnan(st.log_lam).any()
    assert dict(engine.trace_counts) == before


# ------------------------------------------------- scheduler status core
def _strip_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_scheduler_is_a_copy_of_the_jax_packages():
    """The port keeps its own copy of the standard-library scheduler:
    the same code, only docstrings differ."""
    got, want = (_strip_docstrings(ast.parse(inspect.getsource(m)))
                 for m in (scheduler, jscheduler))
    assert got == want


def test_status_terminal_partition():
    assert not Status.PENDING.terminal and not Status.RUNNING.terminal
    for s in (Status.DONE, Status.FAILED, Status.CANCELLED,
              Status.DEADLINE_EXCEEDED, Status.SUPERSEDED):
        assert s.terminal


def test_scheduler_resubmit_is_backoff_ordering():
    """A resubmitted (quarantined) ticket re-queues BEHIND every ticket
    already waiting in its urgency class."""
    sched = Scheduler(num_slots=1)
    t1 = sched.submit("g", 1)
    t2 = sched.submit("g", 2)
    g = sched.group("g")
    [(lane, got)] = sched.admit(g)
    assert got is t1 and t1.status is Status.RUNNING and t1.attempts == 1
    sched.resubmit(g, lane, t1)
    assert t1.status is Status.PENDING
    [(lane, nxt)] = sched.admit(g)
    assert nxt is t2                         # waiting ticket goes first
    sched.release(g, lane)
    [(lane, again)] = sched.admit(g)
    assert again is t1 and t1.attempts == 2


def test_scheduler_sheds_only_queued_tickets():
    sched = Scheduler(num_slots=1)
    t1 = sched.submit("g", 1, deadline=1.0)
    g = sched.group("g")
    sched.admit(g)                           # t1 now RUNNING
    t2 = sched.submit("g", 2, deadline=1.0)
    t3 = sched.submit("g", 3)                # deadline-less: never sheds
    shed = sched.shed_expired(5.0)
    assert [t for _, t in shed] == [t2]
    assert t2.status is Status.DEADLINE_EXCEEDED
    assert t1.status is Status.RUNNING and t3.status is Status.PENDING


def test_scheduler_cancel_queued_skips_running():
    sched = Scheduler(num_slots=1)
    sched.submit("g", 1)
    t2 = sched.submit("g", 2)
    g = sched.group("g")
    sched.admit(g)
    assert sched.cancel_queued(1) is None    # running: not cancellable
    grp, t = sched.cancel_queued(2)
    assert grp is g and t is t2 and t2.status is Status.CANCELLED
    assert sched.cancel_queued(2) is None


# -------------------------------------------------------------- intake
def test_solver_intake_validation(two_problems):
    """Malformed requests fail fast at submit with a ValueError naming
    the offending field -- nothing is enqueued, no lane is poisoned."""
    ds1, _ = two_problems
    svc = _svc(num_slots=2, chunk_steps=C)
    bad_x = ds1.x.copy()
    bad_x[3, 5] = np.nan
    with pytest.raises(ValueError, match=r"FitRequest\.x.*non-finite"):
        svc.submit(FitRequest(x=bad_x, y=ds1.y))
    bad_y = ds1.y.astype(np.float64).copy()
    bad_y[0] = np.inf
    with pytest.raises(ValueError, match=r"FitRequest\.y.*non-finite"):
        svc.submit(FitRequest(x=ds1.x, y=bad_y))
    with pytest.raises(ValueError, match="must be 2-D"):
        svc.submit(FitRequest(x=ds1.x[:, 0], y=ds1.y))
    with pytest.raises(ValueError, match=r"FitRequest\.y must be shape"):
        svc.submit(FitRequest(x=ds1.x, y=ds1.y[:-1]))
    small = _svc(num_slots=2, chunk_steps=C, max_points=64)
    with pytest.raises(ValueError, match="bucket ladder"):
        small.submit(FitRequest(x=ds1.x, y=ds1.y))      # 90 points > 64
    narrow = _svc(num_slots=2, chunk_steps=C, max_dim=8)
    with pytest.raises(ValueError, match="bucket ladder"):
        narrow.submit(FitRequest(x=ds1.x, y=ds1.y))     # d=16 > 8
    with pytest.raises(ValueError, match="idx_schedule"):
        svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=C,
                              idx_schedule=np.zeros((C - 1, 1), np.int32)))
    assert not svc._sched.has_work()


# ---------------------------------------------------------- status API
def test_status_api_and_result_not_ready(two_problems):
    ds1, _ = two_problems
    svc = _svc(num_slots=1, chunk_steps=C)
    rid = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=2 * C,
                                seed=3))
    assert svc.status(rid) is Status.PENDING
    with pytest.raises(ResultNotReady):
        svc.result(rid)
    with pytest.raises(KeyError):            # ResultNotReady IS a KeyError
        svc.result(rid)
    assert svc.step() == []                  # chunk 1 of 2
    assert svc.status(rid) is Status.RUNNING
    (res,) = svc.step()
    assert svc.status(rid) is Status.DONE
    assert svc.result(rid) is res
    with pytest.raises(KeyError):            # claimed: bare KeyError
        svc.result(rid)
    with pytest.raises(KeyError):
        svc.status(rid)
    with pytest.raises(KeyError):            # unknown rid: bare KeyError
        svc.result(12345)


# ---------------------------------------------------------- quarantine
@pytest.mark.parametrize("nu_frac", [0.0, 0.85])
def test_quarantine_bit_for_bit_invariance(two_problems, clean4, nu_frac):
    """Poisoning one slot mid-run does not move a single bit of any
    batch-mate's result (hard margin and nu-SVM), the victim gets a
    structured FAILED record, and its freed lane serves the next
    request (the fourth ran in it) with exact parity."""
    clean_rids, clean_res = clean4(nu_frac)
    victim = 1
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=victim, at_chunk=1),)))
    rids, res, _svc_ = _run4(two_problems, nu_frac, injector=inj)
    f = res[rids[victim]]
    assert isinstance(f, RequestFailure)
    assert f.status is Status.FAILED and f.attempts == 1
    assert "non-finite solver state" in f.reason
    for i in (0, 2, 3):
        _assert_same_result(res[rids[i]], clean_res[clean_rids[i]])
    assert len(inj.fired) == 1


@pytest.mark.parametrize("victim,chunk", [(0, 0), (1, 2), (2, 3), (3, 1)])
def test_quarantine_invariance_property(two_problems, clean4, victim,
                                        chunk):
    """For a victim and a poison chunk, every co-tenant's result is
    bit-for-bit the fault-free one (the fourth request waits for a lane,
    so victim 3 is poisoned after a mid-run admission)."""
    clean_rids, clean_res = clean4(0.0)
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=victim, at_chunk=chunk),)))
    rids, res, _svc_ = _run4(two_problems, 0.0, injector=inj)
    assert len(inj.fired) == 1
    for i, rid in enumerate(rids):
        if i == victim:
            assert isinstance(res[rid], RequestFailure)
            assert res[rid].status is Status.FAILED
        else:
            _assert_same_result(res[rid], clean_res[clean_rids[i]])


def test_cancel_leaves_batch_mates_bit_for_bit(two_problems, clean4):
    """Cancelling a running lane mid-run frees it for the waiting request;
    every other request equals the run without the cancel bit for bit."""
    clean_rids, clean_res = clean4(0.0)
    rids, res, _svc_ = _run4(two_problems, 0.0, cancel=(2, 1))
    assert res[rids[2]].status is Status.CANCELLED
    for i in (0, 1, 3):
        _assert_same_result(res[rids[i]], clean_res[clean_rids[i]])


# --------------------------------------------------------------- retry
def test_retry_recovers_and_queues_behind_waiters(two_problems):
    """A transient fault (one-shot poison) within the retry budget: the
    victim re-queues BEHIND the waiting bystander (backoff ordering),
    then completes bit-for-bit clean."""
    ds1, ds2 = two_problems
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=0, at_chunk=0),)))
    svc = _svc(num_slots=1, chunk_steps=C, fault_injector=inj)
    rv = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=C, seed=1,
                               max_retries=1))
    rb = svc.submit(FitRequest(x=ds2.x, y=ds2.y, num_iters=C, seed=2))
    assert svc.step() == []                  # victim poisoned+quarantined
    assert svc.status(rv) is Status.PENDING  # resubmitted, not failed
    assert [r.request_id for r in svc.step()] == [rb]   # bystander first
    (got,) = svc.step()                      # then the clean retry
    assert got.request_id == rv
    assert len(inj.fired) == 1
    clean = _svc(num_slots=1, chunk_steps=C).fit(ds1.x, ds1.y,
                                                 num_iters=C, seed=1)
    _assert_same_result(got, clean)


def test_retry_budget_exhausted_fails_structured(two_problems):
    ds1, _ = two_problems
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=0, at_chunk=0),)))
    svc = _svc(num_slots=2, chunk_steps=C, fault_injector=inj)
    rid = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=2 * C,
                                seed=1))                # max_retries=0
    res = svc.run()
    f = res[rid]
    assert isinstance(f, RequestFailure) and f.status is Status.FAILED
    assert f.attempts == 1 and "attempts=1" in f.reason
    # the one-shot convenience path surfaces it as an exception
    inj2 = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=0, at_chunk=0),)))
    svc2 = _svc(num_slots=2, chunk_steps=C, fault_injector=inj2)
    with pytest.raises(RuntimeError, match="FAILED"):
        svc2.fit(ds1.x, ds1.y, num_iters=C, seed=1)


def _stream_update_run(two_problems, injector):
    """One streaming workload: a tenant's initial fit completes, then
    its warm UPDATE round shares the batch with a bystander request.
    rids are deterministic (0 = initial fit, 1 = update, 2 =
    bystander), so a plan poisoning rid 1 hits the update mid-round."""
    ds1, ds2 = two_problems
    extra = synthetic.blobs(2, 2, 16, gap=1.2, spread=0.15, seed=21)
    svc = _svc(num_slots=2, chunk_steps=C, fault_injector=injector)
    rt = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=2 * C,
                               seed=1, stream=True))
    svc.run()                                # warm state harvested
    ru = svc.submit_update(UpdateRequest(tenant=rt, x=extra.x,
                                         y=extra.y, num_iters=2 * C,
                                         max_retries=1))
    rb = svc.submit(FitRequest(x=ds2.x, y=ds2.y, num_iters=2 * C,
                               seed=9))
    res = svc.run()
    return res[ru], res[rb]


def test_update_round_poison_retries_from_warm_state(two_problems):
    """Poison mid-update-round: the update's lane is quarantined and the
    retry RE-ENTERS FROM THE SAME WARM STATE, completing bit-for-bit
    equal to a fault-free warm update; the batch-mate is bit-for-bit
    unchanged."""
    clean_u, clean_b = _stream_update_run(two_problems, None)
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=1, at_chunk=0),)))
    got_u, got_b = _stream_update_run(two_problems, inj)
    assert not isinstance(got_u, RequestFailure)
    _assert_same_result(got_u, clean_u)
    _assert_same_result(got_b, clean_b)
    assert len(inj.fired) == 1


def test_update_round_poison_budget_exhausted_keeps_tenant(two_problems):
    """An update whose retries are exhausted FAILS structured -- and the
    tenant survives it: the dataset edit persists and the next update
    (which re-warms from the last GOOD completed state) still runs."""
    ds1, _ = two_problems
    extra = synthetic.blobs(2, 2, 16, gap=1.2, spread=0.15, seed=21)
    inj = FaultInjector(FaultPlan(
        seed=0, faults=(Fault("poison", rid=1, at_chunk=0),)))
    svc = _svc(num_slots=2, chunk_steps=C, fault_injector=inj)
    rt = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=2 * C,
                               seed=1, stream=True))
    svc.run()
    ru = svc.submit_update(UpdateRequest(tenant=rt, x=extra.x,
                                         y=extra.y, num_iters=2 * C))
    f = svc.run()[ru]                        # max_retries inherited: 0
    assert isinstance(f, RequestFailure) and f.status is Status.FAILED
    r2 = svc.submit_update(UpdateRequest(tenant=rt, num_iters=2 * C))
    assert not isinstance(svc.run()[r2], RequestFailure)


# ----------------------------------------------------------- deadlines
def test_deadline_shedding_with_clock(two_problems):
    """With an injected clock, queued tickets past their deadline are
    shed (DEADLINE_EXCEEDED, attempts=0: never ran); RUNNING tickets
    finish their budget; without a clock, deadlines only order."""
    ds1, ds2 = two_problems
    now = [0.0]
    svc = _svc(num_slots=2, chunk_steps=C, clock=lambda: now[0])
    r1 = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=C, seed=1),
                    deadline=5.0)
    r2 = svc.submit(FitRequest(x=ds2.x, y=ds2.y, num_iters=C, seed=2))
    now[0] = 10.0                            # r1 expires while queued
    res = svc.run()
    f = res[r1]
    assert isinstance(f, RequestFailure)
    assert f.status is Status.DEADLINE_EXCEEDED and f.attempts == 0
    assert not isinstance(res[r2], RequestFailure)
    # a ticket that got a lane before expiry is NOT shed mid-run
    now[0] = 0.0
    r3 = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=2 * C,
                               seed=3), deadline=5.0)
    assert svc.step() == []                  # admitted while now < deadline
    now[0] = 10.0
    res = svc.run()
    assert not isinstance(res[r3], RequestFailure)
    # no clock -> deadlines only order
    svc2 = _svc(num_slots=1, chunk_steps=C)
    r4 = svc2.submit(FitRequest(x=ds2.x, y=ds2.y, num_iters=C, seed=4),
                     deadline=0.5)
    assert not isinstance(svc2.run()[r4], RequestFailure)


# -------------------------------------------------------------- cancel
def test_cancel_queued_and_running(two_problems):
    ds1, ds2 = two_problems
    svc = _svc(num_slots=1, chunk_steps=C)
    r1 = svc.submit(FitRequest(x=ds1.x, y=ds1.y, num_iters=4 * C,
                               seed=1))
    r2 = svc.submit(FitRequest(x=ds2.x, y=ds2.y, num_iters=C, seed=2))
    assert svc.step() == []                  # r1 RUNNING, r2 queued
    assert svc.cancel(r2)
    assert svc.status(r2) is Status.CANCELLED
    f2 = svc.result(r2)
    assert f2.attempts == 0 and "queued" in f2.reason
    assert svc.cancel(r1)
    f1 = svc.result(r1)
    assert f1.status is Status.CANCELLED and f1.attempts == 1
    assert "running" in f1.reason
    assert not svc.cancel(r1)                # terminal: no-op
    assert not svc.cancel(999)               # unknown: no-op
    assert not svc._sched.has_work()
    assert not svc._batches                  # device buffers evicted
    # the service stays fully usable after cancellations
    res = svc.fit(ds1.x, ds1.y, num_iters=C, seed=7)
    assert res.iterations == C
