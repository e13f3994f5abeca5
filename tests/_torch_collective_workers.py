"""What the spawned ranks of tests/test_torch_collectives.py and
tests/test_torch_mesh_service.py run.

The ranks unpickle these functions by their import path, so they live in
this importable module rather than in the test file.  Each returns numpy
arrays and plain numbers only."""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import engine, saddle
from repro_torch.launch import mesh as meshlib
from repro_torch.utils import comm_audit

CPU = "cpu"


def _gathered(res) -> dict:
    return {f: getattr(res.state, f).numpy()
            for f in ("w", "log_eta", "log_xi", "u_p", "u_m")}


def _solve(group, xp, xm, k, **kw) -> dict:
    before = collections.Counter(engine.collective_counts)
    res = dist.solve_distributed(xp, xm, k=k, mesh=group, device=CPU, **kw)
    return dict(state=_gathered(res), history=res.history,
                tally=dict(collections.Counter(engine.collective_counts)
                           - before))


def _serve_batch(problems, n_pad, d, nu, block_size):
    rows = []
    for xp, xm in problems:
        params = saddle.make_params(len(xp) + len(xm), d, 1e-2, 0.1, nu=nu,
                                    block_size=block_size)
        rows.append(engine.slot_params_row(params))
    return comm_audit.fresh_slot_batch(
        [(torch.as_tensor(xp), torch.as_tensor(xm)) for xp, xm in problems],
        n_pad, d, rows, [50 + i for i in range(len(problems))], 10_000,
        torch.device(CPU))


def _serve_run(group, placement, batch, chunks, chunk_steps, d, block_size,
               project, drop=None):
    """``chunks`` chunks of a slot batch: unsharded without a group, else
    this rank's shard in ``placement``, after dropping ``drop = (lane,
    shard)`` when given."""
    state, x_t, sign, sp = batch
    if drop is not None:
        state, sign = dist.drop_slot_shard(state, sign, *drop,
                                           num_shards=group.size)
    kw = dict(chunk_steps=chunk_steps, d=d, block_size=block_size,
              project=project, check_gap=False)
    if group is not None:
        state, x_t, sign, sp = engine.shard_slot_batch(group, placement,
                                                       state, x_t, sign, sp)
    objs = []
    for _ in range(chunks):
        if group is None:
            state, obj, healthy = engine.run_chunk_slots(
                state, x_t, sign, sp, chunk_steps, **kw)
        else:
            state, obj, healthy = engine.run_chunk_slots_sharded(
                state, x_t, sign, sp, chunk_steps, mesh=group,
                placement=placement, **kw)
        objs.append(obj.numpy())
    return dict(w=state.w.numpy(), log_lam=state.log_lam.numpy(),
                u=state.u.numpy(), t=state.t.numpy(),
                active=state.active.numpy(), obj=np.stack(objs),
                healthy=healthy.numpy())


def serve_cases(group, serve) -> dict:
    """The serving placements of one batch on ``group``: the unsharded
    chunk (rank 0), "points", "points" with a shard of one lane dropped,
    and "lanes"."""
    out = {}
    for label, nu in (("hm", 0.0), ("nu", serve["nu"])):
        args = (serve["chunks"], serve["chunk_steps"], serve["d"],
                serve["block_size"], nu > 0)

        def batch():
            return _serve_batch(serve["problems"], serve["n_pad"],
                                serve["d"], nu, serve["block_size"])

        if group.rank == 0:
            out[label, "whole"] = _serve_run(None, None, batch(), *args)
        before = collections.Counter(engine.collective_counts)
        out[label, "points"] = _serve_run(group, "points", batch(), *args)
        out[label, "points_tally"] = dict(
            collections.Counter(engine.collective_counts) - before)
        out[label, "dropped"] = _serve_run(group, "points", batch(), *args,
                                           drop=serve["drop"])
        before = collections.Counter(engine.collective_counts)
        out[label, "lanes"] = _serve_run(group, "lanes", batch(), *args)
        out[label, "lanes_tally"] = dict(
            collections.Counter(engine.collective_counts) - before)
    return out


def runner_cases(world, cases: dict) -> dict:
    """Every case of the 8-rank spawn: k = 8 on JAX's data over the whole
    group, k = 4 (hard margin and nu, a k mismatch, the serving
    placements) on ranks 0-3, and k = 1 on rank 0."""
    g4 = meshlib.sub_group(world, range(4))
    g1 = meshlib.sub_group(world, [0])
    out = {"rank": world.rank}
    xp, xm, sched = cases["jax"]
    out["jax_k8"] = _solve(world, xp, xm, 8, num_iters=len(sched),
                           idx_schedule=sched)
    if g4 is not None:
        xp, xm = cases["problem"]
        for label, kw in cases["k4"].items():
            out[label] = _solve(g4, xp, xm, 4, **kw)
        try:
            dist.solve_distributed(xp, xm, k=3, num_iters=5, mesh=g4,
                                   device=CPU)
        except ValueError as exc:
            out["k_mismatch"] = str(exc)
        out["serve"] = serve_cases(g4, cases["serve"])
    if g1 is not None:
        xp, xm = cases["problem"]
        for label, kw in cases["k1"].items():
            out[label] = _solve(g1, xp, xm, 1, **kw)
    return out


def fail_or_hang(group) -> None:
    """Rank 0 raises at once; every other rank hangs."""
    if group.rank == 0:
        raise ValueError("planted failure on rank 0")
    time.sleep(600)


def hang(group) -> None:
    time.sleep(600)


# ------------------------------------------------ the SPMD fit service
# What the ranks of tests/test_torch_mesh_service.py run.  The data is
# that of tests/test_mesh_service.py; C is its chunk.
C = 40


def _svc(mesh=None, **kw):
    from repro_torch.serve.solver_service import SolverService
    return SolverService(chunk_steps=C, mesh=mesh,
                         device=CPU if mesh is None else None, **kw)


def _req(ds, **kw) -> dict:
    return dict(x=ds[0], y=ds[1], **kw)


def _drain(svc, reqs):
    """Rank 0 submits ``reqs`` and drains the service (the results in
    submission order); every other rank follows the plans (None)."""
    from repro_torch.serve.solver_service import FitRequest
    if svc.mesh is not None and svc.mesh.rank:
        assert svc.run() == {}
        return None
    rids = [svc.submit(FitRequest(**r)) for r in reqs]
    res = svc.run()
    return [res[r] for r in rids]


def _record(svc, run) -> dict:
    """``run(svc)`` on this rank with its tallied all-reduces, the set-up
    keys it added and the service's own accounting before and after."""
    before = collections.Counter(engine.collective_counts)
    keys = set(engine.trace_counts)
    held = svc.rank_stats["held_bytes"]
    res = run(svc)
    return dict(res=res, tally=dict(collections.Counter(
        engine.collective_counts) - before), stats=svc.rank_stats,
        new_keys=sorted(set(engine.trace_counts) - keys),
        held=(held, svc.rank_stats["held_bytes"]),
        batches=len(svc._batches))


def _cancel_run(svc, reqs, victim: int):
    """Rank 0: submit, step until request ``victim`` runs, cancel it,
    drain; the others follow."""
    from repro_torch.serve.scheduler import Status
    from repro_torch.serve.solver_service import FitRequest
    if svc.mesh.rank:
        return _drain(svc, reqs)
    rids = [svc.submit(FitRequest(**r)) for r in reqs]
    while svc.status(rids[victim]) is not Status.RUNNING:
        svc.step()
    status = svc.status(rids[victim]).value
    assert svc.cancel(rids[victim])
    res = svc.run()
    return [res[r] for r in rids], status


def _lifecycle(svc, cases):
    """Rank 0's script of every lifecycle path (the others follow both
    drains): a streaming tenant and an append update (warm admission), a
    request poisoned at its chunk 1 and retried, a deadline shed before
    admission, a running request cancelled, a duality-gap stop, a replayed
    schedule, and a 400-point streaming tenant whose append jumps a rung
    (point-sharded when the service shards above 300 points)."""
    from repro_torch.serve.solver_service import FitRequest, UpdateRequest
    if svc.mesh is not None and svc.mesh.rank:
        return [_drain(svc, []), _drain(svc, [])]
    ds1, ds2, big = cases["ds1"], cases["ds2"], cases["big"]
    sub = [svc.submit(FitRequest(**r)) for r in (
        _req(ds1, num_iters=2 * C, seed=1, stream=True),
        _req(ds2, num_iters=3 * C, seed=9, nu=1.0 / (0.85 * 35),
             max_retries=1),
        _req(ds2, num_iters=4 * C, seed=4),
        _req(ds1, num_iters=20 * C, seed=6, eps=0.1, gap_tol=0.5),
        _req(ds2, num_iters=2 * C, seed=7, signs=cases["signs"],
             idx_schedule=cases["schedule"]),
        _req((big[0][:400], big[1][:400]), num_iters=2 * C, seed=11,
             stream=True))]
    shed = svc.submit(FitRequest(**_req(ds1, num_iters=C, seed=3)),
                      deadline=0.5)
    cases["clock"][0] = 1.0
    svc.step()
    running = svc.status(sub[2]).value
    assert svc.cancel(sub[2])
    first = svc.run()
    extra = cases["extra"]
    ups = [svc.submit_update(UpdateRequest(tenant=sub[0], x=extra[0],
                                           y=extra[1])),
           svc.submit_update(UpdateRequest(tenant=sub[5], x=big[0][400:],
                                           y=big[1][400:]))]
    second = svc.run()
    return [first[r] for r in sub + [shed]], running, \
        [second[r] for r in ups]


def _lifecycle_svc(mesh, cases):
    from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan
    cases["clock"] = [0.0]
    shard = {} if mesh is None else dict(shard_points_above=300,
                                         shard_num_slots=2)
    return _svc(mesh, num_slots=4, clock=lambda: cases["clock"][0],
                fault_injector=FaultInjector(FaultPlan(seed=0, faults=(
                    Fault("poison", rid=1, at_chunk=1),))), **shard)


def mesh_service_cases(world, cases: dict) -> dict:
    """Every case of the 4-rank spawn: a one-rank group (rank 0) in both
    placements beside the meshless service, the lanes placement and the
    lifecycle script on ranks 0-1, and on all four ranks the lanes
    placement, a point-sharded fit with its batch-mates (audited), its
    replay of JAX's draws, and its poison and cancel."""
    from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan

    torch.set_num_threads(1)
    g1 = meshlib.sub_group(world, [0])
    g2 = meshlib.sub_group(world, [0, 1])
    ds1, ds2, big = cases["ds1"], cases["ds2"], cases["big"]
    lane_reqs = [_req(ds1, num_iters=3 * C, seed=1),
                 _req(ds2, num_iters=3 * C, seed=9, nu=1.0 / (0.85 * 35))]
    big_req = _req(big, num_iters=3 * C, seed=5, nu=cases["nu_big"])
    out = {"rank": world.rank}
    if g1 is not None:
        for frac in (0.0, 0.85):
            reqs = [_req(ds1, num_iters=3 * C, seed=1,
                         nu=frac and 1.0 / (frac * 40)),
                    _req(ds2, num_iters=2 * C, seed=9,
                         nu=frac and 1.0 / (frac * 35))]
            out["k1 plain", frac] = _drain(_svc(num_slots=4), reqs)
            out["k1 lanes", frac] = _record(
                _svc(g1, num_slots=4), lambda s, r=reqs: _drain(s, r))
        out["k1 plain points"] = _drain(_svc(num_slots=2), lane_reqs)
        out["k1 points"] = _record(
            _svc(g1, num_slots=2, shard_points_above=0, shard_num_slots=2),
            lambda s: _drain(s, lane_reqs))
        out["plain"] = _drain(_svc(num_slots=8), lane_reqs)
        out["plain life"] = _lifecycle(_lifecycle_svc(None, cases), cases)
    if g2 is not None:
        out["lanes k2"] = _record(_svc(g2, num_slots=8),
                                  lambda s: _drain(s, lane_reqs))
        out["life k2"] = _record(_lifecycle_svc(g2, cases),
                                 lambda s: _lifecycle(s, cases))

    def sharded(injector=None, mesh=world):
        return _svc(mesh, num_slots=8, shard_points_above=256,
                    shard_num_slots=2, fault_injector=injector)

    # one chunk of hard-margin fits under the profiler: a lane-placed
    # group alone, then beside a point-sharded one
    short = [_req(ds1, num_iters=C, seed=1), _req(big, num_iters=C, seed=5)]
    runs = {}
    for label, reqs, make in (
            ("lanes k4", short[:1], lambda g: _svc(g, num_slots=8)),
            ("points k4 short", short, lambda g: sharded(mesh=g))):
        def fn(g, label=label, reqs=reqs, make=make):
            svc = make(g)
            runs[label] = _record(svc, lambda s: _drain(s, reqs))
            return svc
        out[label + " audit"] = comm_audit.audit_service(world, fn)
    out.update(runs)
    # the fit at its full budget beside the same fit fed JAX's draws (two
    # lanes of one point-sharded group) and the lane-placed requests
    out["points k4"] = _record(sharded(), lambda s: _drain(
        s, lane_reqs + [big_req, dict(big_req, signs=cases["jax_signs"],
                                      idx_schedule=cases["jax_schedule"])]))
    out["base"] = _record(sharded(), lambda s: _drain(s, lane_reqs))
    plan = FaultPlan(seed=0, faults=(Fault("poison", rid=2, at_chunk=1),))
    out["poison"] = _record(sharded(FaultInjector(plan)),
                            lambda s: _drain(s, lane_reqs + [big_req]))
    out["cancel"] = _record(sharded(), lambda s: _cancel_run(
        s, lane_reqs + [big_req], 2))
    return out
