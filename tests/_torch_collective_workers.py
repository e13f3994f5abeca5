"""What the spawned ranks of tests/test_torch_collectives.py run.

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
