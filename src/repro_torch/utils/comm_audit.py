"""Communication audit: Theorem 8 against the collectives a process group
really issues.

Counterpart of ``repro.utils.comm_audit``.  The JAX package lowers the
sharded step to HLO and counts the all-reduces XLA emits; here the step
runs on a real ``torch.distributed`` group (``launch.mesh.ClientGroup``)
inside ``torch.profiler.profile(record_shapes=True)``, and the audit
counts the backend's collective events (``gloo:all_reduce`` /
``nccl:all_reduce``, and any other ``gloo:`` / ``nccl:`` collective) with
their payload shapes.  The profiler does not name the reduce op, so each
event is paired, in issue order, with what the group hooks report to the
group's :class:`Recorder` (``ClientGroup.recorder``): a measurement
agrees with the hooks only if every event is an all-reduce of the
reported size, and the multiset equals the hooks' tally
(``engine.collective_counts``).  An all-reduce issued outside the hooks
therefore breaks ``match``.

* :func:`audit_runner` -- ONE step of the packed client step and ONE
  chunk of the runner (``distributed.sharded_run_fn``) against
  ``CommModel``.  The chunk's per-iteration multiset is that of a chunk of
  ``chunk_steps`` steps less that of a chunk of none (which is the
  boundary's objective sum alone), divided by ``chunk_steps``.
* :func:`audit_serve` -- the serving chunk in one placement
  (``engine.run_chunk_slots_sharded``): "lanes" must issue nothing at all,
  "points" exactly ``ServeCommModel``, per iteration and per chunk.
* :func:`run_specs` / :func:`collect_audits` -- a batch of audits on
  subgroups of one group of spawned processes.

Record keys follow the JAX package's (``multiset_to_json`` keys
``"op|kind|elements"``).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed, engine, projections, saddle
from repro_torch.core import preprocess as pp
from repro_torch.launch import mesh as meshlib

BACKEND_PREFIXES = ("gloo:", "nccl:")
SEED = 0            # the audits' data and draws


def _key_str(key: tuple) -> str:
    op, kind, elems = key
    return f"{op}|{kind}|{elems}"


def multiset_to_json(ms: dict) -> dict:
    return {_key_str(k): v for k, v in sorted(ms.items())}


class Recorder:
    """What the group hooks of a ``ClientGroup(recorder=...)`` report:
    ``log``, each all-reduce's (kind, elements, bytes per element) in
    issue order, and ``seconds``, their time between two device
    synchronisations (``engine.group_hooks``), summed."""

    def __init__(self):
        self.log: list = []
        self.seconds = 0.0

    def __call__(self, kind: str, elements: int, size: int,
                 seconds: float) -> None:
        self.log.append((kind, elements, size))
        self.seconds += seconds


class Measured(NamedTuple):
    """The collectives one call issued: the profiler's events and the
    group hooks' log and tally over the same window."""
    events: list       # [(op, elements)] in issue order (profiler)
    log: list          # [(kind, elements, bytes per element)] (hooks)
    tally: dict        # engine.collective_counts over the window

    @property
    def multiset(self) -> dict:
        """(op, kind, elements) -> count, the kind from the paired log
        entry ("unlogged" for an event with none)."""
        ms = collections.Counter()
        for i, (op, elems) in enumerate(self.events):
            kind = self.log[i][0] if i < len(self.log) else "unlogged"
            ms[op, kind, elems] += 1
        return dict(ms)

    @property
    def nbytes(self) -> int:
        return sum(e * size for _, e, size in self.log)

    @property
    def agrees(self) -> bool:
        """Every event pairs with a hook call of its size, and the
        measured multiset is the hooks' tally."""
        return (len(self.events) == len(self.log)
                and all(op == "all-reduce" and e == le for (op, e), (_, le, _)
                        in zip(self.events, self.log))
                and self.multiset == self.tally)


def measure(group: meshlib.ClientGroup, fn) -> Measured:
    """Run ``fn(g)`` under the profiler, ``g`` being ``group`` with a
    fresh :class:`Recorder`, and return its collectives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = collections.Counter(engine.collective_counts)
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn(group._replace(recorder=rec))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    tally = dict(collections.Counter(engine.collective_counts) - before)
    events = sorted(
        (ev.time_range.start, ev.name.split(":", 1)[1].replace("_", "-"),
         int(np.prod(ev.input_shapes[0])))
        for ev in prof.events()
        if ev.device_type == DeviceType.CPU
        and ev.name.startswith(BACKEND_PREFIXES) and ev.input_shapes)
    return Measured(events=[(op, e) for _, op, e in events], log=rec.log,
                    tally=tally)


def _per_step(total: Measured, fixed: Measured, steps: int) -> tuple:
    """(multiset, bytes) of one step of a chunk of ``steps`` steps, from
    the chunk and a chunk of none; raises if the difference does not
    divide into equal steps."""
    ms_t, ms_f = total.multiset, fixed.multiset
    out = {}
    for key in set(ms_t) | set(ms_f):
        extra = ms_t.get(key, 0) - ms_f.get(key, 0)
        if extra < 0 or extra % steps:
            raise ValueError(f"{key}: {extra} collectives over {steps} "
                             "steps do not split into equal steps")
        if extra:
            out[key] = extra // steps
    return out, (total.nbytes - fixed.nbytes) // steps


def _rounds(nu: float) -> float:
    return float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0


def _problem(n1: int, n2: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n1, d)).astype(np.float32),
            rng.normal(size=(n2, d)).astype(np.float32))


def fresh_slot_batch(problems, n_pad: int, d: int,
                     rows: list[engine.SlotParams], seeds: list[int],
                     max_t: int, device: torch.device):
    """A slot batch whose lane i holds ``problems[i] = (xp, xm)``
    (preprocessed float32 tensors on ``device``) freshly initialised, with
    step scalars ``rows[i]`` (``engine.slot_params_row``), a sampler
    seeded with ``seeds[i]`` and the budget ``max_t``.  Returns (state,
    x_t (S, d, n_pad), sign (S, n_pad), sp)."""
    s = len(problems)
    state = engine.init_slot_state(s, n_pad, d, device)
    x_t = torch.zeros((s, d, n_pad), dtype=torch.float32, device=device)
    sign = torch.zeros((s, n_pad), dtype=torch.float32, device=device)
    for lane, (xp, xm) in enumerate(problems):
        pts = pp.pack_points_to(xp, xm, n_pad, d)
        x_t[lane], sign[lane] = pts.x_t, pts.sign
        engine.admit_into_slot(
            state, lane, engine.init_packed_state(pts.sign, pts.n1, pts.n2,
                                                  d),
            torch.Generator(device=device).manual_seed(seeds[lane]), max_t)
    return state, x_t, sign, engine.stack_slot_params(rows, device)


def audit_runner(group: meshlib.ClientGroup, *, n1: int, n2: int, d: int,
                 nu: float, block_size: int = 1,
                 chunk_steps: int = 8) -> dict:
    """Measured collectives of one packed client step and of one runner
    chunk on ``group``, against ``CommModel`` (see the module doc)."""
    k, dev = group.size, group.device
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu,
                                block_size=block_size)
    model = distributed.CommModel(k=k, nu_rounds_per_iter=_rounds(nu))
    predicted = model.collective_multiset(block_size)

    xp, xm = _problem(n1, n2, d, SEED)
    xp_sh, mask_p = distributed.shard_points(xp, k)
    xm_sh, mask_m = distributed.shard_points(xm, k)
    x_t, sign = distributed.pack_shards(xp_sh, mask_p, xm_sh, mask_m)
    rows = slice(group.rank, group.rank + 1)
    x_t = torch.as_tensor(x_t[rows], device=dev)
    sign = torch.as_tensor(sign[rows], device=dev)
    state = engine.init_packed_state(sign, n1, n2, d)
    idx = engine.draw_blocks(torch.Generator(device=dev).manual_seed(SEED),
                             d, block_size, chunk_steps, dev)
    sc = engine.stack_slot_params([engine.slot_params_row(params)], dev)

    def one_step(g):
        all_sum, all_max = engine.group_hooks(g)
        engine._step_packed_core(
            state, x_t, sign, sc, d=d, block_size=block_size,
            project=nu > 0, idx=idx[:1], all_sum=all_sum, all_max=all_max)

    def run(steps):
        return lambda g: distributed.sharded_run_fn(
            g, params=params, chunk_steps=chunk_steps)(state, x_t, sign,
                                                       idx[:steps])

    step = measure(group, one_step)
    none = measure(group, run(0))
    chunk = measure(group, run(chunk_steps))
    runner_iter, _ = _per_step(chunk, none, chunk_steps)
    agrees = step.agrees and none.agrees and chunk.agrees
    return {
        "k": k, "n1": n1, "n2": n2, "d": d, "nu": nu,
        "block_size": block_size, "backend": dist.get_backend(group.group),
        "predicted": multiset_to_json(predicted),
        "measured": multiset_to_json(step.multiset),
        "match": agrees and step.multiset == predicted,
        "hooks_agree": agrees,
        "per_iteration_count": sum(step.multiset.values()),
        "per_iteration_bytes": step.nbytes,
        "model_collectives": model.collectives_per_iteration(block_size),
        "model_payload_bytes":
            4 * model.payload_elements_per_iteration(block_size),
        "model_scalars": model.scalars_per_iteration(),
        "chunk_steps": chunk_steps,
        "runner_measured": multiset_to_json(runner_iter),
        "runner_per_chunk": multiset_to_json(none.multiset),
        "runner_match": agrees and runner_iter == predicted,
        "runner_matches_step": runner_iter == step.multiset,
    }


def audit_serve(group: meshlib.ClientGroup, *, placement: str,
                num_slots: int, n1: int, n2: int, d: int, nu: float,
                block_size: int = 1, chunk_steps: int = 8) -> dict:
    """Measured collectives of one serving chunk of ``num_slots`` lanes
    (the whole batch) on ``group`` in ``placement``: none at all for
    "lanes"; ``ServeCommModel`` per iteration and per chunk for
    "points"."""
    k, dev = group.size, group.device
    # the JAX service's buckets: k shards of a rung each for "points"
    n_pad = (k * pp.bucket_length(-(-(n1 + n2) // k)) if placement == "points"
             else pp.bucket_length(n1 + n2))
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu,
                                block_size=block_size)
    problems = [tuple(torch.as_tensor(a, device=dev)
                      for a in _problem(n1, n2, d, SEED + lane))
                for lane in range(num_slots)]
    batch = fresh_slot_batch(
        problems, n_pad, d, [engine.slot_params_row(params)] * num_slots,
        [SEED + lane for lane in range(num_slots)], 1 << 30, dev)
    local = engine.shard_slot_batch(group, placement, *batch)

    def run(steps):
        return lambda g: engine.run_chunk_slots_sharded(
            *local, steps, mesh=g, placement=placement,
            chunk_steps=chunk_steps, d=d, block_size=block_size,
            project=nu > 0)

    none = measure(group, run(0))
    chunk = measure(group, run(chunk_steps))
    per_iter, nbytes = _per_step(chunk, none, chunk_steps)
    if placement == "points":
        model = distributed.ServeCommModel(k=k, num_slots=num_slots,
                                           nu_rounds_per_iter=_rounds(nu))
        want_iter = model.collective_multiset(block_size)
        want_chunk = model.per_chunk_multiset(d)
    else:
        model, want_iter, want_chunk = None, {}, {}
    agrees = none.agrees and chunk.agrees
    rec = {
        "kind": "serve", "k": k, "num_slots": num_slots, "n1": n1,
        "n2": n2, "n_pad": n_pad, "d": d, "nu": nu,
        "block_size": block_size, "chunk_steps": chunk_steps,
        "placement": placement, "sharded": placement == "points",
        "backend": dist.get_backend(group.group),
        "predicted": multiset_to_json(want_iter),
        "measured": multiset_to_json(per_iter),
        "predicted_per_chunk": multiset_to_json(want_chunk),
        "measured_per_chunk": multiset_to_json(none.multiset),
        "match": (agrees and per_iter == want_iter
                  and none.multiset == want_chunk),
        "hooks_agree": agrees,
        "per_iteration_count": sum(per_iter.values()),
        "per_iteration_bytes": nbytes,
    }
    if model is not None:
        rec["model_collectives"] = model.collectives_per_iteration(
            block_size)
        rec["model_payload_bytes"] = \
            4 * model.payload_elements_per_iteration(block_size)
    return rec


def audit_spec(group: meshlib.ClientGroup, spec: dict) -> dict:
    """One audit from a spec: keys n1, n2, d, nu, block_size, chunk_steps;
    ``kind="serve"`` adds placement and num_slots (``k`` names the group
    and is not passed on)."""
    kw = {key: v for key, v in spec.items() if key not in ("k", "kind")}
    if spec.get("kind") == "serve":
        return audit_serve(group, **kw)
    return audit_runner(group, **kw)


def run_specs(world: meshlib.ClientGroup, specs: list[dict]) -> list:
    """Every spec on the subgroup of the first ``spec["k"]`` ranks of
    ``world`` (the default group); records in spec order, None where this
    rank is outside the spec's subgroup."""
    groups = {}
    for k in sorted({int(s["k"]) for s in specs}):
        if k > world.size:
            raise ValueError(f"spec k={k} > the group's {world.size} ranks")
        groups[k] = (world if k == world.size
                     else meshlib.sub_group(world, range(k)))
    return [None if groups[int(s["k"])] is None
            else audit_spec(groups[int(s["k"])], s) for s in specs]


def collect_audits(specs: list[dict], *, backend: str, device,
                   timeout_s: float) -> list:
    """Run a batch of audit specs on max(k) spawned ranks
    (``launch.mesh.spawn_clients``, whose arguments ``backend``, ``device``
    and ``timeout_s`` are) and return the records of rank 0 (a member of
    every subgroup).  Raises if another member's record of a spec differs
    from rank 0's."""
    if not specs:
        return []
    k = max(int(s["k"]) for s in specs)
    per_rank = meshlib.spawn_clients(run_specs, k, backend=backend,
                                     device=device, timeout_s=timeout_s,
                                     args=(specs,))
    for rank, recs in enumerate(per_rank[1:], start=1):
        for want, got in zip(per_rank[0], recs):
            if got is not None and got != want:
                raise RuntimeError(f"rank {rank} measured {got}, rank 0 "
                                   f"{want}")
    return per_rank[0]
