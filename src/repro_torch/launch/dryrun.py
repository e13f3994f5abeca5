"""The launch dry-run: every (arch x shape), and the solver and serving
entries, at the production meshes' sizes without their machines.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes] [--out DIR]
        [--device cpu]

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
combination for 256 or 512 forced host devices and reads XLA's memory and
cost analyses.  Eager PyTorch compiles nothing, so each entry RUNS, once,
where it allocates nothing or little, and the dry-run counts what it
dispatched.  One JSON record a (arch, shape, mesh) goes to ``--out``,
named and keyed as the JAX dry-run's (``{arch}_{shape}_{single|multi}``;
``"16x16"`` and ``"2x16x16"``).

**LM entries** (:func:`run_one`): the train step, prefill or decode of
``specs.build_lowerable`` runs once inside a ``FakeTensorMode`` on the CPU
(the weights undrawn, nothing allocated, at the published widths) under
``utils.roofline.analyze``.  The port shards no model, so both meshes'
records come from that one run by a stated rule:

* FLOPs a device (``hlo_flops_per_device``) = the run's
  ``FlopCounterMode`` count over 256 or 512;
* HBM bytes a device = every dispatched op's inputs plus outputs (an upper
  bound on traffic: eager ops do not fuse) over the device count;
* argument bytes a device (``memory.argument_size_in_bytes``) = the
  step's parameters, AdamW state, batch and serve state under the copied
  JAX rules (``specs.argument_bytes_per_device``);
* ``temp_size_in_bytes`` is null (eager PyTorch has no compiled temporary
  figure), and so are the collective terms (no LM is sharded);
* compute and memory terms at the H100 data-sheet peaks of
  ``utils.roofline``; ``model_flops_per_device``, ``useful_flops_ratio``
  and ``mfu_bound`` as the JAX dry-run computes them.

There is no ``--unroll``: an eager run dispatches every layer, so the
counts are always those of the unrolled stack (``"unrolled": true``).

**Solver entries** (:func:`run_one_saddle`): one client of k = 256 or 512
on a fake default group (``launch.mesh.init_fake_group``) runs one step
and one chunk of ``distributed.sharded_run_fn`` at its shard shape, under
``utils.dispatch_trace.Trace`` (the profiler shows no event of the fake
backend, so ``comm_audit.measure`` would see nothing).  Its per-iteration
collectives, from the step and from the chunk less a chunk of no step (as
``comm_audit.audit_runner`` derives them), must equal ``CommModel``'s;
a mismatch raises.  A chunk runs ``STEPS_RUN`` of its ``chunk_steps``
steps: the JAX entry lowers the whole loop once, an eager chunk dispatches
every step, and the collectives of a step do not depend on how many run.

**Serving entries** (:func:`run_one_saddle_serve`): ``serve_lanes_512``,
one rank's own lanes (2 at k = 256, 1 at k = 512), must issue no
collective; ``serve_points_1m``, one rank of one model column's group (16
data ranks, or 32 = pod x data; every column's group is made), must match
``ServeCommModel`` per iteration (the chunk of ``STEPS_RUN`` steps less
the chunk of none) and per chunk (the chunk of none).

A fake group is the process's default group, so the solver and serving
entries run in a process of their own: this CLI is one.  The reduced
values mean nothing; the collectives, their sizes and the shapes are this
rank's own.  Their shards live on ``--device``: the card unless ``cpu`` is
asked for (no card raises), so on the card the records count what the
CUDA kernels' path dispatches.  The LM entries allocate nothing on any
device: their fake tensors stand for CPU ones whatever ``--device`` is.
The figures are counts, not times: nothing here measures a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
import traceback

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.shapes import SHAPES, InputShape, applicability
from repro_torch.utils import roofline as rl
from repro_torch.utils.dispatch_trace import Trace

ASSIGNED = [
    "qwen2-vl-7b", "chatglm3-6b", "xlstm-125m", "recurrentgemma-2b",
    "deepseek-v2-236b", "deepseek-v2-lite-16b", "gemma-7b",
    "deepseek-67b", "whisper-medium", "h2o-danube-1.8b",
]
STEPS_RUN = 2          # steps a solver or serving chunk runs


def _tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}_{shape}_{'multi' if multi_pod else 'single'}"


def _multiset(ms) -> dict:
    from repro_torch.utils.comm_audit import multiset_to_json

    return multiset_to_json(dict(ms))


# ------------------------------------------------------------ LM entries
def measure_lm(cfg, shape: InputShape, layouts):
    """One run of ``shape``'s step on ``cfg`` inside a ``FakeTensorMode``
    on the CPU (undrawn weights, nothing allocated): (roofline, argument
    bytes a device by layout name, build seconds, run seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        t0 = time.perf_counter()
        fn, args = specs_mod.build_lowerable(cfg, shape, "cpu")
        args_bytes = {lay.name: specs_mod.argument_bytes_per_device(
            cfg, shape.kind, args, lay) for lay in layouts}
        build_s = time.perf_counter() - t0
        roof = rl.analyze(fn, *args)
        run_s = time.perf_counter() - t0 - build_s
    return roof, args_bytes, build_s, run_s


def lm_record(arch: str, cfg, shape: InputShape, layout, roof,
              args_bytes: int, build_s: float, run_s: float) -> dict:
    """The record of one mesh from one run (the module doc's rule)."""
    n = layout.size
    flops, hbm = roof.flops / n, roof.hbm_bytes / n
    compute_s, memory_s = roof.compute_s / n, roof.memory_s / n
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mflops = rl.model_flops(cfg, shape.kind, tokens) / n
    step_s = max(compute_s, memory_s)
    return {
        "lower_s": round(build_s, 2), "compile_s": None,
        "run_s": round(run_s, 2),
        "memory": {"argument_size_in_bytes": args_bytes,
                   "temp_size_in_bytes": None},
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": hbm,
        "collective_bytes_per_device": None,
        "collective_breakdown": None,
        "collective_counts": None,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": None,
        "bottleneck": "compute" if compute_s >= memory_s else "memory",
        "model_flops_per_device": mflops,
        "useful_flops_ratio": mflops / flops if flops else 0.0,
        "mfu_bound": mflops / (step_s * rl.PEAK_FLOPS) if step_s else 0.0,
    }


def run_one(arch: str, shape_name, meshes, verbose: bool = True,
            cfg=None) -> list[dict]:
    """``arch`` x ``shape_name`` once, fake, and its record on each mesh
    of ``meshes`` (multi_pod flags); a skip record on each where
    ``applicability`` says so.  ``cfg`` overrides the registered config
    (the tests' reduced ones)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, reason = applicability(cfg, shape)
    layouts = [meshlib.production_layout(mp) for mp in meshes]
    recs = [{"arch": arch, "shape": shape.name, "mesh": lay.name,
             "applicable": ok, "reason": reason, "unrolled": True}
            for lay in layouts]
    if not ok:
        if verbose:
            for rec in recs:
                print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}: "
                      f"SKIP ({reason})")
        return recs
    roof, args_bytes, build_s, run_s = measure_lm(cfg, shape, layouts)
    for rec, lay in zip(recs, layouts):
        rec.update(lm_record(arch, cfg, shape, lay, roof,
                             args_bytes[lay.name], build_s, run_s))
        if verbose:
            print(f"[dryrun] {arch} x {shape.name} x {lay.name}: OK  "
                  f"args {rec['memory']['argument_size_in_bytes'] / 2**30:.2f}"
                  f" GiB/dev  flops {rec['hlo_flops_per_device']:.3e}/dev  "
                  f"compute {rec['compute_s'] * 1e3:.2f} ms  memory "
                  f"{rec['memory_s'] * 1e3:.2f} ms  -> "
                  f"{rec['bottleneck']}-bound  (build {build_s:.1f}s run "
                  f"{run_s:.1f}s, fake)")
    return recs


# ------------------------------------------------- solver and serving entries
def _traced(fn) -> Trace:
    with Trace() as tr:
        fn()
    return tr


def _per_step(chunk, none, steps: int) -> collections.Counter:
    """One step's collectives of a chunk of ``steps`` steps, from it and a
    chunk of none; raises unless the difference splits into equal
    steps."""
    extra = chunk - none
    if none - chunk or any(v % steps for v in extra.values()):
        raise ValueError(f"collectives {dict(extra)} over {steps} steps do "
                         "not split into equal steps")
    return collections.Counter({k: v // steps for k, v in extra.items()})


def _arg_bytes(args) -> int:
    """Bytes of a rank's arguments: its own shard, so a device's."""
    return sum(t.numel() * t.element_size()
               for _, t in specs_mod.tensor_leaves(args))


def _flops_trace(fn):
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, Trace() as tr:
        fn()
    return float(counter.get_total_flops()), tr


def saddle_step_fn(group, args, meta):
    """One packed client step (``engine._step_packed_core`` with the
    group's hooks) on the runner's state and first block."""
    from repro_torch.core import engine

    state, x_t, sign, idx = args
    sc = engine.stack_slot_params([engine.slot_params_row(meta["params"])],
                                  x_t.device)
    all_sum, all_max = engine.group_hooks(group)

    def step():
        engine._step_packed_core(
            state, x_t, sign, sc, d=meta["d"], block_size=meta["block_size"],
            project=meta["nu"] > 0, idx=idx[:1], all_sum=all_sum,
            all_max=all_max)
    return step


def run_one_saddle(shape_name: str, multi_pod: bool, verbose: bool = True,
                   device=None) -> dict:
    """One client of the Saddle-DSVC entry on a fake group of the mesh's
    size, its shard on ``device`` (the card unless the CPU is asked for):
    its collectives a step and a chunk against ``CommModel`` (Theorem 8).
    Raises on a mismatch."""
    shape = specs_mod.SADDLE_DSVC_SHAPES[shape_name]
    layout = meshlib.production_layout(multi_pod)
    rec = {"arch": specs_mod.SOLVER_ARCH, "shape": shape_name,
           "mesh": layout.name, "applicable": True, "reason": "ok"}
    world = meshlib.init_fake_group(layout.size, device)
    try:
        t0 = time.perf_counter()
        fn, args, meta = specs_mod.build_saddle_dsvc_runner(world, shape)
        state, x_t, sign, idx = args
        build_s = time.perf_counter() - t0
        step = _traced(saddle_step_fn(world, args, meta))
        none = _traced(lambda: fn(state, x_t, sign, idx[:0]))
        flops, chunk = _flops_trace(
            lambda: fn(state, x_t, sign, idx[:STEPS_RUN]))
        run_s = time.perf_counter() - t0 - build_s
    finally:
        torch.distributed.destroy_process_group()

    model = meta["model"]
    predicted = collections.Counter(model.collective_multiset(
        meta["block_size"]))
    per_iter = step.collective_multiset()
    runner_iter = _per_step(chunk.collective_multiset(),
                            none.collective_multiset(), STEPS_RUN)
    coll = chunk.collective_stats()
    rec.update({
        "lower_s": round(build_s, 2), "compile_s": None,
        "run_s": round(run_s, 2),
        "memory": {"argument_size_in_bytes": _arg_bytes(args),
                   "temp_size_in_bytes": None},
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": float(chunk.nbytes),
        "collective_bytes_per_device": float(coll.total_bytes),
        "collective_breakdown": coll.bytes_by_op,
        "collective_counts": coll.count_by_op,
        "comm_audit": {
            "k": meta["k"], "nu": meta["nu"],
            "block_size": meta["block_size"],
            "chunk_steps": meta["chunk_steps"], "steps_run": STEPS_RUN,
            "n_pad": meta["n_pad"], "d": meta["d"],
            "device": x_t.device.type,
            "measured_per_iteration": _multiset(per_iter),
            "predicted_per_iteration": _multiset(predicted),
            "runner_per_iteration": _multiset(runner_iter),
            "match": per_iter == predicted and runner_iter == predicted,
            "per_iteration_count": sum(per_iter.values()),
            "per_iteration_bytes": sum(c.nbytes for c in step.collectives),
            "per_chunk": _multiset(none.collective_multiset()),
            "model_scalars_per_iteration": model.scalars_per_iteration(),
        },
    })
    ca = rec["comm_audit"]
    if not ca["match"]:
        raise RuntimeError(
            f"saddle-dsvc {shape_name} x {layout.name}: measured "
            f"collectives a step {ca['measured_per_iteration']}, a chunk's "
            f"step {ca['runner_per_iteration']} != CommModel "
            f"{ca['predicted_per_iteration']}")
    if verbose:
        print(f"[dryrun] {specs_mod.SOLVER_ARCH} x {shape_name} x "
              f"{layout.name}: OK  k={ca['k']}  n_pad={ca['n_pad']} "
              f"d={ca['d']} b={ca['block_size']}  collectives/iter "
              f"{ca['per_iteration_count']} (model "
              f"{model.collectives_per_iteration(meta['block_size'])})  "
              f"bytes/iter {ca['per_iteration_bytes']}  Theorem8 "
              f"scalars/iter {ca['model_scalars_per_iteration']:.0f}  "
              f"(build {build_s:.1f}s run {run_s:.1f}s, {ca['device']})")
    return rec


def run_one_saddle_serve(shape_name: str, multi_pod: bool,
                         verbose: bool = True, device=None) -> dict:
    """One rank of the serving entry on a fake group of the mesh's size,
    its shard on ``device`` (the card unless the CPU is asked for): the
    lanes placement must issue no collective, the points placement must
    match ``ServeCommModel`` per iteration and per chunk.  Raises on a
    mismatch."""
    shape = specs_mod.SADDLE_SERVE_SHAPES[shape_name]
    layout = meshlib.production_layout(multi_pod)
    rec = {"arch": specs_mod.SERVE_ARCH, "shape": shape_name,
           "mesh": layout.name, "applicable": True, "reason": "ok"}
    world = meshlib.init_fake_group(layout.size, device)
    try:
        t0 = time.perf_counter()
        fn, args, meta = specs_mod.build_saddle_serve_runner(world, layout,
                                                             shape)
        build_s = time.perf_counter() - t0
        none = _traced(lambda: fn(*args, 0))
        flops, chunk = _flops_trace(lambda: fn(*args, STEPS_RUN))
        run_s = time.perf_counter() - t0 - build_s
    finally:
        torch.distributed.destroy_process_group()

    model = meta["model"]
    if model is not None:
        predicted = collections.Counter(model.collective_multiset(
            meta["block_size"]))
        predicted_chunk = collections.Counter(model.per_chunk_multiset(
            meta["d"]))
    else:
        predicted, predicted_chunk = collections.Counter(), \
            collections.Counter()
    per_chunk = none.collective_multiset()
    per_iter = _per_step(chunk.collective_multiset(), per_chunk, STEPS_RUN)
    step_bytes = (sum(c.nbytes for c in chunk.collectives)
                  - sum(c.nbytes for c in none.collectives)) // STEPS_RUN
    rec.update({
        "lower_s": round(build_s, 2), "compile_s": None,
        "run_s": round(run_s, 2),
        "memory": {"argument_size_in_bytes": _arg_bytes(args),
                   "temp_size_in_bytes": None},
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": float(chunk.nbytes),
        "collective_bytes_per_device": float(
            chunk.collective_stats().total_bytes),
        "comm_audit": {
            "slot_axes": list(meta["slot_axes"]),
            "point_axes": list(meta["point_axes"]),
            "k_slots": meta["k_slots"], "k_points": meta["k_points"],
            "nu": meta["nu"], "num_slots": meta["num_slots"],
            "n_pad": meta["n_pad"], "lanes_per_rank": meta["lanes"],
            "rank_n_pad": meta["rank_n_pad"], "d": meta["d"],
            "block_size": meta["block_size"],
            "chunk_steps": meta["chunk_steps"], "steps_run": STEPS_RUN,
            "device": args[1].device.type,
            "measured_per_iteration": _multiset(per_iter),
            "predicted_per_iteration": _multiset(predicted),
            "measured_per_chunk": _multiset(per_chunk),
            "predicted_per_chunk": _multiset(predicted_chunk),
            "match": per_iter == predicted and per_chunk == predicted_chunk,
            "per_iteration_count": sum(per_iter.values()),
            "per_iteration_bytes": step_bytes,
        },
    })
    ca = rec["comm_audit"]
    if not ca["match"]:
        raise RuntimeError(
            f"saddle-serve {shape_name} x {layout.name}: measured "
            f"collectives iter={ca['measured_per_iteration']} chunk="
            f"{ca['measured_per_chunk']} != model iter="
            f"{ca['predicted_per_iteration']} chunk="
            f"{ca['predicted_per_chunk']}")
    if verbose:
        placement = (f"slots/{'x'.join(ca['slot_axes']) or '-'} "
                     f"points/{'x'.join(ca['point_axes']) or '-'}")
        print(f"[dryrun] {specs_mod.SERVE_ARCH} x {shape_name} x "
              f"{layout.name}: OK  {placement}  S={ca['num_slots']} "
              f"n_pad={ca['n_pad']}  this rank {ca['lanes_per_rank']} "
              f"lanes x {ca['rank_n_pad']} points  collectives/iter "
              f"{ca['per_iteration_count']}  bytes/iter "
              f"{ca['per_iteration_bytes']}  (build {build_s:.1f}s run "
              f"{run_s:.1f}s, {ca['device']})")
    return rec


# ------------------------------------------------------------------- CLI
def combos(arch: str | None, shape: str | None) -> list[tuple[str, str]]:
    """The (arch, shape) pairs a CLI call covers (the JAX dry-run's
    rule)."""
    if shape and shape not in SHAPES \
            and shape not in specs_mod.SADDLE_DSVC_SHAPES \
            and shape not in specs_mod.SADDLE_SERVE_SHAPES:
        raise SystemExit(
            f"unknown --shape {shape!r}: LM shapes {sorted(SHAPES)}, "
            f"solver shapes {sorted(specs_mod.SADDLE_DSVC_SHAPES)}, "
            f"serve shapes {sorted(specs_mod.SADDLE_SERVE_SHAPES)}")
    solver_only = arch == specs_mod.SOLVER_ARCH
    serve_only = arch == specs_mod.SERVE_ARCH
    archs = [] if (solver_only or serve_only) \
        else ([arch] if arch else ASSIGNED)
    lm_shapes = ([shape] if shape in SHAPES
                 else [] if shape else list(SHAPES))
    out = [(a, s) for a in archs for s in lm_shapes]
    if not arch and not shape:
        out.append(("gemma-7b-swa", "long_500k"))
    for entry, table, only in (
            (specs_mod.SOLVER_ARCH, specs_mod.SADDLE_DSVC_SHAPES,
             solver_only),
            (specs_mod.SERVE_ARCH, specs_mod.SADDLE_SERVE_SHAPES,
             serve_only)):
        if only or arch is None:
            names = ([shape] if shape in table
                     else [] if shape else list(table))
            out += [(entry, s) for s in names]
    if not out:
        raise SystemExit(
            f"no (arch, shape) combinations: --arch {arch!r} does not "
            f"take --shape {shape!r}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None,
                    help=f"one of {list_configs()} + "
                         f"'{specs_mod.SOLVER_ARCH}' + "
                         f"'{specs_mod.SERVE_ARCH}' (default: all assigned)")
    ap.add_argument("--shape", default=None,
                    help=f"one of {sorted(SHAPES)} (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="the solver and serving shards' device: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)      # raises for cuda without one
    pairs = combos(args.arch, args.shape)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.perf_counter()
    for arch, shape in pairs:
        try:
            if arch == specs_mod.SOLVER_ARCH:
                recs = [run_one_saddle(shape, mp, device=device)
                        for mp in meshes]
            elif arch == specs_mod.SERVE_ARCH:
                recs = [run_one_saddle_serve(shape, mp, device=device)
                        for mp in meshes]
            else:
                recs = run_one(arch, shape, meshes)
        except Exception as e:      # noqa: BLE001
            traceback.print_exc()
            recs = [{"arch": arch, "shape": shape,
                     "mesh": meshlib.production_layout(mp).name,
                    "error": str(e)}
                    for mp in meshes]
            failures += [_tag(arch, shape, mp) for mp in meshes]
        for mp, rec in zip(meshes, recs):
            with open(os.path.join(args.out, _tag(arch, shape, mp)
                                   + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    print(f"[dryrun] {len(pairs) * len(meshes)} records in "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run complete: every combination ran")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
