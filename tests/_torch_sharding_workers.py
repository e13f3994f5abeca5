"""What the spawned gloo ranks of tests/test_torch_sharded_train.py and the
child process of tests/test_torch_sharding.py run.

A spawned process imports a function by its module path, so these live
in an importable module rather than in a test file.  Everything crosses
the process boundary as numpy."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed

from repro_torch.configs import get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs
from repro_torch.models import moe
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import steps

LR, WARMUP_STEPS = 1e-3, 10          # the JAX launcher's AdamWConfig


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _whole_model(cfg, named: dict) -> tf.LM:
    """The port's model on the CPU with the named numpy weights."""
    model = tf.LM(cfg, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(named[name], np.float32)))
    return model


def _whole_rows(mesh, t: torch.Tensor, batch: int) -> torch.Tensor:
    """``sharding.batch_rows``' inverse: the whole batch of ``batch`` rows
    from each rank's (all-gathered over ``data`` where it split them)."""
    if t.shape[0] == batch:
        return t
    group = mesh.groups["data"]
    out = t.new_empty((group.size * t.shape[0],) + t.shape[1:])
    torch.distributed.all_gather_into_tensor(out, t.contiguous(),
                                             group=group.group)
    return out


def _moe_drops(mesh, model: tf.LM, tokens: int) -> list:
    """Each MoE layer's dropped choices of its last forward, (groups,
    tokens a group x top-k) over the whole batch of ``tokens`` tokens:
    gathered over ``data`` where each rank routed its own groups."""
    groups = moe.num_groups(tokens)
    out = []
    for block in model.layers:
        if isinstance(block.mlp, moe.MoE):
            d = block.mlp.dropped.to(torch.int32)
            if mesh is not None:
                d = _whole_rows(mesh, d, groups)
            out.append(d.bool().numpy())
    return out


def _case(mesh, params: dict, case: dict) -> dict:
    """One config on ``mesh`` from the whole weights ``params``: the
    gathered forward logits of
    ``case["tokens"]``, this rank's bytes, the losses of the launcher's
    steps over ``case["batches"]`` and the trained parameters gathered
    whole by ``sharding.whole``; for a MoE config what a forward without
    the whole batch's row count raises, and the logits of the first row
    alone as a batch of one, whole on every rank (and, with
    ``case["dtensor"]``, whether
    DTensor gathers each block over ``mesh.device_mesh`` by
    ``sharding.to_placements`` to the same tensor)."""
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case.get("changes", {}))
    shd.set_mesh_axes(mesh)
    try:
        model = shd.distribute(_whole_model(cfg, params), mesh,
                               fsdp=cfg.fsdp_params,
                               embed_fsdp=cfg.embed_fsdp)
        tokens = torch.as_tensor(case["tokens"])
        vocab = (None, None, cfg.padded_vocab)
        with torch.no_grad():
            logits, _ = model(shd.batch_rows(tokens),
                              batch_size=tokens.shape[0])
            logits = _whole_rows(mesh, shd.gather(
                logits, "batch", None, "vocab", shape=vocab),
                tokens.shape[0])
        dropped = _moe_drops(mesh, model, tokens.numel())
        moe_out = {}
        if cfg.moe_num_experts:
            with torch.no_grad():
                try:
                    model(shd.batch_rows(tokens))
                    moe_out["unsized"] = None
                except ValueError as e:
                    moe_out["unsized"] = str(e)
                one, _ = model(tokens[:1], batch_size=1)
                moe_out["one_row"] = shd.gather(
                    one, "batch", None, "vocab", shape=vocab).numpy()
        ocfg = opt.AdamWConfig(lr=LR, warmup_steps=WARMUP_STEPS,
                               state_dtype=cfg.optimizer_state_dtype)
        state = steps.TrainState(steps.trainable(model),
                                 opt.init(model, ocfg))
        want = specs.train_state_bytes_per_device(cfg, mesh.layout)
        out = {"rank": mesh.rank,
               "param_bytes": _nbytes(model.parameters()),
               "state_bytes": [_nbytes(t.values()) for t in
                               (state.opt_state.master, state.opt_state.m,
                                state.opt_state.v)],
               "want_param_bytes": want["params"],
               "want_state_bytes": [want[k] for k in ("master", "m", "v")]}
        train_step = steps.make_train_step(cfg, ocfg)
        losses = []
        for tok, tgt in case["batches"]:
            batch = {"tokens": shd.batch_rows(torch.as_tensor(tok)),
                     "targets": shd.batch_rows(torch.as_tensor(tgt)),
                     "batch_size": len(tok)}
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
        out["losses"] = losses
        whole = {n: shd.whole(p) for n, p in model.named_parameters()}
        if case.get("dtensor"):
            from torch.distributed.tensor import DTensor

            names = mesh.layout.axis_names
            via = {n: DTensor.from_local(
                p.detach(), mesh.device_mesh,
                shd.to_placements(p.spec, names)).full_tensor()
                for n, p in model.named_parameters()}
            out["dtensor_equal"] = all(torch.equal(via[n], whole[n])
                                       for n in whole)
        if mesh.rank == 0:
            out["logits"] = logits.numpy()
            out["dropped"] = dropped
            out.update(moe_out)
            out["trained"] = {n: t.numpy() for n, t in whole.items()}
        return out
    finally:
        shd.set_mesh_axes(None)


def sharded_cases(world, params: dict, cases: dict, sub_ranks: list
                  ) -> dict:
    """Every rank: the (2, 4) mesh of all 8 ranks runs ``cases["all"]``,
    then the (1, 2) mesh of ``sub_ranks`` (a ``sub_group``) runs
    ``cases["sub"]``, each case from the weights in the ``.npz`` file
    ``params[case["weights"]]`` (numpy by the port's names).  Returns each
    case's result (and its seconds) by name and layout."""
    torch.set_num_threads(1)
    big = meshlib.make_test_mesh(world)
    small = meshlib.make_test_mesh(world, ranks=sub_ranks)
    out = {"layouts": (big.layout, None if small is None else small.layout)}
    for where, mesh in (("all", big), ("sub", small)):
        for name, case in cases[where].items() if mesh is not None else ():
            t0 = time.perf_counter()
            with np.load(params[case["weights"]]) as weights:
                out[(where, name)] = _case(mesh, dict(weights), case)
            out[(where, name)]["seconds"] = time.perf_counter() - t0
    return out


def fake_group_checks() -> dict:
    """In a child process: on a fake group of 2 ranks, what each family
    raises when placed on the (1, 2) mesh (None: it placed), and the
    collectives ``dispatch_trace.Trace`` records of DTensor's
    redistributions and of the functional collectives."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.utils import dispatch_trace

    world = meshlib.init_fake_group(2, "cpu")
    try:
        mesh = meshlib.make_test_mesh(world)
        raised = {}
        for arch in ("deepseek-v2-lite-16b", "deepseek-v2-236b",
                     "xlstm-125m", "whisper-medium", "qwen2-vl-7b",
                     "recurrentgemma-2b"):
            try:
                tf.init_lm(get_config(arch).reduced(), 0, "cpu", mesh=mesh)
                raised[arch] = None
            except NotImplementedError as e:
                raised[arch] = str(e)
        dm = mesh.device_mesh
        t = torch.ones(4, 6)
        line = dm["model"]
        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        scatter = getattr(funcol, "reduce_scatter_single", None) \
            or funcol.reduce_scatter_tensor
        with dispatch_trace.Trace() as tr:
            outs = [funcol.all_reduce(t, "sum", line),
                    funcol.all_reduce(t, "max", line),
                    gather(t, 0, line), scatter(t, "sum", 0, line)]
            d = DTensor.from_local(t, dm, [Replicate(), Shard(0)])
            outs.append(d.redistribute(dm, [Replicate(), Replicate()])
                        .to_local())
            for o in outs:
                funcol.wait_tensor(o)
        return {"raised": raised,
                "collectives": [tuple(c) for c in tr.collectives],
                "layout": mesh.layout, "dm": dm is not None}
    finally:
        dist.destroy_process_group()
