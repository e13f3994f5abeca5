"""Training launcher: the train step of ``repro_torch.train`` over a group
of ranks laid out (data, model), the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 20 --batch 8 --seq 64 [--full] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --ranks 8 \\
        --backend gloo --device cpu --arch h2o-danube-1.8b --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --ranks 8 \\
        --backend gloo --device cpu --arch deepseek-v2-lite-16b --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --ranks 8 \\
        --backend gloo --device cpu --steps 3       # xlstm-125m, as JAX's

The JAX launcher jits the step over ``make_test_mesh()``, a mesh of every
local device laid out ``(n // model, model)`` over ``("data", "model")``
(model 4, 2 or 1, the first that divides n), with its sharding rules
installed: on n > 1 devices it trains with the batch over ``data``, the
parameters FSDP-sharded over ``data`` and the heads, MLP, vocabulary and
residual stream over ``model``.  The port does the same over ``--ranks
k`` processes (``launch.mesh.spawn_clients``, the ``--backend`` the
caller names: gloo, or NCCL with one card a rank; nothing falls back from
one to the other): each rank joins ``launch.mesh.make_test_mesh`` and
trains its blocks (``models.sharding``).  At ``--ranks 1`` (the default)
it is one process with no mesh, as a one-device mesh is.  Every arch the
JAX launcher trains shards: the dense family, DeepSeek-V2 (MLA's heads and
the MoE's experts over ``model``), the recurrent families (xlstm-125m's
mLSTM and sLSTM heads, recurrentgemma-2b's RG-LRU channels), whisper
(encoder, decoder and cross attention) and qwen2-vl (its vision inputs
and M-RoPE positions cut to each rank's rows).

It trains what the JAX launcher trains: the config, reduced unless
``--full``; AdamW at lr 1e-3 with the launcher's 10 warm-up steps and the
config's state dtype; the model and its optimizer state from seed 0;
``TokenPipeline`` batches (seed 0) with the config's extras.  The loop is
the model-zoo trainer's (``examples.train_lm.Trainer``, given the
launcher's warm-up).  It runs on the card unless ``--device cpu`` is
given; without a card that raises.  It prints the JAX launcher's lines:
the mesh, the arch and the parameter count, then the loss every 5 steps
and at the last (over several ranks, rank 0's, once they have all ended).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config
from repro_torch.examples.train_lm import Trainer
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as tf

LR, WARMUP_STEPS = 1e-3, 10        # the JAX launcher's AdamWConfig
LOG_EVERY = 5
SPAWN_TIMEOUT_S = 3600.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes, laid out (ranks // model, model)")
    ap.add_argument("--backend", choices=meshlib.BACKENDS, default=None,
                    help="the process group's backend (needed at --ranks "
                    "> 1)")
    args = ap.parse_args(argv)
    if args.ranks > 1 and args.backend is None:
        ap.error("--ranks > 1 needs --backend gloo or nccl")
    return args


def make_trainer(args: argparse.Namespace, mesh=None) -> Trainer:
    """The launcher's trainer for parsed flags, before any step; with
    ``mesh``, this rank's (``Trainer(mesh=)``)."""
    return Trainer(argparse.Namespace(
        arch=args.arch, batch=args.batch, seq=args.seq, lr=LR,
        full=args.full), args.device, warmup_steps=WARMUP_STEPS, mesh=mesh)


def _line(i: int, loss: float, secs: float) -> str:
    return f"step {i:4d} loss {loss:.4f} ({secs:.1f}s)"


def _mesh_line(layout, cfg, n_params: int) -> str:
    return (f"mesh={layout.axis_sizes if layout else {'data': 1, 'model': 1}}"
            f" arch={cfg.name} params={n_params:,}")


def rank_main(group, argv) -> dict:
    """What each rank of ``--ranks k`` runs: join the mesh of the whole
    group, train, return the losses and step seconds (the same on every
    rank: the loss is the global batch's)."""
    args = parse_args(argv)
    mesh = meshlib.make_test_mesh(group)
    out = make_trainer(args, mesh).train(args.steps)
    return {"loss": out["loss"], "step_s": out["step_s"]}


def main(argv=None) -> list[float]:
    """Trains as the flags say; returns the loss of every step."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.ranks == 1:
        trainer = make_trainer(args)
        print(_mesh_line(None, trainer.cfg,
                         tf.count_params(trainer.state.model)))
        return trainer.train(
            args.steps, log_every=LOG_EVERY,
            line=lambda i, out, secs: _line(i, out["loss"][-1], secs))["loss"]
    cfg = get_config(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    out = meshlib.spawn_clients(
        rank_main, args.ranks, backend=args.backend, device=args.device,
        timeout_s=SPAWN_TIMEOUT_S,
        args=(argv,))[0]
    print(_mesh_line(meshlib.layout_for(args.ranks), cfg,
                     tf.count_params(tf.LM(cfg, "meta"))))
    secs = 0.0
    for i, (loss, s) in enumerate(zip(out["loss"], out["step_s"])):
        secs += s
        if i % LOG_EVERY == 0 or i == args.steps - 1:
            print(_line(i, loss, secs))
    return out["loss"]


if __name__ == "__main__":
    main()
