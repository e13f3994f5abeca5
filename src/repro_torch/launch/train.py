"""Training launcher: the train step of ``repro_torch.train`` over the
local client group, the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 20 --batch 8 --seq 64 [--full] [--device cpu]

The JAX launcher jits the step over a mesh of the local devices, which is
one device on a single card or a CPU.  The port runs at world size 1 (one
process, one card), as that mesh does, and adds no data parallelism: the
JAX package has none either.  It trains what the JAX launcher trains: the
config, reduced unless ``--full``; AdamW at lr 1e-3 with the launcher's
10 warm-up steps and the config's state dtype; the model and its
optimizer state from seed 0; ``TokenPipeline`` batches (seed 0) with the
config's extras.  The loop is the model-zoo trainer's
(``examples.train_lm.Trainer``, given the launcher's warm-up).  It runs on
the card unless ``--device cpu`` is given; without a card that raises.  It
prints the JAX launcher's lines: the mesh, the arch and the parameter
count, then the loss every 5 steps and at the last.
"""

from __future__ import annotations

import argparse

from repro_torch.examples.train_lm import Trainer
from repro_torch.models import transformer as tf

MESH = {"data": 1, "model": 1}     # world size 1, as make_test_mesh on one
LR, WARMUP_STEPS = 1e-3, 10        # the JAX launcher's AdamWConfig
LOG_EVERY = 5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace) -> Trainer:
    """The launcher's trainer for parsed flags, before any step."""
    return Trainer(argparse.Namespace(
        arch=args.arch, batch=args.batch, seq=args.seq, lr=LR,
        full=args.full), args.device, warmup_steps=WARMUP_STEPS)


def _line(i: int, out: dict, secs: float) -> str:
    return f"step {i:4d} loss {out['loss'][-1]:.4f} ({secs:.1f}s)"


def main(argv=None) -> list[float]:
    """Trains as the flags say; returns the loss of every step."""
    args = parse_args(argv)
    trainer = make_trainer(args)
    print(f"mesh={MESH} arch={trainer.cfg.name} "
          f"params={tf.count_params(trainer.state.model):,}")
    return trainer.train(args.steps, log_every=LOG_EVERY, line=_line)["loss"]


if __name__ == "__main__":
    main()
