"""Model-zoo training driver on the port (the counterpart of the JAX
package's ``examples/train_lm.py``): train any ``--arch`` (reduced by
default; ``--full`` for the published widths, on the card) on the
synthetic token pipeline with AdamW.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch xlstm-125m \\
        --steps 200 --batch 8 --seq 64 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full \\
        --arch h2o-danube-1.8b --batch 4 --seq 1024 --steps 8
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full \\
        --arch deepseek-v2-lite-16b --layers 3 --batch 4 --seq 1024 --steps 2

It runs on the card unless ``--device cpu`` is given.  A vision-language
config trains with zero patch embeddings under a false mask and equal
t/h/w position streams, an encoder-decoder with zero frames, as the JAX
script does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint, optimizer as opt, steps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="full (unreduced) config -- on the card")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                    "config's)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _line(i: int, out: dict, secs: float) -> str:
    return (f"  step {i:5d}  loss {out['loss'][-1]:.4f}"
            f"  grad_norm {out['grad_norm'][-1]:.3f}  ({secs:.1f}s)")


def zero_extras(cfg, b: int, s: int, device) -> dict:
    """A batch's extras as the JAX script trains: for a vision-language
    config zero patch embeddings under a false mask and equal t/h/w
    position streams, for an encoder-decoder zero frames."""
    out, d = {}, cfg.d_model
    if cfg.vision_embeds:
        out["vision_embeds"] = torch.zeros((b, s, d), device=device)
        out["vision_mask"] = torch.zeros((b, s), dtype=torch.bool,
                                         device=device)
        out["positions"] = torch.arange(
            s, dtype=torch.int32, device=device).expand(3, b, s)
    if cfg.is_encoder_decoder:
        out["enc_frames"] = torch.zeros((b, cfg.enc_frames, d), device=device)
    return out


class Trainer:
    """What the script trains: the config (its depth cut to ``--layers``
    where given), AdamW's settings (the JAX script's: ``warmup_steps=20``,
    the config's state dtype), the model
    and its optimizer state from seed 0, and the token pipeline (seed 0).
    ``warmup_steps`` overrides the script's 20 (``launch.train`` passes
    the JAX launcher's 10).

    With ``mesh`` (a ``models.sharding.Mesh``, which it installs, as the
    JAX launcher installs its mesh) the model and its AdamW state are this
    rank's blocks of the same seed-0 draw (``tf.init_lm(mesh=)``), and
    every rank draws the same pipeline batch and keeps its own ``data``
    rows (``sharding.batch_rows``) of the tokens, targets and extras, with
    the whole batch's row count (``batch_size``).  Without one nothing
    changes.

    ``extras(cfg, b, s, device)`` gives a whole batch's extras by name
    (default :func:`zero_extras`, the JAX script's)."""

    def __init__(self, args: argparse.Namespace, device=None, *,
                 warmup_steps: int = 20, mesh=None, extras=None):
        cfg = get_config(args.arch)
        cfg = cfg if args.full else cfg.reduced()
        if getattr(args, "layers", 0):
            cfg = dataclasses.replace(cfg, num_layers=args.layers)
        self.cfg = cfg
        self.ocfg = opt.AdamWConfig(
            lr=args.lr, warmup_steps=warmup_steps,
            state_dtype=self.cfg.optimizer_state_dtype)
        if mesh is not None:
            shd.set_mesh_axes(mesh)
        self.mesh = mesh
        self.state = steps.init_train_state(self.cfg, self.ocfg, seed=0,
                                            device=device, mesh=mesh)
        self.device = self.state.model.device
        self.pipe = TokenPipeline(self.cfg.vocab_size, args.seq, args.batch,
                                  seed=0)
        self.train_step = steps.make_train_step(self.cfg, self.ocfg)
        self.eval_step = steps.make_eval_step(self.cfg)
        self.extras = zero_extras if extras is None else extras

    def batch(self) -> dict:
        """The pipeline's next batch on the device, with the config's
        extras; on a mesh this rank's rows of each (``positions`` (3, B,
        S) on dim 1)."""
        nb = self.pipe.next_batch()
        b, s = nb.tokens.shape
        out = {"tokens": torch.as_tensor(nb.tokens, device=self.device),
               "targets": torch.as_tensor(nb.targets, device=self.device)}
        out.update(self.extras(self.cfg, b, s, self.device))
        if self.mesh is not None:
            out = {k: shd.batch_rows(v, 1 if k == "positions" else 0)
                   for k, v in out.items()}
            out["batch_size"] = b
        return out

    def train(self, n: int, log_every: int | None = None,
              line=None) -> dict:
        """``n`` steps; each step's loss and grad norm read back (which
        waits for the step) and its wall seconds, batch included.  Every
        ``log_every`` steps and at the last it prints ``line(i, out,
        seconds so far)`` (default: step, loss and grad norm)."""
        out = {"loss": [], "grad_norm": [], "step_s": []}
        t_start = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, self.batch())
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
            out["step_s"].append(time.perf_counter() - t0)
            if log_every and (i % log_every == 0 or i == n - 1):
                print((line or _line)(i, out, time.perf_counter() - t_start))
        return out

    def evaluate(self) -> dict:
        """One eval step on the pipeline's next batch, as floats."""
        return {k: float(v)
                for k, v in self.eval_step(self.state.model,
                                           self.batch()).items()}


def main(argv=None, device=None) -> dict:
    """Trains as the flags say (``device`` overrides ``--device``);
    returns the per-step losses, grad norms and seconds, the parameter
    count and one eval step's loss."""
    args = parse_args(argv)
    trainer = Trainer(args, device if device is not None else args.device)
    n_params = tf.count_params(trainer.state.model)
    print(f"arch={trainer.cfg.name} params={n_params:,} "
          f"steps={args.steps} batch={args.batch} seq={args.seq} "
          f"device={trainer.device}")
    out = trainer.train(args.steps, log_every=max(args.steps // 10, 1))
    out["params"] = n_params
    out["eval"] = trainer.evaluate()
    print(f"  eval loss {out['eval']['loss']:.4f}; median step "
          f"{np.median(out['step_s']) * 1e3:.1f} ms")
    if args.ckpt:
        checkpoint.save(args.ckpt,
                        dict(trainer.state.model.named_parameters()))
        print(f"checkpoint -> {args.ckpt}")
    return out


if __name__ == "__main__":
    main()
