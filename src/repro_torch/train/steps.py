"""Train and eval steps for the model zoo: the counterpart of
``repro.train.steps``.

A batch is a dict: ``tokens`` and ``targets`` (B, S) always;
``vision_embeds`` / ``vision_mask`` / (3, B, S) ``positions`` for a
vision-language config; ``enc_frames`` for an encoder-decoder; on a
mesh, ``batch_size``: the whole batch's row count (an int).  The loss
is next-token cross entropy with the padded-vocab tail masked out, plus
``AUX_WEIGHT`` times the MoE load-balance loss.

A train step is the model's forward with grads on (every block
rematerialised, ``models.transformer.run_block``), one backward, then
AdamW (``optimizer.apply``) in place.  Its metrics stay 0-d tensors on the
device: nothing in a step reads back to the host.

On a mesh of ranks (``models.sharding``; ``launch.train --ranks``) each
rank holds its rows of the batch (``sharding.batch_rows``; the batch's
``batch_size`` says how many rows the whole batch has) and its block
of the logits' vocabulary: the cross entropy takes the softmax's max and
sums over ``model`` and the mean over the global batch (a sum over
``data``), and the backward leaves each rank its parameters' blocks of
the global grads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt

AUX_WEIGHT = 0.01
BATCH_EXTRAS = ("vision_embeds", "vision_mask", "enc_frames", "positions",
                "batch_size")


class TrainState(NamedTuple):
    model: tf.LM          # the parameters, updated in place
    opt_state: opt.OptState


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int, full_vocab: int | None = None
                  ) -> torch.Tensor:
    """Mean next-token CE in float32; ignores the padded-vocab tail
    (logits there set to -1e30).  Gather-free, as the JAX package's: the
    target's logit is picked by a mask over the vocabulary axis.

    On a mesh, ``logits`` and ``targets`` are this rank's rows, and
    ``logits`` its block of the ``full_vocab`` (the padded vocabulary;
    default: ``logits``' own, whole) split over ``model``: the log-sum-exp
    and the picked logit are summed over ``model``, and the mean over the
    global batch is each rank's mean over ``batch_ways`` summed over
    ``data`` (a row a rank repeats counts once).  The value is the global
    mean on every rank; its backward reaches this rank's rows only."""
    logits = logits.float()
    v = logits.shape[-1]
    mesh = shd.active()
    split = mesh is not None and full_vocab not in (None, v)
    lo = v * mesh.coords["model"] if split else 0
    iota = torch.arange(lo, lo + v, device=logits.device)
    if (full_vocab or v) != vocab_size:
        logits = torch.where(iota < vocab_size, logits, -1e30)
    onehot = iota == targets[..., None]
    picked = torch.where(onehot, logits, 0.0).sum(dim=-1)
    if not split:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        top = shd.all_max(logits.max(dim=-1).values)
        lse = torch.log(shd.reduce_from(
            torch.exp(logits - top[..., None]).sum(dim=-1))) + top
        picked = shd.reduce_from(picked)
    if mesh is None:
        return (lse - picked).mean()
    return shd.reduce_from((lse - picked).mean() / shd.batch_ways(), "data")


def loss_fn(model: tf.LM, cfg, batch: dict):
    """(loss, (ce, aux)) of ``model`` on ``batch`` (on a mesh, this
    rank's rows of it)."""
    kw = {k: batch[k] for k in BATCH_EXTRAS if k in batch}
    logits, _, aux = model(batch["tokens"], return_aux=True, **kw)
    ce = cross_entropy(logits, batch["targets"], cfg.vocab_size,
                       cfg.padded_vocab)
    return ce + AUX_WEIGHT * aux, (ce, aux)


def trainable(model: tf.LM) -> tf.LM:
    """Turns grads on for every parameter of ``model`` (init_lm leaves
    them off, for serving) and returns it."""
    return model.requires_grad_(True)


def value_and_grad(model: tf.LM, cfg, batch: dict):
    """(loss, (ce, aux), grads by parameter name) of ``model`` on
    ``batch``: one forward and one backward, the grads cleared first
    (``set_to_none``).  The grads stay on the parameters (``.grad``)."""
    trainable(model).zero_grad(set_to_none=True)
    loss, (ce, aux) = loss_fn(model, cfg, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), (ce.detach(), aux.detach()), grads


def make_train_step(cfg, opt_cfg: opt.AdamWConfig):
    def train_step(state: TrainState, batch: dict):
        loss, (ce, aux), grads = value_and_grad(state.model, cfg, batch)
        _, opt_state, gnorm = opt.apply(grads, state.opt_state,
                                        state.model, opt_cfg)
        state.model.zero_grad(set_to_none=True)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm}
        return TrainState(state.model, opt_state), metrics

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(model: tf.LM, batch: dict):
        loss, (ce, _aux) = loss_fn(model, cfg, batch)
        return {"loss": loss, "ce": ce}
    return eval_step


def init_train_state(cfg, opt_cfg: opt.AdamWConfig, *, seed: int = 0,
                     device=None, mesh=None) -> TrainState:
    """A model drawn from ``seed`` on ``device`` (the card unless asked
    for the CPU), with grads on, and its AdamW state; with ``mesh``, this
    rank's blocks of both (``tf.init_lm(mesh=)``, ``opt.init``)."""
    model = trainable(tf.init_lm(cfg, seed=seed, device=device, mesh=mesh))
    return TrainState(model=model, opt_state=opt.init(model, opt_cfg))
