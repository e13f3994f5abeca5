"""Train and eval steps for the model zoo: the counterpart of
``repro.train.steps``.

A batch is a dict of tensors: ``tokens`` and ``targets`` (B, S) always;
``vision_embeds`` / ``vision_mask`` / (3, B, S) ``positions`` for a
vision-language config; ``enc_frames`` for an encoder-decoder.  The loss
is next-token cross entropy with the padded-vocab tail masked out, plus
``AUX_WEIGHT`` times the MoE load-balance loss.

A train step is the model's forward with grads on (every block
rematerialised, ``models.transformer.run_block``), one backward, then
AdamW (``optimizer.apply``) in place.  Its metrics stay 0-d tensors on the
device: nothing in a step reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt

AUX_WEIGHT = 0.01
BATCH_EXTRAS = ("vision_embeds", "vision_mask", "enc_frames", "positions")


class TrainState(NamedTuple):
    model: tf.LM          # the parameters, updated in place
    opt_state: opt.OptState


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token CE in float32; ignores the padded-vocab tail
    (logits there set to -1e30).  Gather-free, as the JAX package's: the
    target's logit is picked by a mask over the vocabulary axis."""
    logits = logits.float()
    v = logits.shape[-1]
    iota = torch.arange(v, device=logits.device)
    if v != vocab_size:
        logits = torch.where(iota < vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    onehot = iota == targets[..., None]
    picked = torch.where(onehot, logits, 0.0).sum(dim=-1)
    return (lse - picked).mean()


def loss_fn(model: tf.LM, cfg, batch: dict):
    """(loss, (ce, aux)) of ``model`` on ``batch``."""
    kw = {k: batch[k] for k in BATCH_EXTRAS if k in batch}
    logits, _, aux = model(batch["tokens"], return_aux=True, **kw)
    ce = cross_entropy(logits, batch["targets"], cfg.vocab_size)
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
                     device=None) -> TrainState:
    """A model drawn from ``seed`` on ``device`` (the card unless asked
    for the CPU), with grads on, and its AdamW state."""
    model = trainable(tf.init_lm(cfg, seed=seed, device=device))
    return TrainState(model=model, opt_state=opt.init(model, opt_cfg))
