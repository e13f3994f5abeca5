"""What ``tests/test_torch_train_archs*.py`` share: one reduced train
step of the port against the JAX package's on the same weights (carried
by ``repro_torch.convert``) and the same batch, made once an arch and
kept for the file's tests.

For each arch: JAX's grads (``jax.value_and_grad`` of ``loss_fn``, jitted)
and the port's (``steps.value_and_grad``), both by the port's parameter
names; three steps of ``jax.jit(make_train_step)`` and of the port's
``make_train_step`` from the same AdamW state (``opt_state_from_jax``);
the port's grads again with remat off, for the bit-for-bit check."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.train import optimizer as opt, steps

CPU = "cpu"
B, S = 2, 32
# above h2o's reduced window of 64 and recurrentgemma's local window of
# 32: both windows bite
S_WINDOW = {"h2o-danube-1.8b": 80, "recurrentgemma-2b": 80}
STEPS = 3
METRIC_RTOL = 1e-5    # loss, ce, aux, grad_norm of the first step
GRAD_RTOL = 1e-4      # of each leaf's max |g|
LOSS_RTOL = 1e-4      # the losses of all three steps
# h2o-danube-1.8b trains on a vocabulary of 500 padded to 512: the CE's
# mask of the padded tail is on the path
VOCAB = {"h2o-danube-1.8b": 500}


def configs(arch: str):
    cfg = get_config(arch).reduced()
    if arch in VOCAB:
        cfg = dataclasses.replace(cfg, vocab_size=VOCAB[arch])
    jcfg = dataclasses.replace(jget_config(arch), **dataclasses.asdict(cfg))
    return cfg, jcfg


def batch(cfg, seed: int = 1) -> dict:
    """Tokens and targets (S_WINDOW's length where a window applies, else
    S), with the arch's extras: patch embeddings under a mask and
    distinct t/h/w streams (vision), frames from a seed (encoder-decoder),
    all numpy."""
    rng = np.random.default_rng(seed)
    s = S_WINDOW.get(cfg.name, S)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.vision_embeds:
        out["vision_embeds"] = rng.standard_normal(
            (B, s, cfg.d_model)).astype(np.float32)
        mask = np.zeros((B, s), bool)
        mask[:, 8:24] = True
        out["vision_mask"] = mask
        t = np.arange(s, dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 2, t % 8])[:, None], (3, B, s)).copy()
    if cfg.is_encoder_decoder:
        out["enc_frames"] = (0.05 * rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    return out


def _numpy(t) -> np.ndarray:
    """A copy (a float32 tensor's numpy() shares its memory)."""
    return t.detach().float().numpy().copy()


def run(arch: str) -> dict:
    cfg, jcfg = configs(arch)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=4)
    jocfg = jopt.AdamWConfig(**ocfg._asdict())
    jstate = jax.jit(lambda k: jsteps.init_train_state(k, jcfg, jocfg))(
        jax.random.key(0))
    nb = batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}

    vg = jax.jit(lambda p, b: jax.value_and_grad(
        jsteps.loss_fn, has_aux=True)(p, jcfg, b))
    (_, _), jgrads = vg(jstate.params, jb)
    tree = jax.tree.map(np.asarray, jstate.params)
    out = {"cfg": cfg,
           "jax_grads": convert.lm_tree_to_named(
               jax.tree.map(np.asarray, jgrads), cfg)}

    model = convert.lm_params_from_jax(tree, cfg, device=CPU)
    _, _, grads = steps.value_and_grad(model, cfg, tb)
    out["grads"] = {k: g.clone() for k, g in grads.items()}
    out["named"] = set(n for n, _ in model.named_parameters())

    plain = convert.lm_params_from_jax(tree, cfg, device=CPU)
    plain.remat = False
    _, _, grads = steps.value_and_grad(plain, cfg, tb)
    out["grads_no_remat"] = {k: g.clone() for k, g in grads.items()}
    del plain

    ts = jax.jit(jsteps.make_train_step(jcfg, jocfg))
    state = steps.TrainState(model, convert.opt_state_from_jax(
        jstate.opt_state, cfg, device=CPU))
    train_step = steps.make_train_step(cfg, ocfg)
    out["metrics"], out["jax_metrics"] = [], []
    for i in range(STEPS):
        jstate, jm = ts(jstate, jb)
        state, m = train_step(state, tb)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["jax_metrics"].append({k: float(v) for k, v in jm.items()})
        if i == 0:
            out["master"] = {k: _numpy(v)
                             for k, v in state.opt_state.master.items()}
            out["jax_master"] = convert.lm_tree_to_named(
                jax.tree.map(np.asarray, jstate.opt_state.master), cfg)
    return out


def check_first_step(r) -> None:
    got, want = r["metrics"][0], r["jax_metrics"][0]
    assert got.keys() == want.keys() == {"loss", "ce", "aux", "grad_norm"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   err_msg=k)


def check_grads(r) -> None:
    """Every parameter has a grad, mapped onto JAX's leaf by name, within
    GRAD_RTOL of the leaf's max |g|."""
    grads, want = r["grads"], r["jax_grads"]
    assert grads.keys() == want.keys() == r["named"]
    for name, g in grads.items():
        assert g is not None, name
        w = np.asarray(want[name], np.float32)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(_numpy(g) - w).max())
        assert err <= GRAD_RTOL * scale + 1e-30, (name, err, scale)


def check_losses(r) -> None:
    for got, want in zip(r["metrics"], r["jax_metrics"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert len(r["metrics"]) == STEPS


def check_master(r) -> None:
    """The first step's float32 master equals JAX's where |g| is above
    1e-3 of the leaf's max: Adam's first step moves a weight by about
    +-lr whatever its grad's size, so a near-zero grad of the other sign
    moves it 2 lr the other way."""
    for name, g in r["grads"].items():
        g = np.abs(_numpy(g))
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(
            r["master"][name][big],
            np.asarray(r["jax_master"][name], np.float32)[big],
            rtol=1e-5, atol=1e-6, err_msg=name)


def check_remat(r) -> None:
    """Remat changes no value: the grads with each block checkpointed
    and without are equal bit for bit."""
    for name, g in r["grads"].items():
        assert torch.equal(g, r["grads_no_remat"][name]), name
