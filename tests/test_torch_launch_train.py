"""The training launcher (``repro_torch.launch.train``) at world size 1 on
the CPU, held to the JAX package's launcher (``repro.launch.train``): the
same reduced config and AdamW settings, and from JAX's initial state
(``jax.random.key(0)``, carried by ``repro_torch.convert``) over the same
``TokenPipeline`` batches, the same losses; it prints the JAX launcher's
lines, and without ``--device cpu`` it asks for the card (none here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.train import steps

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH, STEPS, BATCH, SEQ = "h2o-danube-1.8b", 3, 2, 16
FLAGS = ["--arch", ARCH, "--steps", str(STEPS), "--batch", str(BATCH),
         "--seq", str(SEQ)]
LOSS_RTOL = 1e-5


def _jax_launcher_losses(jcfg, jocfg) -> tuple:
    """The JAX launcher's initial state and the losses of its loop (its
    config, AdamWConfig, pipeline and jitted step)."""
    state = init = jax.jit(
        lambda k: jsteps.init_train_state(k, jcfg, jocfg))(jax.random.key(0))
    train_step = jax.jit(jsteps.make_train_step(jcfg, jocfg))
    pipe = JTokenPipeline(jcfg.vocab_size, SEQ, BATCH)
    losses = []
    for _ in range(STEPS):
        nb = pipe.next_batch()
        state, m = train_step(state, {"tokens": jnp.asarray(nb.tokens),
                                      "targets": jnp.asarray(nb.targets)})
        losses.append(float(m["loss"]))
    return init, losses


def test_losses_match_the_jax_launcher():
    trainer = train.make_trainer(train.parse_args(FLAGS + ["--device",
                                                           "cpu"]))
    jcfg = jget_config(ARCH).reduced()
    jocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10,
                             state_dtype=jcfg.optimizer_state_dtype)
    assert trainer.ocfg._asdict() == jocfg._asdict()
    assert trainer.cfg.name == jcfg.name
    jstate, want = _jax_launcher_losses(jcfg, jocfg)
    model = steps.trainable(convert.lm_params_from_jax(
        jax.tree.map(np.asarray, jstate.params), trainer.cfg, device="cpu"))
    trainer.state = steps.TrainState(model, convert.opt_state_from_jax(
        jstate.opt_state, trainer.cfg, device="cpu"))
    got = trainer.train(STEPS)["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert want[0] != want[-1]


def test_main_prints_the_jax_launchers_lines(capsys):
    losses = train.main(FLAGS + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    again = train.make_trainer(train.parse_args(
        FLAGS + ["--device", "cpu"])).train(STEPS)["loss"]
    assert len(losses) == STEPS and losses == again
    assert lines[0].startswith("mesh={'data': 1, 'model': 1} "
                               f"arch={ARCH} params=")
    assert [ln.split()[:2] for ln in lines[1:]] == [["step", "0"],
                                                    ["step", "2"]]
    assert f"loss {losses[-1]:.4f}" in lines[-1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_card_is_the_default():
    with pytest.raises(RuntimeError):
        train.main(FLAGS)
