"""One reduced train step of the port against the JAX package's
(``jax.jit(repro.train.steps.make_train_step)``) for the attention
families: h2o-danube-1.8b (sliding window 64 at S = 80, a vocabulary of
500 padded to 512), gemma-7b (tied and scaled embeddings, GeGLU),
whisper-medium (the encoder over seeded frames: grads reach it through
``enc_frames``) and qwen2-vl-7b (patch embeddings under a mask, distinct
M-RoPE t/h/w streams).  Same weights through ``repro_torch.convert``, same
batch; the helpers and tolerances are in ``tests/_torch_train_archs.py``
(the MoE and recurrent families are in
``tests/test_torch_train_archs_moe_ssm.py``).

Also: serving builds no graph on a model whose parameters require grad
(as the trainer leaves them), and its tokens are those of the same model
with grads off."""

import numpy as np
import pytest
import torch

import _torch_train_archs as common
from _torch_launch_workers import one_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve import engine
from repro_torch.train import steps

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_thread")]

ARCHS = ["h2o-danube-1.8b", "gemma-7b", "whisper-medium", "qwen2-vl-7b"]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = common.run(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_metrics_match_jax(arch, runs):
    common.check_first_step(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_per_leaf(arch, runs):
    common.check_grads(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_step_losses_match_jax(arch, runs):
    common.check_losses(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_master_matches_jax(arch, runs):
    common.check_master(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bit_equal(arch, runs):
    common.check_remat(runs(arch))


def test_grads_reach_the_encoder_through_frames(runs):
    r = runs("whisper-medium")
    enc = [n for n in r["grads"] if n.startswith("encoder.")]
    assert enc
    for name in enc:
        if not name.endswith("norm1.scale"):
            assert float(r["grads"][name].abs().max()) > 0, name


def test_serving_builds_no_graph_on_a_trainable_model():
    """``engine.prefill`` / ``decode_step`` / ``generate`` on a model
    whose parameters require grad return nothing that requires grad, and
    the same tokens as the model with grads off."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    model = tf.init_lm(cfg, seed=0, device=common.CPU)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    want = engine.generate(model, prompt, steps=6, max_len=32)
    steps.trainable(model)
    assert all(p.requires_grad for p in model.parameters())
    st = engine.prefill(model, prompt, max_len=32)
    st = engine.decode_step(model, st.last_logits.argmax(-1)[:, None], st)
    tensors = [st.last_logits] + [t for layer in st.cache["layers"]
                                  for t in layer.values()]
    assert not any(t.requires_grad or t.grad_fn is not None
                   for t in tensors)
    got = engine.generate(model, prompt, steps=6, max_len=32)
    assert not got.requires_grad
    assert torch.equal(got, want)
