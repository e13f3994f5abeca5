"""The port's encoder-decoder (whisper-medium, reduced: 2 encoder and 2
decoder layers, d 256, 64 frames, vocab 512) on the CPU, held to the JAX
package's with the same float32 weights (``convert.lm_params_from_jax``):
the sinusoidal rows, the encoder, a full forward over frames, a prefill
that fills the cross cache and 4 decode steps against it (a float32 cache,
and a bfloat16 one where the cross K/V stay in the activations' float32,
as JAX's prefill stores them), greedy ``generate(enc_frames=)``, and both
packages' ``LMService``, whose fallback decodes against the zero cross
cache (the service carries no frames).

Tolerances: logits within 1e-4 of max |logit| (the JAX package's
decode-consistency bound, tests/test_decode_consistency.py), tokens
exact, the weight bridge bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve.lm_service import LMService as JLMService
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.serve import engine
from repro_torch.serve.lm_service import LMService

pytestmark = [pytest.mark.serve, pytest.mark.usefixtures("one_thread")]

CPU = "cpu"
RTOL = 1e-4          # of max |logit|
B, S = 2, 12


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _jcfg(cfg):
    return dataclasses.replace(jget_config(cfg.name),
                               **dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def whisper():
    """(cfg, JAX params, the port's model with the same weights, frames
    (B, 64, 256) float32, tokens (B, S))."""
    cfg = get_config("whisper-medium").reduced()
    assert (cfg.enc_layers, cfg.num_layers, cfg.d_model, cfg.enc_frames,
            cfg.vocab_size) == (2, 2, 256, 64, 512)
    params = jtf.init_lm(jax.random.key(0), _jcfg(cfg))
    model = convert.lm_params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                       device=CPU)
    rng = np.random.default_rng(2)
    frames = (rng.standard_normal((B, cfg.enc_frames, cfg.d_model))
              * 0.05).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    return cfg, params, model, frames, toks


@pytest.mark.parametrize("t,d", [(4096, 256), (1500, 1024)])
def test_sinusoidal_rows_match_jax_table(t, d):
    """Rows at given positions against JAX's table: each angle is
    ``pos * div`` with ``div`` an exp that XLA and torch may round one
    float32 ulp (2^-23 relative, div <= 1) apart, so a row may differ by
    up to ~pos * 2^-23, plus sin's and cos's own rounding."""
    want = np.asarray(jlayers.sinusoidal_positions(t, d))
    pos = np.arange(t)
    got = layers.sinusoidal_positions(torch.as_tensor(pos), d).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (np.abs(got - want) <= 2.0 ** -22 * (pos[:, None] + 1)).all()
    # any (B, S) positions: the rows of those positions
    idx = np.random.default_rng(0).integers(0, t, (3, 5))
    rows = layers.sinusoidal_positions(torch.as_tensor(idx), d).numpy()
    np.testing.assert_array_equal(rows, got[idx])


def test_encode_matches_jax(whisper):
    cfg, params, model, frames, _ = whisper
    want = jtf.encode(params, _jcfg(cfg), jnp.asarray(frames))
    got = model.encode(torch.as_tensor(frames))
    assert got.shape == (B, cfg.enc_frames, cfg.d_model)
    assert _rel(got, want) < RTOL


def test_forward_with_frames_matches_jax(whisper):
    cfg, params, model, frames, toks = whisper
    want, _, _ = jtf.forward(params, _jcfg(cfg), jnp.asarray(toks),
                             enc_frames=jnp.asarray(frames))
    got, _ = model(torch.as_tensor(toks), enc_frames=torch.as_tensor(frames))
    assert got.shape == (B, S, cfg.padded_vocab)
    assert _rel(got, want) < RTOL
    with pytest.raises(ValueError, match="enc_frames"):
        model(torch.as_tensor(toks))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(whisper, cache_dtype):
    """A prefill over frames fills the cross cache; 4 decode steps read it
    (no frames), each step's logits against JAX's ``decode_step``.  With a
    bfloat16 cache the self K/V are bfloat16 and the cross K/V float32 in
    both packages."""
    cfg, params, model, frames, toks = whisper
    jst = jengine.prefill(params, _jcfg(cfg), jnp.asarray(toks[:, :S - 4]),
                          max_len=S + 2, enc_frames=jnp.asarray(frames),
                          cache_dtype=getattr(jnp, cache_dtype))
    st = engine.prefill(model, toks[:, :S - 4], max_len=S + 2,
                        enc_frames=frames,
                        cache_dtype=getattr(torch, cache_dtype))
    layer = st.cache["layers"][0]
    jlayer = jax.tree.map(lambda a: a[0], jst.cache["blocks"][0])
    assert layer["k"].dtype == getattr(torch, cache_dtype)
    assert str(jlayer["self"]["k"].dtype) == cache_dtype
    assert layer["cross_k"].dtype == layer["cross_v"].dtype == torch.float32
    assert jlayer["cross_kv"]["k"].dtype == jnp.float32
    np.testing.assert_allclose(
        layer["cross_k"].transpose(1, 2).numpy(),
        np.asarray(jlayer["cross_kv"]["k"]), rtol=0,
        atol=RTOL * float(np.abs(jlayer["cross_kv"]["k"]).max()))
    assert _rel(st.last_logits, jst.last_logits) < RTOL
    for i in range(S - 4, S):
        jst = jengine.decode_step(params, _jcfg(cfg),
                                  jnp.asarray(toks[:, i:i + 1]), jst)
        st = engine.decode_step(model, toks[:, i:i + 1], st)
        assert _rel(st.last_logits, jst.last_logits) < RTOL
    if cache_dtype == "float32":
        full, _ = model(torch.as_tensor(toks),
                        enc_frames=torch.as_tensor(frames))
        assert _rel(st.last_logits, full[:, -1]) < RTOL


def test_greedy_generate_with_frames_matches_jax(whisper):
    cfg, params, model, frames, toks = whisper
    want = jengine.generate(params, _jcfg(cfg), jnp.asarray(toks[:, :6]),
                            steps=6, enc_frames=jnp.asarray(frames))
    got = engine.generate(model, toks[:, :6], steps=6, enc_frames=frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the frames matter: without them the cross cache stays zero
    assert not np.array_equal(got.numpy(), engine.generate(
        model, toks[:, :6], steps=6).numpy())


def test_service_decodes_on_zero_cross_cache_as_jax(whisper):
    """Neither package's ``GenRequest`` carries frames: both services take
    the fallback and decode against the zero cross cache, the same tokens
    in the same order, each equal to the port's ``generate`` without
    frames."""
    cfg, params, model, _, toks = whisper
    prompts = [toks[0, :5], toks[1, :9]]
    out = []
    for svc in (JLMService(params, _jcfg(cfg), num_slots=2, chunk_steps=4),
                LMService(model, num_slots=2, chunk_steps=4)):
        assert not svc.slot_mode
        rids = [svc.submit(p, 6, seed=i) for i, p in enumerate(prompts)]
        res = svc.run()
        out.append([np.asarray(res[r].tokens) for r in rids])
    for (jt, t), p in zip(zip(*out), prompts):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(
            t, engine.generate(model, p[None], steps=6)[0].numpy())


def test_weight_bridge_round_trip_bit_equal(whisper):
    """Decoder blocks with ``norm_x`` and ``cross``, and the encoder's
    stack and final norm, cross both ways bit for bit."""
    cfg, params, model, _, _ = whisper
    back = convert.lm_params_to_numpy(model)
    assert set(back) == {"embed", "decoder", "encoder"}
    flat, tree = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tf.count_params(model) == jtf.count_params(params)
