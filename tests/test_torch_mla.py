"""The port's multi-head latent attention (repro_torch.models.attention
``MLAttention``) on the CPU, held to the JAX package's ``mla_attention``
with the same weights: the expanded prefill with its cache fill and the
absorbed decode against the compressed cache, on reduced
deepseek-v2-lite-16b (no q-LoRA) and deepseek-v2-236b (q-LoRA), float32
weights, a float32 or the default bfloat16 cache.  Then the MLA cases of
tests/test_decode_consistency.py mirrored on the port's whole model.

Tolerances: 1e-5 of max |out| for one attention layer, 1e-4 of max
|logit| for a model (the JAX package's decode-consistency bound), both
across the two frameworks' float32 sums; the cache's latent and rotated
key within 1e-5 in float32, and within one bfloat16 step (2^-8 of max
|value|) in bfloat16, where a float32 value at a rounding boundary may
round either way in the two frameworks.
Greedy tokens and bucketed-vs-exact prefills are compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import rope_tables
from repro_torch.serve import engine

pytestmark = [pytest.mark.serve, pytest.mark.usefixtures("one_thread")]

CPU = "cpu"
MLA = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
LAYER_RTOL, RTOL = 1e-5, 1e-4


def _jcfg(cfg):
    return dataclasses.replace(jget_config(cfg.name),
                               **dataclasses.asdict(cfg))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _layer(cfg, seed=0):
    """(JAX params, the port's MLAttention with the same weights)."""
    params = jattn.init_mla(jax.random.key(seed), _jcfg(cfg))
    layer = attn.MLAttention(cfg, CPU)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            leaf = params
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(torch.as_tensor(np.array(leaf)))
    return params, layer


@pytest.mark.parametrize("arch", MLA)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_absorbed_decode_match_jax(arch, cache_dtype):
    """An 8-token prefill fills the latent cache (expanded path), then 3
    decode steps run the absorbed path: outputs and the cache's latent
    and rotated key equal JAX's within float32 rounding."""
    cfg = get_config(arch).reduced()
    jcfg = _jcfg(cfg)
    params, layer = _layer(cfg)
    assert hasattr(layer, "wq_a") == bool(cfg.mla_q_lora)
    b, s, t = 2, 8, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s + 3, cfg.d_model)).astype(np.float32)
    jdt, dt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jcache = jattn.init_mla_cache(jcfg, b, t, dtype=jdt)
    cache = attn.init_mla_cache(cfg, b, t, dtype=dt, device=CPU)
    pos = np.tile(np.arange(s), (b, 1))
    want, jcache = jattn.mla_attention(params, jnp.asarray(x[:, :s]),
                                       cfg=jcfg, positions=jnp.asarray(pos),
                                       cache=jcache)
    tpos = torch.as_tensor(pos)
    got = layer(torch.as_tensor(x[:, :s]), positions=tpos,
                rope=rope_tables(tpos, cfg.mla_rope_dim,
                                 theta=cfg.rope_theta), cache=cache)
    assert _rel(got, want) < LAYER_RTOL
    for i in range(s, s + 3):
        pos = np.full((b, 1), i)
        want, jcache = jattn.mla_attention(
            params, jnp.asarray(x[:, i:i + 1]), cfg=jcfg,
            positions=jnp.asarray(pos), cache=jcache)
        tpos = torch.as_tensor(pos)
        got = layer(torch.as_tensor(x[:, i:i + 1]), positions=tpos,
                    rope=rope_tables(tpos, cfg.mla_rope_dim,
                                     theta=cfg.rope_theta),
                    cache=cache, index=torch.full((b,), i))
        assert got.shape == (b, 1, cfg.d_model)
        assert _rel(got, want) < LAYER_RTOL
    tol = LAYER_RTOL if cache_dtype == "float32" else 2.0 ** -8
    for name in ("c_kv", "k_rope"):
        assert cache[name].dtype == dt
        assert _rel(cache[name].float(),
                    np.asarray(jcache[name], np.float32)) < tol


@pytest.mark.parametrize("arch", MLA)
def test_greedy_generate_matches_jax(arch):
    """Bucketed prefill, absorbed decode and the MoE's per-row routing:
    the same greedy tokens as the JAX package's ``generate``."""
    cfg = get_config(arch).reduced()
    params = jtf.init_lm(jax.random.key(0), _jcfg(cfg))
    model = convert.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg, device=CPU)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
    want = jengine.generate(params, _jcfg(cfg), jnp.asarray(prompt),
                            steps=6)
    got = engine.generate(model, prompt, steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_bucketing_exact_and_single_trace():
    """tests/test_decode_consistency.py's MLA case: prompts of 5 and 7
    tokens share bucket 8, generate the tokens of the exact-length path,
    and set up the bucket's prefill once."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    model = convert.lm_params_from_jax(
        jax.tree.map(np.asarray, jtf.init_lm(jax.random.key(0),
                                             _jcfg(cfg))), cfg, device=CPU)
    assert engine._can_bucket(cfg)
    snap = dict(engine.trace_counts)
    for s in (5, 7):
        prompt = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s))
        a = engine.generate(model, prompt, steps=4)
        b = engine.generate(model, prompt, steps=4, bucket_prompts=False)
        assert torch.equal(a, b)
    delta = {k: v - snap.get(k, 0) for k, v in engine.trace_counts.items()
             if v != snap.get(k, 0)}
    assert delta == {(cfg.name, 8, 8 + 4): 1}, delta


def test_absorbed_decode_matches_expanded_forward():
    """The port alone: a 12-token prompt then 8 decode steps (absorbed,
    float32 cache) against one causal forward over the 20 tokens (no
    capacity drop at 20 tokens: every token its own routing group)."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    model = tf.init_lm(cfg, seed=5, device=CPU)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 20))
    full, _ = model(torch.as_tensor(toks))
    st = engine.prefill(model, toks[:, :12], max_len=24,
                        cache_dtype=torch.float32)
    for i in range(12, 20):
        assert _rel(st.last_logits, full[:, i - 1]) < RTOL
        st = engine.decode_step(model, toks[:, i:i + 1], st)
    assert _rel(st.last_logits, full[:, -1]) < RTOL
