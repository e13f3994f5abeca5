"""The port's models (repro_torch.models) on the CPU, held to the JAX
package's (repro.models) with the same weights, carried over by
``repro_torch.convert.lm_params_from_jax``: reduced gemma-7b (GeGLU, tied
and scaled embeddings), h2o-danube-1.8b (sliding window 64, ring cache),
chatglm3-6b (partial RoPE), deepseek-v2-lite-16b (MLA, a dense layer then
MoE), deepseek-v2-236b (MLA with a q-LoRA), xlstm-125m (mLSTM and sLSTM,
no RoPE, no MLP) and recurrentgemma-2b (RG-LRU and local-attention MQA,
a float32 ``lam`` leaf), float32 weights.

Tolerances: logits within 1e-4 of max |logit| (the JAX package's own
decode-consistency bound, tests/test_decode_consistency.py), here across
the two frameworks' float32 products and sums.  The weight bridge is bit
for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config, list_configs
from repro_torch.models import transformer as tf
from repro_torch.serve import engine

pytestmark = [pytest.mark.serve, pytest.mark.usefixtures("one_thread")]

CPU = "cpu"
ARCHS = ["gemma-7b", "h2o-danube-1.8b", "chatglm3-6b",
         "deepseek-v2-lite-16b", "deepseek-v2-236b", "xlstm-125m",
         "recurrentgemma-2b"]
RTOL = 1e-4          # of max |logit|


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _pair(cfg, seed=0):
    """(JAX params, the port's model with the same weights)."""
    params = jtf.init_lm(jax.random.key(seed), _jcfg(cfg))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.lm_params_from_jax(tree, cfg, device=CPU)


def _jcfg(cfg):
    """The JAX package's ModelConfig with the same fields as ``cfg``."""
    base = jget_config(cfg.name)
    return dataclasses.replace(base, **dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        out[arch] = (cfg,) + _pair(cfg)
    return out


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ------------------------------------------------------------ configs
def test_every_config_registers_as_in_jax():
    """The port's config copy: the same names, fields and ``reduced()``."""
    assert list_configs() == jlist_configs()
    for name in list_configs():
        for ours, theirs in ((get_config(name), jget_config(name)),
                             (get_config(name).reduced(),
                              jget_config(name).reduced())):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert tuple(tf.layer_plan(get_config(name))) == tuple(
            jtf.layer_plan(jget_config(name)))


@pytest.mark.parametrize("arch", list_configs())
def test_every_config_builds_reduced_with_finite_logits(arch):
    """Every registered config builds reduced on the CPU and gives finite
    logits of the padded vocabulary (an encoder-decoder over frames)."""
    cfg = get_config(arch).reduced()
    model = tf.init_lm(cfg, device=CPU)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_frames"] = torch.full((2, cfg.enc_frames, cfg.d_model), 0.01)
    logits, _ = model(torch.as_tensor(_tokens(cfg, (2, 8))), **kw)
    assert logits.shape == (2, 8, cfg.padded_vocab)
    assert torch.isfinite(logits).all()


# -------------------------------------------------------------- bridge
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_bridge_round_trip_bit_equal(arch, models):
    cfg, params, model = models[arch]
    back = convert.lm_params_to_numpy(model)
    flat, tree = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tf.count_params(model) == jtf.count_params(params)


def test_weight_bridge_bfloat16_bit_equal():
    """bfloat16 leaves (the full-width configs' dtype) cross both ways
    bit for bit."""
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = jtf.init_lm(jax.random.key(2), _jcfg(cfg))
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_jax(tree, cfg, device=CPU)
    assert model.embed.embedding.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(convert.lm_params_to_numpy(model))):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-2b"])
def test_weight_bridge_bfloat16_recurrent_keeps_float32_lam(arch):
    """A bfloat16 recurrent model (mLSTM / sLSTM layers without an MLP,
    RG-LRU's float32 ``lam`` leaf) crosses both ways bit for bit, every
    leaf in its own dtype."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = jtf.init_lm(jax.random.key(2), _jcfg(cfg))
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_jax(tree, cfg, device=CPU)
    dtypes = {p.dtype for p in model.parameters()}
    assert dtypes == ({torch.bfloat16, torch.float32}
                      if arch == "recurrentgemma-2b" else {torch.bfloat16})
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(convert.lm_params_to_numpy(model))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_seeded_init_repeats_and_truncates():
    """The port's own init: the same seed gives the same weights, another
    seed others; every draw lies within 2 scales (truncation at +-2), the
    norm scales are zero, and the spread is the truncated normal's."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    a, b = (tf.init_lm(cfg, seed=3, device=CPU) for _ in range(2))
    c = tf.init_lm(cfg, seed=4, device=CPU)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("scale"):
            assert not pa.any(), name
        else:
            assert not torch.equal(pa, pc), name
    d, ff, h, dh = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    scales = {"embed.embedding": 1.0, "embed.lm_head": d ** -0.5,
              "mixer.wq": d ** -0.5, "mixer.wk": d ** -0.5,
              "mixer.wv": d ** -0.5, "mixer.wo": (h * dh) ** -0.5,
              "mlp.w_gate": d ** -0.5, "mlp.w_up": d ** -0.5,
              "mlp.w_down": ff ** -0.5}
    for name, p in a.named_parameters():
        key = next((k for k in scales if name.endswith(k)), None)
        if key is None:
            continue
        s = scales[key]
        assert p.abs().max().item() <= 2.0 * s * (1 + 1e-6), name
        # std of a normal truncated at +-2: 0.8796
        assert abs(p.std().item() / s - 0.8796) < 0.05, name


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, models):
    cfg, params, model = models[arch]
    toks = _tokens(cfg, (2, 12))
    want, _, _ = jtf.forward(params, _jcfg(cfg), jnp.asarray(toks))
    got, cache = model(torch.as_tensor(toks))
    assert cache is None and got.shape == (2, 12, cfg.padded_vocab)
    assert _rel(got, want) < RTOL


def test_forward_query_chunks_match_one_chunk(monkeypatch):
    """More than 1,024 queries run in chunks of 1,024 (``_pick_chunk``):
    the same logits as one chunk, within float32 rounding."""
    from repro_torch.models import attention

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              window=0)
    model = tf.init_lm(cfg, seed=0, device=CPU)
    toks = torch.as_tensor(_tokens(cfg, (1, 1100)))
    got, _ = model(toks)
    monkeypatch.setattr(attention, "_pick_chunk", lambda sq, t: sq)
    want, _ = model(toks)
    assert _rel(got, want) < RTOL


# -------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch, models):
    """Prefill + step-by-step decode (float32 cache) reproduces the full
    forward's logits (tests/test_decode_consistency.py)."""
    cfg, _params, model = models[arch]
    toks = _tokens(cfg, (2, 12))
    full, _ = model(torch.as_tensor(toks))
    st = engine.prefill(model, toks[:, :8], max_len=14,
                        cache_dtype=torch.float32)
    for i in range(8, 12):
        st = engine.decode_step(model, toks[:, i:i + 1], st)
    assert _rel(st.last_logits, full[:, -1]) < RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bf16_cache_matches_jax(arch, models):
    """With the default bfloat16 cache under float32 weights, the port
    casts K/V where the JAX package does: every step's logits agree."""
    cfg, params, model = models[arch]
    jcfg = _jcfg(cfg)
    toks = _tokens(cfg, (2, 12), seed=5)
    jst = jengine.prefill(params, jcfg, jnp.asarray(toks[:, :8]),
                          max_len=14)
    st = engine.prefill(model, toks[:, :8], max_len=14)
    for layer in st.cache["layers"]:
        if "k" in layer or "c_kv" in layer:
            assert layer.get("k", layer.get("c_kv")).dtype == torch.bfloat16
        else:                       # recurrent states stay float32
            assert all(t.dtype == torch.float32
                       for t in _cache_tensors(layer))
    assert _rel(st.last_logits, jst.last_logits) < RTOL
    for i in range(8, 12):
        jst = jengine.decode_step(params, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                  jst)
        st = engine.decode_step(model, toks[:, i:i + 1], st)
        assert _rel(st.last_logits, jst.last_logits) < RTOL


def test_swa_ring_wraparound_matches_full_and_jax():
    """Window 16: a 30-token prefill keeps the last window rolled (slot ==
    pos % 16), 10 decode steps wrap the ring; the logits match the full
    forward and the JAX package's ring."""
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              window=16)
    params, model = _pair(cfg)
    toks = _tokens(cfg, (1, 40))
    full, _ = model(torch.as_tensor(toks))
    jfull, _, _ = jtf.forward(params, _jcfg(cfg), jnp.asarray(toks))
    assert _rel(full, jfull) < RTOL
    st = engine.prefill(model, toks[:, :30], max_len=48,
                        cache_dtype=torch.float32)
    pos = st.cache["layers"][0]["pos"][0]
    assert torch.equal(pos % 16, torch.arange(16, dtype=pos.dtype))
    assert int(pos.min()) == 14 and int(pos.max()) == 29
    jst = jengine.prefill(params, _jcfg(cfg), jnp.asarray(toks[:, :30]),
                          max_len=48, cache_dtype=jnp.float32)
    for i in range(30, 40):
        st = engine.decode_step(model, toks[:, i:i + 1], st)
        jst = jengine.decode_step(params, _jcfg(cfg),
                                  jnp.asarray(toks[:, i:i + 1]), jst)
    assert _rel(st.last_logits, full[:, -1]) < RTOL
    assert _rel(st.last_logits, jst.last_logits) < RTOL


def _cache_tensors(layer: dict):
    for t in layer.values():
        yield from _cache_tensors(t) if isinstance(t, dict) else (t,)


def test_local_attention_ring_wraparound_matches_full_and_jax():
    """Reduced recurrentgemma-2b with a local window of 32: a 40-token
    prompt keeps the last 32 positions rolled (slot == pos % 32) beside
    the RG-LRU states, 8 decode steps wrap the ring; the logits match the
    full forward and the JAX package's decode."""
    cfg = get_config("recurrentgemma-2b").reduced()
    assert cfg.local_window == 32
    params, model = _pair(cfg)
    jcfg = _jcfg(cfg)
    toks = _tokens(cfg, (1, 48))
    full, _ = model(torch.as_tensor(toks))
    jfull, _, _ = jtf.forward(params, jcfg, jnp.asarray(toks))
    assert _rel(full, jfull) < RTOL
    st = engine.prefill(model, toks[:, :40], max_len=56,
                        cache_dtype=torch.float32)
    ring = st.cache["layers"][tf.layer_kinds(cfg).index("local_attn")]
    pos = ring["pos"][0]
    assert ring["k"].shape[2] == 32
    assert torch.equal(pos % 32, torch.arange(32, dtype=pos.dtype))
    assert int(pos.min()) == 8 and int(pos.max()) == 39
    jst = jengine.prefill(params, jcfg, jnp.asarray(toks[:, :40]),
                          max_len=56, cache_dtype=jnp.float32)
    for i in range(40, 48):
        st = engine.decode_step(model, toks[:, i:i + 1], st)
        jst = jengine.decode_step(params, jcfg,
                                  jnp.asarray(toks[:, i:i + 1]), jst)
        assert _rel(st.last_logits, jst.last_logits) < RTOL
    assert _rel(st.last_logits, full[:, -1]) < RTOL


def test_layer_kinds_and_caches_follow_the_jax_layer_order():
    """recurrentgemma-2b: 8 periods of (rglru, rglru, local_attn) and a
    tail of two rglru; each layer's cache by its kind, states float32 with
    m at -1e30, the ring min(local_window, max_len) slots."""
    cfg = get_config("recurrentgemma-2b")
    kinds = tf.layer_kinds(cfg)
    assert kinds == ["rglru", "rglru", "local_attn"] * 8 + ["rglru"] * 2
    assert tf.layer_mlps(cfg) == ["geglu"] * 26
    small = get_config("xlstm-125m").reduced()
    assert tf.layer_kinds(small) == ["mlstm", "slstm"]
    assert tf.layer_mlps(small) == [None, None]
    cache = tf.init_stack_cache(small, 3, 20, device=CPU)
    m_cache, s_cache = cache["layers"]
    assert set(m_cache) == {"state", "conv"}
    assert set(m_cache["state"]) == {"C", "n", "m"}
    assert set(s_cache) == {"state"}
    assert set(s_cache["state"]) == {"c", "n", "h", "m"}
    assert (m_cache["state"]["m"] == -1e30).all()
    assert (s_cache["state"]["m"] == -1e30).all()
    rg = get_config("recurrentgemma-2b").reduced()
    layers = tf.init_stack_cache(rg, 2, 20, device=CPU)["layers"]
    assert set(layers[0]) == {"h", "conv"}
    assert layers[0]["conv"].shape == (2, rg.conv1d_width - 1,
                                       rg.rglru_width)
    assert layers[2]["k"].shape[2] == min(rg.local_window, 20)
    for layer in (m_cache, s_cache, layers[0]):
        assert all(t.dtype == torch.float32 for t in _cache_tensors(layer))


def test_recurrent_seeded_init_draws_weights_not_lam_bias_or_norms():
    """xlstm-125m and recurrentgemma-2b reduced: the same seed gives the
    same weights, another seed other weights; lam stays linspace(-4, -1),
    the conv bias and every norm scale zero."""
    for arch in ("xlstm-125m", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        a, b = (tf.init_lm(cfg, seed=3, device=CPU) for _ in range(2))
        c = tf.init_lm(cfg, seed=4, device=CPU)
        for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                      c.parameters()):
            assert torch.equal(pa, pb), name
            if name.endswith("lam"):
                assert torch.equal(pa, torch.linspace(-4.0, -1.0,
                                                      pa.shape[0]))
                assert torch.equal(pa, pc)
            elif name.endswith("scale") or name.endswith("conv.b"):
                assert not pa.any(), name
            else:
                assert not torch.equal(pa, pc), name


def test_decode_rows_are_batch_invariant():
    """A row decoded among S lanes at different depths has the bits of the
    same row decoded alone (row-padded products, per-row attention)."""
    model = tf.init_lm(get_config("gemma-7b").reduced(), seed=1,
                       device=CPU)
    cfg = model.cfg
    lens = [5, 9, 3]
    prompts = [_tokens(cfg, (1, n), seed=n) for n in lens]
    solo = [engine.prefill(model, p, max_len=24) for p in prompts]
    table = engine.init_lm_slot_state(solo[0], len(lens))
    for lane, st in enumerate(solo):
        table = engine.admit_lane(table, lane, st, seed=lane, max_t=8)
    nxt = torch.as_tensor([[7], [11], [13]])
    logits, _ = model(nxt, cache=table.cache,
                      positions=table.pos[:, None])
    for lane, st in enumerate(solo):
        st = engine.decode_step(model, nxt[lane:lane + 1], st)
        assert torch.equal(logits[lane, -1], st.last_logits[0])
        for a, b in zip(table.cache["layers"], st.cache["layers"]):
            assert torch.equal(a["k"][lane], b["k"][0])
    assert table.cache["index"].tolist() == [n + 1 for n in lens]


# --------------------------------------------------------------- probe
def test_probe_features_match_jax_and_separate():
    """The SVM probe on LM features (examples/svm_probe_lm.py, reduced
    gemma-7b): the pooled logits within 1e-4 of JAX's, and the port's
    nu-SVM separates the two token ranges."""
    from repro_torch.core.svm import SaddleNuSVC

    cfg = get_config("gemma-7b").reduced()
    params, model = _pair(cfg)
    rng = np.random.default_rng(0)
    n = 40
    toks = np.vstack([rng.integers(0, cfg.vocab_size // 4, size=(n, 24)),
                      rng.integers(cfg.vocab_size // 2, cfg.vocab_size - 1,
                                   size=(n, 24))])
    want, _, _ = jtf.forward(params, _jcfg(cfg), jnp.asarray(toks))
    want = np.asarray(want.mean(axis=1))[:, :128]
    got, _ = model(torch.as_tensor(toks))
    got = got.mean(dim=1)[:, :128].numpy()
    assert _rel(got, want) < RTOL
    y = np.r_[np.ones(n), -np.ones(n)]
    clf = SaddleNuSVC(alpha=0.6, eps=1e-3, beta=0.1, num_iters=1500,
                      device=CPU).fit(got, y)
    assert clf.score(got, y) >= 0.9
