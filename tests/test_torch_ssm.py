"""The port's recurrent mixers (repro_torch.models.ssm) on the CPU, held
to the JAX package's (repro.models.ssm) on the same inputs and weights:
the causal conv, the mLSTM's parallel form, closed-form final state and
recurrent step, the sLSTM's scan and step, the RG-LRU's log-depth scan and
step, and each block with its cache.  Inputs are drawn with numpy from a
seed; JAX's weights come from its own initialisers.

Tolerances: the conv at 1e-6 (the same float32 sums), every other
function at 1e-5 of the reference's max |value| (float32 products and
sums in two frameworks; the RG-LRU scan also rounds in another order
than ``associative_scan``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

pytestmark = pytest.mark.serve

CONV_TOL = 1e-6
RTOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _normal(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cfgs(arch):
    cfg = get_config(arch).reduced()
    return cfg, dataclasses.replace(jget_config(arch),
                                    **dataclasses.asdict(cfg))


def _port(module, params):
    """``module`` with the weights of the JAX pytree ``params`` (the
    dotted parameter name is the path of the leaf)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = params
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(_t(leaf))
    return module


# ------------------------------------------------------------ causal conv
@pytest.mark.parametrize("s", [1, 2, 7])
def test_causal_conv_prefill_then_decode_with_history(s):
    """A prompt of ``s`` from zero history, then four one-token steps
    each reading the history the step before left."""
    b, c, width = 2, 6, 4
    params = {"w": jnp.asarray(_normal((width, c), 1)),
              "b": jnp.asarray(_normal((c,), 2))}
    x = _normal((b, s + 4, c), 3)
    want, jbuf = jssm.causal_conv1d(params, jnp.asarray(x[:, :s]))
    got, buf = ssm.causal_conv1d(_t(params["w"]), _t(params["b"]),
                                 _t(x[:, :s]))
    assert _rel(got, want) < CONV_TOL and np.array_equal(buf, jbuf)
    for t in range(s, s + 4):
        want, jbuf = jssm.causal_conv1d(params, jnp.asarray(x[:, t:t + 1]),
                                        jbuf)
        got, buf = ssm.causal_conv1d(_t(params["w"]), _t(params["b"]),
                                     _t(x[:, t:t + 1]), buf)
        assert _rel(got, want) < CONV_TOL
        assert np.array_equal(buf, jbuf)
    # the steps equal one pass over the whole sequence
    whole, _ = ssm.causal_conv1d(_t(params["w"]), _t(params["b"]), _t(x))
    assert _rel(got[:, 0], whole[:, -1]) < CONV_TOL


# ------------------------------------------------------------------ mLSTM
def _mlstm_inputs(b=2, s=40, h=2, dh=8, seed=0):
    q, k, v = (_normal((b, s, h, dh), seed + i) for i in range(3))
    i_pre = _normal((b, s, h), seed + 3, 2.0)
    f_pre = _normal((b, s, h), seed + 4, 2.0) + 2.0
    return q, k, v, i_pre, f_pre


@pytest.mark.parametrize("s,chunk", [(40, 16), (40, 40), (5, 16)])
def test_mlstm_parallel_matches_jax(s, chunk):
    """S = 40 in chunks of 16 (three chunks, the last padded), in one
    chunk, and a prompt shorter than the chunk."""
    args = _mlstm_inputs(s=s)
    want = jssm._mlstm_parallel(*map(jnp.asarray, args), chunk=chunk)
    got = ssm.mlstm_parallel(*map(_t, args), chunk=chunk)
    assert got.shape == want.shape
    assert _rel(got, want) < RTOL


def test_mlstm_final_state_matches_jax_and_the_recurrence():
    """The closed form against JAX's, and against 40 recurrent steps from
    a fresh state."""
    q, k, v, i_pre, f_pre = _mlstm_inputs()
    want = jssm._mlstm_final_state(*map(jnp.asarray, (k, v, i_pre, f_pre)))
    got = ssm.mlstm_final_state(*map(_t, (k, v, i_pre, f_pre)))
    for name in ("C", "n", "m"):
        assert _rel(got[name], want[name]) < RTOL, name
    b, _, h, dh = q.shape
    st = {"C": torch.zeros((b, h, dh, dh)), "n": torch.zeros((b, h, dh)),
          "m": torch.full((b, h), ssm.M_INIT)}
    for t in range(q.shape[1]):
        _, st = ssm.mlstm_recurrent(
            *(_t(a[:, t:t + 1]) for a in (q, k, v, i_pre, f_pre)), st)
    for name in ("C", "n", "m"):
        assert _rel(st[name], want[name]) < RTOL, name


def test_mlstm_recurrent_step_matches_jax():
    q, k, v, i_pre, f_pre = _mlstm_inputs(s=1, seed=5)
    b, _, h, dh = q.shape
    state = {"C": _normal((b, h, dh, dh), 11), "n": _normal((b, h, dh), 12),
             "m": _normal((b, h), 13)}
    args = (q, k, v, i_pre, f_pre)
    want, jst = jssm._mlstm_recurrent(
        *map(jnp.asarray, args), {n: jnp.asarray(a) for n, a in state.items()})
    got, st = ssm.mlstm_recurrent(*map(_t, args),
                                  {n: _t(a) for n, a in state.items()})
    assert _rel(got, want) < RTOL
    for name in ("C", "n", "m"):
        assert _rel(st[name], jst[name]) < RTOL, name


def _mlstm_pair():
    cfg, jcfg = _cfgs("xlstm-125m")
    params = jssm.init_mlstm(jax.random.key(3), jcfg)
    return cfg, jcfg, params, _port(ssm.MLSTM(cfg, "cpu"), params)


def test_mlstm_block_prefill_and_decode_match_jax():
    """A 20-token prompt into an empty cache, then three decode steps
    carrying the cache."""
    cfg, jcfg, params, block = _mlstm_pair()
    x = _normal((2, 23, cfg.d_model), 7)
    jcache = jssm.init_mlstm_cache(jcfg, 2)
    cache = ssm.init_mlstm_cache(cfg, 2)
    want, jcache = jssm.mlstm_block(params, jnp.asarray(x[:, :20]), jcfg,
                                    cache=jcache)
    got = block(_t(x[:, :20]), cache=cache)
    assert _rel(got, want) < RTOL
    for t in range(20, 23):
        want, jcache = jssm.mlstm_block(params, jnp.asarray(x[:, t:t + 1]),
                                        jcfg, cache=jcache)
        got = block(_t(x[:, t:t + 1]), cache=cache)
        assert _rel(got, want) < RTOL
    for name in ("C", "n", "m"):
        assert _rel(cache["state"][name], jcache["state"][name]) < RTOL
    assert _rel(cache["conv"], jcache["conv"]) < RTOL


# ------------------------------------------------------------------ sLSTM
def _slstm_pair():
    cfg, jcfg = _cfgs("xlstm-125m")
    params = jssm.init_slstm(jax.random.key(4), jcfg)
    return cfg, jcfg, params, _port(ssm.SLSTM(cfg, "cpu"), params)


def _slstm_state(cfg, b, seed):
    h = cfg.num_heads
    dh = cfg.d_model // h
    return {"c": _normal((b, h, dh), seed),
            "n": np.abs(_normal((b, h, dh), seed + 1)) + 0.5,
            "h": _normal((b, h, dh), seed + 2, 0.5),
            "m": _normal((b, h, dh), seed + 3)}


@pytest.mark.parametrize("s", [1, 9])
def test_slstm_block_from_a_given_state_matches_jax(s):
    """``s`` = 9: the scan from the cache's state (a prefill); 1: one
    decode step."""
    cfg, jcfg, params, block = _slstm_pair()
    x = _normal((2, s, cfg.d_model), 8)
    state = _slstm_state(cfg, 2, 20)
    want, jcache = jssm.slstm_block(
        params, jnp.asarray(x), jcfg,
        cache={"state": {n: jnp.asarray(a) for n, a in state.items()}})
    cache = {"state": {n: _t(a).clone() for n, a in state.items()}}
    got = block(_t(x), cache=cache)
    assert _rel(got, want) < RTOL
    for name in ("c", "n", "h", "m"):
        assert _rel(cache["state"][name], jcache["state"][name]) < RTOL


def test_slstm_cell_matches_jax():
    cfg, _jcfg, _params, _block = _slstm_pair()
    dh = cfg.d_model // cfg.num_heads
    pre = _normal((2, cfg.num_heads, 4 * dh), 30, 2.0)
    state = _slstm_state(cfg, 2, 31)
    want = jssm._slstm_cell(jnp.asarray(pre),
                            {n: jnp.asarray(a) for n, a in state.items()}, dh)
    got = ssm.slstm_cell(_t(pre), {n: _t(a) for n, a in state.items()}, dh)
    for name in ("c", "n", "h", "m"):
        assert _rel(got[name], want[name]) < RTOL, name


# ----------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("s", [1, 7, 300])
def test_rglru_scan_matches_jax(s):
    b, w = 2, 16
    x, r, i = (_normal((b, s, w), 40 + j) for j in range(3))
    lam = np.linspace(-4.0, -1.0, w).astype(np.float32)
    want = jssm._rglru_scan(*map(jnp.asarray, (x, r, i, lam)))
    got = ssm.rglru_scan(*map(_t, (x, r, i, lam)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < RTOL


def _rglru_pair():
    cfg, jcfg = _cfgs("recurrentgemma-2b")
    params = jssm.init_rglru(jax.random.key(5), jcfg)
    return cfg, jcfg, params, _port(ssm.RGLRU(cfg, "cpu"), params)


def test_rglru_block_prefill_and_decode_match_jax():
    """A 12-token prompt (its final h and conv history), then three decode
    steps, against ``rglru_block``."""
    cfg, jcfg, params, block = _rglru_pair()
    x = _normal((2, 15, cfg.d_model), 9)
    jcache = jssm.init_rglru_cache(jcfg, 2)
    cache = ssm.init_rglru_cache(cfg, 2)
    want, jcache = jssm.rglru_block(params, jnp.asarray(x[:, :12]), jcfg,
                                    cache=jcache)
    got = block(_t(x[:, :12]), cache=cache)
    assert _rel(got, want) < RTOL
    for t in range(12, 15):
        want, jcache = jssm.rglru_block(params, jnp.asarray(x[:, t:t + 1]),
                                        jcfg, cache=jcache)
        got = block(_t(x[:, t:t + 1]), cache=cache)
        assert _rel(got, want) < RTOL
    assert _rel(cache["h"], jcache["h"]) < RTOL
    assert _rel(cache["conv"], jcache["conv"]) < RTOL


def test_rglru_lam_is_float32_linspace_in_a_bfloat16_model():
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    block = ssm.RGLRU(cfg, "cpu")
    assert block.w_r.dtype == torch.bfloat16
    assert block.lam.dtype == torch.float32
    jlam = np.asarray(jssm.init_rglru(jax.random.key(0), cfg)["lam"])
    np.testing.assert_allclose(block.lam.numpy(), jlam, rtol=0, atol=1e-6)


# ------------------------------------------------- the row-padded decode
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_decode_padding_rows_read_fresh_state_and_are_not_written(kind):
    """A decode step on 8 rows against a cache of 2 lanes: the 2 real rows
    equal a decode of the 2 alone, the padding rows equal a decode from a
    fresh cache, and only the 2 lanes' state is written."""
    cfg = get_config("xlstm-125m" if kind != "rglru"
                     else "recurrentgemma-2b").reduced()
    block = {"rglru": ssm.RGLRU, "mlstm": ssm.MLSTM,
             "slstm": ssm.SLSTM}[kind](cfg, "cpu")
    block.reset_parameters(torch.Generator().manual_seed(0))
    init = {"rglru": ssm.init_rglru_cache, "mlstm": ssm.init_mlstm_cache,
            "slstm": ssm.init_slstm_cache}[kind]
    x = _t(_normal((8, 6, cfg.d_model), 50))
    cache = init(cfg, 2)
    block(x[:2, :5], cache=cache)                      # a 5-token prompt

    def clone(c):
        return {n: clone(t) if isinstance(t, dict) else t.clone()
                for n, t in c.items()}

    alone = clone(cache)
    want = block(x[:2, 5:], cache=alone)
    fresh = init(cfg, 6)
    want_pad = block(x[2:, 5:], cache=fresh)
    got = block(x[:, 5:], cache=cache)
    assert _rel(got[:2], want) < 1e-6
    assert _rel(got[2:], want_pad) < 1e-6

    def leaves(c):
        for t in c.values():
            yield from leaves(t) if isinstance(t, dict) else (t,)

    for a, b in zip(leaves(cache), leaves(alone)):
        assert a.shape[0] == 2 and _rel(a, b) < 1e-6
