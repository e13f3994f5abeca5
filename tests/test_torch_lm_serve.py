"""The port's LM serving side (repro_torch.serve.engine and .lm_service) on
the CPU: bucketed prefill, greedy and temperature generation and a
staggered LMService run replayed from the JAX package's (same weights
through ``convert.lm_params_from_jax``; temperature draws replayed from
JAX's Gumbel noise, since torch's generators cannot reproduce threefry),
then the service contracts of tests/test_lm_service.py and
tests/test_faults.py held to the port's own solo ``generate``:
mid-decode admission, lane reuse, the temperature chain, no set-up after
warm-up, the fallback path for window configs, intake validation,
deadline order, quarantine, retry and cancellation.  The recurrent
families (xlstm-125m, recurrentgemma-2b) generate JAX's tokens and take
the fallback in deadline order.  deepseek-v2-lite-16b
(MLA, MoE) serves in slot mode like gemma-7b, and services of more than
one row tile (S = 9, 12) keep every lane bit-equal to a solo decode at the
service's row count.

Tokens are compared exactly (greedy and replayed samples are argmaxes of
float32 logits that agree within 1e-4 across the packages); reduced
configs, float32 weights, the default bfloat16 cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve.lm_service import LMService as JLMService
from repro_torch import convert
from repro_torch.configs import get_config, list_configs
from repro_torch.models import transformer as tf
from repro_torch.serve import engine, faults
from repro_torch.serve.lm_service import LMService
from repro_torch.serve.scheduler import (RequestFailure, ResultNotReady,
                                         Status)

pytestmark = pytest.mark.serve

CPU = "cpu"


def _jcfg(cfg):
    return dataclasses.replace(jget_config(cfg.name),
                               **dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pairs():
    """arch -> (cfg, JAX params, the port's model with the same weights)."""
    out = {}
    for arch in ("gemma-7b", "h2o-danube-1.8b", "chatglm3-6b",
                 "deepseek-v2-lite-16b", "xlstm-125m", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        params = jtf.init_lm(jax.random.key(0), _jcfg(cfg))
        out[arch] = (cfg, params, convert.lm_params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device=CPU))
    return out


@pytest.fixture(scope="module")
def gemma(pairs):
    return pairs["gemma-7b"][0], pairs["gemma-7b"][2]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, s) for s in lens]


def _solo(model, prompt, steps, seed, temperature=0.0):
    return engine.generate(model, np.asarray(prompt)[None], steps=steps,
                           temperature=temperature, seed=seed)[0].numpy()


# ------------------------------------------------------------- engine
def test_bucketing_gate_matches_jax():
    for name in list_configs():
        assert engine._can_bucket(get_config(name).reduced()) == \
            jengine._can_bucket(jget_config(name).reduced()), name


def test_prefill_bucketing_exact_with_one_setup(gemma):
    """Prompts of 5 and 7 tokens share bucket 8: the same tokens as the
    unbucketed path, and one set-up of the bucket's key."""
    cfg, model = gemma
    key = (cfg.name, 8, 8 + 4)
    for s in (5, 7):
        prompt = np.random.default_rng(s).integers(0, cfg.vocab_size,
                                                   (2, s))
        a = engine.generate(model, prompt, steps=4)
        b = engine.generate(model, prompt, steps=4, bucket_prompts=False)
        assert torch.equal(a, b)
    assert engine.trace_counts[key] == 1


def test_explicit_small_max_len_falls_back_to_exact_prefill(gemma):
    cfg, model = gemma
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 5))
    before = dict(engine.trace_counts)
    a = engine.generate(model, prompt, steps=2, max_len=7)
    b = engine.generate(model, prompt, steps=2, bucket_prompts=False)
    assert torch.equal(a, b)
    assert dict(engine.trace_counts) == before      # no bucketed prefill


@pytest.mark.parametrize("arch", ["gemma-7b", "h2o-danube-1.8b",
                                  "chatglm3-6b", "xlstm-125m",
                                  "recurrentgemma-2b"])
def test_greedy_generate_matches_jax(arch, pairs):
    cfg, params, model = pairs[arch]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
    want = jengine.generate(params, _jcfg(cfg), jnp.asarray(prompt),
                            steps=6)
    got = engine.generate(model, prompt, steps=6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,temperature", [
    ("chatglm3-6b", 0.7), ("h2o-danube-1.8b", 0.7), ("xlstm-125m", 0.7),
    ("recurrentgemma-2b", 50.0)])
def test_temperature_replays_jax_gumbel_draws(arch, temperature, pairs):
    """JAX's ``categorical`` is argmax(logits / T + gumbel(sub)) with one
    key split a token: given the same noise, the port samples the same
    tokens (and the noise mattered: greedy differs).  Reduced
    recurrentgemma-2b's tied, scaled embedding puts the last token's own
    logit ~180 above the next, so its noise needs T = 50 to move a token."""
    cfg, params, model = pairs[arch]
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 6))
    steps, seed = 8, 4
    want = jengine.generate(params, _jcfg(cfg), jnp.asarray(prompt),
                            steps=steps, temperature=temperature, seed=seed)
    key, noise = jax.random.key(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(
            sub, (1, cfg.padded_vocab), jnp.float32)))
    got = engine.generate(model, prompt, steps=steps,
                          temperature=temperature, gumbel=np.stack(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, engine.generate(model, prompt, steps=steps))


def test_service_replays_jax_service(pairs):
    """The staggered mid-decode scenario of tests/test_lm_service.py run by
    both packages' services: the same tokens and admission chunks."""
    cfg, params, model = pairs["gemma-7b"]
    p1, p2, p3 = _prompts(cfg, [6, 7, 11])          # buckets 8, 8, 16
    out = []
    for svc in (JLMService(params, _jcfg(cfg), num_slots=2, chunk_steps=4,
                           max_len=48),
                LMService(model, num_slots=2, chunk_steps=4, max_len=48)):
        r1 = svc.submit(p1, steps=12, seed=3)
        assert svc.step() == []
        r2 = svc.submit(p2, steps=8, seed=5)
        r3 = svc.submit(p3, steps=6, seed=7)
        res = svc.run()
        out.append([(np.asarray(res[r].tokens), res[r].admitted_chunk,
                     res[r].bucket) for r in (r1, r2, r3)])
    for (jt, jc, jb), (t, c, b) in zip(*out):
        np.testing.assert_array_equal(t, jt)
        assert (c, b) == (jc, jb)


def test_deepseek_mid_decode_admission_matches_solo_and_jax(pairs):
    """tests/test_lm_service.py's MLA case: a request admitted into a
    freed lane mid-decode generates the tokens of its solo ``generate``,
    and both packages' services give the same tokens and admission
    chunks (the JAX service decodes each lane as a batch of one; the
    port's MoE routes each decode row alone)."""
    cfg, params, model = pairs["deepseek-v2-lite-16b"]
    p1, p2, p3 = _prompts(cfg, [6, 7, 11])
    out = []
    for svc in (JLMService(params, _jcfg(cfg), num_slots=2, chunk_steps=4,
                           max_len=48),
                LMService(model, num_slots=2, chunk_steps=4, max_len=48)):
        assert svc.slot_mode
        r1 = svc.submit(p1, steps=12, seed=3)
        assert svc.step() == []
        r2 = svc.submit(p2, steps=8, seed=5)
        r3 = svc.submit(p3, steps=6, seed=7)
        res = svc.run()
        out.append([(np.asarray(res[r].tokens), res[r].admitted_chunk)
                    for r in (r1, r2, r3)])
    for (jt, jc), (t, c), (p, steps, seed) in zip(
            *out, [(p1, 12, 3), (p2, 8, 5), (p3, 6, 7)]):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(
            t, engine.generate(model, p[None], steps=steps, seed=seed,
                               max_len=48)[0].numpy())
        assert c == jc
    assert out[1][1][1] > 0 and out[1][2][1] > out[1][1][1]


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("lanes", [9, 12])
def test_lanes_above_one_row_tile_equal_solo_at_same_rows(pairs, arch,
                                                           lanes):
    """A service of more than DECODE_ROW_TILE lanes decodes on
    ``decode_rows(S)`` = 16 rows; a solo decode at the same rows has every
    lane's bits: one decode step's logits and cache rows bit-equal, and a
    full service run's tokens equal to solo ``generate(rows=svc.rows)``."""
    cfg, _params, model = pairs[arch]
    prompts = _prompts(cfg, [3 + (5 * i) % 11 for i in range(lanes)],
                       seed=lanes)
    svc = LMService(model, num_slots=lanes, chunk_steps=4, max_len=32)
    assert svc.rows == tf.decode_rows(lanes) == 16
    solo = [engine.prefill(model, p[None], max_len=32) for p in prompts]
    table = engine.init_lm_slot_state(solo[0], lanes)
    for lane, st in enumerate(solo):
        table = engine.admit_lane(table, lane, st, seed=lane, max_t=8)
    nxt = torch.as_tensor(_prompts(cfg, [lanes], seed=99)[0])[:, None]
    logits, _ = model(nxt, cache=table.cache, positions=table.pos[:, None])
    for lane in range(lanes):
        st = engine.decode_step(model, nxt[lane:lane + 1], solo[lane],
                                rows=svc.rows)
        assert torch.equal(logits[lane, -1], st.last_logits[0]), lane
        for a, b in zip(table.cache["layers"], st.cache["layers"]):
            for name in a:
                assert torch.equal(a[name][lane], b[name][0]), (lane, name)
    rids = [svc.submit(p, steps=6 + i % 3, seed=i)
            for i, p in enumerate(prompts)]
    res = svc.run()
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        want = engine.generate(model, p[None], steps=6 + i % 3, seed=i,
                               max_len=svc.max_len, rows=svc.rows)
        np.testing.assert_array_equal(res[rid].tokens, want[0].numpy())


def test_rows_below_the_batch_refused(gemma):
    cfg, model = gemma
    st = engine.prefill(model, np.zeros((3, 4), np.int64), max_len=8)
    with pytest.raises(ValueError, match="rows=2"):
        engine.decode_step(model, np.zeros((3, 1), np.int64), st, rows=2)


# ----------------------------------------- service contracts (port's own)
def test_mid_decode_admission_matches_solo(gemma):
    cfg, model = gemma
    p1, p2, p3 = _prompts(cfg, [6, 7, 11])
    svc = LMService(model, num_slots=2, chunk_steps=4, max_len=48)
    assert svc.slot_mode
    r1 = svc.submit(p1, steps=12, seed=3)
    assert svc.step() == []                     # chunk 1: only r1 runs
    r2 = svc.submit(p2, steps=8, seed=5)        # joins mid-decode
    r3 = svc.submit(p3, steps=6, seed=7)        # waits for a freed lane
    res = svc.run()
    for rid, p, steps, seed in [(r1, p1, 12, 3), (r2, p2, 8, 5),
                                (r3, p3, 6, 7)]:
        np.testing.assert_array_equal(res[rid].tokens,
                                      _solo(model, p, steps, seed))
    assert res[r2].admitted_chunk > 0
    assert res[r3].admitted_chunk > res[r2].admitted_chunk


def test_freed_lane_reuse_leaks_no_kv_state(gemma):
    cfg, model = gemma
    p1, p2 = _prompts(cfg, [5, 13], seed=1)     # different buckets too
    svc = LMService(model, num_slots=1, chunk_steps=4, max_len=48)
    a = svc.generate(p1, 8, seed=11)
    b = svc.generate(p2, 8, seed=12)
    np.testing.assert_array_equal(a.tokens, _solo(model, p1, 8, 11))
    np.testing.assert_array_equal(b.tokens, _solo(model, p2, 8, 12))


def test_temperature_sampling_replays_solo_chain(pairs):
    """temperature > 0: each lane's chain replays the solo sampling
    schedule (chatglm3-6b: reduced gemma-7b's tied, scaled logits are too
    peaked for noise at 0.7 to move a token)."""
    cfg, _params, model = pairs["chatglm3-6b"]
    p1, p2 = _prompts(cfg, [6, 7], seed=2)
    svc = LMService(model, num_slots=2, chunk_steps=3, max_len=32,
                    temperature=0.7)
    r1 = svc.submit(p1, steps=9, seed=21)
    svc.step()
    r2 = svc.submit(p2, steps=5, seed=22)       # mid-decode
    res = svc.run()
    for rid, p, steps, seed in [(r1, p1, 9, 21), (r2, p2, 5, 22)]:
        np.testing.assert_array_equal(
            res[rid].tokens, _solo(model, p, steps, seed, temperature=0.7))
    assert not np.array_equal(res[r1].tokens, _solo(model, p1, 9, 21))


def test_zero_setups_after_warmup(gemma):
    cfg, model = gemma
    p1, p2 = _prompts(cfg, [6, 12], seed=3)     # buckets 8 and 16
    svc = LMService(model, num_slots=2, chunk_steps=4, max_len=40)
    svc.submit(p1, steps=8, seed=0)
    svc.submit(p2, steps=6, seed=1)
    svc.run()                                   # warm-up
    compiles = svc.stats["compiles"]
    assert compiles == 3                        # two buckets, one chunk
    snap = dict(engine.trace_counts)
    svc.submit(p1, steps=8, seed=4)
    svc.step()
    svc.submit(p2, steps=6, seed=5)             # mid-decode admission
    svc.run()
    assert svc.stats["compiles"] == compiles
    assert dict(engine.trace_counts) == snap
    calls = svc.stats
    assert calls["cache_hits"] == calls["chunk_calls"] - compiles


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b",
                                  "xlstm-125m"])
def test_fallback_window_config_routes_through_solo_generate(pairs, arch):
    """A ring-buffer (window) or recurrent config cannot share decode
    lanes; the service runs each request as a solo generate, in scheduler
    order (tests/test_lm_service.py's fallback contract)."""
    cfg, _params, model = pairs[arch]
    assert not engine._can_bucket(cfg)
    p1, p2 = _prompts(cfg, [6, 9], seed=4)
    svc = LMService(model, num_slots=2, chunk_steps=4)
    assert not svc.slot_mode
    r1 = svc.submit(p1, steps=5, seed=8)
    r2 = svc.submit(p2, steps=5, seed=9, deadline=1.0)  # jumps the queue
    res = svc.run()
    np.testing.assert_array_equal(res[r1].tokens, _solo(model, p1, 5, 8))
    np.testing.assert_array_equal(res[r2].tokens, _solo(model, p2, 5, 9))
    done = [rid for rid, _ in svc.latencies]
    assert done.index(r2) < done.index(r1)


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-2b"])
def test_fallback_generate_is_prefill_then_stepwise_decode(pairs, arch):
    """A recurrent family's solo ``generate`` (the service's fallback)
    equals an exact-length prefill followed by step-by-step greedy decode,
    token for token, and its last logits match a full forward over the
    whole sequence."""
    cfg, _params, model = pairs[arch]
    prompt = _prompts(cfg, [11], seed=6)[0]
    want = LMService(model).generate(prompt, 7, seed=0).tokens
    st = engine.prefill(model, prompt[None], max_len=18)
    toks = []
    for _ in range(7):
        tok = st.last_logits.argmax(-1)
        toks.append(int(tok[0]))
        st = engine.decode_step(model, tok[:, None], st)
    np.testing.assert_array_equal(want, toks)
    full, _ = model(torch.as_tensor(np.r_[prompt, toks][None]))
    err = (st.last_logits[0] - full[0, -1]).abs().max() / full.abs().max()
    assert err < 1e-4


def test_intake_validated_at_submit(gemma):
    cfg, model = gemma
    svc = LMService(model, num_slots=2, chunk_steps=4, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        svc.submit(np.zeros(9, np.int32), steps=9)   # bucket 16 + 9 > 16
    with pytest.raises(ValueError, match="1-D"):
        svc.submit(np.zeros((1, 4), np.int32), steps=2)
    with pytest.raises(ValueError, match="integer"):
        svc.submit(np.zeros(4, np.float32), steps=2)
    with pytest.raises(ValueError, match="lie in"):
        svc.submit(np.full(4, cfg.vocab_size), steps=2)
    with pytest.raises(ValueError, match="steps"):
        svc.submit(np.zeros(4, np.int32), steps=0)


def test_deadline_request_admitted_before_slack_backlog(gemma):
    cfg, model = gemma
    p = _prompts(cfg, [5, 5, 5], seed=5)
    svc = LMService(model, num_slots=1, chunk_steps=4, max_len=32)
    r0 = svc.submit(p[0], steps=4, seed=0)
    svc.step()                                  # r0 occupies the lane
    svc.submit(p[1], steps=4, seed=1)           # slack backlog
    rid_d = svc.submit(p[2], steps=4, seed=2, deadline=0.5)
    svc.run()
    done = [rid for rid, _ in svc.latencies]
    assert done == [r0, rid_d, done[-1]]


# ----------------------------------------------------- faults, lifecycle
def _poison_run(model, prompts, victim, retries):
    inj = faults.FaultInjector(faults.FaultPlan(seed=0, faults=(
        faults.Fault("poison", rid=victim, at_chunk=1),)))
    svc = LMService(model, num_slots=3, chunk_steps=3, max_len=40,
                    fault_injector=inj)
    rids = [svc.submit(p, steps=9, seed=i, max_retries=retries)
            for i, p in enumerate(prompts)]
    res = svc.run()
    assert len(inj.fired) == 1
    return rids, res


@pytest.mark.faults
@pytest.mark.parametrize("retries", [0, 1])
def test_poisoned_lane_quarantined_batchmates_bit_equal(gemma, retries):
    """A NaN written into one lane's logits before its chunk 1 trips the
    chunk's health flag: the lane is quarantined (FAILED without retries;
    re-admitted and finished equal to solo with one), and its batch-mates
    produce exactly the tokens of an undisturbed run."""
    cfg, model = gemma
    prompts = _prompts(cfg, [6, 7, 9], seed=7)
    clean = LMService(model, num_slots=3, chunk_steps=3, max_len=40)
    ok = [clean.submit(p, steps=9, seed=i) for i, p in enumerate(prompts)]
    clean_res = clean.run()
    rids, res = _poison_run(model, prompts, victim=1, retries=retries)
    for i in (0, 2):
        np.testing.assert_array_equal(res[rids[i]].tokens,
                                      clean_res[ok[i]].tokens)
    if retries:
        np.testing.assert_array_equal(res[rids[1]].tokens,
                                      clean_res[ok[1]].tokens)
    else:
        assert isinstance(res[rids[1]], RequestFailure)
        assert res[rids[1]].status is Status.FAILED
        assert "non-finite" in res[rids[1]].reason


@pytest.mark.faults
def test_cancel_and_status_contract(gemma):
    cfg, model = gemma
    p = _prompts(cfg, [6, 7, 8], seed=8)
    svc = LMService(model, num_slots=2, chunk_steps=3, max_len=40)
    r = [svc.submit(x, steps=9, seed=i) for i, x in enumerate(p)]
    assert svc.status(r[2]) is Status.PENDING
    svc.step()
    assert svc.status(r[0]) is Status.RUNNING
    with pytest.raises(ResultNotReady):
        svc.result(r[0])
    assert svc.cancel(r[0])                     # running
    assert svc.cancel(r[2])                     # queued
    assert not svc.cancel(r[0])                 # already terminal
    res = svc.run()
    assert res[r[0]].status is Status.CANCELLED
    assert res[r[2]].status is Status.CANCELLED
    assert "queued" in res[r[2]].reason
    np.testing.assert_array_equal(res[r[1]].tokens, _solo(model, p[1], 9, 1))
    with pytest.raises(KeyError):
        svc.result(r[1])                        # claimed by run()


def test_poison_lane_logits_writes_nan_in_place():
    state = engine.LMSlotState(
        cache={}, last_logits=torch.zeros((3, 5)), pos=None, t=None,
        max_t=None, generators=(), active=None)
    out = faults.poison_lane_logits(state, 1)
    assert out is state
    assert torch.isnan(state.last_logits[1]).all()
    assert not torch.isnan(state.last_logits[[0, 2]]).any()
