"""The port's MoE block (repro_torch.models.moe) on the CPU, held to the
JAX package's (repro.models.moe) with the same weights, and the forward
cases of tests/test_moe.py mirrored on the port: reduced
deepseek-v2-lite-16b (4 experts, top-2, one shared expert), float32.

Tolerances: ``out`` within 1e-5 of JAX's relative to max |out|, ``aux``
within 1e-6 (float32 sums of the same terms in two frameworks).  The
gradient case of tests/test_moe.py waits for the training slice: the
port has no backward pass yet."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_launch_workers import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.serve import engine

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = "cpu"
OUT_RTOL, AUX_ATOL = 1e-5, 1e-6


def _cfg(**kw):
    return dataclasses.replace(
        get_config("deepseek-v2-lite-16b").reduced(), **kw)


def _pair(cfg, seed=0):
    """(JAX params, the port's MoE with the same weights)."""
    jcfg = dataclasses.replace(jget_config(cfg.name),
                               **dataclasses.asdict(cfg))
    params = jmoe.init_moe(jax.random.key(seed), jcfg)
    block = moe.MoE(cfg, CPU)
    with torch.no_grad():
        for name, p in block.named_parameters():
            leaf = params
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(torch.as_tensor(np.array(leaf)))
    return jcfg, params, block


def _x(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * 0.5)


def _drops(block, x):
    """Choices dropped by capacity in the port's routing of x."""
    cfg = block.cfg
    b, s, d = x.shape
    g = moe.num_groups(b * s)
    cap = moe.capacity(b * s // g, cfg)
    probs = torch.softmax(x.reshape(g, -1, d).float() @ block.router, -1)
    _, top_e = moe.top_k(probs, cfg.moe_top_k)
    slot = moe.dispatch(top_e.reshape(g, -1), cfg.moe_num_experts, cap)
    return int((slot == cfg.moe_num_experts * cap).sum())


# ---------------------------------------------- tests/test_moe.py, mirrored
def test_moe_output_shape_and_finite():
    cfg = _cfg()
    _, _, block = _pair(cfg)
    x = torch.as_tensor(_x((2, 16, cfg.d_model)) * 0.2)
    out, aux = block(x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert float(aux) >= 0.99    # E * sum f_e p_e >= 1 by Cauchy-Schwarz


def test_single_expert_equals_dense():
    """E = 1, top-1, generous capacity: routing is the identity and the
    MoE (no shared experts) is a plain GLU."""
    cfg = _cfg(moe_num_experts=1, moe_top_k=1, moe_num_shared=0,
               moe_capacity_factor=2.0)
    _, _, block = _pair(cfg)
    x = torch.as_tensor(_x((2, 8, cfg.d_model)) * 0.2)
    out, _ = block(x)
    ref = (F.silu(x @ block.expert_gate[0])
           * (x @ block.expert_up[0])) @ block.expert_down[0]
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def test_capacity_drops_overflow():
    """Capacity factor ~0 (capacity 1 an expert, at least one is kept):
    most of the output is the shared experts'."""
    cfg = _cfg(moe_capacity_factor=1e-6)
    _, _, block = _pair(cfg)
    x = torch.as_tensor(_x((1, 8, cfg.d_model)) * 0.2)
    out, _ = block(x)
    shared_only = block.shared(x)
    diff = (out - shared_only).abs()
    assert diff.median() / (shared_only.abs().max() + 1e-9) < 0.5


@pytest.mark.parametrize("n,want", [(1_048_576, 32), (128, 32), (30, 30),
                                    (31, 31), (80, 20), (1, 1)])
def test_grouping_divides(n, want):
    assert moe.num_groups(n) == want == jmoe._num_groups(n, 32)


# -------------------------------------------------------- against JAX
@pytest.mark.parametrize("shape,kw,drops", [
    ((2, 16, 256), {}, False),                  # 32 groups of one token
    ((2, 40, 256), {}, True),                   # 20 groups of 4, cap 3
    ((2, 40, 256), {"moe_capacity_factor": 0.5}, True),   # cap 1
    ((3, 7, 256), {"moe_num_shared": 0}, False),          # 21 groups
])
def test_moe_block_matches_jax(shape, kw, drops):
    cfg = _cfg(**kw)
    jcfg, params, block = _pair(cfg)
    x = _x(shape)
    want, jaux = jmoe.moe_block(params, jnp.asarray(x), jcfg)
    got, aux = block(torch.as_tensor(x))
    want = np.asarray(want)
    assert (np.abs(got.numpy() - want).max() / np.abs(want).max()
            < OUT_RTOL)
    assert abs(float(aux) - float(jaux)) < AUX_ATOL
    assert (_drops(block, torch.as_tensor(x)) > 0) == drops


def test_top_k_keeps_the_lower_index_on_a_tie():
    probs = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0]])
    values, index = moe.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert index.tolist() == np.asarray(ji).tolist() == [[1, 3, 0]]
    assert values.tolist() == np.asarray(jv).tolist()


def test_dispatch_keeps_the_first_tokens_of_each_expert():
    """Stable sort by expert: each expert keeps its first ``cap`` choices
    in token order; the rest go to the dummy slot."""
    top_e = torch.tensor([[2, 0, 2, 1, 2, 0, 2, 2]])     # 4 tokens, k = 2
    slot = moe.dispatch(top_e, num_experts=3, cap=2)
    assert slot.tolist() == [[4, 0, 5, 2, 6, 1, 6, 6]]


def test_forty_lane_decode_does_not_couple_lanes():
    """40 rows route as 40 groups of one token in decode (the JAX
    service's lanes are batches of one): a lane equals its solo decode at
    the same rows, bit for bit, whatever its batch-mates hold; over the
    whole batch the JAX package's grouping would put two tokens a group
    with one slot an expert."""
    cfg = _cfg(moe_num_experts=16)
    model = tf.init_lm(cfg, seed=3, device=CPU)
    lanes, rows = 40, tf.decode_rows(40)
    assert moe.capacity(rows // moe.num_groups(rows), cfg) == 1
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (1, 3 + i % 5))
               for i in range(lanes)]
    solo = [engine.prefill(model, p, max_len=16) for p in prompts]
    table = engine.init_lm_slot_state(solo[0], lanes)
    for lane, st in enumerate(solo):
        table = engine.admit_lane(table, lane, st, seed=lane, max_t=4)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (lanes, 1)))
    logits, _ = model(nxt, cache=table.cache, positions=table.pos[:, None])
    for lane in (0, 17, 39):
        st = engine.decode_step(model, nxt[lane:lane + 1], solo[lane],
                                rows=rows)
        assert torch.equal(logits[lane, -1], st.last_logits[0])
