"""The port's vision-language backbone (qwen2-vl-7b, reduced: 2 layers, d
256, 4 heads / 4 KV heads of 64, vocab 512) on the CPU, held to the JAX
package's with the same float32 weights (``convert.lm_params_from_jax``):
M-RoPE's tables with distinct t/h/w streams against JAX's
``apply_rope(mrope_sections=)`` (equal streams give the 1-D tables bit for
bit), a forward at explicit (3, B, S) positions (a 4 x 8 patch grid
between text), a forward and a greedy ``generate`` with patch embeddings
in place of the masked tokens', and text requests through the slot-mode
``LMService`` against solo ``generate`` and JAX's service.

Tolerances: logits within 1e-4 of max |logit| (the JAX package's
decode-consistency bound, tests/test_decode_consistency.py), tokens
exact; rotated activations within 1e-6 of their largest magnitude."""

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
from repro_torch.serve import engine
from repro_torch.serve.lm_service import LMService

pytestmark = [pytest.mark.serve, pytest.mark.usefixtures("one_thread")]

CPU = "cpu"
RTOL = 1e-4          # of max |logit|
GRID = (4, 8)        # patch rows x columns
TEXT = (3, 5)        # text tokens before and after the patches


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _jcfg(cfg):
    return dataclasses.replace(jget_config(cfg.name),
                               **dataclasses.asdict(cfg))


def mrope_positions(b: int, grid=GRID, text=TEXT) -> np.ndarray:
    """(3, b, S) t/h/w positions of ``text[0]`` tokens, a patch grid and
    ``text[1]`` tokens, as Qwen2-VL lays them out: text at t = h = w =
    its index; the patches at t = the grid's start, h and w its start plus
    the patch's row and column; text after at one past the largest."""
    rows, cols = grid
    before = np.arange(text[0])
    t0 = text[0]
    r, c = np.divmod(np.arange(rows * cols), cols)
    patches = np.stack([np.full(rows * cols, t0), t0 + r, t0 + c])
    start = patches.max() + 1
    after = np.arange(start, start + text[1])
    pos = np.concatenate([np.stack([before] * 3), patches,
                          np.stack([after] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(
        np.int32)


@pytest.fixture(scope="module")
def qwen():
    """(cfg, JAX params, the port's model with the same weights)."""
    cfg = get_config("qwen2-vl-7b").reduced()
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.rope_kind,
            cfg.vision_embeds) == (2, 256, 64, "mrope", True)
    params = jtf.init_lm(jax.random.key(0), _jcfg(cfg))
    return cfg, params, convert.lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device=CPU)


def _vision(cfg, b, s, seed=4):
    """Patch embeddings (b, s, D) and a mask over the middle positions."""
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[:, s // 4:s // 4 + s // 2] = True
    return embeds, mask


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (64, (8, 12, 12))])
def test_mrope_tables_match_jax_apply_rope(head_dim, sections):
    """Distinct t/h/w streams: each section of the rotated half-dims takes
    its own stream's angles, as JAX's ``apply_rope(mrope_sections=)``."""
    assert layers.default_mrope_sections(head_dim // 2) == sections
    assert jlayers.default_mrope_sections(head_dim // 2) == sections
    pos = mrope_positions(2)
    x = np.random.default_rng(1).standard_normal(
        (2, pos.shape[2], 3, head_dim)).astype(np.float32)
    want = np.asarray(jlayers.apply_rope(
        jnp.asarray(x), jnp.asarray(pos), theta=1e6,
        mrope_sections=sections))
    sin, cos = layers.rope_tables(torch.as_tensor(pos), head_dim, theta=1e6,
                                  mrope_sections=sections)
    got = layers.apply_rope(torch.as_tensor(x), sin, cos).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the streams differ, so the sections matter
    flat = layers.apply_rope(torch.as_tensor(x), *layers.rope_tables(
        torch.as_tensor(pos[0]), head_dim, theta=1e6)).numpy()
    assert np.abs(flat - want).max() > 1e-2


def test_mrope_equal_streams_bit_equal_to_1d_tables():
    pos = torch.arange(40).reshape(2, 20)
    one = layers.rope_tables(pos, 128, theta=1e6)
    three = layers.rope_tables(pos[None].expand(3, 2, 20), 128, theta=1e6,
                               mrope_sections=(16, 24, 24))
    for a, b in zip(one, three):
        assert torch.equal(a, b)


def test_forward_at_mrope_positions_matches_jax(qwen):
    cfg, params, model = qwen
    pos = mrope_positions(2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, pos.shape[2]))
    want, _, _ = jtf.forward(params, _jcfg(cfg), jnp.asarray(toks),
                             positions=jnp.asarray(pos))
    got, _ = model(torch.as_tensor(toks), positions=torch.as_tensor(pos))
    assert _rel(got, want) < RTOL
    # 1-D positions are three equal streams
    flat, _ = model(torch.as_tensor(toks))
    assert torch.equal(flat, model(torch.as_tensor(toks), positions=(
        torch.arange(pos.shape[2])[None, None].expand(3, 2, -1)))[0])
    assert _rel(got, flat) > 1e-3


def test_vision_masked_forward_matches_jax(qwen):
    cfg, params, model = qwen
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    embeds, mask = _vision(cfg, 2, 16)
    want, _, _ = jtf.forward(params, _jcfg(cfg), jnp.asarray(toks),
                             vision_embeds=jnp.asarray(embeds),
                             vision_mask=jnp.asarray(mask))
    got, _ = model(torch.as_tensor(toks),
                   vision_embeds=torch.as_tensor(embeds),
                   vision_mask=torch.as_tensor(mask))
    assert _rel(got, want) < RTOL
    plain, _ = model(torch.as_tensor(toks))
    assert _rel(got, plain) > 1e-3


def test_vision_generate_matches_jax(qwen):
    """A vision-conditioned ``generate`` takes the exact-length prefill in
    both packages; greedy tokens equal."""
    cfg, params, model = qwen
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    embeds, mask = _vision(cfg, 2, 12, seed=6)
    want = jengine.generate(params, _jcfg(cfg), jnp.asarray(toks), steps=6,
                            vision_embeds=jnp.asarray(embeds),
                            vision_mask=jnp.asarray(mask))
    got = engine.generate(model, toks, steps=6, vision_embeds=embeds,
                          vision_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(),
                              engine.generate(model, toks, steps=6).numpy())


def test_slot_service_matches_solo_and_jax_service(qwen):
    """M-RoPE text requests run in slot mode: three staggered requests
    (buckets 8, 8, 16; one admitted mid-decode), each equal to its solo
    ``generate`` at the service's capacity and to JAX's service tokens
    and admission chunks."""
    cfg, params, model = qwen
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in (6, 7, 11)]
    steps, seeds = (12, 8, 6), (3, 5, 7)
    out = []
    for svc in (JLMService(params, _jcfg(cfg), num_slots=2, chunk_steps=4,
                           max_len=48),
                LMService(model, num_slots=2, chunk_steps=4, max_len=48)):
        assert svc.slot_mode
        rids = [svc.submit(prompts[0], steps[0], seed=seeds[0])]
        assert svc.step() == []
        rids += [svc.submit(p, n, seed=sd) for p, n, sd in
                 zip(prompts[1:], steps[1:], seeds[1:])]
        res = svc.run()
        out.append([(np.asarray(res[r].tokens), res[r].admitted_chunk)
                    for r in rids])
    for (jt, jc), (t, c), p, n, sd in zip(*out, prompts, steps, seeds):
        np.testing.assert_array_equal(t, jt)
        assert c == jc
        np.testing.assert_array_equal(t, engine.generate(
            model, p[None], steps=n, seed=sd, max_len=48,
            rows=LMService(model, num_slots=2).rows)[0].numpy())
    assert max(c for _, c in out[1]) > 0
