"""The port's training runtime (repro_torch.train, repro_torch.data.tokens,
the training examples) on the CPU, held to the JAX package's
(repro.train, repro.data.tokens) where both compute the same thing.

Tolerances: the optimizer's master, moments and grad norm within 1e-6
relative of JAX's on the same grads (float32 elementwise arithmetic; the
two frameworks may fuse a multiply-add or round a power an ulp apart);
cross entropy 1e-6 relative.  The token pipeline and the checkpoints are
bit for bit."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.train import checkpoint, optimizer as opt, steps

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_thread")]

CPU = "cpu"
OPT_RTOL = 1e-6


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------- optimizer
def _tree(rng):
    """A small tree with a float32 and a bfloat16 leaf (numpy), as JAX
    and the port each hold it."""
    w = rng.standard_normal((3, 5)).astype(np.float32)
    e = rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)
    return {"w": w, "e": e}


def _port(tree):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == ml_dtypes.bfloat16 else torch.float32)
        for k, v in tree.items()}


OPT_CASES = {
    "clip bites, warm-up 4": dict(lr=1e-2, grad_clip=0.5, warmup_steps=4),
    "no clip, bf16 state": dict(lr=3e-3, grad_clip=0.0, warmup_steps=3,
                                state_dtype="bfloat16"),
    "defaults": dict(),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_matches_jax_three_steps(case):
    """The same numpy grads through JAX's ``apply`` and the port's, three
    steps: master, m, v (in the state dtype) and the pre-clip norm."""
    ocfg = opt.AdamWConfig(**OPT_CASES[case])
    jocfg = jopt.AdamWConfig(**ocfg._asdict())
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = _port(tree)
    jst, st = jopt.init(jparams, jocfg), opt.init(params, ocfg)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 4).astype(v.dtype)
                 for k, v in tree.items()}
        jparams, jst, jg = jopt.apply(jax.tree.map(jnp.asarray, grads), jst,
                                      jparams, jocfg)
        params, st, g = opt.apply(_port(grads), st, params, ocfg)
        np.testing.assert_allclose(float(g), float(jg), rtol=OPT_RTOL)
        if case == "clip bites, warm-up 4":
            assert float(g) > ocfg.grad_clip
        for k in tree:
            for name in ("master", "m", "v"):
                got, want = getattr(st, name)[k], getattr(jst, name)[k]
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                np.testing.assert_allclose(_np(got), _np(want),
                                           rtol=OPT_RTOL, atol=1e-30)
            # the new parameters are the master cast to their dtype
            assert params[k].dtype == (torch.bfloat16 if k == "e"
                                       else torch.float32)
            assert torch.equal(params[k], st.master[k].to(params[k].dtype))
            assert params[k].data_ptr() != st.master[k].data_ptr()
        assert int(st.step) == int(jst.step) == step + 1


def test_master_is_distinct_from_float32_parameter():
    """A float32 parameter's ``.float()`` is itself: the master must not
    share its storage, and the parameter is written only through
    ``apply``."""
    p = torch.nn.Parameter(torch.ones(4))
    st = opt.init({"w": p}, opt.AdamWConfig())
    assert st.master["w"].data_ptr() != p.data_ptr()
    st.master["w"].add_(1.0)
    assert float(p.detach().sum()) == 4.0


# ------------------------------------------ tests/test_train.py, mirrored
def test_loss_decreases_on_fixed_batch():
    cfg = get_config("chatglm3-6b").reduced()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=4)
    state = steps.init_train_state(cfg, ocfg, device=CPU)
    ts = steps.make_train_step(cfg, ocfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    losses = []
    for _ in range(10):
        state, m = ts(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7


def test_adamw_direction():
    """Single-parameter sanity: AdamW moves against the gradient."""
    params = {"w": torch.tensor([1.0, -2.0])}
    ocfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    st = opt.init(params, ocfg)
    new, st, gnorm = opt.apply({"w": torch.tensor([1.0, -1.0])}, st,
                               params, ocfg)
    assert new["w"][0] < 1.0
    assert new["w"][1] > -2.0
    assert abs(float(gnorm) - np.sqrt(2)) < 1e-5


def test_grad_clip():
    params = {"w": torch.zeros(3)}
    ocfg = opt.AdamWConfig(lr=1.0, grad_clip=0.5, weight_decay=0.0,
                           warmup_steps=1)
    st = opt.init(params, ocfg)
    _, _, gnorm = opt.apply({"w": torch.tensor([100.0, 0.0, 0.0])}, st,
                            params, ocfg)
    assert float(gnorm) == 100.0       # reported pre-clip


def test_bf16_state_dtype():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    st = opt.init(params, opt.AdamWConfig(state_dtype="bfloat16"))
    assert st.m["w"].dtype == torch.bfloat16
    assert st.v["w"].dtype == torch.bfloat16
    assert st.master["w"].dtype == torch.float32


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("xlstm-125m").reduced()
    state = steps.init_train_state(cfg, opt.AdamWConfig(), device=CPU)
    params = dict(state.model.named_parameters())
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, params)
    back = checkpoint.restore(path, {k: torch.zeros_like(v)
                                     for k, v in params.items()})
    assert back.keys() == params.keys()
    for k, v in params.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(_np(back[k]), _np(v))


def test_cross_entropy_masks_padded_vocab():
    logits = torch.zeros((1, 2, 8))
    # logits uniform over 8, but only 5 real classes -> ce = log 5
    ce = steps.cross_entropy(logits, torch.tensor([[0, 4]]), vocab_size=5)
    assert abs(float(ce) - np.log(5)) < 1e-5


# ------------------------------------------------------- cross entropy
@pytest.mark.parametrize("vocab", [50, 64])
def test_cross_entropy_matches_jax(vocab):
    """Random logits over a padded vocabulary of 64 (a tail of 14 masked,
    or none)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 64)) * 3).astype(np.float32)
    targets = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                vocab)
    got = steps.cross_entropy(torch.as_tensor(logits),
                              torch.as_tensor(targets), vocab)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_aux_weight_and_batch_keys_match_jax():
    assert steps.AUX_WEIGHT == jsteps.AUX_WEIGHT
    assert opt.AdamWConfig()._asdict() == jopt.AdamWConfig()._asdict()
    assert opt.OptState._fields == jopt.OptState._fields


# ----------------------------------------------------------- token pipeline
@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_equals_jax(seed):
    """Three batches of the port's pipeline equal the JAX package's, bit
    for bit, at two seeds."""
    ours = TokenPipeline(vocab_size=1000, seq_len=40, batch_size=3,
                         seed=seed)
    theirs = JTokenPipeline(vocab_size=1000, seq_len=40, batch_size=3,
                            seed=seed)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_token_pipeline_shapes():
    pipe = TokenPipeline(vocab_size=1000, seq_len=64, batch_size=4, seed=0)
    b = pipe.next_batch()
    assert b.tokens.shape == (4, 64) and b.targets.shape == (4, 64)
    assert (b.tokens >= 0).all() and (b.tokens < 1000).all()
    np.testing.assert_array_equal(b.tokens[:, 1:], b.targets[:, :-1])


# -------------------------------------------------------------- checkpoints
def test_checkpoint_bf16_and_int32_bit_exact(tmp_path):
    """bfloat16 leaves (stored as their bits), int32 and a 0-d step come
    back bit for bit, in a nested tree with a list and a NamedTuple."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16),
                  "i": torch.arange(7, dtype=torch.int32)},
            "l": [torch.randn(2, generator=g), np.arange(3)],
            "s": opt.OptState(master={"x": torch.ones(2)},
                              m={"x": torch.zeros(2, dtype=torch.bfloat16)},
                              v={"x": torch.full((2,), 3.0)},
                              step=torch.tensor(4, dtype=torch.int32))}
    path = str(tmp_path / "t.npz")
    checkpoint.save(path, tree)
    back = checkpoint.restore(path, tree)
    flat = dict(checkpoint._items(tree))
    flat_back = dict(checkpoint._items(back))
    assert flat.keys() == flat_back.keys()
    assert "a/w" in flat and "s/step" in flat and "l/1" in flat
    for k, v in flat.items():
        got = flat_back[k]
        if isinstance(v, torch.Tensor):
            assert got.dtype == v.dtype
            assert torch.equal(got, v)
        else:
            np.testing.assert_array_equal(got, v)
    assert isinstance(back["s"], opt.OptState)


def test_checkpoint_float32_read_by_jax(tmp_path):
    """A float32 tree the port writes (the SVM example's {"w", "b"}, and a
    nested one) is what the JAX package's ``restore`` reads."""
    rng = np.random.default_rng(5)
    tree = {"w": torch.as_tensor(rng.standard_normal(9).astype(np.float32)),
            "b": np.asarray(0.25, np.float32),
            "n": {"x": torch.as_tensor(rng.standard_normal((2, 3)),
                                       dtype=torch.float32)}}
    path = str(tmp_path / "svm.npz")
    checkpoint.save(path, tree)
    like = {"w": jnp.zeros(9), "b": jnp.zeros(()), "n": {"x":
                                                          jnp.zeros((2, 3))}}
    back = jcheckpoint.restore(path, like)
    np.testing.assert_array_equal(np.asarray(back["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(back["b"]), tree["b"])
    np.testing.assert_array_equal(np.asarray(back["n"]["x"]),
                                  tree["n"]["x"].numpy())


def test_checkpoint_missing_key_raises(tmp_path):
    path = str(tmp_path / "m.npz")
    checkpoint.save(path, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing keys"):
        checkpoint.restore(path, {"w": torch.zeros(2),
                                  "extra": torch.zeros(1)})


# ----------------------------------------------------------------- examples
def test_train_lm_example_runs_reduced():
    """``python -m repro_torch.examples.train_lm --device cpu``: reduced
    xlstm-125m, 3 steps, finite losses and grad norms, an eval step."""
    from repro_torch.examples import train_lm

    out = train_lm.main(["--arch", "xlstm-125m", "--steps", "3",
                         "--batch", "4", "--seq", "32"], device=CPU)
    assert len(out["loss"]) == len(out["grad_norm"]) == 3
    assert np.isfinite(out["loss"]).all() and np.isfinite(
        out["grad_norm"]).all()
    assert np.isfinite(out["eval"]["loss"])
    assert out["params"] > 0


def test_train_lm_example_batch_extras():
    """The vision and audio configs' batches carry JAX's extras: zero
    embeddings under a false mask, equal t/h/w streams, zero frames."""
    from repro_torch.examples import train_lm

    for arch in ("qwen2-vl-7b", "whisper-medium"):
        tr = train_lm.Trainer(train_lm.parse_args(
            ["--arch", arch, "--batch", "2", "--seq", "8"]), device=CPU)
        b = tr.batch()
        cfg = tr.cfg
        if cfg.vision_embeds:
            assert b["vision_embeds"].shape == (2, 8, cfg.d_model)
            assert not b["vision_mask"].any()
            assert (b["positions"] == torch.arange(8)).all()
            assert b["positions"].shape == (3, 2, 8)
        if cfg.is_encoder_decoder:
            assert b["enc_frames"].shape == (2, cfg.enc_frames, cfg.d_model)
            assert not b["enc_frames"].any()


def test_train_svm_e2e_example_checkpoint(tmp_path):
    """``python -m repro_torch.examples.train_svm_e2e --device cpu`` at n
    = 600, d = 32, 200 iterations: the objective falls and never rises
    above its first record, accuracy above chance, and the checkpoint
    restores w and b bit for bit (also through the JAX package's
    ``restore``)."""
    from repro_torch.examples import train_svm_e2e

    ckpt = str(tmp_path / "svm_e2e.npz")
    out = train_svm_e2e.main(["--n", "600", "--d", "32", "--iters", "200",
                              "--ckpt", ckpt], device=CPU)
    objs = [o for _, o in out["history"]]
    assert objs[-1] < objs[0] and max(objs) <= objs[0]
    assert out["train_acc"] > 0.6
    clf = out["clf"]
    back = checkpoint.restore(ckpt, {"w": clf.w_, "b": np.asarray(clf.b_)})
    np.testing.assert_array_equal(back["w"], clf.w_)
    assert back["b"] == clf.b_
    jback = jcheckpoint.restore(ckpt, {"w": jnp.zeros_like(clf.w_),
                                       "b": jnp.zeros(())})
    np.testing.assert_array_equal(np.asarray(jback["w"]), clf.w_)
