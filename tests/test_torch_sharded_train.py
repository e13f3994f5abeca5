"""Sharded training of the dense family (``repro_torch.models.sharding``)
on gloo ranks on the CPU, held to the JAX package's unsharded model and
launcher (``repro.launch.train`` on one device: GSPMD's sharding changes
no value).

One spawn of 8 ranks runs every case: the (2, 4) mesh of all of them
(``launch.mesh.make_test_mesh``), then the (1, 2) mesh of two of them (a
``sub_group``, as ``chip_smoke.py`` path p runs on part of path f's
spawn).  Each case starts from JAX's initial state (``jax.random.key(0)``,
carried by ``repro_torch.convert``) in float32.  Tolerances: the gathered
logits within 1e-4 of max |logit| of JAX's forward, the losses of the
launcher's 3 steps within 1e-5 (as ``tests/test_torch_launch_train.py``
holds world size 1), each rank's parameter and AdamW state bytes equal to
``launch.specs``' count for its layout exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from _torch_sharding_workers import _whole_model, sharded_cases
from repro.configs import get_config as jget_config
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import steps

pytestmark = pytest.mark.usefixtures("one_thread")

STEPS, SEQ = 3, 16
LOGIT_TOL, LOSS_RTOL = 1e-4, 1e-5
SUB_RANKS = [2, 5]
# name -> (arch, batch, config changes, reference): the (2, 4) cases, then
# (1, 2)'s.  "jax": JAX's initial state, forward and launcher; "port": the
# port's unsharded model and launcher steps (held to JAX's at world size
# 1 by tests/test_torch_launch_train.py) from the port's seed-0 draw
ALL = {"h2o-danube-1.8b": ("h2o-danube-1.8b", 2, {}, "jax"),
       "gemma-7b": ("gemma-7b", 2, {}, "jax"),       # tied, emb_scale
       "chatglm3-6b": ("chatglm3-6b", 2, {}, "port"),  # 2 KV heads, 4 ranks
       "h2o-danube-1.8b batch 1": ("h2o-danube-1.8b", 1, {}, "port"),
       "h2o-danube-1.8b ZeRO-2": ("h2o-danube-1.8b", 2,
                                  {"fsdp_params": False,
                                   "embed_fsdp": False}, "jax")}
SUB = {"h2o-danube-1.8b": ALL["h2o-danube-1.8b"],
       "gemma-7b": ALL["gemma-7b"]}


def _reference(arch: str, batch: int) -> dict:
    """JAX's initial state by the port's names, its unsharded logits on
    the first batch's tokens, the launcher's batches and its losses."""
    jcfg = jget_config(arch).reduced()
    jocfg = jopt.AdamWConfig(lr=train.LR, warmup_steps=train.WARMUP_STEPS,
                             state_dtype=jcfg.optimizer_state_dtype)
    state = jax.jit(lambda k: jsteps.init_train_state(k, jcfg, jocfg))(
        jax.random.key(0))
    params = convert.lm_tree_to_named(jax.tree.map(np.asarray, state.params),
                                      get_config(arch).reduced())
    pipe = JTokenPipeline(jcfg.vocab_size, SEQ, batch)
    batches = [pipe.next_batch() for _ in range(STEPS)]
    logits, _, _ = jax.jit(lambda p, t: jtf.forward(p, jcfg, t))(
        state.params, jnp.asarray(batches[0].tokens))
    step = jax.jit(jsteps.make_train_step(jcfg, jocfg))
    losses = []
    for nb in batches:
        state, m = step(state, {"tokens": jnp.asarray(nb.tokens),
                                "targets": jnp.asarray(nb.targets)})
        losses.append(float(m["loss"]))
    return {"params": params, "logits": np.asarray(logits, np.float32),
            "tokens": np.asarray(batches[0].tokens),
            "batches": [(np.asarray(b.tokens), np.asarray(b.targets))
                        for b in batches],
            "losses": losses}


def _port_reference(arch: str, batch: int, params=None) -> dict:
    """The same from the port's unsharded model: ``params`` (default: the
    port's seed-0 draw on the CPU), its logits and launcher steps."""
    cfg = get_config(arch).reduced()
    if params is None:
        params = {n: p.detach().numpy().copy() for n, p in
                  tf.init_lm(cfg, 0, "cpu").named_parameters()}
    model = _whole_model(cfg, params)
    pipe = TokenPipeline(cfg.vocab_size, SEQ, batch)
    batches = [pipe.next_batch() for _ in range(STEPS)]
    tokens = torch.as_tensor(batches[0].tokens)
    with torch.no_grad():
        logits = model(tokens)[0].numpy()
    ocfg = opt.AdamWConfig(lr=train.LR, warmup_steps=train.WARMUP_STEPS)
    state = steps.TrainState(steps.trainable(model), opt.init(model, ocfg))
    step = steps.make_train_step(cfg, ocfg)
    losses = []
    for nb in batches:
        state, m = step(state, {"tokens": torch.as_tensor(nb.tokens),
                                "targets": torch.as_tensor(nb.targets)})
        losses.append(float(m["loss"]))
    return {"params": params, "logits": logits, "tokens": tokens.numpy(),
            "batches": [(b.tokens, b.targets) for b in batches],
            "losses": losses}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs = {}
    for arch, batch, _, kind in ALL.values():
        if kind == "jax" and (arch, batch) not in refs:
            refs[arch, batch] = _reference(arch, batch)
    for arch, batch, _, kind in ALL.values():
        if kind == "port":
            jax_ref = refs.get((arch, 2))
            refs[arch, batch] = _port_reference(
                arch, batch, jax_ref["params"] if jax_ref else None)
    # the weights go by file: a spawned process's arguments travel through
    # a pipe, slowly (~1 s a MB for 8 ranks)
    params = {}
    for arch, batch, _, _ in ALL.values():
        path = tmp_path_factory.mktemp("weights") / f"{arch}.npz"
        np.savez(path, **refs[arch, batch]["params"])
        params[arch] = str(path)

    def cases(table):
        return {name: {"arch": arch, "changes": changes, "dtensor": i == 0,
                       **{k: refs[arch, batch][k]
                          for k in ("tokens", "batches")}}
                for i, (name, (arch, batch, changes, _))
                in enumerate(table.items())}

    ranks = meshlib.spawn_clients(
        sharded_cases, 8, backend="gloo", device="cpu", timeout_s=300,
        args=(params, {"all": cases(ALL), "sub": cases(SUB)}, SUB_RANKS))
    return refs, ranks


LAYOUT_CASES = [("all", n) for n in ALL] + [("sub", n) for n in SUB]


def _ranks_of(ranks, where):
    return ranks if where == "all" else [ranks[r] for r in SUB_RANKS]


def test_layouts_are_make_test_mesh(runs):
    _, ranks = runs
    big, small = ranks[SUB_RANKS[0]]["layouts"]
    assert (big.axis_names, big.shape) == (("data", "model"), (2, 4))
    assert (small.axis_names, small.shape) == (("data", "model"), (1, 2))
    assert ranks[3]["layouts"][1] is None        # outside the sub mesh


@pytest.mark.parametrize("where,name", LAYOUT_CASES)
def test_gathered_logits_equal_reference(runs, where, name):
    refs, ranks = runs
    arch, batch, _, _ = (ALL if where == "all" else SUB)[name]
    want = refs[arch, batch]["logits"]
    got = _ranks_of(ranks, where)[0][(where, name)]["logits"]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= LOGIT_TOL, err


@pytest.mark.parametrize("where,name", LAYOUT_CASES)
def test_losses_equal_reference(runs, where, name):
    refs, ranks = runs
    arch, batch, _, _ = (ALL if where == "all" else SUB)[name]
    want = refs[arch, batch]["losses"]
    for r in _ranks_of(ranks, where):
        np.testing.assert_allclose(r[(where, name)]["losses"], want,
                                   rtol=LOSS_RTOL)
    assert want[0] != want[-1]


@pytest.mark.parametrize("where,name", LAYOUT_CASES)
def test_bytes_a_rank_equal_specs(runs, where, name):
    _, ranks = runs
    for r in _ranks_of(ranks, where):
        out = r[(where, name)]
        assert out["param_bytes"] == out["want_param_bytes"]
        assert out["state_bytes"] == out["want_state_bytes"]
    whole = _ranks_of(ranks, where)[0][(where, name)]
    # a rank holds a strict part of the model: 1/8 or 1/2 of the bytes of
    # every split tensor
    assert whole["param_bytes"] < sum(
        t.nbytes for t in whole["trained"].values())


@pytest.mark.parametrize("where", ["all", "sub"])
def test_blocks_gather_the_same_through_dtensor(runs, where):
    """``sharding.to_placements`` over the mesh's ``DeviceMesh`` gathers
    each trained parameter (of the first case) to what ``sharding.whole``
    gathers."""
    _, ranks = runs
    name = next(iter(ALL if where == "all" else SUB))
    assert all(r[(where, name)]["dtensor_equal"]
               for r in _ranks_of(ranks, where))


def test_zero2_keeps_state_finer_than_params(runs):
    """Under ``fsdp_params=False`` / ``embed_fsdp=False`` the parameters
    stay whole over ``data`` and the AdamW state does not (JAX's
    ``train_state_sharding``)."""
    _, ranks = runs
    z = ranks[0][("all", "h2o-danube-1.8b ZeRO-2")]
    f = ranks[0][("all", "h2o-danube-1.8b")]
    assert z["param_bytes"] > f["param_bytes"]
    assert z["state_bytes"] == f["state_bytes"]


def test_trained_blocks_are_whole_model_steps(runs):
    """The (2, 4) run's trained parameters, gathered, equal the port's
    unsharded launcher steps from the same state (1e-5 where a grad is
    not tiny: AdamW's first steps take a grad's sign)."""
    refs, ranks = runs
    cfg = get_config("h2o-danube-1.8b").reduced()
    ref = refs["h2o-danube-1.8b", 2]
    model = _whole_model(cfg, ref["params"])
    ocfg = opt.AdamWConfig(lr=train.LR, warmup_steps=train.WARMUP_STEPS)
    state = steps.TrainState(steps.trainable(model), opt.init(model, ocfg))
    step = steps.make_train_step(cfg, ocfg)
    first = None
    for tok, tgt in ref["batches"]:
        batch = {"tokens": torch.as_tensor(tok),
                 "targets": torch.as_tensor(tgt)}
        if first is None:
            _, _, g = steps.value_and_grad(state.model, cfg, batch)
            first = {n: t.detach().clone() for n, t in g.items()}
        state, _ = step(state, batch)
    got = ranks[0][("all", "h2o-danube-1.8b")]["trained"]
    for n, p in state.model.named_parameters():
        big = first[n].abs() > 1e-3 * first[n].abs().max()
        diff = (torch.as_tensor(got[n]) - p.detach())[big]
        assert float(diff.abs().max()) <= 1e-5, n


def test_configs_stay_dense_family():
    """The cases cover the trouble spots: KV heads that do not divide the
    model axis (chatglm3-6b reduced: 2 on 4), tied embeddings with a
    scale (gemma-7b), a batch of one row on a 2-way data axis."""
    chat = get_config("chatglm3-6b").reduced()
    assert chat.num_kv_heads == 2 and chat.num_heads == 4
    gem = get_config("gemma-7b").reduced()
    assert gem.tie_embeddings and gem.emb_scale
