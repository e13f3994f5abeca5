"""Sharded training of the dense and DeepSeek-V2 families
(``repro_torch.models.sharding``: GQA and MLA attention, GLU and MoE MLPs)
on gloo ranks on the CPU, held to the JAX package's unsharded model and
launcher (``repro.launch.train`` on one device: GSPMD's sharding changes
no value, the MoE's routing groups included).

One spawn of 8 ranks runs every case: the (2, 4) mesh of all of them
(``launch.mesh.make_test_mesh``), then the (1, 2) mesh of two of them (a
``sub_group``, as ``chip_smoke.py`` paths p and q run on part of path f's
spawn).  Each case starts from JAX's initial state (``jax.random.key(0)``,
carried by ``repro_torch.convert``) or from the port's seed-0 draw, in
float32.  Tolerances: the gathered logits within 1e-4 of max |logit| of
the reference's forward, the losses of the launcher's 3 steps within 1e-5
(as ``tests/test_torch_launch_train.py`` holds world size 1), each rank's
parameter and AdamW state bytes equal to ``launch.specs``' count for its
layout exactly; the MoE's dropped choices equal the unsharded run's."""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from _torch_sharding_workers import _moe_drops, _whole_model, sharded_cases
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
from repro_torch.models import moe
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import steps

pytestmark = pytest.mark.usefixtures("one_thread")

STEPS, SEQ = 3, 16
LOGIT_TOL, LOSS_RTOL = 1e-4, 1e-5
SUB_RANKS = [2, 5]
LITE = "deepseek-v2-lite-16b"
# changes of the config that move a layout, not a value
LAYOUT_KEYS = ("fsdp_params", "embed_fsdp", "shard_acts")


class Case(NamedTuple):
    """A config on a mesh: its reduced ``arch`` with ``changes``, a batch
    of ``batch`` rows of ``seq`` tokens, held to ``ref``: "jax" (JAX's
    initial state, forward and launcher) or "port" (the port's unsharded
    model and launcher steps, held to JAX's at world size 1 by
    tests/test_torch_launch_train.py) from the weights of case
    ``weights`` (None: the port's seed-0 draw)."""
    arch: str
    batch: int
    changes: dict
    ref: str
    seq: int = SEQ
    weights: str | None = None

    def cfg(self):
        return dataclasses.replace(get_config(self.arch).reduced(),
                                   **self.changes)

    def key(self) -> tuple:
        """What the reference's values depend on."""
        return (self.arch, self.batch, self.seq, tuple(sorted(
            (k, v) for k, v in self.changes.items()
            if k not in LAYOUT_KEYS)))


# the (2, 4) cases, then (1, 2)'s
ALL = {"h2o-danube-1.8b": Case("h2o-danube-1.8b", 2, {}, "jax"),
       "gemma-7b": Case("gemma-7b", 2, {}, "jax"),  # tied, emb_scale
       "chatglm3-6b": Case("chatglm3-6b", 2, {}, "port"),  # 2 KV heads
       "h2o-danube-1.8b batch 1": Case("h2o-danube-1.8b", 1, {}, "port",
                                       weights="h2o-danube-1.8b"),
       "h2o-danube-1.8b ZeRO-2": Case("h2o-danube-1.8b", 2,
                                      {"fsdp_params": False,
                                       "embed_fsdp": False}, "jax"),
       # MLA without q-lora, 4 experts top-2 and a shared one: a head and
       # an expert a rank on model 4
       LITE: Case(LITE, 2, {}, "jax"),
       # MLA with q-lora, bf16 moments
       "deepseek-v2-236b": Case("deepseek-v2-236b", 2, {}, "port"),
       # 32 groups of 8 tokens at capacity 4 drop choices; a rank's own
       # 128 tokens would make groups of 4 at capacity 2
       f"{LITE} capacity": Case(LITE, 4, {"moe_capacity_factor": 1.0},
                                "port", seq=64, weights=LITE),
       # 31 groups: data 2 does not divide them
       f"{LITE} seq 31": Case(LITE, 2, {}, "port", seq=31, weights=LITE),
       # 6 experts do not divide model 4: their hidden units split
       f"{LITE} 6 experts": Case(LITE, 2, {"moe_num_experts": 6}, "port")}
SUB = {n: ALL[n] for n in ("h2o-danube-1.8b", "gemma-7b", LITE)}
MOE_PORT = [n for n, c in ALL.items()
            if c.ref == "port" and c.cfg().moe_num_experts]


def _reference(case: Case) -> dict:
    """JAX's initial state by the port's names, its unsharded logits on
    the first batch's tokens, the launcher's batches and its losses."""
    jcfg = dataclasses.replace(jget_config(case.arch).reduced(),
                               **case.changes)
    jocfg = jopt.AdamWConfig(lr=train.LR, warmup_steps=train.WARMUP_STEPS,
                             state_dtype=jcfg.optimizer_state_dtype)
    state = jax.jit(lambda k: jsteps.init_train_state(k, jcfg, jocfg))(
        jax.random.key(0))
    params = convert.lm_tree_to_named(jax.tree.map(np.asarray, state.params),
                                      case.cfg())
    pipe = JTokenPipeline(jcfg.vocab_size, case.seq, case.batch)
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


def _port_reference(case: Case, params=None) -> dict:
    """The same from the port's unsharded model: ``params`` (default: the
    port's seed-0 draw on the CPU), its logits (and the MoE's dropped
    choices) and launcher steps."""
    cfg = case.cfg()
    if params is None:
        params = {n: p.detach().numpy().copy() for n, p in
                  tf.init_lm(cfg, 0, "cpu").named_parameters()}
    model = _whole_model(cfg, params)
    pipe = TokenPipeline(cfg.vocab_size, case.seq, case.batch)
    batches = [pipe.next_batch() for _ in range(STEPS)]
    tokens = torch.as_tensor(batches[0].tokens)
    with torch.no_grad():
        logits = model(tokens)[0].numpy()
    dropped = _moe_drops(None, model, tokens.numel())
    ocfg = opt.AdamWConfig(lr=train.LR, warmup_steps=train.WARMUP_STEPS,
                           state_dtype=cfg.optimizer_state_dtype)
    state = steps.TrainState(steps.trainable(model), opt.init(model, ocfg))
    step = steps.make_train_step(cfg, ocfg)
    losses = []
    for nb in batches:
        state, m = step(state, {"tokens": torch.as_tensor(nb.tokens),
                                "targets": torch.as_tensor(nb.targets)})
        losses.append(float(m["loss"]))
    return {"params": params, "logits": logits, "tokens": tokens.numpy(),
            "batches": [(b.tokens, b.targets) for b in batches],
            "losses": losses, "dropped": dropped}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs = {}
    for case in ALL.values():
        if case.ref == "jax" and case.key() not in refs:
            refs[case.key()] = _reference(case)
    for case in ALL.values():
        if case.ref == "port":
            weights = (None if case.weights is None
                       else refs[ALL[case.weights].key()]["params"])
            refs[case.key()] = _port_reference(case, weights)
    # the weights go by file: a spawned process's arguments travel through
    # a pipe, slowly (~1 s a MB for 8 ranks)
    params = {}
    for name, case in ALL.items():
        path = tmp_path_factory.mktemp("weights") / "weights.npz"
        np.savez(path, **refs[case.key()]["params"])
        params[name] = str(path)

    def cases(table):
        return {name: {"arch": c.arch, "changes": c.changes,
                       "dtensor": i == 0, "weights": name,
                       **{k: refs[c.key()][k] for k in ("tokens", "batches")}}
                for i, (name, c) in enumerate(table.items())}

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
    want = refs[ALL[name].key()]["logits"]
    got = _ranks_of(ranks, where)[0][(where, name)]["logits"]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= LOGIT_TOL, err


@pytest.mark.parametrize("where,name", LAYOUT_CASES)
def test_losses_equal_reference(runs, where, name):
    refs, ranks = runs
    want = refs[ALL[name].key()]["losses"]
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
    ref = refs[ALL["h2o-danube-1.8b"].key()]
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


@pytest.mark.parametrize("name", MOE_PORT)
def test_moe_drops_equal_unsharded(runs, name):
    """Every MoE layer's dropped choices (group by group, in token order),
    gathered from the (2, 4) mesh's data ranks, equal the unsharded
    run's: the ranks route the whole batch's groups at its capacity.  A
    rank that grouped its own tokens alone would give other shapes."""
    refs, ranks = runs
    want = refs[ALL[name].key()]["dropped"]
    got = ranks[0][("all", name)]["dropped"]
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)
    if name == f"{LITE} capacity":
        assert sum(int(w.sum()) for w in want) >= 1


MOE_CASES = [(w, n) for w, n in LAYOUT_CASES if ALL[n].cfg().moe_num_experts]


@pytest.mark.parametrize("where,name", MOE_CASES)
def test_moe_forward_takes_the_batch_size(runs, where, name):
    """On a mesh the MoE routes by the whole batch's row count, which the
    caller passes: a forward without it raises (a rank's rows do not tell
    a split batch from a repeated one), and the first row alone as a
    batch of one, whole on every rank (``batch_size=1``), gives the
    unsharded forward's logits of that row."""
    refs, ranks = runs
    out = _ranks_of(ranks, where)[0][(where, name)]
    assert "batch_size=" in out["unsized"]
    ref = refs[ALL[name].key()]
    model = _whole_model(ALL[name].cfg(), ref["params"])
    with torch.no_grad():
        want = model(torch.as_tensor(ref["tokens"][:1]))[0].numpy()
    assert out["one_row"].shape == want.shape
    err = float(np.abs(out["one_row"] - want).max()) / float(
        np.abs(want).max())
    assert err <= LOGIT_TOL, err


def test_configs_stay_dense_family():
    """The cases cover the trouble spots: KV heads that do not divide the
    model axis (chatglm3-6b reduced: 2 on 4), tied embeddings with a
    scale (gemma-7b), a batch of one row on a 2-way data axis; for the
    DeepSeek-V2 family a head and an expert a rank on model 4, q-lora and
    bf16 moments (236b), routing groups that a rank's own tokens would
    cut otherwise (the capacity case), groups that data does not divide
    (seq 31), and experts that model does not divide (6 on 4)."""
    chat = get_config("chatglm3-6b").reduced()
    assert chat.num_kv_heads == 2 and chat.num_heads == 4
    gem = get_config("gemma-7b").reduced()
    assert gem.tie_embeddings and gem.emb_scale
    layout = meshlib.layout_for(8)
    assert layout.axis_sizes == {"data": 2, "model": 4}
    lite = ALL[LITE].cfg()
    assert (lite.moe_num_experts, lite.moe_top_k, lite.moe_num_shared,
            lite.mla_q_lora, lite.num_heads) == (4, 2, 1, 0, 4)
    e, d, f = lite.moe_num_experts, lite.d_model, lite.moe_d_ff
    assert shd.param_spec("expert_gate", (e, d, f), layout) == (
        "model", "data", None)
    assert shd.param_spec("wkv_b_k", (lite.mla_kv_lora, lite.num_heads,
                                      lite.head_dim), layout)[1] == "model"
    big = ALL["deepseek-v2-236b"].cfg()
    assert big.mla_q_lora and big.optimizer_state_dtype == "bfloat16"
    cap = ALL[f"{LITE} capacity"]
    n = cap.batch * cap.seq
    assert moe.num_groups(n) == 32 and moe.capacity(n // 32, cap.cfg()) == 4
    assert moe.capacity(n // 2 // moe.num_groups(n // 2), cap.cfg()) == 2
    odd = ALL[f"{LITE} seq 31"]
    g = moe.num_groups(odd.batch * odd.seq)
    assert g == 31 and shd.spec_for(["batch"], (g,), layout) == (None,)
    assert shd.spec_for(["batch"], (odd.batch,), layout) == ("data",)
    six = ALL[f"{LITE} 6 experts"].cfg()
    assert shd.param_spec("expert_gate", (6, d, f), layout) == (
        None, "data", "model")
    assert shd.param_spec("router", (d, 6), layout) == ("data", None)
    assert six.moe_num_experts == 6
