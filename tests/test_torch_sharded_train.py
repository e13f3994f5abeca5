"""Sharded training of every family (``repro_torch.models.sharding``: GQA
and MLA attention, GLU and MoE MLPs, the mLSTM / sLSTM / RG-LRU mixers,
whisper's encoder and cross attention, qwen2-vl's vision inputs) on gloo
ranks on the CPU, held to the JAX package's unsharded model and launcher
(``repro.launch.train`` on one device: GSPMD's sharding changes no value,
the MoE's routing groups included).

One spawn of 8 ranks runs every case: the (2, 4) mesh of all of them
(``launch.mesh.make_test_mesh``), then the (1, 2) mesh of two of them (a
``sub_group``, as ``chip_smoke.py`` paths p and q run on part of path f's
spawn).  Each case starts from JAX's initial state (``jax.random.key(0)``,
carried by ``repro_torch.convert``) or from the port's seed-0 draw, in
float32.  Tolerances: the gathered logits within 1e-4 of max |logit| of
the reference's forward, the losses of the launcher's 3 steps within 1e-5
(as ``tests/test_torch_launch_train.py`` holds world size 1), each rank's
parameter and AdamW state bytes equal to ``launch.specs``' count for its
layout exactly; the MoE's dropped choices equal the unsharded run's; after
the steps, every parameter whole over ``model`` bit-equal on the ranks of
each model line.  The whisper and qwen2-vl cases carry seeded extras
(frames; patch embeddings under a span mask with distinct t/h/w M-RoPE
streams), the same through JAX's forward and step."""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from _torch_sharding_workers import (_moe_drops, _whole_model,
                                     sharded_cases)
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
XLSTM, RG, WHISPER, QWEN = ("xlstm-125m", "recurrentgemma-2b",
                            "whisper-medium", "qwen2-vl-7b")
TRACE_SEQS = (16, 48)     # a sharded xlstm step's collectives at each
INIT_ARCHS = (XLSTM, RG)  # init_lm(mesh=) gathered against unsharded


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

    def extras(self) -> dict:
        """The batch's extras (the same for every step), numpy from seed
        0: an encoder-decoder's frames; a vision config's patch embeddings,
        the mask of a 2 x 4 patch grid after 4 text tokens, and M-RoPE's
        (3, B, S) positions, Qwen2-VL's layout (text at t = h = w = its
        index, a patch at the grid's start in t plus its row in h and its
        column in w, text after from one past the largest), the same on
        every row as JAX's mask reads row 0's."""
        cfg, out = self.cfg(), {}
        rng = np.random.default_rng(0)
        if cfg.is_encoder_decoder:
            out["enc_frames"] = rng.standard_normal(
                (self.batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        if cfg.vision_embeds:
            t0, (rows, cols) = 4, (2, 4)
            r, c = np.divmod(np.arange(rows * cols), cols)
            grid = np.stack([np.full(rows * cols, t0), t0 + r, t0 + c])
            start = grid.max() + 1
            rest = self.seq - t0 - rows * cols
            pos = np.concatenate([np.stack([np.arange(t0)] * 3), grid,
                                  np.stack([np.arange(start, start + rest)]
                                           * 3)], axis=1)
            mask = np.zeros(self.seq, bool)
            mask[t0:t0 + rows * cols] = True
            out["vision_embeds"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(np.float32)
            out["vision_mask"] = np.repeat(mask[None], self.batch, 0)
            out["positions"] = np.repeat(pos[:, None], self.batch,
                                         1).astype(np.int32)
        return out


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
       f"{LITE} 6 experts": Case(LITE, 2, {"moe_num_experts": 6}, "port"),
       # a head a rank; sLSTM's up-projection 341 does not divide model 4
       XLSTM: Case(XLSTM, 2, {}, "jax"),
       # sLSTM's w_in (384, 1,024) and mLSTM's w_up (384, 1,536) split over
       # model as at full width; w_rec (4, 96, 384) (data, model, None)
       f"{XLSTM} d_model 384": Case(XLSTM, 2, {"d_model": 384}, "jax"),
       # rglru, rglru, local_attn: 48 tokens past the 32-token window
       RG: Case(RG, 2, {}, "jax", seq=48),
       # 10 heads do not divide model 4: attention whole on every rank
       f"{RG} 10 heads": Case(RG, 2, {"num_heads": 10}, "port", seq=48),
       WHISPER: Case(WHISPER, 2, {}, "jax"),   # 2 + 2 layers, 64 frames
       QWEN: Case(QWEN, 2, {}, "jax")}
SUB = {n: ALL[n] for n in ("h2o-danube-1.8b", "gemma-7b", LITE, XLSTM,
                           WHISPER)}
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
    extras = {k: jnp.asarray(v) for k, v in case.extras().items()}
    logits, _, _ = jax.jit(lambda p, t, e: jtf.forward(p, jcfg, t, **e))(
        state.params, jnp.asarray(batches[0].tokens), extras)
    step = jax.jit(jsteps.make_train_step(jcfg, jocfg))
    losses = []
    for nb in batches:
        state, m = step(state, {"tokens": jnp.asarray(nb.tokens),
                                "targets": jnp.asarray(nb.targets),
                                **extras})
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
    extras = {k: torch.as_tensor(v) for k, v in case.extras().items()}
    with torch.no_grad():
        logits = model(tokens, **extras)[0].numpy()
    dropped = _moe_drops(None, model, tokens.numel())
    ocfg = opt.AdamWConfig(lr=train.LR, warmup_steps=train.WARMUP_STEPS,
                           state_dtype=cfg.optimizer_state_dtype)
    state = steps.TrainState(steps.trainable(model), opt.init(model, ocfg))
    step = steps.make_train_step(cfg, ocfg)
    losses = []
    for nb in batches:
        state, m = step(state, {"tokens": torch.as_tensor(nb.tokens),
                                "targets": torch.as_tensor(nb.targets),
                                **extras})
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

    def cases(table, trace):
        return {name: {"arch": c.arch, "changes": c.changes,
                       "dtensor": i == 0, "weights": name,
                       "extras": c.extras(),
                       "trace_seqs": TRACE_SEQS if name in trace else (),
                       **{k: refs[c.key()][k] for k in ("tokens", "batches")}}
                for i, (name, c) in enumerate(table.items())}

    ranks = meshlib.spawn_clients(
        sharded_cases, 8, backend="gloo", device="cpu", timeout_s=300,
        args=(params, {"all": cases(ALL, (XLSTM,)), "sub": cases(SUB, ())},
              SUB_RANKS, INIT_ARCHS))
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


def _specs(cfg, layout) -> dict:
    return shd.param_sharding_tree(tf.LM(cfg, "meta"), layout,
                                   fsdp=cfg.fsdp_params,
                                   embed_fsdp=cfg.embed_fsdp)


def test_recurrent_and_multimodal_cases_hit_their_trouble_spots():
    """The new families' cases against their published widths' specs on
    the (2, 4) layout: xlstm-125m's mLSTM (w_up's columns across the x_in /
    z halves, a head a rank, w_down's rows one head's dh) and sLSTM (heads
    over model, w_rec's dh over model and heads over data, w_in / w_out
    over model) at full width and at d_model 384, reduced sLSTM's 341
    units that model does not divide; recurrentgemma-2b's RG-LRU (w_in /
    w_out over model, its gates whole with no FSDP) and its 10 heads and
    one KV head that model does not divide, the reduced window cut at 48
    tokens; whisper's 16 and qwen2-vl's 28 / 4 heads over model."""
    layout = meshlib.layout_for(8)
    full = _specs(get_config(XLSTM), layout)
    m, sl = "layers.0.mixer", "layers.1.mixer"
    assert full[f"{m}.w_up"] == ("data", "model")            # (768, 3,072)
    assert full[f"{m}.wq"] == full[f"{m}.w_gates"] == ("data", "model",
                                                        None)
    assert full[f"{m}.w_down"] == ("model", "data")          # 384 rows
    assert full[f"{m}.conv.w"] == (None, None)
    assert full[f"{sl}.w_x"] == ("data", "model", None)
    assert full[f"{sl}.w_rec"] == ("data", "model", None)    # (4, 192, 768)
    assert full[f"{sl}.w_in"] == ("data", "model")
    assert full[f"{sl}.w_out"] == ("model", "data")
    red = ALL[XLSTM].cfg()
    up = int(red.d_model * red.slstm_proj_factor)
    assert up == 341 and (2 * up) % 4 and up % 4
    assert _specs(red, layout)[f"{sl}.w_in"] == ("data", None)
    wide = _specs(ALL[f"{XLSTM} d_model 384"].cfg(), layout)
    model = tf.LM(ALL[f"{XLSTM} d_model 384"].cfg(), "meta")
    assert tuple(model.layers[1].mixer.w_rec.shape) == (4, 96, 384)
    assert wide[f"{sl}.w_rec"] == ("data", "model", None)
    assert tuple(model.layers[1].mixer.w_in.shape) == (384, 1024)
    assert wide[f"{sl}.w_in"] == wide[f"{m}.w_up"] == ("data", "model")
    assert tuple(model.layers[0].mixer.w_up.shape) == (384, 1536)
    rg = _specs(get_config(RG), layout)
    assert rg[f"{m}.w_in"] == ("data", "model")
    assert rg[f"{m}.w_out"] == ("model", "data")
    for leaf in ("w_gate_branch", "w_r", "w_i", "lam", "conv.w"):
        assert all(e is None for e in rg[f"{m}.{leaf}"]), leaf
    assert rg["layers.2.mixer.wq"] == ("data", None, None)    # 10 heads
    assert rg["layers.2.mixer.wk"] == ("data", None, None)    # 1 KV head
    assert rg["layers.2.mixer.wo"] == (None, None, "data")
    for name in (RG, f"{RG} 10 heads"):
        case = ALL[name]
        assert case.cfg().local_window < case.seq
        assert tf.layer_kinds(case.cfg()) == ["rglru", "rglru", "local_attn"]
    assert _specs(ALL[f"{RG} 10 heads"].cfg(), layout)[
        "layers.2.mixer.wq"][1] is None
    wh = _specs(get_config(WHISPER), layout)
    for name in ("layers.0.mixer.wq", "layers.0.cross.wq",
                 "layers.0.cross.wk", "encoder.layers.0.mixer.wk"):
        assert wh[name] == ("data", "model", None), name
    qw = _specs(get_config(QWEN), layout)
    assert qw["layers.0.mixer.wq"] == qw["layers.0.mixer.wk"] == (
        "data", "model", None)
    q = ALL[QWEN]
    ex = q.extras()
    assert ex["positions"].shape == (3, q.batch, q.seq)
    assert not np.array_equal(ex["positions"][1], ex["positions"][2])
    assert 0 < ex["vision_mask"].sum() < ex["vision_mask"].size


@pytest.mark.parametrize("where,name", LAYOUT_CASES)
def test_blocks_whole_over_model_stay_equal(runs, where, name):
    """After the steps, every parameter whole over ``model`` (norms, the
    mixers' convs, RG-LRU's gates and ``lam``, ...) is bit-equal on the
    ranks of each model line: a rank that uses only its part of one has
    its grad summed over ``model``, so the copies do not drift apart."""
    _, ranks = runs
    for r in _ranks_of(ranks, where):
        differ, held = r[(where, name)]["drift"]
        assert differ == [] and held > 0, (r["rank"], differ, held)
        # the check sees a drift: one rank of each line moved final_norm
        assert r[(where, name)]["planted_drift"] == (["final_norm.scale"],
                                                     held)


def test_sharded_xlstm_collectives_do_not_grow_with_seq(runs):
    """A sharded step of reduced xlstm-125m makes the same collectives, by
    kind and count (``dispatch_trace.Trace``), at 16 and at 48 tokens:
    none runs a time step of the sLSTM's loop (``w_rec`` is gathered once
    a block)."""
    _, ranks = runs
    for r in ranks:
        got = r[("all", XLSTM)]["collectives"]
        assert set(got) == set(TRACE_SEQS)
        count = {seq: got[seq]["trace"][0] for seq in TRACE_SEQS}
        assert count[TRACE_SEQS[0]] == count[TRACE_SEQS[1]], count
        assert sum(count[TRACE_SEQS[0]].values()) > 0


def test_tally_records_what_the_trace_records(runs):
    """``sharding.tally`` (which chip_smoke.py reads) records the same
    collectives of a sharded step as ``dispatch_trace.Trace``: the same
    count and bytes of each kind, at both lengths."""
    _, ranks = runs
    for r in ranks:
        for seq, got in r[("all", XLSTM)]["collectives"].items():
            assert got["tally"] == got["trace"], (r["rank"], seq, got)


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_placed_init_gathers_to_the_unsharded_draw(runs, arch):
    """``init_lm(mesh=)`` on the (2, 4) mesh, each parameter gathered
    whole, equals ``init_lm`` unsharded bit for bit (RG-LRU's ``lam``, a
    line rather than a draw, included)."""
    _, ranks = runs
    got = ranks[0]["init"][arch]
    want = dict(tf.init_lm(get_config(arch).reduced(), 0,
                           "cpu").named_parameters())
    assert got.keys() == want.keys()
    for n, p in want.items():
        assert np.array_equal(got[n], p.detach().numpy()), n
    lams = [n for n in got if n.endswith(".lam")]
    assert bool(lams) == (arch == RG)
    for n in lams:
        assert np.array_equal(got[n], torch.linspace(
            -4.0, -1.0, got[n].shape[0], dtype=torch.float32).numpy()), n
    assert all(r["init"][arch] is None for r in ranks[1:])
