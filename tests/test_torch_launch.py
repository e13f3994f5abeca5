"""The port's launch tables (``repro_torch.launch.{shapes,specs,mesh}``)
against the JAX package's: the config registry and its dimensions, the
input shapes and their applicability, the input specs, the copied
sharding rules and the bytes a device they give (on reduced configs,
against JAX's own ``param_spec`` / ``spec_for`` over ``jax.eval_shape``
trees under a stand-in mesh), the solver and serving dry-run tables, and
the production layouts' rank coordinates."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import shapes as jshapes
from repro.launch import specs as jspecs
from repro.models import sharding as jshd
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from _torch_launch_workers import one_thread  # noqa: F401
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import mesh, shapes, specs
from repro_torch.launch.dryrun import ASSIGNED
from repro_torch.train import optimizer as opt

pytestmark = pytest.mark.usefixtures("one_thread")

LAYOUTS = list(mesh.PRODUCTION_LAYOUTS.values())


def test_all_assigned_registered():
    assert ASSIGNED == [
        "qwen2-vl-7b", "chatglm3-6b", "xlstm-125m", "recurrentgemma-2b",
        "deepseek-v2-236b", "deepseek-v2-lite-16b", "gemma-7b",
        "deepseek-67b", "whisper-medium", "h2o-danube-1.8b"]
    known = set(list_configs())
    assert set(ASSIGNED) <= known and "gemma-7b-swa" in known


def test_exact_assigned_dimensions():
    spec = {
        "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024),
        "xlstm-125m": (12, 768, 4, 4, 0, 50304),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
        "deepseek-v2-236b": (60, 5120, 128, 128, 12288, 102400),
        "deepseek-v2-lite-16b": (27, 2048, 16, 16, 10944, 102400),
        "gemma-7b": (28, 3072, 16, 16, 24576, 256000),
        "deepseek-67b": (95, 8192, 64, 8, 22016, 102400),
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
        "h2o-danube-1.8b": (24, 2560, 32, 8, 6912, 32000),
    }
    for name, dims in spec.items():
        c = get_config(name)
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
                c.d_ff, c.vocab_size) == dims, name


def test_moe_configs():
    c = get_config("deepseek-v2-236b")
    assert (c.moe_num_experts, c.moe_top_k, c.moe_num_shared,
            c.moe_d_ff, c.mla_kv_lora) == (160, 6, 2, 1536, 512)
    c = get_config("deepseek-v2-lite-16b")
    assert (c.moe_num_experts, c.moe_top_k, c.mla_q_lora) == (64, 6, 0)


def test_input_shapes_table():
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.SHAPES["prefill_32k"] == ("prefill_32k", "prefill",
                                            32768, 32)
    assert shapes.SHAPES["long_500k"].seq_len == 524288


def test_applicability_equals_jax():
    runs = {}
    for arch in ASSIGNED + ["gemma-7b-swa"]:
        for shape in shapes.SHAPES.values():
            got = shapes.applicability(get_config(arch), shape)
            assert got == jshapes.applicability(jget_config(arch), shape)
        runs[arch] = got[0]
    assert runs == {
        "qwen2-vl-7b": False, "chatglm3-6b": False,
        "xlstm-125m": True, "recurrentgemma-2b": True,
        "deepseek-v2-236b": False, "deepseek-v2-lite-16b": False,
        "gemma-7b": False, "deepseek-67b": False,
        "whisper-medium": False, "h2o-danube-1.8b": True,
        "gemma-7b-swa": True}


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium",
                                  "gemma-7b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_input_specs_equal_jax(arch, shape):
    got = specs.input_specs(arch, shape)
    want = jspecs.input_specs(arch, shape)
    assert list(got) == list(want)
    for key, spec in want.items():
        assert tuple(got[key].shape) == spec.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            str(jnp.dtype(spec.dtype)), key
        assert got[key].device.type == "meta"


def test_padded_vocab_divisible_by_mesh():
    for a in ASSIGNED:
        assert get_config(a).padded_vocab % 256 == 0, a


def test_rules_and_leaf_logical_equal_jax():
    assert specs.DEFAULT_RULES == jshd.DEFAULT_RULES
    probes = [("blocks/0/self/k", (128, 32768, 16, 256)),
              ("blocks/0/self/c_kv", (128, 32768, 512)),
              ("self/k_rope", (128, 32768, 64)), ("state/C", (8, 4, 64, 64)),
              ("state/n", (8, 4, 64)), ("self/h", (8, 2560)),
              ("conv", (8, 3, 2560)), ("last_logits", (8, 512)),
              ("tokens", (8, 64)), ("vision_mask", (8, 64)),
              ("enc_frames", (8, 1500, 1024)), ("positions", (3, 8, 64)),
              ("pos", (8,)), ("index", ())]
    for path, shape in probes:
        assert specs._leaf_logical(path, shape) == \
            jspecs._leaf_logical(path, shape), path
    # the port's (B, KV, T, Dh) cache takes JAX's axes in its own order
    assert specs._port_cache_logical("layers/0/k", (128, 16, 32768, 256)) \
        == ["batch", "kv_heads", "kv_seq_bp", None]


class StandInMesh:
    """What ``repro.models.sharding.spec_for`` reads of a mesh."""

    def __init__(self, layout):
        self.axis_names = layout.axis_names
        self.devices = np.empty(layout.shape, dtype=np.int8)


@pytest.fixture
def jax_rules():
    def use(layout):
        jshd.set_mesh_axes(StandInMesh(layout))
    yield use
    jshd.set_mesh_axes(None)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: lay.name)
def test_spec_for_equals_jax(layout, jax_rules):
    jax_rules(layout)
    for logical, shape in ((["batch", None], (256, 64)),
                           (["batch", None], (1, 64)),
                           (["vocab", "param_embed"], (512, 256)),
                           (["param_embed", "heads", None], (256, 4, 64)),
                           (["batch", "kv_seq_bp", "kv_heads", None],
                            (128, 32768, 16, 256)),
                           (["batch", "kv_seq", None], (1, 524288, 512)),
                           (["experts", "param_embed", "mlp"],
                            (64, 2048, 1408))):
        assert specs.spec_for(logical, shape, layout) == \
            tuple(jshd.spec_for(logical, shape)), (logical, shape)


def _jax_bytes(tree, spec_of, skip=()) -> int:
    """Bytes a device of a JAX shape tree under ``spec_of(path, shape)``
    (a stacked period's leading layer axis never sharded), leaves named
    in ``skip`` left out."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        if keys.split("/")[-1] in skip:
            continue
        shape = leaf.shape
        scanned = "/blocks/" in f"/{keys}/" and len(shape) >= 1
        spec = spec_of(keys, shape[1:] if scanned else shape)
        n = math.prod(jshd_axis_extent(a) for a in spec if a is not None)
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize // n
    return total


def jshd_axis_extent(entry):
    mesh_ = jshd.get_mesh()
    sizes = dict(zip(mesh_.axis_names, mesh_.devices.shape))
    return math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str)
                                        else entry))


TRAIN = shapes.InputShape("t", "train", 64, 256)
DECODE = shapes.InputShape("t", "decode", 256, 128)


@functools.lru_cache(maxsize=None)
def _port_step(arch: str, shape: shapes.InputShape):
    """(cfg, args) of the reduced config's step, built inside a
    FakeTensorMode (undrawn weights, nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch).reduced()
    with FakeTensorMode():
        _, args = specs.build_lowerable(cfg, shape, "cpu")
    return cfg, args


@functools.lru_cache(maxsize=None)
def _jax_train_state(arch: str):
    jcfg = jget_config(arch).reduced()
    ocfg = jopt.AdamWConfig(state_dtype=jcfg.optimizer_state_dtype)
    return jcfg, jax.eval_shape(lambda: jsteps.init_train_state(
        jax.random.key(0), jcfg, ocfg))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: lay.name)
@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-lite-16b",
                                  "xlstm-125m", "qwen2-vl-7b"])
def test_train_argument_bytes_equal_jax(arch, layout, jax_rules):
    """Parameters (the config's FSDP settings), AdamW's master and moments
    (fully sharded), its step and the batch: the port's bytes a device
    equal JAX's rules over JAX's own trees."""
    cfg, args = _port_step(arch, TRAIN)
    got = specs.argument_bytes_per_device(cfg, "train", args, layout)

    jax_rules(layout)
    jcfg, st = _jax_train_state(arch)

    def params(fsdp, embed_fsdp):
        return lambda p, s: jshd.param_spec(p, s, fsdp=fsdp,
                                            embed_fsdp=embed_fsdp)

    want = _jax_bytes(st.params, params(jcfg.fsdp_params, jcfg.embed_fsdp))
    for tree in (st.opt_state.master, st.opt_state.m, st.opt_state.v):
        want += _jax_bytes(tree, params(True, True))
    want += 4                                     # the step count
    want += _jax_bytes(jspecs.batch_specs(jcfg, TRAIN), lambda p, s:
                       jshd.spec_for(jspecs._leaf_logical(p, s), s))
    assert got == want


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: lay.name)
@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-2b"])
def test_decode_cache_bytes_equal_jax(arch, layout, jax_rules):
    """The decode cache's K/V, MLA latents and recurrent states: the
    port's bytes a device equal JAX's (the write indices and ring
    positions, laid out differently, left out)."""
    _, (_model, _tokens, state) = _port_step(arch, DECODE)
    jcfg = jget_config(arch).reduced()
    cache = {"layers": [{k: v for k, v in layer.items() if k != "pos"}
                        for layer in state.cache["layers"]]}
    got = specs.state_bytes_per_device(cache, layout)
    assert got > 0

    jax_rules(layout)
    jcache = jax.eval_shape(lambda: jengine.init_cache(
        jcfg, DECODE.global_batch, DECODE.seq_len))
    want = _jax_bytes(jcache, lambda p, s: jshd.spec_for(
        jspecs._leaf_logical(p, s), s), skip=("pos", "index"))
    assert got == want


def test_saddle_tables_equal_jax():
    assert {k: tuple(v) for k, v in specs.SADDLE_DSVC_SHAPES.items()} == \
        {k: tuple(v) for k, v in jspecs.SADDLE_DSVC_SHAPES.items()}
    assert {k: tuple(v) for k, v in specs.SADDLE_SERVE_SHAPES.items()} == \
        {k: tuple(v) for k, v in jspecs.SADDLE_SERVE_SHAPES.items()}
    for k in (256, 512):
        for name, shape in specs.SADDLE_DSVC_SHAPES.items():
            got = specs.saddle_dsvc_client_shape(shape, k)
            assert got == jspecs.saddle_dsvc_client_shape(
                jspecs.SADDLE_DSVC_SHAPES[name], k)
            assert got == {"n_pad": 4096 if k == 256 else 2048, "d": 256,
                           "b": 128 if name == "svm_1m_nu" else 1}
    for layout in LAYOUTS:
        for name, shape in specs.SADDLE_SERVE_SHAPES.items():
            assert specs.saddle_serve_placement(layout, shape) == \
                jspecs.saddle_serve_placement(
                    StandInMesh(layout), jspecs.SADDLE_SERVE_SHAPES[name])


def test_production_layouts():
    single, multi = mesh.production_layout(), mesh.production_layout(True)
    assert (single.name, single.axis_names, single.size) == \
        ("16x16", ("data", "model"), 256)
    assert (multi.name, multi.axis_names, multi.size) == \
        ("2x16x16", ("pod", "data", "model"), 512)
    assert single.coords(37) == {"data": 2, "model": 5}
    assert multi.coords(300) == {"pod": 1, "data": 2, "model": 12}
    assert single.column_ranks(3) == [d * 16 + 3 for d in range(16)]
    assert multi.column_ranks(5) == [(p * 16 + d) * 16 + 5
                                     for p in range(2) for d in range(16)]
    # jax.make_mesh's device order: row-major over the axes
    assert np.arange(512).reshape(multi.shape)[1, 2, 12] == 300


def test_dsvc_client_shard_is_pack_shards_layout():
    """A client's shard drawn at its own shape has the signs
    ``distributed.pack_shards`` gives that client of the whole problem."""
    from repro_torch.core import distributed

    shape = specs.SaddleDsvcShape("t", 1000, 900, 8, 0.8, 4, 5)
    k = 16
    xp_sh, mask_p = distributed.shard_points(np.zeros((1000, 8)), k)
    xm_sh, mask_m = distributed.shard_points(np.zeros((900, 8)), k)
    _, sign = distributed.pack_shards(xp_sh, mask_p, xm_sh, mask_m)
    for rank in (0, 7, 15):
        x_t, got = specs.dsvc_client_shard(shape, k, rank, "cpu")
        np.testing.assert_array_equal(got.numpy()[0], sign[rank])
        assert x_t.shape == (1, 8, sign.shape[1])
        assert torch.all(x_t[0][:, got[0] == 0] == 0)


def test_jax_train_state_is_the_ports():
    """The JAX train-state tree and the port's carry the same leaves
    (``convert.lm_tree_to_named``), so the rules key the same tensors."""
    from repro_torch import convert

    cfg, (state, _) = _port_step("deepseek-v2-lite-16b", TRAIN)
    _, jstate = _jax_train_state("deepseek-v2-lite-16b")
    named = convert.lm_tree_to_named(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     jstate.params), cfg)
    params = dict(state.model.named_parameters())
    assert named.keys() == params.keys()
    assert all(named[n].shape == tuple(p.shape) for n, p in params.items())
    assert set(opt.named(state.opt_state.master)) == set(params)
    # the config's dtypes: a reduced config trains in float32
    assert {p.dtype for p in params.values()} == {torch.float32}
