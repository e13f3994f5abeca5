"""The sharding rules of the port (``repro_torch.models.sharding``), its
test meshes (``launch.mesh.make_test_mesh``) and its launcher over several
ranks, held to the JAX package's (``repro.models.sharding``,
``repro.launch.mesh``), which run in a subprocess with 8 forced host
devices as ``tests/test_sharding.py`` runs them; and, on a fake group of
2 ranks, every registered config placed on a mesh, its cache refused
there, and the functional collectives that ``utils.dispatch_trace``
records."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_launch_workers import one_thread  # noqa: F401
from _torch_sharding_workers import fake_group_checks
from repro_torch.configs import get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("h2o-danube-1.8b", "gemma-7b", "deepseek-v2-lite-16b",
         "deepseek-v2-236b", "xlstm-125m", "recurrentgemma-2b",
         "whisper-medium", "qwen2-vl-7b")
LAYOUT = meshlib.Layout("4x2", ("data", "model"), (4, 2))

JAX_SIDE = r"""
import json
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import sharding as shd
from repro.models import transformer as tf
from repro_torch import convert
from repro_torch.configs import get_config as port_config

out = {"layouts": {n: list(make_test_mesh(n).devices.shape)
                   for n in range(1, 9)}, "specs": {}}
mesh = jax.make_mesh((4, 2), ("data", "model"))
shd.set_mesh_axes(mesh)


def entry(e):
    return list(e) if isinstance(e, tuple) else e


for arch in sys.argv[1:]:
    cfg = get_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: tf.init_lm(k, cfg), jax.random.key(0))
    tree = shd.param_sharding_tree(shapes, mesh, fsdp=cfg.fsdp_params,
                                   embed_fsdp=cfg.embed_fsdp)

    def encode(path, sharding, leaf):
        keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        spec = [entry(e) for e in sharding.spec]
        spec += [None] * (len(leaf.shape) - len(spec))
        if "/blocks/" in f"/{keys}/":      # a stacked period: per layer
            return np.array([json.dumps(spec[1:])] * leaf.shape[0],
                            dtype=object)
        return np.array(json.dumps(spec), dtype=object)

    objs = jax.tree_util.tree_map_with_path(encode, tree, shapes)
    named = convert.lm_tree_to_named(objs, port_config(arch).reduced())
    out["specs"][arch] = {k: json.loads(np.asarray(v).item())
                          for k, v in named.items()}
print("JAX_SIDE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_SIDE, *ARCHS],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=240)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("JAX_SIDE ")]
    assert line, out.stdout + out.stderr
    return json.loads(line[0][len("JAX_SIDE "):])


def _json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_spec_divisibility_guard():
    """JAX's ``test_spec_divisibility_guard`` cases on a (4, 2) layout."""
    s = shd.spec_for(["batch", None, "heads", None], (8, 1, 28, 64), LAYOUT)
    assert s[2] == "model", s
    s = shd.spec_for(["batch", None, "heads", None], (8, 1, 7, 64), LAYOUT)
    assert s[2] is None, s
    s = shd.spec_for(["batch", None], (2, 16), LAYOUT)
    assert s[0] is None, s
    s = shd.spec_for(["heads", "mlp"], (4, 4), LAYOUT)
    assert not (s[0] == "model" and s[1] == "model"), s


def test_no_mesh_is_noop():
    shd.set_mesh_axes(None)
    x = torch.ones(4, 4)
    assert shd.shard(x, "batch", "mlp") is x
    assert shd.gather(x, "batch", "mlp", shape=(4, 4)) is x
    assert shd.spec_for(["batch", "mlp"], (4, 4)) == ()
    assert shd.copy_to(x) is x and shd.reduce_from(x) is x
    assert shd.batch_rows(x) is x and shd.batch_ways() == 1


def test_placed_parameter_without_a_mesh_raises():
    shd.set_mesh_axes(None)
    p = torch.nn.Parameter(torch.zeros(2, 3))
    p.spec = ("data", None)
    with pytest.raises(RuntimeError):
        shd.param(p)


def test_make_test_mesh_layouts_equal_jax(jax_side):
    for k in range(1, 9):
        layout = meshlib.layout_for(k)
        assert layout.axis_names == ("data", "model")
        assert list(layout.shape) == jax_side["layouts"][str(k)], k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(jax_side, arch):
    """Every parameter of the reduced config: the port's ``param_spec``
    (by ``param_sharding_tree``) against JAX's ``param_sharding_tree`` on
    a forced 8-device (4, 2) mesh, leaf for leaf by the port's names."""
    cfg = get_config(arch).reduced()
    got = shd.param_sharding_tree(tf.LM(cfg, "meta"), LAYOUT,
                                  fsdp=cfg.fsdp_params,
                                  embed_fsdp=cfg.embed_fsdp)
    want = jax_side["specs"][arch]
    assert got.keys() == want.keys()
    for name, spec in got.items():
        assert _json(spec) == want[name], name
    assert any("data" in _json(s) for s in got.values())
    assert any("model" in _json(s) for s in got.values())


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    names = ("data", "model")
    assert shd.to_placements(("data", "model", None), names) == [
        Shard(0), Shard(1)]
    assert shd.to_placements(("model", None), names) == [
        Replicate(), Shard(0)]
    assert shd.to_placements((None,), names) == [Replicate(), Replicate()]
    assert shd.to_placements((("data", "pod"), None),
                             ("pod", "data", "model")) == [
        Shard(0), Shard(0), Replicate()]


def test_train_state_sharding_keeps_state_fully_sharded():
    """``launch.specs.train_state_sharding``: under ZeRO-2 the parameters'
    specs leave ``data`` out and the master and moments keep it."""
    import dataclasses

    from repro_torch.launch import specs

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              fsdp_params=False)
    sh = specs.train_state_sharding(tf.LM(cfg, "meta"), LAYOUT, cfg)
    name = "layers.0.mixer.wq"
    assert sh["params"][name] == (None, "model", None)
    assert sh["master"][name] == sh["m"][name] == ("data", "model", None)
    assert sh["step"] == ()


@pytest.fixture(scope="module")
def fake():
    return meshlib.run_in_child(fake_group_checks, timeout_s=240)


def test_families_outside_the_slice_raise_on_a_mesh(fake):
    """Every registered config places on a mesh (the recurrent, whisper
    and qwen2-vl families too); a forward with a cache (a prefill) on a
    mesh still raises, naming the sharded cache."""
    from repro_torch.configs import list_configs

    assert fake["layout"].shape == (1, 2)
    assert set(fake["raised"]) == set(list_configs())
    for arch, msg in fake["raised"].items():
        assert msg is None, f"{arch}: {msg}"
    assert set(fake["cached"]) == set(list_configs())
    for arch, msg in fake["cached"].items():
        assert msg is not None, f"{arch}: a cache ran on a mesh"
        assert "sharded cache" in msg and "ROADMAP.md" in msg, msg


def test_trace_counts_functional_collectives(fake):
    """DTensor's redistribution and the functional collectives are
    recorded under the ``c10d`` ops' names (``wait_tensor`` is not)."""
    assert fake["dm"]
    got = [c[:3] for c in fake["collectives"]]
    assert got == [("all-reduce", "add", 24), ("all-reduce", "max", 24),
                   ("all-gather", "", 24), ("reduce-scatter", "", 24),
                   ("all-gather", "", 24)], got


def test_launcher_over_two_ranks_prints_jax_lines(capsys, one_thread):
    """``launch.train --ranks 2 --backend gloo --device cpu``: the JAX
    launcher's lines with the (1, 2) mesh, and the unsharded launcher's
    losses (1e-5)."""
    flags = ["--arch", "h2o-danube-1.8b", "--steps", "3", "--batch", "2",
             "--seq", "16", "--device", "cpu"]
    got = train.main(flags + ["--ranks", "2", "--backend", "gloo"])
    lines = capsys.readouterr().out.splitlines()
    want = train.make_trainer(train.parse_args(flags)).train(3)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert lines[0].startswith("mesh={'data': 1, 'model': 2} "
                               "arch=h2o-danube-1.8b params=1,574,144")
    assert [ln.split()[:2] for ln in lines[1:]] == [["step", "0"],
                                                    ["step", "2"]]


def test_ranks_above_one_need_a_backend():
    with pytest.raises(SystemExit):
        train.parse_args(["--ranks", "2"])


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-medium"])
def test_launcher_over_two_ranks_trains_every_family(capsys, one_thread,
                                                     arch):
    """``launch.train --ranks 2`` of JAX's default arch (xlstm-125m: its
    mLSTM and sLSTM heads split) and of whisper (encoder, cross attention,
    the launcher's frames cut to each rank's rows): the unsharded
    launcher's losses (1e-5)."""
    flags = ["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
             "--device", "cpu"]
    got = train.main(flags + ["--ranks", "2", "--backend", "gloo"])
    lines = capsys.readouterr().out.splitlines()
    want = train.make_trainer(train.parse_args(flags)).train(2)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert lines[0].startswith("mesh={'data': 1, 'model': 2} "
                               f"arch={arch}")
