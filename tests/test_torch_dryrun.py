"""The port's launch dry-run (``repro_torch.launch.dryrun``) held to its
contract: the CLI's solver and serving records at both production meshes
match ``CommModel`` / ``ServeCommModel`` (the JAX package's), the lanes
placement issues no collective, an all-reduce planted in the step fails
the CLI, a long_500k skip is written down with JAX's reason, and the LM
entry's records carry the JAX dry-run's keys with FLOPs equal to a real
run's at the same tiny shape.  (JAX's own small dry-run fails most of its
cases in this environment, so the port is held to the contract, not to
that test's output.)  The CLI's calls share one spawned process (a fake
group is its process's default group); its card default is tested
here."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_launch_workers as workers
from _torch_launch_workers import one_thread  # noqa: F401
from repro.core import distributed as jdist
from repro.launch import shapes as jshapes
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.launch.shapes import InputShape

pytestmark = [pytest.mark.dist, pytest.mark.usefixtures("one_thread")]

TIMEOUT_S = 240
JAX_KEYS = {"arch", "shape", "mesh", "applicable", "reason", "unrolled",
            "lower_s", "compile_s", "memory", "hlo_flops_per_device",
            "hlo_bytes_per_device", "collective_bytes_per_device",
            "collective_breakdown", "collective_counts", "compute_s",
            "memory_s", "collective_s", "bottleneck",
            "model_flops_per_device", "useful_flops_ratio", "mfu_bound"}


def _records(out):
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}


@pytest.fixture(scope="module")
def cli(tmp_path_factory, one_thread):
    out = tmp_path_factory.mktemp("dryrun")
    runs = mesh.run_in_child(workers.dryrun_cli_runs, str(out),
                             timeout_s=TIMEOUT_S)
    return {"runs": runs, "ok": _records(out / "ok"),
            "planted": _records(out / "planted")}


@pytest.fixture(scope="module")
def solver_records(cli):
    for arch in ("saddle-dsvc", "saddle-serve"):
        rc, printed = cli["runs"][arch]
        assert rc == 0, printed[-3000:]
    assert len(cli["ok"]) == 8
    return cli["ok"]


def _json(ms):
    return {"|".join(map(str, k)): v for k, v in ms.items()}


def test_solver_records_match_commmodel(solver_records):
    for name, k, b, n_pad in (("svm_1m_nu", 256, 128, 4096),
                              ("svm_1m_hm", 256, 1, 4096),
                              ("svm_1m_nu", 512, 128, 2048),
                              ("svm_1m_hm", 512, 1, 2048)):
        rec = solver_records[f"saddle-dsvc_{name}_"
                             f"{'single' if k == 256 else 'multi'}"]
        ca = rec["comm_audit"]
        nu = name == "svm_1m_nu"
        model = jdist.CommModel(k=k, nu_rounds_per_iter=24.0 if nu else 0.0)
        want = _json(model.collective_multiset(b))
        assert rec["mesh"] == ("16x16" if k == 256 else "2x16x16")
        assert (ca["k"], ca["block_size"], ca["n_pad"], ca["d"]) == \
            (k, b, n_pad, 256)
        assert ca["match"] and ca["measured_per_iteration"] == want
        assert ca["predicted_per_iteration"] == want
        assert ca["runner_per_iteration"] == want
        assert ca["per_iteration_count"] == (29 if nu else 3)
        # the chunk boundary's objective: A eta - B xi summed, (d,)
        assert ca["per_chunk"] == {"all-reduce|add|256": 1}
        assert ca["model_scalars_per_iteration"] == \
            model.scalars_per_iteration()
        assert rec["memory"]["temp_size_in_bytes"] is None


def test_serve_records_match_servecommmodel(solver_records):
    for mp, k, lanes, kp, m in ((False, 256, 2, 16, 65_536),
                                (True, 512, 1, 32, 32_768)):
        tag = "multi" if mp else "single"
        ca = solver_records[f"saddle-serve_serve_lanes_512_{tag}"][
            "comm_audit"]
        assert ca["match"] and ca["slot_axes"] == (
            ["pod", "data", "model"] if mp else ["data", "model"])
        assert (ca["k_slots"], ca["lanes_per_rank"], ca["n_pad"],
                ca["d"]) == (k, lanes, 4096, 64)
        assert ca["measured_per_iteration"] == {}
        assert ca["measured_per_chunk"] == {}
        ca = solver_records[f"saddle-serve_serve_points_1m_{tag}"][
            "comm_audit"]
        model = jdist.ServeCommModel(k=kp, num_slots=2,
                                     nu_rounds_per_iter=24.0)
        assert ca["match"] and (ca["slot_axes"], ca["point_axes"]) == (
            ["model"], ["pod", "data"] if mp else ["data"])
        assert (ca["k_points"], ca["lanes_per_rank"], ca["rank_n_pad"],
                ca["n_pad"], ca["block_size"]) == (kp, 2, m, 1 << 20, 128)
        assert ca["measured_per_iteration"] == _json(
            model.collective_multiset(128))
        assert ca["measured_per_chunk"] == _json(
            model.per_chunk_multiset(256))


def test_planted_all_reduce_fails_the_cli(cli):
    rc, printed = cli["runs"]["planted"]
    assert rc == 1, printed
    assert "FAILURES" in printed
    rec = cli["planted"]["saddle-dsvc_svm_1m_hm_single"]
    assert "!= CommModel" in rec["error"]


def test_long_500k_skip_record_on_full_attention():
    recs = dryrun.run_one("gemma-7b", "long_500k", [False, True],
                          verbose=False)
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert [dryrun._tag(r["arch"], r["shape"], mp) for r, mp in
            zip(recs, (False, True))] == ["gemma-7b_long_500k_single",
                                          "gemma-7b_long_500k_multi"]
    ok, reason = jshapes.applicability(jget_config("gemma-7b"),
                                       jshapes.SHAPES["long_500k"])
    for rec in recs:
        assert (rec["applicable"], rec["reason"]) == (ok, reason)
        assert not ok and "hlo_flops_per_device" not in rec
        json.dumps(rec)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_card_is_the_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "saddle-dsvc", "--out", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_one_saddle("svm_1m_hm", False, verbose=False)


@pytest.mark.parametrize("arch,kind", [
    ("h2o-danube-1.8b", "train"),
    ("recurrentgemma-2b", "decode"),
    ("whisper-medium", "prefill"),
])
def test_lm_entry_records(arch, kind):
    """One fake run gives both meshes' records; its FLOPs equal a real
    run's ``FlopCounterMode`` count at the same tiny shape, and its
    argument bytes the rules' count of the real arguments."""
    cfg = get_config(arch).reduced()
    shape = InputShape("t", kind, 32, 8)
    single, multi = dryrun.run_one(arch, shape, [False, True], cfg=cfg,
                                   verbose=False)
    assert set(single) == set(multi) == JAX_KEYS | {"run_s"}
    assert (single["mesh"], multi["mesh"]) == ("16x16", "2x16x16")
    assert single["applicable"] and single["unrolled"]
    json.dumps(single)

    fn, args = specs.build_lowerable(cfg, shape, "cpu", seed=0)
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    flops = counter.get_total_flops()
    assert flops > 0
    assert single["hlo_flops_per_device"] * 256 == flops
    assert multi["hlo_flops_per_device"] * 512 == flops
    assert single["memory"]["argument_size_in_bytes"] == \
        specs.argument_bytes_per_device(
            cfg, kind, args, dryrun.meshlib.production_layout(False))
    assert single["memory"]["temp_size_in_bytes"] is None
    assert single["collective_s"] is None
    assert single["bottleneck"] in ("compute", "memory")
    assert 0 < single["mfu_bound"] and single["model_flops_per_device"] > 0
