"""The audit of the hand kernels' launch plans
(``repro_torch.analysis.kernel_audit``): the registry covers every CUDA
entry point, the sweep is clean, each rule catches a planted fault, the
plan dicts give exactly the geometry the wrappers passed to the C
launchers before they launched from memoised launch tuples, and the plans
are built from those same tuples."""

import copy
import re
from pathlib import Path

import pytest

from repro_torch.analysis import kernel_audit as ka
from repro_torch.kernels import fwht
from repro_torch.kernels import saddle_update as su

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def test_registry_covers_every_cuda_entry_point():
    """Every exported launcher of ``kernels/csrc`` belongs to a registered
    plan: the five wrappers of the five Pallas kernels."""
    reg = ka.registry()
    assert set(reg) == {"momentum_dot_packed", "mwu_update_packed",
                        "momentum_dot", "mwu_update", "fwht"}
    launchers = set()
    for src in CSRC.glob("*.cu"):
        launchers |= set(re.findall(r'extern "C" int (\w+)_f32\(',
                                    src.read_text()))
    assert launchers == {"momentum_dot_packed", "mwu_update_packed",
                         "momentum_dot", "mwu_update", "fwht_rows",
                         "fwht_strided"}
    cases = {c.kernel for c in ka.audit_cases()}
    assert cases == set(reg)


def test_full_sweep_is_clean():
    records, findings = ka.audit_all()
    assert findings == []
    assert len(records) == len(ka.audit_cases()) > 400
    # the sweep reaches both FWHT pass counts and multi-block merges
    assert any(len(r["grids"]) == 2 for r in records if r["kernel"] ==
               "fwht")
    assert any(r["grids"][0][0] > 1 for r in records
               if r["kernel"] == "mwu_update")


# ------------------------------------------------------- planted faults

def _packed():
    return ka.momentum_dot_packed_plan(s=2, d=64, n_pad=4096, b=8)


def _rules(plan, kernel="k"):
    return {f.rule for f in ka.audit_plan(plan, kernel=kernel)}


def test_unplanted_plans_are_clean():
    for plan in (_packed(), ka.mwu_update_plan(k=3, n=5001, b=1),
                 ka.momentum_dot_plan(k=2, n=9000, b=128),
                 ka.fwht_rows_plan(n=5, d=65536)):
        assert ka.audit_plan(plan) == []


def test_block_past_n_is_caught():
    plan = _packed()
    plan["axes"][0]["hi"][-1] += su.LANE
    assert _rules(plan) == {"BLOCK-001"}
    plan = ka.mwu_update_plan(k=3, n=5001, b=1)
    plan["axes"][0]["extent"] += 1          # blocks run one point past n
    plan["axes"][0]["hi"][-1] += 1
    assert "BLOCK-001" in _rules(plan)


@pytest.mark.parametrize("make", [
    _packed, lambda: ka.mwu_update_plan(k=3, n=5001, b=1),
    lambda: ka.momentum_dot_plan(k=2, n=9000, b=128),
    lambda: ka.fwht_rows_plan(n=5, d=65536)])
def test_dropped_last_block_is_caught(make):
    plan = make()
    p = ka.launches(plan)[-1]
    gx, gy, gz = p["grid"]
    p["grid"] = (gx - 1, gy, gz)
    for key in ("lo", "hi"):
        p["axes"][0][key] = p["axes"][0][key][:-1]
    if p["partials"] is not None:
        for key in ("lo", "hi"):
            p["partials"][key] = p["partials"][key][:-1]
    assert "COVER-001" in _rules(plan)


def test_two_blocks_on_one_partial_slot_are_caught():
    for plan in (_packed(), ka.mwu_update_plan(k=3, n=5001, b=1),
                 ka.momentum_dot_plan(k=2, n=9000, b=128)):
        part = plan["partials"]
        part["lo"][1] = part["lo"][0]
        part["hi"][1] = part["hi"][0]
        assert _rules(plan) == {"RACE-001"}


def test_merge_without_ticket_or_shared_counter_is_caught():
    plan = ka.mwu_update_plan(k=3, n=5001, b=1)
    plan["ticket"] = False
    assert _rules(plan) == {"RACE-001"}
    plan = ka.mwu_update_plan(k=3, n=5001, b=1)
    plan["counter"][1] = plan["counter"][0]
    assert _rules(plan) == {"RACE-001"}


def test_shared_memory_over_the_limit_is_caught():
    plan = _packed()
    plan["dynamic_smem"] = su.MAX_SMEM - plan["static_smem"] + 1
    assert _rules(plan) == {"SMEM-001"}
    plan["dynamic_smem"] -= 1
    assert _rules(plan) == set()


def test_grid_y_over_65535_is_caught():
    plan = _packed()
    gx, _, gz = plan["grid"]
    plan["grid"] = (gx, 65_536, gz)
    assert "GRID-001" in _rules(plan)
    plan = _packed()
    plan["threads"] = 2_048
    assert _rules(plan) == {"GRID-001"}


# ------------------------------------- the geometry the wrappers passed
# (the parent's expressions, copied: the plans must reproduce them)

def _old_packed(name, s, d, n_pad, b):
    tpb = su.packed_tiles_per_block(b)
    floats = (s * (n_pad // su.LANE) * (-(-b // 4) * 4)
              if name == "momentum_dot_packed" else s * (n_pad // su.LANE) * 4)
    grid = ((n_pad // su.LANE + tpb - 1) // tpb, s, 1)
    return dict(tpb=tpb), (s, floats), grid, su.packed_smem(b)


def _old_unpacked(name, k, n, b):
    if name == "momentum_dot":
        lanes, points, blocks, chunks = su.momentum_dot_geometry(k, n, b)
        ws = (k * chunks, k * chunks * blocks * su.DOT_COLS)
        grid = ((n + points - 1) // points, chunks, k)
        smem = 0
    else:
        lanes, points, blocks = su.mwu_update_geometry(k, n, b)
        ws = (k, 2 * k * blocks)
        grid = ((n + points - 1) // points, k, 1)
        smem = 3 * points * 4
    return dict(lanes=lanes, points=points), ws, grid, smem


def test_plans_give_the_parents_launch_geometry():
    reg = ka.registry()
    seen = 0
    for c in ka.audit_cases():
        plan = reg[c.kernel](**c.kwargs)
        kw = {k: v for k, v in c.kwargs.items() if k != "normalize"}
        if c.kernel == "fwht":
            n, d = kw["n"], kw["d"]
            old = fwht.fwht_plan(d)
            first, *strided = plan["passes"]
            assert first["args"]["rows"] == n * old.d1
            assert first["args"]["d2"] == old.d2
            assert first["grid"][0] == -(-n * old.d1 // old.rows_per_block)
            assert len(strided) == len(old.strided)
            log_s = old.d2.bit_length() - 1
            for p, log_m in zip(strided, old.strided):
                assert (p["args"]["rows"], p["args"]["log_s"],
                        p["args"]["log_m"]) == ((n * d) >> log_m, log_s,
                                                log_m)
                assert p["grid"][0] == -(-((n * d) >> log_m) // 256)
                log_s += log_m
            continue
        if "n_pad" in kw:
            args, ws, grid, smem = _old_packed(c.kernel, **kw)
        else:
            args, ws, grid, smem = _old_unpacked(c.kernel, **kw)
        assert plan["args"] == args, c
        assert (plan["workspace"]["counters"],
                plan["workspace"]["floats"]) == ws, c
        assert plan["grid"] == grid, c
        assert plan["dynamic_smem"] == smem, c
        seen += 1
    assert seen > 300


def test_plans_hold_the_wrappers_launch_tuples():
    """A plan's grid, shared memory, geometry arguments and workspace are
    the memoised ``saddle_update.Launch`` the wrapper launches from."""
    su.packed_launch.cache_clear()
    for kernel in ("momentum_dot_packed", "mwu_update_packed"):
        plan = ka.registry()[kernel](s=3, d=512, n_pad=50_048, b=1)
        ln = su.packed_launch(kernel, 3, 50_048, 1)
        assert (plan["grid"], plan["dynamic_smem"], plan["args"]) == (
            ln.grid, ln.dynamic_smem, {"tpb": ln.args[0]})
        assert plan["workspace"] == {"counters": ln.counters,
                                     "floats": ln.floats}
    assert su.packed_launch.cache_info().misses == 2
    for kernel, launch in (("momentum_dot", su.momentum_dot_launch),
                           ("mwu_update", su.mwu_update_launch)):
        plan = ka.registry()[kernel](k=20, n=251, b=128)
        ln = launch(20, 251, 128)
        assert (plan["grid"], plan["dynamic_smem"],
                tuple(plan["args"].values())) == (ln.grid, ln.dynamic_smem,
                                                  ln.args)
        assert launch(20, 251, 128) is ln                     # memoised


def test_static_smem_is_the_compiled_layout():
    """The plans' static shared memory: each kernel's ``__shared__``
    declarations laid out as nvcc does for sm_90a, the figures the
    library's ``static_smem`` read on an H100 (``chip_smoke.py`` n2 holds
    them equal on every run)."""
    assert set(ka.STATIC_SMEM_ORDER) == set(ka.STATIC_SMEM)
    assert ka.STATIC_SMEM == {"momentum_dot_packed": 4224,
                              "mwu_update_packed": 4224,
                              "momentum_dot[b=1]": 4224,
                              "momentum_dot": 20608, "mwu_update": 128}
    # the largest packed block still fits beside them
    big = su.packed_smem(su.CHUNK_ROWS + 1)
    assert all(v + big <= su.MAX_SMEM for v in ka.STATIC_SMEM.values())
    plan = _packed()
    assert copy.deepcopy(plan)["grid"] == plan["grid"]   # plain data
