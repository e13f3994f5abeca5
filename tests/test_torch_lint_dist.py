"""The lint's k = 8 targets (``repro_torch.analysis.lint.group_targets``)
over one module-scoped spawn of 8 gloo ranks, as
tests/test_torch_collectives.py runs its cases: the sharded runner and the
serving chunk's two placements are clean on every rank, their per-step
collectives equal ``CommModel`` / ``ServeCommModel`` (none for the lanes
placement), and an all-reduce planted in the step is caught."""

import pytest

import _torch_lint_workers as workers
from repro_torch.analysis import lint
from repro_torch.core import distributed, projections
from repro_torch.launch import mesh as meshlib

pytestmark = pytest.mark.dist

SPAWN_TIMEOUT_S = 240
K = lint.DIST_K


@pytest.fixture(scope="module")
def ranks():
    return meshlib.spawn_clients(workers.lint_cases, K, backend="gloo",
                                 device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _records(ranks, name):
    return [rec for r in ranks for rec in r["records"]
            if rec["target"] == name]


def test_group_targets_are_clean_on_every_rank(ranks):
    assert [r["findings"] for r in ranks] == [[]] * K
    names = [t.name for t in lint.group_targets()]
    for name in names:
        recs = _records(ranks, name)
        assert sorted(rec["rank"] for rec in recs) == list(range(K))
        assert all(rec["calls_per_unit"] == {"momentum_dot_packed": 1,
                                             "mwu_update_packed": 1}
                   for rec in recs)


def _multiset(model, block):
    return {"|".join(map(str, k)): v
            for k, v in model.collective_multiset(block).items()}


def test_per_step_collectives_equal_the_models(ranks):
    rounds = float(projections.BISECT_ROUNDS_SOLVER)
    runner = distributed.CommModel(k=K, nu_rounds_per_iter=rounds)
    points = distributed.ServeCommModel(k=K, num_slots=2,
                                        nu_rounds_per_iter=rounds)
    want = {f"distributed.sharded_run_fn[k={K}]": _multiset(runner, 128),
            f"engine.run_chunk_slots_sharded[points,k={K}]":
                _multiset(points, 1),
            f"engine.run_chunk_slots_sharded[lanes,k={K}]": {}}
    for name, multiset in want.items():
        for rec in _records(ranks, name):
            assert rec["collectives_per_unit"] == multiset, (name, rec)
    lanes = _records(ranks, f"engine.run_chunk_slots_sharded[lanes,k={K}]")
    assert all(rec["collectives"] == 0 for rec in lanes)


def test_planted_all_reduce_is_caught(ranks):
    for r in ranks:
        rules = {f[0] for f in r["planted"]}
        assert rules == {"COMM-001"}, r["planted"]
        assert "exceed the CommModel budget" in r["planted"][0][2]
