"""The launch dry-run in the analysis gate: the launch-plan audit covers
the per-client shard shapes of the production meshes (k = 256 and 512)
under the JAX auditor's labels, with no finding; the lint's dry-run
targets (one client on a fake group of k ranks, in a spawned process) are
clean, their steps' collectives equal ``CommModel`` at k, and an
all-reduce planted in the step is caught."""

import pytest

import _torch_launch_workers as workers
from _torch_launch_workers import one_thread  # noqa: F401
from repro.analysis import pallas_audit
from repro.core import distributed as jdist
from repro_torch.analysis import kernel_audit, lint
from repro_torch.launch import mesh

pytestmark = [pytest.mark.dist, pytest.mark.usefixtures("one_thread")]

SPAWN_TIMEOUT_S = 240


def _dryrun_cases(cases):
    return sorted((c.kernel, c.case) for c in cases
                  if c.case.startswith("dryrun "))


def test_audit_has_the_dryrun_shard_cases_with_jax_labels():
    cases = kernel_audit.audit_cases()
    got = _dryrun_cases(cases)
    want = _dryrun_cases(pallas_audit.audit_cases())
    assert got == want and len(got) == 8
    assert len(cases) == 481
    shard = {c.case: c.kwargs for c in cases if c.case.startswith("dryrun ")}
    assert shard["dryrun svm_1m_nu k=256 n_pad=4096 d=256 b=128"] == dict(
        s=1, d=256, n_pad=4096, b=128)
    assert shard["dryrun svm_1m_hm k=512 n_pad=2048 d=256 b=1"] == dict(
        s=1, d=256, n_pad=2048, b=1)


def test_dryrun_shard_cases_have_no_finding():
    cases = [c for c in kernel_audit.audit_cases()
             if c.case.startswith("dryrun ")]
    records, findings = kernel_audit.audit_all(cases)
    assert findings == [] and len(records) == 8
    assert all(r["findings"] == 0 for r in records)


@pytest.fixture(scope="module")
def linted(one_thread):
    return mesh.run_in_child(workers.dryrun_lint_cases,
                             timeout_s=SPAWN_TIMEOUT_S)


def test_dryrun_mesh_targets_are_clean(linted):
    assert linted["findings"] == []
    names = [r["target"] for r in linted["records"]]
    assert names == [t.name for t in lint.dryrun_mesh_targets()] == [
        "dryrun.svm_1m_nu[k=256]", "dryrun.svm_1m_hm[k=256]",
        "dryrun.svm_1m_nu[k=512]", "dryrun.svm_1m_hm[k=512]"]
    for rec in linted["records"]:
        assert rec["calls_per_unit"] == {"momentum_dot_packed": 1,
                                         "mwu_update_packed": 1}


def test_dryrun_targets_collectives_equal_jax_commmodel(linted):
    for rec in linted["records"]:
        nu = "svm_1m_nu" in rec["target"]
        b = 128 if nu else 1
        model = jdist.CommModel(k=rec["fake_k"],
                                nu_rounds_per_iter=24.0 if nu else 0.0)
        want = {"|".join(map(str, k)): v
                for k, v in model.collective_multiset(b).items()}
        assert rec["collectives_per_unit"] == want, rec["target"]
        assert sum(want.values()) == (29 if nu else 3)


def test_planted_all_reduce_is_caught_at_both_meshes(linted):
    rules = [(f[0], f[1]) for f in linted["planted"]]
    assert sorted(rules) == sorted(
        ("COMM-001", t.name) for t in lint.dryrun_mesh_targets())
    assert all("exceed the CommModel budget" in f[2]
               for f in linted["planted"])
