"""Theorem 8 measured on real collectives: the all-reduces a gloo process
group issues for the port's distributed step, runner chunk and serving
chunk (``repro_torch.utils.comm_audit``, counted from
``torch.profiler`` events) equal ``CommModel`` / ``ServeCommModel`` and
the hooks' own tally.  The port's mirror of the non-slow tests of
tests/test_comm_audit.py, which counts the collectives in XLA's HLO.

Every spec runs in ONE spawn of 8 gloo ranks (k = 2 and 4 on subgroups of
its first ranks), batched through ``comm_audit.collect_audits`` by a
module-scoped fixture; the planted fault runs on a one-rank group in this
process.
"""

import pytest
import torch
import torch.distributed as tdist

from repro.core import distributed as jdist
from repro_torch.core import distributed as dist
from repro_torch.core import engine, projections
from repro_torch.launch import mesh as meshlib
from repro_torch.utils import comm_audit

pytestmark = pytest.mark.dist

KS = (2, 4, 8)
BASE = dict(n1=96, n2=112, d=32, block_size=4)
NU = 1.0 / (0.8 * BASE["n1"])
SERVE_BASE = dict(n1=96, n2=112, d=32, chunk_steps=5)


def _specs():
    specs = [{"k": k, "nu": nu, **BASE, "chunk_steps": 5}
             for k in KS for nu in (0.0, NU)]
    # n / d variation (bytes must not scale with n or d) at one k
    specs.append({"k": 2, "nu": NU, "n1": 768, "n2": 896, "d": 128,
                  "block_size": 4})
    for k in (2, 8):
        for nu in (0.0, NU):
            specs.append({"kind": "serve", "k": k, "nu": nu,
                          "num_slots": 2 * k, "block_size": 1,
                          "placement": "lanes", **SERVE_BASE})
            specs.append({"kind": "serve", "k": k, "nu": nu,
                          "num_slots": 2, "block_size": 4,
                          "placement": "points", **SERVE_BASE})
    return specs


@pytest.fixture(scope="module")
def all_audits():
    recs = comm_audit.collect_audits(_specs(), backend="gloo", device="cpu",
                                     timeout_s=240)
    assert len(recs) == len(_specs()) and all(recs)
    return recs


@pytest.fixture(scope="module")
def audits(all_audits):
    return [r for r in all_audits if r.get("kind") != "serve"]


@pytest.fixture(scope="module")
def serve_audits(all_audits):
    return [r for r in all_audits if r.get("kind") == "serve"]


def _find(audits, **want):
    out = [r for r in audits
           if all(r.get(k) == v for k, v in want.items())]
    assert out, f"no audit record matching {want}"
    return out


def _model(k, nu):
    rounds = float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0
    return dist.CommModel(k=k, nu_rounds_per_iter=rounds)


# --------------------------------------------------- count == CommModel
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nu", [0.0, NU], ids=["hm", "nu"])
def test_measured_equals_model(audits, k, nu):
    """The profiler's per-iteration all-reduces, with their kinds from the
    hooks' log, are EXACTLY CommModel's multiset (JAX's CommModel too),
    and agree with the hooks' tally."""
    rec = _find(audits, k=k, nu=nu, n1=BASE["n1"])[0]
    model = _model(k, nu)
    assert rec["measured"] == rec["predicted"], rec
    assert rec["predicted"] == comm_audit.multiset_to_json(
        jdist.CommModel(k=k, nu_rounds_per_iter=model.nu_rounds_per_iter)
        .collective_multiset(BASE["block_size"]))
    assert rec["match"] is True and rec["hooks_agree"] is True
    assert rec["backend"] == "gloo"
    assert rec["per_iteration_count"] == \
        model.collectives_per_iteration(BASE["block_size"]) == \
        (29 if nu else 3)


@pytest.mark.parametrize("nu", [0.0, NU], ids=["hm", "nu"])
def test_count_independent_of_k(audits, nu):
    recs = _find(audits, nu=nu, n1=BASE["n1"])
    assert {r["k"] for r in recs} == set(KS)
    counts = {r["per_iteration_count"] for r in recs}
    payloads = {r["per_iteration_bytes"] for r in recs}
    assert len(counts) == 1 and len(payloads) == 1, (counts, payloads)


def test_count_and_bytes_independent_of_n_d(audits):
    """n 8x and d 4x: the same collectives and bytes an iteration."""
    small = _find(audits, k=2, nu=NU, n1=BASE["n1"])[0]
    big = _find(audits, k=2, nu=NU, n1=768)[0]
    assert big["n1"] * big["n2"] * big["d"] > \
        8 * small["n1"] * small["n2"] * small["d"]
    assert small["measured"] == big["measured"]
    assert small["per_iteration_bytes"] == big["per_iteration_bytes"]
    assert big["match"] is True


def test_bytes_are_o_block_not_o_nd(audits):
    """Per-iteration payload is the model's 4 (B + 2 + 2 [+ 2 + 2R + 4])
    bytes, far below one row of the data."""
    for rec in audits:
        model = _model(rec["k"], rec["nu"])
        want = 4 * model.payload_elements_per_iteration(rec["block_size"])
        assert rec["per_iteration_bytes"] == want == \
            rec["model_payload_bytes"], rec
        assert rec["per_iteration_bytes"] < 4 * rec["n1"], rec


# ------------------------------------------------------ chunk vs step
@pytest.mark.parametrize("nu", [0.0, NU], ids=["hm", "nu"])
def test_production_chunk_matches_single_step(audits, nu):
    """The runner's chunk (``distributed.sharded_run_fn``) issues the
    single step's multiset every step and, once a chunk, the (d,)
    objective sum alone."""
    for rec in _find(audits, nu=nu, n1=BASE["n1"]):
        assert rec["runner_match"] is True
        assert rec["runner_matches_step"] is True
        assert rec["runner_per_chunk"] == {
            f"all-reduce|add|{BASE['d']}": 1}, rec["runner_per_chunk"]


# ------------------------------------------------- serving chunk budget
@pytest.mark.parametrize("k", (2, 8))
@pytest.mark.parametrize("nu", [0.0, NU], ids=["hm", "nu"])
def test_serve_lanes_collective_free(serve_audits, k, nu):
    """The lanes placement issues no collective at all, in the steps or
    at the chunk boundary."""
    rec = _find(serve_audits, k=k, nu=nu, placement="lanes")[0]
    assert rec["measured"] == {} and rec["measured_per_chunk"] == {}
    assert rec["match"] is True
    assert rec["per_iteration_count"] == 0
    assert rec["per_iteration_bytes"] == 0


@pytest.mark.parametrize("k", (2, 8))
@pytest.mark.parametrize("nu", [0.0, NU], ids=["hm", "nu"])
def test_serve_points_match_model(serve_audits, k, nu):
    """The points placement issues ServeCommModel's multiset an iteration
    (the Theorem-8 count, payloads times S) and its two boundary sums a
    chunk."""
    rec = _find(serve_audits, k=k, nu=nu, placement="points")[0]
    rounds = float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0
    model = dist.ServeCommModel(k=k, num_slots=rec["num_slots"],
                                nu_rounds_per_iter=rounds)
    assert rec["measured"] == comm_audit.multiset_to_json(
        model.collective_multiset(rec["block_size"]))
    assert rec["measured_per_chunk"] == comm_audit.multiset_to_json(
        model.per_chunk_multiset(rec["d"]))
    assert rec["match"] is True and rec["hooks_agree"] is True
    assert rec["per_iteration_count"] == \
        model.collectives_per_iteration(rec["block_size"])
    assert rec["n_pad"] % (128 * k) == 0


# ----------------------------------------------------- model self-checks
def test_model_multiset_totals_consistent():
    for k in (1, 8):
        for rounds in (0.0, 24.0):
            m = dist.CommModel(k=k, nu_rounds_per_iter=rounds)
            for b in (1, 4, 128):
                ms = m.collective_multiset(b)
                assert sum(ms.values()) == m.collectives_per_iteration(b)
                assert sum(e * c for (_, _, e), c in ms.items()) == \
                    m.payload_elements_per_iteration(b)
            want = 3 if rounds == 0 else 5 + int(rounds)
            assert m.collectives_per_iteration(1) == want


def test_scalar_model_linear_in_k():
    for rounds in (0.0, float(projections.BISECT_ROUNDS_SOLVER)):
        per_k = [dist.CommModel(k=k, nu_rounds_per_iter=rounds)
                 .scalars_per_iteration() / k for k in (1, 5, 20, 256)]
        assert len(set(per_k)) == 1, per_k


# ------------------------------------------------------- planted fault
@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    group = meshlib.init_client_group(
        backend="gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        rank=0, world_size=1, device="cpu", timeout_s=60)
    try:
        yield group
    finally:
        tdist.destroy_process_group()


def test_stray_all_reduce_breaks_the_match(one_rank):
    """An all-reduce issued outside the hooks shows in the profiler's
    events but not in the hooks' log: the measurement no longer agrees,
    and its multiset is not the model's."""
    rec = comm_audit.audit_runner(one_rank, **BASE, nu=0.0)
    assert rec["match"] is True and rec["hooks_agree"] is True
    predicted = _model(1, 0.0).collective_multiset(BASE["block_size"])

    def step(stray: bool):
        def run(group):
            all_sum, _ = engine.group_hooks(group)
            all_sum(torch.ones(BASE["block_size"]))
            all_sum(torch.ones(2))
            if stray:
                tdist.all_reduce(torch.ones(2))
        return run

    clean = comm_audit.measure(one_rank, step(False))
    assert clean.agrees and len(clean.events) == 2
    planted = comm_audit.measure(one_rank, step(True))
    assert len(planted.events) == 3 and len(planted.log) == 2
    assert planted.agrees is False
    assert planted.multiset != predicted
    assert ("all-reduce", "unlogged", 2) in planted.multiset


def test_recorder_sees_every_hook_call_and_changes_no_result(one_rank):
    """The hooks report each all-reduce to the group's recorder (kind,
    elements, bytes per element, seconds) in issue order, and only when
    one is set; with or without it they return the same values."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    plain_sum, plain_max = engine.group_hooks(one_rank)
    rec = comm_audit.Recorder()
    rec_sum, rec_max = engine.group_hooks(one_rank._replace(recorder=rec))
    before = dict(engine.collective_counts)
    assert torch.equal(rec_sum(x), plain_sum(x))
    assert torch.equal(rec_max(x[0]), plain_max(x[0]))
    assert rec.log == [("add", 6, 4), ("max", 3, 4)]
    assert rec.seconds > 0.0
    after = engine.collective_counts
    assert after["all-reduce", "add", 6] - before.get(
        ("all-reduce", "add", 6), 0) == 2
    assert after["all-reduce", "max", 3] - before.get(
        ("all-reduce", "max", 3), 0) == 2
