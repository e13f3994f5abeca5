"""The lint of the hot paths (``repro_torch.analysis.lint``) on the CPU:
the serial targets are clean, each rule catches a fault planted in the
packed chunk, suppressions need a justification, and the gate
(``python -m repro_torch.analysis.run --device cpu --json``) exits 0."""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from _torch_launch_workers import one_thread  # noqa: F401
from repro_torch.analysis import lint
from repro_torch.core import engine

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("target", lint.serial_targets(),
                         ids=lambda t: t.name)
def test_serial_target_is_clean(target):
    record, findings = lint.lint_target(target, "cpu")
    assert findings == []
    assert record["collectives"] == 0
    if target.units is not None and target.per_unit:
        per = {k: v for k, v in target.per_unit.items()
               if k in lint.PACKED}
        assert record["calls_per_unit"] == per


def _chunk_target():
    return next(t for t in lint.serial_targets()
                if t.name == "engine.run_chunk_packed")


def _rules(monkeypatch, step_fault=None, chunk_fault=None):
    """The rules a fault in the packed step (or around the chunk) breaks."""
    if step_fault is not None:
        step = engine._step_packed_core

        def faulty(state, *args, **kw):
            out = step(state, *args, **kw)
            step_fault(out)
            return out
        monkeypatch.setattr(engine, "_step_packed_core", faulty)
    if chunk_fault is not None:
        chunk = engine.chunk_body_packed

        def faulty_chunk(state, *args, **kw):
            chunk_fault(state)
            return chunk(state, *args, **kw)
        monkeypatch.setattr(engine, "chunk_body_packed", faulty_chunk)
    _, findings = lint.lint_target(_chunk_target(), "cpu")
    return {f.rule for f in findings}


def test_item_inside_a_chunk_is_caught(monkeypatch):
    assert _rules(monkeypatch, lambda out: out.w.sum().item()) == \
        {"SYNC-001"}


def test_float64_op_is_caught(monkeypatch):
    assert _rules(monkeypatch, lambda out: out.w.double() * 2) == \
        {"DTYPE-001"}


def test_all_reduce_in_a_serial_target_is_caught(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            rules = _rules(monkeypatch,
                           lambda out: dist.all_reduce(out.w.clone()))
        finally:
            dist.destroy_process_group()
    assert rules == {"COMM-001"}


def test_data_dependent_loop_is_caught(monkeypatch):
    def loop(out):
        x = out.w
        for _ in range(int(out.t[0]) % 3):      # work that varies by step
            x = x * 0.5
    rules = _rules(monkeypatch, loop)
    assert "STEP-001" in rules and "SYNC-001" in rules


def test_entry_state_held_by_the_engine_is_caught(monkeypatch):
    held = []
    assert _rules(monkeypatch, chunk_fault=held.append) == {"STATE-001"}


def test_suppressions_need_a_justification():
    f = lint.Finding("SYNC-001", "engine.run_chunk_packed", "x")
    with pytest.raises(ValueError):
        lint.apply_suppressions(
            [f], (lint.Suppression(f.rule, f.target, "  "),))
    live, waived = lint.apply_suppressions(
        [f], (lint.Suppression(f.rule, f.target, "why it is sound"),))
    assert live == [] and waived[0]["justification"] == "why it is sound"
    assert lint.apply_suppressions([f]) == ([f], [])
    assert all(s.justification.strip() for s in lint.SUPPRESSIONS)


def test_the_gate_exits_zero_on_the_cpu(tmp_path):
    out = tmp_path / "analysis.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.run", "--device", "cpu",
         "--json", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["unsuppressed_count"] == 0 and report["findings"] == []
    assert set(report) == {"rules", "kernel_cases", "hlo_targets",
                           "findings", "suppressed", "unsuppressed_count"}
    names = {r["target"] for r in report["hlo_targets"]}
    assert names == {t.name for t in lint.default_targets()}


def test_the_gate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.analysis import run
    with pytest.raises(RuntimeError):
        run.main(["--skip-lint"])
