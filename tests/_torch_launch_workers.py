"""Helpers of the launch tests: the fixture that runs a module's small
torch ops on one thread, and the functions that the spawned processes of
tests/test_torch_launch_gate.py and tests/test_torch_dryrun.py run (a
spawned process imports a function by its module path, so they live
here, not in a ``test_*.py`` module)."""

import contextlib
import io
import os

import pytest
import torch

from repro_torch.analysis import lint
from repro_torch.core import engine


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for this module's small ops, in this process
    and in the processes it starts (``OMP_NUM_THREADS``), restored after:
    the suite's workers share the cores, and small ops on many threads
    spend most of their time waking them."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


@contextlib.contextmanager
def planted_all_reduce():
    """The planted fault: one extra all-reduce of w in every packed
    step."""
    step = engine._step_packed_core

    def noisy(state, *args, all_sum=engine._identity, **kw):
        out = step(state, *args, all_sum=all_sum, **kw)
        all_sum(out.w)
        return out

    engine._step_packed_core = noisy
    try:
        yield
    finally:
        engine._step_packed_core = step


def dryrun_lint_cases() -> dict:
    """The lint's dry-run targets (fake groups of k = 256 and 512) as the
    gate runs them on the CPU, then again with the planted fault."""
    names = [t.name for t in lint.dryrun_mesh_targets()]
    records, findings = lint._fake_lint(names, "cpu")
    with planted_all_reduce():
        _, planted = lint._fake_lint(names, "cpu")
    return {"records": records, "findings": findings, "planted": planted}


def _main(argv) -> tuple[int, str]:
    """``dryrun.main(argv)``'s exit code and what it printed."""
    from repro_torch.launch import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(argv)
    return rc, buf.getvalue()


def dryrun_cli_runs(out: str) -> dict:
    """The dry-run CLI's solver and serving entries at both meshes on the
    CPU (records in ``out``/ok), then the solver's hard-margin entry with
    the planted fault (records in ``out``/planted): each call's exit code
    and output.  Each entry makes and destroys its own fake group, so
    one process runs them all."""
    runs = {arch: _main(["--arch", arch, "--both-meshes", "--device", "cpu",
                         "--out", os.path.join(out, "ok")])
            for arch in ("saddle-dsvc", "saddle-serve")}
    with planted_all_reduce():
        runs["planted"] = _main(["--arch", "saddle-dsvc", "--shape",
                                 "svm_1m_hm", "--device", "cpu", "--out",
                                 os.path.join(out, "planted")])
    return runs
