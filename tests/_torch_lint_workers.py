"""Functions that the spawned gloo ranks of tests/test_torch_lint_dist.py
run (a spawned rank imports a function by its module path, so they live
here, not in a ``test_*.py`` module)."""

from repro_torch.analysis import lint
from repro_torch.core import engine


def lint_cases(group) -> dict:
    """Every k = 8 lint target on this rank, then the sharded runner with
    a planted fault: one extra all-reduce of w in every step."""
    names = [t.name for t in lint.group_targets()]
    records, findings = lint._rank_lint(group, names)
    step = engine._step_packed_core

    def noisy(state, *args, all_sum=engine._identity, **kw):
        out = step(state, *args, all_sum=all_sum, **kw)
        all_sum(out.w)
        return out

    engine._step_packed_core = noisy
    try:
        _, planted = lint._rank_lint(group, names[:1])
    finally:
        engine._step_packed_core = step
    return {"records": records, "findings": findings, "planted": planted}
