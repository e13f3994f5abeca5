"""The port's walkthroughs (``repro_torch.examples``) run end to end on the
CPU and check what they claim."""

import pytest

pytestmark = pytest.mark.serve


def test_serve_lm_example_exact_and_falls_back(capsys):
    """``python -m repro_torch.examples.serve_lm --device cpu``: four
    staggered requests to reduced gemma-7b, two admitted mid-decode, each
    EXACT against its solo ``generate``; reduced recurrentgemma-2b on the
    service's fallback path, EXACT too."""
    from repro_torch.examples import serve_lm

    out = serve_lm.main(device="cpu")
    assert len(out["staggered"]) == len(serve_lm.REQS)
    assert all(ok for _, _, ok in out["staggered"])
    assert sum(chunk > 0 for _, chunk, _ in out["staggered"]) >= 2
    assert out["fallback"] == (False, True)
    assert "MISMATCH" not in capsys.readouterr().out
