"""The port's roofline helpers (``repro_torch.utils.roofline``) against the
JAX package's: the choosers and the differencing of tests/test_roofline.py
with the H100's peaks, the model-FLOP counts for every registered config,
and ``analyze`` counting a product's FLOPs and bytes from one run."""

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.utils import roofline as jroofline
from repro_torch.configs import get_config, list_configs
from repro_torch.utils import roofline


def _rf(flops=0.0, hbm=0.0, coll=0.0):
    return roofline.Roofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=coll,
        collectives=None,
        compute_s=flops / roofline.PEAK_FLOPS,
        memory_s=hbm / roofline.HBM_BW,
        collective_s=coll / roofline.NVLINK_BW)


def test_peaks_are_the_h100_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.F32_FLOPS, roofline.HBM_BW,
            roofline.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)


def test_delta_isolates_extra_work():
    a = _rf(flops=2e12, hbm=3e9)
    b = _rf(flops=1.5e12, hbm=1e9)
    d = roofline.delta(a, b)
    assert d.flops == pytest.approx(0.5e12)
    assert d.hbm_bytes == pytest.approx(2e9)
    assert d.step_time_s == pytest.approx(
        max(0.5e12 / roofline.PEAK_FLOPS, 2e9 / roofline.HBM_BW))


def test_delta_clamps_at_zero():
    d = roofline.delta(_rf(flops=1.0), _rf(flops=5.0, hbm=1.0))
    assert d.flops == 0.0 and d.hbm_bytes == 0.0
    assert d.step_time_s == 0.0


@pytest.mark.parametrize("costs", [{1: 1.0, 32: 2.0, 128: 4.0},
                                   {32: 1.0, 64: 3.0}])
def test_pick_block_size_matches_jax(costs):
    assert roofline.pick_block_size(costs) == jroofline.pick_block_size(
        costs)
    with pytest.raises(ValueError):
        roofline.pick_block_size({})


@pytest.mark.parametrize("args", [(1e-6, 1e-4, 10000), (1e-3, 0.0, 10000),
                                  (1e-9, 1.0, 10000)])
def test_gap_check_cadence_matches_jax(args):
    assert roofline.gap_check_cadence(*args) == jroofline.gap_check_cadence(
        *args)


@pytest.mark.parametrize("args", [(0.0, 1.0, 10), (1e-6, -1.0, 10),
                                  (1e-6, 1.0, 0)])
def test_gap_check_cadence_rejects_degenerate_costs(args):
    with pytest.raises(ValueError):
        roofline.gap_check_cadence(*args)


@pytest.mark.parametrize("name", list_configs())
def test_model_flops_match_jax(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert roofline.active_param_count(cfg) == \
        jroofline.active_param_count(jcfg)
    for kind in ("train", "decode"):
        assert roofline.model_flops(cfg, kind, 4096) == \
            jroofline.model_flops(jcfg, kind, 4096)


def test_analyze_counts_one_matmul():
    m, k, n = 64, 48, 32
    a = torch.randn(m, k)
    b = torch.randn(k, n)
    r = roofline.analyze(torch.mm, a, b)
    assert r.flops == 2 * m * n * k
    assert r.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert r.collective_bytes == 0.0
    # a float32 product is priced at the float32 peak
    assert r.compute_s == pytest.approx(2 * m * n * k / roofline.F32_FLOPS)
    assert r.memory_s == pytest.approx(r.hbm_bytes / roofline.HBM_BW)
    assert r.bottleneck == "memory"
    half = roofline.analyze(torch.mm, a.bfloat16(), b.bfloat16())
    assert half.compute_s == pytest.approx(
        2 * m * n * k / roofline.PEAK_FLOPS)
