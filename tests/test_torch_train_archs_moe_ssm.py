"""One reduced train step of the port against the JAX package's
(``jax.jit(repro.train.steps.make_train_step)``) for the MoE and recurrent
families: deepseek-v2-lite-16b (MLA, a dense layer then MoE with a
non-zero load-balance aux), xlstm-125m (mLSTM and sLSTM) and
recurrentgemma-2b (RG-LRU and local attention, window 32 at S = 80).
Same weights through ``repro_torch.convert``, same batch; the helpers and
tolerances are in ``tests/_torch_train_archs.py``."""

import numpy as np
import pytest

import _torch_train_archs as common
from _torch_launch_workers import one_thread  # noqa: F401
from repro_torch.train import steps

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_thread")]

ARCHS = ["deepseek-v2-lite-16b", "xlstm-125m", "recurrentgemma-2b"]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = common.run(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_metrics_match_jax(arch, runs):
    common.check_first_step(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_per_leaf(arch, runs):
    common.check_grads(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_step_losses_match_jax(arch, runs):
    common.check_losses(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_master_matches_jax(arch, runs):
    common.check_master(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bit_equal(arch, runs):
    common.check_remat(runs(arch))


def test_moe_aux_is_in_the_loss(runs):
    """deepseek-v2-lite-16b's load-balance aux is non-zero and weighs in
    the loss as JAX's does: loss = ce + AUX_WEIGHT * aux."""
    m = runs("deepseek-v2-lite-16b")["metrics"][0]
    assert m["aux"] > 0
    np.testing.assert_allclose(m["loss"], m["ce"] + steps.AUX_WEIGHT
                               * m["aux"], rtol=1e-6)
