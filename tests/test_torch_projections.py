"""Property tests of the port's projections (``repro_torch.core.
projections``), mirroring those of tests/test_projections.py: the
random cases are drawn from numpy seeds (the JAX package's draws them
with hypothesis), and each is also held to the JAX package's projection
of the same input where the property test compares packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projections as jproj
from repro_torch.core import projections as proj

SEEDS = list(range(8))


def _rand_simplex(rng, n):
    v = rng.exponential(size=n)
    return v / v.sum()


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _bisect_invariants(out, nu, total=1.0, atol=2e-5):
    assert np.all(np.isfinite(out))
    assert out.max() <= nu + atol
    assert out.min() >= -1e-7
    assert abs(out.sum() - total) < 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_projection_idempotent(seed):
    """Rule 2 twice is Rule 2 once (tests/test_projections.py:51)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 61))
    nu = 2.0 / n
    once = proj.capped_simplex_project_sorted(_t(_rand_simplex(rng, n)), nu)
    twice = proj.capped_simplex_project_sorted(once, nu)
    np.testing.assert_allclose(once.numpy(), twice.numpy(), atol=2e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_bisect_idempotent(seed):
    """The sort-free bisection twice is once (tests/test_projections.py:155),
    and once equals the JAX package's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 61))
    nu = 2.0 / n
    eta = _rand_simplex(rng, n).astype(np.float32)
    once = proj.capped_simplex_project_bisect(_t(eta), nu)
    twice = proj.capped_simplex_project_bisect(once, nu)
    np.testing.assert_allclose(once.numpy(), twice.numpy(), atol=2e-5)
    want = np.asarray(jproj.capped_simplex_project_bisect(jnp.asarray(eta),
                                                          nu))
    np.testing.assert_allclose(once.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_projection_preserves_order(seed):
    """The paper's projection is monotone: it clamps the top block and
    scales the rest by a common factor (tests/test_projections.py:62)."""
    rng = np.random.default_rng(seed)
    eta = _rand_simplex(rng, 50)
    nu = 1.5 / 50
    out = proj.capped_simplex_project_sorted(_t(eta), nu).numpy()
    sorted_out = out[np.argsort(eta)]
    assert np.all(np.diff(sorted_out) >= -1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_bisect_all_mass_on_one_point(seed):
    """All mass on one entry, the rest f32 dust: the cap set is that entry
    and the dust block's rescale factor is enormous
    (tests/test_projections.py:213)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 201))
    nu = float(rng.uniform(1.05, 4.0)) / n
    eta = rng.uniform(1e-30, 1e-12, size=n).astype(np.float32)
    eta[rng.integers(n)] = 1.0 - eta.sum() + eta[rng.integers(n)]
    eta = (eta / eta.sum()).astype(np.float32)
    out = proj.capped_simplex_project_bisect(_t(eta), nu).numpy()
    _bisect_invariants(out, nu)
    assert abs(out[np.argmax(eta)] - nu) < 2e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_bisect_everything_at_cap(seed):
    """nu = 1/n: the only feasible point is uniform, and small
    perturbations of it must land there (tests/test_projections.py:231)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 129))
    nu = 1.0 / n
    eta = np.full(n, nu, np.float32)
    eta += rng.uniform(-0.1 * nu, 0.1 * nu, size=n).astype(np.float32)
    eta = (eta / eta.sum()).astype(np.float32)
    out = proj.capped_simplex_project_bisect(_t(eta), nu).numpy()
    _bisect_invariants(out, nu)
    np.testing.assert_allclose(out, nu, atol=2e-5)


def test_bisect_masked_empty_mask():
    """A class whose mask selects nothing comes back all zero (no NaN from
    the 0/0 rescale) and leaves the other class as the single-class
    projection (tests/test_projections.py:246)."""
    rng = np.random.default_rng(11)
    n = 64
    eta = _t(_rand_simplex(rng, n))
    nu = 1.5 / n
    masks = torch.zeros((2, n), dtype=torch.bool)
    masks[0, :] = True
    out2 = proj.capped_bisect_masked(eta, nu, masks,
                                     rounds=proj.BISECT_ROUNDS).numpy()
    _bisect_invariants(out2, nu)
    want = proj.capped_simplex_project_bisect(eta, nu).numpy()
    np.testing.assert_allclose(out2, want, atol=2e-6)
    none = proj.capped_bisect_masked(eta, nu, torch.zeros((1, n),
                                                          dtype=torch.bool),
                                     rounds=proj.BISECT_ROUNDS).numpy()
    assert np.all(np.isfinite(none))
    np.testing.assert_array_equal(none, 0.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_bisect_f32_mass_concentration(seed):
    """(1 - delta) of the mass on one entry, delta over the rest, across
    the f32 range where the sorted rule's prefix sums cancel: the
    invariants, and the loop oracle (Rule 3) as ground truth
    (tests/test_projections.py:275)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(16, 129))
    delta = float(10.0 ** rng.uniform(-7, -1))
    eta = rng.exponential(size=n).astype(np.float32)
    eta = eta / eta.sum() * delta
    j = rng.integers(n)
    eta[j] = 1.0 - (eta.sum() - eta[j])
    eta = eta.astype(np.float32)
    nu = 2.0 / n
    out = proj.capped_simplex_project_bisect(_t(eta), nu).numpy()
    _bisect_invariants(out, nu)
    want = proj.capped_simplex_project_loop(_t(eta), nu).numpy()
    np.testing.assert_allclose(out, want, atol=2e-5)
    jwant = np.asarray(jproj.capped_simplex_project_loop(jnp.asarray(eta),
                                                         nu))
    np.testing.assert_allclose(out, jwant, atol=2e-5)


def test_entropy_prox_is_argmin():
    """Lemma 10: the closed form solves the prox problem, against a dense
    numeric minimisation over the simplex (tests/test_projections.py:297)."""
    import scipy.optimize as so
    rng = np.random.default_rng(0)
    n, d, gamma, tau = 12, 16.0, 0.05, 3.0
    lam = _rand_simplex(rng, n)
    v = rng.normal(size=n)

    closed = torch.exp(proj.entropy_prox(_t(np.log(lam)), _t(v), gamma, tau,
                                         d)).numpy()

    def objective(u):
        u = np.maximum(u, 1e-12)
        h = np.sum(u * np.log(u))
        bregman = np.sum(u * np.log(u / lam)) - (u.sum() - lam.sum())
        return np.dot(v, u) / d + gamma / d * h + bregman / tau

    cons = [{"type": "eq", "fun": lambda u: u.sum() - 1}]
    r = so.minimize(objective, lam, bounds=[(1e-9, 1)] * n,
                    constraints=cons, options={"maxiter": 300})
    np.testing.assert_allclose(closed, r.x, atol=1e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_entropy_prox_normalized(seed):
    """The step returns normalised log weights
    (tests/test_projections.py:325), as the JAX package's does."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 201))
    lam = _rand_simplex(rng, n)
    v = rng.normal(size=n) * 3
    out = proj.entropy_prox(_t(np.log(lam)), _t(v), 0.01, 10.0, 64.0)
    assert abs(torch.exp(out).sum().item() - 1.0) < 1e-4
    want = np.asarray(jproj.entropy_prox(
        jnp.asarray(np.log(lam), jnp.float32), jnp.asarray(v, jnp.float32),
        0.01, 10.0, 64.0))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
