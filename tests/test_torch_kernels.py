"""The port's kernel entry points on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels (interpret mode) and its jnp
oracles, at the tolerances of tests/test_kernels.py; plus the wrappers'
input checks.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

NEG = -1e30


@pytest.mark.parametrize("n,d", [(1, 8), (5, 64), (33, 256), (100, 32)])
def test_fwht_matches_jax(n, d):
    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = ops.fwht(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.fwht(jnp.asarray(x))),
                               atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref.fwht_ref(jnp.asarray(x))),
                               atol=1e-4)


def test_fwht_vector_and_unnormalized():
    rng = np.random.default_rng(9)
    x = rng.normal(size=128).astype(np.float32)
    got = ops.fwht(torch.from_numpy(x))
    assert got.shape == (128,)
    want = np.asarray(jref.fwht_ref(jnp.asarray(x)[None]))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    raw = ops.fwht(torch.from_numpy(x), normalize=False).numpy()
    np.testing.assert_allclose(raw / np.sqrt(128), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("d", [0, 3, 12, 100])
def test_fwht_non_pow2_d_fails_fast(d):
    with pytest.raises(ValueError, match="power of two"):
        ops.fwht(torch.zeros((4, d)))


def test_fwht_rejects_non_f32():
    with pytest.raises(TypeError, match="float32"):
        ops.fwht(torch.zeros((4, 8), dtype=torch.float64))


@pytest.mark.parametrize("log_d", range(21))
def test_fwht_plan(log_d):
    """One pass up to d = 32,768 (a thread, a warp or a block a row), two
    above (the row kernel over rows of d2 = 32,768, then one strided pass
    over the d1 = d / d2 values at stride d2); d1 * d2 = d."""
    from repro_torch.kernels import fwht
    d = 1 << log_d
    plan = fwht.fwht_plan(d)
    assert plan.d1 * plan.d2 == d and plan.d2 <= fwht.MAX_ROW
    want = ("thread" if d <= 16 else "warp" if d <= 1024 else "block")
    assert plan.variant == want
    assert plan.rows_per_block == {"thread": fwht.THREAD_ROWS,
                                   "warp": fwht.WARP_ROWS, "block": 1}[want]
    assert sum(plan.strided) == log_d - plan.d2.bit_length() + 1
    assert all(1 <= m <= fwht.STRIDED_LOG for m in plan.strided)
    if d <= fwht.MAX_ROW:
        assert plan.d1 == 1 and plan.device_launches == 1
    else:
        assert plan.d2 == fwht.MAX_ROW and plan.device_launches == 2


@pytest.mark.parametrize("n,d", [(2, 65_536), (3, 131_072), (4, 65_536)])
def test_fwht_two_pass_factorisation_is_bit_exact(n, d):
    """The card's two passes written plainly: the stages h < d2 on every
    chunk of d2, then the stages h >= d2 over the d1 values at stride d2,
    then one division by sqrt(d).  Bit for bit the plain version, and
    within 1e-4 of JAX's preprocess.fwht."""
    from repro.core import preprocess as jpp
    from repro_torch.kernels.fwht import fwht_plan
    plan = fwht_plan(d)
    assert plan.d1 > 1
    x = torch.from_numpy(np.random.default_rng(n * d).normal(
        size=(n, d)).astype(np.float32))
    low = ref.fwht_ref(x.reshape(n * plan.d1, plan.d2), normalize=False)
    cols = low.reshape(n, plan.d1, plan.d2).transpose(1, 2).contiguous()
    high = ref.fwht_ref(cols, normalize=False).transpose(1, 2)
    got = high.reshape(n, d) / torch.tensor(np.sqrt(d), dtype=torch.float32)
    assert torch.equal(got, ref.fwht_ref(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpp.fwht(jnp.asarray(x.numpy()))),
                               atol=1e-4)


def test_fwht_refuses_a_grid_beyond_32_bits():
    """Element offsets are 64-bit; the row kernels' 1-D grid is not."""
    from repro_torch.kernels import fwht
    for d in (8, 512, 4096, 131_072):
        plan = fwht.fwht_plan(d)
        most = fwht.MAX_GRID * plan.rows_per_block // plan.d1
        fwht.check_grid(most, plan)
        with pytest.raises(ValueError, match="blocks"):
            fwht.check_grid(most + plan.rows_per_block, plan)


def _packed_problem(rng, n_pad, n1, n2, d, b):
    """Packed operand with lane padding and per-class log weights (numpy),
    as tests/test_kernels.py builds it."""
    x = rng.normal(size=(n_pad, d)).astype(np.float32)
    x[n1 + n2:] = 0.0
    sign = np.zeros(n_pad, np.float32)
    sign[:n1] = 1.0
    sign[n1:n1 + n2] = -1.0
    log_lam = np.full(n_pad, NEG, np.float32)
    log_lam[:n1] = -np.log(n1) + 0.1 * rng.normal(size=n1)
    log_lam[n1:n1 + n2] = -np.log(n2) + 0.1 * rng.normal(size=n2)
    idx = rng.choice(d, b, replace=False).astype(np.int32)
    return np.ascontiguousarray(x.T), sign, log_lam, idx


def _t(a):
    """numpy -> torch with a leading slot axis of 1."""
    return torch.from_numpy(np.asarray(a))[None].contiguous()


# (n_pad, n1, n2, d, b): one tile; a single-class first tile and a mixed
# one; an all-padding last tile (n1 + n2 <= n_pad - 128)
PACKED_CASES = [(128, 40, 50, 16, 1), (512, 200, 250, 32, 8),
                (512, 150, 200, 32, 32)]


@pytest.mark.parametrize("n_pad,n1,n2,d,b", PACKED_CASES)
def test_momentum_dot_packed_matches_jax(n_pad, n1, n2, d, b):
    rng = np.random.default_rng(n_pad + b)
    x_t, sign, ll, idx = _packed_problem(rng, n_pad, n1, n2, d, b)
    lp = (ll + 0.05 * rng.normal(size=n_pad).astype(np.float32)
          * (sign != 0)).astype(np.float32)
    theta = np.float32(0.95)
    got = ops.momentum_dot_packed(_t(x_t), _t(idx), _t(ll), _t(lp), _t(sign),
                                  torch.tensor([theta]))[0].numpy()
    args = [jnp.asarray(a) for a in (x_t, idx, ll, lp, sign)]
    np.testing.assert_allclose(
        got, np.asarray(jops.momentum_dot_packed(*args, theta)), atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref.momentum_dot_packed_ref(*args, theta)),
        atol=1e-4)


@pytest.mark.parametrize("n_pad,n1,n2,d,b", PACKED_CASES)
def test_mwu_update_packed_matches_jax(n_pad, n1, n2, d, b):
    rng = np.random.default_rng(n_pad * 3 + b)
    x_t, sign, ll, idx = _packed_problem(rng, n_pad, n1, n2, d, b)
    u = (rng.normal(size=n_pad) * 0.1).astype(np.float32)
    dw = (rng.normal(size=b) * 0.01).astype(np.float32)
    gamma, tau, d_eff = 1e-3, 40.0, float(d)
    mwu_c = np.float32(1.0 / (gamma + d_eff / tau))
    mwu_dot = np.float32(d_eff / tau)
    got = ops.mwu_update_packed(
        _t(x_t), _t(idx), _t(ll), _t(u), _t(dw), _t(sign),
        torch.tensor([mwu_c]), torch.tensor([mwu_dot]), d_eff)
    assert got[2].shape == got[3].shape == (1, 2)
    _assert_mwu_packed_like_jax([g[0].numpy() for g in got], x_t, idx, ll,
                                u, dw, sign, gamma, tau, d_eff, n1 + n2)


def _assert_mwu_packed_like_jax(got, x_t, idx, ll, u, dw, sign, gamma, tau,
                                d_eff, n):
    """One slot of the port's packed MWU, (log_new, u_new, m (2,), s (2,)),
    against the JAX package's Pallas kernel (interpret mode) and its jnp
    oracle, which return (log_new, u_new, m_p, s_p, m_m, s_m); n real
    points."""
    args = [jnp.asarray(a) for a in (x_t, idx, ll, u, dw, sign)]
    lse = got[2] + np.log(got[3])
    for want in (jops.mwu_update_packed(*args, gamma=gamma, tau=tau,
                                        d_eff=d_eff),
                 jref.mwu_update_packed_ref(*args, gamma, tau, d_eff)):
        want = [np.asarray(w) for w in want]
        np.testing.assert_allclose(got[0][:n], want[0][:n], atol=1e-4)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)
        assert (got[0][n:] < -1e20).all()
        np.testing.assert_allclose(
            lse, [float(want[2]) + np.log(float(want[3])),
                  float(want[4]) + np.log(float(want[5]))], atol=1e-4)


def test_mwu_update_packed_slots_match_jax():
    """S = 3 slots of different layouts in one call, each held against
    the JAX kernel on its own: slot 0 ends in an all-padding tile, slot 1
    has single-class tiles only (class + fills tiles 0-1, class - tiles
    2-3), slot 2 has a class of one point.  The (m, s) equal the plain
    merge, in tile order, of the per-tile partials of log_new."""
    rng = np.random.default_rng(21)
    n_pad, d, b = 512, 32, 8
    layouts = [(150, 200), (256, 256), (1, 300)]
    probs = [_packed_problem(rng, n_pad, n1, n2, d, b) for n1, n2 in layouts]
    x_t, sign, ll, idx = (torch.from_numpy(np.stack([p[i] for p in probs]))
                          for i in range(4))
    u = (rng.normal(size=(3, n_pad)) * 0.1).astype(np.float32)
    dw = (rng.normal(size=(3, b)) * 0.01).astype(np.float32)
    gamma, tau, d_eff = 1e-3, 40.0, float(d)
    got = ops.mwu_update_packed(
        x_t, idx, ll, torch.from_numpy(u), torch.from_numpy(dw), sign,
        torch.full((3,), 1.0 / (gamma + d_eff / tau)),
        torch.full((3,), d_eff / tau), d_eff)
    assert got[2].shape == got[3].shape == (3, 2)
    m, s = ref.merge_class_partials(ref.class_partials(got[0], sign))
    np.testing.assert_allclose((m + torch.log(s)).numpy(),
                               (got[2] + torch.log(got[3])).numpy(),
                               atol=1e-5)
    for k, (n1, n2) in enumerate(layouts):
        _assert_mwu_packed_like_jax(
            [g[k].numpy() for g in got], x_t[k].numpy(), idx[k].numpy(),
            ll[k].numpy(), u[k], dw[k], sign[k].numpy(), gamma, tau, d_eff,
            n1 + n2)


def test_class_partials_combine_like_jax():
    """The kernels' fixed-order merge of per-tile (m, s) partials, as its
    plain version ``ref.merge_class_partials``: padding-only and
    single-class tiles give (NEG, 0) and must not disturb the merged
    logsumexp; ``ref.class_partials`` gives the same partials."""
    rng = np.random.default_rng(3)
    log_new = rng.normal(size=512).astype(np.float32)
    sign = np.zeros(512, np.float32)
    sign[:200], sign[200:350] = 1.0, -1.0
    parts = []
    for tile in range(4):
        ln, sg = log_new[tile * 128:(tile + 1) * 128], sign[tile * 128:]
        sg = sg[:128]
        row = []
        for cls in (1.0, -1.0):
            m = ln[sg == cls].max() if (sg == cls).any() else NEG
            s = np.exp(ln[sg == cls] - m).sum() if (sg == cls).any() else 0.0
            row += [m, s]
        parts.append(row)
    parts = torch.tensor([parts], dtype=torch.float32)
    np.testing.assert_allclose(
        ref.class_partials(torch.from_numpy(log_new)[None],
                           torch.from_numpy(sign)[None]).numpy(),
        parts.numpy(), rtol=1e-6)
    m, s = ref.merge_class_partials(parts)
    assert m.shape == s.shape == (1, 2)
    for c, cls in enumerate((1.0, -1.0)):
        want = np.log(np.exp(log_new[sign == cls].astype(np.float64)).sum())
        np.testing.assert_allclose(float(m[0, c] + torch.log(s[0, c])),
                                   want, atol=1e-5)


def _good_packed(n_pad=256, d=16, b=4):
    x_t = torch.zeros((1, d, n_pad))
    idx = torch.arange(b, dtype=torch.int32)[None]
    vec = torch.zeros((1, n_pad))
    return x_t, idx, vec


@pytest.mark.parametrize("bad", ["lane", "idx_dtype", "vec_dtype", "shape",
                                 "contiguous", "b_gt_d", "idx_negative",
                                 "idx_ge_d"])
def test_packed_wrappers_reject_bad_inputs(bad):
    x_t, idx, vec = _good_packed()
    theta = torch.ones(1)
    log_lam, log_prev, sign = vec, vec.clone(), vec.clone()
    err = ValueError
    if bad == "lane":
        x_t, log_lam = torch.zeros((1, 16, 200)), torch.zeros((1, 200))
        log_prev, sign = log_lam.clone(), log_lam.clone()
    elif bad == "idx_dtype":
        idx, err = idx.long(), TypeError
    elif bad == "vec_dtype":
        log_lam, err = log_lam.double(), TypeError
    elif bad == "shape":
        sign = torch.zeros((1, 128))
    elif bad == "contiguous":
        x_t = torch.zeros((1, 256, 16)).transpose(1, 2)
    elif bad == "b_gt_d":
        idx = torch.arange(17, dtype=torch.int32)[None]
    elif bad == "idx_negative":
        idx, err = idx - 1, IndexError
    elif bad == "idx_ge_d":
        idx, err = idx + 13, IndexError
    with pytest.raises(err):
        ops.momentum_dot_packed(x_t, idx, log_lam, log_prev, sign, theta)
    with pytest.raises(err):
        b = idx.shape[1]
        ops.mwu_update_packed(x_t, idx, log_lam, log_prev, torch.zeros((1, b)),
                              sign, theta, theta, 4.0)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 7, 8, 128, 512])
def test_packed_block_geometry(b):
    """A packed block's 8 warps cover T tiles in 8 / T row groups: never
    more row groups than rows, and all 8 warps on one tile from b = 8."""
    from repro_torch.kernels.saddle_update import packed_tiles_per_block
    tiles = packed_tiles_per_block(b)
    assert tiles in (1, 2, 4, 8)
    assert 8 // tiles <= b
    assert (tiles == 1) == (b >= 8)


@pytest.mark.parametrize("b", [1, 32_768, 32_769, 40_000, 65_536])
def test_packed_chunk_geometry(b):
    """A packed block holds the ring and one chunk of the sampled rows'
    indices or dw in at most 232,448 bytes of shared memory, by the CUDA
    source's formula (mirrored as packed_smem): all b rows up to
    CHUNK_ROWS, CHUNK_ROWS at a time above, a chunk ending where a stage
    of the ring ends."""
    from repro_torch.kernels import saddle_update as su
    tpb = su.packed_tiles_per_block(b)
    rows = su.STAGE_FLOATS // (tpb * su.LANE)
    nbuf = su.packed_ring_stages(b, tpb)
    assert 1 <= nbuf <= su.MAX_STAGES and nbuf == min(-(-b // rows), 4)
    assert su.CHUNK_ROWS % rows == 0
    chunk = min(b, su.CHUNK_ROWS)
    assert su.packed_smem(b) == nbuf * 16_384 + -(-chunk * 4 // 16) * 16
    assert su.packed_smem(b) <= su.MAX_SMEM
    assert -(-b // chunk) == (1 if b <= 32_768 else 2)


def test_check_packed_takes_b_above_32768():
    """No cap on the sampled rows below d: the wrapper's check takes
    b = 40,000 of d = 65,536 (the CUDA kernels walk the rows in chunks)."""
    from repro_torch.kernels import saddle_update as su
    assert not hasattr(su, "MAX_PACKED_ROWS")
    s, d, n_pad, b = 1, 65_536, 128, 40_000
    x_t = torch.zeros((s, d, n_pad))
    idx = torch.arange(b, dtype=torch.int32)[None]
    vec = torch.zeros((s, n_pad))
    assert su.check_packed(x_t, idx, dict(sign=vec), dict(
        theta=torch.ones(s)), rows=dict(dw=torch.zeros((s, b)))) == (
            s, d, n_pad, b)


def test_packed_plain_versions_above_32768_rows_match_jax():
    """Both packed plain versions at b = 40,000 sampled rows of d = 65,536
    (S = 2, n_pad = 128), each slot against the JAX package's jnp oracle
    on the same inputs: the reference the card holds the chunked kernels
    to.  The points are scaled into the unit ball, as Algorithm 1 leaves
    them (coordinates ~ 1 / sqrt(d)): with unit Gaussian coordinates the
    40,000-term sums of the two float32 versions differ by 1e-3 in an
    order of summation neither package fixes."""
    rng = np.random.default_rng(40_000)
    s, d, n_pad, b, n1, n2 = 2, 65_536, 128, 40_000, 40, 50
    probs = [_packed_problem(rng, n_pad, n1, n2, d, b) for _ in range(s)]
    x_t, sign, ll, idx = (np.stack([p[i] for p in probs]) for i in range(4))
    x_t *= np.float32(1.0 / np.sqrt(d))
    lp = (ll + 0.05 * rng.normal(size=(s, n_pad)) * (sign != 0)).astype(
        np.float32)
    u = (0.1 * rng.normal(size=(s, n_pad))).astype(np.float32)
    dw = (0.01 * rng.normal(size=(s, b))).astype(np.float32)
    theta = np.float32(0.95)
    gamma, tau, d_eff = 1e-3, 40.0, float(d) / b
    t = [torch.from_numpy(a) for a in (x_t, idx, ll, lp, sign, u, dw)]
    delta = ops.momentum_dot_packed(t[0], t[1], t[2], t[3], t[4],
                                    torch.full((s,), theta))
    got = ops.mwu_update_packed(
        t[0], t[1], t[2], t[5], t[6], t[4],
        torch.full((s,), 1.0 / (gamma + d_eff / tau)),
        torch.full((s,), d_eff / tau), d_eff)
    for k in range(s):
        args = [jnp.asarray(a[k]) for a in (x_t, idx, ll)]
        want = jref.momentum_dot_packed_ref(*args, jnp.asarray(lp[k]),
                                            jnp.asarray(sign[k]), theta)
        np.testing.assert_allclose(delta[k].numpy(), np.asarray(want),
                                   atol=1e-4)
        want = [np.asarray(w) for w in jref.mwu_update_packed_ref(
            *args, jnp.asarray(u[k]), jnp.asarray(dw[k]),
            jnp.asarray(sign[k]), gamma, tau, d_eff)]
        n = n1 + n2
        np.testing.assert_allclose(got[0][k, :n].numpy(), want[0][:n],
                                   atol=1e-4)
        np.testing.assert_allclose(got[1][k].numpy(), want[1], atol=1e-5)
        lse = (got[2][k] + torch.log(got[3][k])).numpy()
        np.testing.assert_allclose(
            lse, [float(want[2]) + np.log(float(want[3])),
                  float(want[4]) + np.log(float(want[5]))], atol=1e-4)


# PERF.md section 6's packed shapes (S, d, n_pad, b) below b = 32,768
PERF_PACKED_SHAPES = ((1, 512, 50_048, 1), (1, 256, 20_096, 128),
                      (20, 256, 512, 1), (20, 512, 384, 1),
                      (20, 256, 512, 128), (1, 256, 10_112, 1),
                      (1, 65_536, 1_536, 1), (8, 256, 4_096, 1),
                      (8, 256, 8_192, 1), (8, 512, 8_192, 1),
                      (1, 128, 18_048, 1), (1, 128, 256, 1),
                      (1, 256, 18_048, 1), (1, 512, 10_112, 1),
                      (2, 256, 16_384, 1), (2, 512, 32_768, 1),
                      (4, 256, 32_768, 1), (1, 256, 4_096, 128),
                      (1, 256, 2_048, 128), (2, 64, 4_096, 1),
                      (2, 256, 65_536, 128), (1, 64, 1_664, 1),
                      (1, 64, 2_432, 1), (20, 128, 256, 1),
                      (2, 256, 32_768, 128), (1, 256, 4_096, 1),
                      (1, 256, 2_048, 1))
WIDE_RUNGS = (32_768, 32_769, 40_000, 65_536)   # b over n_pad = 1,536


@pytest.mark.parametrize("n_pad", [128 * 2 ** k for k in range(10)]
                         + [384, 1_536, 10_112, 50_048])
def test_packed_row_splits_are_one_up_to_128_rows(n_pad):
    """No row split at b <= 128 (those shapes keep their bits), nor where
    the point blocks alone fill the card."""
    from repro_torch.kernels import saddle_update as su
    for b in range(1, 129):
        assert su.packed_row_splits(n_pad, b) == 1
    if n_pad // su.LANE >= 2 * su.SMS:
        assert su.packed_row_splits(n_pad, 65_536) == 1


def test_packed_row_splits_only_at_the_wide_rungs():
    """R = 1 at every packed shape PERF.md section 6 lists but the four
    wide rungs, which split into about two blocks an SM."""
    from repro_torch.kernels import saddle_update as su
    for s, d, n_pad, b in PERF_PACKED_SHAPES:
        assert su.packed_row_splits(n_pad, b) == 1, (s, d, n_pad, b)
    for b in WIDE_RUNGS:
        splits = su.packed_row_splits(1_536, b)
        assert 1 < splits <= su.MAX_SPLITS
        assert 12 * splits <= 2 * su.SMS < 12 * (splits + 1)
    assert su.packed_row_splits(1_536, 40_000) == 22
    assert su.packed_split_rows(40_000, 22) == 1_824


@pytest.mark.parametrize("n_pad,b", [(1_536, b) for b in WIDE_RUNGS]
                         + [(128, 40_000), (128, 65_537), (1_536, 2_048),
                            (1_536, 3_000), (50_048, 40_000)])
def test_packed_row_splits_do_not_depend_on_slots(n_pad, b):
    """A slot's launch geometry is the same alone as in a batch of S:
    grid (point blocks, S, R) with the same R for every S."""
    from repro_torch.kernels import saddle_update as su
    for kernel in ("momentum_dot_packed", "mwu_update_packed"):
        grids = {s: su.packed_launch(kernel, s, n_pad, b).grid
                 for s in (1, 2, 3, 8, 20)}
        assert {(g[0], g[2]) for g in grids.values()} == {
            (grids[1][0], su.packed_row_splits(n_pad, b))}
        assert all(g[1] == s for s, g in grids.items())
        assert {su.packed_launch(kernel, s, n_pad, b).args
                for s in grids} == {su.packed_launch(kernel, 1, n_pad,
                                                     b).args}


@pytest.mark.parametrize("n_pad,b", [(1_536, b) for b in WIDE_RUNGS]
                         + [(128, b) for b in (2_048, 40_000, 65_537)]
                         + [(384, 5_000), (1_536, 2_047), (1_536, 2_080)])
def test_packed_row_splits_partition_the_rows(n_pad, b):
    """The R splits cut [0, b) into contiguous ranges in order, each
    starting on a stage of the ring (32 rows at T = 1), none empty, each
    of at least SPLIT_ROWS rows but the last, and the C launcher's rule
    (R - 1) span < b holds."""
    from repro_torch.kernels import saddle_update as su
    splits = su.packed_row_splits(n_pad, b)
    span = su.packed_split_rows(b, splits)
    stage = su.STAGE_FLOATS // (su.packed_tiles_per_block(b) * su.LANE)
    bounds = [min(b, r * span) for r in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == b
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    assert all(lo % stage == 0 for lo in bounds[:-1])
    assert (splits - 1) * span < b <= splits * span
    assert splits == 1 or span >= su.SPLIT_ROWS
    assert su.packed_split_rows(b, splits) == span     # a fixed point


@pytest.mark.parametrize("b", WIDE_RUNGS)
def test_packed_split_shared_memory_fits(b):
    """A block of a row split holds the ring and its split's indices or
    dw: at most MAX_SMEM beside the kernels' static shared memory, and
    less than R = 1 would take (one chunk of up to 32,768 rows)."""
    from repro_torch.analysis.kernel_audit import STATIC_SMEM
    from repro_torch.kernels import saddle_update as su
    for kernel in ("momentum_dot_packed", "mwu_update_packed"):
        ln = su.packed_launch(kernel, 1, 1_536, b)
        span = su.packed_split_rows(b, ln.args[1])
        assert ln.dynamic_smem == su.packed_smem(span)
        assert ln.dynamic_smem + STATIC_SMEM[kernel] <= su.MAX_SMEM
        assert ln.dynamic_smem < su.packed_smem(b)


def test_split_partials_merge_in_split_order():
    """``ref.split_partials`` sums each split's rows; with one split the
    merge is the plain dv bit for bit, and with several it adds the
    splits' dv in split order, within float32 rounding of the plain dv."""
    rng = np.random.default_rng(17)
    s, d, n_pad, b = 2, 4_096, 256, 3_000
    x_t = torch.from_numpy(rng.normal(size=(s, d, n_pad)).astype(
        np.float32) / 64)
    idx = torch.from_numpy(np.stack([rng.choice(d, b, replace=False)
                                     for _ in range(s)]).astype(np.int32))
    dw = torch.from_numpy(rng.normal(size=(s, b)).astype(np.float32) / 100)
    full = torch.bmm(dw[:, None, :], ref._gather_rows(x_t, idx))[:, 0]
    one = ref.split_partials(x_t, idx, dw, b)
    assert one.shape == (s, 1, n_pad)
    assert torch.equal(ref.merge_split_partials(one), full)
    parts = ref.split_partials(x_t, idx, dw, 1_024)
    assert parts.shape == (s, 3, n_pad)
    assert torch.equal(ref.merge_split_partials(parts),
                       (parts[:, 0] + parts[:, 1]) + parts[:, 2])
    np.testing.assert_allclose(ref.merge_split_partials(parts).numpy(),
                               full.numpy(), atol=1e-6)


def test_packed_split_order_plain_version_matches_jax():
    """The packed MWU's plain version in the kernel's split order
    (``ref.mwu_update_packed_ref(span=)``, the row splits of b = 40,000
    over n_pad = 128: 38 of 1,056 rows) on S = 2 slots of d = 65,536,
    each slot against the JAX package's jnp oracle: log_new and each
    class's lse within 1e-4, u within 1e-5.  The points are scaled into
    the unit ball, as Algorithm 1 leaves them."""
    from repro_torch.kernels import saddle_update as su
    rng = np.random.default_rng(40_001)
    s, d, n_pad, b, n1, n2 = 2, 65_536, 128, 40_000, 40, 50
    probs = [_packed_problem(rng, n_pad, n1, n2, d, b) for _ in range(s)]
    x_t, sign, ll, idx = (np.stack([p[i] for p in probs]) for i in range(4))
    x_t *= np.float32(1.0 / np.sqrt(d))
    u = (0.1 * rng.normal(size=(s, n_pad))).astype(np.float32)
    dw = (0.01 * rng.normal(size=(s, b))).astype(np.float32)
    gamma, tau, d_eff = 1e-3, 40.0, float(d) / b
    span = su.packed_split_rows(b, su.packed_row_splits(n_pad, b))
    assert span == 1_056
    t = [torch.from_numpy(a) for a in (x_t, idx, ll, u, dw, sign)]
    got = ref.mwu_update_packed_ref(
        *t, torch.full((s,), 1.0 / (gamma + d_eff / tau)),
        torch.full((s,), d_eff / tau), d_eff, span=span)
    for k in range(s):
        want = [np.asarray(w) for w in jref.mwu_update_packed_ref(
            *(jnp.asarray(a[k]) for a in (x_t, idx, ll, u, dw, sign)),
            gamma, tau, d_eff)]
        n = n1 + n2
        np.testing.assert_allclose(got[0][k, :n].numpy(), want[0][:n],
                                   atol=1e-4)
        np.testing.assert_allclose(got[1][k].numpy(), want[1], atol=1e-5)
        lse = (got[2][k] + torch.log(got[3][k])).numpy()
        np.testing.assert_allclose(
            lse, [float(want[2]) + np.log(float(want[3])),
                  float(want[4]) + np.log(float(want[5]))], atol=1e-4)


def test_packed_workspace_grows_and_keeps_counters_zero():
    """The packed kernels' per-device workspace: zeroed counters, grown
    (never shrunk) when a call needs more slots or scratch."""
    from repro_torch.kernels import saddle_update as su
    dev = torch.device("cpu")
    su._workspace.pop(dev.index, None)
    try:
        counters, scratch = su.workspace(dev, 3, 10)
        assert counters.dtype == torch.int32 and not counters.any()
        assert counters.numel() == 3 and scratch.numel() == 10
        assert su.workspace(dev, 2, 8)[0] is counters      # big enough
        counters, scratch = su.workspace(dev, 2, 20)
        assert counters.numel() == 3 and scratch.numel() == 20
        counters, scratch = su.workspace(dev, 5, 4)
        assert counters.numel() == 5 and scratch.numel() == 20
        assert not counters.any()
    finally:
        su._workspace.pop(dev.index, None)


def test_cpu_calls_are_not_counted_as_launches():
    """launch_counts counts CUDA kernel launches only: a call served by a
    plain version on the CPU leaves it unchanged."""
    before = dict(ops.launch_counts)
    x_t, idx, vec = _good_packed()
    ops.momentum_dot_packed(x_t, idx, vec, vec, vec, torch.ones(1))
    ops.fwht(torch.zeros((2, 8)))
    assert dict(ops.launch_counts) == before


def test_ref_fwht_is_orthonormal():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 64)).astype(np.float32))
    np.testing.assert_allclose(ref.fwht_ref(ref.fwht_ref(x)).numpy(),
                               x.numpy(), atol=1e-5)


# ------------------------------------------------ unpacked per-class kernels
@pytest.mark.parametrize("n,b", [(17, 1), (256, 1), (1000, 4), (513, 128),
                                 (100, 3), (300, 130)])
def test_momentum_dot_matches_jax(n, b):
    """ops.momentum_dot on CPU tensors (the plain version) against the
    JAX package's Pallas kernel in interpret mode and its jnp oracle."""
    rng = np.random.default_rng(n + b)
    cols = rng.normal(size=(n, b)).astype(np.float32)
    ll = (rng.normal(size=n) - 3).astype(np.float32)
    lp = (rng.normal(size=n) - 3).astype(np.float32)
    got = ops.momentum_dot(torch.from_numpy(cols), torch.from_numpy(ll),
                           torch.from_numpy(lp), 0.95)
    assert got.shape == (b,)
    want = jops.momentum_dot(jnp.asarray(cols), jnp.asarray(ll),
                             jnp.asarray(lp), 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    oracle = jref.momentum_dot_ref(jnp.asarray(cols), jnp.exp(ll),
                                   jnp.exp(lp), 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-4)


# (k, n, b): the reference step's shapes (k = 20 clients of 250 / 251
# points, serial 4,999 / 5,001 points; B = 1 and 128), the JAX kernel
# tests' shapes with 20 clients, ragged B and a client of 100,000 points
DOT_SHAPES = [(20, 250, 1), (20, 251, 128), (1, 4_999, 1), (1, 5_001, 1),
              (20, 17, 1), (20, 513, 128), (20, 1_025, 8), (20, 2_048, 128),
              (20, 100, 3), (20, 300, 130), (1, 100_000, 128), (1, 5, 1000)]


@pytest.mark.parametrize("k,n,b", DOT_SHAPES)
def test_momentum_dot_geometry(k, n, b):
    """The unpacked dot's blocks cover every (point, column) once: chunks
    of 4 * lanes columns, point blocks of at most DOT_POINTS points (their
    momentum in shared memory) when B > 1, at most DOT_WAVE blocks unless
    a block would take more than DOT_POINTS; and the reference step's
    clients of 250 points take one block each, so no merge."""
    from repro_torch.kernels import saddle_update as su
    lanes, points, blocks, chunks = su.momentum_dot_geometry(k, n, b)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert (lanes == 1) == (b <= 4)
    assert chunks == -(-b // (4 * lanes)) and 4 * lanes <= su.DOT_COLS
    assert points * blocks >= n > points * (blocks - 1)
    assert b == 1 or points <= su.DOT_POINTS
    if k * chunks * blocks > max(su.DOT_WAVE, k * chunks):
        assert blocks == -(-n // su.DOT_POINTS)    # forced by the cap
    if k == 20 and n in (250, 251) and b in (1, 128):
        assert blocks == 1


@pytest.mark.parametrize("k,n,b", DOT_SHAPES)
def test_mwu_update_geometry(k, n, b):
    """The unpacked MWU's point blocks cover every point exactly once
    (each block non-empty), a block's dv, log_lam and u (3 floats a point)
    fit its shared memory, the reference step's clients take the blocks
    the design chose (one block of 250 points at B = 1, four of 63 at
    B = 128), and the serial B = 1 call of ~5,000 points is spread over
    more than the 5 blocks of the tiled kernel it replaced."""
    from repro_torch.kernels import saddle_update as su
    lanes, points, blocks = su.mwu_update_geometry(k, n, b)
    assert lanes == min(32, 1 << (-(-b // 4) - 1).bit_length())
    assert points * blocks >= n > points * (blocks - 1)
    assert 1 <= points <= su.MWU_POINTS
    assert 3 * 4 * su.MWU_POINTS <= 48 * 1024
    rnd = su.THREADS // lanes * su.DOT_UNROLL       # rows one round loads
    one_round = -(-n // min(rnd, su.MWU_POINTS))     # blocks of one round
    if blocks == 1:
        assert n <= 2 * rnd
    elif k * one_round <= su.DOT_WAVE:
        assert points <= rnd
    else:                            # fewer, longer blocks: about one wave
        assert (k * blocks < su.DOT_WAVE + k
                or points > su.MWU_POINTS // 2)
    if k == 20 and n in (250, 251) and b in (1, 128):
        assert (blocks, points) == ((1, n) if b == 1 else (4, 63))
    if k == 1 and n in (4_999, 5_001) and b == 1:
        assert blocks > 5


# (k, n, b, pad): the JAX kernel tests' shapes, the reference step's
# clients (K = 20 of 250 / 251 points) and a client whose last point is
# round-robin padding
MERGE_SHAPES = [(1, 17, 1, False), (1, 512, 1, False), (1, 1025, 8, False),
                (1, 2048, 128, False), (20, 250, 1, False),
                (20, 251, 128, False), (20, 251, 128, True),
                (3, 5_001, 1, True)]


@pytest.mark.parametrize("k,n,b,pad", MERGE_SHAPES)
def test_mwu_block_merge_matches_jax(k, n, b, pad):
    """The plain form of the CUDA kernel's in-launch merge: the plain
    log_new cut by the geometry's point blocks into per-block (max,
    sum-exp) partials (``ref.block_partials``), merged in block order by
    ``ref.merge_block_partials``, gives the plain version's m bit for bit
    and, per client, JAX's ``mwu_update(normalize=False)`` m and
    lse = m + log s within 1e-5.  (The two packages' log_new differ by a
    few float32 ulps, up to 4e-6 here: XLA and PyTorch round the dual
    update's products differently, so m is not bit-equal across them.)"""
    import jax

    from repro_torch.kernels import saddle_update as su
    rng = np.random.default_rng(k * n + b)
    cols = rng.normal(size=(k, n, b)).astype(np.float32)
    ll = (rng.normal(size=(k, n)) * 0.5 - np.log(n)).astype(np.float32)
    u = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    dw = (rng.normal(size=(k, b)) * 0.01).astype(np.float32)
    if pad:
        cols[-1, -1], ll[-1, -1], u[-1, -1] = 0.0, NEG, 0.0
    scal = dict(sign=1.0, gamma=1e-3, tau=40.0, d_eff=128.0)
    ln, _, m, s = ref.mwu_update_ref(
        *(torch.from_numpy(a) for a in (cols, ll, u, dw)), *scal.values(),
        normalize=False)
    _, points, blocks = su.mwu_update_geometry(k, n, b)
    pmax, psum = ref.block_partials(ln, points)
    assert pmax.shape == psum.shape == (k, blocks)
    mm, ss = ref.merge_block_partials(pmax, psum)
    assert torch.equal(mm, m)
    np.testing.assert_allclose(ss.numpy(), s.numpy(), rtol=1e-5)
    _, _, jm, js = jax.vmap(lambda c, l, uu, w: jops.mwu_update(
        c, l, uu, w, **scal, normalize=False))(
        *(jnp.asarray(a) for a in (cols, ll, u, dw)))
    np.testing.assert_allclose(mm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose((mm + torch.log(ss)).numpy(),
                               np.asarray(jm + jnp.log(js)), atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("n,b", [(17, 1), (512, 1), (1025, 8), (2048, 128)])
def test_mwu_update_matches_jax(n, b, sign, normalize):
    """ops.mwu_update (plain version) against the JAX Pallas kernel
    (interpret mode) at the shapes and scalars of tests/test_kernels.py;
    unnormalized, the (m, s) partials give the same logsumexp."""
    rng = np.random.default_rng(n * 7 + b)
    cols = rng.normal(size=(n, b)).astype(np.float32)
    ll = np.log(np.ones(n) / n).astype(np.float32)
    u = (rng.normal(size=n) * 0.1).astype(np.float32)
    dw = (rng.normal(size=b) * 0.01).astype(np.float32)
    scal = dict(sign=sign, gamma=1e-3, tau=40.0, d_eff=128.0)
    got = ops.mwu_update(*(torch.from_numpy(a) for a in (cols, ll, u, dw)),
                         **scal, normalize=normalize)
    want = jops.mwu_update(*(jnp.asarray(a) for a in (cols, ll, u, dw)),
                           **scal, normalize=normalize)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5)
    if not normalize:
        np.testing.assert_allclose(
            float(got[2] + torch.log(got[3])),
            float(want[2] + jnp.log(want[3])), atol=1e-4)
        oracle, _ = jref.mwu_update_ref(*(jnp.asarray(a) for a in
                                          (cols, ll, u, dw)), **scal)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(oracle),
                                   atol=1e-4)


@pytest.mark.parametrize("k,n,b", [(5, 37, 1), (3, 513, 8), (2, 1025, 128)])
def test_unpacked_client_axis_is_per_client(k, n, b):
    """With a leading client axis each client's row is the single-client
    call on that row (no sum over clients), and matches JAX's kernel on
    it, unnormalized and normalized (each client by its own logsumexp);
    round-robin padding rows (zero points, log weight -1e30) add exactly
    0."""
    rng = np.random.default_rng(k * n + b)
    cols = rng.normal(size=(k, n, b)).astype(np.float32)
    ll = (rng.normal(size=(k, n)) * 0.1 - np.log(k * n)).astype(np.float32)
    lp = (ll + 0.05 * rng.normal(size=(k, n))).astype(np.float32)
    cols[:, -1] = 0.0
    ll[:, -1] = lp[:, -1] = NEG
    u = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    u[:, -1] = 0.0
    dw = (rng.normal(size=(k, b)) * 0.01).astype(np.float32)
    t = [torch.from_numpy(a) for a in (cols, ll, lp, u, dw)]
    delta = ops.momentum_dot(t[0], t[1], t[2], 0.9)
    out = ops.mwu_update(t[0], t[1], t[3], t[4], -1.0, 1e-3, 40.0, 16.0,
                         normalize=False)
    norm = ops.mwu_update(t[0], t[1], t[3], t[4], -1.0, 1e-3, 40.0, 16.0,
                          normalize=True)
    assert delta.shape == (k, b) and out[2].shape == out[3].shape == (k,)
    assert len(norm) == 2 and norm[0].shape == norm[1].shape == (k, n)
    for c in range(k):
        one = ops.momentum_dot(t[0][c], t[1][c], t[2][c], 0.9)
        np.testing.assert_array_equal(delta[c].numpy(), one.numpy())
        want = jops.momentum_dot(jnp.asarray(cols[c]), jnp.asarray(ll[c]),
                                 jnp.asarray(lp[c]), 0.9)
        np.testing.assert_allclose(delta[c].numpy(), np.asarray(want),
                                   atol=1e-4)
        jw = jops.mwu_update(jnp.asarray(cols[c]), jnp.asarray(ll[c]),
                             jnp.asarray(u[c]), jnp.asarray(dw[c]),
                             sign=-1.0, gamma=1e-3, tau=40.0, d_eff=16.0,
                             normalize=False)
        real = slice(0, n - 1)
        np.testing.assert_allclose(out[0][c, real].numpy(),
                                   np.asarray(jw[0])[real], atol=1e-4)
        np.testing.assert_allclose(out[1][c].numpy(), np.asarray(jw[1]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(out[2][c] + torch.log(out[3][c])),
                                   float(jw[2] + jnp.log(jw[3])), atol=1e-4)
        jn = jops.mwu_update(jnp.asarray(cols[c]), jnp.asarray(ll[c]),
                             jnp.asarray(u[c]), jnp.asarray(dw[c]),
                             sign=-1.0, gamma=1e-3, tau=40.0, d_eff=16.0,
                             normalize=True)
        np.testing.assert_allclose(norm[0][c, real].numpy(),
                                   np.asarray(jn[0])[real], atol=1e-4)
        np.testing.assert_allclose(norm[1][c].numpy(), np.asarray(jn[1]),
                                   atol=1e-5)
        one = ops.mwu_update(t[0][c], t[1][c], t[3][c], t[4][c], -1.0, 1e-3,
                             40.0, 16.0, normalize=True)
        np.testing.assert_array_equal(norm[0][c].numpy(), one[0].numpy())
    # the padding point's log weight stays finite near -1e30
    assert torch.isfinite(out[0][:, -1]).all()
    assert (out[0][:, -1] < -1e29).all()
    assert (norm[0][:, -1] < -1e29).all()


def _good_unpacked(k=None, n=40, b=4):
    lead = () if k is None else (k,)
    return (torch.zeros(lead + (n, b)), torch.zeros(lead + (n,)),
            torch.zeros(lead + (b,)))


@pytest.mark.parametrize("bad", ["cols_dtype", "vec_dtype", "dw_dtype",
                                 "dw_length", "client_axis_vec",
                                 "client_axis_dw", "cols_ndim", "empty",
                                 "contiguous"])
def test_unpacked_wrappers_reject_bad_inputs(bad):
    cols, vec, dw = _good_unpacked(k=3)
    log_lam, log_prev, u = vec, vec.clone(), vec.clone()
    err = ValueError
    if bad == "cols_dtype":
        cols, err = cols.double(), TypeError
    elif bad == "vec_dtype":
        log_lam, err = log_lam.to(torch.bfloat16), TypeError
        u = u.double()
    elif bad == "dw_dtype":
        dw, err = dw.double(), TypeError
    elif bad == "dw_length":
        dw = torch.zeros((3, 5))
    elif bad == "client_axis_vec":
        log_lam, u = torch.zeros(40), torch.zeros((2, 40))
    elif bad == "client_axis_dw":
        dw = torch.zeros(4)
    elif bad == "cols_ndim":
        cols = torch.zeros((1, 3, 40, 4))
    elif bad == "empty":
        cols, log_lam = torch.zeros((3, 0, 4)), torch.zeros((3, 0))
        log_prev, u = log_lam.clone(), log_lam.clone()
    elif bad == "contiguous":
        cols = torch.zeros((3, 4, 40)).transpose(1, 2)
    if bad not in ("dw_dtype", "dw_length", "client_axis_dw"):
        with pytest.raises(err):
            ops.momentum_dot(cols, log_lam, log_prev, 0.9)
    with pytest.raises(err):
        ops.mwu_update(cols, log_lam, u, dw, 1.0, 1e-3, 40.0, 4.0)


def test_unpacked_cpu_calls_are_not_counted_as_launches():
    before = dict(ops.launch_counts)
    cols, vec, dw = _good_unpacked()
    ops.momentum_dot(cols, vec, vec, 0.5)
    ops.mwu_update(cols, vec, vec, dw, 1.0, 1e-3, 40.0, 4.0)
    ops.mwu_update(cols, vec, vec, dw, -1.0, 1e-3, 40.0, 4.0,
                   normalize=False)
    assert dict(ops.launch_counts) == before
    assert "momentum_dot" not in ops.launch_counts
    assert "mwu_update" not in ops.launch_counts


def test_unpacked_plain_versions_compute_step_scalars_in_f32():
    """c = 1 / (gamma + d_eff / tau) is taken in float32 from float32
    scalars, as the Pallas kernel and the CUDA kernel take it."""
    cols, vec, dw = _good_unpacked(n=3, b=1)
    ll = torch.tensor([-1.0, -2.0, -3.0])
    got, _, m, s = ref.mwu_update_ref(cols, ll, vec, dw, 1.0, 0.1, 3.0,
                                      7.0, normalize=False)
    f = np.float32
    ratio = f(7.0) / f(3.0)
    c = f(1.0) / (f(0.1) + ratio)
    want = c * (ratio * ll.numpy())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert float(m) == float(got.max())
