"""The port's data sets (``repro_torch.data``) against the JAX package's:
the sparse Table 4 generator bit for bit, and the LIBSVM reader and
writer on files the tests write themselves (no data set is
downloaded)."""

import numpy as np
import pytest

from repro.data import libsvm as jlibsvm
from repro.data import synthetic as jsynthetic
from repro_torch.data import libsvm, synthetic


@pytest.mark.parametrize("n,d,nnz,seed", [(50, 32, 5, 2), (40, 128, 12, 12),
                                          (30, 16, 16, 7)])
def test_sparse_non_separable_is_jax_s(n, d, nnz, seed):
    """Bit-equal to the JAX package's, with exactly ``nnz`` non-zeros a
    row (tests/test_data.py::test_sparse_nnz holds at most nnz)."""
    want = jsynthetic.sparse_non_separable(n, d, nnz=nnz, seed=seed)
    got = synthetic.sparse_non_separable(n, d, nnz=nnz, seed=seed)
    assert got.x.dtype == np.float32 and got.y.dtype == np.int64
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal((got.x != 0).sum(axis=1), nnz)
    assert set(np.unique(got.y)) == {-1, 1}


def test_libsvm_roundtrip(tmp_path):
    """tests/test_data.py::test_libsvm_roundtrip, for the port."""
    ds = synthetic.sparse_non_separable(20, 10, nnz=3, seed=3)
    p = str(tmp_path / "data.libsvm")
    libsvm.save_libsvm(p, ds)
    back = libsvm.load_libsvm(p, n_features=10)
    assert isinstance(back, synthetic.Dataset)
    np.testing.assert_allclose(back.x, ds.x, atol=1e-5)
    np.testing.assert_array_equal(back.y, ds.y)


def test_libsvm_reads_and_writes_as_jax(tmp_path):
    """The port writes the JAX package's bytes, and reads the JAX
    package's file to the JAX package's arrays, bit for bit."""
    ds = jsynthetic.separable(25, 12, seed=12)
    jpath, path = str(tmp_path / "jax.libsvm"), str(tmp_path / "port.libsvm")
    jlibsvm.save_libsvm(jpath, ds)
    libsvm.save_libsvm(path, synthetic.Dataset(ds.x, ds.y))
    with open(jpath, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    want = jlibsvm.load_libsvm(jpath)
    got = libsvm.load_libsvm(jpath)
    assert got.x.dtype == np.float32 and got.y.dtype == np.int64
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)


@pytest.mark.parametrize("labels,want", [
    ((0, 1, 1, 0), (-1, 1, 1, -1)),
    ((1, 2, 2, 1), (-1, 1, 1, -1)),
    ((-1, 1, 1, -1), (-1, 1, 1, -1)),
    ((1, 1, 1, 1), (1, 1, 1, 1)),
])
def test_libsvm_label_mapping(tmp_path, labels, want):
    """{-1, +1} stay; any other labels map the largest to +1 and the rest
    to -1, as the JAX package's reader does."""
    path = str(tmp_path / "labels.libsvm")
    with open(path, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"{lab} {i % 3 + 1}:{0.5 * (i + 1)}\n")
    got = libsvm.load_libsvm(path)
    np.testing.assert_array_equal(got.y, want)
    np.testing.assert_array_equal(got.y, jlibsvm.load_libsvm(path).y)


@pytest.mark.parametrize("n_features", [None, 2, 6])
def test_libsvm_comments_blank_lines_and_width(tmp_path, n_features):
    """Blank lines are skipped, a token starting with '#' ends a row, and
    ``n_features`` cuts or pads the columns, as in the JAX package."""
    path = str(tmp_path / "edge.libsvm")
    with open(path, "w") as f:
        f.write("+1 1:0.25 4:-1.5 # a comment 2:9\n\n-1 3:2e-3\n   \n"
                "1 2:7\n")
    got = libsvm.load_libsvm(path, n_features=n_features)
    want = jlibsvm.load_libsvm(path, n_features=n_features)
    assert got.x.shape == (3, n_features or 4)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, [1, -1, 1])
    np.testing.assert_array_equal(got.y, want.y)
