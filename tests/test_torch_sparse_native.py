"""The port's binding of the native sparse Cholesky (paropt_torch.ops.
sparse_native) against paropt_tpu.ops.sparse_native on the same numpy
inputs: both load a library built from src_native/paropt_sparse.cpp with
the same flags, so every result is bitwise equal.

- `SparseCholesky` over both methods and every ordering, refactored with
  new values;
- the orderings and `fill_count`; `csr_adat` with and without C;
- `CSRQuasiDefMat` with and without dense columns (the SMW split), one and
  several right-hand sides, and `get_factor_info`;
- the not-positive-definite error, and a failed build raising with g++'s
  output.
"""

import numpy as np
import pytest

from paropt_tpu.ops import sparse_native as jsn
from paropt_torch.ops import sparse_native as tsn


def _spd_csr(n=60, density=0.08, seed=0):
    """A random sparse SPD matrix in CSR form (pattern, values, dense)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    A = A @ A.T + n * np.eye(n)
    rowp = np.concatenate([[0], np.cumsum((A != 0).sum(1))]).astype(np.int32)
    cols = np.nonzero(A)[1].astype(np.int32)
    return rowp, cols, A[A != 0], A


def _aw_csr(m=40, nv=30, dense=True, seed=1):
    """A random [m, nv] constraint Jacobian in CSR form; with ``dense``,
    two columns appear in every row."""
    rng = np.random.default_rng(seed)
    Aw = (rng.random((m, nv)) < 0.1) * rng.standard_normal((m, nv))
    Aw[np.arange(m), rng.integers(0, nv, m)] = 1.0   # no empty row
    if dense:
        Aw[:, 3] = 1.0
        Aw[:, 7] = rng.standard_normal(m)
    rowp = np.concatenate([[0], np.cumsum((Aw != 0).sum(1))]).astype(
        np.int32)
    return rowp, np.nonzero(Aw)[1].astype(np.int32), Aw[Aw != 0], Aw


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_library_builds_beside_the_checkout_not_in_the_jax_package():
    path = tsn.build_library()
    assert path.parent.parent == tsn.BUILD_ROOT
    assert path.parts[-4:-2] == ("build", "paropt_torch_sparse")
    assert path.name != "_paropt_sparse.so"
    assert tsn.load_library() is tsn.load_library()


@pytest.mark.parametrize("method", ["supernodal", "simplicial"])
@pytest.mark.parametrize("ordering", ["natural", "amd", "nd", "auto"])
def test_sparse_cholesky_bitwise(method, ordering):
    rowp, cols, vals, A = _spd_csr()
    t = tsn.SparseCholesky(rowp, cols, ordering=ordering, method=method)
    j = jsn.SparseCholesky(rowp, cols, ordering=ordering, method=method)
    assert (t.nnz, t.nsupernodes) == (j.nnz, j.nsupernodes)
    rng = np.random.default_rng(2)
    for scale in (1.0, 3.0):   # a refactor with new values
        t.factor(scale * vals)
        j.factor(scale * vals)
        b1, b3 = rng.standard_normal(A.shape[0]), rng.standard_normal(
            (A.shape[0], 3))
        _equal(t.solve(b1), j.solve(b1))
        _equal(t.solve(b3), j.solve(b3))
        np.testing.assert_allclose(t.solve(b3), np.linalg.solve(scale * A,
                                                                b3),
                                   rtol=1e-10, atol=1e-12)


def test_orderings_and_fill_count_bitwise():
    rowp, cols, _, _ = _spd_csr(n=80, seed=3)
    for name in ("amd_order", "nd_order"):
        perm = getattr(tsn, name)(rowp, cols)
        _equal(perm, getattr(jsn, name)(rowp, cols))
        assert sorted(perm) == list(range(80))
        assert tsn.fill_count(rowp, cols, perm) == jsn.fill_count(rowp, cols,
                                                                   perm)


@pytest.mark.parametrize("with_c", [False, True])
def test_csr_adat_bitwise(with_c):
    rowp, cols, vals, Aw = _aw_csr(dense=False)
    rng = np.random.default_rng(4)
    d = rng.random(Aw.shape[1]) + 0.5
    c = rng.random(Aw.shape[0]) + 0.1 if with_c else None
    got, want = tsn.csr_adat(rowp, cols, vals, d, c), jsn.csr_adat(
        rowp, cols, vals, d, c)
    for a, b in zip(got, want):
        _equal(a, b)
    orp, oc, ov = got
    dense = np.zeros((Aw.shape[0],) * 2)
    dense[np.repeat(np.arange(Aw.shape[0]), np.diff(orp)), oc] = ov
    ref = Aw @ np.diag(d) @ Aw.T + (np.diag(c) if with_c else 0.0)
    np.testing.assert_allclose(dense, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dense_cols", [False, True])
def test_csr_quasi_def_mat_bitwise(dense_cols):
    rowp, cols, vals, Aw = _aw_csr(dense=dense_cols)
    m, nv = Aw.shape
    t = tsn.CSRQuasiDefMat(nv, rowp, cols)
    j = jsn.CSRQuasiDefMat(nv, rowp, cols)
    _equal(t.dense_cols, j.dense_cols)
    assert (t.dense_cols.size > 0) == dense_cols
    assert t.get_factor_info() == j.get_factor_info() == "unfactored"
    rng = np.random.default_rng(5)
    for step in range(2):   # the second factor reuses the pattern
        t.set_values((1.0 + step) * vals)
        j.set_values((1.0 + step) * vals)
        Dinv, C0 = rng.random(nv) + 0.5, rng.random(m) + 0.1
        t.factor(Dinv, C0)
        j.factor(Dinv, C0)
        b1, b2 = rng.standard_normal(m), np.asfortranarray(
            rng.standard_normal((m, 2)))
        _equal(t.solve(b1), j.solve(b1))
        _equal(t.solve(b2), j.solve(b2))
        Cw = np.diag(C0) + ((1.0 + step) * Aw) @ np.diag(Dinv) @ (
            (1.0 + step) * Aw).T
        np.testing.assert_allclose(t.solve(b2), np.linalg.solve(Cw, b2),
                                   rtol=1e-9, atol=1e-11)
    assert t.get_factor_info() == j.get_factor_info()
    assert t.nfactor == j.nfactor == 2
    assert t.factor_seconds > 0.0 and t.solve_seconds > 0.0


def test_not_positive_definite_raises_alike():
    rowp, cols, vals, A = _spd_csr(n=20, seed=6)
    bad = vals.copy()
    diag = [p for i in range(20) for p in range(rowp[i], rowp[i + 1])
            if cols[p] == i]
    bad[diag[7]] = -50.0
    msgs = []
    for mod in (tsn, jsn):
        chol = mod.SparseCholesky(rowp, cols, ordering="natural")
        with pytest.raises(RuntimeError, match="not positive definite") as e:
            chol.factor(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int paropt_amd_order( {\n")
    monkeypatch.setattr(tsn, "SOURCE", src)
    monkeypatch.setattr(tsn, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        tsn.build_library()
    assert "broken.cpp" in str(e.value)
    assert not any((tmp_path / "build").rglob("*.so"))
