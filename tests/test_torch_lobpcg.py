"""The port's LOBPCG (`paropt_torch.ops.lobpcg`) against JAX's
``jax.experimental.sparse.linalg.lobpcg_standard`` on the same numpy
inputs, in float64: a dense SPD operator given as a callable, n = 200,
k = 4.  Eigenvalues to 1e-10 relative, eigenvectors to 1e-8 up to the sign
of each column (the two packages' ``eigh`` may pick either), the same
iteration count; and the pieces (SVQB orthonormalization, the projection,
the Householder basis extension) against JAX's on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse import linalg as jlinalg

from paropt_torch.ip import HostSyncs
from paropt_torch.ops import lobpcg as tlobpcg

from ._torch_parity import assert_close

torch.set_num_threads(1)

N, K = 200, 4


def _operator(case):
    """A dense SPD matrix with a chosen spectrum: 'separated' top-k
    eigenvalues converge early; 'clustered' ones run to the cap m."""
    rng = np.random.default_rng(0 if case == "separated" else 1)
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    if case == "separated":
        ev = np.concatenate([np.linspace(10.0, 5.0, 6),
                             rng.uniform(0.1, 4.0, N - 6)])
    else:
        ev = np.concatenate([1.0 + 1e-3 * np.arange(8)[::-1],
                             rng.uniform(0.1, 0.99, N - 8)])
    return (Q * ev) @ Q.T, rng.standard_normal((N, K))


def _same_up_to_sign(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, rtol=0.0, atol=atol)


@pytest.mark.parametrize("case,m", [("separated", 100), ("clustered", 12)])
def test_lobpcg_matches_jax(case, m):
    A, X0 = _operator(case)
    Aj = jnp.asarray(A)
    jtheta, jU, jit = jlinalg.lobpcg_standard(lambda v: Aj @ v,
                                              jnp.asarray(X0), m=m)
    At = torch.tensor(A)
    syncs = HostSyncs()
    ttheta, tU, tit = tlobpcg.lobpcg_standard(lambda v: At @ v,
                                              torch.tensor(X0), m=m,
                                              syncs=syncs)
    assert tit == int(jit)
    # one host read of the converged count per block iteration
    assert syncs.count == tit
    assert_close(ttheta, jtheta, rtol=1e-10)
    _same_up_to_sign(tU, jU, atol=1e-8)
    if case == "separated":
        assert tit < m
        np.testing.assert_allclose(ttheta.numpy(), [10.0, 9.0, 8.0, 7.0],
                                   rtol=1e-12)
    else:
        assert tit == m


def test_lobpcg_pieces_match_jax():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((N, 3 * K))
    X[:, 5] = X[:, 2] + 1e-17 * X[:, 1]       # a dependent column
    X[:, 7] = 0.0                             # a zero column
    Xt = torch.tensor(X)
    got = tlobpcg._svqb(Xt)
    want = jlinalg._svqb(jnp.asarray(X))
    # SVQB's basis is an eigenbasis of XᵀX: equal up to column sign
    _same_up_to_sign(got, want, atol=1e-10)

    B = np.asarray(jlinalg._orthonormalize(jnp.asarray(X[:, :K])))
    U = rng.standard_normal((N, K))
    got = tlobpcg._project_out(torch.tensor(B), torch.tensor(U)).numpy()
    want = np.asarray(jlinalg._project_out(jnp.asarray(B), jnp.asarray(U)))
    # its second orthonormalization sees an orthonormal block (XᵀX ≈ I, a
    # degenerate eigenproblem), so only the span is defined: hold the
    # projectors onto it
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-10)
    np.testing.assert_allclose(B.T @ got, 0.0, atol=1e-12)
    assert_close(tlobpcg._extend_basis(torch.tensor(B), K),
                 jlinalg._extend_basis(jnp.asarray(B), K),
                 rtol=0.0, atol=1e-12)
    ext = tlobpcg._extend_basis(torch.tensor(B), K).numpy()
    basis = np.concatenate([B, ext], axis=1)
    np.testing.assert_allclose(basis.T @ basis, np.eye(2 * K), atol=1e-12)


def test_lobpcg_input_checks():
    X = torch.zeros((10, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="search dim \\* 5"):
        tlobpcg.lobpcg_standard(lambda v: v, X)
    with pytest.raises(ValueError, match="search dim > 0"):
        tlobpcg.lobpcg_standard(lambda v: v, torch.zeros((10, 0)))
