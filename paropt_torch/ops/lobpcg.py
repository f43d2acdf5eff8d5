"""LOBPCG for the top-k eigenpairs of a symmetric operator given as a
callable: the port's own copy of JAX 0.9.0's
``jax.experimental.sparse.linalg.lobpcg_standard`` (callable form), which
the JAX package's frequency models call.  ``torch.lobpcg`` is a different
iteration (another basis, restarts and convergence test), so this module
keeps JAX's: an orthonormal [X, P, R] basis (SVQB orthonormalization,
projection "twice is enough"), a Rayleigh-Ritz solve on it, P taken from the
Ritz vectors orthogonalized against X, a deterministic Householder
extension for the first P, and the self-consistency exit test
``|A x - θ x| < tol · 10 · n · (|A x| + θ)`` with ``tol`` the dtype's eps.

JAX runs the iteration as one ``lax.while_loop``; here it is a host loop
that reads the count of converged pairs once per block iteration (counted
by ``syncs``).  JAX's input check calls ``A`` on a zero column, dead code
under ``jit``; the port checks the shapes without calling ``A``.  The
eigenvectors agree with JAX's up to the sign of each column: the two
packages' ``eigh`` may pick either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["lobpcg_standard"]


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor],
                    X: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None, syncs=None):
    """The k largest eigenpairs of the symmetric operator ``A`` ([n, k] ->
    [n, k]) from the start block ``X`` [n, k] (numerically independent
    columns; 0 < 5k < n), in at most ``m`` block iterations.  Returns
    ``(theta [k], U [n, k], iterations)``, theta in descending order.
    ``syncs`` (a `HostSyncs`) counts the per-iteration host reads."""
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if tol is None:
        tol = torch.finfo(X.dtype).eps
    read = syncs.value if syncs is not None else float

    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i, converged = 0, 0
    while i < m and converged < k:
        # invariants: X, P, R orthonormal; some R, P columns may be 0
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / _colnorm(B)
        X = XPR @ B
        X = X / _colnorm(X)

        # P: the Ritz directions of [P, R] orthogonalized against X's, in
        # the basis XPR (orthonormal, so P comes out orthonormal)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = _colnorm(P)
        P = P / torch.where(normP == 0, 1.0, normP)

        AX = A(X)
        R = AX - theta[None, :k] * X
        resid = torch.linalg.vector_norm(R, dim=0)
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(read(torch.sum(resid < tol * reltol)))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _colnorm(a):
    return torch.linalg.vector_norm(a, dim=0, keepdim=True)


def _eigh_descending(a):
    """eigh of the symmetrized input (JAX symmetrizes by default), largest
    eigenvalue first."""
    w, V = torch.linalg.eigh((a + a.T) / 2)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """Orthonormal basis of span(X) from the eigenbasis of XᵀX (SVQB);
    directions whose eigenvalue falls below eps times the largest are
    dropped as zero columns."""
    norms = _colnorm(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _colnorm(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    """The component of U orthogonal to the orthonormal ``basis`` (zero
    columns allowed), orthonormalized; a column that does not keep 0.99 of
    its norm through the final subtractions is zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    return U * (_colnorm(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S):
    """Eigenpairs of Sᵀ A S for an orthonormal S, largest first."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X, m):
    """m columns orthonormal to X's and to each other, by a block
    Householder reflector built from X's top k rows (deterministic)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    return torch.cat([h[:k], h[k:] + other], dim=0)
