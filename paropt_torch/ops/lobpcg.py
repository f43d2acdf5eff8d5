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

`lobpcg_standard_batched` runs kb independent solves on a leading instance
axis (torch.linalg's batched ``eigh``, ``qr`` and ``svd``), which a host
read inside ``torch.func.vmap`` cannot: each instance keeps its own block
counter and converged count, and an instance that has converged or reached
``m`` keeps its carry (X, P, R, theta, i) bit for bit while the others
iterate, as JAX's ``while_loop`` batching rule does under ``jax.vmap``.
The helpers below act on the last two axes, so both forms share them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["lobpcg_standard", "lobpcg_standard_batched"]


def _check_inputs(X):
    n, k = X.shape[-2:]
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    return n, k


def _start(A, X, k):
    """The orthonormalized start block, the first P, and R at X."""
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=-2, keepdim=True)
    return X, P, AX - theta * X, theta


def _iterate(A, X, P, R, k, n, tol):
    """One block iteration: (X, P, R, theta [..., 1, k], the count of
    converged pairs)."""
    # invariants: X, P, R orthonormal; some R, P columns may be 0
    R = _project_out(torch.cat((X, P), dim=-1), R)
    XPR = torch.cat((X, P, R), dim=-1)
    theta, Q = _rayleigh_ritz_orth(A, XPR)

    B = Q[..., :k]
    B = B / _colnorm(B)
    X = XPR @ B
    X = X / _colnorm(X)

    # P: the Ritz directions of [P, R] orthogonalized against X's, in
    # the basis XPR (orthonormal, so P comes out orthonormal)
    q, _ = torch.linalg.qr(Q[..., :k, k:].mT)
    P = XPR @ (Q[..., k:] @ q)
    normP = _colnorm(P)
    P = P / torch.where(normP == 0, 1.0, normP)

    AX = A(X)
    R = AX - theta[..., None, :k] * X
    resid = torch.linalg.vector_norm(R, dim=-2)
    reltol = (torch.linalg.vector_norm(AX, dim=-2) + theta[..., :k]) * n * 10
    converged = torch.sum(resid < tol * reltol, dim=-1)
    return X, P, R, theta[..., None, :k], converged


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor],
                    X: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None, syncs=None):
    """The k largest eigenpairs of the symmetric operator ``A`` ([n, k] ->
    [n, k]) from the start block ``X`` [n, k] (numerically independent
    columns; 0 < 5k < n), in at most ``m`` block iterations.  Returns
    ``(theta [k], U [n, k], iterations)``, theta in descending order.
    ``syncs`` (a `HostSyncs`) counts the per-iteration host reads."""
    n, k = _check_inputs(X)
    if tol is None:
        tol = torch.finfo(X.dtype).eps
    read = syncs.value if syncs is not None else float

    X, P, R, theta = _start(A, X, k)
    i, converged = 0, 0
    while i < m and converged < k:
        X, P, R, theta, conv = _iterate(A, X, P, R, k, n, tol)
        converged = int(read(conv))
        i += 1
    return theta[0, :], X, i


def lobpcg_standard_batched(A: Callable[[torch.Tensor], torch.Tensor],
                            X: torch.Tensor, m: int = 100,
                            tol: Optional[float] = None, syncs=None):
    """kb independent `lobpcg_standard` solves: ``A`` maps [kb, n, k] to
    [kb, n, k] instance by instance, ``X`` is [kb, n, k] (or [n, k], one
    start for every instance, with ``kb`` given by ``A``'s output).  One
    host read per block iteration for the whole batch: the [kb] flags of
    the instances still running, from which the host keeps each one's
    count.  Returns ``(theta [kb, k], U [kb, n, k], iterations)`` with
    ``iterations`` a list of kb ints."""
    n, k = _check_inputs(X)
    if tol is None:
        tol = torch.finfo(X.dtype).eps
    X, P, R, theta = _start(A, X, k)
    kb = R.shape[0]
    X, P = X.expand(kb, n, k), P.expand(kb, n, k)
    theta = theta.expand(kb, 1, k)
    running = torch.ones(kb, dtype=torch.bool, device=R.device)
    count = torch.zeros(kb, dtype=torch.int64, device=R.device)
    flags = np.full(kb, m > 0)
    iters = np.zeros(kb, dtype=np.int64)
    while flags.any():
        new = _iterate(A, X, P, R, k, n, tol)
        sel = running[:, None, None]
        X, P, R, theta = (torch.where(sel, a, b) for a, b in
                          zip(new[:4], (X, P, R, theta)))
        count = count + running
        running = running & (count < m) & (new[4] < k)
        iters += flags
        flags = (syncs.array(running) if syncs is not None
                 else running.cpu().numpy())
    return theta[:, 0, :], X, iters.tolist()


def _colnorm(a):
    return torch.linalg.vector_norm(a, dim=-2, keepdim=True)


def _eigh_descending(a):
    """eigh of the symmetrized input (JAX symmetrizes by default), largest
    eigenvalue first."""
    w, V = torch.linalg.eigh((a + a.mT) / 2)
    return w.flip(-1), V.flip(-1)


def _svqb(X):
    """Orthonormal basis of span(X) from the eigenbasis of XᵀX (SVQB);
    directions whose eigenvalue falls below eps times the largest are
    dropped as zero columns."""
    norms = _colnorm(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.mT @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[..., :1]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    orthoX = X @ (V * sqrted[..., None, :])
    keep = ((w > tau) & (torch.diagonal(inner, dim1=-2, dim2=-1)
                         > 0.0))[..., None, :]
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
        U = U - basis @ (basis.mT @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.mT @ U)
    return U * (_colnorm(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S):
    """Eigenpairs of Sᵀ A S for an orthonormal S, largest first."""
    return _eigh_descending(S.mT @ A(S))


def _extend_basis(X, m):
    """m columns orthonormal to X's and to each other, by a block
    Householder reflector built from X's top k rows (deterministic)."""
    n, k = X.shape[-2:]
    Xupper, Xlower = X[..., :k, :], X[..., k:, :]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=-2)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.mT * ((2 * (1 + s)) ** (-0.5))[..., None, :])
    h = -2 * (w @ (w[..., k:, :].mT @ other))
    return torch.cat([h[..., :k, :], h[..., k:, :] + other], dim=-2)
