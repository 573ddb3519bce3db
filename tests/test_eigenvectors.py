"""Tests for standard eigenvector back-substitution."""

import numpy as np
import jax.numpy as jnp

from starneig_jax.errors import Error
from starneig_jax.ops.eigenvectors import eigenvectors_schur
from starneig_jax.ops.small_schur import small_schur
from starneig_jax.ops.eigvals import extract_eigenvalues
from starneig_jax.testing import random_hessenberg

RNG = np.random.default_rng(41)


def _setup(n, seed):
    H = random_hessenberg(n, seed=seed)
    S, Q, info = small_schur(jnp.array(H), jnp.eye(n), n)
    assert int(info) == 0
    return H, np.asarray(S), np.asarray(Q)


def _residuals(A, X, eigs):
    """max ||A x - lambda x|| / (||A|| ||x||) over returned columns."""
    worst = 0.0
    c = 0
    nA = np.linalg.norm(A)
    for lam, pair in eigs:
        if pair:
            x = X[:, c] + 1j * X[:, c + 1]
            c += 2
        else:
            x = X[:, c].astype(complex)
            c += 1
        r = np.linalg.norm(A @ x - lam * x) / (nA * max(np.linalg.norm(x), 1e-300))
        worst = max(worst, r)
    return worst


def _selected_eigs(S, select):
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    d = np.diagonal(S)
    sup = np.concatenate([np.diagonal(S, 1), [0.0]])
    out = []
    i = 0
    n = S.shape[0]
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                lam = 0.5 * (d[i] + d[i + 1]) + 1j * np.sqrt(np.abs(sup[i]) * np.abs(sub[i]))
                out.append((lam, True))
            i += 2
        else:
            if select[i]:
                out.append((d[i], False))
            i += 1
    return out


def test_all_eigenvectors():
    n = 32
    A, S, Q = _setup(n, seed=1)
    select = np.ones(n, bool)
    X, info = eigenvectors_schur(S, Q, select)
    assert info == Error.SUCCESS
    X = np.asarray(X)
    eigs = _selected_eigs(S, select)
    worst = _residuals(A, X, eigs)
    assert worst < 1e-12, f"worst rel residual {worst}"


def test_subset_selection():
    n = 40
    A, S, Q = _setup(n, seed=2)
    select = RNG.random(n) < 0.3
    X, info = eigenvectors_schur(S, Q, select)
    X = np.asarray(X)
    eigs = _selected_eigs(S, select)
    ncols = sum(2 if p else 1 for _, p in eigs)
    assert X.shape == (n, ncols)
    assert _residuals(A, X, eigs) < 1e-12


def test_none_selected():
    n = 10
    A, S, Q = _setup(n, seed=3)
    X, info = eigenvectors_schur(S, Q, np.zeros(n, bool))
    assert np.asarray(X).shape == (n, 0)


def test_unit_norm():
    n = 24
    A, S, Q = _setup(n, seed=4)
    X, info = eigenvectors_schur(S, Q, np.ones(n, bool))
    X = np.asarray(X)
    eigs = _selected_eigs(S, np.ones(n, bool))
    c = 0
    for lam, pair in eigs:
        if pair:
            nrm = np.sqrt(np.linalg.norm(X[:, c])**2 + np.linalg.norm(X[:, c+1])**2)
            c += 2
        else:
            nrm = np.linalg.norm(X[:, c])
            c += 1
        assert 0.9 < nrm < 1.1


def test_graded_matrix_robust():
    """Diagonal graded across 1e+150 .. 1e-150: the robust scaling
    (reference robust.h:185-381 machinery) must produce finite, accurate
    vectors where an unprotected backsolve over/underflows."""
    n = 40
    rng = np.random.default_rng(7)
    d = np.logspace(150, -150, n)
    S = np.triu(rng.standard_normal((n, n))) * np.sqrt(np.outer(d, d))
    np.fill_diagonal(S, d)
    Q = np.eye(n)
    sel = np.zeros(n, bool)
    sel[n // 2] = True          # an eigenvalue deep in the grading
    sel[-1] = True              # the tiniest one
    X, info = eigenvectors_schur(jnp.asarray(S), jnp.asarray(Q), sel)
    X = np.asarray(X)
    assert np.all(np.isfinite(X)) and X.shape == (n, 2)
    for c, j in enumerate([n // 2, n - 1]):
        x = X[:, c]
        assert np.linalg.norm(x) > 0.5
        r = S @ x - d[j] * x
        # relative to the largest row scale the vector actually touches
        denom = np.max(np.abs(S) @ np.abs(x)) + d[j] * np.abs(x).max()
        assert np.linalg.norm(r) / max(denom, 1e-300) < 1e-10


def test_close_eigenvalues_warning():
    """A multiple eigenvalue raises the CLOSE_EIGENVALUES warning
    (reference interface.c:57-88, error.h:122-127)."""
    n = 12
    rng = np.random.default_rng(8)
    S = np.triu(rng.standard_normal((n, n)))
    np.fill_diagonal(S, np.arange(1, n + 1, dtype=float))
    S[5, 5] = S[2, 2]           # exact multiplicity
    sel = np.zeros(n, bool)
    sel[5] = True               # solving through the duplicate at 2
    X, info = eigenvectors_schur(jnp.asarray(S), jnp.asarray(np.eye(n)), sel)
    assert info == Error.CLOSE_EIGENVALUES
    assert np.all(np.isfinite(np.asarray(X)))
    # distinct eigenvalues stay clean
    S[5, 5] = 6.0
    X, info = eigenvectors_schur(jnp.asarray(S), jnp.asarray(np.eye(n)), sel)
    assert info == Error.SUCCESS
