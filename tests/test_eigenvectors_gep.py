"""Tests for generalized eigenvector back-substitution."""

import numpy as np
import jax.numpy as jnp

from starneig_jax.errors import Error
from starneig_jax.ops.eigenvectors import eigenvectors_schur_gep
from starneig_jax.ops.hess_triangular import hessenberg_triangular
from starneig_jax.ops.qz import small_qz
from starneig_jax.testing import random_dense, known_spectrum_pencil


def _make(n, seed, **kw):
    if kw:
        A, B, alpha, beta = known_spectrum_pencil(n, seed=seed, **kw)
    else:
        A = random_dense(n, seed=seed)
        B = random_dense(n, seed=seed + 77) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, info = small_qz(H, T, Q, Z, n)
    assert int(info) == 0
    return A, B, *map(np.asarray, (S, Tt, Qo, Zo))


def _check_vectors(A, B, S, Tt, X, select):
    """Verify beta*A x = alpha*B x for returned columns."""
    n = A.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    nrm = np.linalg.norm(A) + np.linalg.norm(B)
    worst = 0.0
    c = i = 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                # complex pair: alpha from 2x2 pencil
                import scipy.linalg
                ev = scipy.linalg.eigvals(S[i:i+2, i:i+2], Tt[i:i+2, i:i+2])
                lam = ev[0] if ev[0].imag > 0 else ev[1]
                x = X[:, c] + 1j * X[:, c + 1]
                r = np.linalg.norm(A @ x - lam * (B @ x)) / (nrm * np.linalg.norm(x))
                worst = max(worst, r)
                c += 2
            i += 2
        else:
            if select[i]:
                if abs(Tt[i, i]) > 1e-12:
                    lam = S[i, i] / Tt[i, i]
                    x = X[:, c]
                    r = np.linalg.norm(A @ x - lam * (B @ x)) / (nrm * np.linalg.norm(x) * max(1, abs(lam)))
                else:  # infinite eigenvalue: B x = 0
                    x = X[:, c]
                    r = np.linalg.norm(B @ x) / (nrm * np.linalg.norm(x))
                worst = max(worst, r)
                c += 1
            i += 1
    return worst


def test_gep_eigenvectors_all():
    n = 24
    A, B, S, Tt, Q, Z = _make(n, seed=1)
    sel = np.ones(n, bool)
    X, info = eigenvectors_schur_gep(S, Tt, Q, Z, sel)
    assert info == Error.SUCCESS
    worst = _check_vectors(A, B, S, Tt, np.asarray(X), sel)
    assert worst < 1e-10, worst


def test_gep_eigenvectors_subset():
    n = 32
    A, B, S, Tt, Q, Z = _make(n, seed=5)
    sel = np.random.default_rng(0).random(n) < 0.4
    X, info = eigenvectors_schur_gep(S, Tt, Q, Z, sel)
    worst = _check_vectors(A, B, S, Tt, np.asarray(X), sel)
    assert worst < 1e-10, worst


def test_gep_eigenvectors_infinite():
    n = 20
    A, B, S, Tt, Q, Z = _make(n, seed=9, complex_ratio=0.2, inf_ratio=0.2)
    sel = np.ones(n, bool)
    X, info = eigenvectors_schur_gep(S, Tt, Q, Z, sel)
    worst = _check_vectors(A, B, S, Tt, np.asarray(X), sel)
    assert worst < 1e-8, worst
