"""Tests for the QZ iteration (generalized Schur form)."""

import numpy as np
import jax.numpy as jnp
import pytest

from starneig_jax.ops.qz import small_qz, standardize_gep_2x2
from starneig_jax.ops.hess_triangular import hessenberg_triangular
from starneig_jax.ops.eigvals import extract_eigenvalues_gen
from starneig_jax.testing import (
    random_dense,
    known_spectrum_pencil,
    residual_gep,
    orthogonality,
    schur_structure_error,
    eigenvalue_error,
)
from starneig_jax.testing.hooks import triangular_structure_error

RNG = np.random.default_rng(77)


def _full_qz(A, B):
    n = A.shape[0]
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, info = small_qz(H, T, Q, Z, n)
    return map(np.asarray, (S, Tt, Qo, Zo)), int(info)


def _check(A, B, S, Tt, Q, Z, atol_u=3000):
    assert schur_structure_error(S) == 0.0
    assert triangular_structure_error(Tt) == 0.0
    ra, rb = residual_gep(A, B, S, Tt, Q, Z)
    assert ra < atol_u, f"A residual {ra}u"
    assert rb < atol_u, f"B residual {rb}u"
    assert orthogonality(Q) < atol_u
    assert orthogonality(Z) < atol_u


@pytest.mark.parametrize("n", [2, 3, 6, 16])
def test_qz_small_sizes(n):
    A = random_dense(n, seed=n)
    B = random_dense(n, seed=n + 50) + 3 * np.eye(n)
    (S, Tt, Q, Z), info = _full_qz(A, B)
    assert info == 0
    _check(A, B, S, Tt, Q, Z)
    # generalized eigenvalues vs scipy
    import scipy.linalg
    ev_ref = scipy.linalg.eigvals(A, B)
    er, ei, beta = extract_eigenvalues_gen(jnp.array(S), jnp.array(Tt))
    er, ei, beta = map(np.asarray, (er, ei, beta))
    finite = np.abs(beta) > 1e-12
    ev = (er[finite] + 1j * ei[finite]) / beta[finite]
    assert eigenvalue_error(ev, ev_ref) < 5e4


def test_qz_medium():
    n = 48
    A = random_dense(n, seed=5)
    B = random_dense(n, seed=6) + 4 * np.eye(n)
    (S, Tt, Q, Z), info = _full_qz(A, B)
    assert info == 0
    _check(A, B, S, Tt, Q, Z)


def test_qz_known_pencil():
    n = 32
    A, B, alpha, beta = known_spectrum_pencil(n, complex_ratio=0.4, seed=3)
    (S, Tt, Q, Z), info = _full_qz(A, B)
    assert info == 0
    _check(A, B, S, Tt, Q, Z)
    er, ei, bt = extract_eigenvalues_gen(jnp.array(S), jnp.array(Tt))
    er, ei, bt = map(np.asarray, (er, ei, bt))
    ev = (er + 1j * ei) / bt
    want = alpha / beta
    assert eigenvalue_error(ev, want) < 1e5


def test_qz_infinite_eigenvalues():
    n = 24
    A, B, alpha, beta = known_spectrum_pencil(
        n, complex_ratio=0.3, inf_ratio=0.2, seed=11)
    (S, Tt, Q, Z), info = _full_qz(A, B)
    assert info == 0
    _check(A, B, S, Tt, Q, Z, atol_u=5000)
    # count recovered infinite eigenvalues (zero T diagonal)
    n_inf_true = int((beta == 0).sum())
    tdiag = np.abs(np.diagonal(Tt))
    n_inf_found = int((tdiag < 1e-8 * tdiag.max()).sum())
    assert n_inf_found == n_inf_true


def test_standardize_gep_2x2_real():
    # 2x2 block with real generalized eigenvalues -> must split
    A2 = jnp.array([[2.0, 1.0], [0.5, 1.0]])
    B2 = jnp.array([[1.0, 0.3], [0.0, 2.0]])
    A2n, B2n, cl, sl, cr, sr = standardize_gep_2x2(A2, B2)
    A2n, B2n = np.asarray(A2n), np.asarray(B2n)
    import scipy.linalg
    ev = scipy.linalg.eigvals(np.asarray(A2), np.asarray(B2))
    assert np.all(np.isreal(ev))
    assert A2n[1, 0] == 0.0
    assert B2n[1, 0] == 0.0
    # eigenvalues preserved: diag ratios
    got = sorted(np.diag(A2n) / np.diag(B2n))
    np.testing.assert_allclose(sorted(ev.real), got, rtol=1e-10)
