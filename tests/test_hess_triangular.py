"""Tests for the native Hessenberg-triangular reduction."""

import numpy as np
import jax.numpy as jnp
import pytest

from starneig_jax.ops.hess_triangular import hessenberg_triangular
from starneig_jax.testing import (
    random_dense,
    residual_gep,
    orthogonality,
    hessenberg_structure_error,
)
from starneig_jax.testing.hooks import triangular_structure_error


def _check(A, B, H, T, Q, Z, atol_u=1000):
    H, T, Q, Z = map(np.asarray, (H, T, Q, Z))
    assert hessenberg_structure_error(H) == 0.0
    assert triangular_structure_error(T) == 0.0
    ra, rb = residual_gep(A, B, H, T, Q, Z)
    assert ra < atol_u, f"A residual {ra}u"
    assert rb < atol_u, f"B residual {rb}u"
    assert orthogonality(Q) < atol_u
    assert orthogonality(Z) < atol_u
    # generalized eigenvalues preserved
    ev0 = np.sort_complex(np.linalg.eigvals(np.linalg.solve(B, A)))
    ev1 = np.sort_complex(np.linalg.eigvals(np.linalg.solve(T, H)))
    np.testing.assert_allclose(ev1, ev0, rtol=1e-6,
                               atol=1e-8 * (1 + np.abs(ev0).max()))


@pytest.mark.parametrize("n", [2, 3, 8, 24])
def test_ht_sizes(n):
    A = random_dense(n, seed=n)
    B = random_dense(n, seed=n + 100) + 3 * np.eye(n)  # well-conditioned B
    H, T, Q, Z = hessenberg_triangular(A, B)
    _check(A, B, H, T, Q, Z)


def test_ht_larger():
    n = 64
    A = random_dense(n, seed=7)
    B = random_dense(n, seed=8) + 4 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    _check(A, B, H, T, Q, Z)


def test_ht_matches_scipy():
    import scipy.linalg
    n = 20
    A = random_dense(n, seed=2)
    B = random_dense(n, seed=3) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    # scipy.qz gives full QZ; compare generalized eigenvalues instead of form
    # (greedy matching: sort_complex misorders conjugate pairs whose real
    # parts differ only in the last ulp)
    from starneig_jax.testing import eigenvalue_error
    ev_scipy = scipy.linalg.eigvals(A, B)
    ev_ours = scipy.linalg.eigvals(np.asarray(H), np.asarray(T))
    assert eigenvalue_error(ev_ours, ev_scipy) < 1000
