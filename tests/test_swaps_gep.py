"""Tests for generalized (pencil) adjacent block swaps."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg

from starneig_jax.ops.swaps_gep import swap_adjacent_gep

_swap = jax.jit(swap_adjacent_gep)
RNG = np.random.default_rng(5)


def _mk_pencil(p, q, seed=0):
    rng = np.random.default_rng(seed)
    A = np.triu(rng.standard_normal((4, 4)))
    B = np.triu(rng.standard_normal((4, 4))) + 2 * np.eye(4)
    if p == 2:
        A[1, 0] = -0.8  # complex pair block (make b*c < 0 w/ diag equal-ish)
        A[0, 0] = A[1, 1] = rng.standard_normal()
        A[0, 1] = abs(A[0, 1]) + 0.3
        A[1, 0] = -abs(A[1, 0]) - 0.3
        B[0, 1] = 0.0
    if q == 2:
        i = p
        A[i + 1, i] = -0.5
        A[i, i] = A[i + 1, i + 1] = rng.standard_normal()
        A[i, i + 1] = abs(A[i, i + 1]) + 0.3
        A[i + 1, i] = -abs(A[i + 1, i]) - 0.3
        B[i, i + 1] = 0.0
    return A, B


@pytest.mark.parametrize("p,q", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_gep_swap(p, q):
    A, B = _mk_pencil(p, q, seed=p * 7 + q)
    d = p + q
    ev_up = scipy.linalg.eigvals(A[:p, :p], B[:p, :p])
    ev_lo = scipy.linalg.eigvals(A[p:d, p:d], B[p:d, p:d])
    Qs, Zs, Ah, Bh, acc = _swap(jnp.array(A), jnp.array(B), p, q)
    Qs, Zs, Ah, Bh = map(np.asarray, (Qs, Zs, Ah, Bh))
    assert bool(acc)
    np.testing.assert_allclose(Qs.T @ Qs, np.eye(4), atol=1e-12)
    np.testing.assert_allclose(Zs.T @ Zs, np.eye(4), atol=1e-12)
    # equivalence transform holds
    np.testing.assert_allclose(Ah, Qs.T @ A @ Zs, atol=1e-11 * (1 + abs(A).max()))
    np.testing.assert_allclose(Bh, Qs.T @ B @ Zs, atol=1e-11 * (1 + abs(B).max()))
    # swapped eigenvalues
    assert np.all(Ah[q:d, :q] == 0)
    assert np.all(np.abs(np.tril(Bh[:d, :d], -1)) == 0)
    from starneig_jax.testing import eigenvalue_error
    got_up = scipy.linalg.eigvals(Ah[:q, :q], Bh[:q, :q])
    got_lo = scipy.linalg.eigvals(Ah[q:d, q:d], Bh[q:d, q:d])
    assert eigenvalue_error(got_up, ev_lo) < 1e4
    assert eigenvalue_error(got_lo, ev_up) < 1e4
