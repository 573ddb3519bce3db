"""Tests for adjacent diagonal-block swaps (dlaexc equivalent)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from starneig_jax.ops.swaps import swap_adjacent

_swap = jax.jit(swap_adjacent)
RNG = np.random.default_rng(3)


def _mk_block(p, vals=None, seed=0):
    """A p x p diagonal block: 1x1 scalar or standardized 2x2 complex pair."""
    rng = np.random.default_rng(seed)
    if p == 1:
        return np.array([[vals if vals is not None else rng.standard_normal()]])
    a = rng.standard_normal()
    b = np.abs(rng.standard_normal()) + 0.2
    c = -(np.abs(rng.standard_normal()) + 0.2)
    return np.array([[a, b], [c, a]])


def _mk_D4(p, q, seed=0):
    rng = np.random.default_rng(seed + 100)
    D = rng.standard_normal((4, 4))
    D = np.triu(D)
    D[:p, :p] = _mk_block(p, seed=seed)
    D[p:p + q, p:p + q] = _mk_block(q, seed=seed + 1)
    # zero the sub-block couplings
    D[p:p + q, :p] = 0
    D[p + q:, :p + q] = 0
    return D


@pytest.mark.parametrize("p,q", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_swap_sizes(p, q):
    D = _mk_D4(p, q, seed=p * 10 + q)
    d = p + q
    ev_upper = np.linalg.eigvals(D[:p, :p])
    ev_lower = np.linalg.eigvals(D[p:d, p:d])
    Q, Dh, accept = _swap(jnp.array(D), p, q)
    Q, Dh = np.asarray(Q), np.asarray(Dh)
    assert bool(accept)
    # orthogonal, identity outside leading d
    np.testing.assert_allclose(Q.T @ Q, np.eye(4), atol=1e-13)
    np.testing.assert_allclose(Q[d:, :d], 0, atol=1e-13)
    np.testing.assert_allclose(Q[:d, d:], 0, atol=1e-13)
    # similarity holds
    np.testing.assert_allclose(Dh, Q.T @ D @ Q, atol=1e-12 * (1 + np.abs(D).max()))
    # block structure: (2,1) zero, eigenvalues swapped
    assert np.all(Dh[q:d, :q] == 0)
    np.testing.assert_allclose(
        np.sort_complex(np.linalg.eigvals(Dh[:q, :q])),
        np.sort_complex(ev_lower), atol=1e-10)
    np.testing.assert_allclose(
        np.sort_complex(np.linalg.eigvals(Dh[q:d, q:d])),
        np.sort_complex(ev_upper), atol=1e-10)


def test_swap_11_equal_eigenvalues():
    # t11 == t22: rotation path must not blow up
    D = np.triu(RNG.standard_normal((4, 4)))
    D[0, 0] = D[1, 1] = 1.5
    Q, Dh, accept = _swap(jnp.array(D), 1, 1)
    assert bool(accept)
    np.testing.assert_allclose(np.asarray(Q).T @ np.asarray(Q), np.eye(4), atol=1e-13)


def test_swap_2x2_standardized_output():
    D = _mk_D4(2, 2, seed=9)
    Q, Dh, accept = _swap(jnp.array(D), 2, 2)
    Dh = np.asarray(Dh)
    assert bool(accept)
    # new blocks are standardized: equal diagonals, opposite-sign off-diagonals
    for off in (0, 2):
        blk = Dh[off:off + 2, off:off + 2]
        if blk[1, 0] != 0:
            np.testing.assert_allclose(blk[0, 0], blk[1, 1], rtol=1e-12)
            assert blk[0, 1] * blk[1, 0] < 0


def test_swap_rejects_or_succeeds_near_identical_pairs():
    # nearly identical 2x2 blocks: swap is ill-conditioned; must either
    # succeed with small backward error or be rejected cleanly
    blk = _mk_block(2, seed=4)
    D = np.triu(RNG.standard_normal((4, 4))) * 1e-8
    D[:2, :2] = blk
    D[2:, 2:] = blk + 1e-13 * RNG.standard_normal((2, 2))
    D[2:, :2] = 0
    Q, Dh, accept = _swap(jnp.array(D), 2, 2)
    Q, Dh = np.asarray(Q), np.asarray(Dh)
    if bool(accept):
        err = np.abs(Q.T @ D @ Q - Dh).max()
        assert err < 1e-10
    else:
        np.testing.assert_allclose(Q, np.eye(4))
        np.testing.assert_allclose(Dh, D)
