"""Tests for the multishift QR + AED Schur driver."""

import numpy as np
import jax.numpy as jnp
import pytest

from starneig_jax.config import SchurConf
from starneig_jax.errors import Error
from starneig_jax.ops.schur import schur, standardize_blocks, status_info
from starneig_jax.testing import (
    random_hessenberg,
    known_spectrum_matrix,
    residual_sep,
    orthogonality,
    schur_structure_error,
)

RNG = np.random.default_rng(31)


def _check(H, S, Q, atol_u=2000):
    S, Q = np.asarray(S), np.asarray(Q)
    assert schur_structure_error(S) == 0.0, "not quasi-triangular"
    res = residual_sep(H, S, Q)
    orth = orthogonality(Q)
    assert res < atol_u, f"residual {res}u"
    assert orth < atol_u, f"orthogonality {orth}u"


def test_standardize_blocks():
    # build a quasi-triangular matrix with unstandardized 2x2 blocks
    n = 10
    S0 = np.triu(RNG.standard_normal((n, n)))
    S0[3, 2] = 0.5   # 2x2 block at (2,3) — complex or real depending on data
    S0[7, 6] = -0.3
    Q0 = np.eye(n)
    S1, Q1 = standardize_blocks(jnp.array(S0), jnp.array(Q0))
    S1, Q1 = np.asarray(S1), np.asarray(Q1)
    np.testing.assert_allclose(Q1 @ S1 @ Q1.T, S0, atol=1e-12 * np.abs(S0).max())
    np.testing.assert_allclose(Q1 @ Q1.T, np.eye(n), atol=1e-13)
    for i in (2, 6):
        blk = S1[i:i + 2, i:i + 2]
        if blk[1, 0] != 0:
            np.testing.assert_allclose(blk[0, 0], blk[1, 1])
            assert blk[0, 1] * blk[1, 0] < 0


@pytest.mark.parametrize("n", [40, 96])
def test_schur_small_path(n):
    # n <= small_limit: exercises the small-segment path end to end
    H = random_hessenberg(n, seed=n)
    S, Q, er, ei, info = schur(jnp.array(H))
    assert info == Error.SUCCESS
    _check(H, S, Q)
    ev = np.sort_complex(np.asarray(er) + 1j * np.asarray(ei))
    ref = np.sort_complex(np.linalg.eigvals(H))
    # random spectra contain near-degenerate pairs whose eigenvalue
    # condition number amplifies an O(n u ||A||) backward error to ~1e-8;
    # the residual check above is the strict correctness gate
    np.testing.assert_allclose(ev, ref, atol=1e-7 * (1 + np.abs(ref).max()))


def test_schur_aed_path():
    # force the AED + sweep path with a small small_limit
    n = 150
    H = random_hessenberg(n, seed=3)
    conf = SchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    S, Q, er, ei, info = schur(jnp.array(H), conf=conf)
    assert info == Error.SUCCESS
    _check(H, S, Q)
    ev = np.sort_complex(np.asarray(er) + 1j * np.asarray(ei))
    ref = np.sort_complex(np.linalg.eigvals(H))
    np.testing.assert_allclose(ev, ref, atol=1e-8 * (1 + np.abs(ref).max()))


def test_schur_known_spectrum():
    n = 120
    A, eig = known_spectrum_matrix(n, complex_ratio=0.6, seed=9, hessenberg=True)
    conf = SchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    S, Q, er, ei, info = schur(jnp.array(A), conf=conf)
    assert info == Error.SUCCESS
    _check(A, S, Q)
    ev = np.sort_complex(np.asarray(er) + 1j * np.asarray(ei))
    np.testing.assert_allclose(ev, np.sort_complex(eig),
                               atol=2e-7 * (1 + np.abs(eig).max()))


def test_schur_zero_eigenvalues():
    n = 80
    A, eig = known_spectrum_matrix(n, complex_ratio=0.3, zero_ratio=0.3,
                                   seed=13, hessenberg=True)
    conf = SchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    S, Q, er, ei, info = schur(jnp.array(A), conf=conf)
    assert info == Error.SUCCESS
    _check(A, S, Q)


def test_schur_dense_gaussian_n400():
    """Well-conditioned dense matrix through the full hessenberg+schur chain;
    matched eigenvalues must satisfy the reference's accuracy gates."""
    from starneig_jax.ops.hessenberg import hessenberg
    from starneig_jax.testing import eigenvalue_error
    n = 400
    A = RNG.standard_normal((n, n))
    H, Q = hessenberg(jnp.asarray(A))
    S, Q2, er, ei, info = schur(H, Q)
    assert info == Error.SUCCESS
    _check(A, S, Q2)
    ev = np.asarray(er) + 1j * np.asarray(ei)
    assert eigenvalue_error(ev, np.linalg.eigvals(A)) < 10000


def test_single_dispatch_did_not_converge():
    """iteration_limit=0 fails the first segment after one round: the
    one-dispatch driver returns DID_NOT_CONVERGE with a still-similar,
    partially reduced matrix (reference error.h:105-111)."""
    n = 160
    H = random_hessenberg(n, seed=5)
    S, Q, er, ei, info = schur(jnp.array(H),
                               conf=SchurConf(iteration_limit=0))
    assert info == Error.DID_NOT_CONVERGE
    S, Q = np.asarray(S), np.asarray(Q)
    assert residual_sep(H, S, Q) < 2000
    assert orthogonality(Q) < 2000
    assert schur_structure_error(S) > 0.0  # not (yet) quasi-triangular


@pytest.mark.parametrize("state, want", [
    ([0, 3, 0, 0, 41], Error.SUCCESS),
    ([17, 301, 17, 1, 90], Error.DID_NOT_CONVERGE),   # segment failed
    ([12, 2, 14, 0, 330], Error.DID_NOT_CONVERGE),    # global round cap
])
def test_status_info(state, want):
    assert status_info(np.asarray(state, np.int32)) == want
