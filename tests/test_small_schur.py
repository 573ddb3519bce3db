"""Tests for the dense Francis QR (small_schur) against numpy/scipy oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.linalg

from starneig_jax.ops.small_schur import small_schur
from starneig_jax.ops.eigvals import extract_eigenvalues
from starneig_jax.testing import (
    random_hessenberg,
    known_spectrum_matrix,
    residual_sep,
    orthogonality,
    schur_structure_error,
)

RNG = np.random.default_rng(7)


def _solve(H, w=None):
    n = H.shape[0]
    w = w or n
    Hp = np.zeros((w, w))
    Hp[:n, :n] = H
    Z = np.eye(w)
    S, Zo, info = small_schur(jnp.array(Hp), jnp.array(Z), n)
    return np.asarray(S)[:n, :n], np.asarray(Zo)[:n, :n], int(info)


def _check_all(H, S, Q, atol_u=500, check_eigs=True):
    n = H.shape[0]
    assert schur_structure_error(S) == 0.0, "not quasi-triangular"
    res = residual_sep(H, S, Q)
    orth = orthogonality(Q)
    assert res < atol_u, f"residual {res}u"
    assert orth < atol_u, f"orthogonality {orth}u"
    if not check_eigs:
        return
    # eigenvalues match numpy
    ev_ref = np.sort_complex(np.linalg.eigvals(H))
    er, ei = extract_eigenvalues(jnp.array(S))
    ev = np.sort_complex(np.asarray(er)[:n] + 1j * np.asarray(ei)[:n])
    scale = max(np.max(np.abs(ev_ref)), 1e-300)
    np.testing.assert_allclose(ev, ev_ref, atol=1e-10 * scale)


def test_tiny_sizes():
    for n in [1, 2, 3, 4, 5]:
        H = np.triu(RNG.standard_normal((n, n)), -1)
        S, Q, info = _solve(H)
        assert info == 0
        _check_all(H, S, Q)


def test_random_hessenberg_n32():
    H = random_hessenberg(32, seed=1)
    S, Q, info = _solve(H)
    assert info == 0
    _check_all(H, S, Q)


def test_padded_window():
    H = random_hessenberg(24, seed=3)
    S, Q, info = _solve(H, w=40)
    assert info == 0
    _check_all(H, S, Q)


def test_known_spectrum():
    A, eig = known_spectrum_matrix(48, complex_ratio=0.5, seed=5, hessenberg=True)
    S, Q, info = _solve(A)
    assert info == 0
    _check_all(A, S, Q)
    er, ei = extract_eigenvalues(jnp.array(np.pad(S, ((0, 0), (0, 0)))))
    ev = np.sort_complex(np.asarray(er) + 1j * np.asarray(ei))
    np.testing.assert_allclose(ev, np.sort_complex(eig), atol=1e-9 * np.abs(eig).max())


def test_repeated_eigenvalues():
    # identity-like with clustered spectrum
    n = 16
    S0 = np.triu(RNG.standard_normal((n, n)), 1) + np.eye(n)
    Q0, _ = np.linalg.qr(RNG.standard_normal((n, n)))
    H = scipy.linalg.hessenberg(Q0 @ S0 @ Q0.T)
    S, Q, info = _solve(H)
    assert info == 0
    # a 16-fold defective eigenvalue has condition ~eps^(1/16): eigenvalue
    # comparison against the oracle is meaningless, the backward error is not.
    _check_all(H, S, Q, check_eigs=False)


def test_zero_matrix():
    n = 8
    H = np.zeros((n, n))
    S, Q, info = _solve(H)
    assert info == 0
    assert np.allclose(S, 0)
    assert np.allclose(Q, np.eye(n))


def test_larger_n128():
    H = random_hessenberg(128, seed=11)
    S, Q, info = _solve(H)
    assert info == 0
    _check_all(H, S, Q)
