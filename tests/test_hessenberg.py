"""Tests for the blocked Hessenberg reduction."""

import numpy as np
import jax.numpy as jnp
import pytest

from starneig_jax.config import HessenbergConf
from starneig_jax.ops.hessenberg import hessenberg
from starneig_jax.testing import (
    random_dense,
    residual_sep,
    orthogonality,
    hessenberg_structure_error,
)

RNG = np.random.default_rng(23)


def _check(A, H, Q, atol_u=500):
    assert hessenberg_structure_error(H) == 0.0
    res = residual_sep(A, H, Q)
    orth = orthogonality(Q)
    assert res < atol_u, f"residual {res}u"
    assert orth < atol_u, f"orthogonality {orth}u"
    # same eigenvalues as the original (similarity transform)
    ev0 = np.sort_complex(np.linalg.eigvals(A))
    ev1 = np.sort_complex(np.linalg.eigvals(np.asarray(H)))
    np.testing.assert_allclose(ev1, ev0, atol=1e-9 * (1 + np.abs(ev0).max()))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 33])
def test_small_sizes(n):
    A = random_dense(n, seed=n)
    H, Q = hessenberg(A)
    _check(A, np.asarray(H), np.asarray(Q))


def test_multi_panel():
    # panel width smaller than n: exercises the panel loop + clamped last panel
    n = 50
    A = random_dense(n, seed=101)
    H, Q = hessenberg(A, conf=HessenbergConf(panel_width=12))
    _check(A, np.asarray(H), np.asarray(Q))


def test_panel_exact_divide():
    n = 48
    A = random_dense(n, seed=55)
    H, Q = hessenberg(A, conf=HessenbergConf(panel_width=16))
    _check(A, np.asarray(H), np.asarray(Q))


def test_accumulate_onto_existing_q():
    n = 20
    A = random_dense(n, seed=7)
    from starneig_jax.testing.generators import random_orthogonal
    Q0 = random_orthogonal(n, seed=8)
    H, Q = hessenberg(A, Q=jnp.array(Q0))
    # Q = Q0 @ Q_hess; residual w.r.t. Q0^T A Q0 ... i.e. Q0 Q_h^T? Check:
    # H = Qh^T A Qh and returned Q = Q0 Qh, so Q H Q^T = Q0 A Q0^T? No:
    # hessenberg accumulates Q <- Q @ (I - VTV^T), so A = (Q0^{-1} Q) H (..)^T
    Qh = Q0.T @ np.asarray(Q)
    res = residual_sep(A, np.asarray(H), Qh)
    assert res < 500


def test_matches_scipy_structure():
    import scipy.linalg
    n = 24
    A = random_dense(n, seed=90)
    H, Q = hessenberg(A)
    Hs = scipy.linalg.hessenberg(A)
    # both are valid Hessenberg reductions; compare |H| profiles loosely via
    # subdiagonal magnitudes (signs/columns may differ)
    np.testing.assert_allclose(
        np.sort(np.abs(np.diagonal(np.asarray(H), -1))),
        np.sort(np.abs(np.diagonal(Hs, -1))), rtol=1e-8)


def test_partial_range_is_similarity():
    """Partial reduction must stay a similarity transform (regression: the
    panel used to zero the lower rows of unreduced columns past ``end``)."""
    import numpy as np
    import jax.numpy as jnp
    from starneig_jax.ops.hessenberg import hessenberg
    rng = np.random.default_rng(7)
    n = 150
    A = rng.standard_normal((n, n))
    H, Q = map(np.asarray, hessenberg(jnp.asarray(A), end=90))
    u = np.finfo(np.float64).eps / 2
    res = np.linalg.norm(Q @ H @ Q.T - A) / np.linalg.norm(A) / u
    assert res < 10000, res
    assert np.abs(np.tril(H[:, :88], -2)).max() == 0.0
