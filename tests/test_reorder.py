"""Tests for eigenvalue reordering (ReorderSchur equivalent)."""

import numpy as np
import jax.numpy as jnp
import pytest

from starneig_jax.config import ReorderConf
from starneig_jax.errors import Error
from starneig_jax.ops.reorder import reorder_schur
from starneig_jax.ops.small_schur import small_schur
from starneig_jax.ops.eigvals import extract_eigenvalues
from starneig_jax.testing import (
    random_hessenberg,
    residual_sep,
    orthogonality,
    schur_structure_error,
)

RNG = np.random.default_rng(17)


def _make_schur(n, seed=0):
    H = random_hessenberg(n, seed=seed)
    S, Q, info = small_schur(jnp.array(H), jnp.eye(n), n)
    assert int(info) == 0
    return np.asarray(S), np.asarray(Q), H


def _eigs(S):
    er, ei = extract_eigenvalues(jnp.asarray(S))
    return np.asarray(er) + 1j * np.asarray(ei)


def _run_and_check(n, seed, select_fn, conf=None, atol_u=2000):
    S0, Q0, H = _make_schur(n, seed)
    ev0 = _eigs(S0)
    select = select_fn(ev0)
    S1, Q1, m, info = reorder_schur(S0, Q0, select, conf)
    S1, Q1 = np.asarray(S1), np.asarray(Q1)
    assert schur_structure_error(S1) == 0.0
    res = residual_sep(H, S1, Q1)
    orth = orthogonality(Q1)
    assert res < atol_u, f"residual {res}u"
    assert orth < atol_u, f"orthogonality {orth}u"
    return S0, S1, m, info, select, ev0


def _check_leading(S1, m, select, ev0, rtol=1e-8):
    """The leading m x m block must hold exactly the selected eigenvalues."""
    lead = _eigs(S1[:m, :m].copy()) if m else np.array([], complex)
    want = ev0[select]
    assert len(lead) == len(want)
    np.testing.assert_allclose(
        np.sort_complex(lead), np.sort_complex(want),
        rtol=rtol, atol=1e-9 * (1 + np.abs(ev0).max()))


@pytest.mark.parametrize("n", [8, 24])
def test_reorder_small(n):
    def pick(ev):
        sel = np.zeros(n, bool)
        sel[ev.real > np.median(ev.real)] = True
        return sel
    S0, S1, m, info, select, ev0 = _run_and_check(n, seed=n, select_fn=pick)
    assert info == Error.SUCCESS
    # block-aligned selection count
    _check_leading(S1, m, _aligned(select, S0), ev0)


def _aligned(select, S0):
    sub = np.diagonal(S0, -1)
    sel = select.copy()
    i = 0
    n = len(sel)
    while i < n - 1:
        if i < len(sub) and sub[i] != 0:
            v = sel[i] or sel[i + 1]
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            i += 1
    return sel


def test_reorder_none_selected():
    S0, Q0, H = _make_schur(10, seed=2)
    S1, Q1, m, info = reorder_schur(S0, Q0, np.zeros(10, bool))
    assert m == 0 and info == Error.SUCCESS
    np.testing.assert_allclose(np.asarray(S1), S0)


def test_reorder_all_selected():
    S0, Q0, H = _make_schur(10, seed=3)
    S1, Q1, m, info = reorder_schur(S0, Q0, np.ones(10, bool))
    assert m == 10 and info == Error.SUCCESS
    np.testing.assert_allclose(np.asarray(S1), S0)


def test_reorder_single_bottom():
    # select only the trailing eigenvalue: maximal travel distance
    n = 16

    def pick(ev):
        sel = np.zeros(n, bool)
        sel[-1] = True
        return sel

    S0, S1, m, info, select, ev0 = _run_and_check(n, seed=5, select_fn=pick)
    assert info == Error.SUCCESS
    _check_leading(S1, m, _aligned(select, S0), ev0)


def test_reorder_windowed_large():
    # n larger than the window size: exercises window chaining + carries
    n = 96
    conf = ReorderConf(window_size=24)

    def pick(ev):
        rng = np.random.default_rng(42)
        return rng.random(n) < 0.35

    S0, S1, m, info, select, ev0 = _run_and_check(n, seed=7, select_fn=pick, conf=conf)
    assert info == Error.SUCCESS
    _check_leading(S1, m, _aligned(select, S0), ev0)


def test_reorder_complex_pairs_travel():
    # heavy complex-pair content and clustered selection at the bottom
    n = 48
    conf = ReorderConf(window_size=16)

    def pick(ev):
        sel = np.zeros(n, bool)
        sel[n // 2:] = True
        return sel

    S0, S1, m, info, select, ev0 = _run_and_check(n, seed=11, select_fn=pick, conf=conf)
    assert info == Error.SUCCESS
    _check_leading(S1, m, _aligned(select, S0), ev0)


def test_reorder_parallel_matches():
    from starneig_jax.ops.reorder import reorder_schur_parallel
    n = 96
    S0, Q0, H = _make_schur(n, seed=31)
    ev0 = _eigs(S0)
    select = np.random.default_rng(5).random(n) < 0.3
    S1, Q1, m, info = reorder_schur_parallel(S0, Q0, select,
                                             ReorderConf(window_size=24))
    S1, Q1 = np.asarray(S1), np.asarray(Q1)
    assert schur_structure_error(S1) == 0.0
    assert residual_sep(H, S1, Q1) < 3000
    assert orthogonality(Q1) < 3000
    _check_leading(S1, m, _aligned(select, S0), ev0)
