"""Tests for generalized (pencil) eigenvalue reordering."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg

from starneig_jax.config import ReorderConf
from starneig_jax.errors import Error
from starneig_jax.ops.reorder import reorder_schur_gep
from starneig_jax.ops.hess_triangular import hessenberg_triangular
from starneig_jax.ops.qz import small_qz
from starneig_jax.ops.eigvals import extract_eigenvalues_gen
from starneig_jax.testing import (
    random_dense,
    residual_gep,
    orthogonality,
    schur_structure_error,
    eigenvalue_error,
)
from starneig_jax.testing.hooks import triangular_structure_error

RNG = np.random.default_rng(55)


def _make_gen_schur(n, seed):
    A = random_dense(n, seed=seed)
    B = random_dense(n, seed=seed + 1000) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, info = small_qz(H, T, Q, Z, n)
    assert int(info) == 0
    return A, B, *map(np.asarray, (S, Tt, Qo, Zo))


def _eigs(S, Tt):
    er, ei, bt = extract_eigenvalues_gen(jnp.asarray(S), jnp.asarray(Tt))
    er, ei, bt = map(np.asarray, (er, ei, bt))
    bt = np.where(bt == 0, 1e-300, bt)
    return (er + 1j * ei) / bt


@pytest.mark.parametrize("n", [8, 24])
def test_reorder_gep(n):
    A, B, S, Tt, Q, Z = _make_gen_schur(n, seed=n)
    ev = _eigs(S, Tt)
    sel = ev.real > np.median(ev.real)
    S2, T2, Q2, Z2, m, info = reorder_schur_gep(S, Tt, Q, Z, sel)
    S2, T2, Q2, Z2 = map(np.asarray, (S2, T2, Q2, Z2))
    assert info == Error.SUCCESS
    assert schur_structure_error(S2) == 0.0
    assert triangular_structure_error(T2) == 0.0
    ra, rb = residual_gep(A, B, S2, T2, Q2, Z2)
    assert ra < 5000 and rb < 5000, (ra, rb)
    assert orthogonality(Q2) < 5000 and orthogonality(Z2) < 5000
    # leading block holds the selected eigenvalues
    lead = scipy.linalg.eigvals(S2[:m, :m], T2[:m, :m])
    want = ev[sel]
    if len(lead) == len(want):
        assert eigenvalue_error(lead, want) < 1e6


def test_reorder_gep_windowed():
    n = 48
    A, B, S, Tt, Q, Z = _make_gen_schur(n, seed=3)
    ev = _eigs(S, Tt)
    sel = RNG.random(n) < 0.3
    S2, T2, Q2, Z2, m, info = reorder_schur_gep(
        S, Tt, Q, Z, sel, ReorderConf(window_size=16))
    S2, T2, Q2, Z2 = map(np.asarray, (S2, T2, Q2, Z2))
    ra, rb = residual_gep(A, B, S2, T2, Q2, Z2)
    assert ra < 10000 and rb < 10000, (ra, rb)
    assert schur_structure_error(S2) == 0.0
    assert triangular_structure_error(T2) == 0.0
