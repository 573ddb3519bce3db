"""Full-chain experiments (the reference's full_chain test module,
test/misc/full_chain.c): Hessenberg -> Schur -> Select -> Reorder ->
Eigenvectors, SEP and GEP, with all hooks."""

import numpy as np
import jax.numpy as jnp

from starneig_jax.api import sep, gep
from starneig_jax.errors import Error
from starneig_jax.testing import (
    random_dense,
    residual_sep,
    residual_gep,
    orthogonality,
    schur_structure_error,
    eigenvalue_error,
)


def test_sep_full_chain():
    n = 200
    A = random_dense(n, seed=42)
    S, Q, er, ei, nsel, info = sep.reduce(A, predicate=lambda lam: lam.real > 0)
    assert info == Error.SUCCESS
    S, Q = np.asarray(S), np.asarray(Q)
    assert schur_structure_error(S) == 0.0
    assert residual_sep(A, S, Q) < 2000
    assert orthogonality(Q) < 2000
    # eigenvalues vs oracle
    ev = np.asarray(er) + 1j * np.asarray(ei)
    assert eigenvalue_error(ev, np.linalg.eigvals(A)) < 10000
    # selected eigenvalues lead
    lead = np.linalg.eigvals(S[:nsel, :nsel])
    assert np.all(lead.real > 0)
    # eigenvectors of the deflating subspace
    sel = np.zeros(n, bool)
    sel[:nsel] = True
    X, xinfo = sep.eigenvectors(S, Q, sel)
    assert xinfo == Error.SUCCESS
    X = np.asarray(X)
    assert X.shape[0] == n and X.shape[1] >= nsel


def test_gep_full_chain():
    n = 64
    A = random_dense(n, seed=7)
    B = random_dense(n, seed=8) + 3 * np.eye(n)
    S, T, Q, Z, ar, ai, bt, nsel, info = gep.reduce(
        A, B, predicate=lambda a, b: b != 0 and (a / b).real > 0)
    assert info == Error.SUCCESS
    S, T, Q, Z = map(np.asarray, (S, T, Q, Z))
    ra, rb = residual_gep(A, B, S, T, Q, Z)
    assert ra < 5000 and rb < 5000
    assert orthogonality(Q) < 5000 and orthogonality(Z) < 5000
    # selection helper coverage
    sel = gep.select(S, T, lambda a, b: b != 0 and abs(a / b) < 1.0)
    assert sel.dtype == bool and sel.shape == (n,)
    X, xinfo = gep.eigenvectors(S, T, Q, Z, np.ones(n, bool))
    assert xinfo == Error.SUCCESS
