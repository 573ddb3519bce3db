"""Tests for the multishift QZ + AED driver (large-n GEP path)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg

from starneig_jax.config import SchurConf
from starneig_jax.errors import Error
from starneig_jax.ops.qz_driver import qz_schur
from starneig_jax.ops.hess_triangular import hessenberg_triangular
from starneig_jax.testing import (
    random_dense,
    residual_gep,
    orthogonality,
    schur_structure_error,
    eigenvalue_error,
)
from starneig_jax.testing.hooks import triangular_structure_error


def _run(n, seed, conf=None):
    A = random_dense(n, seed=seed)
    B = random_dense(n, seed=seed + 77) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, ar, ai, bt, info = qz_schur(H, T, Q, Z, conf=conf)
    return A, B, *map(np.asarray, (S, Tt, Qo, Zo)), \
        np.asarray(ar), np.asarray(ai), np.asarray(bt), info


def _check(A, B, S, Tt, Q, Z, atol_u=5000):
    assert schur_structure_error(S) == 0.0
    assert triangular_structure_error(Tt) == 0.0
    ra, rb = residual_gep(A, B, S, Tt, Q, Z)
    assert ra < atol_u and rb < atol_u, (ra, rb)
    assert orthogonality(Q) < atol_u and orthogonality(Z) < atol_u


def test_qz_driver_small_path():
    # whole problem below small_limit: single window solve
    A, B, S, Tt, Q, Z, ar, ai, bt, info = _run(48, seed=1)
    assert info == Error.SUCCESS
    _check(A, B, S, Tt, Q, Z)


def test_qz_driver_aed_path():
    n = 150
    conf = SchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    A, B, S, Tt, Q, Z, ar, ai, bt, info = _run(n, seed=3, conf=conf)
    assert info == Error.SUCCESS
    _check(A, B, S, Tt, Q, Z)
    ev_ref = scipy.linalg.eigvals(A, B)
    safe = np.where(np.abs(bt) < 1e-12, 1e-12, bt)
    ev = (ar + 1j * ai) / safe
    assert eigenvalue_error(ev, ev_ref) < 5e5


def test_qz_driver_inf_large_segment():
    """HT-form pencil with exact T-diagonal zeros in a segment exceeding
    every window bucket: exercises the windowed infinite-eigenvalue push
    (the reference's insert_push_inf_top capability,
    src/schur/core.c:475-562) that previously returned DID_NOT_CONVERGE.

    The input is given directly in Hessenberg-triangular form: scrambling
    by orthogonal transforms smears exact B-singularity below any
    principled detection threshold — LAPACK dhgeqz on the scrambled pencil
    recovers only ~1 of 12 planted infinities (measured via scipy.ordqz);
    detection parity is what the reference's kernel provides
    (cpu_utils.c:605 operates on detected zero T diagonals)."""
    rng = np.random.default_rng(11)
    n = 120
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    # non-adjacent zeros: adjacent pairs (a Jordan block at infinity) keep
    # their rank deficiency under the push but it leaves the diagonal —
    # LAPACK dhgeqz misclassifies those too (measured |lambda| ~ 600 via
    # scipy on the scrambled equivalent)
    inf_pos = [15, 40, 62, 77, 103]
    for j in inf_pos:
        T0[j, j] = 0.0
    conf = SchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    S, Tt, Qo, Zo, ar, ai, bt, info = qz_schur(
        jnp.asarray(H0), jnp.asarray(T0), conf=conf)
    assert info == Error.SUCCESS
    S, Tt, Qo, Zo = map(np.asarray, (S, Tt, Qo, Zo))
    _check(H0, T0, S, Tt, Qo, Zo)
    # every planted infinite eigenvalue is recovered with beta == 0 and a
    # zero diagonal in the output T
    bt_np = np.asarray(bt)
    n_inf_found = int((np.abs(bt_np) <= 1e-12 * np.abs(bt_np).max()).sum())
    assert n_inf_found >= len(inf_pos), bt_np[np.argsort(np.abs(bt_np))[:8]]


def test_qz_driver_n256_default_conf():
    """Fused-driver AED path at default geometry above the round-3 n=150
    ceiling: realistic window sizing, several rounds, device-side shift
    packing."""
    A, B, S, Tt, Q, Z, ar, ai, bt, info = _run(256, seed=9)
    assert info == Error.SUCCESS
    _check(A, B, S, Tt, Q, Z)


def test_qz_driver_n512_default_inf_rich():
    """Coverage bar: default AED geometry at
    n=512 with an infinity-rich pencil — exercises realistic window
    sizing, bucket transitions, and the windowed infinite-eigenvalue push
    at a size where none of them degenerate.  Starts from HT form
    directly (the HT reduction is exercised elsewhere; including it would
    triple the test's runtime for no added QZ coverage)."""
    n = 512
    rng = np.random.default_rng(21)
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    inf_pos = rng.choice(np.arange(1, n - 1), size=n // 10, replace=False)
    for j in inf_pos:
        T0[j, j] = 0.0
    S, Tt, Qo, Zo, ar, ai, bt, info = qz_schur(jnp.asarray(H0),
                                               jnp.asarray(T0))
    assert info == Error.SUCCESS
    S, Tt, Qo, Zo = map(np.asarray, (S, Tt, Qo, Zo))
    _check(H0, T0, S, Tt, Qo, Zo)
    # the planted infinite eigenvalues survive to beta == 0.  A dense
    # random plant can put two infinities adjacent, where one may surface
    # as a huge-but-finite eigenvalue (the LAPACK dhgeqz behavior the
    # analysis hook documents) — require 90% exact-beta-zero recovery.
    bt_np = np.asarray(bt)
    n_inf = int((np.abs(bt_np) <= 1e-12 * np.abs(bt_np).max()).sum())
    assert n_inf >= int(0.9 * len(inf_pos)), n_inf
