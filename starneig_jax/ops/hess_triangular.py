"""Hessenberg-triangular reduction (GEP): (A, B) -> (H, T) = (Q^T A Z, Q^T B Z).

The reference *outsources* this step — LAPACK ``dgeqrf/dormqr/dgghd3`` in
shared memory (``src/wrappers/lapack.c:46-170``) and the bundled Fortran
``pdgghrd`` in distributed memory (``src/3rdparty/pdgghrd/``).  Here it is
implemented natively (SURVEY.md section 2.8 calls this out as a gap to
fill):

  1. B = Q0 R (QR via ``jnp.linalg.qr``), A <- Q0^T A — B triangular.
  2. Column-by-column Givens reduction of A to Hessenberg keeping B
     triangular: for each column j, bottom-up left rotations G(i-1, i)
     annihilate A[i, j]; each fills B[i, i-1], which is immediately
     annihilated by a right rotation on columns (i-1, i) — the classic
     interleaved cascade (same mathematics as dgghrd), expressed as one
     jitted double ``fori_loop`` with O(n)-wide row/column updates per
     rotation.

Round-1 performance note: the rotation loop is sequential over ~n^2/2
steps (each a vectorized O(n) update); panel-deferred cascade application
(dgghd3-style accumulation into GEMMs) is the planned optimization.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.ops import primitives as prim


@jax.jit
def _ht_reduce(A, B, Q, Z):
    """Interleaved Givens HT reduction; B must already be upper triangular."""
    n = A.shape[0]

    def col_body(j, carry):
        A, B, Q, Z = carry

        def row_body(t, carry):
            A, B, Q, Z = carry
            i = (n - 1) - t                       # bottom-up
            active = i >= j + 2

            # ---- left rotation on rows (i-1, i): zero A[i, j] ----
            c, s, _r = prim.givens(A[i - 1, j], A[i, j])
            c = jnp.where(active, c, 1.0)
            s = jnp.where(active, s, 0.0)
            ra0, ra1 = A[i - 1, :], A[i, :]
            A = A.at[i - 1, :].set(c * ra0 + s * ra1)
            A = A.at[i, :].set(-s * ra0 + c * ra1)
            A = A.at[i, j].set(jnp.where(active, 0.0, A[i, j]))
            rb0, rb1 = B[i - 1, :], B[i, :]
            B = B.at[i - 1, :].set(c * rb0 + s * rb1)
            B = B.at[i, :].set(-s * rb0 + c * rb1)
            q0, q1 = Q[:, i - 1], Q[:, i]
            Q = Q.at[:, i - 1].set(c * q0 + s * q1)
            Q = Q.at[:, i].set(-s * q0 + c * q1)

            # ---- right rotation on cols (i-1, i): zero B[i, i-1] ----
            cr, sr, _r2 = prim.givens(B[i, i], B[i, i - 1])
            cr = jnp.where(active, cr, 1.0)
            sr = jnp.where(active, sr, 0.0)
            cb0, cb1 = B[:, i - 1], B[:, i]
            B = B.at[:, i - 1].set(cr * cb0 - sr * cb1)
            B = B.at[:, i].set(sr * cb0 + cr * cb1)
            B = B.at[i, i - 1].set(jnp.where(active, 0.0, B[i, i - 1]))
            ca0, ca1 = A[:, i - 1], A[:, i]
            A = A.at[:, i - 1].set(cr * ca0 - sr * ca1)
            A = A.at[:, i].set(sr * ca0 + cr * ca1)
            z0, z1 = Z[:, i - 1], Z[:, i]
            Z = Z.at[:, i - 1].set(cr * z0 - sr * z1)
            Z = Z.at[:, i].set(sr * z0 + cr * z1)
            return A, B, Q, Z

        return lax.fori_loop(0, n - 1, row_body, (A, B, Q, Z))

    A, B, Q, Z = lax.fori_loop(0, max(n - 2, 0), col_body, (A, B, Q, Z))
    return A, B, Q, Z


def hessenberg_triangular(A, B, Q=None, Z=None):
    """Reduce (A, B) to Hessenberg-triangular form.

    Mirrors ``starneig_GEP_SM_HessenbergTriangular`` (reference:
    gep_sm.h:106-160, implemented by wrappers/lapack.c:46-170).

    Returns (H, T, Q, Z) with H = Q^T A Z upper Hessenberg and
    T = Q^T B Z upper triangular (Q/Z accumulate onto given matrices).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    n = A.shape[0]
    dtype = A.dtype
    Qin = jnp.eye(n, dtype=dtype) if Q is None else jnp.asarray(Q)
    Zin = jnp.eye(n, dtype=dtype) if Z is None else jnp.asarray(Z)

    # stage 1: B = Q0 R -> A <- Q0^T A
    Q0, R = jnp.linalg.qr(B)
    A1 = Q0.T @ A
    Q1 = Qin @ Q0
    # exact triangularity for the downstream structure checks
    R = jnp.triu(R)

    if n <= 2:
        return A1, R, Q1, Zin
    H, T, Qo, Zo = _ht_reduce(A1, R, Q1, Zin)
    # plant exact zeros below the first subdiagonal / diagonal
    H = jnp.triu(H, -1)
    T = jnp.triu(T)
    return H, T, Qo, Zo
