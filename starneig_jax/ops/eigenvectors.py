"""Eigenvectors from a real Schur form (SEP): overflow-guarded backsolve.

JAX rebuild of the reference standard eigenvector component
(``src/eigenvectors/standard/``, SURVEY.md section 2.5): for each selected
eigenvalue, solve (S - lambda I) y = 0 by backward substitution over the
quasi-triangular S, then backtransform X = Q Y as one GEMM.

Design: the reference tiles the backsolve into bound/solve/update tasks with
per-tile scaling factors (robust.h:185-381); here each eigenvector's
backward recurrence is one masked ``lax.fori_loop`` and all selected
eigenvectors run *simultaneously* via ``vmap`` — the per-step work becomes a
batched dot across the whole eigenvector block (vectorized), which is
the level-3 reformulation of the same algorithm.  Overflow protection:
small-denominator guards (smlnum floors, as in LAPACK dtrevc) plus periodic
rescaling of growing columns; vectors are normalized at the end.

Output convention (LAPACK/dtrevc style, matching the reference's
``starneig_SEP_SM_Eigenvectors`` sep_sm.h:229-527): one real column per real
eigenvalue; a selected complex pair contributes two consecutive columns
(real part, imaginary part) for the eigenvalue with positive imaginary part.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.config import EigenvectorsConf
from starneig_jax.errors import Error


def _cdiv(ar, ai, br, bi, guard):
    """Complex division (ar+i*ai)/(br+i*bi), Smith's algorithm, guarded."""
    babs = jnp.abs(br) + jnp.abs(bi)
    scale = jnp.where(babs < guard, guard, 0.0)
    br = br + jnp.where(babs < guard, scale, 0.0)
    big = jnp.abs(br) >= jnp.abs(bi)
    # |br| >= |bi| branch
    r1 = bi / jnp.where(br == 0, 1.0, br)
    den1 = br + bi * r1
    den1 = jnp.where(den1 == 0, guard, den1)
    xr1 = (ar + ai * r1) / den1
    xi1 = (ai - ar * r1) / den1
    # |bi| > |br| branch
    r2 = br / jnp.where(bi == 0, 1.0, bi)
    den2 = bi + br * r2
    den2 = jnp.where(den2 == 0, guard, den2)
    xr2 = (ar * r2 + ai) / den2
    xi2 = (ai * r2 - ar) / den2
    return jnp.where(big, xr1, xr2), jnp.where(big, xi1, xi2)


@jax.jit
def _backsolve_all(S, lam_r, lam_i, pos, is_pair, valid):
    """Backward substitution for a batch of eigenvalues (vmapped).

    Robustness (the reference's per-tile scaling-factor machinery,
    src/eigenvectors/standard/robust.h:185-381, recast per column):

      * every column carries a running scaling factor applied whenever a
        division would overflow — before computing x[k] = rhs / d, the
        column is rescaled by (|d| * Omega) / |rhs| if |rhs| exceeds the
        growth bound |d| * Omega (Omega sized so the next row-dot cannot
        overflow either);
      * near-singular shifted diagonals |S[k,k] - lambda| < smin are
        perturbed to smin and flagged — the reference's
        STARNEIG_CLOSE_EIGENVALUES condition
        (src/eigenvectors/standard/interface.c:57-88).

    Args:
      S: (n, n) real Schur form.
      lam_r, lam_i: (m,) eigenvalues (lam_i > 0 for pairs).
      pos: (m,) block start positions.
      is_pair, valid: (m,) bool flags.

    Returns:
      (xr, xi, close): (m, n) normalized eigenvector parts and an (m,)
      close-eigenvalues flag per column.
    """
    n = S.shape[0]
    dtype = S.dtype
    smlnum = jnp.finfo(dtype).tiny / jnp.finfo(dtype).eps
    ulp = jnp.finfo(dtype).eps
    snorm = jnp.max(jnp.abs(S)) + smlnum
    # growth bound: keep max|x| below Omega so the row dot n*snorm*|x|
    # stays far from the overflow threshold
    omega = jnp.finfo(dtype).max / (16.0 * n) / snorm
    sub = jnp.concatenate([jnp.diagonal(S, offset=-1), jnp.zeros((1,), dtype)])
    rows = jnp.arange(n)

    def one(lr, li, p, pair):
        smin = jnp.maximum(ulp * (jnp.abs(lr) + jnp.abs(li)), smlnum)
        # initial entries at the eigenvalue's own block
        xr = jnp.zeros(n, dtype)
        xi = jnp.zeros(n, dtype)
        b12 = S[p, jnp.minimum(p + 1, n - 1)]
        xr = xr.at[p].set(jnp.where(pair, b12, 1.0))
        xi = xi.at[jnp.minimum(p + 1, n - 1)].add(jnp.where(pair, li, 0.0))

        def step(t, carry):
            xr, xi, close = carry
            k = n - 2 - t
            in_range = (k >= 0) & (k < p)
            is_second = jnp.where(k >= 1, sub[jnp.maximum(k - 1, 0)] != 0, False)
            top2 = sub[jnp.maximum(k, 0)] != 0   # 2x2 block at (k, k+1)
            do_1 = in_range & ~is_second & ~top2
            do_2 = in_range & ~is_second & top2

            mask_k = (rows > k).astype(dtype)
            rhs_r = -jnp.dot(S[k] * mask_k, xr)
            rhs_i = -jnp.dot(S[k] * mask_k, xi)

            # --- 1x1: x[k] = rhs / (S[k,k] - lambda), protected ---
            d_r = S[k, k] - lr
            d_i = -li
            dabs = jnp.abs(d_r) + jnp.abs(d_i)
            near = do_1 & (dabs < smin)
            d_r = jnp.where(near, smin, d_r)
            d_i = jnp.where(near, 0.0, d_i)
            dabs = jnp.maximum(dabs, smin)
            close = close | near
            # scale the column before a growing division (robust.h's
            # protect_update: solve only after the bound admits it)
            rabs = jnp.abs(rhs_r) + jnp.abs(rhs_i)
            fac1 = jnp.where(do_1 & (rabs > dabs * omega),
                             dabs * omega / jnp.maximum(rabs, smlnum), 1.0)
            xr, xi = xr * fac1, xi * fac1
            vr, vi = _cdiv(rhs_r * fac1, rhs_i * fac1, d_r, d_i, smlnum)
            xr = jnp.where(do_1, xr.at[k].set(vr), xr)
            xi = jnp.where(do_1, xi.at[k].set(vi), xi)

            # --- 2x2 block rows (k, k+1): solve the complex 2x2 system ---
            k1 = jnp.minimum(k + 1, n - 1)
            mask_k1 = (rows > k1).astype(dtype)
            rhs2_r = -jnp.dot(S[k1] * mask_k1, xr)
            rhs2_i = -jnp.dot(S[k1] * mask_k1, xi)
            m11r, m11i = S[k, k] - lr, -li
            m22r, m22i = S[k1, k1] - lr, -li
            m12 = S[k, k1]
            m21 = S[k1, k]
            # det = m11*m22 - m12*m21 (complex)
            detr = m11r * m22r - m11i * m22i - m12 * m21
            deti = m11r * m22i + m11i * m22r
            detabs = jnp.abs(detr) + jnp.abs(deti)
            blkscale = jnp.abs(m11r) + jnp.abs(m11i) + jnp.abs(m12) + \
                jnp.abs(m21) + jnp.abs(m22r) + jnp.abs(m22i) + smin
            near2 = do_2 & (detabs < smin * blkscale)
            detr = jnp.where(near2, smin * blkscale, detr)
            deti = jnp.where(near2, 0.0, deti)
            detabs = jnp.maximum(detabs, smin * blkscale)
            close = close | near2
            # x_k = (m22*r1 - m12*r2)/det ; x_k1 = (m11*r2 - m21*r1)/det
            n1r = m22r * rhs_r - m22i * rhs_i - m12 * rhs2_r
            n1i = m22r * rhs_i + m22i * rhs_r - m12 * rhs2_i
            n2r = m11r * rhs2_r - m11i * rhs2_i - m21 * rhs_r
            n2i = m11r * rhs2_i + m11i * rhs2_r - m21 * rhs_i
            nmax = jnp.maximum(jnp.abs(n1r) + jnp.abs(n1i),
                               jnp.abs(n2r) + jnp.abs(n2i))
            fac2 = jnp.where(do_2 & (nmax > detabs * omega),
                             detabs * omega / jnp.maximum(nmax, smlnum), 1.0)
            xr, xi = xr * fac2, xi * fac2
            w1r, w1i = _cdiv(n1r * fac2, n1i * fac2, detr, deti, smlnum)
            w2r, w2i = _cdiv(n2r * fac2, n2i * fac2, detr, deti, smlnum)
            xr = jnp.where(do_2, xr.at[k].set(w1r).at[k1].set(w2r), xr)
            xi = jnp.where(do_2, xi.at[k].set(w1i).at[k1].set(w2i), xi)
            return xr, xi, close

        xr, xi, close = lax.fori_loop(0, n - 1, step,
                                      (xr, xi, jnp.bool_(False)))
        mx = jnp.maximum(jnp.max(jnp.abs(xr)), jnp.max(jnp.abs(xi)))
        mx = jnp.where(mx == 0, 1.0, mx)
        xr, xi = xr / mx, xi / mx   # safe two-stage normalization
        nrm = jnp.sqrt(jnp.sum(xr * xr) + jnp.sum(xi * xi))
        nrm = jnp.where(nrm == 0, 1.0, nrm)
        return xr / nrm, xi / nrm, close

    xr, xi, close = jax.vmap(one)(lam_r, lam_i, pos, is_pair)
    xr = jnp.where(valid[:, None], xr, 0.0)
    xi = jnp.where(valid[:, None], xi, 0.0)
    return xr, xi, close & valid


@jax.jit
def _backtransform(Q, Y):
    return Q @ Y


def eigenvectors_schur(S, Q, select, conf: Optional[EigenvectorsConf] = None):
    """Eigenvectors of the matrix A = Q S Q^T for selected eigenvalues.

    Mirrors ``starneig_SEP_SM_Eigenvectors`` (reference: sep_sm.h:229-527).

    Args:
      S: (n, n) real Schur form.
      Q: (n, n) orthogonal matrix (A = Q S Q^T).
      select: (n,) bool array, 2x2 blocks selected atomically.

    Returns:
      (X, info): X is (n, ncols) with one column per selected real
      eigenvalue and (Re, Im) column pairs per selected complex pair.
    """
    S = jnp.asarray(S)
    Q = jnp.asarray(Q)
    n = S.shape[0]
    select = np.asarray(select, bool)
    sub = np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]])
    diag = np.asarray(jnp.diagonal(S))
    sup = np.concatenate([np.asarray(jnp.diagonal(S, offset=1)), [0.0]])

    # collect selected blocks on host
    entries = []  # (pos, is_pair, lam_r, lam_i)
    i = 0
    while i < n:
        if sub[i] != 0:  # 2x2 block (i, i+1)
            if select[i] or select[i + 1]:
                lr = 0.5 * (diag[i] + diag[i + 1])
                li = np.sqrt(np.abs(sup[i])) * np.sqrt(np.abs(sub[i]))
                entries.append((i, True, lr, li))
            i += 2
        else:
            if select[i]:
                entries.append((i, False, diag[i], 0.0))
            i += 1

    ncols = sum(2 if e[1] else 1 for e in entries)
    if ncols == 0:
        return jnp.zeros((n, 0), S.dtype), Error.SUCCESS

    m = len(entries)
    mp = max(8, int(np.ceil(m / 8.0)) * 8)  # pad batch to bucketed size
    pos = np.zeros(mp, np.int32)
    is_pair = np.zeros(mp, bool)
    lam_r = np.zeros(mp)
    lam_i = np.zeros(mp)
    valid = np.zeros(mp, bool)
    for j, (p, pr, lr, li) in enumerate(entries):
        pos[j], is_pair[j], lam_r[j], lam_i[j], valid[j] = p, pr, lr, li, True

    xr, xi, close = _backsolve_all(S, jnp.asarray(lam_r), jnp.asarray(lam_i),
                                   jnp.asarray(pos), jnp.asarray(is_pair),
                                   jnp.asarray(valid))
    xr = np.asarray(xr)
    xi = np.asarray(xi)

    Y = np.zeros((n, ncols))
    c = 0
    for j, (p, pr, lr, li) in enumerate(entries):
        if pr:
            Y[:, c] = xr[j]
            Y[:, c + 1] = xi[j]
            c += 2
        else:
            Y[:, c] = xr[j]
            c += 1
    X = _backtransform(Q, jnp.asarray(Y))
    # close-eigenvalue warning (reference: interface.c:57-88 + error.h:122)
    info = Error.CLOSE_EIGENVALUES if bool(np.asarray(close).any()) \
        else Error.SUCCESS
    return X, info


# ===========================================================================
# generalized (pencil) eigenvectors — reference src/eigenvectors/generalized/
# (the "sinew" robust solve, sirobust-geig.c:760); here the same backward
# substitution on (beta*S - alpha*T) x = 0, vmapped over eigenvalues, with
# infinite eigenvalues (beta == 0) handled by the same recurrence.
# ===========================================================================

@jax.jit
def _backsolve_all_gep(S, T, ar, ai, bt, pos, is_pair, valid):
    """Backward substitution for (beta*S - alpha*T) x = 0, batched.

    alpha = ar + i*ai, beta = bt (real; the pair case carries the complex
    alpha of the eigenvalue with positive imaginary part).
    """
    n = S.shape[0]
    dtype = S.dtype
    smlnum = jnp.finfo(dtype).tiny / jnp.finfo(dtype).eps
    ulp = jnp.finfo(dtype).eps
    pnorm = jnp.max(jnp.abs(S)) + jnp.max(jnp.abs(T)) + smlnum
    omega = jnp.finfo(dtype).max / (16.0 * n) / pnorm
    sub = jnp.concatenate([jnp.diagonal(S, offset=-1), jnp.zeros((1,), dtype)])
    rows = jnp.arange(n)

    def one(lr, li, b, p, pair):
        # M = b*S - (lr + i*li)*T ; solve M x = 0 with x supported on [0, p+1]
        xr = jnp.zeros(n, dtype)
        xi = jnp.zeros(n, dtype)
        # starting vector from the eigenvalue's own block
        s12 = S[p, jnp.minimum(p + 1, n - 1)]
        t12 = T[p, jnp.minimum(p + 1, n - 1)]
        # pair: null vector of the (singular) 2x2 of M at (p, p+1); pick the
        # row with the larger magnitude for robustness
        k1p = jnp.minimum(p + 1, n - 1)
        m11r = b * S[p, p] - lr * T[p, p]
        m11i = -li * T[p, p]
        m12r = b * s12 - lr * t12
        m12i = -li * t12
        m21r = b * S[k1p, p]
        m21i = 0.0 * m21r
        m22r = b * S[k1p, k1p] - lr * T[k1p, k1p]
        m22i = -li * T[k1p, k1p]
        row0 = m11r * m11r + m11i * m11i + m12r * m12r + m12i * m12i
        row1 = m21r * m21r + m22r * m22r + m22i * m22i
        use0 = row0 >= row1
        # null of row0: [-m12, m11]; null of row1: [m22, -m21]
        w0r = jnp.where(use0, -m12r, m22r)
        w0i = jnp.where(use0, -m12i, m22i)
        w1r = jnp.where(use0, m11r, -m21r)
        w1i = jnp.where(use0, m11i, -m21i)
        xr = xr.at[p].set(jnp.where(pair, w0r, 1.0))
        xi = xi.at[p].set(jnp.where(pair, w0i, 0.0))
        xr = xr.at[k1p].add(jnp.where(pair, w1r, 0.0))
        xi = xi.at[k1p].add(jnp.where(pair, w1i, 0.0))

        def mrow(k):
            return (b * S[k] - lr * T[k], -li * T[k])

        smin = jnp.maximum(
            ulp * (jnp.abs(lr) + jnp.abs(li) + jnp.abs(b)), smlnum)

        def step(t, carry):
            xr, xi, close = carry
            k = n - 2 - t
            in_range = (k >= 0) & (k < p)
            is_second = jnp.where(k >= 1, sub[jnp.maximum(k - 1, 0)] != 0, False)
            top2 = sub[jnp.maximum(k, 0)] != 0
            do_1 = in_range & ~is_second & ~top2
            do_2 = in_range & ~is_second & top2

            mkr, mki = mrow(k)
            mask_k = (rows > k).astype(dtype)
            rhs_r = -(jnp.dot(mkr * mask_k, xr) - jnp.dot(mki * mask_k, xi))
            rhs_i = -(jnp.dot(mkr * mask_k, xi) + jnp.dot(mki * mask_k, xr))

            # 1x1 with the robust.h protections (perturb near-singular
            # diagonal + scale the column before a growing division)
            d_r = b * S[k, k] - lr * T[k, k]
            d_i = -li * T[k, k]
            dabs = jnp.abs(d_r) + jnp.abs(d_i)
            near = do_1 & (dabs < smin)
            d_r = jnp.where(near, smin, d_r)
            d_i = jnp.where(near, 0.0, d_i)
            dabs = jnp.maximum(dabs, smin)
            close = close | near
            rabs = jnp.abs(rhs_r) + jnp.abs(rhs_i)
            fac1 = jnp.where(do_1 & (rabs > dabs * omega),
                             dabs * omega / jnp.maximum(rabs, smlnum), 1.0)
            xr, xi = xr * fac1, xi * fac1
            vr, vi = _cdiv(rhs_r * fac1, rhs_i * fac1, d_r, d_i, smlnum)
            xr = jnp.where(do_1, xr.at[k].set(vr), xr)
            xi = jnp.where(do_1, xi.at[k].set(vi), xi)

            # 2x2 block rows (k, k+1)
            k1 = jnp.minimum(k + 1, n - 1)
            mk1r, mk1i = mrow(k1)
            mask_k1 = (rows > k1).astype(dtype)
            rhs2_r = -(jnp.dot(mk1r * mask_k1, xr) - jnp.dot(mk1i * mask_k1, xi))
            rhs2_i = -(jnp.dot(mk1r * mask_k1, xi) + jnp.dot(mk1i * mask_k1, xr))
            a11r, a11i = b * S[k, k] - lr * T[k, k], -li * T[k, k]
            a12r, a12i = b * S[k, k1] - lr * T[k, k1], -li * T[k, k1]
            a21r, a21i = b * S[k1, k] - lr * T[k1, k], -li * T[k1, k]
            a22r, a22i = b * S[k1, k1] - lr * T[k1, k1], -li * T[k1, k1]
            detr = a11r * a22r - a11i * a22i - (a12r * a21r - a12i * a21i)
            deti = a11r * a22i + a11i * a22r - (a12r * a21i + a12i * a21r)
            detabs = jnp.abs(detr) + jnp.abs(deti)
            blkscale = jnp.abs(a11r) + jnp.abs(a11i) + jnp.abs(a12r) + \
                jnp.abs(a12i) + jnp.abs(a21r) + jnp.abs(a21i) + \
                jnp.abs(a22r) + jnp.abs(a22i) + smin
            near2 = do_2 & (detabs < smin * blkscale)
            detr = jnp.where(near2, smin * blkscale, detr)
            deti = jnp.where(near2, 0.0, deti)
            detabs = jnp.maximum(detabs, smin * blkscale)
            close = close | near2
            n1r = a22r * rhs_r - a22i * rhs_i - (a12r * rhs2_r - a12i * rhs2_i)
            n1i = a22r * rhs_i + a22i * rhs_r - (a12r * rhs2_i + a12i * rhs2_r)
            n2r = a11r * rhs2_r - a11i * rhs2_i - (a21r * rhs_r - a21i * rhs_i)
            n2i = a11r * rhs2_i + a11i * rhs2_r - (a21r * rhs_i + a21i * rhs_r)
            nmax = jnp.maximum(jnp.abs(n1r) + jnp.abs(n1i),
                               jnp.abs(n2r) + jnp.abs(n2i))
            fac2 = jnp.where(do_2 & (nmax > detabs * omega),
                             detabs * omega / jnp.maximum(nmax, smlnum), 1.0)
            xr, xi = xr * fac2, xi * fac2
            w1r, w1i = _cdiv(n1r * fac2, n1i * fac2, detr, deti, smlnum)
            w2r, w2i = _cdiv(n2r * fac2, n2i * fac2, detr, deti, smlnum)
            xr = jnp.where(do_2, xr.at[k].set(w1r).at[k1].set(w2r), xr)
            xi = jnp.where(do_2, xi.at[k].set(w1i).at[k1].set(w2i), xi)
            return xr, xi, close

        xr, xi, close = lax.fori_loop(0, n - 1, step,
                                      (xr, xi, jnp.bool_(False)))
        mx = jnp.maximum(jnp.max(jnp.abs(xr)), jnp.max(jnp.abs(xi)))
        mx = jnp.where(mx == 0, 1.0, mx)
        xr, xi = xr / mx, xi / mx
        nrm = jnp.sqrt(jnp.sum(xr * xr) + jnp.sum(xi * xi))
        nrm = jnp.where(nrm == 0, 1.0, nrm)
        return xr / nrm, xi / nrm, close

    xr, xi, close = jax.vmap(one)(ar, ai, bt, pos, is_pair)
    xr = jnp.where(valid[:, None], xr, 0.0)
    xi = jnp.where(valid[:, None], xi, 0.0)
    return xr, xi, close & valid


def eigenvectors_schur_gep(S, T, Q, Z, select,
                           conf: Optional[EigenvectorsConf] = None):
    """Right eigenvectors of the pencil (A, B) = (Q S Z^T, Q T Z^T).

    Mirrors ``starneig_GEP_SM_Eigenvectors`` (reference: gep_sm.h:400-629).
    Infinite eigenvalues (zero T diagonal) are supported: the vector solves
    T x = 0 on the leading block.

    Returns (X, info), LAPACK-style real storage.
    """
    S = jnp.asarray(S)
    T = jnp.asarray(T)
    Z = jnp.asarray(Z)
    n = S.shape[0]
    select = np.asarray(select, bool)
    sub = np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]])
    ds = np.asarray(jnp.diagonal(S))
    dt = np.asarray(jnp.diagonal(T))
    sup_s = np.concatenate([np.asarray(jnp.diagonal(S, offset=1)), [0.0]])
    sup_t = np.concatenate([np.asarray(jnp.diagonal(T, offset=1)), [0.0]])

    entries = []  # (pos, is_pair, alpha_r, alpha_i, beta)
    i = 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                # complex pair of the 2x2 pencil block
                t11, t22 = dt[i], dt[i + 1]
                det_t = t11 * t22
                m11 = ds[i] * t22
                m12 = -ds[i] * sup_t[i] + sup_s[i] * t11
                m21 = sub[i] * t22
                m22 = -sub[i] * sup_t[i] + ds[i + 1] * t11
                tr = 0.5 * (m11 + m22)
                disc = 0.25 * (m11 - m22) ** 2 + m12 * m21
                im = np.sqrt(max(-disc, 0.0))
                # pick the sign so lambda = alpha/beta has POSITIVE imaginary
                # part (the Re/Im column-pair convention)
                im_s = im if det_t >= 0 else -im
                entries.append((i, True, tr, im_s, det_t))
            i += 2
        else:
            if select[i]:
                entries.append((i, False, ds[i], 0.0, dt[i]))
            i += 1

    ncols = sum(2 if e[1] else 1 for e in entries)
    if ncols == 0:
        return jnp.zeros((n, 0), S.dtype), Error.SUCCESS

    m = len(entries)
    mp = max(8, int(np.ceil(m / 8.0)) * 8)
    pos = np.zeros(mp, np.int32)
    is_pair = np.zeros(mp, bool)
    ar = np.zeros(mp)
    ai = np.zeros(mp)
    bt = np.ones(mp)
    valid = np.zeros(mp, bool)
    for j, (p, pr, lr, li, b) in enumerate(entries):
        # normalize (alpha, beta) so max magnitude ~ 1 (robustness)
        scale = max(abs(lr) + abs(li), abs(b), 1e-300)
        pos[j], is_pair[j], valid[j] = p, pr, True
        ar[j], ai[j], bt[j] = lr / scale, li / scale, b / scale

    xr, xi, close = _backsolve_all_gep(S, T, jnp.asarray(ar), jnp.asarray(ai),
                                       jnp.asarray(bt), jnp.asarray(pos),
                                       jnp.asarray(is_pair), jnp.asarray(valid))
    xr = np.asarray(xr)
    xi = np.asarray(xi)

    Y = np.zeros((n, ncols))
    c = 0
    for j, (p, pr, *_rest) in enumerate(entries):
        if pr:
            Y[:, c] = xr[j]
            Y[:, c + 1] = xi[j]
            c += 2
        else:
            Y[:, c] = xr[j]
            c += 1
    X = _backtransform(Z, jnp.asarray(Y))
    info = Error.CLOSE_EIGENVALUES if bool(np.asarray(close).any()) \
        else Error.SUCCESS
    return X, info
