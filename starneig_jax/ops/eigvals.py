"""Eigenvalue extraction from (generalized) real Schur forms.

Vectorized analogue of the reference's extract-eigenvalues task
(reference: ``src/common/tasks.h:330-376`` + 2x2 extraction
``src/common/math.c:147``): walk the diagonal of the quasi-triangular S,
reading 1x1 blocks directly and 2x2 blocks (nonzero subdiagonal) as complex
conjugate pairs.  Here the walk is a single vectorized pass — every diagonal
position computes both hypotheses and selects by block-membership masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from starneig_jax.ops.primitives import eig2x2, _safe_div


@jax.jit
def extract_eigenvalues(S):
    """Eigenvalues of a real Schur form S -> (real, imag) arrays of length n.

    2x2 diagonal blocks with nonzero subdiagonal entries produce conjugate
    pairs at their two positions.
    """
    n = S.shape[0]
    d = jnp.diagonal(S)
    sub = jnp.concatenate([jnp.diagonal(S, offset=-1), jnp.zeros((1,), S.dtype)])
    sup = jnp.concatenate([jnp.diagonal(S, offset=1), jnp.zeros((1,), S.dtype)])
    # is_start[i]: S[i+1,i] != 0 -> block [i, i+1]. Blocks cannot overlap in a
    # valid Schur form; a defensive mask prevents double-claims anyway.
    is_start = sub != 0
    prev_start = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])
    is_start = is_start & ~prev_start
    is_second = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])

    d_next = jnp.concatenate([d[1:], jnp.zeros((1,), S.dtype)])
    l1r, l1i, l2r, l2i = eig2x2(d, sup, sub, d_next)

    d_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), d[:-1]])
    sup_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), sup[:-1]])
    sub_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), sub[:-1]])
    p1r, p1i, p2r, p2i = eig2x2(d_prev, sup_prev, sub_prev, d)

    real = jnp.where(is_start, l1r, jnp.where(is_second, p2r, d))
    imag = jnp.where(is_start, l1i, jnp.where(is_second, p2i, jnp.zeros_like(d)))
    return real, imag


@jax.jit
def extract_eigenvalues_gen(S, T):
    """Generalized eigenvalues of pencil (S, T) -> (real, imag, beta).

    Follows the reference's alpha/beta convention (gep_sm.h): eigenvalue i is
    (real[i] + 1j*imag[i]) / beta[i]; beta == 0 encodes an infinite
    eigenvalue.  1x1 blocks give (s_ii, 0, t_ii).  2x2 blocks (S subdiagonal
    nonzero, T upper triangular) give the complex pair of inv(T22) @ S22 with
    beta = 1 scaled by det(T22) robustness: we compute eigenvalues of the
    2x2 pencil via the scaled product.
    """
    n = S.shape[0]
    ds = jnp.diagonal(S)
    dt = jnp.diagonal(T)
    sub = jnp.concatenate([jnp.diagonal(S, offset=-1), jnp.zeros((1,), S.dtype)])
    sup = jnp.concatenate([jnp.diagonal(S, offset=1), jnp.zeros((1,), S.dtype)])
    tsup = jnp.concatenate([jnp.diagonal(T, offset=1), jnp.zeros((1,), T.dtype)])

    is_start = sub != 0
    prev_start = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])
    is_start = is_start & ~prev_start
    is_second = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])

    ds_next = jnp.concatenate([ds[1:], jnp.zeros((1,), S.dtype)])
    dt_next = jnp.concatenate([dt[1:], jnp.ones((1,), T.dtype)])

    # 2x2 pencil (S2, T2) with T2 = [[t11, t12], [0, t22]] upper triangular:
    # eigenvalues of S2 @ inv(T2) (finite when t11*t22 != 0).
    t11, t12, t22 = dt, tsup, dt_next
    det_t = t11 * t22
    # inv(T2) = 1/det * [[t22, -t12], [0, t11]]
    m11 = ds * t22
    m12 = -ds * t12 + sup * t11
    m21 = sub * t22
    m22 = -sub * t12 + ds_next * t11
    e1r, e1i, e2r, e2i = eig2x2(m11, m12, m21, m22)
    # eigenvalues of S2 inv(T2) scaled by det_t -> represent as alpha/beta
    beta2 = det_t

    e1r_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), e1r[:-1]])
    e2r_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), e2r[:-1]])
    e1i_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), e1i[:-1]])
    e2i_prev = jnp.concatenate([jnp.zeros((1,), S.dtype), e2i[:-1]])
    beta2_prev = jnp.concatenate([jnp.ones((1,), S.dtype), beta2[:-1]])

    real = jnp.where(is_start, e1r, jnp.where(is_second, e2r_prev, ds))
    imag = jnp.where(is_start, e1i, jnp.where(is_second, e2i_prev, jnp.zeros_like(ds)))
    beta = jnp.where(is_start, beta2, jnp.where(is_second, beta2_prev, dt))
    return real, imag, beta
