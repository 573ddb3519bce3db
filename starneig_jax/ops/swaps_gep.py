"""Adjacent diagonal-block swaps in a generalized real Schur form.

The pencil analogue of ops/swaps.py (dtgex2 semantics; the reference wraps
LAPACK dtgsen for GEP reordering, ``src/reorder/lapack.c:114``): to swap
adjacent diagonal blocks of sizes (p, q) of a pencil (A, B) with A
quasi-triangular and B upper triangular, solve the coupled generalized
Sylvester equations

    A11 R - L A22 = -A12,      B11 R - L B22 = -B12

for R, L (p x q) via a padded 8x8 Kronecker system, take the right
transform Z from a Householder QR of [R; I] and the left transform Q from
QR of [L; I] (so that A [R; I] = [L; I] A22 and likewise for B), and accept
only when the transformed (2,1) blocks of BOTH matrices are negligible.
New diagonal blocks are standardized with the dlagv2-equivalent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.ops import primitives as prim
from starneig_jax.ops.qz import standardize_gep_2x2


def _solve8(A, b):
    """Solve an 8x8 system by unrolled Gaussian elimination w/ pivoting."""
    M = jnp.concatenate([A, b[:, None]], axis=1)

    def elim(M, k):
        col = jnp.abs(M[:, k])
        idx = jnp.arange(8)
        col = jnp.where(idx >= k, col, -1.0)
        piv = jnp.argmax(col)
        rk, rp = M[k], M[piv]
        M = M.at[k].set(rp).at[piv].set(rk)
        pivval = M[k, k]
        pivval = jnp.where(pivval == 0, jnp.finfo(M.dtype).tiny, pivval)
        factors = M[:, k] / pivval
        factors = jnp.where(idx == k, 0.0, factors)
        M = M - factors[:, None] * M[k][None, :]
        return M

    for k in range(8):
        M = elim(M, k)
    diag = jnp.diagonal(M[:, :8])
    diag = jnp.where(diag == 0, jnp.finfo(M.dtype).tiny, diag)
    return M[:, 8] / diag


def _qr_cols(M4, d, q):
    """Orthogonal (4,4) Q whose leading q columns span the columns of M4.

    M4 is (4, 2) with rows >= d zero and columns >= q zero.
    """
    r4 = jnp.arange(4)[:, None]
    rmask = r4[:, 0] < d
    v1, tau1, _ = prim.householder(M4[:, 0], rmask)
    M1 = M4 - tau1 * jnp.outer(v1, v1 @ M4)
    m2 = jnp.where(jnp.arange(4) >= 1, M1[:, 1], 0.0)
    v2r, tau2, _ = prim.householder(
        jnp.roll(m2, -1), jnp.roll(rmask & (jnp.arange(4) >= 1), -1))
    v2 = jnp.roll(v2r, 1)
    tau2 = jnp.where(q > 1, tau2, 0.0)
    Q = jnp.eye(4, dtype=M4.dtype)
    Q = Q - tau1 * jnp.outer(v1, v1 @ Q)
    Q = Q - tau2 * jnp.outer(v2, v2 @ Q)
    return Q.T  # = H1 @ H2


def _pad_blocks(M4, p, q):
    idx = jnp.arange(2)
    rp = idx[:, None] < p
    cp = idx[None, :] < p
    rq = idx[:, None] < q
    cq = idx[None, :] < q
    M11 = jnp.where(rp & cp, M4[:2, :2], 0.0)
    M22 = jnp.where(rq & cq, lax.dynamic_slice(M4, (p, p), (2, 2)), 0.0)
    M12 = jnp.where(rp & cq, lax.dynamic_slice(M4, (p * 0, p), (2, 2)), 0.0)
    return M11, M22, M12


def swap_adjacent_gep(A4, B4, p, q):
    """Swap adjacent diagonal blocks of a pencil (A4, B4) at the top.

    Args:
      A4, B4: (4, 4) slices; upper block rows/cols [0, p), lower [p, p+q).
      p, q: dynamic block sizes in {1, 2}.

    Returns:
      (Qs, Zs, Ah, Bh, accept): 4x4 orthogonal transforms (identity beyond
      p+q), the swapped blocks Ah = Qs^T A4 Zs / Bh = Qs^T B4 Zs with exact
      (2,1) zeros, and the acceptance flag (False -> untouched).
    """
    dtype = A4.dtype
    d = p + q
    A11, A22, A12 = _pad_blocks(A4, p, q)
    B11, B22, B12 = _pad_blocks(B4, p, q)

    # coupled Kronecker system: unknowns x = [vec(R); vec(L)], vec index
    # k = 2*j + i (i row, j col), active iff i < p, j < q.
    def rows_for(M11, M22, M12, block):
        rows = []
        rhss = []
        for k in range(4):
            i, j = k % 2, k // 2
            row = jnp.zeros(8, dtype)
            # M11 R: coeff at R[i', j] -> x[2j + i']
            row = row.at[2 * j + 0].add(M11[i, 0])
            row = row.at[2 * j + 1].add(M11[i, 1])
            # -L M22: coeff at L[i, j'] -> x[4 + 2j' + i]
            row = row.at[4 + 2 * 0 + i].add(-M22[0, j])
            row = row.at[4 + 2 * 1 + i].add(-M22[1, j])
            rhs = -M12[i, j]
            active = (i < p) & (j < q)
            unit = jnp.zeros(8, dtype).at[block * 4 + k].set(1.0)
            rows.append(jnp.where(active, row, unit))
            rhss.append(jnp.where(active, rhs, 0.0))
        return rows, rhss

    ra, ba = rows_for(A11, A22, A12, 0)
    rb, bb = rows_for(B11, B22, B12, 1)
    Asys = jnp.stack(ra + rb)
    bsys = jnp.stack(ba + bb)
    x = _solve8(Asys, bsys)
    R = x[:4].reshape(2, 2).T
    L = x[4:].reshape(2, 2).T

    r4 = jnp.arange(4)[:, None]
    c2 = jnp.arange(2)[None, :]
    eye_part = ((r4 - p) == c2) & (r4 >= p) & (c2 < q)
    MR = jnp.where(r4 < p, jnp.zeros((4, 2), dtype).at[:2, :].set(R), 0.0) \
        + jnp.where(eye_part, 1.0, 0.0)
    ML = jnp.where(r4 < p, jnp.zeros((4, 2), dtype).at[:2, :].set(L), 0.0) \
        + jnp.where(eye_part, 1.0, 0.0)
    Zs = _qr_cols(MR, d, q)
    Qs = _qr_cols(ML, d, q)

    Ah = Qs.T @ A4 @ Zs
    Bh = Qs.T @ B4 @ Zs

    r = jnp.arange(4)[:, None]
    c = jnp.arange(4)[None, :]
    act = (r < d) & (c < d)
    blk21 = act & (r >= q) & (c < q)
    nrm = jnp.maximum(jnp.max(jnp.where(act, jnp.abs(A4), 0.0)),
                      jnp.max(jnp.where(act, jnp.abs(B4), 0.0)))
    err = jnp.maximum(jnp.max(jnp.where(blk21, jnp.abs(Ah), 0.0)),
                      jnp.max(jnp.where(blk21, jnp.abs(Bh), 0.0)))
    eps = jnp.finfo(dtype).eps
    accept = err <= jnp.maximum(20.0 * eps * nrm, jnp.finfo(dtype).tiny)
    Ah = jnp.where(blk21, 0.0, Ah)
    Bh = jnp.where(blk21, 0.0, Bh)

    # standardize the two new pencil blocks (upper size q at 0, lower size p
    # at q); B's (2,1) entries inside blocks must stay zero.
    def std_at(Ah, Bh, Qs, Zs, off, active):
        A2 = lax.dynamic_slice(Ah, (off, off), (2, 2))
        B2 = lax.dynamic_slice(Bh, (off, off), (2, 2))
        # the equivalence transform leaves the new B diagonal blocks full:
        # re-triangularize with a left rotation zeroing B2[1, 0] first
        c0, s0, _ = prim.givens(B2[0, 0], B2[1, 0])
        c0 = jnp.where(active, c0, 1.0)
        s0 = jnp.where(active, s0, 0.0)
        G0 = jnp.array([[c0, -s0], [s0, c0]], dtype)
        A2 = G0.T @ A2
        B2 = (G0.T @ B2).at[1, 0].set(0.0)
        G0e = jnp.eye(4, dtype=dtype)
        G0e = G0e.at[off, off].set(c0).at[off + 1, off].set(s0)
        G0e = G0e.at[off, off + 1].set(-s0).at[off + 1, off + 1].set(c0)
        Ah = G0e.T @ Ah
        Bh = Bh_new = G0e.T @ Bh
        Qs = Qs @ G0e
        A2n, B2n, cl, sl, cr, sr = standardize_gep_2x2(A2, B2)
        cl = jnp.where(active, cl, 1.0)
        sl = jnp.where(active, sl, 0.0)
        cr = jnp.where(active, cr, 1.0)
        sr = jnp.where(active, sr, 0.0)
        Gl = jnp.eye(4, dtype=dtype)
        Gl = Gl.at[off, off].set(cl).at[off + 1, off].set(sl)
        Gl = Gl.at[off, off + 1].set(-sl).at[off + 1, off + 1].set(cl)
        Gr = jnp.eye(4, dtype=dtype)
        Gr = Gr.at[off, off].set(cr).at[off + 1, off].set(sr)
        Gr = Gr.at[off, off + 1].set(-sr).at[off + 1, off + 1].set(cr)
        Ah = Gl.T @ Ah @ Gr
        Bh = Gl.T @ Bh @ Gr
        A2k = jnp.where(active, A2n, A2)
        B2k = jnp.where(active, B2n, B2)
        Ah = lax.dynamic_update_slice(Ah, A2k, (off, off))
        Bh = lax.dynamic_update_slice(Bh, B2k, (off, off))
        return Ah, Bh, Qs @ Gl, Zs @ Gr

    Ah, Bh, Qs, Zs = std_at(Ah, Bh, Qs, Zs, 0 * p, (q == 2) & accept)
    Ah, Bh, Qs, Zs = std_at(Ah, Bh, Qs, Zs, q, (p == 2) & accept)
    eye = jnp.eye(4, dtype=dtype)
    Qs = jnp.where(accept, Qs, eye)
    Zs = jnp.where(accept, Zs, eye)
    Ah = jnp.where(accept, Ah, A4)
    Bh = jnp.where(accept, Bh, B4)
    return Qs, Zs, Ah, Bh, accept
