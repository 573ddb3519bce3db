"""Adjacent diagonal-block swaps in a real Schur form (dlaexc semantics).

The reorder component and the AED deflation step both move 1x1/2x2 blocks
along the diagonal by swapping adjacent blocks (the reference wraps LAPACK
dtrsen/dtrexc for this, ``src/reorder/lapack.c:59``, and uses block moves in
AED deflation ``src/schur/cpu_utils.c:3377``).  This module implements the
underlying direct-swap math from scratch as fixed-shape 4x4 JAX ops:

  * (1,1)+(1,1): exact Givens rotation (always succeeds),
  * otherwise: solve the small Sylvester equation T11 X - X T22 = -T12 via
    a padded 4x4 Kronecker system, orthogonalize [X; I] with Householder QR,
    and accept the swap only if the resulting (2,1) block is negligible
    (backward-stability test), rejecting ill-conditioned swaps exactly like
    dlaexc (-> the reference's PARTIAL_REORDERING semantics).

Every function is branch-free (where/cond) and jit/vmap friendly; block
sizes p, q in {1, 2} are dynamic scalars.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.ops import primitives as prim


def _solve4(A, b):
    """Solve a 4x4 linear system by unrolled Gaussian elimination w/ partial
    pivoting (no data-dependent control flow)."""
    M = jnp.concatenate([A, b[:, None]], axis=1)  # 4x5 augmented

    def elim(M, k):
        col = jnp.abs(M[:, k])
        idx = jnp.arange(4)
        col = jnp.where(idx >= k, col, -1.0)
        piv = jnp.argmax(col)
        # swap rows k <-> piv
        rk, rp = M[k], M[piv]
        M = M.at[k].set(rp).at[piv].set(rk)
        pivval = M[k, k]
        pivval = jnp.where(pivval == 0, jnp.finfo(M.dtype).tiny, pivval)
        factors = M[:, k] / pivval
        factors = jnp.where(idx == k, 0.0, factors)
        M = M - factors[:, None] * M[k][None, :]
        return M

    for k in range(4):
        M = elim(M, k)
    diag = jnp.diagonal(M[:, :4])
    diag = jnp.where(diag == 0, jnp.finfo(M.dtype).tiny, diag)
    return M[:, 4] / diag


def _swap_11(D4):
    """Exact rotation swap of two 1x1 blocks (dlaexc J1 case)."""
    t11, t12, t22 = D4[0, 0], D4[0, 1], D4[1, 1]
    cs, sn, _ = prim.givens(t12, t22 - t11)
    # Q first column = [cs, sn] (spans the t22 eigenvector [t12, t22-t11])
    Q = jnp.eye(4, dtype=D4.dtype)
    Q = Q.at[0, 0].set(cs).at[1, 0].set(sn).at[0, 1].set(-sn).at[1, 1].set(cs)
    Dh = Q.T @ D4 @ Q
    Dh = Dh.at[0, 0].set(t22).at[1, 1].set(t11).at[1, 0].set(0.0)
    return Q, Dh, jnp.bool_(True)


def _swap_general(D4, p, q):
    """Sylvester + QR swap for (p,q) with p*q > 1, on the padded 4x4 block."""
    dtype = D4.dtype
    d = p + q
    idx = jnp.arange(2)
    # padded T11 (p x p), T22 (q x q), T12 (p x q) as 2x2 blocks
    rmask_p = idx[:, None] < p
    cmask_p = idx[None, :] < p
    rmask_q = idx[:, None] < q
    cmask_q = idx[None, :] < q
    T11 = jnp.where(rmask_p & cmask_p, D4[:2, :2], 0.0)
    # T22 starts at (p, p): gather with dynamic offset
    T22 = jnp.where(rmask_q & cmask_q, lax.dynamic_slice(D4, (p, p), (2, 2)), 0.0)
    T12 = jnp.where(rmask_p & cmask_q, lax.dynamic_slice(D4, (p * 0, p), (2, 2)), 0.0)

    # Kronecker system for vec(X), X stored 2x2, unknown k = 2*j + i
    # active iff i < p, j < q; inactive rows are identity rows (x_k = 0).
    def sys_row(k):
        i = k % 2
        j = k // 2
        row = jnp.zeros(4, dtype)
        # + sum_{i'} T11[i, i'] X[i', j]  -> coeff at unknown 2*j + i'
        row = row.at[2 * j + 0].add(T11[i, 0])
        row = row.at[2 * j + 1].add(T11[i, 1])
        # - sum_{j'} X[i, j'] T22[j', j] -> coeff at unknown 2*j' + i
        row = row.at[2 * 0 + i].add(-T22[0, j])
        row = row.at[2 * 1 + i].add(-T22[1, j])
        rhs = -T12[i, j]
        active = (i < p) & (j < q)
        row = jnp.where(active, row, jnp.zeros(4, dtype).at[k].set(1.0))
        rhs = jnp.where(active, rhs, 0.0)
        return row, rhs

    rows, rhss = zip(*[sys_row(k) for k in range(4)])
    A = jnp.stack(rows)
    b = jnp.stack(rhss)
    x = _solve4(A, b)
    X = x.reshape(2, 2).T  # unpack k = 2*j + i -> X[i, j]

    # M = [X; I_q] packed into the first d rows of a 4x2 array
    r4 = jnp.arange(4)[:, None]
    c2 = jnp.arange(2)[None, :]
    Xp = jnp.zeros((4, 2), dtype).at[:2, :].set(X)
    eye_part = ((r4 - p) == c2) & (r4 >= p) & (c2 < q)
    M = jnp.where(r4 < p, Xp, 0.0) + jnp.where(eye_part, 1.0, 0.0)

    # QR via two Householder reflectors (second masked out when q == 1)
    rmask4 = (r4[:, 0] < d)
    v1, tau1, _ = prim.householder(M[:, 0], rmask4)
    M1 = M - tau1 * jnp.outer(v1, v1 @ M)
    m2 = jnp.where(jnp.arange(4) >= 1, M1[:, 1], 0.0)
    # roll so the pivot sits at index 0 for householder(), then roll back
    v2r, tau2, _ = prim.householder(jnp.roll(m2, -1), jnp.roll(rmask4 & (jnp.arange(4) >= 1), -1))
    v2 = jnp.roll(v2r, 1)
    tau2 = jnp.where(q > 1, tau2, 0.0)
    Q = jnp.eye(4, dtype=dtype)
    Q = Q - tau1 * jnp.outer(v1, v1 @ Q)
    Q = Q - tau2 * jnp.outer(v2, v2 @ Q)
    Q = Q.T  # Q = H1 @ H2

    Dh = Q.T @ D4 @ Q

    # acceptance: (2,1) block of the active d x d region must be negligible
    r = jnp.arange(4)[:, None]
    c = jnp.arange(4)[None, :]
    active = (r < d) & (c < d)
    block21 = active & (r >= q) & (c < q)
    dnorm = jnp.max(jnp.where(active, jnp.abs(D4), 0.0))
    err = jnp.max(jnp.where(block21, jnp.abs(Dh), 0.0))
    eps = jnp.finfo(dtype).eps
    accept = err <= jnp.maximum(10.0 * eps * dnorm, jnp.finfo(dtype).tiny)
    Dh = jnp.where(block21, 0.0, Dh)
    return Q, Dh, accept


def _standardize_at(Dh, Q, off, active):
    """Standardize the 2x2 block of Dh at (off, off); compose rotation into Q.

    ``active`` masks the operation (no-op when the block is 1x1).
    """
    blk = lax.dynamic_slice(Dh, (off, off), (2, 2))
    aa, bb, cc, dd, *_e, cs, sn = prim.standardize_2x2(
        blk[0, 0], blk[0, 1], blk[1, 0], blk[1, 1]
    )
    cs = jnp.where(active, cs, 1.0)
    sn = jnp.where(active, sn, 0.0)
    # standardize_2x2 gives R = G M G^T with G = [[cs, sn], [-sn, cs]]; the
    # similarity below is G^T_emb Dh G_emb, so embed G^T.
    G = jnp.eye(4, dtype=Dh.dtype)
    G = G.at[off, off].set(cs).at[off + 1, off].set(sn)
    G = G.at[off, off + 1].set(-sn).at[off + 1, off + 1].set(cs)
    Dh2 = G.T @ Dh @ G
    newblk = jnp.where(
        active,
        jnp.array([[0.0, 0.0], [0.0, 0.0]], Dh.dtype).at[0, 0].set(aa).at[0, 1].set(bb)
        .at[1, 0].set(cc).at[1, 1].set(dd),
        blk,
    )
    Dh2 = lax.dynamic_update_slice(Dh2, newblk, (off, off))
    return Dh2, Q @ G


def swap_adjacent(D4, p, q):
    """Swap adjacent diagonal blocks of sizes (p, q) at the top of D4.

    Args:
      D4: (4, 4) slice of a quasi-triangular matrix; the upper block occupies
        rows/cols [0, p), the lower [p, p+q); entries beyond p+q are
        arbitrary and ignored (Q is identity there).
      p, q: dynamic block sizes in {1, 2}.

    Returns:
      (Q, Dh, accept): 4x4 orthogonal Q (identity outside the leading
      p+q), the swapped-and-standardized block Dh = Q^T D4 Q with exact
      zeros in its (2,1) block, and an acceptance flag (False -> the swap
      was numerically rejected; Q is then identity and Dh == D4).
    """
    both1 = (p == 1) & (q == 1)
    Q, Dh, accept = lax.cond(
        both1,
        lambda D: _swap_11(D),
        lambda D: _swap_general(D, p, q),
        D4,
    )
    # standardize the two new blocks: upper now has size q, lower size p
    Dh, Q = _standardize_at(Dh, Q, 0, (q == 2) & accept)
    Dh, Q = _standardize_at(Dh, Q, q, (p == 2) & accept)
    # rejected swap: leave everything untouched
    eye = jnp.eye(4, dtype=D4.dtype)
    Q = jnp.where(accept, Q, eye)
    Dh = jnp.where(accept, Dh, D4)
    return Q, Dh, accept
