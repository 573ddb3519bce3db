"""Dense Francis double-implicit-shift QR iteration for small/window problems.

This is the recursion base of the Schur component: the AED window solver and
the small-segment solver (the reference implements the same role in
``src/schur/cpu_utils.c:2150-2179`` via LAPACK dhseqr and a built-in
sequential QR ``perform_small_schur_reduction`` cpu_utils.c:2426).  Here it
is a from-scratch JAX implementation following the published Francis/dlahqr
algorithm:

  * bottom-up deflation with the classic pairwise negligibility test plus a
    caller-provided absolute (norm-stable) floor — the reference's two
    deflation criteria (schur/core.c:2388-2462),
  * Wilkinson double shifts from the trailing 2x2, with exceptional shifts
    every 10 iterations,
  * a bulge-chase sweep as a static-bound masked ``lax.fori_loop`` of
    rank-1 reflector updates on fixed-shape (padded) arrays,
  * 2x2 block standardization (dlanv2-equivalent) on deflation.

The outer iteration is one jitted ``lax.while_loop``
(:mod:`starneig_jax.ops.control`); all shapes are static, the active size is
a dynamic scalar.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from starneig_jax.ops import primitives as prim
from starneig_jax.ops.control import make_bounded_while

ITMAX_PER_BLOCK = 30  # exceptional-shift cadence 10; hard per-block cap


def _find_deflation(H, ilo, i, thresh):
    """Largest l in (ilo, i] with negligible H[l, l-1]; else ilo."""
    w = H.shape[0]
    dtype = H.dtype
    ulp = jnp.finfo(dtype).eps
    d = jnp.diagonal(H)
    sub = jnp.diagonal(H, offset=-1)
    tst = jnp.abs(d[:-1]) + jnp.abs(d[1:])
    neg = jnp.abs(sub) <= jnp.maximum(ulp * tst, thresh)
    neg = jnp.concatenate([jnp.ones((1,), bool), neg])
    idx = jnp.arange(w, dtype=jnp.int32)
    cand = neg & (idx > ilo) & (idx <= i)
    return jnp.max(jnp.where(cand, idx, ilo)).astype(jnp.int32)


def _shifts(H, i, its):
    """Wilkinson double shift from trailing 2x2; exceptional every 10 its."""
    h11 = H[i - 1, i - 1]
    h12 = H[i - 1, i]
    h21 = H[i, i - 1]
    h22 = H[i, i]
    exceptional = (its > 0) & (its % 10 == 0)
    s = jnp.abs(H[i, i - 1]) + jnp.abs(H[i - 1, jnp.maximum(i - 2, 0)])
    e11 = 0.75 * s + h22
    a = jnp.where(exceptional, e11, h11)
    b = jnp.where(exceptional, -0.4375 * s, h12)
    c = jnp.where(exceptional, s, h21)
    d = jnp.where(exceptional, e11, h22)
    rt1r, rt1i, rt2r, rt2i = prim.eig2x2(a, b, c, d)
    real_pair = rt1i == 0
    use1 = jnp.abs(h22 - rt1r) <= jnp.abs(h22 - rt2r)
    sr1 = jnp.where(real_pair, jnp.where(use1, rt1r, rt2r), rt1r)
    sr2 = jnp.where(real_pair, sr1, rt2r)
    si1 = jnp.where(real_pair, 0.0, rt1i)
    si2 = -si1
    return sr1, si1, sr2, si2


def _sweep(Hp, Zp, l, i, sr1, si1, sr2, si2):
    """One double-shift bulge chase over the active block [l, i] (inclusive).

    Dynamic-bound ``while_loop``: step t corresponds to column k = l + t and
    the loop exits at k == i, so shrinking active blocks cost proportionally
    less (the reference's scalar kernel naturally has the same property,
    cpu_utils.c:1309).
    """
    wp = Hp.shape[0]
    w = Zp.shape[0]

    def step_cond(carry):
        t, Hp, Zp = carry
        return l + t <= i - 1

    def step(carry):
        t, Hp, Zp = carry
        k_real = l + t
        active = k_real <= i - 1
        k = jnp.where(active, k_real, jnp.int32(0))
        use3 = active & (k_real <= i - 2)
        blk = lax.dynamic_slice(Hp, (k, k), (3, 3))
        v_intro = prim.first_column_shifted(blk, sr1, si1, sr2, si2, use3)
        col = lax.dynamic_slice(Hp, (k, jnp.maximum(k - 1, 0)), (3, 1))[:, 0]
        v_chase = jnp.where(use3, col, col.at[2].set(0.0))
        x = jnp.where(k_real == l, v_intro, v_chase)
        mask = jnp.stack([jnp.bool_(True), jnp.bool_(True), use3])
        v, tau, beta = prim.householder(x, mask)
        tau = jnp.where(active, tau, 0.0)

        rows = lax.dynamic_slice(Hp, (k, k * 0), (3, wp))
        sums = v @ rows
        rows = rows - tau * jnp.outer(v, sums)
        Hp = lax.dynamic_update_slice(Hp, rows, (k, k * 0))

        # plant the exact chase column (masked rather than a per-step
        # lax.cond)
        fix = active & (k_real > l)
        km1 = jnp.maximum(k - 1, 0)
        old = lax.dynamic_slice(Hp, (k, km1), (3, 1))[:, 0]
        patch = jnp.stack([
            jnp.where(fix, beta, old[0]),
            jnp.where(fix, 0.0, old[1]),
            jnp.where(fix & use3, 0.0, old[2])])
        Hp = lax.dynamic_update_slice(Hp, patch[:, None], (k, km1))

        cols = lax.dynamic_slice(Hp, (k * 0, k), (wp, 3))
        sums = cols @ v
        cols = cols - tau * jnp.outer(sums, v)
        Hp = lax.dynamic_update_slice(Hp, cols, (k * 0, k))

        zc = lax.dynamic_slice(Zp, (k * 0, k), (w, 3))
        sums = zc @ v
        zc = zc - tau * jnp.outer(sums, v)
        Zp = lax.dynamic_update_slice(Zp, zc, (k * 0, k))
        return t + 1, Hp, Zp

    _, Hp, Zp = lax.while_loop(step_cond, step, (jnp.int32(0), Hp, Zp))
    return Hp, Zp


def _deflate_block(Hp, Zp, l, i):
    """Deflate converged 1x1 (l == i) or standardized 2x2 (l == i-1)."""
    wp = Hp.shape[0]
    w = Zp.shape[0]

    def two(args):
        Hp, Zp = args
        a, b = Hp[i - 1, i - 1], Hp[i - 1, i]
        c, d = Hp[i, i - 1], Hp[i, i]
        aa, bb, cc, dd, *_rt, cs, sn = prim.standardize_2x2(a, b, c, d)
        rows = lax.dynamic_slice(Hp, (i - 1, i * 0), (2, wp))
        r0 = cs * rows[0] + sn * rows[1]
        r1 = -sn * rows[0] + cs * rows[1]
        Hp = lax.dynamic_update_slice(Hp, jnp.stack([r0, r1]), (i - 1, i * 0))
        cols = lax.dynamic_slice(Hp, (i * 0, i - 1), (wp, 2))
        c0 = cs * cols[:, 0] + sn * cols[:, 1]
        c1 = -sn * cols[:, 0] + cs * cols[:, 1]
        Hp = lax.dynamic_update_slice(Hp, jnp.stack([c0, c1], axis=1), (i * 0, i - 1))
        blk = jnp.zeros((2, 2), Hp.dtype)
        blk = blk.at[0, 0].set(aa).at[0, 1].set(bb).at[1, 0].set(cc).at[1, 1].set(dd)
        Hp = lax.dynamic_update_slice(Hp, blk, (i - 1, i - 1))
        zc = lax.dynamic_slice(Zp, (i * 0, i - 1), (w, 2))
        z0 = cs * zc[:, 0] + sn * zc[:, 1]
        z1 = -sn * zc[:, 0] + cs * zc[:, 1]
        Zp = lax.dynamic_update_slice(Zp, jnp.stack([z0, z1], axis=1), (i * 0, i - 1))
        return Hp, Zp

    return lax.cond(l == i - 1, two, lambda a: a, (Hp, Zp))


def _cond(state):
    Hp, Zp, i, its, total, failed, thresh, ilo, maxiter = state
    return (i >= ilo) & (~failed) & (total < maxiter)


def _body(state):
    Hp, Zp, i, its, total, failed, thresh, ilo, maxiter = state
    w = Zp.shape[0]
    Hsq = lax.dynamic_slice(Hp, (0, 0), (w, w))
    l = _find_deflation(Hsq, ilo, i, thresh)
    Hp = lax.cond(l > ilo, lambda Hp: Hp.at[l, l - 1].set(0.0),
                  lambda Hp: Hp, Hp)

    def do_deflate(args):
        Hp, Zp = args
        Hp, Zp = _deflate_block(Hp, Zp, l, i)
        new_i = jnp.where(l == i, i - 1, i - 2)
        return Hp, Zp, new_i, jnp.zeros_like(its), total + 1, failed

    def do_sweep(args):
        Hp, Zp = args
        Hsq = lax.dynamic_slice(Hp, (0, 0), (w, w))
        sr1, si1, sr2, si2 = _shifts(Hsq, i, its)
        Hp2, Zp2 = _sweep(Hp, Zp, l, i, sr1, si1, sr2, si2)
        new_failed = its + 1 >= ITMAX_PER_BLOCK
        return Hp2, Zp2, i, its + 1, total + 1, new_failed

    Hp, Zp, i, its, total, failed = lax.cond(
        l >= i - 1, do_deflate, do_sweep, (Hp, Zp))
    return Hp, Zp, i, its, total, failed, thresh, ilo, maxiter


_run = make_bounded_while(_cond, _body)


def small_schur(H, Z, m, thresh=0.0, ilo=0, max_total_iter=0):
    """Real Schur form of the active m x m Hessenberg block of H.

    Args:
      H: (w, w) upper Hessenberg in [0, m) x [0, m); anything outside the
        active block is ignored (zeros recommended).
      Z: (w, w) initial accumulation matrix (identity for a fresh solve);
        transformations accumulate as ``Z @ Q``.
      m: dynamic active size (m <= w).
      thresh: absolute deflation floor (0 = pure LAPACK pairwise test; the
        reference's norm-stable default passes u * ||A||_F).
      ilo: active block start.
      max_total_iter: 0 -> auto (30 * w).

    Returns:
      (S, Z, info): S (w, w) with the Schur form in the active block, Z with
      accumulated transforms, info = 0 on success else failing row + 1.
    """
    H = jnp.asarray(H)
    Z = jnp.asarray(Z)
    w = H.shape[0]
    dtype = H.dtype
    if max_total_iter == 0:
        max_total_iter = 30 * w
    Hp = jnp.zeros((w + 2, w + 2), dtype).at[:w, :w].set(H)
    Zp = jnp.zeros((w, w + 2), dtype).at[:, :w].set(Z)
    state = (Hp, Zp, jnp.int32(m - 1), jnp.int32(0), jnp.int32(0),
             jnp.bool_(False), jnp.asarray(thresh, dtype), jnp.int32(ilo),
             jnp.int32(max_total_iter))
    Hp, Zp, i, its, total, failed, *_ = _run(state)
    S = Hp[:w, :w]
    Zout = Zp[:, :w]
    info = jnp.where(failed, i + 1, 0)
    return S, Zout, info
