"""QZ iteration: generalized Schur form of a Hessenberg-triangular pencil.

JAX rebuild of the reference's GEP Schur component (the QZ half of
``src/schur/``, SURVEY.md section 2.3): double-implicit-shift Moler-Stewart
QZ with deflation and infinite-eigenvalue handling, following the published
dhgeqz algorithm, expressed as jitted fixed-shape JAX (like small_schur):

  * H-subdiagonal deflation with the reference's norm-stable / pairwise
    thresholds,
  * infinite eigenvalues (negligible T diagonal): the T-zero is chased to
    the segment bottom with free left rotations (free because T[j,j] == 0
    kills the fill) and deflated by a right rotation zeroing H[i, i-1]
    (reference: push_inf_top cpu_utils.c:605 does the mirror-image push-up;
    the bottom-deflation variant is equivalent and fits the bottom-up
    driver),
  * double-shift QZ sweeps: left 3-reflectors chase the bulge through H
    while right 3-reflector + rotation pairs restore T's triangularity,
  * converged 2x2 blocks standardized (dlagv2-equivalent): real pairs are
    split via the generalized eigenvector rotation, complex pairs keep
    T upper triangular.

Everything is shape-static; the active size is a dynamic scalar.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.ops import primitives as prim
from starneig_jax.ops.control import make_bounded_while

ITMAX_PER_BLOCK = 40


def _safe(x, floor):
    return jnp.where(jnp.abs(x) < floor, jnp.where(x < 0, -floor, floor), x)


def _pencil_m2(h11, h12, h21, h22, t11, t12, t22, floor):
    """M = H2 @ inv(T2) for a 2x2 pencil with T upper triangular."""
    t11 = _safe(t11, floor)
    t22 = _safe(t22, floor)
    m11 = h11 / t11
    m21 = h21 / t11
    m12 = (h12 - m11 * t12) / t22
    m22 = (h22 - m21 * t12) / t22
    return m11, m12, m21, m22


def _shifts_qz(H, T, i, its, floor):
    """Double shift from the trailing 2x2 of the pencil; exceptional every 10."""
    h11, h12 = H[i - 1, i - 1], H[i - 1, i]
    h21, h22 = H[i, i - 1], H[i, i]
    t11, t12, t22 = T[i - 1, i - 1], T[i - 1, i], T[i, i]
    m11, m12, m21, m22 = _pencil_m2(h11, h12, h21, h22, t11, t12, t22, floor)
    exceptional = (its > 0) & (its % 10 == 0)
    s = jnp.abs(H[i, i - 1] / _safe(T[i - 1, i - 1], floor)) + \
        jnp.abs(H[i - 1, i - 2] / _safe(T[i - 2, i - 2], floor))
    e11 = 0.75 * s + m22
    a = jnp.where(exceptional, e11, m11)
    b = jnp.where(exceptional, -0.4375 * s, m12)
    c = jnp.where(exceptional, s, m21)
    d = jnp.where(exceptional, e11, m22)
    rt1r, rt1i, rt2r, rt2i = prim.eig2x2(a, b, c, d)
    real_pair = rt1i == 0
    use1 = jnp.abs(m22 - rt1r) <= jnp.abs(m22 - rt2r)
    sr1 = jnp.where(real_pair, jnp.where(use1, rt1r, rt2r), rt1r)
    sr2 = jnp.where(real_pair, sr1, rt2r)
    si1 = jnp.where(real_pair, 0.0, rt1i)
    return sr1, si1, sr2, -si1


def _first_col_qz(H, T, l, sr1, si1, sr2, si2, floor):
    """First column of (H T^-1 - s1)(H T^-1 - s2) restricted to 3 rows."""
    # leading 3x3 of M = H T^-1 (T upper triangular)
    t11 = _safe(T[l, l], floor)
    t22 = _safe(T[l + 1, l + 1], floor)
    t33 = _safe(T[l + 2, l + 2], floor)
    t12, t13, t23 = T[l, l + 1], T[l, l + 2], T[l + 1, l + 2]
    # inv(T3) upper triangular
    i11 = 1.0 / t11
    i22 = 1.0 / t22
    i33 = 1.0 / t33
    i12 = -t12 / (t11 * t22)
    i23 = -t23 / (t22 * t33)
    i13 = (t12 * t23 - t13 * t22) / (t11 * t22 * t33)
    H3 = lax.dynamic_slice(H, (l, l), (3, 3))
    invT = jnp.array([[0.0, 0.0, 0.0]] * 3, H.dtype)
    invT = invT.at[0, 0].set(i11).at[0, 1].set(i12).at[0, 2].set(i13)
    invT = invT.at[1, 1].set(i22).at[1, 2].set(i23).at[2, 2].set(i33)
    M3 = H3 @ invT
    return prim.first_column_shifted(M3, sr1, si1, sr2, si2, jnp.bool_(True))


def standardize_gep_2x2(A2, B2):
    """Standardize a 2x2 pencil block (dlagv2 semantics, B upper triangular).

    Returns (A2', B2', cl, sl, cr, sr): left/right rotations such that
    A2' = G_l^T A2 G_r, B2' = G_l^T B2 G_r with either A2'[1,0] == 0 (real
    generalized eigenvalues, both matrices triangular) or a standardized
    complex-pair block (B stays triangular).
    """
    dtype = A2.dtype
    floor = jnp.finfo(dtype).tiny ** 0.5
    ulp = jnp.finfo(dtype).eps
    a11, a12, a21, a22 = A2[0, 0], A2[0, 1], A2[1, 0], A2[1, 1]
    b11, b12, b22 = B2[0, 0], B2[0, 1], B2[1, 1]
    m11, m12, m21, m22 = _pencil_m2(a11, a12, a21, a22, b11, b12, b22, floor)
    l1r, l1i, l2r, l2i = prim.eig2x2(m11, m12, m21, m22)
    # a numerically singular B2 means the block holds an infinite
    # eigenvalue and MUST split as a real pair (LAPACK dlagv2 semantics —
    # without this, an inf + finite pair masquerades as a "complex" block
    # with beta ~ sqrt(tiny * O(1)))
    bnorm = jnp.abs(b11) + jnp.abs(b12) + jnp.abs(b22)
    b_sing = jnp.minimum(jnp.abs(b11), jnp.abs(b22)) <= 8 * ulp * bnorm
    is_real = (l1i == 0) | b_sing

    # real case: right rotation from the eigenvector of (A - lam B)
    lam = l1r
    r0 = jnp.array([a11 - lam * b11, a12 - lam * b12])
    r1 = jnp.array([a21, a22 - lam * b22])
    use_r1 = jnp.sum(r1 * r1) > jnp.sum(r0 * r0)
    row = jnp.where(use_r1, r1, r0)
    w = jnp.array([-row[1], row[0]])  # null vector of the chosen row
    nw = jnp.sqrt(jnp.sum(w * w))
    degenerate = nw < floor
    w = jnp.where(degenerate, jnp.array([1.0, 0.0], dtype), w / jnp.where(degenerate, 1.0, nw))
    cr = w[0]
    sr = w[1]

    # infinite-eigenvalue split: rotate B2's null vector to the first
    # column (inf lands on top), then triangularize A from the left
    inf_at_11 = jnp.abs(b11) <= jnp.abs(b22)
    rinf = jnp.sqrt(b12 * b12 + b11 * b11)
    rdeg = rinf < floor
    cr_i = jnp.where(inf_at_11, 1.0, jnp.where(rdeg, 1.0, -b12 / jnp.where(rdeg, 1.0, rinf)))
    sr_i = jnp.where(inf_at_11, 0.0, jnp.where(rdeg, 0.0, b11 / jnp.where(rdeg, 1.0, rinf)))
    cr = jnp.where(b_sing, cr_i, cr)
    sr = jnp.where(b_sing, sr_i, sr)

    # B' = B @ Gr with Gr = [[cr, -sr], [sr, cr]]; left rotation zeroes B'[1,0]
    b_p00 = b11 * cr + b12 * sr
    b_p10 = b22 * sr
    cl, sl, _ = prim.givens(b_p00, b_p10)
    # ... except in the singular-B split, where the left rotation zeroes
    # A'[1,0] instead (B' first column is ~0 on both rows already)
    a_p00 = a11 * cr + a12 * sr
    a_p10 = a21 * cr + a22 * sr
    cl_i, sl_i, _ = prim.givens(a_p00, a_p10)
    cl = jnp.where(b_sing, cl_i, cl)
    sl = jnp.where(b_sing, sl_i, sl)
    # identity transforms for the complex case
    cr = jnp.where(is_real, cr, 1.0)
    sr = jnp.where(is_real, sr, 0.0)
    cl = jnp.where(is_real, cl, 1.0)
    sl = jnp.where(is_real, sl, 0.0)
    Gl = jnp.array([[cl, -sl], [sl, cl]], dtype)
    Gr = jnp.array([[cr, -sr], [sr, cr]], dtype)
    A2n = Gl.T @ A2 @ Gr
    B2n = Gl.T @ B2 @ Gr
    # plant exact zeros for the real case; the singular-B split also
    # plants the exact zero beta marking the infinite eigenvalue
    A2n = jnp.where(is_real, A2n.at[1, 0].set(0.0), A2n)
    B2n = B2n.at[1, 0].set(0.0)
    B2n = jnp.where(b_sing, B2n.at[0, 0].set(0.0), B2n)
    return A2n, B2n, cl, sl, cr, sr


_QZ_RUNNERS = {}


def small_qz(H, T, Q, Z, m, thresh_h=0.0, thresh_t=0.0, ilo=0,
             max_total_iter=0):
    """Generalized real Schur form of the active m x m pencil (H, T).

    Args:
      H: (w, w) upper Hessenberg; T: (w, w) upper triangular (active block).
      Q, Z: (w, w) accumulation matrices (left/right transforms).
      m: dynamic active size; thresh_h/thresh_t: absolute deflation floors.

    Returns:
      (S, Tt, Q, Z, info): S quasi-triangular, Tt upper triangular with
      zero diagonal entries marking infinite eigenvalues; info = 0 on
      success else the failing row + 1.
    """
    H = jnp.asarray(H)
    w = H.shape[0]
    dtype = H.dtype
    if max_total_iter == 0:
        max_total_iter = 40 * w
    WP = w + 3
    Hp = jnp.zeros((WP, WP), dtype).at[:w, :w].set(H)
    Tp = jnp.zeros((WP, WP), dtype).at[:w, :w].set(jnp.asarray(T))
    Qp = jnp.zeros((w, WP), dtype).at[:, :w].set(jnp.asarray(Q))
    Zp = jnp.zeros((w, WP), dtype).at[:, :w].set(jnp.asarray(Z))
    key = (w, str(dtype))
    if key not in _QZ_RUNNERS:
        _QZ_RUNNERS[key] = _build_qz_machine(w)
    run = _QZ_RUNNERS[key]
    init = (Hp, Tp, Qp, Zp, jnp.int32(m - 1), jnp.int32(0), jnp.int32(0),
            jnp.bool_(False), jnp.asarray(thresh_h, dtype),
            jnp.asarray(thresh_t, dtype), jnp.int32(ilo),
            jnp.int32(max_total_iter))
    out = run(init)
    Hp, Tp, Qp, Zp, i, its, total, failed = out[:8]
    info = jnp.where(failed, i + 1, 0)
    return Hp[:w, :w], Tp[:w, :w], Qp[:, :w], Zp[:, :w], info


def _build_qz_machine(w):
    """cond/body state machine for window size w (cached per shape)."""
    WP = w + 3
    idx = np.arange(w, dtype=np.int32)  # NUMPY: a jnp array built inside a
    # caller trace would be a tracer, leak through the _QZ_RUNNERS cache

    def find_l(Hp, i, thresh_h, ilo):
        ulp = jnp.finfo(Hp.dtype).eps
        d = jnp.diagonal(Hp[:w, :w])
        sub = jnp.diagonal(Hp[:w, :w], offset=-1)
        tst = jnp.abs(d[:-1]) + jnp.abs(d[1:])
        neg = jnp.abs(sub) <= jnp.maximum(ulp * tst, thresh_h)
        neg = jnp.concatenate([jnp.ones((1,), bool), neg])
        cand = neg & (idx > ilo) & (idx <= i)
        return jnp.max(jnp.where(cand, idx, ilo)).astype(jnp.int32)

    # ---- rotation application helpers (full padded width) ----
    def lrot(M, r0, r1, c, s):
        """rows: (r0, r1) <- (c*r0 + s*r1, -s*r0 + c*r1)."""
        a = M[r0, :]
        b = M[r1, :]
        M = M.at[r0, :].set(c * a + s * b)
        M = M.at[r1, :].set(-s * a + c * b)
        return M

    def rrot(M, c0, c1, c, s):
        """cols: right-multiply by G = [[c, -s], [s, c]]:
        (c0, c1) <- (c*c0 + s*c1, -s*c0 + c*c1)."""
        a = M[:, c0]
        b = M[:, c1]
        M = M.at[:, c0].set(c * a + s * b)
        M = M.at[:, c1].set(-s * a + c * b)
        return M

    # ------------------------------------------------------------------
    # infinite-eigenvalue chase: T[j,j] ~ 0 -> chase to bottom, deflate
    # ------------------------------------------------------------------
    def process_inf(args):
        Hp, Tp, Qp, Zp, j, l, i, thresh_t = args
        ulp = jnp.finfo(Hp.dtype).eps
        Tp = Tp.at[j, j].set(0.0)

        def body(jch, carry):
            Hp, Tp, Qp, Zp, stopped = carry
            act = (jch >= j) & (jch <= i - 1) & (~stopped)
            c, s, _ = prim.givens(Hp[jch, jch], Hp[jch + 1, jch])
            c = jnp.where(act, c, 1.0)
            s = jnp.where(act, s, 0.0)
            Hp = lrot(Hp, jch, jch + 1, c, s)
            Hp = Hp.at[jch + 1, jch].set(jnp.where(act, 0.0, Hp[jch + 1, jch]))
            # first chase step: drop the (negligible, see the chaseability
            # gate) fill -s*H[j, j-1] below the subdiagonal — dhgeqz's
            # ILAZR2 treatment (H[j, j-1] itself was scaled by c via lrot)
            jm1 = jnp.maximum(jch - 1, 0)
            first_fill = act & (jch == j) & (jch > l) & (jch >= 1)
            Hp = Hp.at[jch + 1, jm1].set(
                jnp.where(first_fill, 0.0, Hp[jch + 1, jm1]))
            Tp = lrot(Tp, jch, jch + 1, c, s)
            qa = Qp[:, jch]
            qb = Qp[:, jch + 1]
            Qp = Qp.at[:, jch].set(c * qa + s * qb).at[:, jch + 1].set(-s * qa + c * qb)
            tsig = jnp.abs(Tp[jch + 1, jch + 1]) > jnp.maximum(
                thresh_t, ulp * jnp.abs(Tp[jch, jch + 1]))
            stop_now = act & tsig
            Tp = lax.cond(act & ~tsig,
                          lambda T: T.at[jch + 1, jch + 1].set(0.0),
                          lambda T: T, Tp)
            return Hp, Tp, Qp, Zp, stopped | stop_now

        Hp, Tp, Qp, Zp, stopped = lax.fori_loop(0, w - 1, body,
                                                (Hp, Tp, Qp, Zp, jnp.bool_(False)))

        # if the zero reached the bottom, deflate the infinite eigenvalue:
        # right rotation zeroing H[i, i-1]
        def deflate_bottom(args):
            Hp, Tp, Qp, Zp = args
            c, s, _ = prim.givens(Hp[i, i], Hp[i, i - 1])
            # zero H[i, i-1]: combine cols (i, i-1): col_{i-1} <- c*col_{i-1} - s*col_i is
            # the wrong pairing; use cols (i-1, i) with the swap convention:
            a = Hp[:, i - 1]
            b = Hp[:, i]
            Hp = Hp.at[:, i - 1].set(c * a - s * b).at[:, i].set(s * a + c * b)
            Hp = Hp.at[i, i - 1].set(0.0)
            a = Tp[:, i - 1]
            b = Tp[:, i]
            Tp = Tp.at[:, i - 1].set(c * a - s * b).at[:, i].set(s * a + c * b)
            Tp = Tp.at[i, i - 1].set(0.0)
            a = Zp[:, i - 1]
            b = Zp[:, i]
            Zp = Zp.at[:, i - 1].set(c * a - s * b).at[:, i].set(s * a + c * b)
            return Hp, Tp, Qp, Zp

        Hp, Tp, Qp, Zp = lax.cond(~stopped, deflate_bottom,
                                  lambda a: a, (Hp, Tp, Qp, Zp))
        new_i = jnp.where(stopped, i, i - 1)
        return Hp, Tp, Qp, Zp, new_i

    # ------------------------------------------------------------------
    # double-shift QZ sweep over [l, i]
    # ------------------------------------------------------------------
    def sweep(Hp, Tp, Qp, Zp, l, i, its):
        floor = jnp.finfo(Hp.dtype).tiny ** 0.5
        Hsq = Hp[:w, :w]
        Tsq = Tp[:w, :w]
        sr1, si1, sr2, si2 = _shifts_qz(Hsq, Tsq, i, its, floor)

        def step(t, carry):
            Hp, Tp, Qp, Zp = carry
            k_real = l + t
            active = k_real <= i - 1
            k = jnp.where(active, k_real, jnp.int32(0) + l * 0)
            use3 = active & (k_real <= i - 2)
            mask = jnp.stack([jnp.bool_(True), jnp.bool_(True), use3])

            col = lax.dynamic_slice(Hp, (k, jnp.maximum(k - 1, 0)), (3, 1))[:, 0]
            col = jnp.where(use3, col, col.at[2].set(0.0))
            v_intro = _first_col_qz(Hp, Tp, l, sr1, si1, sr2, si2, floor)
            x = jnp.where(k_real == l, v_intro, col)
            v, tau, beta = prim.householder(x, mask)
            tau = jnp.where(active, tau, 0.0)

            # left reflector on H, T rows k..k+2; Q cols k..k+2
            rows = lax.dynamic_slice(Hp, (k, k * 0), (3, WP))
            Hp = lax.dynamic_update_slice(Hp, rows - tau * jnp.outer(v, v @ rows), (k, k * 0))
            rows = lax.dynamic_slice(Tp, (k, k * 0), (3, WP))
            Tp = lax.dynamic_update_slice(Tp, rows - tau * jnp.outer(v, v @ rows), (k, k * 0))
            qc = lax.dynamic_slice(Qp, (k * 0, k), (w, 3))
            Qp = lax.dynamic_update_slice(Qp, qc - tau * jnp.outer(qc @ v, v), (k * 0, k))

            def fix_col(Hp):
                km1 = jnp.maximum(k - 1, 0)
                patch = jnp.stack([beta, 0.0 * beta, jnp.where(use3, 0.0, Hp[k + 2, km1])])
                return lax.dynamic_update_slice(Hp, patch[:, None], (k, km1))
            Hp = lax.cond(active & (k_real > l), fix_col, lambda M: M, Hp)

            # right 3-reflector from T row k+2 zeroing T[k+2, k], T[k+2, k+1]
            trow = lax.dynamic_slice(Tp, (k + 2, k), (1, 3))[0]
            # reversed householder: zero leading 2 entries of the row
            rrev = trow[::-1]
            vr_r, tau_r, beta_r = prim.householder(rrev, jnp.array([True, True, True]))
            vr = vr_r[::-1]
            tau_r = jnp.where(use3 & active, tau_r, 0.0)
            cols = lax.dynamic_slice(Hp, (k * 0, k), (WP, 3))
            Hp = lax.dynamic_update_slice(Hp, cols - tau_r * jnp.outer(cols @ vr, vr), (k * 0, k))
            cols = lax.dynamic_slice(Tp, (k * 0, k), (WP, 3))
            Tp = lax.dynamic_update_slice(Tp, cols - tau_r * jnp.outer(cols @ vr, vr), (k * 0, k))
            zc = lax.dynamic_slice(Zp, (k * 0, k), (w, 3))
            Zp = lax.dynamic_update_slice(Zp, zc - tau_r * jnp.outer(zc @ vr, vr), (k * 0, k))
            # plant the exact zeros produced by the reflector
            Tp = lax.cond(use3,
                          lambda T: T.at[k + 2, k].set(0.0).at[k + 2, k + 1].set(0.0),
                          lambda T: T, Tp)

            # right rotation zeroing T[k+1, k] on cols (k, k+1)
            c2, s2, _ = prim.givens(Tp[k + 1, k + 1], Tp[k + 1, k])
            c2 = jnp.where(active, c2, 1.0)
            s2 = jnp.where(active, s2, 0.0)
            a = Hp[:, k]
            b = Hp[:, k + 1]
            Hp = Hp.at[:, k].set(c2 * a - s2 * b).at[:, k + 1].set(s2 * a + c2 * b)
            a = Tp[:, k]
            b = Tp[:, k + 1]
            Tp = Tp.at[:, k].set(c2 * a - s2 * b).at[:, k + 1].set(s2 * a + c2 * b)
            Tp = Tp.at[k + 1, k].set(jnp.where(active, 0.0, Tp[k + 1, k]))
            a = Zp[:, k]
            b = Zp[:, k + 1]
            Zp = Zp.at[:, k].set(c2 * a - s2 * b).at[:, k + 1].set(s2 * a + c2 * b)
            return Hp, Tp, Qp, Zp

        return lax.fori_loop(0, w, step, (Hp, Tp, Qp, Zp))

    # ------------------------------------------------------------------
    # 2x2 deflation with generalized standardization
    # ------------------------------------------------------------------
    def deflate2(Hp, Tp, Qp, Zp, i):
        A2 = lax.dynamic_slice(Hp, (i - 1, i - 1), (2, 2))
        B2 = lax.dynamic_slice(Tp, (i - 1, i - 1), (2, 2))
        A2n, B2n, cl, sl, cr, sr = standardize_gep_2x2(A2, B2)
        Hp = lrot(Hp, i - 1, i, cl, sl)
        Tp = lrot(Tp, i - 1, i, cl, sl)
        qa, qb = Qp[:, i - 1], Qp[:, i]
        Qp = Qp.at[:, i - 1].set(cl * qa + sl * qb).at[:, i].set(-sl * qa + cl * qb)
        Hp = rrot(Hp, i - 1, i, cr, sr)
        Tp = rrot(Tp, i - 1, i, cr, sr)
        Zp = rrot(Zp, i - 1, i, cr, sr)
        Hp = lax.dynamic_update_slice(Hp, A2n, (i - 1, i - 1))
        Tp = lax.dynamic_update_slice(Tp, B2n, (i - 1, i - 1))
        return Hp, Tp, Qp, Zp

    # ------------------------------------------------------------------
    # driver state machine
    # ------------------------------------------------------------------
    def cond(st):
        i, its, total, failed, ilo, maxiter = st[4], st[5], st[6], st[7], st[10], st[11]
        return (i >= ilo) & (~failed) & (total < maxiter)

    def body(st):
        Hp, Tp, Qp, Zp, i, its, total, failed, thresh_h, thresh_t, ilo, maxiter = st
        ulp = jnp.finfo(Hp.dtype).eps
        l = find_l(Hp, i, thresh_h, ilo)
        Hp = lax.cond(l > ilo, lambda M: M.at[l, l - 1].set(0.0), lambda M: M, Hp)

        # infinite eigenvalue in [l, i]? (negligible T diagonal)
        tdiag = jnp.abs(jnp.diagonal(Tp[:w, :w]))
        tsmall = tdiag <= jnp.maximum(thresh_t, ulp * tdiag.max())
        cand = tsmall & (idx >= l) & (idx <= i)
        jinf = jnp.min(jnp.where(cand, idx, w))
        has_inf = jinf < w
        # chaseability (dhgeqz ILAZRO/ILAZR2): the first chase rotation
        # drops a fill of size |s|*|H[j, j-1]|; only allowed when H[j, j-1]
        # is zero (segment top) or the dropped quantity is negligible
        jsafe = jnp.minimum(jinf, w - 1)
        hjm = jnp.abs(Hp[jsafe, jnp.maximum(jsafe - 1, 0)])
        hsub = jnp.abs(Hp[jnp.minimum(jsafe + 1, w - 1), jsafe])
        hdia = jnp.abs(Hp[jsafe, jsafe])
        chaseable = (jinf == l) | (hjm * hsub <= jnp.maximum(
            thresh_h, ulp * hdia * (hjm + hsub + hdia)))
        has_inf = has_inf & chaseable

        def do_inf(args):
            Hp, Tp, Qp, Zp = args
            Hp, Tp, Qp, Zp, new_i = process_inf(
                (Hp, Tp, Qp, Zp, jinf, l, i, thresh_t))
            return (Hp, Tp, Qp, Zp, new_i, jnp.zeros_like(its), total + 1,
                    failed, thresh_h, thresh_t, ilo, maxiter)

        def no_inf(args):
            Hp, Tp, Qp, Zp = args

            def do_deflate(args):
                Hp, Tp, Qp, Zp = args
                Hp, Tp, Qp, Zp = lax.cond(
                    l == i - 1, lambda a: deflate2(*a, i), lambda a: a,
                    (Hp, Tp, Qp, Zp))
                new_i = jnp.where(l == i, i - 1, i - 2)
                return (Hp, Tp, Qp, Zp, new_i, jnp.zeros_like(its), total + 1,
                        failed, thresh_h, thresh_t, ilo, maxiter)

            def do_sweep(args):
                Hp, Tp, Qp, Zp = args
                Hp, Tp, Qp, Zp = sweep(Hp, Tp, Qp, Zp, l, i, its)
                nf = its + 1 >= ITMAX_PER_BLOCK
                return (Hp, Tp, Qp, Zp, i, its + 1, total + 1, nf,
                        thresh_h, thresh_t, ilo, maxiter)

            return lax.cond(l >= i - 1, do_deflate, do_sweep, (Hp, Tp, Qp, Zp))

        return lax.cond(has_inf, do_inf, no_inf, (Hp, Tp, Qp, Zp))

    return make_bounded_while(cond, body)
