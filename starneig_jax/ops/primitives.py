"""Scalar linear-algebra primitives, vectorized for JAX.

These are from-scratch JAX implementations of the classic kernel-level
operations every dense eigensolver is built from (the reference implements
the same math in ``src/schur/cpu_utils.c``: reflector generation
cpu_utils.c:952, first-column computation cpu_utils.c:884-919, rotation
generation cpu_utils.c:305, 2x2 standardization cpu_utils.c:806-828).  The
algorithms follow the published LAPACK algorithm descriptions (dlarfg,
dlartg, dlanv2, dlaqr1); all control flow is expressed with ``jnp.where``
select chains so every function is jit/vmap-friendly and branch-free.

All functions are dtype-polymorphic (f32/f64) and shape-static.
"""

from __future__ import annotations

import jax.numpy as jnp


def _safe_div(num, den):
    """num/den with den==0 mapped to 0 (used only on inactive select lanes)."""
    den_ok = den != 0
    return jnp.where(den_ok, num / jnp.where(den_ok, den, 1), 0)


def _sign(x):
    """sign(x) with sign(0) == +1 (Fortran SIGN(1,x) semantics)."""
    return jnp.where(x >= 0, 1.0, -1.0).astype(x.dtype)


def hypot2(x, y):
    """Robust sqrt(x^2+y^2) (dlapy2)."""
    ax, ay = jnp.abs(x), jnp.abs(y)
    w = jnp.maximum(ax, ay)
    z = jnp.minimum(ax, ay)
    r = _safe_div(z, w)
    return jnp.where(w == 0, 0.0, w * jnp.sqrt(1.0 + r * r))


def householder(x, mask=None):
    """Householder reflector annihilating x[1:] (dlarfg semantics).

    Computes (v, tau, beta) with v[0] == 1 such that
    ``(I - tau * v v^T) x = beta * e1`` on the active entries.

    Args:
      x: (m,) vector.
      mask: optional (m,) boolean; inactive entries are treated as zero and
        the returned v is zero there (supports fixed-shape windowed kernels).

    Returns:
      (v, tau, beta): v is (m,) with v[0]==1 and masked tail, tau/beta scalars.
    """
    if mask is not None:
        x = jnp.where(mask, x, 0)
    # Scale to ~1 magnitude before forming any product, as LAPACK dlarfg
    # rescales for the subnormal range: squares of tiny entries must not
    # underflow when a bulge collapses onto roundoff-level values.  v and
    # tau are scale invariant; beta scales linearly.
    m = jnp.max(jnp.abs(x))
    msafe = jnp.where(m == 0, jnp.ones((), x.dtype), m)
    xs = x / msafe
    alpha = xs[0]
    tail = xs.at[0].set(0)
    xnorm = jnp.sqrt(jnp.sum(tail * tail))
    beta = -_sign(alpha) * hypot2(alpha, xnorm)
    degenerate = xnorm == 0
    tau = jnp.where(degenerate, 0.0, _safe_div(beta - alpha, beta))
    scale = _safe_div(jnp.ones((), x.dtype), alpha - beta)
    v = jnp.where(degenerate, jnp.zeros_like(xs), tail * scale).at[0].set(1.0)
    if mask is not None:
        v = jnp.where(mask, v, 0).at[0].set(1.0)
    beta = jnp.where(degenerate, alpha, beta) * msafe
    return v, tau, beta


def plant(M, rows, cols, vals, where):
    """``M[rows[i], cols[i]] = vals[i]`` for the lanes where ``where[i]``.

    One scatter whose masked-off lanes are dropped, never written: writing
    the old value back instead would race with a lane that targets the
    same entry, and a scatter's order among duplicate indices is
    unspecified (GPUs apply them in any order).  Active lanes must target
    distinct, in-range entries.
    """
    rows = jnp.where(where, rows, M.shape[0])   # out of range: dropped
    return M.at[rows, cols].set(vals, mode="drop")


def givens(f, g):
    """Plane rotation zeroing g (dlartg semantics).

    Returns (c, s, r) with  [c  s; -s  c] @ [f; g] = [r; 0].
    """
    rmag = hypot2(f, g)
    r0 = _sign(f) * rmag
    rsafe = jnp.where(r0 == 0, 1.0, r0)
    c = jnp.where(g == 0, 1.0, jnp.where(f == 0, 0.0, f / rsafe))
    s = jnp.where(g == 0, 0.0, jnp.where(f == 0, 1.0, g / rsafe))
    r = jnp.where(g == 0, f, jnp.where(f == 0, g, r0))
    return c, s, r


def eig2x2(a, b, c, d):
    """Eigenvalues of [[a,b],[c,d]] -> (re1, im1, re2, im2).

    Stable quadratic: complex pairs get +/- conjugate imag parts.
    """
    # scale to ~1 before forming p*p / b*c so products of tiny operands
    # cannot underflow (see householder); eigenvalues scale linearly
    sc = jnp.abs(a) + jnp.abs(b) + jnp.abs(c) + jnp.abs(d)
    sc = jnp.where(sc == 0, jnp.ones_like(sc), sc)
    a, b, c, d = a / sc, b / sc, c / sc, d / sc
    p = 0.5 * (a - d)
    bc = b * c
    disc = p * p + bc
    sq = jnp.sqrt(jnp.abs(disc))
    real_case = disc >= 0
    z = p + _sign(p) * sq
    lam1_r = jnp.where(real_case, d + z, 0.5 * (a + d))
    lam2_r = jnp.where(real_case, jnp.where(z == 0, d, d - _safe_div(bc, z)), 0.5 * (a + d))
    lam1_i = jnp.where(real_case, 0.0, sq)
    lam2_i = jnp.where(real_case, 0.0, -sq)
    return lam1_r * sc, lam1_i * sc, lam2_r * sc, lam2_i * sc


def standardize_2x2(a, b, c, d):
    """Standardize a real 2x2 Schur block (dlanv2 semantics).

    Computes the rotation (cs, sn) so that

        [ cs  sn ]^T [ a  b ] [ cs  sn ]  =  [ aa  bb ]
        [-sn  cs ]   [ c  d ] [-sn  cs ]     [ cc  dd ]

    where either cc == 0 (real eigenvalues, upper triangular) or
    aa == dd and bb*cc < 0 (standardized complex-pair block).

    Returns (aa, bb, cc, dd, rt1r, rt1i, rt2r, rt2i, cs, sn).
    """
    dtype = jnp.result_type(a, b, c, d)
    eps = jnp.finfo(dtype).eps
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    # ---- general path quantities (guarded) ----
    temp0 = a - d
    p0 = 0.5 * temp0
    bcmax = jnp.maximum(jnp.abs(b), jnp.abs(c))
    bcmis = jnp.minimum(jnp.abs(b), jnp.abs(c)) * _sign(b) * _sign(c)
    scale = jnp.maximum(jnp.abs(p0), bcmax)
    z0 = _safe_div(p0, scale) * p0 + _safe_div(bcmax, scale) * bcmis
    real_gen = z0 >= 4.0 * eps

    # -- general / real eigenvalues branch --
    zr = p0 + _sign(p0) * jnp.sqrt(jnp.maximum(scale, 0)) * jnp.sqrt(jnp.maximum(z0, 0))
    a_r = d + zr
    d_r = d - _safe_div(bcmax, zr) * bcmis
    tau_r = hypot2(c, zr)
    cs_r = _safe_div(zr, tau_r)
    sn_r = _safe_div(c, tau_r)
    b_r = b - c
    c_r = zero

    # -- general / complex-or-equal branch --
    sigma = b + c
    tau_c = hypot2(sigma, temp0)
    cs_c = jnp.sqrt(0.5 * (1.0 + _safe_div(jnp.abs(sigma), tau_c)))
    sn_c = -_safe_div(p0, tau_c * cs_c) * _sign(sigma)
    # rotate: [aa bb; cc dd] = [a b; c d] G,  then G^T [..]
    aa = a * cs_c + b * sn_c
    bb = -a * sn_c + b * cs_c
    cc = c * cs_c + d * sn_c
    dd = -c * sn_c + d * cs_c
    a1 = aa * cs_c + cc * sn_c
    b1 = bb * cs_c + dd * sn_c
    c1 = -aa * sn_c + cc * cs_c
    d1 = -bb * sn_c + dd * cs_c
    tmid = 0.5 * (a1 + d1)
    a1 = tmid
    d1 = tmid
    # sub-branches after the equalizing rotation
    # (i) c1 != 0 and b1 != 0 and sign(b1) == sign(c1): real almost-equal pair
    sab = jnp.sqrt(jnp.abs(b1))
    sac = jnp.sqrt(jnp.abs(c1))
    p1 = _sign(c1) * sab * sac
    tau1 = _safe_div(one, jnp.sqrt(jnp.maximum(jnp.abs(b1 + c1), jnp.finfo(dtype).tiny)))
    a_i = tmid + p1
    d_i = tmid - p1
    b_i = b1 - c1
    c_i = zero
    cs1 = sab * tau1
    sn1 = sac * tau1
    cs_i = cs_c * cs1 - sn_c * sn1
    sn_i = cs_c * sn1 + sn_c * cs1
    # (ii) c1 != 0 and b1 == 0: swap
    b_ii = -c1
    c_ii = zero
    cs_ii = -sn_c
    sn_ii = cs_c
    # select within complex branch
    sub_i = (c1 != 0) & (b1 != 0) & (_sign(b1) == _sign(c1))
    sub_ii = (c1 != 0) & (b1 == 0)
    a_cx = jnp.where(sub_i, a_i, a1)
    b_cx = jnp.where(sub_i, b_i, jnp.where(sub_ii, b_ii, b1))
    c_cx = jnp.where(sub_i, c_i, jnp.where(sub_ii, c_ii, c1))
    d_cx = jnp.where(sub_i, d_i, d1)
    cs_cx = jnp.where(sub_i, cs_i, jnp.where(sub_ii, cs_ii, cs_c))
    sn_cx = jnp.where(sub_i, sn_i, jnp.where(sub_ii, sn_ii, sn_c))

    # -- combine general branch --
    a_g = jnp.where(real_gen, a_r, a_cx)
    b_g = jnp.where(real_gen, b_r, b_cx)
    c_g = jnp.where(real_gen, c_r, c_cx)
    d_g = jnp.where(real_gen, d_r, d_cx)
    cs_g = jnp.where(real_gen, cs_r, cs_cx)
    sn_g = jnp.where(real_gen, sn_r, sn_cx)

    # ---- top-level select chain ----
    case1 = c == 0
    case2 = (~case1) & (b == 0)
    case3 = (~case1) & (~case2) & (temp0 == 0) & (_sign(b) != _sign(c))

    aa_f = jnp.where(case1, a, jnp.where(case2, d, jnp.where(case3, a, a_g)))
    bb_f = jnp.where(case1, b, jnp.where(case2, -c, jnp.where(case3, b, b_g)))
    cc_f = jnp.where(case1, c, jnp.where(case2, zero, jnp.where(case3, c, c_g)))
    dd_f = jnp.where(case1, d, jnp.where(case2, a, jnp.where(case3, d, d_g)))
    cs_f = jnp.where(case1 | case3, one, jnp.where(case2, zero, cs_g))
    sn_f = jnp.where(case1 | case3, zero, jnp.where(case2, one, sn_g))

    # canonicalize: a standardized complex block has aa == dd *exactly*; XLA
    # fusion may duplicate the shared subexpression with different
    # FMA/reassociation rounding, so enforce it structurally.
    dd_f = jnp.where(cc_f == 0, dd_f, aa_f)
    rt1r = aa_f
    rt2r = dd_f
    imag = jnp.sqrt(jnp.abs(bb_f)) * jnp.sqrt(jnp.abs(cc_f))
    rt1i = jnp.where(cc_f == 0, zero, imag)
    rt2i = -rt1i
    return aa_f, bb_f, cc_f, dd_f, rt1r, rt1i, rt2r, rt2i, cs_f, sn_f


def first_column_shifted(h, sr1, si1, sr2, si2, use3):
    """First column of (H - s1 I)(H - s2 I), scaled (dlaqr1 semantics).

    Args:
      h: (3,3) top-left of the (sub)matrix; when ``use3`` is False only the
        leading 2x2 is meaningful and a 2-element column (third entry 0) is
        produced.
      sr1, si1, sr2, si2: the two shifts (si2 == -si1 for a conjugate pair).
      use3: bool scalar — 3x3 (double-shift bulge) vs 2x2 tail case.

    Returns:
      v: (3,) the (unnormalized) first column.
    """
    h11, h12, h13 = h[0, 0], h[0, 1], h[0, 2]
    h21, h22, h23 = h[1, 0], h[1, 1], h[1, 2]
    h31, h32, h33 = h[2, 0], h[2, 1], h[2, 2]

    # 3x3 case
    s3 = jnp.abs(h11 - sr2) + jnp.abs(si2) + jnp.abs(h21) + jnp.abs(h31)
    h21s3 = _safe_div(h21, s3)
    h31s3 = _safe_div(h31, s3)
    v1_3 = (h11 - sr1) * _safe_div(h11 - sr2, s3) - si1 * _safe_div(si2, s3) \
        + h12 * h21s3 + h13 * h31s3
    v2_3 = h21s3 * (h11 + h22 - sr1 - sr2) + h23 * h31s3
    v3_3 = h31s3 * (h11 + h33 - sr1 - sr2) + h21s3 * h32

    # 2x2 case
    s2 = jnp.abs(h11 - sr2) + jnp.abs(si2) + jnp.abs(h21)
    h21s2 = _safe_div(h21, s2)
    v1_2 = h21s2 * h12 + (h11 - sr1) * _safe_div(h11 - sr2, s2) \
        - si1 * _safe_div(si2, s2)
    v2_2 = h21s2 * (h11 + h22 - sr1 - sr2)

    v1 = jnp.where(use3, jnp.where(s3 == 0, 0.0, v1_3), jnp.where(s2 == 0, 0.0, v1_2))
    v2 = jnp.where(use3, jnp.where(s3 == 0, 0.0, v2_3), jnp.where(s2 == 0, 0.0, v2_2))
    v3 = jnp.where(use3, jnp.where(s3 == 0, 0.0, v3_3), 0.0)
    return jnp.stack([v1, v2, v3])
