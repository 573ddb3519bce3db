"""Multishift QZ with aggressive early deflation: the large-n GEP driver.

Pencil counterpart of ops/schur.py (the reference implements both problem
types through the same segment machinery, ``src/schur/``): a host state
machine over jitted building blocks —

  * H-subdiagonal deflation scan + host peel,
  * AED on the trailing window pair: small_qz solves the window, spike
    entries (s * Qw[0, :]) are tested bottom-up with generalized block
    swaps moving undeflatable blocks up, shifts come from the undeflated
    generalized Schur diagonal, and the undeflated part is re-condensed to
    Hessenberg-triangular inside the window,
  * multishift QZ sweeps: B-bulge trains advance one row per step — left
    3-reflectors on (H, T) rows, right 3-reflector + rotation pairs
    restoring T's triangularity, all batched over the train's contiguous
    rows/columns,
  * a final vectorized generalized 2x2 standardization pass.

Infinite eigenvalues: windows (small_qz) handle T-diagonal zeros natively;
if negligible T diagonals appear in a large segment outside the AED window
the driver falls back to small_qz on that whole segment (correct, slower —
the windowed infinite chase is a planned optimization).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.config import SchurConf
from starneig_jax.ops import primitives as prim
from starneig_jax.ops.control import make_bounded_while
from starneig_jax.ops.qz import small_qz, standardize_gep_2x2
from starneig_jax.ops.schur import status_info
from starneig_jax.ops.swaps_gep import swap_adjacent_gep
from starneig_jax.ops.eigvals import extract_eigenvalues_gen


def _zero_negligible(S, ihi, thresh):
    """Zero negligible H-subdiagonals above row ihi; returns (S, sub)."""
    n = S.shape[0]
    ulp = jnp.finfo(S.dtype).eps
    d = jnp.diagonal(S)
    sub = jnp.diagonal(S, offset=-1)
    tst = jnp.abs(d[:-1]) + jnp.abs(d[1:])
    idx = jnp.arange(n - 1)
    neg = (jnp.abs(sub) <= jnp.maximum(ulp * tst, thresh)) & (idx + 1 < ihi)
    newsub = jnp.where(neg, 0.0, sub)
    r = jnp.arange(n)
    S = S.at[r[1:], r[:-1]].set(newsub)
    return S, jnp.concatenate([newsub, jnp.zeros((1,), S.dtype)])


# ---------------------------------------------------------------------------
# AED deflation for pencils
# ---------------------------------------------------------------------------

def _aed_deflate_gep(Sw, Tw, Qw, Zw, s, w, thresh):
    """Bottom-up spike deflation with generalized block moves.

    (Sw, Tw) is the generalized Schur form of the AED window, (Qw, Zw) the
    accumulated left/right window transforms.  The spike is s * Qw[0, :].

    Returns (Sw, Tw, Qw, Zw, kbot, fail).
    """
    WA = Sw.shape[0]
    WP = WA + 4
    dtype = Sw.dtype
    Sp = jnp.zeros((WP, WP), dtype).at[:WA, :WA].set(Sw)
    Tp = jnp.zeros((WP, WP), dtype).at[:WA, :WA].set(Tw)
    Qp = jnp.zeros((WA, WP), dtype).at[:, :WA].set(Qw)
    Zp = jnp.zeros((WA, WP), dtype).at[:, :WA].set(Zw)
    init = (Sp, Tp, Qp, Zp, jnp.int32(w), jnp.int32(0), jnp.int32(-1),
            jnp.bool_(False), jnp.int32(0), jnp.asarray(s, dtype),
            jnp.asarray(thresh, dtype))
    Sp, Tp, Qp, Zp, kbot, ilst, src, fail, steps, _s, _t = _run_aed_gep(init)
    return Sp[:WA, :WA], Tp[:WA, :WA], Qp[:, :WA], Zp[:, :WA], kbot, fail


def _size_end(Sp, e):
    coupled = jnp.where(e >= 1, Sp[e, jnp.maximum(e - 1, 0)], 0.0)
    return jnp.where(coupled == 0, 1, 2)


def _size_start(Sp, WA, st):
    below = jnp.where(st + 1 < WA, Sp[jnp.minimum(st + 1, WA - 1), st], 0.0)
    return jnp.where(below == 0, 1, 2)


def _aed_gep_cond(st):
    kbot, ilst, src, fail, steps = st[4], st[5], st[6], st[7], st[8]
    WA = st[2].shape[0]
    return (kbot > ilst) & (~fail) & (steps < 4 * WA * WA)


def _aed_gep_test(st):
    Sp, Tp, Qp, Zp, kbot, ilst, src, fail, steps, s, thresh = st
    ulp = jnp.finfo(Sp.dtype).eps
    sz = _size_end(Sp, kbot - 1)
    start = kbot - sz
    sp0 = s * Qp[0, jnp.maximum(start, 0)]
    sp1 = s * Qp[0, jnp.maximum(kbot - 1, 0)]
    foot = jnp.maximum(jnp.abs(sp0), jnp.abs(sp1) * (sz == 2))
    tst = jnp.abs(Sp[start, start]) + jnp.where(
        sz == 2, jnp.abs(Sp[kbot - 1, kbot - 1]), 0.0)
    deflatable = foot <= jnp.maximum(ulp * tst, thresh)
    new_kbot = jnp.where(deflatable, start, kbot)
    new_src = jnp.where(deflatable, jnp.int32(-1), start.astype(jnp.int32))
    at_front = (~deflatable) & (start == ilst)
    new_ilst = jnp.where(at_front, ilst + sz, ilst)
    new_src = jnp.where(at_front, jnp.int32(-1), new_src)
    return (Sp, Tp, Qp, Zp, new_kbot, new_ilst, new_src, fail, steps + 1,
            s, thresh)


def _aed_gep_move(st):
    Sp, Tp, Qp, Zp, kbot, ilst, src, fail, steps, s, thresh = st
    WA = Qp.shape[0]
    WP = Sp.shape[0]
    p = _size_end(Sp, src - 1)
    a = src - p
    q = _size_start(Sp, WA, src)
    A4 = lax.dynamic_slice(Sp, (a, a), (4, 4))
    B4 = lax.dynamic_slice(Tp, (a, a), (4, 4))
    Qs, Zs, Ah, Bh, accept = swap_adjacent_gep(A4, B4, p, q)
    rows = lax.dynamic_slice(Sp, (a, a * 0), (4, WP))
    Sp = lax.dynamic_update_slice(Sp, Qs.T @ rows, (a, a * 0))
    rows = lax.dynamic_slice(Tp, (a, a * 0), (4, WP))
    Tp = lax.dynamic_update_slice(Tp, Qs.T @ rows, (a, a * 0))
    cols = lax.dynamic_slice(Sp, (a * 0, a), (WP, 4))
    Sp = lax.dynamic_update_slice(Sp, cols @ Zs, (a * 0, a))
    cols = lax.dynamic_slice(Tp, (a * 0, a), (WP, 4))
    Tp = lax.dynamic_update_slice(Tp, cols @ Zs, (a * 0, a))
    Sp = lax.dynamic_update_slice(Sp, Ah, (a, a))
    Tp = lax.dynamic_update_slice(Tp, Bh, (a, a))
    qc = lax.dynamic_slice(Qp, (a * 0, a), (WA, 4))
    Qp = lax.dynamic_update_slice(Qp, qc @ Qs, (a * 0, a))
    zc = lax.dynamic_slice(Zp, (a * 0, a), (WA, 4))
    Zp = lax.dynamic_update_slice(Zp, zc @ Zs, (a * 0, a))
    new_src = jnp.where(accept, a.astype(jnp.int32), jnp.int32(-1))
    arrived = accept & (new_src == ilst)
    new_ilst = jnp.where(arrived, ilst + q, ilst)
    new_src = jnp.where(arrived, jnp.int32(-1), new_src)
    new_fail = fail | (~accept)
    return (Sp, Tp, Qp, Zp, kbot, new_ilst, new_src, new_fail, steps + 1,
            s, thresh)


def _aed_gep_body(st):
    return lax.cond(st[6] < 0, _aed_gep_test, _aed_gep_move, st)


_run_aed_gep = make_bounded_while(_aed_gep_cond, _aed_gep_body)


# ---------------------------------------------------------------------------
# recondense: spike reflector + in-window HT re-reduction
# ---------------------------------------------------------------------------

@jax.jit
def _aed_recondense_gep(Sw, Tw, Qw, Zw, s, kbot):
    """Return the undeflated window part to Hessenberg-triangular form with
    the spike condensed into beta*e1.

    Bottom-up rotation pairs condense the spike into beta*e1 (keeping T
    triangular), then interleaved Givens re-reduce the leading kbot x kbot
    of (Sw, Tw) to HT form (the window-level analogue of
    ops/hess_triangular).  Returns (Sw, Tw, Qw, Zw, beta).
    """
    WA = Sw.shape[0]
    rows = jnp.arange(WA)

    # condense the spike bottom-up with left rotation pairs: rotation
    # (i-1, i) zeroes sp[i]; the T-subdiagonal fill is immediately removed
    # by a right rotation — so T stays triangular throughout and, crucially,
    # the subsequent HT interleave never touches row 0 (which would undo
    # the condensed spike)
    sp0 = jnp.where(rows < kbot, s * Qw[0, :], 0.0)

    def chase_body(t, carry):
        Sw, Tw, Qw, Zw, sp = carry
        i = (WA - 1) - t
        act = (i >= 1) & (i <= kbot - 1)
        c, s_, r_ = prim.givens(sp[jnp.maximum(i - 1, 0)], sp[i])
        c = jnp.where(act, c, 1.0)
        s_ = jnp.where(act, s_, 0.0)
        r0, r1 = Sw[i - 1, :], Sw[i, :]
        Sw = Sw.at[i - 1, :].set(c * r0 + s_ * r1)
        Sw = Sw.at[i, :].set(-s_ * r0 + c * r1)
        r0, r1 = Tw[i - 1, :], Tw[i, :]
        Tw = Tw.at[i - 1, :].set(c * r0 + s_ * r1)
        Tw = Tw.at[i, :].set(-s_ * r0 + c * r1)
        q0, q1 = Qw[:, i - 1], Qw[:, i]
        Qw = Qw.at[:, i - 1].set(c * q0 + s_ * q1)
        Qw = Qw.at[:, i].set(-s_ * q0 + c * q1)
        sp = sp.at[i - 1].set(jnp.where(act, r_, sp[i - 1]))
        sp = sp.at[i].set(jnp.where(act, 0.0, sp[i]))
        # right rotation zeroing the T[i, i-1] fill
        cr, sr, _ = prim.givens(Tw[i, i], Tw[i, i - 1])
        cr = jnp.where(act, cr, 1.0)
        sr = jnp.where(act, sr, 0.0)
        c0, c1 = Tw[:, i - 1], Tw[:, i]
        Tw = Tw.at[:, i - 1].set(cr * c0 - sr * c1)
        Tw = Tw.at[:, i].set(sr * c0 + cr * c1)
        Tw = Tw.at[i, i - 1].set(jnp.where(act, 0.0, Tw[i, i - 1]))
        c0, c1 = Sw[:, i - 1], Sw[:, i]
        Sw = Sw.at[:, i - 1].set(cr * c0 - sr * c1)
        Sw = Sw.at[:, i].set(sr * c0 + cr * c1)
        z0, z1 = Zw[:, i - 1], Zw[:, i]
        Zw = Zw.at[:, i - 1].set(cr * z0 - sr * z1)
        Zw = Zw.at[:, i].set(sr * z0 + cr * z1)
        return Sw, Tw, Qw, Zw, sp

    Sw, Tw, Qw, Zw, sp_f = lax.fori_loop(0, WA - 1, chase_body,
                                         (Sw, Tw, Qw, Zw, sp0))
    beta = sp_f[0]

    # S now carries extra band fill below the subdiagonal: interleaved
    # Givens HT re-reduction, masked to the active kbot block (same
    # mathematics as ops/hess_triangular)
    def col_body(j, carry):
        Sw, Tw, Qw, Zw = carry

        def row_body(t, carry):
            Sw, Tw, Qw, Zw = carry
            i = (WA - 1) - t
            act = (i >= j + 2) & (i <= kbot - 1) & (j <= kbot - 3)
            c, s_, _ = prim.givens(Sw[i - 1, j], Sw[i, j])
            c = jnp.where(act, c, 1.0)
            s_ = jnp.where(act, s_, 0.0)
            r0, r1 = Sw[i - 1, :], Sw[i, :]
            Sw = Sw.at[i - 1, :].set(c * r0 + s_ * r1)
            Sw = Sw.at[i, :].set(-s_ * r0 + c * r1)
            Sw = Sw.at[i, j].set(jnp.where(act, 0.0, Sw[i, j]))
            r0, r1 = Tw[i - 1, :], Tw[i, :]
            Tw = Tw.at[i - 1, :].set(c * r0 + s_ * r1)
            Tw = Tw.at[i, :].set(-s_ * r0 + c * r1)
            q0, q1 = Qw[:, i - 1], Qw[:, i]
            Qw = Qw.at[:, i - 1].set(c * q0 + s_ * q1)
            Qw = Qw.at[:, i].set(-s_ * q0 + c * q1)
            # right rotation zeroing T[i, i-1]
            cr, sr, _ = prim.givens(Tw[i, i], Tw[i, i - 1])
            cr = jnp.where(act, cr, 1.0)
            sr = jnp.where(act, sr, 0.0)
            c0, c1 = Tw[:, i - 1], Tw[:, i]
            Tw = Tw.at[:, i - 1].set(cr * c0 - sr * c1)
            Tw = Tw.at[:, i].set(sr * c0 + cr * c1)
            Tw = Tw.at[i, i - 1].set(jnp.where(act, 0.0, Tw[i, i - 1]))
            c0, c1 = Sw[:, i - 1], Sw[:, i]
            Sw = Sw.at[:, i - 1].set(cr * c0 - sr * c1)
            Sw = Sw.at[:, i].set(sr * c0 + cr * c1)
            z0, z1 = Zw[:, i - 1], Zw[:, i]
            Zw = Zw.at[:, i - 1].set(cr * z0 - sr * z1)
            Zw = Zw.at[:, i].set(sr * z0 + cr * z1)
            return Sw, Tw, Qw, Zw

        return lax.fori_loop(0, WA - 1, row_body, (Sw, Tw, Qw, Zw))

    Sw, Tw, Qw, Zw = lax.fori_loop(0, max(WA - 2, 0), col_body,
                                   (Sw, Tw, Qw, Zw))
    # clean residual subdiagonal noise on T inside the active block
    r = jnp.arange(WA)
    mask_low = (r[:, None] > r[None, :]) & (r[:, None] < kbot) & (r[None, :] < kbot)
    Tw = jnp.where(mask_low, 0.0, Tw)
    return Sw, Tw, Qw, Zw, beta


# ---------------------------------------------------------------------------
# window transform application (pencil)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3),
                   static_argnames=("P", "W"))
def _apply_window_gep(Spad, Tpad, Qpad, Zpad, Qw, Zw, Sw, Tw, active_m, pos,
                      spike, beta, P: int, W: int):
    NP = Spad.shape[0]
    gp = P + pos
    rows = lax.dynamic_slice(Spad, (gp, gp * 0), (W, NP))
    Spad = lax.dynamic_update_slice(Spad, Qw.T @ rows, (gp, gp * 0))
    rows = lax.dynamic_slice(Tpad, (gp, gp * 0), (W, NP))
    Tpad = lax.dynamic_update_slice(Tpad, Qw.T @ rows, (gp, gp * 0))
    cols = lax.dynamic_slice(Spad, (gp * 0, gp), (NP, W))
    Spad = lax.dynamic_update_slice(Spad, cols @ Zw, (gp * 0, gp))
    cols = lax.dynamic_slice(Tpad, (gp * 0, gp), (NP, W))
    Tpad = lax.dynamic_update_slice(Tpad, cols @ Zw, (gp * 0, gp))
    r = jnp.arange(W)
    act = (r[:, None] < active_m) & (r[None, :] < active_m)
    blkS = lax.dynamic_slice(Spad, (gp, gp), (W, W))
    Spad = lax.dynamic_update_slice(Spad, jnp.where(act, Sw, blkS), (gp, gp))
    blkT = lax.dynamic_slice(Tpad, (gp, gp), (W, W))
    Tpad = lax.dynamic_update_slice(Tpad, jnp.where(act, Tw, blkT), (gp, gp))
    old = lax.dynamic_slice(Spad, (gp, gp - 1), (W, 1))
    spk = jnp.where(r[:, None] == 0, beta, 0.0)
    Spad = lax.dynamic_update_slice(Spad, jnp.where(spike, spk, old),
                                    (gp, gp - 1))
    nq = Qpad.shape[0]
    qc = lax.dynamic_slice(Qpad, (gp * 0, gp), (nq, W))
    Qpad = lax.dynamic_update_slice(Qpad, qc @ Qw, (gp * 0, gp))
    zc = lax.dynamic_slice(Zpad, (gp * 0, gp), (nq, W))
    Zpad = lax.dynamic_update_slice(Zpad, zc @ Zw, (gp * 0, gp))
    return Spad, Tpad, Qpad, Zpad


@functools.partial(jax.jit, static_argnames=("P", "W"))
def _masked_window_pair(Spad, Tpad, pos, m, P: int, W: int):
    r = jnp.arange(W)
    act = (r[:, None] < m) & (r[None, :] < m)
    Sw = jnp.where(act, lax.dynamic_slice(Spad, (P + pos, P + pos), (W, W)), 0.0)
    Tw = jnp.where(act, lax.dynamic_slice(Tpad, (P + pos, P + pos), (W, W)), 0.0)
    return Sw, Tw


# ---------------------------------------------------------------------------
# windowed infinite-eigenvalue push (reference: insert_push_inf_top,
# src/schur/core.c:475-562; kernel starneig_push_inf_top cpu_utils.c:605).
# The reference pushes T-diagonal zeros to the segment TOP inside fixed
# windows; here the push runs DOWN to the segment bottom (matching the
# bottom-deflating window solver small_qz) — equivalent capability: the
# infinite eigenvalue deflates at the segment edge with windowed left
# rotations + off-window GEMM application of the accumulated transform.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("Wb",))
def _inf_chase_kernel(Hw, Tw, jrel, mrel, lrel, Wb: int):
    """Move the T-diagonal zero at window-relative jrel down to mrel-1.

    The reference's push_inf_down mechanics (cpu_utils.c:505-560),
    windowed: per step i, a LEFT rotation built from T's superdiagonal
    pair (T[i, i+1], T[i+1, i+1]) zeroes T[i+1, i+1] — moving the zero
    diagonal down unconditionally (no dhgeqz chaseability restriction) —
    and a RIGHT reflection built from the A-fill pair (A[i+1, i-1],
    A[i+1, i]) restores A's Hessenberg structure.  ``lrel`` is the step
    where the right reflection must be skipped (the decoupled segment
    top, where A[l, l-1] == 0 means no fill arises), or -1.

    Returns (Hw, Tw, Qw, Zw) with accumulated window transforms.
    """
    dtype = Hw.dtype
    Qw = jnp.eye(Wb, dtype=dtype)
    Zw = jnp.eye(Wb, dtype=dtype)
    Tw = Tw.at[jrel, jrel].set(0.0)   # plant the detected zero exactly

    def body(t, carry):
        Hw, Tw, Qw, Zw = carry
        act = (t >= jrel) & (t <= mrel - 2)
        i = jnp.clip(t, 0, Wb - 2)
        i1 = i + 1
        c, s, r = prim.givens(Tw[i, i1], Tw[i1, i1])
        c = jnp.where(act, c, 1.0)
        s = jnp.where(act, s, 0.0)
        for M in ("H", "T"):
            X = Hw if M == "H" else Tw
            r0, r1 = X[i, :], X[i1, :]
            X = X.at[i, :].set(c * r0 + s * r1)
            X = X.at[i1, :].set(-s * r0 + c * r1)
            if M == "H":
                Hw = X
            else:
                Tw = X
        q0, q1 = Qw[:, i], Qw[:, i1]
        Qw = Qw.at[:, i].set(c * q0 + s * q1)
        Qw = Qw.at[:, i1].set(-s * q0 + c * q1)
        Tw = Tw.at[i, i1].set(jnp.where(act, r, Tw[i, i1]))
        Tw = Tw.at[i1, i1].set(jnp.where(act, 0.0, Tw[i1, i1]))
        Tw = Tw.at[i1, i].set(jnp.where(act, 0.0, Tw[i1, i]))

        # right reflection on cols (i-1, i) zeroing the A-fill A[i+1, i-1]
        ract = act & (t != lrel)
        im1 = jnp.maximum(i - 1, 0)
        cr, sr, rr = prim.givens(Hw[i1, im1], Hw[i1, i])
        # reflection [[-sr, cr], [cr, sr]] (dlartg pair: zeroes col i-1's
        # entry, lands r on col i); inactive steps keep columns untouched
        for nm in ("H", "T", "Z"):
            X = Hw if nm == "H" else (Tw if nm == "T" else Zw)
            a, b = X[:, im1], X[:, i]
            na = jnp.where(ract, -sr * a + cr * b, a)
            nb = jnp.where(ract, cr * a + sr * b, b)
            X = X.at[:, im1].set(na).at[:, i].set(nb)
            if nm == "H":
                Hw = X
            elif nm == "T":
                Tw = X
            else:
                Zw = X
        Hw = Hw.at[i1, i].set(jnp.where(ract, rr, Hw[i1, i]))
        Hw = Hw.at[i1, im1].set(jnp.where(ract, 0.0, Hw[i1, im1]))
        return Hw, Tw, Qw, Zw

    Hw, Tw, Qw, Zw = lax.fori_loop(0, Wb - 1, body, (Hw, Tw, Qw, Zw))
    return Hw, Tw, Qw, Zw


@functools.partial(jax.jit, donate_argnums=(0, 1, 2), static_argnames=("P",))
def _deflate_inf_bottom(Spad, Tpad, Zpad, ihi, P: int):
    """Right rotation deflating the infinite eigenvalue at the segment
    bottom: zeroes H[ihi-1, ihi-2] (T[ihi-1, ihi-1] is already zero)."""
    i = P + ihi - 1
    c, s, _ = prim.givens(Spad[i, i], Spad[i, i - 1])

    def rot(M):
        a, b = M[:, i - 1], M[:, i]
        return M.at[:, i - 1].set(c * a - s * b).at[:, i].set(s * a + c * b)

    Spad = rot(Spad)
    Spad = Spad.at[i, i - 1].set(0.0)
    Tpad = rot(Tpad)
    Tpad = Tpad.at[i, i - 1].set(0.0)
    # plant the deflated infinite eigenvalue's beta to EXACT zero: when the
    # detected T-diagonal zero is already at the segment bottom the chase
    # is skipped and beta would otherwise stay sub-threshold tiny (the
    # chase kernel plants exact zeros; hooks expect the same here)
    Tpad = Tpad.at[i, i].set(0.0)
    nq = Zpad.shape[0]
    gi = i  # Zpad columns are padded like Spad's
    a, b = Zpad[:, gi - 1], Zpad[:, gi]
    Zpad = Zpad.at[:, gi - 1].set(c * a - s * b).at[:, gi].set(s * a + c * b)
    return Spad, Tpad, Zpad


# ---------------------------------------------------------------------------
# batched QZ bulge trains (full-width v1)
# ---------------------------------------------------------------------------

QZ_SWEEP_CHUNK = 256


def _qz_sweep_batch(Spad, Tpad, Qpad, Zpad, l, ihi, sr1, si1, sr2, si2,
                    B: int):
    steps = (ihi - l) - 2 + 3 * (B - 1) + 1
    for s0 in range(0, steps, QZ_SWEEP_CHUNK):
        Spad, Tpad, Qpad, Zpad = _qz_sweep_chunk(
            Spad, Tpad, Qpad, Zpad, l, ihi, jnp.int32(s0),
            sr1, si1, sr2, si2, B=B)
    return Spad, Tpad, Qpad, Zpad


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3),
                   static_argnames=("B",))
def _qz_sweep_chunk(Spad, Tpad, Qpad, Zpad, l, ihi, s0, sr1, si1, sr2, si2,
                    B: int):
    """QZ_SWEEP_CHUNK masked train-advance steps for the pencil.

    Per step and bulge: left 3-reflector on (H, T) rows, then a right
    3-reflector (from T's row k+2, zeroing T[k+2, k], T[k+2, k+1]) and a
    right rotation (zeroing T[k+1, k]) on (H, T) columns; Q/Z accumulate.
    Bulge trains occupy 3B contiguous rows; all per-bulge transforms act on
    disjoint row/column triples, so they batch exactly like the SEP train.
    """
    NP = Spad.shape[0]
    nq = Qpad.shape[0]
    dtype = Spad.dtype
    floor = jnp.finfo(dtype).tiny ** 0.5
    bidx = jnp.arange(B)
    seg = ihi - l
    steps = seg - 2 + 3 * (B - 1) + 1

    def step(t, carry):
        Spad, Tpad, Qpad, Zpad = carry
        s = s0 + t
        in_range = s < steps
        k = (l + s - 3 * bidx).astype(jnp.int32)
        k = jnp.where(in_range, k, l)
        active = in_range & (k >= l) & (k <= ihi - 2) & (l + s - 3 * bidx == k)
        intro = active & (l + s - 3 * bidx == l)
        use3 = k <= ihi - 3

        def gather_col(ki):
            return lax.dynamic_slice(
                Spad, (ki, jnp.maximum(ki - 1, 0)), (3, 1))[:, 0]

        cols3 = jax.vmap(gather_col)(k)

        # first column of (H T^-1 - s1)(H T^-1 - s2) at the segment top
        t11 = jnp.where(jnp.abs(Tpad[l, l]) < floor, floor, Tpad[l, l])
        t22v = Tpad[l + 1, l + 1]
        t22 = jnp.where(jnp.abs(t22v) < floor, floor, t22v)
        t33v = Tpad[l + 2, l + 2]
        t33 = jnp.where(jnp.abs(t33v) < floor, floor, t33v)
        t12, t13, t23 = Tpad[l, l + 1], Tpad[l, l + 2], Tpad[l + 1, l + 2]
        i11 = 1.0 / t11
        i22 = 1.0 / t22
        i33 = 1.0 / t33
        i12 = -t12 / (t11 * t22)
        i23 = -t23 / (t22 * t33)
        i13 = (t12 * t23 - t13 * t22) / (t11 * t22 * t33)
        H3 = lax.dynamic_slice(Spad, (l, l), (3, 3))
        invT = jnp.zeros((3, 3), dtype)
        invT = invT.at[0, 0].set(i11).at[0, 1].set(i12).at[0, 2].set(i13)
        invT = invT.at[1, 1].set(i22).at[1, 2].set(i23).at[2, 2].set(i33)
        M3 = H3 @ invT
        intro_cols = jax.vmap(
            lambda a, b, c, d, u: prim.first_column_shifted(M3, a, b, c, d, u)
        )(sr1, si1, sr2, si2, use3)

        x = jnp.where(intro[:, None], intro_cols, cols3)
        mask = jnp.stack([jnp.ones_like(use3), jnp.ones_like(use3), use3],
                         axis=1)
        v, tau, beta = jax.vmap(prim.householder)(x, mask)
        tau = jnp.where(active, tau, 0.0)

        lo = jnp.where(in_range, l + s - 3 * (B - 1), l)
        vs = v[::-1]
        taus = tau[::-1]

        # ---- left reflectors on (H, T) rows ----
        for name in ("S", "T"):
            M = Spad if name == "S" else Tpad
            R = lax.dynamic_slice(M, (lo, lo * 0), (3 * B, NP)).reshape(B, 3, NP)
            w_ = jnp.einsum("bi,bin->bn", vs, R)
            R = R - taus[:, None, None] * vs[:, :, None] * w_[:, None, :]
            M = lax.dynamic_update_slice(M, R.reshape(3 * B, NP), (lo, lo * 0))
            if name == "S":
                Spad = M
            else:
                Tpad = M
        qc = lax.dynamic_slice(Qpad, (lo * 0, lo), (nq, 3 * B)).reshape(nq, B, 3)
        wq = jnp.einsum("nbi,bi->nb", qc, vs)
        qc = qc - taus[None, :, None] * wq[:, :, None] * vs[None, :, :]
        Qpad = lax.dynamic_update_slice(Qpad, qc.reshape(nq, 3 * B), (lo * 0, lo))

        # plant H bulge columns (between left and right phases)
        fix = active & ~intro
        F = lax.dynamic_slice(Spad, (lo, lo - 1), (3 * B, 3 * B + 1))
        rrel = k - lo
        F = prim.plant(F, rrel, rrel, beta, fix)
        F = prim.plant(F, rrel + 1, rrel, 0.0, fix)
        F = prim.plant(F, rrel + 2, rrel, 0.0, fix & use3)
        Spad = lax.dynamic_update_slice(Spad, F, (lo, lo - 1))

        # ---- right 3-reflectors from T rows k+2 ----
        def gather_trow(ki):
            return lax.dynamic_slice(Tpad, (ki + 2, ki), (1, 3))[0]

        trows = jax.vmap(gather_trow)(k)
        rrev = trows[:, ::-1]
        m3 = jnp.ones_like(mask)
        vr_r, tau_r, _ = jax.vmap(prim.householder)(rrev, m3)
        vr = vr_r[:, ::-1]
        tau_r = jnp.where(active & use3, tau_r, 0.0)
        vrs = vr[::-1]
        tau_rs = tau_r[::-1]
        for name in ("S", "T"):
            M = Spad if name == "S" else Tpad
            C = lax.dynamic_slice(M, (lo * 0, lo), (NP, 3 * B)).reshape(NP, B, 3)
            wc_ = jnp.einsum("nbi,bi->nb", C, vrs)
            C = C - tau_rs[None, :, None] * wc_[:, :, None] * vrs[None, :, :]
            M = lax.dynamic_update_slice(M, C.reshape(NP, 3 * B), (lo * 0, lo))
            if name == "S":
                Spad = M
            else:
                Tpad = M
        zc = lax.dynamic_slice(Zpad, (lo * 0, lo), (nq, 3 * B)).reshape(nq, B, 3)
        wz = jnp.einsum("nbi,bi->nb", zc, vrs)
        zc = zc - tau_rs[None, :, None] * wz[:, :, None] * vrs[None, :, :]
        Zpad = lax.dynamic_update_slice(Zpad, zc.reshape(nq, 3 * B), (lo * 0, lo))

        # plant T[k+2, k], T[k+2, k+1] zeros
        FT = lax.dynamic_slice(Tpad, (lo, lo), (3 * B, 3 * B))
        cplant = active & use3
        FT = prim.plant(FT, rrel + 2, rrel, 0.0, cplant)
        FT = prim.plant(FT, rrel + 2, rrel + 1, 0.0, cplant)
        Tpad = lax.dynamic_update_slice(Tpad, FT, (lo, lo))

        # ---- right rotations zeroing T[k+1, k] ----
        def gather_t2(ki):
            return lax.dynamic_slice(Tpad, (ki + 1, ki), (1, 2))[0]

        t2 = jax.vmap(gather_t2)(k)
        c2, s2, _ = jax.vmap(prim.givens)(t2[:, 1], t2[:, 0])
        c2 = jnp.where(active, c2, 1.0)
        s2 = jnp.where(active, s2, 0.0)
        # batched 2-column rotations: cols (k, k+1) disjoint across bulges;
        # express as 3-wide batched transform with identity third column
        G = jnp.zeros((B, 3, 3), dtype)
        G = G.at[:, 0, 0].set(c2).at[:, 1, 0].set(-s2)
        G = G.at[:, 0, 1].set(s2).at[:, 1, 1].set(c2)
        G = G.at[:, 2, 2].set(1.0)
        Gs = G[::-1]
        for name in ("S", "T"):
            M = Spad if name == "S" else Tpad
            C = lax.dynamic_slice(M, (lo * 0, lo), (NP, 3 * B)).reshape(NP, B, 3)
            C = jnp.einsum("nbi,bij->nbj", C, Gs)
            M = lax.dynamic_update_slice(M, C.reshape(NP, 3 * B), (lo * 0, lo))
            if name == "S":
                Spad = M
            else:
                Tpad = M
        zc = lax.dynamic_slice(Zpad, (lo * 0, lo), (nq, 3 * B)).reshape(nq, B, 3)
        zc = jnp.einsum("nbi,bij->nbj", zc, Gs)
        Zpad = lax.dynamic_update_slice(Zpad, zc.reshape(nq, 3 * B), (lo * 0, lo))
        FT = lax.dynamic_slice(Tpad, (lo, lo), (3 * B, 3 * B))
        FT = prim.plant(FT, rrel + 1, rrel, 0.0, active)
        Tpad = lax.dynamic_update_slice(Tpad, FT, (lo, lo))
        return Spad, Tpad, Qpad, Zpad

    Spad, Tpad, Qpad, Zpad = lax.fori_loop(0, QZ_SWEEP_CHUNK, step,
                                           (Spad, Tpad, Qpad, Zpad))
    return Spad, Tpad, Qpad, Zpad


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def qz_schur(H, T, Q=None, Z=None, conf: Optional[SchurConf] = None):
    """Hessenberg-triangular pencil -> generalized real Schur form via
    multishift QZ with AED.

    Large-n replacement for calling small_qz on the whole pencil; mirrors
    the reference GEP Schur path (``starneig_GEP_SM_Schur``).

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, info).
    """
    H = jnp.asarray(H)
    T = jnp.asarray(T)
    n = H.shape[0]
    dtype = H.dtype
    Q = jnp.eye(n, dtype=dtype) if Q is None else jnp.asarray(Q)
    Z = jnp.eye(n, dtype=dtype) if Z is None else jnp.asarray(Z)
    conf = (conf or SchurConf()).resolve(n)

    B = min(12, max(1, n // 8))
    SMALL_W = min(max(64, conf.small_limit), n)
    WA = min(max(32, conf.aed_window_size + 2), n)
    P = max(3 * B + 4, SMALL_W, WA) + 2
    NP = n + 2 * P

    Spad = jnp.zeros((NP, NP), dtype)
    Spad = lax.dynamic_update_slice(Spad, H, (P, P))
    Tpad = jnp.zeros((NP, NP), dtype)
    Tpad = lax.dynamic_update_slice(Tpad, T, (P, P))
    Qpad = jnp.zeros((n, NP), dtype)
    Qpad = lax.dynamic_update_slice(Qpad, Q, (0, P))
    Zpad = jnp.zeros((n, NP), dtype)
    Zpad = lax.dynamic_update_slice(Zpad, Z, (0, P))

    tiny = float(np.finfo(np.float64).tiny)
    u = float(jnp.finfo(dtype).eps) / 2
    thresh = max(u * float(jnp.linalg.norm(H)), tiny)
    thresh_t = max(u * float(jnp.linalg.norm(T)), tiny)

    NSs = max(2, min(conf.aed_shift_count // 2 * 2, 2 * (WA // 2)))
    TMAX = max(1, (NSs // 2 + B - 1) // B)
    INFW = min(96, WA)
    eyeW = jnp.eye(WA, dtype=dtype)

    # the fused device program runs to convergence in one dispatch
    Spad, Tpad, Qpad, Zpad, state = _qz_fused(
        Spad, Tpad, Qpad, Zpad, jnp.asarray(thresh, dtype),
        jnp.asarray(thresh_t, dtype), eyeW, P=P, WA=WA, NS=NSs, B=B,
        TMAX=TMAX, nibble=conf.aed_nibble, itmax=conf.iteration_limit,
        INFW=INFW)
    info = status_info(state)

    S = lax.dynamic_slice(Spad, (P, P), (n, n))
    Tt = lax.dynamic_slice(Tpad, (P, P), (n, n))
    Qf = lax.dynamic_slice(Qpad, (0, P), (n, n))
    Zf = lax.dynamic_slice(Zpad, (0, P), (n, n))
    S, Tt, Qf, Zf = standardize_blocks_gep(S, Tt, Qf, Zf)
    ar, ai, bt = extract_eigenvalues_gen(S, Tt)
    return S, Tt, Qf, Zf, ar, ai, bt, info


@jax.jit
def standardize_blocks_gep(S, T, Q, Z):
    """Vectorized generalized 2x2 standardization pass (pencil analogue of
    schur.standardize_blocks): every 2x2 S-block gets the dlagv2 treatment;
    real pairs split exactly."""
    n = S.shape[0]
    d = jnp.diagonal(S)
    sub = jnp.concatenate([jnp.diagonal(S, offset=-1), jnp.zeros((1,), S.dtype)])
    is_start = sub != 0
    prev = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])
    is_start = is_start & ~prev
    is_second = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])

    def blk(M, i):
        i1 = jnp.minimum(i + 1, n - 1)
        return jnp.array([[M[i, i], M[i, i1]], [M[i1, i], M[i1, i1]]], M.dtype)

    idx = jnp.arange(n)
    outs = jax.vmap(lambda i: standardize_gep_2x2(blk(S, i), blk(T, i)))(idx)
    A2n, B2n, cl, sl, cr, sr = outs
    cl = jnp.where(is_start, cl, 1.0)
    sl = jnp.where(is_start, sl, 0.0)
    cr = jnp.where(is_start, cr, 1.0)
    sr = jnp.where(is_start, sr, 0.0)
    cl_r = jnp.roll(cl, 1)
    sl_r = jnp.roll(sl, 1)
    cr_r = jnp.roll(cr, 1)
    sr_r = jnp.roll(sr, 1)

    def lrot_all(M):
        Md = jnp.roll(M, -1, axis=0)
        Mu = jnp.roll(M, 1, axis=0)
        return jnp.where(is_start[:, None], cl[:, None] * M + sl[:, None] * Md,
                         jnp.where(is_second[:, None],
                                   -sl_r[:, None] * Mu + cl_r[:, None] * M, M))

    def rrot_all(M, c, s, c_r, s_r):
        Md = jnp.roll(M, -1, axis=1)
        Mu = jnp.roll(M, 1, axis=1)
        return jnp.where(is_start[None, :], c[None, :] * M + s[None, :] * Md,
                         jnp.where(is_second[None, :],
                                   -s_r[None, :] * Mu + c_r[None, :] * M, M))

    S1 = rrot_all(lrot_all(S), cr, sr, cr_r, sr_r)
    T1 = rrot_all(lrot_all(T), cr, sr, cr_r, sr_r)
    Q1 = rrot_all(Q, cl, sl, cl_r, sl_r)
    Z1 = rrot_all(Z, cr, sr, cr_r, sr_r)

    # plant exact standardized entries
    r = jnp.arange(n)
    a00 = A2n[:, 0, 0]
    a01 = A2n[:, 0, 1]
    a10 = A2n[:, 1, 0]
    a11 = A2n[:, 1, 1]
    b00 = B2n[:, 0, 0]
    b01 = B2n[:, 0, 1]
    b11 = B2n[:, 1, 1]
    Sd = jnp.where(is_start, a00, jnp.where(is_second, jnp.roll(a11, 1),
                                            jnp.diagonal(S1)))
    S1 = S1.at[r, r].set(Sd)
    sup1 = jnp.diagonal(S1, offset=1)
    S1 = S1.at[r[:-1], r[1:]].set(jnp.where(is_start[:-1], a01[:-1], sup1))
    sub1 = jnp.diagonal(S1, offset=-1)
    S1 = S1.at[r[1:], r[:-1]].set(jnp.where(is_start[:-1], a10[:-1], sub1))
    Td = jnp.where(is_start, b00, jnp.where(is_second, jnp.roll(b11, 1),
                                            jnp.diagonal(T1)))
    T1 = T1.at[r, r].set(Td)
    tsup = jnp.diagonal(T1, offset=1)
    T1 = T1.at[r[:-1], r[1:]].set(jnp.where(is_start[:-1], b01[:-1], tsup))
    tsub = jnp.diagonal(T1, offset=-1)
    T1 = T1.at[r[1:], r[:-1]].set(jnp.where(is_start[:-1], 0.0, tsub))
    return S1, T1, Q1, Z1


# ===========================================================================
# fused QZ driver: the ENTIRE multishift-QZ iteration as one device program
# (the GEP analogue of ops/schur.py:_schur_iter; reference runs one segment
# state machine for BOTH problem types, src/schur/core.c:2295-2336).  Kills
# the per-round np.asarray host syncs of the round-2/3 host loop.
# ===========================================================================


def _qz_round(Spad, Tpad, Qpad, Zpad, ihi, thresh, thresh_t, eyeW,
              P: int, WA: int, NS: int, B: int, TMAX: int, nibble: int,
              INFW: int):
    """One fused QZ round: deflation scan + peel, EITHER a windowed
    infinite-eigenvalue push (T-diagonal zero in the segment) OR an AED
    round (window QZ solve, spike deflation, shift packing, recondense).

    Returns (Spad, Tpad, Qpad, Zpad, shifts(TMAX,B,4), status(6,)) with
    status = [new_ihi, l, ntr, fail, nd, npairs].
    """
    from starneig_jax.ops.schur import _pack_shifts

    NP = Spad.shape[0]
    n = NP - 2 * P
    dtype = Spad.dtype

    # -- negligible-subdiagonal zeroing + T-diagonal magnitudes --
    S = lax.dynamic_slice(Spad, (P, P), (n, n))
    S, sub = _zero_negligible(S, ihi, thresh)
    Spad = lax.dynamic_update_slice(Spad, S, (P, P))
    tdiag = jnp.abs(jnp.diagonal(lax.dynamic_slice(Tpad, (P, P), (n, n))))

    # -- converged-block peel --
    def pcond(c):
        ih, again = c
        return again & (ih > 0)

    def pbody(c):
        ih, _ = c
        one = (ih == 1) | (sub[jnp.maximum(ih - 2, 0)] == 0.0)
        two = (~one) & ((ih == 2) | (sub[jnp.maximum(ih - 3, 0)] == 0.0))
        nih = jnp.where(one, ih - 1, jnp.where(two, ih - 2, ih))
        return nih, one | two

    ihi, _ = lax.while_loop(pcond, pbody, (ihi, jnp.bool_(True)))

    idx = jnp.arange(n, dtype=jnp.int32)
    zb = (sub == 0.0) & (idx < ihi - 1)
    l = jnp.max(jnp.where(zb, idx + 1, 0)).astype(jnp.int32)
    converged = ihi <= 0
    l = jnp.where(converged, jnp.int32(0), l)

    inf_mask = (tdiag <= thresh_t) & (idx >= l) & (idx < ihi) & (~converged)
    has_inf = jnp.any(inf_mask)
    jinf = jnp.max(jnp.where(inf_mask, idx, jnp.int32(0))).astype(jnp.int32)

    zshifts = jnp.zeros((TMAX, B, 4), dtype)

    def skip(ops):
        Spad, Tpad, Qpad, Zpad = ops
        return (Spad, Tpad, Qpad, Zpad, zshifts, ihi, jnp.int32(0),
                jnp.bool_(False), jnp.int32(0), jnp.int32(0))

    def do_inf(ops):
        """Chase the bottom-most T-zero down to ihi-1 in INFW windows and
        deflate the infinite eigenvalue (reference push_inf capability,
        cpu_utils.c:505-560); no sweep this round."""
        Spad, Tpad, Qpad, Zpad = ops

        def cond(c):
            return c[0] < ihi - 1

        def body(c):
            p, Spad, Tpad, Qpad, Zpad = c
            a0 = jnp.maximum(p - 1, l)
            m = jnp.minimum(jnp.int32(INFW), ihi - a0)
            Hw, Tw = _masked_window_pair(Spad, Tpad, a0, m, P, INFW)
            lrel = jnp.where(p == l, p - a0, jnp.int32(-1))
            Hw, Tw, Qw, Zw = _inf_chase_kernel(Hw, Tw, p - a0, m, lrel, INFW)
            Spad, Tpad, Qpad, Zpad = _apply_window_gep(
                Spad, Tpad, Qpad, Zpad, Qw, Zw, Hw, Tw, m, a0,
                jnp.bool_(False), jnp.zeros((), dtype), P=P, W=INFW)
            return a0 + m - 1, Spad, Tpad, Qpad, Zpad

        _, Spad, Tpad, Qpad, Zpad = lax.while_loop(
            cond, body, (jinf, Spad, Tpad, Qpad, Zpad))
        Spad, Tpad, Zpad = _deflate_inf_bottom(Spad, Tpad, Zpad, ihi, P=P)
        return (Spad, Tpad, Qpad, Zpad, zshifts, ihi - 1, jnp.int32(0),
                jnp.bool_(False), jnp.int32(1), jnp.int32(0))

    def do_aed(ops):
        Spad, Tpad, Qpad, Zpad = ops
        seg = ihi - l
        w = jnp.minimum(jnp.int32(WA), seg)
        kwtop = ihi - w
        gk = P + kwtop

        Sw, Tw = _masked_window_pair(Spad, Tpad, kwtop, w, P, WA)
        r = jnp.arange(WA)
        dead = (~((r[:, None] < w) & (r[None, :] < w))) \
            & (r[:, None] == r[None, :])
        Tw = jnp.where(dead, 1.0, Tw)
        Sw, Tw, Qw, Zw, sinfo = small_qz(Sw, Tw, eyeW, eyeW, w,
                                         thresh, thresh_t)
        sfail = sinfo != 0
        s_spike = jnp.where(kwtop >= 1,
                            sub[jnp.clip(kwtop - 1, 0, n - 1)], 0.0)
        Sw, Tw, Qw, Zw, kbot, _dfail = _aed_deflate_gep(
            Sw, Tw, Qw, Zw, s_spike, w, thresh)
        nd = w - kbot

        ar_w, ai_w, bt_w = extract_eigenvalues_gen(Sw, Tw)
        floor = jnp.asarray(1e-12, dtype)
        safe_bt = jnp.where(jnp.abs(bt_w) < floor,
                            jnp.where(bt_w < 0, -floor, floor), bt_w)
        er = ar_w / safe_bt
        ei = ai_w / safe_bt
        shifts, npairs = _pack_shifts(er, ei, Sw, kbot, NS, B, TMAX)

        Sw, Tw, Qw, Zw, beta = _aed_recondense_gep(Sw, Tw, Qw, Zw,
                                                   s_spike, kbot)
        beta = jnp.where(kbot > 0, beta, jnp.zeros((), dtype))
        Spad, Tpad, Qpad, Zpad = _apply_window_gep(
            Spad, Tpad, Qpad, Zpad, Qw, Zw, Sw, Tw, w, kwtop,
            jnp.bool_(True), beta, P=P, W=WA)
        new_ihi = ihi - nd

        # exceptional fallback when the window yielded no usable pair
        d0 = Spad[P + new_ihi - 1, P + jnp.maximum(new_ihi - 1, 0)]
        t0 = Tpad[P + new_ihi - 1, P + jnp.maximum(new_ihi - 1, 0)]
        lam = jnp.where(jnp.abs(t0) > floor, d0 / jnp.where(
            jnp.abs(t0) > floor, t0, 1.0), d0)
        fb = jnp.stack([lam * 1.01, 0 * lam, lam * 0.99, 0 * lam])
        need_fb = npairs == 0
        shifts = jnp.where(need_fb, jnp.broadcast_to(fb, (TMAX, B, 4)),
                           shifts)
        npairs = jnp.where(need_fb, 1, npairs)
        return (Spad, Tpad, Qpad, Zpad, shifts, new_ihi, npairs, sfail,
                nd, w)

    Spad, Tpad, Qpad, Zpad, shifts, new_ihi, npairs, sfail, nd, w = \
        lax.cond(converged, skip,
                 lambda ops: lax.cond(has_inf, do_inf, do_aed, ops),
                 (Spad, Tpad, Qpad, Zpad))

    skip_sweep = (((nd > 0) & (100 * nd >= nibble * jnp.maximum(w, 1)))
                  | (new_ihi - l <= 2) | converged | sfail | has_inf)
    ntr = jnp.where(skip_sweep, 0, (npairs + B - 1) // B)
    status = jnp.stack([new_ihi, l, ntr, sfail.astype(jnp.int32), nd,
                        npairs]).astype(jnp.int32)
    return Spad, Tpad, Qpad, Zpad, shifts, status


def _qz_iter(Spad, Tpad, Qpad, Zpad, thresh, thresh_t, eyeW, *,
             P: int = 0, WA: int = 0, NS: int = 0, B: int = 0,
             TMAX: int = 0, nibble: int = 0, itmax: int = 0, INFW: int = 0):
    """The whole multishift-QZ iteration as ONE device program (the GEP
    analogue of ops/schur.py:_schur_iter): a while_loop over fused rounds
    + per-train sweeps, run to convergence or the global round cap.
    Returns (Spad, Tpad, Qpad, Zpad, state) with the state vector of
    :func:`starneig_jax.ops.schur.status_info`."""
    NP = Spad.shape[0]
    n = NP - 2 * P

    def cond(st):
        Spad, Tpad, Qpad, Zpad, ihi, it_seg, last_ihi, fail, rounds = st
        return (ihi > 0) & (fail == 0) & (rounds < 2 * n + 10)

    def body(st):
        Spad, Tpad, Qpad, Zpad, ihi, it_seg, last_ihi, fail, rounds = st
        Spad, Tpad, Qpad, Zpad, shifts, status = _qz_round(
            Spad, Tpad, Qpad, Zpad, ihi, thresh, thresh_t, eyeW,
            P=P, WA=WA, NS=NS, B=B, TMAX=TMAX, nibble=nibble, INFW=INFW)
        new_ihi, l, ntr, sfail, nd, npairs = (status[i] for i in range(6))
        it_seg = jnp.where(new_ihi != last_ihi, 0, it_seg) + 1
        # a non-converged AED window is NOT fatal (LAPACK dlaqr3 semantics:
        # use whatever deflated, skip the sweep — _qz_round already zeroes
        # ntr on sfail); only the per-segment iteration limit fails
        fail = (it_seg > itmax).astype(jnp.int32)

        def sweeps(ops):
            Spad, Tpad, Qpad, Zpad = ops
            steps = (new_ihi - l) - 2 + 3 * (B - 1) + 1

            def train(t, ops):
                Spad, Tpad, Qpad, Zpad = ops
                sh = shifts[jnp.minimum(t, TMAX - 1)]

                def swc(c):
                    return c[0] < steps

                def swb(c):
                    s0, Spad, Tpad, Qpad, Zpad = c
                    Spad, Tpad, Qpad, Zpad = _qz_sweep_chunk(
                        Spad, Tpad, Qpad, Zpad, P + l, P + new_ihi, s0,
                        sh[:, 0], sh[:, 1], sh[:, 2], sh[:, 3], B=B)
                    return (s0 + jnp.int32(QZ_SWEEP_CHUNK), Spad, Tpad,
                            Qpad, Zpad)

                def run(ops):
                    Spad, Tpad, Qpad, Zpad = ops
                    _, Spad, Tpad, Qpad, Zpad = lax.while_loop(
                        swc, swb, (jnp.int32(0), Spad, Tpad, Qpad, Zpad))
                    return Spad, Tpad, Qpad, Zpad

                return lax.cond(t < ntr, run, lambda o: o,
                                (Spad, Tpad, Qpad, Zpad))

            return lax.fori_loop(0, TMAX, train, (Spad, Tpad, Qpad, Zpad))

        Spad, Tpad, Qpad, Zpad = lax.cond(
            (ntr > 0) & (fail == 0), sweeps, lambda o: o,
            (Spad, Tpad, Qpad, Zpad))
        return (Spad, Tpad, Qpad, Zpad, jnp.where(fail != 0, ihi, new_ihi),
                it_seg, new_ihi, fail, rounds + 1)

    z = jnp.int32(0)
    st = (Spad, Tpad, Qpad, Zpad, jnp.int32(n), z, jnp.int32(n), z, z)
    Spad, Tpad, Qpad, Zpad, ihi, it_seg, last_ihi, fail, rounds = \
        lax.while_loop(cond, body, st)
    return (Spad, Tpad, Qpad, Zpad,
            jnp.stack([ihi, it_seg, last_ihi, fail, rounds]))


_qz_fused = functools.partial(
    jax.jit, donate_argnums=(0, 1, 2, 3),
    static_argnames=("P", "WA", "NS", "B", "TMAX", "nibble", "itmax",
                     "INFW"))(_qz_iter)
