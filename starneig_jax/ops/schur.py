"""Multishift QR Schur reduction with aggressive early deflation (SEP).

JAX rebuild of the reference Schur component (``src/schur/``,
SURVEY.md section 2.3) — the largest and hottest part of the solve chain.
The reference drives an asynchronous segment state machine over StarPU
tasks; here the same mathematics is organized as a host-side loop (control
flow on scalars) over jitted fixed-shape building blocks:

  * deflation scan: vectorized negligibility test + host peel of converged
    trailing blocks (thresholds per the reference's norm-stable default
    u*||A||_F or the LAPACK pairwise test, schur/core.c:2388-2462);
  * AED: the trailing window is Schur-reduced by the jitted Francis solver
    (small_schur), spike entries are tested bottom-up, undeflatable blocks
    are moved to the window top with the swap machinery, shifts are read
    off the undeflated Schur diagonal, the undeflated part is re-condensed
    to Hessenberg, and the window transform is applied as large GEMMs
    (reference: perform_small_aed/perform_large_aed core.c:1365-1551,
    deflate core.c:783-1267);
  * multishift sweep: instead of the reference's pipelined window chains
    (core.c:563-782) the bulge train is advanced by a *batched* step: all B
    bulges occupy 3B contiguous rows, so one step gathers the train block,
    applies every bulge's reflector simultaneously as batched rank-1
    updates (contiguous vectorized work), and advances one row.  The whole
    batch chase is one jitted ``fori_loop`` — no per-window dispatch.

The matrix lives in a (P+n+P)-padded buffer so every dynamic-slice window
(AED, small segments, bulge trains) stays in range without clamping.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.config import SchurConf, DeflationCriterion
from starneig_jax.errors import Error
from starneig_jax.node import full_precision
from starneig_jax.ops import primitives as prim
from starneig_jax.ops.control import make_bounded_while
from starneig_jax.ops.small_schur import small_schur
from starneig_jax.ops.swaps import swap_adjacent
from starneig_jax.ops.eigvals import extract_eigenvalues


# ---------------------------------------------------------------------------
# extent-op strategies: every access the driver makes to the full matrix
# extents goes through one of these.  ``DenseExtent`` operates on plain
# padded arrays (single chip).  ``parallel/dm_core.py`` provides a sharded
# strategy whose methods run inside ``shard_map`` with explicit collectives
# — the same driver mathematics then executes distributed, mirroring the
# reference's "same insert-tasks core, mpi != NULL" structure
# (reference src/mpi/interface_schur.c:53-120).
# ---------------------------------------------------------------------------

class DenseExtent:
    """Full-extent ops on unsharded (NP, *) padded arrays."""

    nshards = 1

    @staticmethod
    def mul_rows(S, i0, h, Qw):
        """S[i0:i0+h, :] = Qw.T @ S[i0:i0+h, :] (h static)."""
        rows = lax.dynamic_slice(S, (i0, i0 * 0), (h, S.shape[1]))
        return lax.dynamic_update_slice(S, Qw.T @ rows, (i0, i0 * 0))

    @staticmethod
    def mul_cols(S, j0, w, Qw):
        """S[:, j0:j0+w] = S[:, j0:j0+w] @ Qw (w static)."""
        cols = lax.dynamic_slice(S, (j0 * 0, j0), (S.shape[0], w))
        return lax.dynamic_update_slice(S, cols @ Qw, (j0 * 0, j0))

    @staticmethod
    def get_block(S, i0, j0, h, w):
        return lax.dynamic_slice(S, (i0, j0), (h, w))

    @staticmethod
    def set_block(S, M, i0, j0):
        return lax.dynamic_update_slice(S, M, (i0, j0))

    # -- batched variants over G disjoint diagonal windows (the wavefront
    # sweep): windows are disjoint by construction, so the per-window
    # transforms commute and may be applied rows-first-all then cols --

    @staticmethod
    def get_diag_blocks(S, ws, w):
        """(G,) window starts -> (G, w, w) diagonal blocks."""
        return jax.vmap(lambda s: lax.dynamic_slice(S, (s, s), (w, w)))(ws)

    @staticmethod
    def set_diag_blocks(S, Ms, ws):
        G, w = Ms.shape[0], Ms.shape[1]

        def body(g, S):
            return lax.dynamic_update_slice(S, Ms[g], (ws[g], ws[g]))

        return lax.fori_loop(0, G, body, S)

    @staticmethod
    def mul_rows_batch(S, ws, w, Qws):
        """S[ws_g:ws_g+w, :] = Qws[g].T @ rows for all g (disjoint)."""
        R = jax.vmap(
            lambda s: lax.dynamic_slice(S, (s, s * 0), (w, S.shape[1])))(ws)
        R = jnp.einsum("gij,gjn->gin", jnp.swapaxes(Qws, 1, 2), R)

        def body(g, S):
            return lax.dynamic_update_slice(S, R[g], (ws[g], ws[g] * 0))

        return lax.fori_loop(0, ws.shape[0], body, S)

    @staticmethod
    def mul_cols_batch(S, ws, w, Qws):
        """S[:, ws_g:ws_g+w] @= Qws[g] for all g (disjoint)."""
        C = jax.vmap(
            lambda s: lax.dynamic_slice(S, (s * 0, s), (S.shape[0], w)))(ws)
        C = jnp.einsum("gnj,gjk->gnk", C, Qws)

        def body(g, S):
            return lax.dynamic_update_slice(S, C[g], (ws[g] * 0, ws[g]))

        return lax.fori_loop(0, ws.shape[0], body, S)

    @staticmethod
    def zero_negligible(Spad, P, n, ihi, thresh):
        """Zero negligible subdiagonals above row ihi (inner coordinates).

        Returns (Spad, sub) with sub the (n,) updated subdiagonal vector.
        """
        S = lax.dynamic_slice(Spad, (P, P), (n, n))
        ulp = jnp.finfo(S.dtype).eps
        d = jnp.diagonal(S)
        sub = jnp.diagonal(S, offset=-1)
        tst = jnp.abs(d[:-1]) + jnp.abs(d[1:])
        idx = jnp.arange(n - 1)
        neg = (jnp.abs(sub) <= jnp.maximum(ulp * tst, thresh)) & (idx + 1 < ihi)
        newsub = jnp.where(neg, 0.0, sub)
        r = jnp.arange(n)
        S = S.at[r[1:], r[:-1]].set(newsub)
        Spad = lax.dynamic_update_slice(Spad, S, (P, P))
        return Spad, jnp.concatenate([newsub, jnp.zeros((1,), S.dtype)])


@jax.jit
def standardize_blocks(S, Q):
    """Standardize every 2x2 diagonal block of a quasi-triangular S.

    Vectorized final pass: all blocks are disjoint, so their rotations apply
    simultaneously via shifted-row/column arithmetic.  Real-eigenvalue 2x2
    blocks become exactly upper triangular.
    """
    n = S.shape[0]
    d = jnp.diagonal(S)
    sub = jnp.concatenate([jnp.diagonal(S, offset=-1), jnp.zeros((1,), S.dtype)])
    sup = jnp.concatenate([jnp.diagonal(S, offset=1), jnp.zeros((1,), S.dtype)])
    is_start = sub != 0
    prev = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])
    is_start = is_start & ~prev
    is_second = jnp.concatenate([jnp.zeros((1,), bool), is_start[:-1]])

    d_next = jnp.concatenate([d[1:], jnp.zeros((1,), S.dtype)])
    out = jax.vmap(prim.standardize_2x2)(d, sup, sub, d_next)
    aa, bb, cc, dd, _r1, _i1, _r2, _i2, cs, sn = out
    cs = jnp.where(is_start, cs, 1.0)
    sn = jnp.where(is_start, sn, 0.0)
    cs_r = jnp.roll(cs, 1)
    sn_r = jnp.roll(sn, 1)

    # rows: [r_i'; r_{i+1}'] = [[cs, sn], [-sn, cs]] @ [r_i; r_{i+1}]
    S_dn = jnp.roll(S, -1, axis=0)
    S_up = jnp.roll(S, 1, axis=0)
    S1 = jnp.where(is_start[:, None], cs[:, None] * S + sn[:, None] * S_dn,
                   jnp.where(is_second[:, None],
                             -sn_r[:, None] * S_up + cs_r[:, None] * S, S))
    # cols: c_i' = cs*c_i + sn*c_{i+1}; c_{i+1}' = -sn*c_i + cs*c_{i+1}
    C_dn = jnp.roll(S1, -1, axis=1)
    C_up = jnp.roll(S1, 1, axis=1)
    S2 = jnp.where(is_start[None, :], cs[None, :] * S1 + sn[None, :] * C_dn,
                   jnp.where(is_second[None, :],
                             -sn_r[None, :] * C_up + cs_r[None, :] * S1, S1))
    # plant exact standardized block entries
    r = jnp.arange(n)
    diag_new = jnp.where(is_start, aa, jnp.where(is_second, jnp.roll(dd, 1), jnp.diagonal(S2)))
    S2 = S2.at[r, r].set(diag_new)
    sup2 = jnp.diagonal(S2, offset=1)
    sup_new = jnp.where(is_start[:-1], bb[:-1], sup2)
    S2 = S2.at[r[:-1], r[1:]].set(sup_new)
    sub2 = jnp.diagonal(S2, offset=-1)
    sub_new = jnp.where(is_start[:-1], cc[:-1], sub2)
    S2 = S2.at[r[1:], r[:-1]].set(sub_new)

    Qd = jnp.roll(Q, -1, axis=1)
    Qu = jnp.roll(Q, 1, axis=1)
    Q2 = jnp.where(is_start[None, :], cs[None, :] * Q + sn[None, :] * Qd,
                   jnp.where(is_second[None, :],
                             -sn_r[None, :] * Qu + cs_r[None, :] * Q, Q))
    return S2, Q2


# ---------------------------------------------------------------------------
# AED helpers
# ---------------------------------------------------------------------------

def _aed_deflate(Tw, Vw, s, w, thresh):
    """Bottom-up spike deflation with block moves (reference core.c:783-1267).

    Tw is a (WA, WA) Schur form of the AED window (active w x w), Vw the
    accumulated window transform.  The spike is s * Vw[0, :].  Blocks whose
    spike entries are negligible deflate (stay at the bottom); others are
    moved to the top region via adjacent swaps.

    Returns (Tw, Vw, kbot, fail): kbot = rows remaining undeflated.
    """
    WA = Tw.shape[0]
    WP = WA + 4
    dtype = Tw.dtype
    ulp = jnp.finfo(dtype).eps
    Tp = jnp.zeros((WP, WP), dtype).at[:WA, :WA].set(Tw)
    Vp = jnp.zeros((WA, WP), dtype).at[:, :WA].set(Vw)

    init = (Tp, Vp, jnp.int32(w), jnp.int32(0), jnp.int32(-1),
            jnp.bool_(False), jnp.int32(0), jnp.asarray(s, dtype),
            jnp.asarray(thresh, dtype))
    Tp, Vp, kbot, ilst, src, fail, steps, _s, _t = _run_aed_deflate(init)
    return Tp[:WA, :WA], Vp[:, :WA], kbot, fail


def _size_ending_at(Tp, e):
    coupled = jnp.where(e >= 1, Tp[e, jnp.maximum(e - 1, 0)], 0.0)
    return jnp.where(coupled == 0, 1, 2)


def _size_starting_at(Tp, WA, st):
    below = jnp.where(st + 1 < WA, Tp[jnp.minimum(st + 1, WA - 1), st], 0.0)
    return jnp.where(below == 0, 1, 2)


def _aed_cond(st):
    Tp, Vp, kbot, ilst, src, fail, steps = st[:7]
    WA = Vp.shape[0]
    return (kbot > ilst) & (~fail) & (steps < 4 * WA * WA)


def _aed_test(st):
    Tp, Vp, kbot, ilst, src, fail, steps, s, thresh = st
    ulp = jnp.finfo(Tp.dtype).eps
    sz = _size_ending_at(Tp, kbot - 1)
    start = kbot - sz
    sp0 = s * Vp[0, jnp.maximum(start, 0)]
    sp1 = s * Vp[0, jnp.maximum(kbot - 1, 0)]
    foot = jnp.maximum(jnp.abs(sp0), jnp.abs(sp1) * (sz == 2))
    tst = jnp.abs(Tp[start, start]) + jnp.where(
        sz == 2, jnp.abs(Tp[kbot - 1, kbot - 1]), 0.0)
    deflatable = foot <= jnp.maximum(ulp * tst, thresh)
    new_kbot = jnp.where(deflatable, start, kbot)
    new_src = jnp.where(deflatable, jnp.int32(-1), start.astype(jnp.int32))
    at_front = (~deflatable) & (start == ilst)
    new_ilst = jnp.where(at_front, ilst + sz, ilst)
    new_src = jnp.where(at_front, jnp.int32(-1), new_src)
    return Tp, Vp, new_kbot, new_ilst, new_src, fail, steps + 1, s, thresh


def _aed_move(st):
    Tp, Vp, kbot, ilst, src, fail, steps, s, thresh = st
    WA = Vp.shape[0]
    WP = Tp.shape[0]
    p = _size_ending_at(Tp, src - 1)
    a = src - p
    q = _size_starting_at(Tp, WA, src)
    D4 = lax.dynamic_slice(Tp, (a, a), (4, 4))
    Qs, Dh, accept = swap_adjacent(D4, p, q)
    rows = lax.dynamic_slice(Tp, (a, a * 0), (4, WP))
    Tp = lax.dynamic_update_slice(Tp, Qs.T @ rows, (a, a * 0))
    cols = lax.dynamic_slice(Tp, (a * 0, a), (WP, 4))
    Tp = lax.dynamic_update_slice(Tp, cols @ Qs, (a * 0, a))
    Tp = lax.dynamic_update_slice(Tp, Dh, (a, a))
    vc = lax.dynamic_slice(Vp, (a * 0, a), (WA, 4))
    Vp = lax.dynamic_update_slice(Vp, vc @ Qs, (a * 0, a))
    new_src = jnp.where(accept, a.astype(jnp.int32), jnp.int32(-1))
    arrived = accept & (new_src == ilst)
    new_ilst = jnp.where(arrived, ilst + q, ilst)
    new_src = jnp.where(arrived, jnp.int32(-1), new_src)
    new_fail = fail | (~accept)
    return Tp, Vp, kbot, new_ilst, new_src, new_fail, steps + 1, s, thresh


def _aed_body(st):
    return lax.cond(st[4] < 0, _aed_test, _aed_move, st)


_run_aed_deflate = make_bounded_while(_aed_cond, _aed_body)


@jax.jit
def _aed_recondense(Tw, Vw, s, kbot):
    """Return the undeflated window part to Hessenberg form with the spike
    condensed into the first column (the re-reduction after deflation).

    Applies, inside the window: (1) a reflector turning the spike vector
    s * Vw[0, :kbot] into beta*e1, (2) an unblocked Hessenberg reduction of
    the leading kbot x kbot block.  Returns (Tw, Vw, beta).
    """
    WA = Tw.shape[0]
    rows = jnp.arange(WA)

    def apply_both(T, V, v, tau):
        T = T - tau * jnp.outer(v, v @ T)
        T = T - tau * jnp.outer(T @ v, v)
        V = V - tau * jnp.outer(V @ v, v)
        return T, V

    # spike reflector
    sp = s * Vw[0, :]
    sp = jnp.where(rows < kbot, sp, 0.0)
    v0, tau0, beta = prim.householder(sp, rows < kbot)
    Tw, Vw = apply_both(Tw, Vw, v0, tau0)

    # unblocked Hessenberg on [0, kbot)
    def step(j, carry):
        T, V = carry
        col = lax.dynamic_slice(T, (0 * j, j), (WA, 1))[:, 0]
        shift = j + 1
        colr = jnp.roll(col, -shift)
        mr = jnp.roll((rows >= shift) & (rows < kbot), -shift)
        vr, tau, b = prim.householder(colr, mr)
        v = jnp.roll(vr, shift)
        ok = shift < kbot
        v = jnp.where(ok & (rows >= shift) & (rows < kbot), v, 0.0)
        tau = jnp.where(ok, tau, 0.0)
        T, V = apply_both(T, V, v, tau)
        newcol = T[:, j]
        zero_zone = ok & (rows > shift) & (rows < kbot)
        newcol = jnp.where(zero_zone, 0.0, newcol)
        newcol = jnp.where((rows == shift) & ok, b, newcol)
        T = lax.dynamic_update_slice(T, newcol[:, None], (0 * j, j))
        return T, V

    Tw, Vw = lax.fori_loop(0, WA - 2, step, (Tw, Vw))
    return Tw, Vw, beta


# ---------------------------------------------------------------------------
# windowed multishift sweep: the train chases inside a small window with an
# accumulated local Qw; off-window rows/columns update per hop as GEMMs
# (reference: pipelined bulge windows + off-window GEMM tasks,
# schur/core.c:563-782 + insert_updates core.c:129 — here one jitted hop
# kernel + three GEMMs per hop, dispatched asynchronously)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("B", "WC", "HOP"))
def _train_hop(Wnd, Qw, sr1, si1, sr2, si2, l_rel, ihi_rel, s0,
               B: int, WC: int, HOP: int):
    """Advance the B-bulge train HOP rows inside the (WC+pad) window.

    Window coordinates: global row g maps to g - ws.  Bulge i performs its
    column-k action at k = l_rel + s - 3*i for step s in [s0, s0 + HOP);
    the train block rows [lo, lo + 3B) stay inside the window by
    construction (the caller slides ws so that lo >= 1 per hop).  All
    reflector applications stay within the window, accumulating into Qw.
    """
    WP = Wnd.shape[0]
    bidx = jnp.arange(B)

    def step(t, carry):
        Wnd, Qw = carry
        s = s0 + t
        k = (l_rel + s - 3 * bidx).astype(jnp.int32)
        active = (k >= l_rel) & (k <= ihi_rel - 2)
        kc = jnp.where(active, k, jnp.int32(1))
        intro = active & (k == l_rel)
        use3 = k <= ihi_rel - 3

        def gather_col(ki):
            return lax.dynamic_slice(
                Wnd, (ki, jnp.maximum(ki - 1, 0)), (3, 1))[:, 0]

        cols3 = jax.vmap(gather_col)(kc)
        lr = jnp.clip(l_rel, 0, WP - 3)
        blk = lax.dynamic_slice(Wnd, (lr, lr), (3, 3))
        intro_cols = jax.vmap(
            lambda a, b, c, d, u: prim.first_column_shifted(blk, a, b, c, d, u)
        )(sr1, si1, sr2, si2, use3)
        x = jnp.where(intro[:, None], intro_cols, cols3)
        mask = jnp.stack([jnp.ones_like(use3), jnp.ones_like(use3), use3],
                         axis=1)
        v, tau, beta = jax.vmap(prim.householder)(x, mask)
        tau = jnp.where(active, tau, 0.0)

        lo = (l_rel + s - 3 * (B - 1)).astype(jnp.int32)
        vs = v[::-1]
        taus = tau[::-1]
        R = lax.dynamic_slice(Wnd, (lo, lo * 0), (3 * B, WP)).reshape(B, 3, WP)
        w_ = jnp.einsum("bi,bin->bn", vs, R)
        R = R - taus[:, None, None] * vs[:, :, None] * w_[:, None, :]
        Wnd = lax.dynamic_update_slice(Wnd, R.reshape(3 * B, WP), (lo, lo * 0))

        # exact bulge-column plant (between left and right updates)
        fix = active & ~intro
        F = lax.dynamic_slice(Wnd, (lo, lo - 1), (3 * B, 3 * B + 1))
        rrel = kc - lo
        F = prim.plant(F, rrel, rrel, beta, fix)
        F = prim.plant(F, rrel + 1, rrel, 0.0, fix)
        F = prim.plant(F, rrel + 2, rrel, 0.0, fix & use3)
        Wnd = lax.dynamic_update_slice(Wnd, F, (lo, lo - 1))

        C = lax.dynamic_slice(Wnd, (lo * 0, lo), (WP, 3 * B)).reshape(WP, B, 3)
        wc_ = jnp.einsum("nbi,bi->nb", C, vs)
        C = C - taus[None, :, None] * wc_[:, :, None] * vs[None, :, :]
        Wnd = lax.dynamic_update_slice(Wnd, C.reshape(WP, 3 * B), (lo * 0, lo))

        nq = Qw.shape[0]
        Zc = lax.dynamic_slice(Qw, (lo * 0, lo), (nq, 3 * B)).reshape(nq, B, 3)
        wz = jnp.einsum("nbi,bi->nb", Zc, vs)
        Zc = Zc - taus[None, :, None] * wz[:, :, None] * vs[None, :, :]
        Qw = lax.dynamic_update_slice(Qw, Zc.reshape(nq, 3 * B), (lo * 0, lo))
        return Wnd, Qw

    Wnd, Qw = lax.fori_loop(0, HOP, step, (Wnd, Qw))
    return Wnd, Qw


def _sweep_traced(Spad, Qpad, eyeWC, l, ihi, sh, B: int, ext=DenseExtent):
    """Chase one B-bulge train across padded range [l, ihi) — fully traced.

    ``l``/``ihi`` are traced scalars in padded coordinates, ``sh`` a (B, 4)
    shift tensor.  The train advances in hops of 3B rows: each hop extracts
    the (WC, WC) diagonal window one column left of the train block, runs
    3B in-window steps (:func:`_train_hop`, accumulating the local Qw), and
    applies Qw to the off-window rows/columns and Q at full width — exact,
    since Qw is identity outside the rows the train touched (the
    reference's separate per-tile update tasks, schur/core.c:129-308, exist
    to feed a CPU task pool; here one wide GEMM per hop does the same
    work).  The final partial hop runs masked steps past the end — a no-op
    by the step masks.
    """
    WC = eyeWC.shape[0]               # 6*B + 4
    HOP = 3 * B
    steps = (ihi - l) - 2 + 3 * (B - 1) + 1
    nh = (steps + HOP - 1) // HOP
    sr1, si1, sr2, si2 = sh[:, 0], sh[:, 1], sh[:, 2], sh[:, 3]

    def hop_body(carry):
        h, Spad, Qpad = carry
        s0 = h * HOP
        ws = l + s0 - 3 * (B - 1) - 1
        Wnd = ext.get_block(Spad, ws, ws, WC, WC)
        Wnd2, Qw = _train_hop(Wnd, eyeWC, sr1, si1, sr2, si2,
                              l - ws, ihi - ws, s0, B=B, WC=WC, HOP=HOP)
        Spad = ext.mul_rows(Spad, ws, WC, Qw)
        Spad = ext.mul_cols(Spad, ws, WC, Qw)
        Spad = ext.set_block(Spad, Wnd2, ws, ws)
        Qpad = ext.mul_cols(Qpad, ws, WC, Qw)
        return h + 1, Spad, Qpad

    _, Spad, Qpad = lax.while_loop(lambda c: c[0] < nh, hop_body,
                                   (jnp.int32(0), Spad, Qpad))
    return Spad, Qpad


# stagger between consecutive trains in the wavefront, in hops: windows of
# neighboring trains are 3*HOP = 9B rows apart, > WC = 6B+4 for B >= 2, so
# all active windows are disjoint
_WAVE_STAG = 3


def _sweep_wave(Spad, Qpad, eyeWC, l, ihi, shifts, ntr, G: int, B: int,
                ext=DenseExtent):
    """Chase up to G staggered B-bulge trains across [l, ihi) in ONE pass.

    The batched form of the reference's pipelined window chains
    (schur/core.c:563-782): train g runs ``_WAVE_STAG`` hops behind train
    g-1, so all active chase windows are disjoint and advance in lockstep —
    the in-window kernels run vmapped and the off-window row/column strips
    update batched.  A pass costs ``nh + 3 (ntr-1)`` serial hops instead of
    ``ntr * nh`` for trains chased one after another.

    ``shifts`` is (G, B, 4); trains g >= ntr (and trains outside their hop
    range) are masked: they run with an identity local transform against a
    parking window inside the left padding (row 0; the pad guarantees no
    overlap with any active window).

    Disjointness makes the per-window similarity transforms commute, so
    applying all row strips first and then all column strips is exact.
    """
    WC = eyeWC.shape[0]               # 6*B + 4
    HOP = 3 * B
    steps = (ihi - l) - 2 + 3 * (B - 1) + 1
    nh = (steps + HOP - 1) // HOP     # hops for one train
    total = nh + _WAVE_STAG * (jnp.maximum(ntr, 1) - 1)

    def hop_body(carry):
        h, Spad, Qpad = carry
        g = jnp.arange(G, dtype=jnp.int32)
        hg = h - _WAVE_STAG * g
        active = (hg >= 0) & (hg < nh) & (g < ntr)
        s0 = jnp.where(active, hg, 0) * HOP
        # inactive trains park at ws=0 inside the left padding (all-zero
        # rows/cols; P reserves WC rows for this) with an empty chase range
        # (l_rel=1, ihi_rel=0) so every step masks to an exact no-op
        ws = jnp.where(active, l + s0 - 3 * (B - 1) - 1, 0)
        l_rel = jnp.where(active, l - ws, 1)
        ihi_rel = jnp.where(active, ihi - ws, 0)

        Wnds = ext.get_diag_blocks(Spad, ws, WC)
        Wnd2, Qw = jax.vmap(
            lambda Wnd, sh, lr, ir, s0g: _train_hop(
                Wnd, eyeWC, sh[:, 0], sh[:, 1], sh[:, 2], sh[:, 3],
                lr, ir, s0g, B=B, WC=WC, HOP=HOP),
            in_axes=(0, 0, 0, 0, 0))(Wnds, shifts, l_rel, ihi_rel, s0)

        Spad = ext.mul_rows_batch(Spad, ws, WC, Qw)
        Spad = ext.mul_cols_batch(Spad, ws, WC, Qw)
        Spad = ext.set_diag_blocks(Spad, Wnd2, ws)
        Qpad = ext.mul_cols_batch(Qpad, ws, WC, Qw)
        return h + 1, Spad, Qpad

    _, Spad, Qpad = lax.while_loop(lambda c: c[0] < total, hop_body,
                                   (jnp.int32(0), Spad, Qpad))
    return Spad, Qpad


# ---------------------------------------------------------------------------
# device-side shift selection (reference: extract_shifts task, tasks.c:516 +
# the conjugate-pair alignment of LAPACK dlaqr0)
# ---------------------------------------------------------------------------

def _pack_shifts(er, ei, Tw, kbot, NS: int, B: int, TMAX: int):
    """Select up to NS shifts from the undeflated window diagonal (device).

    ``er/ei`` are the window eigenvalues (conjugate pairs adjacent, the
    2x2-block layout of a real Schur form), ``kbot`` the undeflated row
    count.  Picks the bottom-most even-sized run [start, kbot) that does not
    straddle a 2x2 block, re-aligns conjugate pairs with the published
    dlaqr0 3-rotation shuffle, and packs the pairs bottom-first into a
    (TMAX, B, 4) train tensor of (sr1, si1, sr2, si2) rows, replicating the
    last valid pair into unused slots (a duplicated shift is still a valid
    shift — it emulates a shorter train).

    Returns (shifts, npairs).
    """
    WA = er.shape[0]
    kreq = jnp.minimum(NS, (kbot // 2) * 2)
    start = kbot - kreq
    sc = jnp.clip(start, 1, WA - 1)
    straddle = (start >= 1) & (Tw[sc, sc - 1] != 0)
    start = start + straddle
    kreq = kbot - start
    start = start + (kreq % 2)          # drop the topmost value if odd
    kreq = jnp.maximum(kbot - start, 0)

    j = jnp.arange(NS, dtype=jnp.int32)
    src = jnp.clip(start + j, 0, WA - 1)
    wr = jnp.where(j < kreq, er[src], 0.0)
    wi = jnp.where(j < kreq, ei[src], 0.0)

    def fix(t, c):
        wr, wi = c
        i = kreq - 1 - 2 * t
        ok = i >= 2
        ic = jnp.clip(i, 2, NS - 1)
        bad = ok & (wi[ic] != -wi[ic - 1])

        def rot(a):
            v2, v1, v0 = a[ic], a[ic - 1], a[ic - 2]
            a = a.at[ic].set(jnp.where(bad, v1, v2))
            a = a.at[ic - 1].set(jnp.where(bad, v0, v1))
            a = a.at[ic - 2].set(jnp.where(bad, v2, v0))
            return a

        return rot(wr), rot(wi)

    wr, wi = lax.fori_loop(0, max(NS // 2, 1), fix, (wr, wi))

    npairs = kreq // 2
    pj = jnp.arange(TMAX * B, dtype=jnp.int32)
    pe = jnp.minimum(pj, jnp.maximum(npairs - 1, 0))
    a1 = jnp.clip(kreq - 1 - 2 * pe, 0, NS - 1)
    a0 = jnp.clip(a1 - 1, 0, NS - 1)
    quad = jnp.stack([wr[a1], wi[a1], wr[a0], wi[a0]], axis=-1)
    return quad.reshape(TMAX, B, 4), npairs


# ---------------------------------------------------------------------------
# device-resident AED round
# ---------------------------------------------------------------------------

def _aed_round(Spad, Qpad, ihi, thresh, eyeW,
               P: int, WA: int, NS: int, B: int, TMAX: int, nibble: int,
               ext=DenseExtent):
    """One full AED round — a traced building block of the fused driver.

    Performs: negligible-subdiagonal zeroing, converged-block peel, segment
    scan, AED window Schur solve (Francis), spike deflation with block
    moves, shift extraction + packing, window recondense, and the
    off-window GEMM application of the window transform.  This fuses what
    the reference spreads over the segment state machine's NEW -> AED_* ->
    BULGES transitions (schur/core.c:1878-2293) into straight-line traced
    code inside the one-dispatch driver program (:func:`_schur_fused`).

    Returns (Spad, Qpad, shifts(TMAX,B,4), status(6,) int32) with status =
    [new_ihi, l, ntr, fail, nd, npairs].
    """
    from starneig_jax.ops.small_schur import small_schur

    NP = Spad.shape[0]
    n = NP - 2 * P
    dtype = Spad.dtype

    # -- negligible-subdiagonal zeroing + converged-block peel --
    Spad, sub = ext.zero_negligible(Spad, P, n, ihi, thresh)

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

    def skip(Spad, Qpad):
        z = jnp.zeros((TMAX, B, 4), dtype)
        return (Spad, Qpad, z, ihi, jnp.int32(0), jnp.bool_(False),
                jnp.int32(0), jnp.int32(0))

    def do_aed(Spad, Qpad):
        seg = ihi - l                     # >= 2 after the peel
        w = jnp.minimum(jnp.int32(WA), seg)
        kwtop = ihi - w
        gk = P + kwtop

        win = ext.get_block(Spad, gk, gk, WA, WA)
        r = jnp.arange(WA)
        act = (r[:, None] < w) & (r[None, :] < w)
        win = jnp.where(act, win, 0.0)
        # spike = subdiagonal entering the window; exactly 0 when kwtop == l
        s_spike = jnp.where(kwtop >= 1,
                            sub[jnp.clip(kwtop - 1, 0, n - 1)], 0.0)

        Tw, Vw, sinfo = small_schur(win, eyeW, w, thresh)
        sfail = sinfo != 0

        Tw, Vw, kbot, _dfail = _aed_deflate(Tw, Vw, s_spike, w, thresh)
        nd = w - kbot

        er_w, ei_w = extract_eigenvalues(Tw)
        shifts, npairs = _pack_shifts(er_w, ei_w, Tw, kbot, NS, B, TMAX)

        Tw, Vw, beta = _aed_recondense(Tw, Vw, s_spike, kbot)

        # window transform applied at full extents (exact: Vw is identity
        # outside the active block); rows first, then columns see the
        # left-updated values, then the window block is planted exactly.
        Spad = ext.mul_rows(Spad, gk, WA, Vw)
        Spad = ext.mul_cols(Spad, gk, WA, Vw)
        blk = ext.get_block(Spad, gk, gk, WA, WA)
        Spad = ext.set_block(Spad, jnp.where(act, Tw, blk), gk, gk)
        spk = jnp.where(r[:, None] == 0, beta, 0.0)
        Spad = ext.set_block(Spad, spk, gk, gk - 1)
        Qpad = ext.mul_cols(Qpad, gk, WA, Vw)

        new_ihi = ihi - nd

        # exceptional-shift fallback when the window yielded no usable pair
        tail = ext.get_block(Spad, P + new_ihi - 1,
                             P + jnp.maximum(new_ihi - 2, 0), 1, 2)
        hq = tail[0, 0]
        d0 = jnp.where(new_ihi >= 2, tail[0, 1], tail[0, 0])
        esh = d0 + 0.75 * jnp.abs(hq)
        fb = jnp.stack([esh, 0 * esh, esh, 0 * esh])
        need_fb = npairs == 0
        shifts = jnp.where(need_fb, jnp.broadcast_to(fb, (TMAX, B, 4)),
                           shifts)
        npairs = jnp.where(need_fb, 1, npairs)
        return Spad, Qpad, shifts, new_ihi, npairs, sfail, nd, w

    Spad, Qpad, shifts, new_ihi, npairs, sfail, nd, w = lax.cond(
        converged, skip, do_aed, Spad, Qpad)

    # nibble test (reference core.c:819-824) + tiny-segment skip
    skip_sweep = (((nd > 0) & (100 * nd >= nibble * w))
                  | (new_ihi - l <= 2) | converged | sfail)
    ntr = jnp.where(skip_sweep, 0, (npairs + B - 1) // B)
    status = jnp.stack([new_ihi, l, ntr, sfail.astype(jnp.int32), nd,
                        npairs]).astype(jnp.int32)
    return Spad, Qpad, shifts, status


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _schur_iter(Spad, Qpad, thresh, eyeW, eyeWC,
                P: int = 0, WA: int = 0, NS: int = 0, B: int = 0,
                TMAX: int = 0, nibble: int = 0,
                itmax: int = 0, ext=DenseExtent, n: Optional[int] = None):
    """The whole multishift-QR iteration as ONE device program.

    A ``lax.while_loop`` over AED rounds: each round runs the fused AED
    block (:func:`_aed_round`) and then up to TMAX bulge-chase trains
    (:func:`_sweep_wave`) with the shifts the round extracted.  No
    host<->device traffic at all until the final Schur form comes back —
    the reference's asynchronous segment state machine (schur/core.c:
    2295-2336) exists to hide task latency on a CPU pool; here the same
    control flow is scalar work the device itself executes between GEMMs.

    ``n`` (the active problem size) defaults to ``NP - 2 P``; the DM driver
    passes it explicitly because its buffer is rounded up to a
    shard-divisible width.  ``ext`` selects the extent-op strategy (dense
    vs sharded collectives).  The loop runs to convergence, to a segment
    exceeding ``itmax`` iterations, or to the global cap of ``2 n + 10``
    rounds, whichever comes first.

    Returns (Spad, Qpad, state) with state = int32[5] [ihi, it_seg,
    last_ihi, fail, rounds] — converged when ihi == 0 and fail == 0.
    """
    if n is None:
        n = Spad.shape[0] - 2 * P

    def cond(st):
        Spad, Qpad, ihi, it_seg, last_ihi, fail, rounds = st
        return (ihi > 0) & (fail == 0) & (rounds < 2 * n + 10)

    def body(st):
        Spad, Qpad, ihi, it_seg, last_ihi, fail, rounds = st
        Spad, Qpad, shifts, status = _aed_round(
            Spad, Qpad, ihi, thresh, eyeW,
            P=P, WA=WA, NS=NS, B=B, TMAX=TMAX, nibble=nibble, ext=ext)
        new_ihi, l, ntr, sfail, nd, npairs = (status[i] for i in range(6))
        it_seg = jnp.where(new_ihi != last_ihi, 0, it_seg) + 1
        # a non-converged AED window is NOT fatal (LAPACK dlaqr3 semantics:
        # use whatever deflated, skip the sweep — _aed_round already zeroes
        # ntr on sfail); only the per-segment iteration limit fails
        fail = (it_seg > itmax).astype(jnp.int32)

        def sweeps(ops):
            Spad, Qpad = ops
            return _sweep_wave(Spad, Qpad, eyeWC, P + l, P + new_ihi,
                               shifts, ntr, G=TMAX, B=B, ext=ext)

        Spad, Qpad = lax.cond((ntr > 0) & (fail == 0), sweeps,
                              lambda ops: ops, (Spad, Qpad))
        return (Spad, Qpad, jnp.where(fail != 0, ihi, new_ihi), it_seg,
                new_ihi, fail, rounds + 1)

    z = jnp.int32(0)
    st = (Spad, Qpad, jnp.int32(n), z, jnp.int32(n), z, z)
    Spad, Qpad, ihi, it_seg, last_ihi, fail, rounds = lax.while_loop(
        cond, body, st)
    return Spad, Qpad, jnp.stack([ihi, it_seg, last_ihi, fail, rounds])


_schur_fused = functools.partial(jax.jit, donate_argnums=(0, 1),
                                 static_argnames=("P", "WA", "NS", "B",
                                                  "TMAX", "nibble", "itmax",
                                                  "ext", "n"))(_schur_iter)


def status_info(state) -> Error:
    """Map a driver state vector to the reference's error code: a failed
    segment, or a global-round-cap exit with ihi > 0, leaves a partially
    reduced (still similar) matrix."""
    st = np.asarray(state)
    return (Error.DID_NOT_CONVERGE if (int(st[3]) or int(st[0]) > 0)
            else Error.SUCCESS)


class SchurGeometry(NamedTuple):
    """Static shapes of the fused driver (all derived from the resolved
    expert configuration)."""

    WA: int     # AED window (aed_window_size + 2, the reference's kwtop pad)
    NS: int     # shifts per AED round
    B: int      # bulges per train
    WC: int     # in-window chase window, 6 B + 4 (~ window_size)
    TMAX: int   # trains per round
    P: int      # padding on each side of the matrix in the padded buffer


def schur_geometry(n: int, conf: SchurConf) -> SchurGeometry:
    """Driver geometry from a resolved :class:`SchurConf` — a pure function
    of ``n`` and the expert values, the same on every backend."""
    WA = min(max(32, conf.aed_window_size + 2), n)
    NS = max(2, min(conf.aed_shift_count // 2 * 2, 2 * (WA // 2)))
    B = max(2, min(conf.shifts_per_window // 2, NS // 2, max(2, n // 12)))
    WC = 6 * B + 4
    TMAX = max(1, (NS // 2 + B - 1) // B)
    # + WC: parking zone for masked wavefront trains (_sweep_wave)
    P = max(3 * B + 4, WC + 2, WA) + 2 + WC
    return SchurGeometry(WA, NS, B, WC, TMAX, P)


def _fused_statics(g: SchurGeometry, conf: SchurConf) -> dict:
    return dict(P=g.P, WA=g.WA, NS=g.NS, B=g.B, TMAX=g.TMAX,
                nibble=conf.aed_nibble, itmax=conf.iteration_limit)


@full_precision
def schur_lowered(n: int, dtype=jnp.float64,
                  conf: Optional[SchurConf] = None):
    """The lowered (pre-compile) fused Schur program the public
    ``api.sep.schur`` runs for an (n, n) problem above the small limit —
    for compile-time and ``memory_analysis()`` reports without running the
    solve."""
    conf = (conf or SchurConf()).resolve(n)
    g = schur_geometry(n, conf)
    NP = n + 2 * g.P

    def sds(*shape):
        return jax.ShapeDtypeStruct(shape, dtype)

    return _schur_fused.lower(sds(NP, NP), sds(n, NP), sds(),
                              sds(g.WA, g.WA), sds(g.WC, g.WC),
                              **_fused_statics(g, conf))


def _resolve_threshold(H, conf, dtype):
    """Deflation threshold (norm-stable default, reference core.c:2428-2462)."""
    tiny = float(np.finfo(np.float32).tiny if dtype == jnp.float32
                 else np.finfo(np.float64).tiny)
    u = float(jnp.finfo(dtype).eps) / 2
    if conf.left_threshold == DeflationCriterion.NORM_STABLE:
        thresh = u * jnp.linalg.norm(H)
    elif conf.left_threshold == DeflationCriterion.LAPACK:
        thresh = jnp.asarray(tiny, dtype)
    else:
        thresh = jnp.asarray(float(conf.left_threshold), dtype)
    return jnp.maximum(thresh, tiny).astype(dtype)


def schur(H, Q=None, conf: Optional[SchurConf] = None):
    """Reduce an upper Hessenberg H to real Schur form S = Qs^T H Qs.

    Mirrors ``starneig_SEP_SM_Schur`` (reference: sep_sm.h:159-227): Q (if
    given) is accumulated on the right, eigenvalues are extracted from the
    final Schur form.

    The ENTIRE iteration — every AED round (deflation scan, window Schur
    solve, spike deflation, shift extraction, recondense, window-transform
    GEMMs) and every bulge-chase sweep — executes as ONE jitted device
    program (:func:`_schur_fused`) dispatched once; the host gets back the
    finished Schur form.  One program also means one compilation per (n,
    geometry, dtype), amortized by the persistent compilation cache.

    Consumed expert knobs (reference expert.h:198-361): ``aed_window_size``
    (AED window), ``aed_shift_count`` (shifts per sweep),
    ``shifts_per_window``/``window_size`` (bulges per train B =
    shifts_per_window/2, chase window 6B+4 ~= window_size),
    ``aed_nibble``, ``iteration_limit``, and the deflation criteria.
    ``update_width``/``update_height`` are accepted but unused: off-window
    updates run at full width as one GEMM per window transform.

    Returns:
      (S, Q, eig_real, eig_imag, info) with info == Error.SUCCESS or
      Error.DID_NOT_CONVERGE (outputs then hold a partially reduced,
      still-similar matrix — reference error semantics, error.h:105-111).
    """
    H = jnp.asarray(H)
    n = H.shape[0]
    dtype = H.dtype
    Q = jnp.eye(n, dtype=dtype) if Q is None else jnp.asarray(Q)
    conf = (conf or SchurConf()).resolve(n)

    if n <= min(conf.small_limit, 300):
        # whole problem below the small limit: one Francis dispatch
        # (reference small-segment path, schur/core.c:1309)
        thresh = _resolve_threshold(H, conf, dtype)
        S0, Z, sinfo = small_schur(H, jnp.eye(n, dtype=dtype), n, thresh)
        info = Error.SUCCESS if int(sinfo) == 0 else Error.DID_NOT_CONVERGE
        S0, QZ = standardize_blocks(S0, Q @ Z)
        er, ei = extract_eigenvalues(S0)
        return S0, QZ, er, ei, info

    g = schur_geometry(n, conf)
    P = g.P
    NP = n + 2 * P

    Spad = jnp.zeros((NP, NP), dtype)
    Spad = lax.dynamic_update_slice(Spad, H, (P, P))
    Qpad = jnp.zeros((n, NP), dtype)
    Qpad = lax.dynamic_update_slice(Qpad, Q, (0, P))

    thresh = _resolve_threshold(H, conf, dtype)
    eyeW = jnp.eye(g.WA, dtype=dtype)
    eyeWC = jnp.eye(g.WC, dtype=dtype)

    Spad, Qpad, state = _schur_fused(Spad, Qpad, thresh, eyeW, eyeWC,
                                     **_fused_statics(g, conf))
    info = status_info(state)
    if os.environ.get("STARNEIG_DEBUG_ROUNDS"):
        print(f"[schur] n={n} WA={g.WA} NS={g.NS} B={g.B} TMAX={g.TMAX} "
              f"rounds={int(np.asarray(state)[4])}", flush=True)

    S = lax.dynamic_slice(Spad, (P, P), (n, n))
    Qf = lax.dynamic_slice(Qpad, (0, P), (n, n))
    S, Qf = standardize_blocks(S, Qf)
    er, ei = extract_eigenvalues(S)
    return S, Qf, er, ei, info
