"""Eigenvalue reordering: move selected eigenvalues to the top-left.

JAX rebuild of the reference reorder component
(``src/reorder/``, SURVEY.md section 2.4): selected 1x1/2x2 blocks bubble to
the leading diagonal positions through chains of overlapping diagonal
windows.  All swap work is confined to a fixed-size window processed by one
jitted kernel (a bounded while loop over adjacent block swaps
accumulating a local orthogonal Q_w, see ops/control.py); the off-window
rows/columns and Q are then updated
with three large GEMMs.  Windows chain bottom-to-top, each
carrying up to ``cap`` selected rows (the reference's values-per-chain,
expert.h:439-525); outer passes repeat until the selection is a leading
prefix.

Window placement never needs to split a 2x2 block: the kernel takes frozen
margins (``dst0`` rows at the top, rows >= ``wlim`` at the bottom) so a
window whose edge falls inside a 2x2 block simply excludes the straddling
half from processing.

Failed (ill-conditioned) swaps deselect the stuck eigenvalue and report
``PARTIAL_REORDERING`` — the output is always a valid Schur form with the
selection vector updated (reference: error.h:114-119, sep_sm.h:139-144).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.config import ReorderConf
from starneig_jax.errors import Error
from starneig_jax.ops.control import make_bounded_while
from starneig_jax.ops.swaps import swap_adjacent


# ---------------------------------------------------------------------------
# window kernel
# ---------------------------------------------------------------------------

def _window_bubble(Tw, sel, dst0, dst_limit, wlim):
    """Bubble selected blocks to the top of the window.

    Args:
      Tw: (W, W) quasi-triangular window (a diagonal block of S).
      sel: (W,) bool selection, 2x2-block aligned.
      dst0: first row of the insertion region (rows < dst0 are frozen — they
        belong to a block straddling the window's top edge).
      dst_limit: stop once the insertion point reaches this row.
      wlim: rows >= wlim are frozen (straddling bottom edge).

    Returns:
      (Tw', Qw, sel', dst, nfail): updated window, accumulated local
      transform (Tw' = Qw^T Tw Qw), updated selection, next insertion row,
      number of rejected swaps.
    """
    W = Tw.shape[0]
    WP = W + 4
    dtype = Tw.dtype
    Tp = jnp.zeros((WP, WP), dtype).at[:W, :W].set(Tw)
    Qp = jnp.zeros((W, WP), dtype).at[:, :W].set(jnp.eye(W, dtype=dtype))
    sel = jnp.concatenate([sel, jnp.zeros((4,), bool)])  # pad: dynamic slices
    # near the bottom edge must not clamp (that would shift the window)
    init = (Tp, Qp, sel, jnp.int32(dst0), jnp.int32(-1), jnp.int32(0),
            jnp.int32(0), jnp.bool_(False), jnp.int32(dst_limit),
            jnp.int32(wlim))
    Tp, Qp, sel, dst, src, nfail, steps, done, _dl, _wl = _run_bubble(init)
    return Tp[:W, :W], Qp[:, :W], sel[:W], dst, nfail


def _bs_mask(Tp, W):
    sub = jnp.diagonal(Tp[:W, :W], offset=-1)
    return jnp.concatenate([jnp.ones((1,), bool), sub == 0])


def _bsize(Tp, W, s):
    below = jnp.where(s + 1 < W, Tp[jnp.minimum(s + 1, W - 1), s], 0.0)
    return jnp.where(below == 0, 1, 2)


def _bubble_cond(state):
    Tp = state[0]
    W = state[1].shape[0]
    dst, src, nfail, steps, done = state[3], state[4], state[5], state[6], state[7]
    return (~done) & (steps < 4 * W * W)


def _bubble_scan(state):
    Tp, Qp, sel, dst, src, nfail, steps, done, dst_limit, wlim = state
    W = Qp.shape[0]
    idx = jnp.arange(W, dtype=jnp.int32)
    bs = _bs_mask(Tp, W)
    cand = bs & sel[:W] & (idx >= dst) & (idx < wlim)
    s = jnp.min(jnp.where(cand, idx, W))
    new_done = (s >= W) | (dst >= dst_limit)
    at_dst = (s == dst) & ~new_done
    sz = _bsize(Tp, W, jnp.minimum(s, W - 1))
    dst = jnp.where(at_dst, dst + sz, dst)
    src = jnp.where(new_done | at_dst, -1, s)
    return Tp, Qp, sel, dst, src, nfail, steps + 1, new_done, dst_limit, wlim


def _bubble_swap(state):
    Tp, Qp, sel, dst, src, nfail, steps, done, dst_limit, wlim = state
    W = Qp.shape[0]
    WP = W + 4
    bs = _bs_mask(Tp, W)
    # block start immediately above src
    a = jnp.where((src >= 2) & ~bs[jnp.maximum(src - 1, 0)], src - 2, src - 1)
    p = src - a
    q = _bsize(Tp, W, src)
    D4 = lax.dynamic_slice(Tp, (a, a), (4, 4))
    Qs, Dh, accept = swap_adjacent(D4, p, q)
    rows = lax.dynamic_slice(Tp, (a, a * 0), (4, WP))
    Tp = lax.dynamic_update_slice(Tp, Qs.T @ rows, (a, a * 0))
    cols = lax.dynamic_slice(Tp, (a * 0, a), (WP, 4))
    Tp = lax.dynamic_update_slice(Tp, cols @ Qs, (a * 0, a))
    Tp = lax.dynamic_update_slice(Tp, Dh, (a, a))
    qc = lax.dynamic_slice(Qp, (a * 0, a), (W, 4))
    Qp = lax.dynamic_update_slice(Qp, qc @ Qs, (a * 0, a))
    old4 = lax.dynamic_slice(sel, (a,), (4,))
    i4 = jnp.arange(4)
    moved = jnp.where(i4 < q, True, jnp.where(i4 < p + q, False, old4))
    stuck = jnp.where((i4 >= p) & (i4 < p + q), False, old4)
    new4 = jnp.where(accept, moved, stuck)
    sel = lax.dynamic_update_slice(sel, new4, (a,))
    new_src = jnp.where(accept, a, -1)
    arrived = accept & (new_src == dst)
    dst = jnp.where(arrived, dst + q, dst)
    new_src = jnp.where(arrived, -1, new_src)
    nfail = nfail + jnp.where(accept, 0, 1)
    return Tp, Qp, sel, dst, new_src, nfail, steps + 1, done, dst_limit, wlim


def _bubble_body(state):
    return lax.cond(state[4] < 0, _bubble_scan, _bubble_swap, state)


_run_bubble = make_bounded_while(_bubble_cond, _bubble_body)

# batched (vmapped) variant: G independent windows advance in lockstep; a
# finished lane's body application is a stable no-op, so lanes may finish at
# different times (this is the batched replacement for the reference's
# pipelined multi-chain window parallelism, expert.h:527-565)
_bubble_body_b = jax.vmap(_bubble_body)


def _bubble_cond_b(state):
    return jnp.any(jax.vmap(_bubble_cond)(state))


_run_bubble_b = make_bounded_while(_bubble_cond_b, _bubble_body_b)


def _window_bubble_batch(Tws, sels, dst0s, dst_limits, wlims):
    """Batched _window_bubble over G stacked windows."""
    G, W = Tws.shape[0], Tws.shape[1]
    WP = W + 4
    dtype = Tws.dtype
    Tp = jnp.zeros((G, WP, WP), dtype).at[:, :W, :W].set(Tws)
    Qp = jnp.zeros((G, W, WP), dtype).at[:, :, :W].set(
        jnp.broadcast_to(jnp.eye(W, dtype=dtype), (G, W, W)))
    sel = jnp.concatenate([sels, jnp.zeros((G, 4), bool)], axis=1)
    zi = jnp.zeros((G,), jnp.int32)
    init = (Tp, Qp, sel, dst0s.astype(jnp.int32), zi - 1, zi,
            zi, jnp.zeros((G,), bool), dst_limits.astype(jnp.int32),
            wlims.astype(jnp.int32))
    Tp, Qp, sel, dst, src, nfail, steps, done, _dl, _wl = _run_bubble_b(init)
    return Tp[:, :W, :W], Qp[:, :, :W], sel[:, :W], dst, nfail


@functools.partial(jax.jit, static_argnames=("W",))
def _gather_windows(S, ws, W: int):
    return jax.vmap(lambda w0: lax.dynamic_slice(S, (w0, w0), (W, W)))(ws)


# ---------------------------------------------------------------------------
# off-window updates (the GEMM work)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0, 1))
def _apply_window(S, Q, Tw, Qw, ws):
    """Apply the window transform: S <- diag(I,Qw,I)^T S diag(I,Qw,I), Q <- Q diag."""
    n = S.shape[0]
    W = Tw.shape[0]
    rows = lax.dynamic_slice(S, (ws, 0), (W, n))
    S = lax.dynamic_update_slice(S, Qw.T @ rows, (ws, 0))
    cols = lax.dynamic_slice(S, (0, ws), (n, W))
    S = lax.dynamic_update_slice(S, cols @ Qw, (0, ws))
    S = lax.dynamic_update_slice(S, Tw, (ws, ws))
    qc = lax.dynamic_slice(Q, (0, ws), (n, W))
    Q = lax.dynamic_update_slice(Q, qc @ Qw, (0, ws))
    return S, Q


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _apply_windows_batch(S, Q, Tws, Qws, ws):
    """Apply G DISJOINT window transforms in one dispatch: batched row
    strips, then batched column strips, then plant the window blocks.
    Disjointness makes the per-window similarity transforms commute, so the
    rows-then-columns order is exact (the batched analogue of the
    reference's independent per-window update tasks, reorder/core.c)."""
    n = S.shape[0]
    G, W = Tws.shape[0], Tws.shape[1]

    R = jax.vmap(lambda w0: lax.dynamic_slice(S, (w0, w0 * 0), (W, n)))(ws)
    R = jnp.einsum("gij,gjn->gin", jnp.swapaxes(Qws, 1, 2), R)
    S = lax.fori_loop(
        0, G, lambda g, S: lax.dynamic_update_slice(S, R[g], (ws[g], ws[g] * 0)),
        S)
    C = jax.vmap(lambda w0: lax.dynamic_slice(S, (w0 * 0, w0), (n, W)))(ws)
    C = jnp.einsum("gnj,gjk->gnk", C, Qws)
    S = lax.fori_loop(
        0, G, lambda g, S: lax.dynamic_update_slice(S, C[g], (ws[g] * 0, ws[g])),
        S)
    S = lax.fori_loop(
        0, G, lambda g, S: lax.dynamic_update_slice(S, Tws[g], (ws[g], ws[g])),
        S)
    nq = Q.shape[0]
    QC = jax.vmap(lambda w0: lax.dynamic_slice(Q, (w0 * 0, w0), (nq, W)))(ws)
    QC = jnp.einsum("gnj,gjk->gnk", QC, Qws)
    Q = lax.fori_loop(
        0, G, lambda g, Q: lax.dynamic_update_slice(Q, QC[g], (ws[g] * 0, ws[g])),
        Q)
    return S, Q


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

def _align_select(subdiag: np.ndarray, select: np.ndarray) -> np.ndarray:
    """Make the selection 2x2-block atomic (reference: helpers.c:46-159)."""
    sel = select.copy()
    n = len(sel)
    i = 0
    while i < n - 1:
        if subdiag[i] != 0:  # block [i, i+1]
            v = bool(sel[i] or sel[i + 1])
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            i += 1
    return sel


def _prefix_len(subdiag: np.ndarray, sel: np.ndarray) -> int:
    """Rows m such that sel[0:m] is a full leading run of selected blocks."""
    n = len(sel)
    m = 0
    while m < n and sel[m]:
        m += 2 if (m < n - 1 and subdiag[m] != 0) else 1
    return m


def reorder_schur(S, Q, select, conf: Optional[ReorderConf] = None):
    """Reorder a real Schur form so selected eigenvalues lead.

    Mirrors ``starneig_SEP_SM_ReorderSchur`` (reference:
    ``src/include/starneig/sep_sm.h:89-157``).

    Args:
      S: (n, n) real Schur form.
      Q: (n, n) orthogonal accumulation matrix.
      select: (n,) bool array; 2x2 blocks are selected atomically (a pair is
        selected if either entry is).
      conf: optional ReorderConf; -1 fields auto-resolve.

    Returns:
      (S, Q, num_selected, info): updated Schur form and Q; rows in the final
      leading block; info == Error.SUCCESS or Error.PARTIAL_REORDERING.
    """
    S = jnp.asarray(S) + 0.0   # _apply_window donates: keep caller's arrays
    Q = jnp.asarray(Q) + 0.0
    n = S.shape[0]

    def get_subdiag():
        return np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]])

    subdiag = get_subdiag()
    sel = _align_select(subdiag, np.asarray(select, bool).copy())

    if conf is None:
        conf = ReorderConf()
    ratio = float(sel.sum()) / max(n, 1)
    rconf = conf.resolve(n, workers=1, select_ratio=ratio)
    W = min(rconf.window_size, n)
    # values moved per window pass: the reference's values_per_chain knob
    # (expert.h:727-733; default ~W/2 - 2) bounds how many selected rows a
    # window carries before handing off to the next chain window
    cap = W if W >= n else max(2, min(rconf.values_per_chain, W // 2))
    total_fail = 0

    while True:
        m = _prefix_len(subdiag, sel)
        below = np.nonzero(sel[m:n])[0]
        if below.size == 0:
            break
        lowest = m + int(below[-1])
        bsz = 2 if subdiag[lowest] != 0 else 1
        if subdiag[lowest - 1] != 0 and lowest > 0:
            lowest, bsz = lowest - 1, 2  # landed on the second row of a pair
        ws = min(max(m, lowest + bsz - W), n - W)
        while True:
            wlo = 1 if (ws > 0 and subdiag[ws - 1] != 0) else 0
            wlim = W - 1 if (ws + W < n and subdiag[ws + W - 1] != 0) else W
            Tw = lax.dynamic_slice(S, (ws, ws), (W, W))
            sel_w = jnp.asarray(sel[ws:ws + W])
            Tw2, Qw, sel_w2, dst, nfail = _window_bubble(
                Tw, sel_w, wlo, min(wlo + cap, W), wlim
            )
            total_fail += int(nfail)
            S, Q = _apply_window(S, Q, Tw2, Qw, ws)
            sel[ws:ws + W] = np.asarray(sel_w2)
            subdiag[ws:ws + W - 1] = np.asarray(jnp.diagonal(Tw2, offset=-1))
            if ws <= m:
                break
            carried = int(dst) - wlo
            ws = max(m, ws + wlo + carried - W)

    m = _prefix_len(get_subdiag(), sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    return S, Q, m, info


# ===========================================================================
# generalized (pencil) variant — mirrors the SEP machinery with left/right
# transforms and dtgex2-style swaps (reference: GEP reorder, reorder/lapack.c:114)
# ===========================================================================

from starneig_jax.ops.swaps_gep import swap_adjacent_gep  # noqa: E402


def _gep_bubble_cond(state):
    Qp = state[2]
    W = Qp.shape[0]
    done = state[9]
    steps = state[8]
    return (~done) & (steps < 4 * W * W)


def _gep_bubble_scan(state):
    Sp, Tp, Qp, Zp, sel, dst, src, nfail, steps, done, dst_limit, wlim = state
    W = Qp.shape[0]
    idx = jnp.arange(W, dtype=jnp.int32)
    bs = _bs_mask(Sp, W)
    cand = bs & sel[:W] & (idx >= dst) & (idx < wlim)
    s = jnp.min(jnp.where(cand, idx, W))
    new_done = (s >= W) | (dst >= dst_limit)
    at_dst = (s == dst) & ~new_done
    sz = _bsize(Sp, W, jnp.minimum(s, W - 1))
    dst = jnp.where(at_dst, dst + sz, dst)
    src = jnp.where(new_done | at_dst, -1, s)
    return (Sp, Tp, Qp, Zp, sel, dst, src, nfail, steps + 1, new_done,
            dst_limit, wlim)


def _gep_bubble_swap(state):
    Sp, Tp, Qp, Zp, sel, dst, src, nfail, steps, done, dst_limit, wlim = state
    W = Qp.shape[0]
    WP = W + 4
    bs = _bs_mask(Sp, W)
    a = jnp.where((src >= 2) & ~bs[jnp.maximum(src - 1, 0)], src - 2, src - 1)
    p = src - a
    q = _bsize(Sp, W, src)
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
    qc = lax.dynamic_slice(Qp, (a * 0, a), (W, 4))
    Qp = lax.dynamic_update_slice(Qp, qc @ Qs, (a * 0, a))
    zc = lax.dynamic_slice(Zp, (a * 0, a), (W, 4))
    Zp = lax.dynamic_update_slice(Zp, zc @ Zs, (a * 0, a))
    old4 = lax.dynamic_slice(sel, (a,), (4,))
    i4 = jnp.arange(4)
    moved = jnp.where(i4 < q, True, jnp.where(i4 < p + q, False, old4))
    stuck = jnp.where((i4 >= p) & (i4 < p + q), False, old4)
    new4 = jnp.where(accept, moved, stuck)
    sel = lax.dynamic_update_slice(sel, new4, (a,))
    new_src = jnp.where(accept, a, -1)
    arrived = accept & (new_src == dst)
    dst = jnp.where(arrived, dst + q, dst)
    new_src = jnp.where(arrived, -1, new_src)
    nfail = nfail + jnp.where(accept, 0, 1)
    return (Sp, Tp, Qp, Zp, sel, dst, new_src, nfail, steps + 1, done,
            dst_limit, wlim)


def _gep_bubble_body(state):
    return lax.cond(state[6] < 0, _gep_bubble_scan, _gep_bubble_swap, state)


_run_gep_bubble = make_bounded_while(_gep_bubble_cond, _gep_bubble_body)


def _window_bubble_gep(Sw, Tw, sel, dst0, dst_limit, wlim):
    """Pencil version of _window_bubble; returns (Sw, Tw, Qw, Zw, sel, dst, nfail)."""
    W = Sw.shape[0]
    WP = W + 4
    dtype = Sw.dtype
    Sp = jnp.zeros((WP, WP), dtype).at[:W, :W].set(Sw)
    Tp = jnp.zeros((WP, WP), dtype).at[:W, :W].set(Tw)
    Qp = jnp.zeros((W, WP), dtype).at[:, :W].set(jnp.eye(W, dtype=dtype))
    Zp = jnp.zeros((W, WP), dtype).at[:, :W].set(jnp.eye(W, dtype=dtype))
    sel = jnp.concatenate([sel, jnp.zeros((4,), bool)])
    init = (Sp, Tp, Qp, Zp, sel, jnp.int32(dst0), jnp.int32(-1), jnp.int32(0),
            jnp.int32(0), jnp.bool_(False), jnp.int32(dst_limit),
            jnp.int32(wlim))
    Sp, Tp, Qp, Zp, sel, dst, src, nfail, *_ = _run_gep_bubble(init)
    return (Sp[:W, :W], Tp[:W, :W], Qp[:, :W], Zp[:, :W], sel[:W], dst, nfail)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _apply_window_gep(S, T, Q, Z, Sw, Tw, Qw, Zw, ws):
    """S <- diag(I,Qw,I)^T S diag(I,Zw,I) etc.; Q <- Q Qw, Z <- Z Zw."""
    n = S.shape[0]
    W = Sw.shape[0]
    rows = lax.dynamic_slice(S, (ws, 0), (W, n))
    S = lax.dynamic_update_slice(S, Qw.T @ rows, (ws, 0))
    rows = lax.dynamic_slice(T, (ws, 0), (W, n))
    T = lax.dynamic_update_slice(T, Qw.T @ rows, (ws, 0))
    cols = lax.dynamic_slice(S, (0, ws), (n, W))
    S = lax.dynamic_update_slice(S, cols @ Zw, (0, ws))
    cols = lax.dynamic_slice(T, (0, ws), (n, W))
    T = lax.dynamic_update_slice(T, cols @ Zw, (0, ws))
    S = lax.dynamic_update_slice(S, Sw, (ws, ws))
    T = lax.dynamic_update_slice(T, Tw, (ws, ws))
    qc = lax.dynamic_slice(Q, (0, ws), (n, W))
    Q = lax.dynamic_update_slice(Q, qc @ Qw, (0, ws))
    zc = lax.dynamic_slice(Z, (0, ws), (n, W))
    Z = lax.dynamic_update_slice(Z, zc @ Zw, (0, ws))
    return S, T, Q, Z


def reorder_schur_gep(S, T, Q, Z, select, conf: Optional[ReorderConf] = None):
    """Reorder a generalized real Schur form so selected eigenvalues lead.

    Mirrors ``starneig_GEP_SM_ReorderSchur`` (reference: gep_sm.h:162-235).

    Returns (S, T, Q, Z, num_selected, info).
    """
    S = jnp.asarray(S) + 0.0
    T = jnp.asarray(T) + 0.0
    Q = jnp.asarray(Q) + 0.0
    Z = jnp.asarray(Z) + 0.0
    n = S.shape[0]

    subdiag = np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]])
    sel = _align_select(subdiag, np.asarray(select, bool).copy())

    if conf is None:
        conf = ReorderConf()
    ratio = float(sel.sum()) / max(n, 1)
    rconf = conf.resolve(n, workers=1, select_ratio=ratio)
    W = min(rconf.window_size, n)
    # values moved per window pass: the reference's values_per_chain knob
    # (expert.h:727-733; default ~W/2 - 2) bounds how many selected rows a
    # window carries before handing off to the next chain window
    cap = W if W >= n else max(2, min(rconf.values_per_chain, W // 2))
    total_fail = 0

    while True:
        m = _prefix_len(subdiag, sel)
        below = np.nonzero(sel[m:n])[0]
        if below.size == 0:
            break
        lowest = m + int(below[-1])
        bsz = 2 if subdiag[lowest] != 0 else 1
        if lowest > 0 and subdiag[lowest - 1] != 0:
            lowest, bsz = lowest - 1, 2
        ws = min(max(m, lowest + bsz - W), n - W)
        while True:
            wlo = 1 if (ws > 0 and subdiag[ws - 1] != 0) else 0
            wlim = W - 1 if (ws + W < n and subdiag[ws + W - 1] != 0) else W
            Sw = lax.dynamic_slice(S, (ws, ws), (W, W))
            Tw = lax.dynamic_slice(T, (ws, ws), (W, W))
            sel_w = jnp.asarray(sel[ws:ws + W])
            Sw2, Tw2, Qw, Zw, sel_w2, dst, nfail = _window_bubble_gep(
                Sw, Tw, sel_w, wlo, min(wlo + cap, W), wlim)
            total_fail += int(nfail)
            S, T, Q, Z = _apply_window_gep(S, T, Q, Z, Sw2, Tw2, Qw, Zw, ws)
            sel[ws:ws + W] = np.asarray(sel_w2)
            subdiag[ws:ws + W - 1] = np.asarray(jnp.diagonal(Sw2, offset=-1))
            if ws <= m:
                break
            carried = int(dst) - wlo
            ws = max(m, ws + wlo + carried - W)

    m = _prefix_len(
        np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]]), sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    return S, T, Q, Z, m, info


def reorder_schur_parallel(S, Q, select, conf: Optional[ReorderConf] = None):
    """Wave-parallel reordering: disjoint windows bubble simultaneously.

    Each pass lays a grid of disjoint windows over [m, n) (alternating the
    grid offset by W/2 between passes so values cross window boundaries),
    runs the bubble kernel on all of them in one vmapped call, and applies
    the per-window transforms as asynchronously dispatched GEMMs.  Selected
    eigenvalues advance ~W/2 rows per pass — the latency is ~passes windows
    instead of ~(chain length x chains).

    Same contract as reorder_schur.
    """
    S = jnp.asarray(S) + 0.0
    Q = jnp.asarray(Q) + 0.0
    n = S.shape[0]

    subdiag = np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]])
    sel = _align_select(subdiag, np.asarray(select, bool).copy())

    if conf is None:
        conf = ReorderConf()
    ratio = float(sel.sum()) / max(n, 1)
    rconf = conf.resolve(n, workers=1, select_ratio=ratio)
    W = min(rconf.window_size, n)
    if n < 2 * W:
        return reorder_schur(S, Q, sel, conf)

    # every batch runs GMAX lanes, so one program per (n, W) compiles;
    # unused lanes park on an all-zero W x W region appended past row n
    # (nothing selected there: an exact no-op)
    GMAX = (n + W - 1) // W
    Sp = jnp.zeros((n + W, n + W), S.dtype).at[:n, :n].set(S)
    Qp = jnp.zeros((n, n + W), S.dtype).at[:, :n].set(Q)

    def get_subdiag():
        return np.concatenate(
            [np.asarray(jnp.diagonal(Sp[:n, :n], offset=-1)), [0.0]])

    debug = bool(os.environ.get("STARNEIG_DEBUG_ROUNDS"))
    total_fail = 0
    offset_toggle = 0
    guard = 0
    while True:
        m = _prefix_len(subdiag, sel)
        if debug:
            pend = np.nonzero(sel[m:n])[0][:4] + m
            print(f"[reorder] pass {guard} W={W} leading={m} "
                  f"pending={int(sel[m:n].sum())} at {pend.tolist()} "
                  f"fails={total_fail}", flush=True)
        if not sel[m:n].any():
            break
        guard += 1
        if guard > 8 * (n // max(W // 2, 1) + 2):
            # fall back to the sequential chain for stragglers
            S, Q, m, info2 = reorder_schur(Sp[:n, :n], Qp[:, :n], sel, conf)
            total_fail += int(info2 == Error.PARTIAL_REORDERING)
            return S, Q, m, (Error.PARTIAL_REORDERING if total_fail
                             else Error.SUCCESS)
        # grid of disjoint windows covering [m, n)
        start = m + (offset_toggle * (W // 2))
        offset_toggle ^= 1
        ws_list = []
        w0 = start
        while w0 + W <= n:
            ws_list.append(w0)
            w0 += W
        if not ws_list or (n - (ws_list[-1] + W)) > 0:
            last = n - W
            if not ws_list or last > ws_list[-1]:
                ws_list.append(last)  # may overlap its neighbor; process it
                # in a separate second batch to preserve disjointness
        tail_overlap = len(ws_list) >= 2 and ws_list[-1] < ws_list[-2] + W
        main_ws = ws_list[:-1] if tail_overlap else ws_list
        batches = [main_ws] + ([[ws_list[-1]]] if tail_overlap else [])
        for group in batches:
            if not group:
                continue
            ws_arr = np.full((GMAX,), n, np.int32)
            ws_arr[:len(group)] = group
            wlo = np.zeros((GMAX,), np.int32)
            wlim = np.full((GMAX,), W, np.int32)
            sels = np.zeros((GMAX, W), bool)
            for g, w0 in enumerate(group):
                wlo[g] = 1 if (w0 > 0 and subdiag[w0 - 1] != 0) else 0
                if w0 + W < n and subdiag[w0 + W - 1] != 0:
                    wlim[g] = W - 1
                sels[g] = sel[w0:w0 + W]
            Tws = _gather_windows(Sp, jnp.asarray(ws_arr), W)
            Tw2, Qw2, sel2, dsts, nfails = _window_bubble_batch(
                Tws, jnp.asarray(sels), jnp.asarray(wlo), jnp.asarray(wlim),
                jnp.asarray(wlim))
            total_fail += int(np.asarray(nfails).sum())
            Sp, Qp = _apply_windows_batch(Sp, Qp, Tw2, Qw2,
                                          jnp.asarray(ws_arr))
            sel2 = np.asarray(sel2)
            for g, w0 in enumerate(group):
                sel[w0:w0 + W] = sel2[g]
            subdiag = get_subdiag()

    m = _prefix_len(subdiag, sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    return Sp[:n, :n], Qp[:, :n], m, info
