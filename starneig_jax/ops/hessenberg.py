"""Blocked Hessenberg reduction (SEP): A -> Q^T A Q = H upper Hessenberg.

JAX rebuild of the reference Hessenberg component
(``src/hessenberg/``, SURVEY.md section 2.2): the same blocked two-sided
compact-WY algorithm — per panel of width nb, columns are reduced one at a
time (each needing a matrix-vector product against the panel-start matrix,
the intrinsically sequential part, reference core.c:461-521), producing
V, T and Y = A V T; the trailing matrix is then updated from the right
(A <- A - Y V^T) and left (A <- A - V T^T V^T A) as large GEMMs
(reference core.c:93-160, 515-537).

Design differences from the reference (StarPU task DAG -> XLA):
  * the panel inner loop is one jitted ``lax.fori_loop``; the matvec u = A v
    runs at full matrix width (masked by v's sparsity) so one compilation
    serves every panel — no per-panel recompiles;
  * trailing updates are whole-matrix GEMMs; the panel columns
    are overwritten with exactly-zeroed reflector results afterwards;
  * Q is accumulated per panel as Q <- Q - (Q V) T V^T.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from starneig_jax.config import HessenbergConf
from starneig_jax.ops import primitives as prim


@functools.partial(jax.jit, static_argnames=("nb", "t0"))
def _panel(A, k, nb: int, t0: int = 0, end=None):
    """Factorize panel columns k..k+nb-1.

    Returns (V, T, Y, P): reflectors (n, nb) with v_j supported on rows
    > k+j, the compact-WY T (nb, nb), Y = A V T (n, nb), and the final
    panel column values P (n, nb) with exact zeros below the subdiagonal.

    ``t0`` is a static bucketed bound with t0 <= k: every reflector is
    supported on rows > t0, so the hot matvec u = A v contracts only over
    columns >= t0 (the trailing-range bucketing that removes the ~2x flop
    overhead of full-width matvecs; reference confines the same work to
    the trailing matrix per panel, hessenberg/core.c:461-521).
    """
    n = A.shape[0]
    dtype = A.dtype
    rows = jnp.arange(n)

    def step(j, carry):
        V, T, U, Y, P = carry
        c = k + j
        a = lax.dynamic_slice(A, (0, c), (n, 1))[:, 0]
        a = a - Y @ lax.dynamic_slice(V, (c, 0), (1, nb))[0]
        a = a - V @ (T.T @ (V.T @ a))
        shift = c + 1
        ar = jnp.roll(a, -shift)
        mr = jnp.roll(rows >= shift, -shift)
        vr, tau, beta = prim.householder(ar, mr)
        v = jnp.roll(vr, shift)
        lim = (n if end is None else end)
        active = (c < lim - 1) & (c < n - 1)
        v = jnp.where(active & (rows >= shift), v, 0.0)
        tau = jnp.where(active, tau, 0.0)
        pcol = jnp.where(rows <= c, a, 0.0)
        pcol = jnp.where((rows == shift) & active, beta, pcol)
        # columns outside the reduction range [begin, end) are NOT reduced:
        # plant the fully-corrected column as-is (zeroing its lower rows
        # would destroy the matrix in partial-range mode)
        pcol = jnp.where(active | (rows <= c), pcol, a)
        # rows < t0 of u (needed only for the final panel values and the
        # right update there) are reconstructed by one deferred GEMM in
        # _apply_panel — the hot sequential matvec runs on the trailing
        # (bucketed) square only (v's support rows > c >= t0 kills cols
        # < t0 exactly)
        u = jnp.zeros((n,), dtype).at[t0:].set(A[t0:, t0:] @ v[t0:])
        tcol = -tau * (T @ (V.T @ v))
        tcol = tcol.at[j].set(tau)
        V = V.at[:, j].set(v)
        T = T.at[:, j].set(tcol)
        U = U.at[:, j].set(u)
        Y = Y.at[:, j].set(U @ tcol)
        P = P.at[:, j].set(pcol)
        return V, T, U, Y, P

    V = jnp.zeros((n, nb), dtype)
    T = jnp.zeros((nb, nb), dtype)
    U = jnp.zeros((n, nb), dtype)
    Y = jnp.zeros((n, nb), dtype)
    P = jnp.zeros((n, nb), dtype)
    V, T, U, Y, P = lax.fori_loop(0, nb, step, (V, T, U, Y, P))
    return V, T, Y, P


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=("t0",))
def _apply_panel(A, Q, V, T, Y, P, k, t0: int = 0):
    """Trailing update + panel write-back + Q accumulation.

    All reflectors are supported on rows > t0 (static, bucketed), so:
      * the right update A <- A - Y V^T only touches columns >= t0;
      * the left update A <- A - V T^T V^T A only touches rows >= t0, and
        columns < t0 of those rows are already exactly zero below the
        subdiagonal (Hessenberg), so V^T A vanishes there — restrict to
        the [t0:, t0:] trailing block;
      * Q accumulation only touches columns >= t0.
    """
    Vt = V[t0:]
    # Y from _panel is supported on rows >= t0 (the in-loop matvec runs on
    # the trailing square only); reconstruct the top rows with one GEMM and
    # patch the panel's top values, which the in-loop correction skipped
    Ytop = (A[:t0, t0:] @ Vt) @ T
    nb = V.shape[1]
    Pk = lax.dynamic_slice(A, (0 * k, k), (A.shape[0], nb))
    Vp = lax.dynamic_slice(V, (k, 0 * k), (nb, nb))
    P = P.at[:t0].set(Pk[:t0] - Ytop @ Vp.T)
    A = A.at[:t0, t0:].add(-(Ytop @ Vt.T))
    A = A.at[t0:, t0:].add(-(Y[t0:] @ Vt.T))
    At = A[t0:, t0:]
    At = At - Vt @ (T.T @ (Vt.T @ At))
    A = A.at[t0:, t0:].set(At)
    A = lax.dynamic_update_slice(A, P, (k * 0, k))
    Q = Q.at[:, t0:].add(-((Q[:, t0:] @ Vt) @ (T @ Vt.T)))
    return A, Q


def hessenberg(A, Q=None, conf: Optional[HessenbergConf] = None,
               begin: int = 0, end: Optional[int] = None):
    """Reduce A to upper Hessenberg form: returns (H, Q) with H = Q^T A Q.

    Mirrors ``starneig_SEP_SM_Hessenberg`` (reference: sep_sm.h:89-118),
    including the partial reduction range [begin, end): only those columns
    are reduced (the reference's partial-hessenberg capability,
    test/misc/partial_hessenberg.c), assuming A[begin:, :begin] is already
    zero below the subdiagonal as in LAPACK's ilo/ihi convention.
    ``Q`` may hold an initial orthogonal matrix to accumulate onto.
    """
    A = jnp.asarray(A)
    # the update steps donate their inputs (in-place on device); copy so the
    # caller's arrays survive
    A = A + jnp.zeros((), A.dtype)
    n = A.shape[0]
    if end is None:
        end = n
    if Q is None:
        Q = jnp.eye(n, dtype=A.dtype)
    else:
        Q = jnp.asarray(Q) + jnp.zeros((), A.dtype)
    if n <= 2 or end - begin <= 2:
        return A, Q
    conf = (conf or HessenbergConf()).resolve(end - begin)
    nb = min(conf.panel_width, max(8, n - 2), n)
    # trailing-range bucket: t0 <= k snapped down to multiples of BK so the
    # sliced programs compile for at most ~8 distinct shapes per n
    BK = max(nb, ((n // 8) // 8 + 1) * 8)
    for k in range(begin, end - 2, nb):
        k_eff = max(0, min(k, n - nb))  # keep the static panel inside the
        # matrix; re-processing already-reduced columns is an exact no-op
        t0 = (k_eff // BK) * BK
        V, T, Y, P = _panel(A, k_eff, nb, t0, jnp.int32(end))
        A, Q = _apply_panel(A, Q, V, T, Y, P, k_eff, t0)
    return A, Q
