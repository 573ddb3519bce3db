"""Distributed-memory Schur solve: the fused driver over shard_map.

The reference's DM layer reruns the *same* task-insertion core with
``mpi != NULL`` — tiles carry owner ranks and StarPU-MPI moves them
implicitly (reference ``src/mpi/interface_schur.c:53-120``, window tasks
owner-executed ``src/schur/core.c:1498-1545``, distribution objects
``src/mpi/distr_matrix.c:97-163``).  The JAX equivalent here is the
same idea one level up: :func:`starneig_jax.ops.schur._schur_iter` already
routes every full-extent access through an extent-op strategy; this module
provides :class:`ShardedExtent`, whose methods execute *inside*
``shard_map`` on column shards of the padded matrix with explicit
collectives:

  * row-strip updates (``mul_rows``/``mul_rows_batch``) are entirely
    shard-local — each device updates the rows of its own columns;
  * column-panel updates gather the WC-wide panel with ONE ``psum``
    (ownership-masked contributions — the collective analogue of
    "windows gathered to the owner rank"), apply the window transform,
    and each shard writes back only the columns it owns;
  * diagonal-window reads (``get_block``/``get_diag_blocks``) use the
    same masked-psum gather; window math (AED, Francis, bulge trains)
    then runs replicated on every shard — replicating O(w^2) scalar work
    avoids an owner-computes + broadcast round trip per window.

Layout: the (NP, NP) padded matrix is column-sharded into (NP, C) blocks,
C = NP / nshards — the 1-D analogue of the reference's 2-D block-cyclic
distribution (column panels are what every hot update touches; row strips
stay local under column sharding).  The wrapper pads NP so that C divides
evenly and C >= every window width used by the driver.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from starneig_jax.config import SchurConf
from starneig_jax.errors import Error


@functools.lru_cache(maxsize=None)
def make_sharded_extent(axis: str, nshards: int):
    """Build a ShardedExtent class for a mesh axis (static, hashable).

    Memoized: ``ext`` is a static jit argument of the fused driver, so a
    fresh class per call would miss the jit cache and recompile the whole
    shard_map program on every DM solve.
    """

    class ShardedExtent:
        """Extent ops on (rows, C) column shards inside shard_map."""

        nsh = nshards
        ax = axis

        # -- ownership-masked column-panel gather/scatter ----------------
        #
        # Shard d owns global columns [d*C, (d+1)*C).  For a w-wide panel
        # at dynamic column j0, the local overlap is read/written through
        # a w-wide local window at clamped offset lo; the blend index
        # arithmetic below maps panel position p <-> local position q
        # exactly, including windows straddling two shards (C >= w is
        # guaranteed by the wrapper's padding).

        @staticmethod
        def _panel_contrib(S, i0, j0, h, w):
            """This shard's owned columns of the (h, w) panel, zeros
            elsewhere (sum over shards = the full panel)."""
            C = S.shape[1]
            d = lax.axis_index(axis)
            lo_un = j0 - d * C
            lo = jnp.clip(lo_un, 0, C - w)
            off = lo_un - lo
            Lw = lax.dynamic_slice(S, (i0, lo), (h, w))
            p = jnp.arange(w)
            q = p + off
            valid = (q >= 0) & (q < w)
            qc = jnp.clip(q, 0, w - 1)
            return jnp.where(valid[None, :], Lw[:, qc], 0.0)

        @staticmethod
        def _panel_write(S, panel, i0, j0, h, w):
            """Write back the columns of ``panel`` this shard owns."""
            C = S.shape[1]
            d = lax.axis_index(axis)
            lo_un = j0 - d * C
            lo = jnp.clip(lo_un, 0, C - w)
            off = lo_un - lo
            Lw = lax.dynamic_slice(S, (i0, lo), (h, w))
            q = jnp.arange(w)
            p = q - off
            valid = (p >= 0) & (p < w)
            pc = jnp.clip(p, 0, w - 1)
            newLw = jnp.where(valid[None, :], panel[:, pc], Lw)
            return lax.dynamic_update_slice(S, newLw, (i0, lo))

        # -- extent ops (same signatures as DenseExtent) -----------------

        @staticmethod
        def mul_rows(S, i0, h, Qw):
            # rows are unsharded under column sharding: fully local
            rows = lax.dynamic_slice(S, (i0, i0 * 0), (h, S.shape[1]))
            return lax.dynamic_update_slice(S, Qw.T @ rows, (i0, i0 * 0))

        @staticmethod
        def mul_cols(S, j0, w, Qw):
            E = ShardedExtent
            panel = lax.psum(
                E._panel_contrib(S, 0 * j0, j0, S.shape[0], w), axis)
            return E._panel_write(S, panel @ Qw, 0 * j0, j0, S.shape[0], w)

        @staticmethod
        def get_block(S, i0, j0, h, w):
            return lax.psum(
                ShardedExtent._panel_contrib(S, i0, j0, h, w), axis)

        @staticmethod
        def set_block(S, M, i0, j0):
            return ShardedExtent._panel_write(
                S, M, i0, j0, M.shape[0], M.shape[1])

        # -- batched variants over disjoint diagonal windows -------------

        @staticmethod
        def get_diag_blocks(S, ws, w):
            contribs = jax.vmap(
                lambda s: ShardedExtent._panel_contrib(S, s, s, w, w))(ws)
            return lax.psum(contribs, axis)

        @staticmethod
        def set_diag_blocks(S, Ms, ws):
            w = Ms.shape[1]

            def body(g, S):
                return ShardedExtent._panel_write(S, Ms[g], ws[g], ws[g],
                                                  w, w)

            return lax.fori_loop(0, ws.shape[0], body, S)

        @staticmethod
        def mul_rows_batch(S, ws, w, Qws):
            C = S.shape[1]
            R = jax.vmap(
                lambda s: lax.dynamic_slice(S, (s, s * 0), (w, C)))(ws)
            R = jnp.einsum("gij,gjn->gin", jnp.swapaxes(Qws, 1, 2), R)

            def body(g, S):
                return lax.dynamic_update_slice(S, R[g], (ws[g], ws[g] * 0))

            return lax.fori_loop(0, ws.shape[0], body, S)

        @staticmethod
        def mul_cols_batch(S, ws, w, Qws):
            E = ShardedExtent
            n0 = S.shape[0]
            panels = lax.psum(jax.vmap(
                lambda s: E._panel_contrib(S, 0 * s, s, n0, w))(ws), axis)
            panels = jnp.einsum("gnj,gjk->gnk", panels, Qws)

            def body(g, S):
                return E._panel_write(S, panels[g], 0 * ws[g], ws[g], n0, w)

            return lax.fori_loop(0, ws.shape[0], body, S)

        @staticmethod
        def zero_negligible(Spad, P, n, ihi, thresh):
            """Sharded negligible-subdiagonal zeroing.

            Diagonal/subdiagonal entries live on the shard owning their
            column; gather them with one psum, decide (replicated), write
            back shard-locally.  Returns (Spad, sub) with sub (n,)
            replicated — matching DenseExtent's contract.
            """
            NPr, C = Spad.shape
            d = lax.axis_index(axis)
            c = jnp.arange(C)
            j = d * C + c                    # global column of local col c
            inner = (j >= P) & (j < P + n)
            rsafe = jnp.clip(j, 0, NPr - 1)
            r1safe = jnp.clip(j + 1, 0, NPr - 1)
            dv = jnp.where(inner, Spad[rsafe, c], 0.0)
            sv = jnp.where(inner & (j + 1 < P + n), Spad[r1safe, c], 0.0)
            pos = jnp.clip(j - P, 0, n - 1)
            dvec = lax.psum(
                jnp.zeros((n,), Spad.dtype).at[pos].add(dv), axis)
            svec = lax.psum(
                jnp.zeros((n,), Spad.dtype).at[pos].add(sv), axis)

            ulp = jnp.finfo(Spad.dtype).eps
            tst = jnp.abs(dvec[:-1]) + jnp.abs(dvec[1:])
            idx = jnp.arange(n - 1)
            sub = svec[:-1]
            neg = (jnp.abs(sub) <= jnp.maximum(ulp * tst, thresh)) \
                & (idx + 1 < ihi)
            newsub = jnp.where(neg, 0.0, sub)
            full = jnp.concatenate([newsub, jnp.zeros((1,), Spad.dtype)])

            write = inner & (j + 1 < P + n)
            vals = jnp.where(write, full[pos], Spad[r1safe, c])
            Spad = Spad.at[r1safe, c].set(vals)
            return Spad, full

    ShardedExtent.__name__ = f"ShardedExtent_{axis}_{nshards}"
    return ShardedExtent


def schur_dm(H, Q=None, mesh: Optional[Mesh] = None,
             conf: Optional[SchurConf] = None):
    """Distributed Hessenberg -> Schur: the fused driver inside shard_map.

    The full multishift-QR iteration (AED rounds + wavefront sweeps) runs
    as one SPMD program over ``mesh``: each device holds a column shard of
    the padded matrix; collectives appear exactly where the extent ops
    demand them (see module docstring).  Mirrors
    ``starneig_SEP_DM_Schur`` (reference mpi/interface_schur.c) by running
    the identical driver core with a sharded extent strategy.

    Returns (S, Q, eig_real, eig_imag, info); S and Q come back with the
    mesh's column sharding (callers may keep computing distributed).
    """
    from starneig_jax.ops.schur import (
        _resolve_threshold, schur_geometry, standardize_blocks, status_info)
    from starneig_jax.ops.eigvals import extract_eigenvalues

    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.array(devs), ("d",))
    axname = mesh.axis_names[0]
    nd = int(np.prod(mesh.devices.shape))

    H = jnp.asarray(H)
    n = H.shape[0]
    dtype = H.dtype
    Q = jnp.eye(n, dtype=dtype) if Q is None else jnp.asarray(Q)
    conf = (conf or SchurConf()).resolve(n, workers=nd)

    if n <= min(conf.small_limit, 300) or nd == 1:
        from starneig_jax.ops.schur import schur as schur_sm
        return schur_sm(H, Q, conf=conf)

    # geometry as in the single-device driver, with padding grown so
    # shards divide evenly and each shard is at least one window wide (the
    # panel blend needs C >= w)
    g = schur_geometry(n, conf)
    NP, P = _dm_padding(n, g, nd)

    thresh = _resolve_threshold(H, conf, dtype)
    eyeW = jnp.eye(g.WA, dtype=dtype)
    eyeWC = jnp.eye(g.WC, dtype=dtype)

    colsh = NamedSharding(mesh, PSpec(None, axname))

    @functools.partial(jax.jit, out_shardings=(colsh, colsh))
    def pad(H, Q):
        # built straight into the column sharding (no full buffer on one
        # device)
        Spad = jnp.zeros((NP, NP), dtype).at[P:P + n, P:P + n].set(H)
        Qpad = jnp.zeros((n, NP), dtype).at[:, P:P + n].set(Q)
        return Spad, Qpad

    Spad, Qpad = pad(H, Q)

    fused = _make_fused_dm(mesh, axname, nd, n, P, g, conf.aed_nibble,
                           conf.iteration_limit)
    # the SPMD program runs to convergence in one dispatch
    Spad, Qpad, state = fused(Spad, Qpad, thresh, eyeW, eyeWC)
    info = status_info(state)

    @jax.jit
    def finish(Spad, Qpad):
        S = lax.dynamic_slice(Spad, (P, P), (n, n))
        Qf = lax.dynamic_slice(Qpad, (0, P), (n, n))
        return standardize_blocks(S, Qf)

    S, Qf = finish(Spad, Qpad)
    er, ei = extract_eigenvalues(S)
    return S, Qf, er, ei, info


def _dm_padding(n: int, g, nd: int):
    """(NP, P) for an nd-way column-sharded padded buffer: NP divisible by
    nd with every shard at least one window wide; left pad P (the right
    pad NP - n - P >= P - 1)."""
    NP = ((n + 2 * g.P + nd - 1) // nd) * nd
    while NP // nd < max(g.WA, g.WC):
        NP += nd
    return NP, (NP - n) // 2


def _fused_dm_program(mesh, axname: str, nd: int, n: int, P: int, g,
                      nibble: int, itmax: int):
    """The fused driver wrapped in shard_map (unjitted)."""
    from starneig_jax.ops.schur import _schur_iter

    body = functools.partial(
        _schur_iter, P=P, WA=g.WA, NS=g.NS, B=g.B, TMAX=g.TMAX,
        nibble=nibble, itmax=itmax, ext=make_sharded_extent(axname, nd),
        n=n)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(PSpec(None, axname), PSpec(None, axname),
                  PSpec(), PSpec(), PSpec()),
        out_specs=(PSpec(None, axname), PSpec(None, axname), PSpec()))


@functools.lru_cache(maxsize=None)
def _make_fused_dm(mesh, axname, nd, n, P, g, nibble, itmax):
    return jax.jit(_fused_dm_program(mesh, axname, nd, n, P, g, nibble,
                                     itmax), donate_argnums=(0, 1))


def schur_dm_lowered(n: int, mesh: Mesh, dtype=jnp.float64):
    """Return the lowered (pre-compile) shard_map Schur program for an
    (n, n) problem — used by tests to assert collective structure and
    per-shard operand shapes without running the full solve."""
    from starneig_jax.ops.schur import schur_geometry

    axname = mesh.axis_names[0]
    nd = int(np.prod(mesh.devices.shape))
    conf = SchurConf().resolve(n, workers=nd)
    g = schur_geometry(n, conf)
    NP, P = _dm_padding(n, g, nd)
    sm = _fused_dm_program(mesh, axname, nd, n, P, g, conf.aed_nibble,
                           conf.iteration_limit)
    args = (jax.ShapeDtypeStruct((NP, NP), dtype),
            jax.ShapeDtypeStruct((n, NP), dtype),
            jax.ShapeDtypeStruct((), dtype),
            jax.ShapeDtypeStruct((g.WA, g.WA), dtype),
            jax.ShapeDtypeStruct((g.WC, g.WC), dtype))
    return jax.jit(sm).lower(*args), NP, nd


# ---------------------------------------------------------------------------
# distributed reordering: the wave-parallel window grid of
# ops/reorder.py:reorder_schur_parallel with every matrix access routed
# through the sharded extent ops (reference: src/mpi/interface_reorder.c —
# same plan-and-window code, MPI-distributed tiles)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _make_reorder_pass(mesh: Mesh, W: int, axname: str, nd: int):
    """Compile one sharded reorder pass: gather G disjoint windows (psum),
    bubble them (replicated vmapped kernel), scatter the transforms back
    as shard-local strips + owned-column panels."""
    from starneig_jax.ops.reorder import _window_bubble_batch

    ext = make_sharded_extent(axname, nd)

    def body(Sp, Qp, ws_arr, wlo, wlim, sels):
        Tws = ext.get_diag_blocks(Sp, ws_arr, W)
        Tw2, Qw2, sel2, dsts, nfails = _window_bubble_batch(
            Tws, sels, wlo, wlim, wlim)
        Sp = ext.mul_rows_batch(Sp, ws_arr, W, Qw2)
        Sp = ext.mul_cols_batch(Sp, ws_arr, W, Qw2)
        Sp = ext.set_diag_blocks(Sp, Tw2, ws_arr)
        Qp = ext.mul_cols_batch(Qp, ws_arr, W, Qw2)
        # gather the updated subdiagonal for the host's plan step
        NPr = Sp.shape[0]
        C = Sp.shape[1]
        d = lax.axis_index(axname)
        c = jnp.arange(C)
        j = d * C + c
        r1 = jnp.clip(j + 1, 0, NPr - 1)
        sv = jnp.where(j + 1 < NPr, Sp[r1, c], 0.0)
        sub = lax.psum(jnp.zeros((NPr,), Sp.dtype).at[jnp.clip(
            j, 0, NPr - 1)].add(sv), axname)
        return Sp, Qp, sel2, dsts, nfails, sub

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(PSpec(None, axname), PSpec(None, axname),
                  PSpec(), PSpec(), PSpec(), PSpec()),
        out_specs=(PSpec(None, axname), PSpec(None, axname),
                   PSpec(), PSpec(), PSpec(), PSpec())),
        donate_argnums=(0, 1))


def reorder_dm(S, Q, select, mesh: Optional[Mesh] = None, conf=None):
    """Distributed reordering: wave-parallel disjoint windows, sharded.

    Column shards hold S and Q throughout; each pass runs ONE shard_map
    program (psum window gathers, replicated bubble kernel, shard-local
    row strips and owned-column panel writes).  The host only reads the
    20-byte-per-window plan data (selection masks, fail counts, the
    subdiagonal) between passes — mirroring
    ``starneig_SEP_DM_ReorderSchur`` (src/mpi/interface_reorder.c).

    Returns (S, Q, num_selected, info) with S, Q column-sharded.
    """
    from starneig_jax.config import ReorderConf
    from starneig_jax.ops.reorder import _align_select, _prefix_len

    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.array(devs), ("d",))
    axname = mesh.axis_names[0]
    nd = int(np.prod(mesh.devices.shape))

    S = jnp.asarray(S)
    Q = jnp.asarray(Q)
    n = S.shape[0]
    dtype = S.dtype

    subdiag = np.concatenate([np.asarray(jnp.diagonal(S, offset=-1)), [0.0]])
    sel = _align_select(subdiag, np.asarray(select, bool).copy())

    if conf is None:
        conf = ReorderConf()
    ratio = float(sel.sum()) / max(n, 1)
    rconf = conf.resolve(n, workers=nd, select_ratio=ratio)
    W = min(rconf.window_size, n)

    # pad: shard-divisible, parking region of one window at the tail, and
    # each shard at least one window wide (the panel blend needs C >= W)
    NP = n + W
    NP = ((NP + nd - 1) // nd) * nd
    while NP // nd < W:
        NP += nd
    park = jnp.int32(n)  # all-zero region: identity bubble, harmless write

    colsh = NamedSharding(mesh, PSpec(None, axname))
    Sp = jnp.zeros((NP, NP), dtype).at[:n, :n].set(S)
    Qp = jnp.zeros((n, NP), dtype).at[:, :n].set(Q)
    Sp = jax.device_put(Sp, colsh)
    Qp = jax.device_put(Qp, colsh)

    if n < 2 * W:
        GMAX = 1
    else:
        GMAX = max(1, (n + W - 1) // W)

    total_fail = 0
    offset_toggle = 0
    guard = 0
    seq_mode = False
    while True:
        m = _prefix_len(subdiag, sel)
        below = np.nonzero(sel[m:n])[0]
        if below.size == 0:
            break
        guard += 1
        if guard > 16 * (n // max(W // 2, 1) + 2):
            from starneig_jax.node import log
            log.warning(
                "reorder_dm: window passes stalled after %d rounds "
                "(n=%d, W=%d, %d selected not yet in the leading block) — "
                "giving up with PARTIAL_REORDERING", guard, n, W,
                int(sel[m:n].sum()))
            total_fail += 1
            break
        tail_batch = []
        if n < 2 * W or seq_mode:
            # sequential window chain (small problems / stragglers): the
            # same sharded pass with G=1
            lowest = m + int(below[-1])
            bsz = 2 if subdiag[lowest] != 0 else 1
            if lowest > 0 and subdiag[lowest - 1] != 0:
                lowest, bsz = lowest - 1, 2
            ws_list = [min(max(m, lowest + bsz - W), n - W)]
        else:
            start = m + (offset_toggle * (W // 2))
            offset_toggle ^= 1
            ws_list = list(range(start, n - W + 1, W))
            if not ws_list:
                ws_list = [n - W]
            elif ws_list[-1] + W < n:
                # the leftover past the last disjoint window is < W; the
                # overlapping n-W window runs as its own second batch (it
                # would break wavefront disjointness in the first) —
                # mirrors the dense path, ops/reorder.py:559-566
                tail_batch = [n - W]
        # one padded fixed-G batch per pass (parked windows no-op)
        for group in [ws_list[:GMAX]] + ([tail_batch] if tail_batch else []):
            G = GMAX
            ws_arr = np.full((G,), int(park), np.int64)
            ws_arr[:len(group)] = group
            wlo = np.zeros((G,), np.int32)
            wlim = np.full((G,), W, np.int32)
            sels = np.zeros((G, W), bool)
            for g, w0 in enumerate(group):
                wlo[g] = 1 if (w0 > 0 and subdiag[w0 - 1] != 0) else 0
                wlim[g] = W - 1 if (w0 + W < n and subdiag[w0 + W - 1] != 0) \
                    else W
                sels[g] = sel[w0:w0 + W]
            pass_fn = _make_reorder_pass(mesh, W, axname, nd)
            Sp, Qp, sel2, dsts, nfails, subfull = pass_fn(
                Sp, Qp, jnp.asarray(ws_arr, jnp.int32), jnp.asarray(wlo),
                jnp.asarray(wlim), jnp.asarray(sels))
            total_fail += int(np.asarray(nfails)[:len(group)].sum())
            sel2 = np.asarray(sel2)
            for g, w0 in enumerate(group):
                sel[w0:w0 + W] = sel2[g]
            subdiag = np.asarray(subfull)[:n].copy()  # subfull[j] = S[j+1, j]
            subdiag[n - 1] = 0.0
        if guard > 8 * (n // max(W // 2, 1) + 2):
            seq_mode = True

    m = _prefix_len(subdiag, sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    S_out = Sp[:n, :n]
    Q_out = Qp[:, :n]
    return S_out, Q_out, m, info
