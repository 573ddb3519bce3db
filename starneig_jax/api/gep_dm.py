"""GEP distributed interface (reference: starneig/gep_dm.h:100-514).

Same pattern as sep_dm: the DM entry points place the pencil with a
NamedSharding and run the shared drivers — XLA SPMD provides the
collectives.  Includes distributed generalized eigenvectors (declared but
unimplemented in the reference, gep_dm.h).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from starneig_jax.api import gep as _gep
from starneig_jax.parallel.distr import DistrMatrix, distr_matrix_from_array, make_mesh


def _as_distr(A, mesh):
    if isinstance(A, DistrMatrix):
        return A
    if mesh is None:
        mesh = make_mesh()
    return distr_matrix_from_array(A, mesh)


def _wrap(out, mesh, spec):
    return DistrMatrix(data=jax.device_put(out, NamedSharding(mesh, spec)),
                       mesh=mesh, spec=spec)


def _wrap_flex(out, mesh):
    """Wrap with the finest sharding the shape allows (cols, rows, replicated)."""
    nd = len(mesh.devices.ravel())
    ax = mesh.axis_names[0]
    if out.ndim == 2 and out.shape[1] % nd == 0:
        spec = P(None, ax)
    elif out.ndim == 2 and out.shape[0] % nd == 0:
        spec = P(ax, None)
    else:
        spec = P()
    return _wrap(out, mesh, spec)


def hessenberg_triangular(A, B, mesh=None):
    """Distributed HT reduction (gep_dm.h:100-160; the reference outsources
    this to the bundled ScaLAPACK pdgghrd)."""
    Ad = _as_distr(A, mesh)
    Bd = _as_distr(B, Ad.mesh)
    H, T, Q, Z = _gep.hessenberg_triangular(Ad.data, Bd.data)
    w = lambda M: _wrap(M, Ad.mesh, Ad.spec)
    return w(H), w(T), w(Q), w(Z)


def schur(H, T, Q=None, Z=None, mesh=None, conf=None):
    """Distributed QZ (gep_dm.h:162-240)."""
    Hd = _as_distr(H, mesh)
    Td = _as_distr(T, Hd.mesh)
    Qd = None if Q is None else _as_distr(Q, Hd.mesh).data
    Zd = None if Z is None else _as_distr(Z, Hd.mesh).data
    S, Tt, Qo, Zo, ar, ai, bt, info = _gep.schur(Hd.data, Td.data, Qd, Zd,
                                                 conf=conf)
    w = lambda M: _wrap(M, Hd.mesh, Hd.spec)
    return w(S), w(Tt), w(Qo), w(Zo), ar, ai, bt, info


def reorder_schur(S, T, Q, Z, select, mesh=None, conf=None):
    """Distributed generalized reordering (gep_dm.h:242-330)."""
    Sd = _as_distr(S, mesh)
    Td = _as_distr(T, Sd.mesh)
    Qd = _as_distr(Q, Sd.mesh)
    Zd = _as_distr(Z, Sd.mesh)
    So, To, Qo, Zo, m, info = _gep.reorder_schur(
        Sd.data, Td.data, Qd.data, Zd.data, select, conf=conf)
    w = lambda M: _wrap(M, Sd.mesh, Sd.spec)
    return w(So), w(To), w(Qo), w(Zo), m, info


def eigenvectors(S, T, Q, Z, select, mesh=None, conf=None):
    """Distributed generalized eigenvectors — unimplemented in the reference
    (gep_dm.h); implemented here."""
    Sd = _as_distr(S, mesh)
    Td = _as_distr(T, Sd.mesh)
    Qd = _as_distr(Q, Sd.mesh)
    Zd = _as_distr(Z, Sd.mesh)
    X, info = _gep.eigenvectors(Sd.data, Td.data, Qd.data, Zd.data, select,
                                conf=conf)
    return _wrap_flex(jnp.asarray(X), Sd.mesh), info


def select(S, T, predicate):
    Sd = S.to_array() if isinstance(S, DistrMatrix) else S
    Td = T.to_array() if isinstance(T, DistrMatrix) else T
    return _gep.select(Sd, Td, predicate)


def reduce(A, B, predicate=None, mesh=None, **confs):
    """Distributed full GEP chain (mpi/combined.c)."""
    Ad = _as_distr(A, mesh)
    Bd = _as_distr(B, Ad.mesh)
    S, T, Q, Z, ar, ai, bt, nsel, info = _gep.reduce(
        Ad.data, Bd.data, predicate=predicate, **confs)
    w = lambda M: _wrap(M, Ad.mesh, Ad.spec)
    return w(S), w(T), w(Q), w(Z), ar, ai, bt, nsel, info
