"""SEP distributed interface (reference: starneig/sep_dm.h:86-427).

The reference's DM functions convert distributed matrices to its internal
tiled format and run the *same* task-insertion code with MPI enabled
(``src/mpi/interface_schur.c:53-120``).  The JAX analogue is even
more direct: the DM entry points place the matrices with a NamedSharding
and run the *same* host drivers — every jitted building block compiles to
an SPMD program and XLA inserts the collectives (all-gather of window
panels, local row-strip updates) that StarPU-MPI's ownership messaging
provided.

Also implements ``eigenvectors`` — declared but left unimplemented in the
reference (sep_dm.h:232-238 "@todo"); here the same backsolve runs on the
sharded Schur form, exceeding reference parity.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from starneig_jax.api import sep as _sep
from starneig_jax.parallel.distr import DistrMatrix, distr_matrix_from_array, make_mesh
from starneig_jax.node import full_precision


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


def hessenberg(A, Q=None, mesh=None, conf=None):
    """Distributed Hessenberg reduction (sep_dm.h:86-130)."""
    Ad = _as_distr(A, mesh)
    Qd = None if Q is None else _as_distr(Q, Ad.mesh).data
    H, Qo = _sep.hessenberg(Ad.data, Q=Qd, conf=conf)
    return _wrap(H, Ad.mesh, Ad.spec), _wrap(Qo, Ad.mesh, Ad.spec)


@full_precision
def schur(H, Q=None, mesh=None, conf=None):
    """Distributed Schur reduction (sep_dm.h:132-196).

    Runs the fused multishift-QR driver as ONE shard_map SPMD program over
    the mesh (column-sharded matrix, explicit psum panel gathers — see
    :mod:`starneig_jax.parallel.dm_core`), mirroring the reference's
    same-core-with-mpi structure (src/mpi/interface_schur.c:53-120).
    """
    from starneig_jax.parallel.dm_core import schur_dm

    Hd = _as_distr(H, mesh)
    Qd = None if Q is None else _as_distr(Q, Hd.mesh).data
    S, Qo, er, ei, info = schur_dm(Hd.data, Q=Qd, mesh=Hd.mesh, conf=conf)
    return _wrap(S, Hd.mesh, Hd.spec), _wrap(Qo, Hd.mesh, Hd.spec), er, ei, info


@full_precision
def reorder_schur(S, Q, select, mesh=None, conf=None):
    """Distributed eigenvalue reordering (sep_dm.h:198-230).

    Wave-parallel disjoint windows with every matrix access inside a
    shard_map pass (psum window gathers, shard-local strips —
    :func:`starneig_jax.parallel.dm_core.reorder_dm`; reference:
    src/mpi/interface_reorder.c)."""
    from starneig_jax.parallel.dm_core import reorder_dm

    Sd = _as_distr(S, mesh)
    Qd = _as_distr(Q, Sd.mesh)
    So, Qo, m, info = reorder_dm(Sd.data, Qd.data, select, mesh=Sd.mesh,
                                 conf=conf)
    return _wrap(So, Sd.mesh, Sd.spec), _wrap(Qo, Sd.mesh, Sd.spec), m, info


def eigenvectors(S, Q, select, mesh=None, conf=None):
    """Distributed eigenvectors — unimplemented in the reference
    (sep_dm.h:232-238); implemented here."""
    Sd = _as_distr(S, mesh)
    Qd = _as_distr(Q, Sd.mesh)
    X, info = _sep.eigenvectors(Sd.data, Qd.data, select, conf=conf)
    return _wrap_flex(jnp.asarray(X), Sd.mesh), info


def select(S, predicate: Callable[[complex], bool]):
    """Distributed Select (sep_dm.h; reference gathers the selection to all
    ranks — here the bitmap is host-global by construction)."""
    Sd = S.to_array() if isinstance(S, DistrMatrix) else S
    return _sep.select(Sd, predicate)


def reduce(A, predicate=None, mesh=None, hessenberg_conf=None,
           schur_conf=None, reorder_conf=None):
    """Distributed full chain (reference: mpi/combined.c).

    Each stage runs its DM entry: Hessenberg (SPMD jit), Schur through the
    shard_map fused driver (:func:`dm_core.schur_dm`), reordering through
    the shard_map window passes (:func:`dm_core.reorder_dm`)."""
    from starneig_jax.errors import Error

    Ad = _as_distr(A, mesh)
    Hd, Qd = hessenberg(Ad, conf=hessenberg_conf)
    Sd, Qd, er, ei, info = schur(Hd, Qd, conf=schur_conf)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(Sd, predicate)
        Sd, Qd, nsel, info = reorder_schur(Sd, Qd, sel, conf=reorder_conf)
        er, ei = _sep.eigenvalues(Sd.data)
    return Sd, Qd, er, ei, nsel, info
