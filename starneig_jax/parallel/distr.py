"""Distributed matrices over a device mesh.

Analogue of the reference's distributed matrix objects
(``starneig/distr_matrix.h:89-455``, ``src/mpi/distr_matrix.c``): the
reference stores 2D-block-cyclic ownership + local buffers and relies on
StarPU-MPI to move tiles; here a :class:`DistrMatrix` wraps a jax array
with a :class:`jax.sharding.NamedSharding` — ownership IS the sharding, and
data movement is compiled into the program by XLA's SPMD partitioner.

Layout choice: **column sharding** (``P(None, 'd')``) is the default for the
solve chain — every windowed transform applies ``Qw^T`` to a row strip
(embarrassingly parallel over column shards) and ``Qw`` to a column strip
(one all-gather of the W-column panel), mirroring the reference's
single-owner-window + distributed-update structure (SURVEY.md section 2.7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    """A 1-D device mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@dataclasses.dataclass
class DistrMatrix:
    """A matrix sharded over a mesh (reference: starneig_distr_matrix_t).

    ``data`` is a jax array placed with a NamedSharding; ``spec`` records
    the partitioning (default column sharding).
    """

    data: jax.Array
    mesh: Mesh
    spec: P

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def to_array(self) -> np.ndarray:
        """Gather to a host numpy array (reference: scatter/gather copy
        semantics, distr_matrix.h:248-305)."""
        return np.asarray(self.data)

    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)


def distr_matrix_create(m: int, n: int, mesh: Mesh, dtype=jnp.float64,
                        spec: Optional[P] = None) -> DistrMatrix:
    """Create a zero-initialized sharded matrix (distr_matrix.h:189)."""
    spec = spec if spec is not None else P(None, mesh.axis_names[0])
    data = jax.device_put(jnp.zeros((m, n), dtype), NamedSharding(mesh, spec))
    return DistrMatrix(data=data, mesh=mesh, spec=spec)


def distr_matrix_from_array(A, mesh: Mesh, spec: Optional[P] = None) -> DistrMatrix:
    """Scatter a host/global array onto the mesh (distr_matrix.h:248).

    A host array goes straight to its shards; it is never materialized
    whole on one device first."""
    spec = spec if spec is not None else P(None, mesh.axis_names[0])
    if not isinstance(A, jax.Array):
        A = np.asarray(A)
    data = jax.device_put(A, NamedSharding(mesh, spec))
    return DistrMatrix(data=data, mesh=mesh, spec=spec)
