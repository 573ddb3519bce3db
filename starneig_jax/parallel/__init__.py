"""Distributed-memory layer: device meshes and sharded matrices.

JAX replacement for the reference's StarPU-MPI stack (SURVEY.md
section 2.7): ownership-by-sharding over a ``jax.sharding.Mesh`` replaces
2D-block-cyclic MPI ownership; XLA's SPMD partitioner inserts the
collectives that StarPU-MPI's implicit messaging provided.
"""

from starneig_jax.parallel.distr import (
    make_mesh,
    DistrMatrix,
    distr_matrix_create,
    distr_matrix_from_array,
)
