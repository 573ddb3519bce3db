"""starneig_jax — a JAX dense nonsymmetric eigenvalue framework.

A from-scratch JAX/XLA framework with the capabilities of
NLAFET/StarNEig: the complete solve chain for
dense nonsymmetric standard (SEP: A v = lambda v) and generalized
(GEP: A v = lambda B v) eigenvalue problems:

  1. Hessenberg(-triangular) reduction
  2. Multishift QR/QZ Schur reduction with aggressive early deflation (AED)
  3. Eigenvalue reordering (deflating subspaces)
  4. Robust, overflow-protected eigenvector back-substitution

The reference's StarPU task DAG / CUDA / MPI stack is replaced by an
accelerator design in plain native-f64 XLA: windowed work (bulge
chasing, AED, reordering windows) runs as jitted fixed-shape programs;
trailing updates are large GEMMs; multi-device runs shard the matrices over
a ``jax.sharding.Mesh`` with XLA collectives.

Public API parity map (reference header -> here):
  starneig/sep_sm.h      -> starneig_jax.api.sep   (SM = single-process)
  starneig/gep_sm.h      -> starneig_jax.api.gep
  starneig/sep_dm.h      -> starneig_jax.api.sep_dm
  starneig/gep_dm.h      -> starneig_jax.api.gep_dm
  starneig/node.h        -> starneig_jax.node
  starneig/expert.h      -> starneig_jax.config
  starneig/error.h       -> starneig_jax.errors
  starneig/distr_matrix.h-> starneig_jax.parallel.distr_matrix
"""

from starneig_jax import config, errors
from starneig_jax.node import node_init, node_finalize, node_initialized

__version__ = "0.1.0"

__all__ = [
    "config",
    "errors",
    "node_init",
    "node_finalize",
    "node_initialized",
]
