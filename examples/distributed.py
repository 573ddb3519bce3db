"""Distributed (mesh-sharded) solve: the DM interface over a device mesh.

Analogue of the reference's distributed-memory examples
(``examples/sep_dm_full_chain.c``): the matrices are sharded over a
``jax.sharding.Mesh`` (all local devices, e.g. the GPUs of one host; on
several hosts, initialize ``jax.distributed`` first).

Run (single host, 8 virtual devices):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
      python examples/distributed.py 256
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from starneig_jax.api import sep_dm
from starneig_jax.parallel import make_mesh, distr_matrix_from_array
from starneig_jax.testing import residual_sep


def main(n: int = 256) -> None:
    mesh = make_mesh()
    print(f"mesh: {mesh.devices.ravel().size} devices")

    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))
    Ad = distr_matrix_from_array(A, mesh)

    Hd, Qd = sep_dm.hessenberg(Ad)
    Sd, Qd, er, ei, info = sep_dm.schur(Hd, Qd)
    print(f"info = {info}")
    print(f"residual = {residual_sep(A, Sd.to_array(), Qd.to_array()):.1f} u")

    select = np.asarray(er) > 0
    Sd, Qd, m, rinfo = sep_dm.reorder_schur(Sd, Qd, select)
    print(f"reordered {m} rows to the top (info = {rinfo})")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
