"""Full GEP solve chain: pencil (A, B) -> generalized Schur form + reordering.

Analogue of the reference's ``examples/gep_sm_full_chain.c``.

Run:  python examples/gep_full_chain.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from starneig_jax.api import gep
from starneig_jax.testing import residual_gep, orthogonality


def main(n: int = 200) -> None:
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n)) + 3 * np.eye(n)

    S, T, Q, Z, ar, ai, bt, nsel, info = gep.reduce(
        A, B, predicate=lambda alpha, beta: beta != 0 and (alpha / beta).real > 0)
    print(f"info = {info}, selected = {nsel}")

    S, T, Q, Z = map(np.asarray, (S, T, Q, Z))
    ra, rb = residual_gep(A, B, S, T, Q, Z)
    print(f"residual A    = {ra:8.1f} u")
    print(f"residual B    = {rb:8.1f} u")
    print(f"orthogonality = {max(orthogonality(Q), orthogonality(Z)):8.1f} u")

    ar, ai, bt = map(np.asarray, (ar, ai, bt))
    n_inf = int((np.abs(bt) < 1e-12).sum())
    print(f"infinite eigenvalues: {n_inf}")

    select = np.zeros(n, bool)
    select[:max(nsel, 1)] = True
    X, xinfo = gep.eigenvectors(S, T, Q, Z, select)
    print(f"generalized eigenvectors: {np.asarray(X).shape}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
