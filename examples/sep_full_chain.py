"""Full SEP solve chain: dense A -> eigenvalues, Schur form, deflating subspace.

Analogue of the reference's ``examples/sep_sm_full_chain.c``: reduce a random
dense matrix to real Schur form, reorder eigenvalues with positive real part
to the top, and validate.

Run:  python examples/sep_full_chain.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from starneig_jax.api import sep
from starneig_jax.testing import residual_sep, orthogonality


def main(n: int = 500) -> None:
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))

    # full chain: Hessenberg -> Schur -> Select -> Reorder
    S, Q, er, ei, nsel, info = sep.reduce(A, predicate=lambda lam: lam.real > 0)
    print(f"info = {info}, selected (positive real part) = {nsel}")

    S, Q = np.asarray(S), np.asarray(Q)
    print(f"residual      = {residual_sep(A, S, Q):8.1f} u")
    print(f"orthogonality = {orthogonality(Q):8.1f} u")

    # eigenvectors for the deflating subspace
    select = np.zeros(n, bool)
    select[:nsel] = True
    X, xinfo = sep.eigenvectors(S, Q, select)
    print(f"eigenvectors: {np.asarray(X).shape}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 500)
