"""SEP single-process interface (reference: starneig/sep_sm.h:89-527).

Function-for-function parity with the reference's 12 SEP SM entry points;
expert variants take the corresponding config dataclass (the reference's
``_expert`` functions take the expert structs, expert.h).

  reference                          here
  ---------------------------------  -------------------------------
  starneig_SEP_SM_Hessenberg         hessenberg
  starneig_SEP_SM_Schur              schur
  starneig_SEP_SM_ReorderSchur       reorder_schur
  starneig_SEP_SM_Eigenvectors       eigenvectors
  starneig_SEP_SM_Reduce             reduce
  starneig_SEP_SM_Select             select
  starneig_SEP_SM_{...}_expert       same fn, ``conf=`` argument

All functions are pure: inputs are not mutated; updated arrays are returned
(JAX-idiomatic replacement for the reference's in-place C API).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from starneig_jax.config import (
    HessenbergConf,
    SchurConf,
    ReorderConf,
    EigenvectorsConf,
)
from starneig_jax.errors import Error
from starneig_jax.ops import hessenberg as _hess
from starneig_jax.ops import schur as _schur
from starneig_jax.ops import reorder as _reorder
from starneig_jax.ops import eigenvectors as _evec
from starneig_jax.ops.eigvals import extract_eigenvalues
from starneig_jax.node import full_precision


@full_precision
def hessenberg(A, Q=None, conf: Optional[HessenbergConf] = None):
    """Reduce A to upper Hessenberg form (sep_sm.h:89-118).

    Returns (H, Q): H = Q^T A Q (Q accumulates onto the given Q, if any).
    """
    return _hess.hessenberg(A, Q=Q, conf=conf)


@full_precision
def schur(H, Q=None, conf: Optional[SchurConf] = None):
    """Hessenberg -> real Schur form (sep_sm.h:159-227).

    Returns (S, Q, eig_real, eig_imag, info).
    """
    return _schur.schur(H, Q=Q, conf=conf)


@full_precision
def reorder_schur(S, Q, select, conf: Optional[ReorderConf] = None):
    """Move selected eigenvalues to the leading block (sep_sm.h:89-157).

    Uses the wave-parallel window grid (disjoint windows bubble
    simultaneously, batched off-window GEMMs — the batched analogue of
    the reference's multi-part plan, expert.h:439-525); small problems
    fall back to the sequential window chain inside.

    Returns (S, Q, num_selected, info); also returns re-extracted
    eigenvalues via ``eigenvalues(S)`` if needed (the reference re-extracts
    because swaps can perturb values).
    """
    return _reorder.reorder_schur_parallel(S, Q, select, conf=conf)


@full_precision
def eigenvectors(S, Q, select, conf: Optional[EigenvectorsConf] = None):
    """Eigenvectors for selected eigenvalues (sep_sm.h:229-527).

    Returns (X, info), LAPACK-style real storage (Re/Im column pairs for
    complex conjugate pairs).
    """
    return _evec.eigenvectors_schur(S, Q, select, conf=conf)


def eigenvalues(S):
    """Extract eigenvalues from a real Schur form: (real, imag)."""
    return extract_eigenvalues(jnp.asarray(S))


def select(S, predicate: Callable[[complex], bool]) -> np.ndarray:
    """Build a selection bitmap from a predicate over eigenvalues.

    Mirrors ``starneig_SEP_SM_Select`` (reference: helpers.c:46-159): walks
    the Schur diagonal, applying the predicate per block; 2x2 complex-pair
    blocks are selected atomically.
    """
    S = np.asarray(S)
    n = S.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    d = np.diagonal(S)
    sup = np.concatenate([np.diagonal(S, 1), [0.0]])
    sel = np.zeros(n, bool)
    i = 0
    while i < n:
        if sub[i] != 0:
            lam = 0.5 * (d[i] + d[i + 1]) + 1j * np.sqrt(np.abs(sup[i]) * np.abs(sub[i]))
            v = bool(predicate(lam))
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            sel[i] = bool(predicate(complex(d[i])))
            i += 1
    return sel


@full_precision
def reduce(
    A,
    predicate: Optional[Callable[[complex], bool]] = None,
    hessenberg_conf: Optional[HessenbergConf] = None,
    schur_conf: Optional[SchurConf] = None,
    reorder_conf: Optional[ReorderConf] = None,
):
    """Full chain: Hessenberg -> Schur [-> Select -> ReorderSchur].

    Mirrors ``starneig_SEP_SM_Reduce`` (reference: common/combined.c:47-90).

    Returns (S, Q, eig_real, eig_imag, num_selected, info).
    """
    H, Q = hessenberg(A, conf=hessenberg_conf)
    S, Q, er, ei, info = schur(H, Q, conf=schur_conf)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(S, predicate)
        S, Q, nsel, info = reorder_schur(S, Q, sel, conf=reorder_conf)
        er, ei = eigenvalues(S)
    return S, Q, er, ei, nsel, info
