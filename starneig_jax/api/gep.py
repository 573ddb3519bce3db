"""GEP single-process interface (reference: starneig/gep_sm.h:106-629).

Function-for-function parity with the reference's 12 GEP SM entry points;
like the SEP module, all functions are pure (inputs not mutated).

  reference                               here
  --------------------------------------  -----------------------------
  starneig_GEP_SM_HessenbergTriangular    hessenberg_triangular
  starneig_GEP_SM_Schur                   schur  (QZ)
  starneig_GEP_SM_ReorderSchur            reorder_schur
  starneig_GEP_SM_Eigenvectors            eigenvectors
  starneig_GEP_SM_Reduce                  reduce
  starneig_GEP_SM_Select                  select
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax.numpy as jnp

from starneig_jax.config import ReorderConf, EigenvectorsConf, SchurConf
from starneig_jax.errors import Error
from starneig_jax.ops import hess_triangular as _ht
from starneig_jax.ops import qz as _qz
from starneig_jax.ops import reorder as _reorder
from starneig_jax.ops import eigenvectors as _evec
from starneig_jax.ops.eigvals import extract_eigenvalues_gen
from starneig_jax.node import full_precision


@full_precision
def hessenberg_triangular(A, B, Q=None, Z=None):
    """(A, B) -> Hessenberg-triangular (H, T, Q, Z) (gep_sm.h:106-160)."""
    return _ht.hessenberg_triangular(A, B, Q=Q, Z=Z)


@full_precision
def schur(H, T, Q=None, Z=None, conf: Optional[SchurConf] = None):
    """Hessenberg-triangular -> generalized real Schur form via QZ
    (gep_sm.h:162-235).

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, info); beta == 0 marks an
    infinite eigenvalue.
    """
    H = jnp.asarray(H)
    n = H.shape[0]
    dtype = H.dtype
    T = jnp.asarray(T)
    Qm = jnp.eye(n, dtype=dtype) if Q is None else jnp.asarray(Q)
    Zm = jnp.eye(n, dtype=dtype) if Z is None else jnp.asarray(Z)
    conf = (conf or SchurConf()).resolve(n)
    if n > conf.small_limit:
        # large problems: multishift QZ + AED driver
        from starneig_jax.ops.qz_driver import qz_schur
        return qz_schur(H, T, Qm, Zm, conf=conf)
    u = float(jnp.finfo(dtype).eps) / 2
    th = u * float(jnp.linalg.norm(H))
    tt = u * float(jnp.linalg.norm(T))
    S, Tt, Qo, Zo, info_i = _qz.small_qz(H, T, Qm, Zm, n, th, tt)
    ar, ai, bt = extract_eigenvalues_gen(S, Tt)
    info = Error.SUCCESS if int(info_i) == 0 else Error.DID_NOT_CONVERGE
    return S, Tt, Qo, Zo, ar, ai, bt, info


@full_precision
def reorder_schur(S, T, Q, Z, select, conf: Optional[ReorderConf] = None):
    """Move selected generalized eigenvalues to the leading block
    (gep_sm.h:237-320).  Returns (S, T, Q, Z, num_selected, info)."""
    return _reorder.reorder_schur_gep(S, T, Q, Z, select, conf=conf)


@full_precision
def eigenvectors(S, T, Q, Z, select, conf: Optional[EigenvectorsConf] = None):
    """Generalized eigenvectors for selected eigenvalues (gep_sm.h:400-629)."""
    return _evec.eigenvectors_schur_gep(S, T, Q, Z, select, conf=conf)


def eigenvalues(S, T):
    """(alpha_r, alpha_i, beta) from a generalized Schur form."""
    return extract_eigenvalues_gen(jnp.asarray(S), jnp.asarray(T))


def select(S, T, predicate: Callable[[complex, float], bool]) -> np.ndarray:
    """Selection bitmap from a predicate over (alpha, beta) pairs.

    Mirrors ``starneig_GEP_SM_Select`` (helpers.c:96-159): the predicate
    receives (alpha: complex, beta: float); beta == 0 means infinite.
    """
    ar, ai, bt = eigenvalues(S, T)
    ar, ai, bt = map(np.asarray, (ar, ai, bt))
    S = np.asarray(S)
    n = S.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    sel = np.zeros(n, bool)
    i = 0
    while i < n:
        if sub[i] != 0:
            v = bool(predicate(complex(ar[i], ai[i]), float(bt[i])))
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            sel[i] = bool(predicate(complex(ar[i], ai[i]), float(bt[i])))
            i += 1
    return sel


@full_precision
def reduce(A, B, predicate=None, reorder_conf: Optional[ReorderConf] = None,
           schur_conf: Optional[SchurConf] = None):
    """Full GEP chain: HT -> QZ [-> Select -> Reorder]
    (reference: common/combined.c:98-154).

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, num_selected, info).
    """
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, T, Q, Z, ar, ai, bt, info = schur(H, T, Q, Z, conf=schur_conf)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(S, T, predicate)
        S, T, Q, Z, nsel, info = reorder_schur(S, T, Q, Z, sel,
                                               conf=reorder_conf)
        ar, ai, bt = eigenvalues(S, T)
    return S, T, Q, Z, ar, ai, bt, nsel, info
