"""Numerical sanity checks between solve phases (debug mode).

Rebuild of the reference's compile-time sanity machinery
(``src/common/sanity.h``, STARNEIG_ENABLE_SANITY_CHECKS; SURVEY.md
section 5): NaN/Inf scans, orthogonality checks, Hessenberg/Schur structure
checks bracketing the kernels.  Race safety needs no analogue — XLA's
functional semantics remove data races by construction; these checks guard
*numerical* invariants only.

Enable via ``enable_sanity_checks()`` or STARNEIG_SANITY=1; checks
raise ``SanityError`` on violation and are no-ops when disabled (zero cost
in production).
"""

from __future__ import annotations

import os

import numpy as np

_ENABLED = bool(int(os.environ.get("STARNEIG_SANITY", "0")))


class SanityError(AssertionError):
    pass


def sanity_enabled() -> bool:
    return _ENABLED


def enable_sanity_checks(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def _u(dtype) -> float:
    return float(np.finfo(dtype).eps) / 2


def check_finite(M, label: str = "matrix") -> None:
    """NaN/Inf scan (reference: sanity.h:120-145)."""
    if not _ENABLED:
        return
    M = np.asarray(M)
    if not np.isfinite(M).all():
        raise SanityError(f"{label}: non-finite entries detected")


def check_hessenberg(H, label: str = "H") -> None:
    """Upper-Hessenberg structure check (reference: sanity.h:681-735)."""
    if not _ENABLED:
        return
    H = np.asarray(H)
    if H.shape[0] > 2 and np.abs(np.tril(H, -2)).max() != 0.0:
        raise SanityError(f"{label}: nonzero below the first subdiagonal")


def check_schur_form(S, label: str = "S") -> None:
    """Quasi-triangular structure check (reference: sanity.h:541-677)."""
    if not _ENABLED:
        return
    S = np.asarray(S)
    n = S.shape[0]
    if n > 2 and np.abs(np.tril(S, -2)).max() != 0.0:
        raise SanityError(f"{label}: nonzero below the first subdiagonal")
    sub = np.abs(np.diagonal(S, -1))
    if n > 2 and np.minimum(sub[:-1], sub[1:]).max() > 0:
        raise SanityError(f"{label}: overlapping 2x2 blocks")


def check_orthogonality(Q, label: str = "Q", limit_u: float = 1e6) -> None:
    """||QQ^T - I|| check (reference: sanity.h:195-245)."""
    if not _ENABLED:
        return
    Q = np.asarray(Q)
    n = Q.shape[0]
    r = np.linalg.norm(Q @ Q.T - np.eye(n)) / _u(Q.dtype)
    if r > limit_u:
        raise SanityError(f"{label}: orthogonality {r:.1f}u exceeds {limit_u}u")


def check_residual_bracket(A, S, Q, label: str = "phase",
                           limit: float = 1e-8) -> None:
    """Residual bracketing around a phase (reference: sanity.h:330-456)."""
    if not _ENABLED:
        return
    A, S, Q = map(np.asarray, (A, S, Q))
    r = np.linalg.norm(Q @ S @ Q.T - A) / max(np.linalg.norm(A), 1e-300)
    if r > limit:
        raise SanityError(f"{label}: residual {r:.2e} exceeds {limit:.2e}")
