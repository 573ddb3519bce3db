"""Test-support layer: matrix generators and validation hooks.

Rebuild of the reference test driver's initializers and hooks
(reference: ``test/common/init_schur.c``, ``test/common/hooks.c``,
``test/common/checks.c``) — these are the correctness oracle for every
component (SURVEY.md section 4).
"""

from starneig_jax.testing.generators import (
    random_dense,
    random_hessenberg,
    known_spectrum_matrix,
    known_spectrum_pencil,
)
from starneig_jax.testing.hooks import (
    residual_sep,
    residual_gep,
    orthogonality,
    hessenberg_structure_error,
    schur_structure_error,
    eigenvalue_error,
    UNIT_ROUNDOFF,
)
