"""Auxiliary tooling: event tracing and numerical sanity checks."""

from starneig_jax.tools.trace import (
    tracing_enabled,
    enable_tracing,
    disable_tracing,
    trace_event,
    trace_span,
    dump_trace,
)
from starneig_jax.tools.sanity import (
    sanity_enabled,
    enable_sanity_checks,
    check_hessenberg,
    check_schur_form,
    check_orthogonality,
    check_finite,
)
