"""Execution-environment ("node") layer.

JAX analogue of the reference node manager (reference:
``src/common/node.c``, public API ``starneig/node.h:178-241``).  There is no
StarPU runtime to boot and no worker pool to discover: XLA owns intra-chip
scheduling.  What remains node-level state:

  * dtype policy (the reference is double-precision only; f32 is offered
    as well, so the policy is configurable),
  * the device set / mesh used for distributed ("DM") calls,
  * multi-process initialization (``jax.distributed``) for multi-host runs,
  * message verbosity flags (reference: node.h:141-152).

``node_init``/``node_finalize`` keep the reference's bracketed lifecycle so
ported user code maps 1:1, but calling compute functions without an explicit
init is allowed (a default node is created lazily) — idiomatic Python.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Optional, Sequence

import jax
import numpy as np

log = logging.getLogger("starneig_jax")

# Init flags (reference: node.h:84-152). Hints are accepted for parity; the
# XLA runtime needs none of them but they gate messaging like the reference.
DEFAULT = 0
HINT_SM = 1 << 0
HINT_DM = 1 << 1
NO_VERBOSE = 1 << 4
NO_MESSAGES = 1 << 5


@dataclasses.dataclass
class Node:
    devices: tuple
    mesh: Optional[jax.sharding.Mesh]
    flags: int
    dtype: np.dtype

    @property
    def n_devices(self) -> int:
        return len(self.devices)


_NODE: Optional[Node] = None


def node_init(
    devices: Optional[Sequence] = None,
    flags: int = DEFAULT,
    dtype=np.float64,
    mesh: Optional[jax.sharding.Mesh] = None,
    distributed: bool = False,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Node:
    """Initialize the execution environment (reference: node.h:178).

    Args:
      devices: devices to use; default all of ``jax.devices()``.
      flags: bitwise OR of init flags (``HINT_SM``/``HINT_DM``/``NO_*``).
      dtype: default element type for solves (f64 matches the reference).
      mesh: optional pre-built device mesh for DM calls.
      distributed: call ``jax.distributed.initialize()`` first (multi-host;
        implied when explicit coordinator arguments are given).  Explicit
        ``coordinator_address``/``num_processes``/``process_id`` support
        launchers without cluster auto-detection — the analogue of the
        reference's MPI_Init-by-the-user contract (node.h:73-99).
    """
    global _NODE
    if coordinator_address is not None:
        if (num_processes is None) != (process_id is None):
            raise ValueError(
                "num_processes and process_id must be given together with "
                "an explicit coordinator_address")
        # idempotent like the `distributed=True` branch: a second
        # node_init (or one after an implicit initialize) must not raise.
        # NB: is_initialized() does not touch the XLA backend (process_count
        # would, and initialize() must run before backend init).
        if not jax.distributed.is_initialized():
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
    elif distributed and jax.process_count() == 1:
        jax.distributed.initialize()
    if devices is None:
        devices = tuple(jax.devices())
    if flags & NO_MESSAGES:
        log.setLevel(logging.ERROR)
    elif flags & NO_VERBOSE:
        log.setLevel(logging.INFO)
    else:
        log.setLevel(logging.DEBUG)
    _NODE = Node(devices=tuple(devices), mesh=mesh, flags=flags, dtype=np.dtype(dtype))
    log.info("node_init: %d device(s), dtype=%s", len(devices), dtype)
    return _NODE


def node_finalize() -> None:
    """Tear down the execution environment (reference: node.h:220)."""
    global _NODE
    _NODE = None


def node_initialized() -> bool:
    return _NODE is not None


def get_node() -> Node:
    """Current node; creates a default one lazily."""
    if _NODE is None:
        node_init()
    return _NODE


def default_mesh(n_devices: Optional[int] = None, axis: str = "d") -> jax.sharding.Mesh:
    """A 1-D mesh over the node's devices (DM calls default to this)."""
    node = get_node()
    devs = node.devices if n_devices is None else node.devices[:n_devices]
    return jax.sharding.Mesh(np.array(devs), (axis,))


def full_precision(fn):
    """Decorator: run ``fn`` with every matrix product at full precision.

    GPUs may run float32 products in TF32 (10 mantissa bits) by default,
    which the f32 chain's orthogonality and residual gates do not survive;
    the public entry points pin "highest".  f64 products are unaffected.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def compilation_cache_dir() -> str:
    """Directory of the persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (jax reads it itself);
    otherwise ``.jax_cache`` in the checkout that holds this package,
    independent of the working directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Enable jax's persistent compilation cache; returns its directory.

    The fused Schur program compiles once per (n, geometry, dtype); the
    on-disk cache amortizes that across processes.  Only the checkout-local
    default is set here — a ``JAX_COMPILATION_CACHE_DIR`` from the
    environment is left to jax.
    """
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def verify_backend(w: int = 64) -> float:
    """Known-answer backend self-test; returns the orthogonality defect.

    Runs the Francis QR solver on a fixed matrix and measures ||ZZ^T - I||.
    A healthy f64 run gives ~1e-13; a backend whose f64 arithmetic or
    while-loop lowering is broken shows up as a defect orders of magnitude
    larger.  It exercises the whole solver loop (reflectors, bulge chase,
    deflation, 2x2 standardization) in one small dispatch.
    """
    import jax.numpy as jnp
    from starneig_jax.ops.small_schur import small_schur

    rng = np.random.default_rng(0)
    H = np.triu(rng.standard_normal((w, w)), -1)
    S, Z, info = small_schur(jnp.asarray(H), jnp.eye(w), w)
    Z = np.asarray(Z)
    return float(np.linalg.norm(Z @ Z.T - np.eye(w)))
