"""Benchmark: Hessenberg + Schur wall-clock vs the reference baseline.

Prints the card and device, then ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Baseline (BASELINE.md, reference test-driver transcripts, 6 CPU workers):
  Hessenberg n=4000: 13,121 ms;  Schur (from Hessenberg) n=4000: 9,479 ms
  -> combined 22,600 ms.  vs_baseline scales the reference cubically when
  BENCH_N != 4000.

Besides wall-clock the detail block reports per-phase GFLOP/s (standard
algorithmic flop counts: 10/3 n^3 Hessenberg + 4/3 n^3 Q accumulation;
Schur uses the reference's effective volume ~2.3 n^3 derived from its
9.5 s / 6-core transcript) and the fraction of this device's GEMM rate in
the bench dtype, measured in the same run (BASELINE.json asks for flops/s
and fraction-of-peak, not just wall-clock).  The card's name and power
limit (``nvidia-smi``) and the JAX device are printed first.

Runs on a GPU only; ``BENCH_PLATFORM=cpu`` asks for a CPU run explicitly.

Environment knobs: BENCH_N (default 4000), BENCH_DTYPE (float64|float32),
BENCH_WARMUP (default 1: one untimed full-size run so the timed run
measures execution, not compilation), BENCH_PLATFORM (gpu|cpu).
"""

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

PLATFORM = os.environ.get("BENCH_PLATFORM", "gpu")
if PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from starneig_jax.node import enable_compilation_cache

enable_compilation_cache()

import numpy as np
import jax.numpy as jnp
from jax import lax


def measure_f64_gemm_peak(dtype, m: int = 2048, iters: int = 200) -> float:
    """Measured device GEMM throughput (GFLOP/s) in the bench dtype."""
    A = jnp.asarray(np.random.default_rng(1).standard_normal((m, m)) / m,
                    dtype)

    @jax.jit
    def chain(a):
        return lax.fori_loop(0, iters, lambda i, x: x @ a + 1e-9, a)

    chain(A).block_until_ready()  # compile
    t0 = time.perf_counter()
    chain(A).block_until_ready()
    dt = time.perf_counter() - t0
    return 2.0 * m ** 3 * iters / dt / 1e9


def solve(A):
    from starneig_jax.api import sep

    t0 = time.perf_counter()
    H, Q = jax.block_until_ready(sep.hessenberg(A))
    t_hess = time.perf_counter() - t0

    t0 = time.perf_counter()
    S, Q2, er, ei, info = jax.block_until_ready(sep.schur(H, Q))
    t_schur = time.perf_counter() - t0
    return H, (S, Q2, er, ei, info), t_hess, t_schur


def nvidia_smi() -> str:
    """The card's name and power limit, from a child that never imports
    JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not found"
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (r.stdout or r.stderr).strip()


def main():
    dev = jax.devices()[0]
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(f"jax devices: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    if dev.platform != PLATFORM:
        raise SystemExit(f"bench: platform {dev.platform!r}, asked for "
                         f"{PLATFORM!r}")
    n = int(os.environ.get("BENCH_N", "4000"))
    dtype = (jnp.float64
             if os.environ.get("BENCH_DTYPE", "float64") == "float64"
             else jnp.float32)

    rng = np.random.default_rng(0)
    A_host = rng.standard_normal((n, n))
    A = jnp.asarray(A_host, dtype=dtype)

    # warm-up: a full-size run so the timed pass measures execution only
    # (compiles are also persisted in .jax_cache across processes)
    if int(os.environ.get("BENCH_WARMUP", "1")):
        solve(A)

    H, (S, Q2, er, ei, info), t_hess, t_schur = solve(A)
    total_ms = (t_hess + t_schur) * 1e3

    # correctness gate: residual in units of u must stay within the
    # reference's fail threshold (10,000 u); u = eps of the bench dtype
    # (reference convention: 2^-52 for f64, test/common/checks.c:190)
    S_np, Q_np = map(np.asarray, (S, Q2))
    A_np = A_host.astype(S_np.dtype)
    u = float(jnp.finfo(dtype).eps)
    nrm = max(float(np.linalg.norm(A_np)), 1e-300)
    res = float(np.linalg.norm(Q_np @ S_np @ Q_np.T - A_np) / nrm / u)
    orth = float(np.linalg.norm(Q_np @ Q_np.T - np.eye(n)) / np.sqrt(n) / u)

    from starneig_jax.node import verify_backend
    backend_defect = verify_backend()

    # flops: Hessenberg 10/3 n^3 + Q accumulation 4/3 n^3; Schur effective
    # volume from the reference transcript (9.5 s at 16 GFLOP/s, n=4000)
    hess_gflops = (10.0 / 3.0 + 4.0 / 3.0) * n ** 3 / 1e9
    schur_gflops = 2.3 * n ** 3 / 1e9
    peak = measure_f64_gemm_peak(dtype)

    baseline_ms = 22600.0 * (n / 4000.0) ** 3  # cubic scaling from n=4000
    achieved = (hess_gflops + schur_gflops) / (total_ms / 1e3)
    out = {
        "metric": f"sep_hessenberg+schur_n{n}_wallclock",
        "value": round(total_ms, 1),
        "unit": "ms",
        "vs_baseline": round(baseline_ms / total_ms, 3),
        "detail": {
            "hessenberg_ms": round(t_hess * 1e3, 1),
            "schur_ms": round(t_schur * 1e3, 1),
            "residual_u": round(res, 1),
            "orthogonality_u": round(orth, 1),
            "info": int(info),
            "n": n,
            "dtype": str(np.dtype(dtype)),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "hessenberg_gflops": round(hess_gflops / t_hess, 1),
            "schur_gflops": round(schur_gflops / t_schur, 1),
            "device_gemm_peak_gflops": round(peak, 1),
            "fraction_of_gemm_peak": round(achieved / peak, 3),
            "backend_orth_defect": backend_defect,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
