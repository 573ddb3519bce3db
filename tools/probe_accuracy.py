"""Accuracy probe: per-phase residual/orthogonality in units of u (f64).

Usage: python tools/probe_accuracy.py [n] [seed] [--platform cpu|gpu]

Writes one JSON line per phase so a regression is bisectable.  The platform
defaults to cpu (the f64 oracle); ``--platform gpu`` runs on the card and
fails if JAX finds none.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def report(name, A, S, Q, t):
    u = np.finfo(np.float64).eps
    nrm = np.linalg.norm(A)
    res = np.linalg.norm(Q @ S @ Q.T - A) / nrm / u
    orth = np.linalg.norm(Q @ Q.T - np.eye(A.shape[0])) / np.sqrt(A.shape[0]) / u
    print(json.dumps({"phase": name, "residual_u": round(float(res), 1),
                      "orth_u": round(float(orth), 1), "sec": round(t, 2)}))
    return res, orth


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n", nargs="?", type=int, default=600)
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("--platform", choices=("cpu", "gpu"), default="cpu")
    args = p.parse_args()
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    platform = jax.devices()[0].platform
    if platform != args.platform:
        raise SystemExit(f"probe_accuracy: platform {platform!r}, asked for "
                         f"{args.platform!r}")
    n, seed = args.n, args.seed
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    Aj = jnp.asarray(A)

    from starneig_jax.api import sep

    t0 = time.perf_counter()
    H, Q = jax.block_until_ready(sep.hessenberg(Aj))
    t_h = time.perf_counter() - t0
    Hn, Qn = np.asarray(H), np.asarray(Q)
    report("hessenberg", A, Hn, Qn, t_h)

    t0 = time.perf_counter()
    S, Q2, er, ei, info = jax.block_until_ready(sep.schur(H, Q))
    t_s = time.perf_counter() - t0
    Sn, Q2n = np.asarray(S), np.asarray(Q2)
    report("hessenberg+schur", A, Sn, Q2n, t_s)

    # schur phase alone: residual of S vs H through the incremental Z
    Z = Qn.T @ Q2n
    report("schur-alone", Hn, Sn, Z, t_s)
    print(json.dumps({"phase": "meta", "n": n, "seed": seed,
                      "info": int(info), "platform": platform,
                      "device_kind": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
