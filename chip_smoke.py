"""Smoke test: the SEP/GEP solve chains on one GPU, checked end to end.

Drives the public entry points (``starneig_jax.api.sep``/``gep``/``sep_dm``)
at the reference's sizes, in one JAX process, and checks every output with
the repository's validation hooks (``starneig_jax.testing.hooks``) in units
of the dtype's roundoff u.  Phases:

  1. ``node.verify_backend``: Francis QR orthogonality defect below 1e-12.
  2. SEP f64, n=4000: hessenberg -> schur -> select (left half-plane) ->
     reorder_schur -> eigenvectors, against host ``scipy.linalg.eigvals``.
  3. GEP f64, n=512: known-spectrum pencil with infinite eigenvalues through
     hessenberg_triangular -> schur -> reorder_schur -> eigenvectors.
  4. SEP f32, n=1000: hessenberg -> schur, gates in f32 units.

With ``--multi`` only the distributed chain runs: ``api.sep_dm`` at n=4000
with columns sharded over four devices, with the gates of phase 2.

Earlier lines give the card (``nvidia-smi``), the JAX devices, and for each
phase its wall time, the devices' ``peak_bytes_in_use`` and the gate values.
The last line is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage::

    python chip_smoke.py            # phases 1-4, one GPU
    python chip_smoke.py --multi    # sep_dm chain, four GPUs
    python chip_smoke.py --n 96 --gep-n 64
        # smaller sizes; on a platform other than gpu the phases run (a
        # rehearsal) and the script still exits non-zero at the device check

Exits non-zero, without the JSON line, when JAX finds no GPU or a gate
fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from starneig_jax.api import gep, sep, sep_dm  # noqa: E402
from starneig_jax.errors import Error  # noqa: E402
from starneig_jax.node import enable_compilation_cache, verify_backend  # noqa: E402
from starneig_jax.ops.schur import schur_lowered  # noqa: E402
from starneig_jax.parallel.distr import distr_matrix_from_array, make_mesh  # noqa: E402
from starneig_jax.testing import hooks, known_spectrum_pencil, random_dense  # noqa: E402

# the reference test driver's gates (BASELINE.md, hooks.c), in units of u
WARN_U = hooks.RESIDUAL_WARN          # 500
FAIL_U = hooks.RESIDUAL_FAIL          # 10,000
# comparisons against another solver's or the planted spectrum carry the
# eigenvalue condition numbers; the reference gates them 100x looser
# (hooks.c:1071-1072, cli.py --known-eigenvalues-*)
KNOWN_WARN_U = 1e4
KNOWN_FAIL_U = 1e6


class Gates:
    """Collects gate values for one phase; prints them all, then fails."""

    def __init__(self, phase: str):
        self.phase = phase
        self.values: dict = {}
        self.failed: list = []

    def le(self, name, value, fail, warn=None):
        value = float(value)
        tag = ("FAIL" if not value < fail else
               "warn" if warn is not None and value >= warn else "ok")
        self._add(name, value, tag, f"< {fail:g}")

    def eq(self, name, value, want):
        self._add(name, value, "ok" if value == want else "FAIL",
                  f"== {want}")

    def _add(self, name, value, tag, rule):
        self.values[name] = value
        if tag == "FAIL":
            self.failed.append(name)
        print(f"  [{self.phase}] {name} = {value} ({rule}) {tag}",
              flush=True)

    def check(self):
        if self.failed:
            raise AssertionError(
                f"phase {self.phase}: gates failed: {self.failed}")
        return self.values


def timed(fn, *args, **kw):
    """(result, seconds) of fn(*args, **kw), synchronized on its arrays;
    prints the time as soon as it is known."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    print(f"    {getattr(fn, '__name__', fn)}: {dt:.2f} s", flush=True)
    return out, dt


def peak_bytes():
    """peak_bytes_in_use of every local device (None where not reported)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.local_devices()]


def _selected_eigs(S, select):
    """(lambda, is_pair) for the selected blocks of a real Schur form, in
    the column order of ``sep.eigenvectors``."""
    n = S.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    d = np.diagonal(S)
    sup = np.concatenate([np.diagonal(S, 1), [0.0]])
    out, i = [], 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                out.append((0.5 * (d[i] + d[i + 1]) + 1j * np.sqrt(
                    abs(sup[i]) * abs(sub[i])), True))
            i += 2
        else:
            if select[i]:
                out.append((d[i], False))
            i += 1
    return out


def eigenvector_residual(A, S, X, select) -> float:
    """max_j ||A x_j - lambda_j x_j|| / (||A|| ||x_j||) in units of u."""
    A, X = np.asarray(A), np.asarray(X)
    cols, lams, c = [], [], 0
    for lam, pair in _selected_eigs(np.asarray(S), select):
        cols.append(X[:, c] + 1j * X[:, c + 1] if pair else X[:, c] + 0j)
        lams.append(lam)
        c += 2 if pair else 1
    if not cols:
        return 0.0
    Xc = np.stack(cols, axis=1)
    R = A @ Xc - Xc * np.asarray(lams)[None, :]
    r = np.linalg.norm(R, axis=0) / (np.linalg.norm(A) *
                                     np.linalg.norm(Xc, axis=0))
    return float(r.max()) / hooks.UNIT_ROUNDOFF[A.dtype]


def gep_eigenvector_residual(A, B, S, T, X, select) -> float:
    """max_j ||beta_j A x_j - alpha_j B x_j|| / ((||A|| + ||B||) ||x_j||
    max(1, |lambda_j|)) in units of u; infinite eigenvalues check B x = 0."""
    import scipy.linalg

    A, B, S, T, X = map(np.asarray, (A, B, S, T, X))
    n = A.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    nrm = np.linalg.norm(A) + np.linalg.norm(B)
    tsc = np.abs(np.diagonal(T)).max()
    worst, c, i = 0.0, 0, 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                ev = scipy.linalg.eigvals(S[i:i + 2, i:i + 2],
                                          T[i:i + 2, i:i + 2])
                lam = ev[0] if ev[0].imag > 0 else ev[1]
                x = X[:, c] + 1j * X[:, c + 1]
                r = np.linalg.norm(A @ x - lam * (B @ x)) / (
                    nrm * np.linalg.norm(x) * max(1.0, abs(lam)))
                worst = max(worst, float(r))
                c += 2
            i += 2
        else:
            if select[i]:
                x = X[:, c]
                if abs(T[i, i]) > 1e-12 * tsc:
                    lam = S[i, i] / T[i, i]
                    r = np.linalg.norm(A @ x - lam * (B @ x)) / (
                        nrm * np.linalg.norm(x) * max(1.0, abs(lam)))
                else:
                    r = np.linalg.norm(B @ x) / (nrm * np.linalg.norm(x))
                worst = max(worst, float(r))
                c += 1
            i += 1
    return worst / hooks.UNIT_ROUNDOFF[A.dtype]


def _lead_eigs(S, m):
    er, ei = map(np.asarray, sep.eigenvalues(S))
    return (er + 1j * ei)[:m]


def _schur_gates(g, A, H, Q, S, Q2, info):
    """Hessenberg and Schur gates, checked before the chain goes on."""
    A, H, Q, S, Q2 = map(np.asarray, (A, H, Q, S, Q2))
    g.eq("hessenberg_structure", hooks.hessenberg_structure_error(H), 0.0)
    g.le("hessenberg_residual_u", hooks.residual_sep(A, H, Q), FAIL_U, WARN_U)
    g.eq("schur_info", int(info), int(Error.SUCCESS))
    g.le("schur_residual_u", hooks.residual_sep(A, S, Q2), FAIL_U, WARN_U)
    g.le("schur_orthogonality_u", hooks.orthogonality(Q2), FAIL_U, WARN_U)
    g.eq("schur_structure", hooks.schur_structure_error(S), 0.0)
    g.eq("schur_finite", bool(np.all(np.isfinite(S))), True)
    g.check()


def _chain_gates(g, A, S, sel, S2, Q3, m, rinfo, X, xinfo, sel2):
    """Eigenvalue, reorder and eigenvector gates of a SEP chain."""
    A, S, S2, Q3 = map(np.asarray, (A, S, S2, Q3))
    er, ei = map(np.asarray, sep.eigenvalues(S))
    t0 = time.perf_counter()
    import scipy.linalg
    ref = scipy.linalg.eigvals(A)
    print(f"  [host] scipy.linalg.eigvals n={A.shape[0]}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    g.le("eigenvalues_vs_scipy_u", hooks.eigenvalue_error(er + 1j * ei, ref),
         KNOWN_FAIL_U, KNOWN_WARN_U)
    # reordering: all selected eigenvalues lead, values intact
    g.eq("reorder_info", int(rinfo), int(Error.SUCCESS))
    g.eq("reordering_check", hooks.reordering_check(er, ei, sel, m), True)
    g.eq("reorder_num_selected", int(m), int(sel.sum()))
    lead = _lead_eigs(S2, int(m))
    g.eq("reorder_lead_in_left_half_plane", bool(np.all(lead.real < 0)), True)
    g.le("reorder_perturbation_u",
         hooks.eigenvalue_error(lead, (er + 1j * ei)[sel]) if m else 0.0,
         hooks.EIGENVALUE_FAIL, hooks.EIGENVALUE_WARN)
    g.le("reorder_residual_u", hooks.residual_sep(A, S2, Q3), FAIL_U, WARN_U)
    g.le("reorder_orthogonality_u", hooks.orthogonality(Q3), FAIL_U, WARN_U)
    g.eq("reorder_structure", hooks.schur_structure_error(S2), 0.0)
    g.eq("eigenvectors_info_ok",
         int(xinfo) in (int(Error.SUCCESS), int(Error.CLOSE_EIGENVALUES)),
         True)
    X = np.asarray(X)
    g.eq("eigenvectors_finite", bool(np.all(np.isfinite(X))), True)
    g.le("eigenvector_residual_u", eigenvector_residual(A, S2, X, sel2),
         FAIL_U, WARN_U)


def phase_verify_backend():
    g = Gates("verify_backend")
    g.le("orthogonality_defect", verify_backend(), 1e-12)
    return g.check()


def phase_sep(n: int = 4000, seed: int = 0, warm: bool = False):
    """Phase 2: the SEP f64 chain on one device (``warm``: run the chain a
    second time and print its stage times too)."""
    g = Gates("sep")
    A = random_dense(n, seed=seed)
    if n > 300:
        t0 = time.perf_counter()
        compiled = schur_lowered(n, jnp.float64).compile()
        print(f"  [sep] fused schur program compile: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        print(f"  [sep] fused schur memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)
    Aj = jnp.asarray(A)
    (H, Q), t_h = timed(sep.hessenberg, Aj)
    (S, Q2, er, ei, info), t_s = timed(sep.schur, H, Q)
    _schur_gates(g, A, H, Q, S, Q2, info)
    sel = sep.select(S, lambda lam: lam.real < 0)
    (S2, Q3, m, rinfo), t_r = timed(sep.reorder_schur, S, Q2, sel)
    sel2 = np.zeros(n, bool)
    sel2[:int(m)] = True
    (X, xinfo), t_e = timed(sep.eigenvectors, S2, Q3, sel2)
    print(f"  [sep] first-call wall times, compile included (s): "
          f"hessenberg {t_h:.2f} schur {t_s:.2f} reorder {t_r:.2f} "
          f"eigenvectors {t_e:.2f}; selected {int(m)} of {n}", flush=True)
    if warm:
        _, t_h = timed(sep.hessenberg, Aj)
        _, t_s = timed(sep.schur, H, Q)
        _, t_r = timed(sep.reorder_schur, S, Q2, sel)
        _, t_e = timed(sep.eigenvectors, S2, Q3, sel2)
        print(f"  [sep] warm wall times (s): hessenberg {t_h:.2f} schur "
              f"{t_s:.2f} reorder {t_r:.2f} eigenvectors {t_e:.2f}",
              flush=True)
    _chain_gates(g, A, S, sel, S2, Q3, m, rinfo, X, xinfo, sel2)
    return g.check()


def phase_gep(n: int = 512, seed: int = 0):
    """Phase 3: the GEP f64 chain on a known-spectrum pencil with infinite
    eigenvalues."""
    g = Gates("gep")
    A, B, alpha, beta = known_spectrum_pencil(
        n, complex_ratio=0.5, inf_ratio=0.1, seed=seed)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    (H, T, Q, Z), t_ht = timed(gep.hessenberg_triangular, Aj, Bj)
    (S, T2, Q2, Z2, ar, ai, bt, info), t_s = timed(gep.schur, H, T, Q, Z)
    sel = gep.select(S, T2, lambda a, b: b != 0 and (a / b).real < 0)
    (S3, T3, Q3, Z3, m, rinfo), t_r = timed(
        gep.reorder_schur, S, T2, Q2, Z2, sel)
    sel2 = np.zeros(n, bool)
    sel2[:int(m)] = True
    (X, xinfo), t_e = timed(gep.eigenvectors, S3, T3, Q3, Z3, sel2)
    print(f"  [gep] first-call wall times, compile included (s): "
          f"hessenberg_triangular {t_ht:.2f} schur {t_s:.2f} reorder "
          f"{t_r:.2f} eigenvectors {t_e:.2f}; selected {int(m)} of {n}",
          flush=True)
    H, T, Q, Z = map(np.asarray, (H, T, Q, Z))
    g.eq("ht_structure", max(hooks.hessenberg_structure_error(H),
                             hooks.triangular_structure_error(T)), 0.0)
    ra, rb = hooks.residual_gep(A, B, H, T, Q, Z)
    g.le("ht_residual_u", max(ra, rb), FAIL_U, WARN_U)
    g.eq("schur_info", int(info), int(Error.SUCCESS))
    S, T2, Q2, Z2 = map(np.asarray, (S, T2, Q2, Z2))
    ra, rb = hooks.residual_gep(A, B, S, T2, Q2, Z2)
    g.le("schur_residual_u", max(ra, rb), FAIL_U, WARN_U)
    g.le("schur_orthogonality_u",
         max(hooks.orthogonality(Q2), hooks.orthogonality(Z2)),
         FAIL_U, WARN_U)
    g.eq("schur_structure", max(hooks.schur_structure_error(S),
                                hooks.triangular_structure_error(T2)), 0.0)
    fin = np.abs(beta) > 0
    g.le("chordal_vs_known_u", hooks.chordal_eigenvalue_error(
        ar, ai, bt, alpha[fin], beta[fin]), KNOWN_FAIL_U, KNOWN_WARN_U)
    ana = hooks.spectrum_analysis(ar, ai, bt)
    print(f"  [gep] analysis: {ana['infinite']} infinite of "
          f"{int((~fin).sum())} planted", flush=True)
    g.eq("reorder_info", int(rinfo), int(Error.SUCCESS))
    g.eq("reorder_num_selected", int(m), int(sel.sum()))
    ar3, ai3, bt3 = map(np.asarray, gep.eigenvalues(S3, T3))
    ar, ai, bt = map(np.asarray, (ar, ai, bt))
    g.le("reorder_perturbation_u", hooks.chordal_eigenvalue_error(
        ar3[:int(m)], ai3[:int(m)], bt3[:int(m)], (ar + 1j * ai)[sel], bt[sel])
        if m else 0.0, hooks.EIGENVALUE_FAIL, hooks.EIGENVALUE_WARN)
    S3, T3, Q3, Z3 = map(np.asarray, (S3, T3, Q3, Z3))
    ra, rb = hooks.residual_gep(A, B, S3, T3, Q3, Z3)
    g.le("reorder_residual_u", max(ra, rb), FAIL_U, WARN_U)
    g.eq("eigenvectors_info_ok",
         int(xinfo) in (int(Error.SUCCESS), int(Error.CLOSE_EIGENVALUES)),
         True)
    g.le("eigenvector_residual_u",
         gep_eigenvector_residual(A, B, S3, T3, X, sel2), FAIL_U, WARN_U)
    return g.check()


def phase_sep_f32(n: int = 1000, seed: int = 0):
    """Phase 4: SEP Hessenberg + Schur in float32, gates in f32 units."""
    g = Gates("sep_f32")
    A = random_dense(n, seed=seed, dtype=np.float32)
    (H, Q), t_h = timed(sep.hessenberg, jnp.asarray(A))
    (S, Q2, er, ei, info), t_s = timed(sep.schur, H, Q)
    print(f"  [sep_f32] first-call wall times, compile included (s): "
          f"hessenberg {t_h:.2f} schur {t_s:.2f}", flush=True)
    H, S, Q2 = map(np.asarray, (H, S, Q2))
    g.eq("dtype", str(S.dtype), "float32")
    g.eq("hessenberg_structure", hooks.hessenberg_structure_error(H), 0.0)
    g.eq("schur_info", int(info), int(Error.SUCCESS))
    g.le("schur_residual_u", hooks.residual_sep(A, S, Q2), FAIL_U, WARN_U)
    g.le("schur_orthogonality_u", hooks.orthogonality(Q2), FAIL_U, WARN_U)
    g.eq("schur_structure", hooks.schur_structure_error(S), 0.0)
    return g.check()


def phase_sep_dm(n: int = 4000, ndev: int = 4, seed: int = 0):
    """--multi: the sep_dm chain with columns sharded over ``ndev``
    devices (1-D mesh from ``parallel.distr.make_mesh``)."""
    g = Gates("sep_dm")
    mesh = make_mesh(ndev)
    A = random_dense(n, seed=seed)
    Ad = distr_matrix_from_array(A, mesh)
    (Hd, Qd), t_h = timed(sep_dm.hessenberg, Ad)
    (Sd, Qd2, er, ei, info), t_s = timed(sep_dm.schur, Hd, Qd)
    _schur_gates(g, A, Hd.data, Qd.data, Sd.data, Qd2.data, info)
    sel = sep_dm.select(Sd, lambda lam: lam.real < 0)
    (Sd2, Qd3, m, rinfo), t_r = timed(sep_dm.reorder_schur, Sd, Qd2, sel)
    sel2 = np.zeros(n, bool)
    sel2[:int(m)] = True
    (X, xinfo), t_e = timed(sep_dm.eigenvectors, Sd2, Qd3, sel2)
    print(f"  [sep_dm] first-call wall times, compile included (s): "
          f"hessenberg {t_h:.2f} schur {t_s:.2f} reorder {t_r:.2f} "
          f"eigenvectors {t_e:.2f}; selected {int(m)} of {n}", flush=True)
    for name, M in (("S", Sd.data), ("Q", Qd2.data), ("S_reordered", Sd2.data),
                    ("Q_reordered", Qd3.data)):
        g.eq(f"{name}_devices", len(M.sharding.device_set), ndev)
    _chain_gates(g, A, Sd.data, sel, Sd2.data, Qd3.data, m, rinfo, X.data,
                 xinfo, sel2)
    return g.check()


def nvidia_smi() -> str:
    """The card's name and power limit, from a child that never imports
    JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (r.stdout or r.stderr).strip()


def device_info() -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(info: dict) -> None:
    """Refuse any platform but gpu (exit status 1, no result line)."""
    if info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: JAX platform is {info['platform']!r}, "
                         "not gpu; no result")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the sep_dm chain on four devices")
    p.add_argument("--n", type=int, default=None,
                   help="SEP and sep_dm size (default 4000); f32 uses "
                        "min(n, 1000)")
    p.add_argument("--warm", action="store_true",
                   help="also time a second run of the SEP chain")
    p.add_argument("--gep-n", type=int, default=None,
                   help="GEP size (default 512; min(n, 512) with --n)")
    args = p.parse_args(argv)

    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    info = device_info()
    print(f"jax devices: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    if args.n is None:
        require_gpu(info)       # no full-size run anywhere but the card
    enable_compilation_cache()

    n = 4000 if args.n is None else args.n
    gep_n = args.gep_n or (512 if args.n is None else min(args.n, 512))
    if args.multi:
        if info["count"] < 4:
            raise SystemExit(f"chip_smoke --multi: needs 4 devices, found "
                             f"{info['count']}")
        phases = [("sep_dm", lambda: phase_sep_dm(n, 4))]
    else:
        phases = [("verify_backend", phase_verify_backend),
                  ("sep", lambda: phase_sep(n, warm=args.warm)),
                  ("gep", lambda: phase_gep(gep_n)),
                  ("sep_f32", lambda: phase_sep_f32(min(n, 1000)))]
    for name, fn in phases:
        print(f"phase {name}: start", flush=True)
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        print(f"phase {name}: ok, wall {dt:.2f} s (cold: first run in this "
              f"process, compiles and host checks included), "
              f"peak_bytes_in_use {peak_bytes()}", flush=True)

    require_gpu(info)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))


if __name__ == "__main__":
    main(sys.argv[1:])
