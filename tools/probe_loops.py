"""Per-iteration cost of the SEP chain's serial loops on the device.

Each loop runs alone at the geometry the n=4000 solve resolves to, once to
compile and then timed (host clock around ``block_until_ready``):

  * ``small_schur``: the AED window Francis solve (per while iteration) and
    one full-length bulge-chase sweep inside it (per chase step);
  * ``_sweep_wave``: one wavefront pass of TMAX bulge trains (per hop);
  * ``_aed_deflate``: the spike-deflation state machine with a spike that
    deflates nothing, so every block moves (per test/move step);
  * ``_aed_recondense``: the window re-reduction (per column step);
  * ``hessenberg._panel``: one panel factorization (per column step);
  * ``sep.reorder_schur`` (left-half-plane selection) and
    ``sep.eigenvectors`` of the selected block on a synthetic n x n real
    Schur form: first call (compiles included) and a second call.

It also reads the compiled fused Schur program for copies of the full
(NP, NP) or (n, NP) while-loop carry, and writes a short profiler trace of
one Francis sweep and one wavefront pass with a device-time summary
(kernels per step, device busy share).  One JSON line per measurement.

Usage: python tools/probe_loops.py [n] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from starneig_jax.api import sep  # noqa: E402
from starneig_jax.config import HessenbergConf, SchurConf  # noqa: E402
from starneig_jax.node import enable_compilation_cache  # noqa: E402
from starneig_jax.ops import hessenberg as hess  # noqa: E402
from starneig_jax.ops import reorder  # noqa: E402
from starneig_jax.ops import schur as sch  # noqa: E402
from starneig_jax.ops import small_schur as ss  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def wall(fn, *args):
    """Seconds of one call after a compiling warm-up call."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def hessenberg_window(w, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(np.triu(rng.standard_normal((w, w)), -1))


def probe_francis(WA):
    H = hessenberg_window(WA, 1)
    Z = jnp.eye(WA)
    w = WA
    state = (jnp.zeros((w + 2, w + 2)).at[:w, :w].set(H),
             jnp.zeros((w, w + 2)).at[:, :w].set(Z), jnp.int32(w - 1),
             jnp.int32(0), jnp.int32(0), jnp.bool_(False), jnp.float64(0.0),
             jnp.int32(0), jnp.int32(30 * w))
    t, out = wall(ss._run, state)
    iters = int(out[4])
    emit(loop="small_schur", width=WA, seconds=t, while_iterations=iters,
         us_per_iteration=1e6 * t / max(iters, 1))

    sweep = jax.jit(lambda Hp, Zp: ss._sweep(
        Hp, Zp, jnp.int32(0), jnp.int32(w - 1), 0.5, 0.0, -0.5, 0.0))
    t, _ = wall(sweep, state[0], state[1])
    emit(loop="francis_sweep", width=WA, seconds=t, chase_steps=w - 1,
         us_per_step=1e6 * t / (w - 1))
    return sweep, state


def probe_sweep_wave(n, g):
    NP = n + 2 * g.P
    key = jax.random.PRNGKey(0)
    H = jnp.triu(jax.random.normal(key, (n, n), jnp.float64), -1)
    Spad = jnp.zeros((NP, NP)).at[g.P:g.P + n, g.P:g.P + n].set(H)
    Qpad = jnp.zeros((n, NP)).at[:, g.P:g.P + n].set(jnp.eye(n))
    rng = np.random.default_rng(2)
    sr = rng.standard_normal((g.TMAX, g.B, 2))
    shifts = jnp.asarray(np.stack([sr[..., 0], 0 * sr[..., 0], sr[..., 1],
                                   0 * sr[..., 1]], -1))
    eyeWC = jnp.eye(g.WC)
    wave = jax.jit(lambda S, Q: sch._sweep_wave(
        S, Q, eyeWC, jnp.int32(g.P), jnp.int32(g.P + n), shifts,
        jnp.int32(g.TMAX), G=g.TMAX, B=g.B))
    t, _ = wall(wave, Spad, Qpad)
    HOP = 3 * g.B
    nh = ((n - 2 + 3 * (g.B - 1) + 1) + HOP - 1) // HOP
    hops = nh + 3 * (g.TMAX - 1)
    emit(loop="sweep_wave", n=n, B=g.B, WC=g.WC, trains=g.TMAX, seconds=t,
         hops=hops, us_per_hop=1e6 * t / hops)
    return wave, (Spad, Qpad)


def probe_deflate_recondense(WA):
    H = hessenberg_window(WA, 3)
    T, V, info = ss.small_schur(H, jnp.eye(WA), WA)
    Tp = jnp.zeros((WA + 4, WA + 4)).at[:WA, :WA].set(T)
    Vp = jnp.zeros((WA, WA + 4)).at[:, :WA].set(V)
    state = (Tp, Vp, jnp.int32(WA), jnp.int32(0), jnp.int32(-1),
             jnp.bool_(False), jnp.int32(0), jnp.float64(1.0),
             jnp.float64(0.0))
    t, out = wall(sch._run_aed_deflate, state)
    steps = int(out[6])
    emit(loop="aed_deflate", width=WA, seconds=t, steps=steps,
         us_per_step=1e6 * t / max(steps, 1), kbot=int(out[2]))
    t, _ = wall(sch._aed_recondense, T, V, jnp.float64(0.1), jnp.int32(WA))
    emit(loop="aed_recondense", width=WA, seconds=t, column_steps=WA - 2,
         us_per_step=1e6 * t / (WA - 2))


def probe_panel(n):
    nb = HessenbergConf().resolve(n).panel_width
    A = jax.random.normal(jax.random.PRNGKey(1), (n, n), jnp.float64)
    panel = jax.jit(lambda A: hess._panel(A, 0, nb, 0, jnp.int32(n)))
    t, _ = wall(panel, A)
    emit(loop="hessenberg_panel", n=n, nb=nb, seconds=t, column_steps=nb,
         us_per_step=1e6 * t / nb)


def synthetic_schur(n, seed=0):
    """A standardized real Schur form with about half its eigenvalues in
    complex pairs (the layout ``sep.schur`` returns)."""
    rng = np.random.default_rng(seed)
    S = np.triu(rng.standard_normal((n, n)), 1) / np.sqrt(n)
    i = 0
    while i < n:
        if i + 1 < n and rng.random() < 0.5:
            p = rng.standard_normal()
            S[i, i] = S[i + 1, i + 1] = p
            S[i, i + 1] = abs(rng.standard_normal()) + 0.1
            S[i + 1, i] = -(abs(rng.standard_normal()) + 0.1)
            i += 2
        else:
            S[i, i] = rng.standard_normal()
            i += 1
    return S


def probe_reorder_eigenvectors(n):
    S = jnp.asarray(synthetic_schur(n))
    Q = jnp.eye(n)
    sel = sep.select(S, lambda lam: lam.real < 0)
    # count window passes and lockstep bubble steps (the batched while
    # loop's trip count) by wrapping the pass runner
    passes = []
    run = reorder._run_bubble_b

    def counting(init):
        out = run(init)
        passes.append((int(init[0].shape[0]), int(np.max(np.asarray(out[6])))))
        return out

    reorder._run_bubble_b = counting
    for call in ("first", "second"):
        passes.clear()
        t0 = time.perf_counter()
        S2, Q2, m, info = jax.block_until_ready(sep.reorder_schur(S, Q, sel))
        t_r = time.perf_counter() - t0
        sel2 = np.zeros(n, bool)
        sel2[:int(m)] = True
        t0 = time.perf_counter()
        jax.block_until_ready(sep.eigenvectors(S2, Q2, sel2))
        t_e = time.perf_counter() - t0
        steps = sum(st for _, st in passes)
        emit(stage="reorder+eigenvectors", n=n, call=call,
             selected=int(m), info=int(info), reorder_seconds=t_r,
             passes=len(passes), batch_sizes=sorted({g for g, _ in passes}),
             lockstep_steps=steps, us_per_step=1e6 * t_r / max(steps, 1),
             eigenvectors_seconds=t_e)
    reorder._run_bubble_b = run


def carry_copies(n):
    """Copies of the full carry buffers in the compiled fused program."""
    conf = SchurConf().resolve(n)
    g = sch.schur_geometry(n, conf)
    NP = n + 2 * g.P
    t0 = time.perf_counter()
    compiled = sch.schur_lowered(n).compile()
    t_c = time.perf_counter() - t0
    text = compiled.as_text()
    big = re.compile(r"f64\[(%d,%d|%d,%d)\][^ ]* (copy|copy-start)\(" %
                     (NP, NP, n, NP))
    comp = re.compile(r"^(ENTRY )?%?([\w.\-]+) .*\{$")
    hits, where = [], None
    for ln in text.splitlines():
        m = comp.match(ln)
        if m:
            where = m.group(2)
        elif big.search(ln):
            hits.append(f"{where}: {ln.strip()[:120]}")
    mem = compiled.memory_analysis()
    emit(check="fused_schur_carry_copies", n=n, NP=NP, compile_seconds=t_c,
         full_buffer_copies=len(hits), copies=hits,
         argument_bytes=mem.argument_size_in_bytes,
         alias_bytes=mem.alias_size_in_bytes,
         temp_bytes=mem.temp_size_in_bytes,
         carry_bytes=8 * (NP * NP + n * NP))


def trace_summary(trace_dir, label):
    """Device busy share and kernel count from the newest trace under
    ``trace_dir`` (GPU planes only; stream lines)."""
    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(files[-1])
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        ivs = sorted((e.start_ns, e.start_ns + e.duration_ns)
                     for name, evs in lines.items()
                     if name.startswith("Stream") for e in evs)
        if not ivs:
            continue
        busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
        for s, e in ivs[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        span = ivs[-1][1] - ivs[0][0]
        emit(trace=label, plane=plane.name, lines=sorted(lines),
             kernels=len(ivs), busy_ns=busy, span_ns=span,
             busy_share=busy / max(span, 1))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n", nargs="?", type=int, default=4000)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--only", default=None,
                   help="comma-separated subset: loops,reorder,carry")
    args = p.parse_args()
    enable_compilation_cache()
    devs = jax.devices()
    emit(platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), xla_flags=os.environ.get("XLA_FLAGS", ""))
    n = args.n
    conf = SchurConf().resolve(n)
    g = sch.schur_geometry(n, conf)
    emit(geometry=g._asdict(), n=n)

    only = set((args.only or "loops,reorder,carry").split(","))
    if "reorder" in only:
        probe_reorder_eigenvectors(n)
    if "carry" in only:
        carry_copies(n)
    if "loops" not in only:
        return
    sweep, sstate = probe_francis(g.WA)
    wave, wstate = probe_sweep_wave(n, g)
    probe_deflate_recondense(g.WA)
    probe_panel(n)
    if args.trace_dir:
        with jax.profiler.trace(os.path.join(args.trace_dir, "sweep")):
            jax.block_until_ready(sweep(*sstate[:2]))
        trace_summary(os.path.join(args.trace_dir, "sweep"),
                      f"francis_sweep w={g.WA} ({g.WA - 1} steps)")
        with jax.profiler.trace(os.path.join(args.trace_dir, "wave")):
            jax.block_until_ready(wave(*wstate))
        trace_summary(os.path.join(args.trace_dir, "wave"),
                      f"sweep_wave n={n}")


if __name__ == "__main__":
    main()
