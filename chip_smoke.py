#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one CUDA card (an H100).

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. device  — the card's name and count, and ``nvidia-smi``'s name and
             power limit;
2. build   — compiles every CUDA source of the package with ``nvcc``
             (``-Xptxas -v``), printing build seconds and each kernel's
             registers, shared memory and spills;
3. kernels — each kernel against its plain PyTorch version on the card,
             bit for bit, at the main path's shape (M = Vmax = 256,
             N = Emax = 128, K = 256 scenarios), a ragged shape, tie-heavy
             inputs and rows with no finite candidate; then each kernel's
             and plain version's time at the main-path shape (CUDA events)
             beside the least time the card could take;
4. main    — LLAMP's latency analysis of a 256-rank 2-D halo-exchange
             stencil (23,040 vertices, 1,024 padded levels) on the card:
             a 256-point latency curve with λ, the 1/2/5 % latency
             tolerances, then one values-only and one λ forward on a
             staged engine, with wall times, peak memory and the kernels'
             launch counts (which must equal padded levels × forwards),
             then a profile of one values-only forward;
5. cpu     — the same graph on the CPU (plain versions) over 16 of the
             curve's points: T within 1e-6 relative of the card's and λ
             equal; T also within 1e-5 of an independent float64 numpy
             longest-path evaluation.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero before doing anything.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAIN_SHAPE = (256, 128, 256)             # M = Vmax, N = Emax, K = scenarios
CURVE_POINTS = 256
CPU_EVERY = 16                           # CPU phase: every 16th curve point
SPIN_CYCLES = 500_000_000                # ~0.3 s at the H100's clocks


def say(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 10) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls.

    A spin kernel holds the card while the host enqueues the calls, so they
    run back to back and the host's per-call cost stays out of the time;
    the run fails if the host took longer to enqueue than the spin lasted.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    if host_ms >= spin_ms:
        fail(f"enqueueing {reps} calls took {host_ms:.1f} ms, longer than "
             f"the {spin_ms:.1f} ms spin: the timing would include host gaps")
    return ev[1].elapsed_time(ev[2]) / reps


def wall(fn):
    """(result, seconds) of ``fn`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    say(f"device: {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    return name


# -- phase 2 -----------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    say(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s "
        f"wall ({build.BUILD_DIR})")
    for lib in libs.values():
        say(f"  {lib.name}: nvcc {lib.seconds:.2f} s -> {lib.path.name}")
        for kernel, info in lib.ptxas.items():
            say(f"    {kernel}: {info}")


# -- phase 3 -----------------------------------------------------------------

def kernel_inputs(kind: str, M: int, N: int, K: int, seed: int):
    """(A, t, c) on the card.  ``main``: a level as the engine stages it —
    each column (edge) has one 0 (its destination), −1e30 elsewhere."""
    rng = np.random.default_rng(seed)
    neg = np.float32(-1e30)
    if kind == "main":
        A = np.full((M, N), neg)
        A[rng.integers(0, M, N), np.arange(N)] = 0.0
        t = rng.uniform(0.0, 1e4, (N, K))
        c = rng.integers(0, 200, (N, K))
    elif kind == "random":
        A = np.where(rng.random((M, N)) < 0.3, rng.uniform(0, 10, (M, N)), neg)
        t = rng.uniform(0.0, 100.0, (N, K))
        c = rng.integers(0, 6, (N, K))
    elif kind == "ties":
        A = np.where(rng.random((M, N)) < 0.5, rng.integers(0, 3, (M, N)), neg)
        t = rng.integers(0, 4, (N, K))
        c = np.ones((N, K))
    elif kind == "empty":
        A = np.where(rng.random((M, N)) < 0.2, 0.0, neg)
        A[::3] = neg
        t = rng.uniform(0.0, 50.0, (N, K))
        t[rng.random((N, K)) < 0.3] = neg
        t[:, 0] = neg
        c = rng.integers(0, 3, (N, K))
    else:
        raise ValueError(kind)
    return tuple(torch.from_numpy(x.astype(np.float32)).cuda()
                 for x in (A, t, c))


def phase_kernels() -> list:
    from repro_torch.kernels.maxplus import (maxplus_matvec,
                                             maxplus_matvec_argmax,
                                             maxplus_matvec_argmax_ref,
                                             maxplus_matvec_ref)
    cases = [("main", *MAIN_SHAPE), ("random", 333, 200, 37),
             ("ties", *MAIN_SHAPE), ("ties", 100, 77, 13),
             ("empty", *MAIN_SHAPE), ("empty", 100, 77, 13)]
    err = {"maxplus_matvec": 0.0, "maxplus_matvec_argmax": 0.0}
    for i, (kind, M, N, K) in enumerate(cases):
        A, t, c = kernel_inputs(kind, M, N, K, seed=i)
        out = maxplus_matvec(A, t)
        o, idx = maxplus_matvec_argmax(A, t, c)
        torch.cuda.synchronize()
        ref = maxplus_matvec_ref(A, t)
        ro, ri = maxplus_matvec_argmax_ref(A, t, c)
        ok = (torch.equal(out, ref) and torch.equal(o, ro)
              and torch.equal(idx, ri))
        e1 = float((out - ref).abs().max())
        e2 = float((o - ro).abs().max())
        say(f"check {kind:6s} {M}x{N}x{K}: max|out-plain| {e1} / {e2}, "
            f"idx mismatches {int((idx != ri).sum())}")
        if not ok:
            fail(f"kernel differs from its plain version on {kind} "
                 f"{M}x{N}x{K}")
        err["maxplus_matvec"] = max(err["maxplus_matvec"], e1)
        err["maxplus_matvec_argmax"] = max(err["maxplus_matvec_argmax"], e2)

    M, N, K = MAIN_SHAPE
    A, t, c = kernel_inputs("main", M, N, K, seed=99)
    ops = 2.0 * M * N * K                     # one add, one max per candidate
    rows = []
    for name, fn, plain, nbytes in (
            ("maxplus_matvec", lambda: maxplus_matvec(A, t),
             lambda: maxplus_matvec_ref(A, t), 4 * (M * N + N * K + M * K)),
            ("maxplus_matvec_argmax", lambda: maxplus_matvec_argmax(A, t, c),
             lambda: maxplus_matvec_argmax_ref(A, t, c),
             4 * (M * N + 2 * N * K + 2 * M * K))):
        ms = cuda_ms(fn, reps=500, warmup=50)
        plain_ms = cuda_ms(plain, reps=20, warmup=5)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/maxplus.cu",
            "replaces": ("src/repro/kernels/maxplus/kernel.py:45"
                         if name == "maxplus_matvec"
                         else "src/repro/kernels/maxplus/kernel.py:108"),
            "launches": None, "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None})
        say(f"time {name} {M}x{N}x{K}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
            f"({rows[-1]['bound_by']}: {nbytes} B, {ops:.0f} ops), "
            "library none")
    return rows


# -- phase 4 -----------------------------------------------------------------

def stencil():
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    p = cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(16, 16, 10, halo_bytes=64e3, comp_us=500.0, params=p)
    return g, p


def phase_main(g, p, rows: list) -> dict:
    from repro_torch.core import sensitivity
    from repro_torch.kernels.maxplus import (maxplus_matvec,
                                             maxplus_matvec_argmax)
    from repro_torch.sweep import Engine, compile_plan, latency_grid
    from repro_torch.sweep.engine import dense_forward

    plan = compile_plan(g, p)
    say(f"graph: {g.num_vertices} vertices, {g.num_edges} edges, "
        f"{g.nlevels} levels -> nlv_p {plan.nlv_p}, Vmax {plan.Vmax}, "
        f"Emax {plan.Emax}, indicator {plan.nlv_p * plan.Vmax * plan.Emax * 4 >> 20} "
        f"MiB, dense footprint {plan.dense_bytes() >> 20} MiB")
    deltas = np.linspace(0.0, 100.0, CURVE_POINTS)

    maxplus_matvec.launches = 0
    maxplus_matvec_argmax.launches = 0
    dense_forward.runs.clear()
    torch.cuda.reset_peak_memory_stats()
    curve, t_curve = wall(lambda: sensitivity.latency_curve(g, p, deltas))
    tol, t_tol = wall(lambda: sensitivity.latency_tolerance(
        g, p, (0.01, 0.02, 0.05)))
    eng, t_stage = wall(lambda: Engine(g, params=p))
    batch = latency_grid(p, deltas)
    vals, t_vals = wall(lambda: eng.run(batch, compute_lam=False))
    _, t_lam = wall(lambda: eng.run(batch))
    peak = torch.cuda.max_memory_allocated()
    launches = {"maxplus_matvec": maxplus_matvec.launches,
                "maxplus_matvec_argmax": maxplus_matvec_argmax.launches}
    runs = dict(dense_forward.runs)

    say(f"T(dL=0) = {curve.T[0]!r} us, lambda_L = {curve.lam[0]!r}, "
        f"rho_L = {curve.rho[0]!r}")
    say(f"tolerance: {tol}")
    say(f"wall: latency_curve {t_curve:.4f} s ({CURVE_POINTS} points, λ), "
        f"latency_tolerance {t_tol:.4f} s, Engine() {t_stage:.4f} s, "
        f"values-only run {t_vals:.4f} s, λ run {t_lam:.4f} s")
    say(f"peak device memory: {peak} B ({peak / 2**20:.1f} MiB)")
    say(f"forwards: {runs}; launches: {launches}; nlv_p {plan.nlv_p}")
    want = {"maxplus_matvec": plan.nlv_p * runs.get("values", 0),
            "maxplus_matvec_argmax": plan.nlv_p * runs.get("lam", 0)}
    if launches != want or min(launches.values()) <= 0:
        fail(f"launch counts {launches} != nlv_p x forwards {want}")
    for row in rows:
        row["launches"] = launches[row["name"]]

    T, lam = curve.T, curve.lam
    if T.shape != (CURVE_POINTS,) or lam.shape != (CURVE_POINTS,):
        fail(f"curve shapes {T.shape} {lam.shape}")
    if not (np.isfinite(T).all() and np.isfinite(lam).all()):
        fail("non-finite curve values")
    if not (np.diff(T) > 0).all():
        fail("T(ΔL) does not increase with ΔL")
    if not ((lam >= 1) & (lam == np.round(lam))).all():
        fail("λ_L must count critical-path messages: a positive integer")
    if not np.array_equal(vals.T, T):
        fail("values-only T differs from the λ run's T")
    tv = [tol[k] for k in (0.01, 0.02, 0.05)]
    if not (0 < tv[0] < tv[1] < tv[2] < np.inf):
        fail(f"tolerances not increasing: {tol}")

    for label, lam_run in (("values-only", False), ("λ", True)):
        profile_forward(label, lambda: eng.run(batch, compute_lam=lam_run))
    return {"deltas": deltas, "T": T, "lam": lam}


def profile_forward(label: str, fn) -> None:
    """One forward under the profiler: its wall, the device's busy time
    (the sum of kernel times) and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = wall(fn)
    # device rows only: a CPU op's row repeats its kernels' device time
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    dev_us = sum(_device_us(e) for e in rows)
    if dev_us <= 0:
        say(f"profile ({label} forward): no device time recorded "
            "(not measured)")
        return
    say(f"profile ({label} forward): wall {secs * 1e3:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / secs:.1f} %), "
        f"{sum(e.count for e in rows)} kernels")
    for e in sorted(rows, key=_device_us, reverse=True)[:6]:
        say(f"  {e.key[:60]:60s} {e.count:6d} calls "
            f"{_device_us(e) / 1e3:.3f} ms")


def _device_us(e) -> float:
    """Self device time of a profiler row (µs), across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


# -- phase 5 -----------------------------------------------------------------

def numpy_makespan(g, p, deltas) -> np.ndarray:
    """Independent float64 longest path per ΔL on class 0: level by level,
    t_start[v] = max over in-edges (t_end[u] + w), t_end = t_start + cost."""
    L = np.tile(np.asarray(p.L, dtype=np.float64), (len(deltas), 1))
    L[:, 0] += deltas
    w = g.econst[:, None] + g.elat.astype(np.float64) @ L.T      # [ne, S]
    t_start = np.zeros((g.num_vertices, len(deltas)))
    t_end = np.zeros_like(t_start)
    lvl_e = g.level[g.edst]
    eord = np.argsort(lvl_e, kind="stable")
    eptr = np.searchsorted(lvl_e[eord], np.arange(g.nlevels + 1))
    vord = np.argsort(g.level, kind="stable")
    vptr = np.searchsorted(g.level[vord], np.arange(g.nlevels + 1))
    for lv in range(g.nlevels):
        e = eord[eptr[lv]:eptr[lv + 1]]
        np.maximum.at(t_start, g.edst[e], t_end[g.esrc[e]] + w[e])
        v = vord[vptr[lv]:vptr[lv + 1]]
        t_end[v] = t_start[v] + g.vcost[v][:, None]
    return t_end.max(axis=0)


def phase_cpu(g, p, card: dict) -> None:
    from repro_torch.core import sensitivity
    sub = card["deltas"][::CPU_EVERY]
    t0 = time.perf_counter()
    cpu = sensitivity.latency_curve(g, p, sub, device="cpu")
    t_cpu = time.perf_counter() - t0
    T_card = card["T"][::CPU_EVERY]
    lam_card = card["lam"][::CPU_EVERY]
    rel = np.abs(cpu.T - T_card) / T_card
    say(f"cpu: {len(sub)} points in {t_cpu:.2f} s; max |T_cpu - T_card| / T "
        f"= {rel.max()!r}; lambda equal: {np.array_equal(cpu.lam, lam_card)}")
    if rel.max() > 1e-6 or not np.array_equal(cpu.lam, lam_card):
        fail("the card's curve differs from the plain versions' on the CPU")
    ref = numpy_makespan(g, p, sub)
    rel64 = np.abs(T_card - ref) / ref
    say(f"float64 numpy longest path: max |T_card - T64| / T64 = "
        f"{rel64.max()!r}")
    if rel64.max() > 1e-5:
        fail("the card's T is off the float64 longest path by > 1e-5")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    name = phase_device()
    phase_build()
    rows = phase_kernels()
    g, p = stencil()
    card = phase_main(g, p, rows)
    phase_cpu(g, p, card)
    say("kernels held against their plain versions: "
        + ", ".join(r["name"] for r in rows))
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
