#!/usr/bin/env python3
"""Algorithm 1's LP of a 2-D halo-exchange stencil on the card's sparse
Newton route (``repro_torch.core.ipm.SparseNewton``), with a line for every
IPM iteration, so a run cut by its time limit still says how far it got.

    python3 tools/ipm_probe.py [--stencil PX PY ITERS] [--check]
                               [--max-iter N] [--deadline S]
                               [--json PATH] [--save PATH] [--forest PATH]

The default stencil is ``chip_smoke.py`` phase 6's (32 × 32 ranks, 100
iterations: 921,602 columns), under CSCS's L 3, o 5 µs, 64 kB halos and
500 µs of compute, as there; ``--stencil 16 16 40`` is phase 16 (b)'s.
Each iteration's line gives the wall so far and the PCG steps of its two
Newton solves; the end gives T and λ against ``core.dag`` (the scalar
engine, on the host), the wall, the iterations, the PCG steps a solve
(min / median / max) and the ms a PCG step, the tree kernels' launches,
the peak device memory, and the card's name and power limit, then one
JSON line (also written to ``--json``).  ``--deadline`` stops the IPM at
its first iteration past S seconds (the JSON line then says how far it
got).

``--check`` holds ``tree_factor`` and ``tree_solve`` against their plain
versions on the first iteration's forest and, when the LP ends, on the
last one's (R 1 and 2 lanes; mismatches counted) and times them (CUDA
events over back-to-back launches), their time and launches left out of
the solve's.  Beside each: µs a level a sweep, the block's warps and
levels a ring slot, the reads that miss the window, the layout's time
(``stage.py``'s tensors made anew), ptxas's registers, shared memory and
spills, and both chains: device memory (2 sweeps × levels × ``TRIP_US``)
and on chip (the ``-DTP_CHAIN_ONLY`` build of ``tree_precond.cu``: a
barrier, one dependent shared-memory read and the float64 arithmetic a
level), the two builds timed in turns.  ``--save`` keeps the last forest
and its diagonal in a file; ``--forest`` checks such a file alone, without
the LP.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
STENCIL = (32, 32, 100)                  # chip_smoke.py's SPARSE_STENCIL
# one dependent device-memory load (chip_smoke.py's TRIP_US)
TRIP_US = 0.2624
# the on-chip chain's build of tree_precond.cu (its nvcc flags)
CHAIN_FLAGS = ("-DTP_CHAIN_ONLY",)


class Deadline(Exception):
    """The IPM passed ``--deadline``."""


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def layout_ms(f, g, reps: int = 10) -> float:
    """The staged layout of forest ``f`` and ``g`` made anew: ms a call
    (CUDA events, host included: the level table, ``w[ch]``, the widest
    level and ``g[ch]``)."""
    from repro_torch.kernels.ipm import stage

    def once():
        f._stage = f._gk = None
        stage.factor_layout(f)
        stage.solve_layout(f, g)

    return events_ms(once, reps)


def check_kernels(label: str, f, diag, libs: dict, ptxas: dict) -> dict:
    """The tree kernels of ``libs['base']`` (the package's build) and
    ``libs['chain']`` (the chain-only build) on forest ``f``: the package's
    results checked, both timed."""
    from repro_torch.kernels.ipm import (ops, stage, tree_factor_ref,
                                         tree_solve_ref)
    base = libs["base"]
    piv, g = torch.empty_like(diag), torch.empty_like(diag)

    def launched(err):
        if err:
            raise SystemExit(f"ipm_probe: launch failed: cudaError {err}")

    launched(ops.launch_factor(base, f, diag, piv, g))
    piv_r, g_r = tree_factor_ref(f, diag)
    W, (C, P, ck) = ops.window_positions(base), ops.block_shape(f, base)
    res = {"levels": f.nlv, "nv": f.nv, "widest_level": stage.widest_level(f),
           "mean_width": stage.factor_layout(f).width,
           "consumer_warps": C, "producer_warps": P, "chunk_levels": ck,
           "window": W,
           "window_misses": stage.window_misses(f, W),
           "factor_mismatches": int((piv != piv_r).sum() + (g != g_r).sum()),
           "layout_ms": layout_ms(f, g),
           "solve_chain_ms": 2 * f.nlv * TRIP_US / 1e3,
           "factor_chain_ms": f.nlv * TRIP_US / 1e3,
           "ptxas": {k: v for k, v in ptxas.items()
                     if f"kernelILi{C}E" in k}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rs = {R: torch.randn(f.nv, R, dtype=torch.float64, device="cuda",
                         generator=gen) for R in (1, 2)}
    want = {R: tree_solve_ref(f, piv, g, r) for R, r in rs.items()}
    for R, r in rs.items():
        x = torch.empty_like(r)
        launched(ops.launch_solve(base, f, piv, g, r, x))
        res[f"solve_R{R}_mismatches"] = int((x != want[R]).sum())
    times: dict = {}
    for name in list(libs) + list(libs)[::-1]:        # in turns
        print(f"timing {name}", flush=True)
        lib, exact = libs[name], name == "base"
        pv, gv = torch.empty_like(diag), torch.empty_like(diag)
        t = {"factor": events_ms(lambda: launched(ops.launch_factor(
            lib, f, diag, pv, gv)), 20)}
        for R, r in rs.items():
            x = torch.empty_like(r)
            t[f"solve_R{R}"] = events_ms(lambda: launched(ops.launch_solve(
                lib, f, piv, g, r, x)), 20)
            if exact and not torch.equal(x, want[R]):
                raise SystemExit(f"ipm_probe: {name} differs from the "
                                 f"plain tree_solve at R {R}")
        if exact and not (torch.equal(pv, piv_r) and torch.equal(gv, g_r)):
            raise SystemExit(f"ipm_probe: {name} differs from the plain "
                             "tree_factor")
        for k, v in t.items():
            times.setdefault(name, {}).setdefault(k, []).append(v)
    res["ms"] = times
    b = times["base"]
    res["us_a_level_a_sweep"] = min(b["solve_R2"]) * 1e3 / (2 * f.nlv)
    res["onchip_solve_chain_ms"] = min(times["chain"]["solve_R2"])
    res["onchip_factor_chain_ms"] = min(times["chain"]["factor"])
    res["onchip_us_a_level_a_sweep"] = \
        res["onchip_solve_chain_ms"] * 1e3 / (2 * f.nlv)
    print(f"check ({label} forest): {res}", flush=True)
    bad = res["factor_mismatches"] + res["solve_R1_mismatches"] \
        + res["solve_R2_mismatches"]
    if bad:
        raise SystemExit("ipm_probe: the tree kernels differ from their "
                         "plain versions")
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stencil", type=int, nargs=3, default=STENCIL)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--save", default=None,
                    help="torch.save the last forest and diag here")
    ap.add_argument("--forest", default=None,
                    help="check a forest --save wrote, without the LP")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ipm_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dag, ipm, lp, synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.kernels import build
    from repro_torch.kernels.ipm import ops, tree_factor, tree_solve

    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = build.build_all(["tree_precond"], variants={
        "chain": ("tree_precond", CHAIN_FLAGS)} if args.check else None)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    libs = {"base": ops._lib()}
    if args.check:
        libs["chain"] = ops.bind(ctypes.CDLL(str(built["chain"].path)))
    ptxas = built["tree_precond"].ptxas
    if args.forest:
        from repro_torch.kernels.ipm import Forest
        kept = torch.load(args.forest)
        f = Forest(*(kept[k].cuda() for k in ("parent", "w", "ch_ptr", "ch",
                                               "lv_ptr")), kept["levels"])
        out = {"card": name, "forest": args.forest,
               "check": check_kernels("saved", f, kept["diag"].cuda(), libs,
                                      ptxas)}
        print(json.dumps(out))
        return 0
    px, py, iters = args.stencil
    p = cluster_params(L_us=3.0, o_us=5.0)
    t0 = time.perf_counter()
    g = synth.stencil2d(px, py, iters, halo_bytes=64e3, comp_us=500.0,
                        params=p)
    prob = lp.build_lp(g, p)
    print(f"stencil2d({px}, {py}, {iters}): {g.num_vertices} vertices, "
          f"{g.nlevels} levels; LP {prob.A.shape[0]} rows x {prob.nvars} "
          f"columns, {prob.A.nnz} nonzeros; built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {"card": name, "stencil": [px, py, iters], "columns": prob.nvars}
    if args.max_iter is not None:
        ipm.MAX_ITER = args.max_iter
    clock = {"t0": None, "extra": [0, 0]}
    last = {}

    class Progress(ipm.SparseNewton):
        """The sparse route, with a line an iteration."""

        def form(self, d):
            torch.cuda.synchronize()
            now = time.perf_counter() - clock["t0"]
            st = self.pcg_steps
            print(f"  iteration {self.iteration + 1}: {now:.2f} s; PCG "
                  f"steps of the last iteration {st[-2:]}, "
                  f"{sum(st)} in all", flush=True)
            last["ns"] = self
            if args.deadline is not None and now > args.deadline:
                raise Deadline
            super().form(d)
            if args.check and self.iteration == 1:
                checked(self, "first")

    def checked(ns, label):
        """``check_kernels`` on ``ns``'s forest, its time and launches
        left out of the solve's."""
        t0 = time.perf_counter()
        n0 = (tree_factor.launches, tree_solve.launches)
        out[f"check_{label}"] = check_kernels(label, ns.forest, ns.diag,
                                              libs, ptxas)
        clock["t0"] += time.perf_counter() - t0
        clock["extra"][0] += tree_factor.launches - n0[0]
        clock["extra"][1] += tree_solve.launches - n0[1]

    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    f0, s0 = tree_factor.launches, tree_solve.launches
    torch.cuda.synchronize()
    clock["t0"] = time.perf_counter()
    try:
        sol = ipm._solve(prob, dev, newton=Progress)
    except Deadline:
        sol = None
    torch.cuda.synchronize()
    secs = time.perf_counter() - clock["t0"]
    peak = torch.cuda.max_memory_allocated()
    steps = last["ns"].pcg_steps if sol is None else sol.pcg_steps
    out.update({
        "wall_s": secs, "pcg_solves": len(steps),
        "pcg_steps": [int(min(steps)), float(np.median(steps)),
                      int(max(steps))], "pcg_total": int(sum(steps)),
        "ms_a_pcg_step": secs * 1e3 / max(sum(steps), 1),
        "tree_factor_launches": tree_factor.launches - f0
        - clock["extra"][0],
        "tree_solve_launches": tree_solve.launches - s0 - clock["extra"][1],
        "peak_bytes": peak})
    if args.check and hasattr(last["ns"], "forest"):
        checked(last["ns"], "last")
    if args.save and hasattr(last["ns"], "forest"):
        f = last["ns"].forest
        torch.save({"parent": f.parent.cpu(), "w": f.w.cpu(),
                    "ch_ptr": f.ch_ptr.cpu(), "ch": f.ch.cpu(),
                    "lv_ptr": f.lv_ptr.cpu(), "levels": f.levels,
                    "diag": last["ns"].diag.cpu()}, args.save)
    if sol is None:
        out.update({"status": "cut", "iterations": last["ns"].iteration})
        print(f"LP: cut at --deadline {args.deadline} s in iteration "
              f"{last['ns'].iteration + 1}, {secs:.2f} s; {out}", flush=True)
        print(json.dumps(out))
        return 1
    t0 = time.perf_counter()
    ref = dag.evaluate(g, p)
    t_dag = time.perf_counter() - t0
    rel = abs(sol.T - ref.T) / abs(ref.T)
    lam_rel = float(np.max(np.abs(sol.lam - ref.lam) / np.abs(ref.lam)))
    out.update({
        "status": sol.status, "iterations": sol.iterations,
        "T": sol.T, "T_dag": ref.T, "T_rel": rel,
        "lam": sol.lam.tolist(), "lam_dag": ref.lam.tolist(),
        "lam_rel": lam_rel, "dag_s": t_dag})
    print(f"LP: {sol.status} in {sol.iterations} iterations, {secs:.2f} s "
          f"({out['ms_a_pcg_step']:.4f} ms a PCG step); "
          f"T {sol.T!r} against core.dag's {ref.T!r} ({rel:.3e}); lambda "
          f"{sol.lam.tolist()} against {ref.lam.tolist()} ({lam_rel:.3e}); "
          f"PCG steps a solve min / median / max {out['pcg_steps']}, "
          f"{out['pcg_total']} in all; launches tree_factor "
          f"{out['tree_factor_launches']}, tree_solve "
          f"{out['tree_solve_launches']}; peak {peak} B "
          f"({peak / 2**30:.3f} GiB); core.dag {t_dag:.2f} s", flush=True)
    line = json.dumps(out)
    print(line)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line + "\n")
    return 0 if sol.status == "optimal" and rel <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
