#!/usr/bin/env python3
"""Algorithm 1's LP of a 2-D halo-exchange stencil on the card's sparse
Newton route (``repro_torch.core.ipm.SparseNewton``), with a line for every
IPM iteration, so a run cut by its time limit still says how far it got.

    python3 tools/ipm_probe.py [--stencil PX PY ITERS] [--check]
                               [--max-iter N] [--json PATH]

The default stencil is ``chip_smoke.py`` phase 6's (32 × 32 ranks, 100
iterations: 921,602 columns), under CSCS's L 3, o 5 µs, 64 kB halos and
500 µs of compute, as there.  Each iteration's line gives the wall so
far and the PCG steps of its two Newton solves; the end gives T and λ against ``core.dag``
(the scalar engine, on the host), the wall, the iterations, the PCG steps
a solve (min / median / max), the tree kernels' launches, the peak device
memory, and the card's name and power limit, then one JSON line (also
written to ``--json``).  ``--check`` first holds ``tree_factor`` and
``tree_solve`` against their plain versions on the first iteration's
forest (R 1 and 2 lanes; mismatches counted) and times them (CUDA events
over back-to-back launches) beside the chain bound (2 sweeps × levels ×
``TRIP_US``), its time and launches left out of the solve's.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
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


def check_kernels(ns, out: dict) -> None:
    """The tree kernels against their plain versions on ``ns``'s forest."""
    from repro_torch.kernels.ipm import (tree_factor, tree_factor_ref,
                                         tree_solve, tree_solve_ref)
    f = ns.forest
    piv, g = tree_factor(f, ns.diag)
    piv_r, g_r = tree_factor_ref(f, ns.diag)
    bad = int((piv != piv_r).sum() + (g != g_r).sum())
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"levels": f.nlv, "nv": f.nv, "factor_mismatches": bad}
    for R in (1, 2):
        r = torch.randn(f.nv, R, dtype=torch.float64, device="cuda",
                        generator=gen)
        x = tree_solve(f, piv, g, r)
        xr = tree_solve_ref(f, piv, g, r)
        res[f"solve_R{R}_mismatches"] = int((x != xr).sum())
        res[f"solve_R{R}_ms"] = events_ms(
            lambda: tree_solve(f, piv, g, r), 20)
    res["factor_ms"] = events_ms(lambda: tree_factor(f, ns.diag), 20)
    res["solve_chain_ms"] = 2 * f.nlv * TRIP_US / 1e3
    res["factor_chain_ms"] = f.nlv * TRIP_US / 1e3
    print(f"check: {res}", flush=True)
    out["check"] = res
    if bad or res["solve_R1_mismatches"] or res["solve_R2_mismatches"]:
        raise SystemExit("ipm_probe: the tree kernels differ from their "
                         "plain versions")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stencil", type=int, nargs=3, default=STENCIL)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ipm_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dag, ipm, lp, synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.kernels import build
    from repro_torch.kernels.ipm import tree_factor, tree_solve

    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all(["tree_precond"])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
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
    clock = {"t0": None, "extra": (0, 0)}

    class Progress(ipm.SparseNewton):
        """The sparse route, with a line an iteration."""

        def form(self, d):
            torch.cuda.synchronize()
            now = time.perf_counter() - clock["t0"]
            st = self.pcg_steps
            print(f"  iteration {self.iteration + 1}: {now:.2f} s; PCG "
                  f"steps of the last iteration {st[-2:]}, "
                  f"{sum(st)} in all", flush=True)
            super().form(d)
            if args.check and self.iteration == 1:
                t0 = time.perf_counter()
                n0 = (tree_factor.launches, tree_solve.launches)
                check_kernels(self, out)
                clock["t0"] += time.perf_counter() - t0   # not the solve's
                clock["extra"] = (tree_factor.launches - n0[0],
                                  tree_solve.launches - n0[1])

    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    f0, s0 = tree_factor.launches, tree_solve.launches
    torch.cuda.synchronize()
    clock["t0"] = time.perf_counter()
    sol = ipm._solve(prob, dev, newton=Progress)
    torch.cuda.synchronize()
    secs = time.perf_counter() - clock["t0"]
    peak = torch.cuda.max_memory_allocated()
    steps = sol.pcg_steps
    t0 = time.perf_counter()
    ref = dag.evaluate(g, p)
    t_dag = time.perf_counter() - t0
    rel = abs(sol.T - ref.T) / abs(ref.T)
    lam_rel = float(np.max(np.abs(sol.lam - ref.lam) / np.abs(ref.lam)))
    out.update({
        "status": sol.status, "iterations": sol.iterations,
        "wall_s": secs, "T": sol.T, "T_dag": ref.T, "T_rel": rel,
        "lam": sol.lam.tolist(), "lam_dag": ref.lam.tolist(),
        "lam_rel": lam_rel, "pcg_solves": len(steps),
        "pcg_steps": [int(min(steps)), float(np.median(steps)),
                      int(max(steps))], "pcg_total": int(sum(steps)),
        "tree_factor_launches": tree_factor.launches - f0
        - clock["extra"][0],
        "tree_solve_launches": tree_solve.launches - s0 - clock["extra"][1],
        "peak_bytes": peak, "dag_s": t_dag})
    print(f"LP: {sol.status} in {sol.iterations} iterations, {secs:.2f} s; "
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
