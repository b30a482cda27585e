"""Scenario-sweep study on the port: thousands of what-if network designs
in one call.

Compile the execution graph once, then evaluate a cartesian latency ×
bandwidth LogGPS grid in one batched forward, reading T, λ_L and ρ_L for
every scenario; repeat it from the result cache; then run
collective-algorithm variants as the structure axis of one query.

    PYTHONPATH=src python -m repro_torch.examples.sweep_study [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch import sweep
from repro_torch.core import synth
from repro_torch.core.loggps import pod_model
from repro_torch.examples._cli import parser

ALGOS = ("ring", "recursive_doubling", "recursive_halving")
GSCALES = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)


def flow(cg=(4, 4, 6), pod: int = 8, lat_points: int = 200,
         gscales=GSCALES, chain=(16, 4), deltas=np.linspace(0.0, 100.0, 50),
         algos=ALGOS, device=None) -> dict:
    """An HPCG-like CG solve on two pods (class 0 ICI, class 1 DCN;
    ``pod_model(pod).params()``, the reference's ``tpu_pod_params``): the
    DCN ΔL × DCN γ cartesian grid (``lat_points`` × ``len(gscales)``
    scenarios) on one engine with a result cache, the same grid again, and
    the allreduce algorithms of an ``chain`` = (ranks, steps) chain as one
    ``StructureBatch.from_plans`` query over ``deltas``."""
    p = pod_model(pod, L_ici_us=1.0, L_dcn_us=10.0).params()
    g = synth.cg_like(*cg, params=p)
    eng = sweep.Engine(g, params=p,
                       policy=sweep.ExecPolicy(cache=sweep.SweepCache()),
                       device=device)
    grid = sweep.cartesian_grid(
        p, lat_deltas={1: np.linspace(0.0, 200.0, lat_points)},
        gscales={1: list(gscales)})
    res = eng.run(grid)
    again = eng.run(grid)
    variants = sweep.collective_variants(
        lambda a: synth.allreduce_chain(*chain, params=p, algo=a),
        list(algos), p)
    sb = sweep.StructureBatch.from_plans(
        [sweep.compile_plan(v.graph, v.params) for v in variants],
        names=[v.name for v in variants])
    out = sweep.Engine(sb, device=device).run(
        sweep.Query(scenarios=sweep.latency_grid(p, deltas))).split()
    return {"graph": g, "params": p, "grid": grid, "res": res,
            "again": again, "variants": variants, "deltas": deltas,
            "by_algo": out}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    o = flow(device=args.device)
    res, grid = o["res"], o["grid"]
    print(f"workload: {o['graph'].summary()}\n")
    print(f"evaluated {res.S} scenarios in one batched call "
          f"(backend={res.backend}, {res.device})")
    i_best, i_worst = res.argbest(), int(np.argmax(res.T))
    print(f"  best : T={res.T[i_best]:10.1f} µs  at {grid.meta[i_best]}")
    print(f"  worst: T={res.T[i_worst]:10.1f} µs  at {grid.meta[i_worst]}")
    rho_dcn = res.rho[:, 1]
    print(f"  ρ_L[dcn] ranges {rho_dcn.min():.3f} → {rho_dcn.max():.3f}\n")
    print(f"re-run from cache: {o['again'].from_cache}\n")
    variants, deltas, out = o["variants"], o["deltas"], o["by_algo"]
    print("allreduce algorithm under rising ICI latency (T µs):")
    print(f"  {'ΔL':>6} " + " ".join(f"{v.name:>24}" for v in variants))
    for k in (0, len(deltas) // 2 - 1, len(deltas) - 1):
        row = " ".join(f"{out[v.name].T[k]:24.1f}" for v in variants)
        print(f"  {deltas[k]:6.1f} {row}")
    lam0 = {v.name: out[v.name].lam[0, 0] for v in variants}
    print("\nλ_L at base point per algorithm: "
          + ", ".join(f"{k.split('=')[1]}={v:.0f}" for k, v in lam0.items()))
    return o


if __name__ == "__main__":
    main()
