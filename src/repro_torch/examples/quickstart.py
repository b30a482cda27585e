"""Quickstart: LLAMP in 60 seconds, on the port.

Build an execution graph of a parallel workload, predict its runtime under
any network latency, read off λ_L / ρ_L, critical latencies and the
1%/2%/5% latency-tolerance zones (the paper's Fig 1 numbers), and hold the
latency curve against the discrete-event simulator.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import lp, sensitivity, simulator, synth
from repro_torch.core.loggps import cluster_params
from repro_torch.examples._cli import parser


def flow(px: int = 4, py: int = 4, iters: int = 10,
         deltas=np.linspace(0, 50, 6), lc_range=(0.5, 500.0),
         device=None) -> dict:
    """The quickstart on a ``px`` × ``py`` stencil of ``iters`` iterations
    (a LULESH-like halo exchange, CSCS testbed constants): the base-point
    analysis, the makespan LP (the port's IPM on ``device``), the
    tolerance zones, Algorithm 2's critical latencies over ``lc_range`` and
    the latency curve against the simulator."""
    p = cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(px, py, iters, halo_bytes=64e3, comp_us=500.0,
                        params=p)
    curve = sensitivity.latency_curve(g, p, deltas, device=device)
    measured = simulator.runtime_sweep(g, p, deltas)
    return {"graph": g, "params": p,
            "report": sensitivity.analyze(g, p, device=device),
            "lp": lp.predict_runtime(g, p, device=device),
            "tolerance": sensitivity.latency_tolerance(g, p, device=device),
            "critical": sensitivity.critical_latencies(g, p, *lc_range,
                                                       device=device),
            "deltas": np.asarray(deltas), "curve": curve,
            "measured": measured, "rrmse": curve.rrmse_vs(measured)}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    out = flow(device=args.device)
    print(f"workload: {out['graph'].summary()}\n")
    rep = out["report"]
    print("base-point analysis:")
    print(rep, "\n")
    sol = out["lp"]
    print(f"LP (interior point, {args.device}) runtime: {sol.T:.3f} µs  "
          f"λ_L={sol.lam[0]:.0f} (matches: {abs(sol.T - rep.T) < 1e-6})\n")
    for pct, t in out["tolerance"].items():
        print(f"  {pct * 100:.0f}% tolerance: ΔL ≤ {t:8.2f} µs")
    print()
    print(f"critical latencies in [0.5, 500] µs: "
          f"{[f'{x:.2f}' for x in out['critical'][:8]]}\n")
    print("ΔL sweep  predicted(µs)  'measured'(µs)")
    for d, a, b in zip(out["deltas"], out["curve"].T, out["measured"]):
        print(f"  {d:5.1f}    {a:12.3f}  {b:12.3f}")
    print(f"RRMSE = {out['rrmse']:.2e}  (paper bound: <2e-2)")
    return out


if __name__ == "__main__":
    main()
