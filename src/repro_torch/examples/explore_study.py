"""Design-space co-design study on the port: GA vs random over split ×
algo × placement.

For a CG-like stencil+allreduce app on P=16 ranks of a two-tier (pod)
fabric, pick the 2-D decomposition ``px × py``, the allreduce algorithm
and the process placement that minimize the 95th-percentile makespan over
a 50-scenario latency-degradation grid.  Both arms run through one warm
:class:`~repro_torch.explore.Stamper` (a generation is a handful of packed
queries, revisited designs are cache hits); the winner is re-verified with
an independent solo rebuild (bit-identical on the segment backend).

    PYTHONPATH=src python -m repro_torch.examples.explore_study \\
        [--device cpu]
"""

from __future__ import annotations

from repro_torch import explore
from repro_torch.core.loggps import LogGPS
from repro_torch.examples._cli import parser
from repro_torch.sweep import sample_grid

P, ITERS = 16, 3
GENERATIONS, POPULATION = 3, 16
SEARCHERS = ("random", "evolution")


def flow(P: int = P, iters: int = ITERS, generations: int = GENERATIONS,
         population: int = POPULATION, budget: int = 50, seed: int = 3,
         device=None, policy=None) -> dict:
    """Both searchers over ``preset("codesign", P, iters)``, ``generations``
    × ``population`` each on one stamper on ``device`` under ``policy``,
    against ``budget`` sampled ΔL scenarios; then the winner's solo
    rebuild."""
    params = LogGPS()
    space, lower = explore.preset("codesign", P=P, iters=iters,
                                  params=params)
    scen = sample_grid(params, budget, rng=0, lat_deltas=(0.0, 100.0))
    objective = explore.robust_makespan(q=0.95)
    stamper = explore.Stamper(policy, device=device)
    results = {}
    for name in SEARCHERS:
        kw = {"population_size": population} if name == "evolution" else {}
        searcher = explore.make_searcher(name, space, seed=seed, **kw)
        results[name] = explore.run_search(
            searcher, lower, scen, generations=generations,
            population=population, objective=objective, stamper=stamper)
    best = min(results.values(), key=lambda r: r.best_objective)
    solo = explore.solo_objective(lower(best.best), scen, objective,
                                  policy=policy, device=device)
    return {"space": space, "lower": lower, "scenarios": scen,
            "objective": objective, "stamper": stamper,
            "results": results, "best": best, "solo": solo}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    out = flow(device=args.device)
    print(f"space: {' x '.join(out['space'].names)};  "
          f"budget {GENERATIONS} generations x {POPULATION} candidates; "
          f"50-scenario q95 objective\n")
    for name, res in out["results"].items():
        dispatches = sum(h["stamp"]["dispatches"] for h in res.history)
        print(f"{name:10s} best q95 makespan {res.best_objective:9.1f} us  "
              f"({res.n_evaluated} candidates in {dispatches} packed "
              f"dispatches)")
        print(f"{'':10s} best design: {res.best}")
    r = out["results"]
    gain = 1.0 - r["evolution"].best_objective / r["random"].best_objective
    print(f"\nevolution vs random at equal budget: {gain:+.1%}")
    print(f"solo rebuild of the winner: {out['solo']:.1f} us "
          f"(bit-identical: {out['solo'] == out['best'].best_objective})")
    print(f"stamper: {out['stamper'].stats}")
    return out


if __name__ == "__main__":
    main()
