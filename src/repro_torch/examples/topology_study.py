"""Topology case study (paper §IV-2 / Fig 11) on the port.

How much *per-wire* latency (e.g. future FEC adding +100 ns/link) can a
workload absorb on Fat Tree vs Dragonfly vs a torus — with wire latency as
the decision variable (Appendix H)?  Topology variants change the graph
itself (each message expands through a different wire-class stamper), so
they register with the port's
:class:`~repro_torch.launch.analysis.AnalysisService` as separate
variants; the service keeps one staged plan per topology and answers the
wire-latency questions (base point, 1% tolerance, degradation ranking).

    PYTHONPATH=src python -m repro_torch.examples.topology_study \\
        [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import topology
from repro_torch.core.graph import GraphBuilder
from repro_torch.examples._cli import parser
from repro_torch.examples.collective_study import ask
from repro_torch.launch.analysis import AnalysisService


def workload(topo, params, nranks=256, iters=3, nbytes=4e5,
             comp_us=2_000.0):
    """``iters`` rounds of compute, then recursive-doubling exchanges of
    ``nbytes`` over ``nranks`` ranks, each message stamped with the
    topology's wire classes."""
    stamp = topology.TopologyStamper(topo, params)
    b = GraphBuilder(nranks, topo.nclasses)
    for _ in range(iters):
        for r in range(nranks):
            b.add_calc(r, comp_us)
        for k in range(8):                  # recursive-doubling exchanges
            for r in range(nranks):
                peer = r ^ (1 << k)
                if r < peer < nranks:
                    stamp.message(b, r, peer, nbytes)
                    stamp.message(b, peer, r, nbytes)
    return b.finalize()


def topologies() -> list:
    """The study's three fabrics of 256 hosts each."""
    return [("fat_tree(k=16)", topology.fat_tree(16)),
            ("dragonfly(8,4,8)", topology.dragonfly(8, 4, 8)),
            ("torus(16x16) ICI", topology.torus((16, 16)))]


def flow(topos=None, nranks: int = 256, iters: int = 3,
         deltas=np.linspace(0.0, 0.5, 11), device=None,
         policy=None) -> dict:
    """Each of ``topos`` ([(name, Topology)], default :func:`topologies`)
    registered with its :func:`workload` through a service on ``device``
    under ``policy``: the curve at ΔL 0 and the 1 % tolerance on wire class
    0, then the ranking by T at the last of ``deltas`` a wire."""
    topos = topologies() if topos is None else topos
    svc = AnalysisService(device=device, policy=policy)
    for name, topo in topos:
        p = topology.topology_params(topo, l_wire_us=0.274, d_switch_us=0.108)
        svc.register_graph(name, workload(topo, p, nranks, iters), p,
                           topology=topo.name)
    rows = {}
    for name, _ in topos:
        curve = ask(svc, kind="curve", variant=name, deltas=[0.0])
        tol = ask(svc, kind="tolerance", variant=name,
                  degradations=[0.01])["tolerance"][0.01]
        rows[name] = (curve, tol)
    rank = ask(svc, kind="rank", deltas=np.asarray(deltas).tolist(),
               reduce="final")
    return {"service": svc, "rows": rows, "rank": rank}


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--ranks", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    out = flow(nranks=args.ranks, iters=args.iters, device=args.device)
    print(f"wire-latency tolerance, {args.ranks} ranks, allreduce-heavy "
          "step")
    print(f"{'topology':22s} {'T(µs)':>10s} {'λ_wire':>8s} "
          f"{'wire +1% (ns)':>14s} {'verdict on +100ns FEC':>24s}")
    for name, (curve, tol) in out["rows"].items():
        verdict = "absorbed" if tol * 1e3 > 100 else "1% SLOWDOWN"
        print(f"{name:22s} {curve['T'][0]:10.0f} {curve['lam'][0]:8.0f} "
              f"{tol * 1e3:14.0f} {verdict:>24s}")
    rank = out["rank"]
    print(f"\nfastest fabric at +0.5µs/wire ({rank['compiled_calls']} "
          "forward(s)):")
    for name, obj in rank["ranking"]:
        print(f"  {name:22s} T={obj:10.0f}µs")
    print("\n(paper found ICON needs >3000 ns/wire before 1% degradation —")
    print(" the same conclusion falls out here for compute-heavy steps.)")
    return out


if __name__ == "__main__":
    main()
