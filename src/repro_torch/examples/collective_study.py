"""Collective-algorithm case study (paper §IV-1 / Fig 10) on jamba-398b,
on the port.

Swaps the allreduce expansion between recursive doubling, ring, tree and
bidirectional ring for the full training step of an assigned architecture
and reports λ_L, ρ_L and the 5% tolerance — the decision a deployment
engineer faces.  The study runs through the port's
:class:`~repro_torch.launch.analysis.AnalysisService`: each traced variant
registers once, its plan stays staged, and the ranking is one packed query
per shape bucket (a variant past the dense guard: one sparse forward).

    PYTHONPATH=src python -m repro_torch.examples.collective_study \\
        [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch import configs
from repro_torch.core.tracer import TraceSpec, trace_step
from repro_torch.examples._cli import parser
from repro_torch.launch.analysis import AnalysisRequest, AnalysisService
from repro_torch.models.config import TRAIN_4K

ARCH = "jamba-1.5-large-398b"
ALGOS = ("recursive_doubling", "ring", "tree", "bidir_ring")


def ask(svc: AnalysisService, **req) -> dict:
    """One request's payload; a failed request raises with its error."""
    resp = svc.handle(AnalysisRequest(**req))
    if not resp.ok:
        raise RuntimeError(f"{req['kind']} request failed: {resp.error}")
    return resp.payload


def flow(cfg=None, shape=TRAIN_4K, mesh=(2, 4, 8), algos=ALGOS,
         deltas=np.linspace(0.0, 50.0, 25), device=None,
         policy=None) -> dict:
    """The study of ``cfg`` (default: jamba's full config) traced at
    ``shape`` on a pods × data × model ``mesh``, one variant an allreduce
    algorithm, through a service on ``device`` under ``policy``: each
    variant's curve at ΔL 0 and 5 % ICI tolerance, then the ranking at the
    last of ``deltas`` (reduce "final")."""
    cfg = cfg if cfg is not None else configs.get(ARCH)[0]
    svc = AnalysisService(device=device, policy=policy)
    pods, data, model = mesh
    for algo in algos:
        ts = TraceSpec(pods=pods, data=data, model=model,
                       allreduce_algo=algo)
        svc.register_graph(algo, trace_step(cfg, shape, ts), ts.params())
    rows = {}
    for algo in algos:
        curve = ask(svc, kind="curve", variant=algo, deltas=[0.0])
        tol = ask(svc, kind="tolerance", variant=algo,
                  degradations=[0.05])["tolerance"][0.05]
        rows[algo] = (curve, tol)
    rank = ask(svc, kind="rank", deltas=np.asarray(deltas).tolist(),
               reduce="final")
    return {"cfg": cfg, "service": svc, "rows": rows, "rank": rank}


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--mesh", type=int, nargs=3, default=(2, 4, 8),
                    metavar=("PODS", "DATA", "MODEL"))
    ap.add_argument("--smoke", action="store_true",
                    help="jamba's SMOKE config (a quick check)")
    args = ap.parse_args(argv)
    out = flow(configs.get(ARCH)[1 if args.smoke else 0],
               mesh=tuple(args.mesh), device=args.device)
    print(f"arch: {out['cfg'].name}; shape: {TRAIN_4K.name}; mesh "
          f"{'×'.join(map(str, args.mesh))}\n")
    print(f"{'allreduce':22s} {'T/step':>10s} {'λ_ici':>8s} {'ρ_ici':>8s} "
          f"{'ICI +5% tol':>12s}")
    for algo, (curve, tol) in out["rows"].items():
        print(f"{algo:22s} {curve['T'][0] / 1e3:8.1f}ms "
              f"{curve['lam'][0]:8.0f} {100 * curve['rho'][0]:7.2f}% "
              f"{tol:10.2f}µs   ({curve['backend']})")
    rank = out["rank"]
    print(f"\nranking under +50µs ICI latency ({rank['compiled_calls']} "
          f"forward(s) for {len(rank['ranking'])} variants):")
    for name, obj in rank["ranking"]:
        print(f"  {name:22s} T={obj / 1e3:8.1f}ms")
    tols = {a: t for a, (_, t) in out["rows"].items()}
    ratio = tols["recursive_doubling"] / tols["ring"]
    print(f"\nrecursive-doubling tolerates {ratio:.1f}× more ICI latency than "
          f"ring (paper: ~4× for ICON @256 nodes)")
    return out


if __name__ == "__main__":
    main()
