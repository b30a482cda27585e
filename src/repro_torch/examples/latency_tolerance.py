"""Latency tolerance of the model stack's training steps, on the port.

How much extra DCN latency can each architecture's training step absorb
before stepping 1%/2%/5% slower? — answered from the traced step graph:
T and λ from ``core.dag``, the tolerances from the batched bisection on
the port's engine.

    PYTHONPATH=src python -m repro_torch.examples.latency_tolerance \\
        [--pods 2] [--device cpu]
"""

from __future__ import annotations

from repro_torch import configs
from repro_torch.core import dag, sensitivity
from repro_torch.core.tracer import TraceSpec, trace_step
from repro_torch.examples._cli import parser
from repro_torch.models.config import TRAIN_4K

ARCHS = ("jamba-1.5-large-398b", "deepseek-v2-lite-16b", "grok-1-314b",
         "rwkv6-7b", "yi-6b", "llama3.2-3b")
DEGRADATIONS = (0.01, 0.02, 0.05)


def flow(archs=ARCHS, pods: int = 2, data: int = 4, model: int = 8,
         shape=TRAIN_4K, smoke: bool = False, device=None) -> dict:
    """{arch: (graph, core.dag schedule, {p: DCN tolerance µs})} of each
    arch's ``shape`` step traced on a pods × data × model mesh (the
    config's SMOKE size with ``smoke``), and the params."""
    ts = TraceSpec(pods=pods, data=data, model=model, mfu=0.5)
    p = ts.params()
    rows = {}
    for arch in archs:
        cfg = configs.get(arch)[1 if smoke else 0]
        g = trace_step(cfg, shape, ts)
        s = dag.LevelPlan(g).forward(p)
        tol = sensitivity.latency_tolerance(g, p, DEGRADATIONS, cls=1,
                                            device=device)
        rows[arch] = (g, s, tol)
    return {"params": p, "rows": rows}


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=8)
    ap.add_argument("--archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' SMOKE sizes (a quick check)")
    args = ap.parse_args(argv)
    out = flow(args.archs, args.pods, args.data, args.model,
               smoke=args.smoke, device=args.device)
    p = out["params"]
    print(f"mesh: {args.pods}×{args.data}×{args.model} (pod×data×model); "
          f"L_ici={p.L[0]}µs L_dcn={p.L[1]}µs\n")
    print(f"{'arch':26s} {'T/step':>10s} {'λ_ici':>7s} {'λ_dcn':>7s} "
          f"{'DCN +1%':>10s} {'DCN +2%':>10s} {'DCN +5%':>10s}")
    for arch, (_, s, tol) in out["rows"].items():
        print(f"{arch:26s} {s.T / 1e3:8.1f}ms {s.lam[0]:7.0f} {s.lam[1]:7.0f} "
              f"{tol[0.01]:8.1f}µs {tol[0.02]:8.1f}µs {tol[0.05]:8.1f}µs")
    print("\nreading: λ = messages on the critical path per fabric; the µs "
          "columns are the Fig-1-style green/orange/red zone edges for DCN "
          "latency injection.")
    return out


if __name__ == "__main__":
    main()
