"""Host-side LLAMP core for the PyTorch package: execution graphs, LogGPS
costs, collective expansion and synthetic workloads (numpy), the scalar
engine ``dag`` and the event simulator ``simulator`` (host oracles), the
explicit LP (``lp``) with its interior-point solver on the card (``ipm``),
and the sensitivity entry points that run on the port's engine."""

from . import (collectives, dag, graph, ipm, loggps, lp,  # noqa: F401
               sensitivity, simulator, synth)
from .graph import ExecutionGraph, GraphBuilder  # noqa: F401
from .loggps import (LogGPS, NetClass, NetworkModel, cluster_params,  # noqa: F401
                     pod_model, resolve_class)
from .lp import build_lp, predict_runtime, tolerance_lp  # noqa: F401
from .sensitivity import (analyze, bandwidth_curve,  # noqa: F401
                          critical_latencies, latency_curve,
                          latency_tolerance)
