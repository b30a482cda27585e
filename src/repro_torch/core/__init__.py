"""Host-side LLAMP core for the PyTorch package: execution graphs, LogGPS
costs, collective expansion, network topologies, the step tracer of the
model stack's train and decode steps and synthetic workloads (numpy), the
scalar engine ``dag`` and the event simulator ``simulator`` (host
oracles), the explicit LP (``lp``) with its interior-point solver on the
card (``ipm``), and the entry points that run on the port's engine: the
sensitivity and resilience studies and Algorithm 3's placement search."""

from . import (collectives, dag, graph, ipm, loggps, lp,  # noqa: F401
               placement, rng, sensitivity, simulator, synth, topology,
               tracer)
from .graph import ExecutionGraph, GraphBuilder  # noqa: F401
from .loggps import (LogGPS, NetClass, NetworkModel, cluster_params,  # noqa: F401
                     pod_model, resolve_class)
from .lp import build_lp, predict_runtime, tolerance_lp  # noqa: F401
from .rng import as_rng  # noqa: F401
from .placement import ArchTopology, place  # noqa: F401
from .sensitivity import (ResilienceReport, analyze,  # noqa: F401
                          bandwidth_curve, critical_latencies,
                          latency_curve, latency_tolerance,
                          resilience_curve)
from .topology import (Topology, TopologyStamper, dragonfly,  # noqa: F401
                       fat_tree, multipod_torus, topology_params, torus)
from .tracer import (TraceSpec, trace_decode_step, trace_step,  # noqa: F401
                     trace_train_step)
