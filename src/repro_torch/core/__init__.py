"""Host-side LLAMP core for the PyTorch package: execution graphs, LogGPS
costs, collective expansion and synthetic workloads (numpy), plus the
sensitivity entry points that run on the port's engine."""

from . import collectives, graph, loggps, sensitivity, synth  # noqa: F401
from .graph import ExecutionGraph, GraphBuilder  # noqa: F401
from .loggps import (LogGPS, NetClass, NetworkModel, cluster_params,  # noqa: F401
                     pod_model, resolve_class)
from .sensitivity import (bandwidth_curve, latency_curve,  # noqa: F401
                          latency_tolerance)
