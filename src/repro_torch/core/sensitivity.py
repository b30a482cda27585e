"""Sensitivity, latency curves, tolerance and critical latencies on the
PyTorch engine (paper §II-B, §II-D, Figs 1 & 9, Algorithm 2).

    report = analyze(graph, params)                    # T, λ_L, ρ_L
    curve  = latency_curve(graph, params, deltas)      # T, λ_L, ρ_L per ΔL
    tol    = latency_tolerance(graph, params)          # Fig 1 zones, 1/2/5 %
    bw     = bandwidth_curve(graph, params, gscales)   # T(γ·G)
    lcs    = critical_latencies(graph, params, lo, hi) # Algorithm 2

The counterparts of ``repro/core/sensitivity.py``'s functions of the same
names, on :class:`repro_torch.sweep.Engine` only: each call compiles the
graph, stages it on ``device`` (the CUDA card unless ``device="cpu"``) and
runs the forward ``policy`` selects (an ``ExecPolicy``; by default the
segment float64 forward, or sparse float64 past the dense-size guard: both
give the scalar engine's T and λ bit for bit).
There is no ``engine=`` dispatch and no scalar fallback: an engine error
reaches the caller.  The scalar engine is ``core.dag``, a host oracle that
callers ask for by name.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.device import DeviceLike

from .graph import ExecutionGraph, edge_gap_shares
from .loggps import LogGPS, resolve_class


@dataclasses.dataclass
class SensitivityReport:
    T: float                     # predicted runtime (µs)
    lam: np.ndarray              # λ per latency class (messages on critical path)
    rho: np.ndarray              # ρ per class (latency share of critical path)
    params: LogGPS

    def __str__(self):
        rows = [f"T = {self.T:.3f} µs"]
        for c, name in enumerate(self.params.class_names):
            rows.append(f"  λ_L[{name}] = {self.lam[c]:.1f}   "
                        f"ρ_L[{name}] = {100 * self.rho[c]:.2f}%")
        return "\n".join(rows)


@dataclasses.dataclass
class LatencyCurve:
    deltas: np.ndarray
    T: np.ndarray
    lam: np.ndarray
    rho: np.ndarray

    def rrmse_vs(self, measured: np.ndarray) -> float:
        """Relative RMSE (paper Fig 9 / Table II metric)."""
        m = np.asarray(measured, dtype=np.float64)
        return float(np.sqrt(np.mean((self.T - m) ** 2)) / np.mean(m))


def _engine(g: ExecutionGraph, params: LogGPS, device: DeviceLike, policy):
    from repro_torch.sweep.api import Engine
    return Engine(g, params=params, policy=policy, device=device)


def analyze(g: ExecutionGraph, params: LogGPS, device: DeviceLike = None,
            policy=None) -> SensitivityReport:
    """T, λ and ρ at the base point ``params``: one scenario through the
    engine on ``device``."""
    from repro_torch.sweep.scenarios import base_batch
    res = _engine(g, params, device, policy).run(base_batch(params))
    return SensitivityReport(T=float(res.T[0]), lam=res.lam[0].copy(),
                             rho=res.rho[0].copy(), params=params)


def latency_curve(g: ExecutionGraph, params: LogGPS, deltas: Sequence[float],
                  cls=0, device: DeviceLike = None,
                  policy=None) -> LatencyCurve:
    """ΔL curve on latency class ``cls`` (an index or a registered class
    name): T, λ_cls and ρ_cls per ΔL, in one batched forward."""
    from repro_torch.sweep.scenarios import latency_grid
    cls = resolve_class(params, cls)
    deltas = np.asarray(deltas, dtype=np.float64)
    res = _engine(g, params, device, policy).run(
        latency_grid(params, deltas, cls=cls))
    return LatencyCurve(deltas=deltas, T=res.T, lam=res.lam[:, cls],
                        rho=res.rho[:, cls])


def latency_tolerance(g: ExecutionGraph, params: LogGPS,
                      degradations: Sequence[float] = (0.01, 0.02, 0.05),
                      cls=0, device: DeviceLike = None, policy=None) -> dict:
    """The Fig 1 zones: the ΔL on class ``cls`` tolerable before each p %
    degradation of T, all levels bisected in lockstep (one batched forward
    per probe round)."""
    from repro_torch.sweep.engine import tolerance_batched
    cls = resolve_class(params, cls)
    return tolerance_batched(_engine(g, params, device, policy), params,
                             list(degradations), cls=cls)


def bandwidth_curve(g: ExecutionGraph, params: LogGPS,
                    gscales: Sequence[float], cls=0,
                    device: DeviceLike = None, policy=None) -> LatencyCurve:
    """T(γ·G) over bandwidth scales γ on class ``cls`` (γ > 1 = slower
    links).  Raises ``ValueError`` if a resolved gap share is non-finite,
    which would poison the whole curve."""
    from repro_torch.sweep.scenarios import bandwidth_grid
    cls = resolve_class(params, cls)
    egap, _ = edge_gap_shares(g, params)
    bad = ~np.isfinite(egap)
    if bad.any():
        raise ValueError(
            f"bandwidth_curve: {int(bad.sum())}/{egap.size} edge gap "
            "share(s) resolved non-finite; check g.egap for NaN/inf entries "
            "and params.G for non-finite values")
    gs = np.asarray(gscales, dtype=np.float64)
    res = _engine(g, params, device, policy).run(
        bandwidth_grid(params, gs, cls=cls))
    return LatencyCurve(deltas=gs, T=res.T, lam=res.lam[:, cls],
                        rho=res.rho[:, cls])


def critical_latencies(g: ExecutionGraph, params: LogGPS, L_min: float,
                       L_max: float, cls=0, device: DeviceLike = None,
                       policy=None) -> list:
    """Algorithm 2's kink search on class ``cls`` (index or registered
    name) over [L_min, L_max]: every frontier interval of a round probed in
    one batched forward (``sweep.engine.breakpoints_batched``).  On the
    float64 backends (segment, the default, and sparse float64) the kinks
    equal ``core.dag.breakpoints``'s."""
    from repro_torch.sweep.engine import breakpoints_batched
    cls = resolve_class(params, cls)
    return breakpoints_batched(_engine(g, params, device, policy), params,
                               L_min, L_max, cls=cls)
