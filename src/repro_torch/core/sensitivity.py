"""Sensitivity, latency curves, tolerance and critical latencies on the
PyTorch engine (paper §II-B, §II-D, Figs 1 & 9, Algorithm 2).

    report = analyze(graph, params)                    # T, λ_L, ρ_L
    curve  = latency_curve(graph, params, deltas)      # T, λ_L, ρ_L per ΔL
    tol    = latency_tolerance(graph, params)          # Fig 1 zones, 1/2/5 %
    bw     = bandwidth_curve(graph, params, gscales)   # T(γ·G)
    lcs    = critical_latencies(graph, params, lo, hi) # Algorithm 2
    rep    = resilience_curve(graph, params, faults)   # E[slowdown]

The counterparts of ``repro/core/sensitivity.py``'s functions of the same
names, on :class:`repro_torch.sweep.Engine` only: each call compiles the
graph, stages it on ``device`` (the CUDA card unless ``device="cpu"``) and
runs the forward ``policy`` selects (an ``ExecPolicy``; by default the
segment float64 forward, or sparse float64 past the dense-size guard: both
give the scalar engine's T and λ bit for bit).
There is no ``engine=`` dispatch and no scalar fallback: an engine error
reaches the caller.  The scalar engine is ``core.dag``, a host oracle that
callers ask for by name (``resilience_curve(engine="scalar")`` runs the
reference's host loop on it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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


@dataclasses.dataclass
class ResilienceReport:
    """Expected slowdown under a fault distribution (one batched query).

    ``T_fault``/``slowdown`` are aligned with ``faults``; ``weights`` are
    the per-fault probabilities (their shortfall from 1 is the no-fault
    mass at slowdown 1.0).  ``quantiles`` are weighted quantiles of the
    slowdown distribution; ``result`` is the full B?×K?×S sweep
    :class:`~repro_torch.sweep.api.Result` for drill-down (None from the
    host loop), with ``cells`` naming each fault's cell in it.
    """

    T0: float                          # intact-system makespan (µs)
    faults: list
    names: tuple
    weights: np.ndarray
    T_fault: np.ndarray                # per-fault makespan (µs)
    slowdown: np.ndarray               # T_fault / T0
    expected_slowdown: float
    quantiles: dict                    # {"p50": …, "p95": …, "p99": …}
    result: object
    cells: list

    def rank(self) -> list:
        """Faults ordered most-damaging first: (name, slowdown)."""
        order = np.argsort(-self.slowdown, kind="stable")
        return [(self.names[i], float(self.slowdown[i])) for i in order]

    def __str__(self):
        rows = [f"T0 = {self.T0:.3f} µs   "
                f"E[slowdown] = {self.expected_slowdown:.4f}"]
        for p, v in self.quantiles.items():
            rows.append(f"  {p} slowdown = {v:.4f}")
        for name, s in self.rank():
            rows.append(f"  {name}: ×{s:.4f}")
        return "\n".join(rows)


def _weighted_quantiles(values: np.ndarray, weights: np.ndarray,
                        qs: Sequence[float]) -> dict:
    """Weighted quantiles by inverted CDF (first value whose cumulative
    weight reaches q of the total)."""
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    cum = np.cumsum(w)
    total = cum[-1]
    out = {}
    for q in qs:
        i = int(np.searchsorted(cum, q * total, side="left"))
        out[f"p{int(round(q * 100))}"] = float(v[min(i, v.size - 1)])
    return out


def resilience_curve(g: ExecutionGraph, params: LogGPS, faults: Sequence,
                     weights: Optional[Sequence[float]] = None,
                     quantiles: Sequence[float] = (0.50, 0.95, 0.99),
                     engine: str = "auto", policy=None,
                     device: DeviceLike = None) -> ResilienceReport:
    """Expected slowdown under a fault distribution, as ONE batched query
    (reference ``repro/core/sensitivity.py:293-410``).

    ``faults`` is a list of :class:`~repro_torch.sweep.scenarios.
    StragglerFault` / :class:`~repro_torch.sweep.scenarios.LinkFault` /
    :class:`~repro_torch.sweep.scenarios.DeviceFault`; each family rides
    one engine batch axis (K / S / B), so the whole distribution — plus
    the intact baseline at cell (0, 0, 0) — evaluates in one
    ``Engine.run(Query(scenarios=, costs=, structure=))``, values only:
    one level-loop launch on ``device`` (the CUDA card unless
    ``device="cpu"``) under ``policy`` (segment float64 by default, or
    ``ExecPolicy("dense")``).

    ``weights`` are per-fault probabilities: nonnegative, summing to
    ≤ 1; the shortfall is the no-fault mass (slowdown 1.0).  ``None``
    means uniform over ``faults``.  The report carries E[slowdown] and
    weighted p50/p95/p99 over the distribution.

    ``engine="auto"`` or ``"sweep"`` runs the query; an engine error
    reaches the caller (the reference falls back to its host loop).
    ``engine="scalar"`` runs the reference's host loop on ``core.dag``,
    straggler and link faults only (a device fault raises).
    """
    if engine not in ("auto", "scalar", "sweep"):
        raise ValueError(f"engine must be 'auto', 'scalar' or 'sweep', "
                         f"got {engine!r}")
    faults = list(faults)
    if not faults:
        raise ValueError("resilience_curve needs at least one fault")
    if weights is None:
        w = np.full(len(faults), 1.0 / len(faults))
    else:
        w = np.asarray(weights, dtype=np.float64).ravel()
        if w.shape[0] != len(faults):
            raise ValueError(f"{len(faults)} faults but {w.shape[0]} weights")
        if (w < 0).any() or w.sum() > 1.0 + 1e-9:
            raise ValueError("weights must be nonnegative and sum to ≤ 1 "
                             "(the shortfall is the no-fault mass)")

    from repro_torch.sweep.scenarios import DeviceFault, fault_axes

    res = None
    if engine != "scalar":
        from repro_torch.sweep.api import Query
        eng = _engine(g, params, device, policy)
        ax = fault_axes(g, params, faults, plan=eng.plan)
        res = eng.run(Query(scenarios=ax.scenarios, costs=ax.extras,
                            structure=ax.structure, outputs=("T",)))

        def cell_T(b, k, s):
            idx = []
            if "B" in res.axes:
                idx.append(b)
            if "K" in res.axes:
                idx.append(k)
            idx.append(s)
            return float(res.T[tuple(idx)])

        T0 = cell_T(0, 0, 0)
        T_fault = np.asarray([cell_T(*c) for c in ax.cells])
    else:                              # the host loop: K/S families only
        if any(isinstance(f, DeviceFault) for f in faults):
            raise ValueError(
                "device faults need the batched sweep engine (structural "
                "B axis) — the scalar path cannot evaluate them")
        from . import dag
        ax = fault_axes(g, params, faults)
        plan = dag.LevelPlan(g)
        T0 = plan.forward(params).T
        T_fault = np.empty(len(faults))
        for i, (b, k, s) in enumerate(ax.cells):
            extra = None if ax.extras is None or k == 0 else ax.extras[k]
            p = params.replace(L=tuple(ax.scenarios.L[s]))
            gs = ax.scenarios.gscale[s]
            if (gs != 1.0).any():
                egap, egclass = edge_gap_shares(g, p)
                gextra = egap * (gs[egclass] - 1.0)
                extra = gextra if extra is None else extra + gextra
            T_fault[i] = plan.forward(p, extra_edge_cost=extra).T

    slow = T_fault / T0
    vals = np.concatenate([[1.0], slow])
    ws = np.concatenate([[max(0.0, 1.0 - w.sum())], w])
    return ResilienceReport(
        T0=T0, faults=faults, names=ax.names, weights=w, T_fault=T_fault,
        slowdown=slow,
        expected_slowdown=float((vals * ws).sum() / ws.sum()),
        quantiles=_weighted_quantiles(vals, ws, quantiles),
        result=res, cells=list(ax.cells))
