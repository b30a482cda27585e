"""Parametric longest-path engine — the exact solver behind LLAMP's LP.

Algorithm 1 of the paper converts an execution graph into difference
constraints ``y_v ≥ y_u + cost(u,v)`` — an LP whose matrix is a node-arc
incidence matrix and therefore **totally unimodular**: the LP optimum equals
the longest-path (makespan) value, and the LP's dual / reduced-cost
information coincides with critical-path combinatorics.  This module
computes all of the paper's §II-D metrics *exactly* in O(V+E) passes:

  evaluate(graph, params)      → T, λ (per-class reduced costs of ℓ), ρ
  critical_edges(...)          → tight constraints (critical DAG)
  breakpoints(...)             → critical latencies L_c (Algorithm 2 output)
  tolerance(...)               → p% latency tolerance (the maximize-ℓ LP)
  pairwise_counts(...)         → D_L / D_G matrices for placement (Appendix I)

Equality with the explicit-LP path (``lp.py`` + HiGHS / our IPM) is asserted
in tests; on the paper's workloads this engine is the fast path (§Perf).

This is a copy of the JAX package's ``repro/core/dag.py`` (numpy only): the
PyTorch package imports nothing from ``repro``.  It is a host oracle that
callers ask for by name; no device entry point reaches it.  One departure,
in speed only: ``LevelPlan.forward`` finds each level's vertices from a
precomputed order instead of an O(nv) mask a level, and resets only the
level's own slope bests, so a forward is O(nv + ne) plus a constant a
level (bit-identical results; the traced steps have 10^5-10^6 vertices
over 10^4 levels).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .graph import ExecutionGraph, _ragged_arange
from .loggps import LogGPS, edge_costs


@dataclasses.dataclass
class Schedule:
    """Result of one forward evaluation at a fixed parameter point."""

    T: float                    # makespan (µs)
    lam: np.ndarray             # (nclass,) λ per latency class = ∂T/∂L_c
    t_start: np.ndarray         # (nv,) start times
    t_end: np.ndarray           # (nv,) end times
    slope: np.ndarray           # (nv, nclass) per-vertex critical slope
    params: LogGPS
    extra_edge_cost: Optional[np.ndarray] = None   # original edge order

    @property
    def lam_total(self) -> float:
        return float(self.lam.sum())

    def rho(self) -> np.ndarray:
        """ρ_L per class: fraction of the critical path due to latency."""
        L = np.asarray(self.params.L)
        return np.where(self.T > 0, (L * self.lam) / self.T, 0.0)


class LevelPlan:
    """Precomputed level schedule: edges grouped by destination level.

    Reused across evaluations (parameter sweeps, breakpoint searches) — this
    is the LLAMP analog of Gurobi re-solving from a warm basis.
    """

    def __init__(self, g: ExecutionGraph):
        self.g = g
        lvl_of_edge = g.level[g.edst]
        order = np.lexsort((g.edst, lvl_of_edge))
        self.eorder = order.astype(np.int64)
        self.esrc = g.esrc[order]
        self.edst = g.edst[order]
        self.elat = g.elat[order]
        self.econst = g.econst[order]
        lvls = lvl_of_edge[order]
        # edge range per level
        self.level_ptr = np.searchsorted(lvls, np.arange(g.nlevels + 1))
        # vertices per level (for completeness; starts computed via scatter-max)
        self.vlevel = g.level
        # level lv's vertices in increasing id: vorder[vptr[lv]:vptr[lv+1]]
        # (what np.nonzero(vlevel == lv) gives, without an O(nv) pass a level)
        self.vorder = np.argsort(g.level, kind="stable")
        self.vptr = np.searchsorted(g.level[self.vorder],
                                    np.arange(max(g.nlevels, 1) + 1))

    def forward(self, params: LogGPS, extra_edge_cost: Optional[np.ndarray] = None,
                tie_break_slopes: bool = True) -> Schedule:
        g = self.g
        nv, nc = g.num_vertices, g.nclass
        Lvec = np.asarray(params.L, dtype=np.float64)
        w = self.econst + self.elat.astype(np.float64) @ Lvec
        if extra_edge_cost is not None:
            w = w + extra_edge_cost[self.eorder]

        t_start = np.zeros(nv, dtype=np.float64)
        slope = np.zeros((nv, nc), dtype=np.float64)
        # "which in-edge realized the max" for slope propagation
        argmax_edge = np.full(nv, -1, dtype=np.int64)

        t_end = np.empty(nv, dtype=np.float64)
        midx = self.vorder[self.vptr[0]:self.vptr[1]]
        t_end[midx] = g.vcost[midx]
        # the slope bests of a level: only its own destinations are read,
        # and they are reset to -inf before each level's scatter-max
        best = np.full(nv, -np.inf)

        for lv in range(1, g.nlevels):
            a, b = self.level_ptr[lv], self.level_ptr[lv + 1]
            midx = self.vorder[self.vptr[lv]:self.vptr[lv + 1]]
            if a == b:
                # level with only source vertices (possible for isolated nodes)
                t_end[midx] = g.vcost[midx]
                continue
            src = self.esrc[a:b]
            dst = self.edst[a:b]
            cand = t_end[src] + w[a:b]
            # scatter-max into t_start
            np.maximum.at(t_start, dst, cand)
            # identify realizing edges (first pass: value match)
            hit = cand >= t_start[dst] - 1e-12
            if tie_break_slopes and nc > 0:
                # among value-ties prefer the larger total slope (right-derivative
                # of T at the evaluation point — matches the paper's "keep the
                # path with larger a_i" rule for λ reporting)
                cand_slope = slope[src].sum(axis=1) + self.elat[a:b].sum(axis=1)
                best[dst] = -np.inf
                idx = np.nonzero(hit)[0]
                np.maximum.at(best, dst[idx], cand_slope[idx])
                sel = hit & (cand_slope >= best[dst] - 1e-12)
            else:
                sel = hit
            eidx = np.nonzero(sel)[0]
            # later writes win; any realizing edge is a valid subgradient choice
            argmax_edge[dst[eidx]] = a + eidx
            chosen = argmax_edge[midx]
            has = chosen >= 0
            mh = midx[has]
            slope[mh] = slope[self.esrc[chosen[has]]] + self.elat[chosen[has]]
            t_end[midx] = t_start[midx] + g.vcost[midx]

        T = float(t_end.max(initial=0.0))
        sinks = np.nonzero(t_end >= T - 1e-12)[0]
        if sinks.size:
            ssl = slope[sinks].sum(axis=1)
            lam = slope[sinks[np.argmax(ssl)]].copy()
        else:
            lam = np.zeros(nc)
        return Schedule(T=T, lam=lam, t_start=t_start, t_end=t_end,
                        slope=slope, params=params,
                        extra_edge_cost=extra_edge_cost)

    def forward_multi(self, params: LogGPS, deltas, cls: int = 0) -> np.ndarray:
        """T(L₀+δ) for K deltas in ONE topological pass.

        The K sweep points ride a trailing vector axis (the same batching
        the maxplus Pallas kernel puts on TPU lanes), so a latency sweep
        costs ~1 forward instead of K — this is what lets LLAMP beat the
        DES on parameter sweeps even for small graphs (§Perf iteration 1).
        Returns Ts: [K].
        """
        g = self.g
        nv = g.num_vertices
        dvec = np.asarray(deltas, dtype=np.float64)
        K = dvec.shape[0]
        Lvec = np.asarray(params.L, dtype=np.float64)
        w0 = self.econst + self.elat.astype(np.float64) @ Lvec    # [ne]
        w = w0[:, None] + self.elat[:, cls].astype(np.float64)[:, None] * dvec

        t_start = np.zeros((nv, K))
        t_end = np.empty((nv, K))
        lvl0 = self.vlevel == 0
        t_end[lvl0] = g.vcost[lvl0, None]
        for lv in range(1, g.nlevels):
            a, b = self.level_ptr[lv], self.level_ptr[lv + 1]
            mask = self.vlevel == lv
            if a != b:
                src = self.esrc[a:b]
                dst = self.edst[a:b]
                cand = t_end[src] + w[a:b]
                np.maximum.at(t_start, dst, cand)
            t_end[mask] = t_start[mask] + g.vcost[mask, None]
        return t_end.max(axis=0)

    # -- critical DAG (tight constraints / reduced-cost support) -------------
    def critical_edges(self, sched: Schedule, atol: float = 1e-9) -> np.ndarray:
        """Boolean mask (in *original* edge order) of tight constraints.

        Edge (u,v) is tight iff it lies on some longest path:
        t_end[u] + w(u,v) == t_start[v]  AND  v is itself critical.
        Criticality propagates backward from the makespan sinks.
        """
        g = self.g
        Lvec = np.asarray(sched.params.L, dtype=np.float64)
        w = self.econst + self.elat.astype(np.float64) @ Lvec
        if sched.extra_edge_cost is not None:
            w = w + sched.extra_edge_cost[self.eorder]
        tight_local = sched.t_end[self.esrc] + w >= sched.t_start[self.edst] - atol
        crit_v = np.zeros(g.num_vertices, dtype=bool)
        crit_v[sched.t_end >= sched.T - atol] = True
        # walk levels backward
        for lv in range(g.nlevels - 1, 0, -1):
            a, b = self.level_ptr[lv], self.level_ptr[lv + 1]
            if a == b:
                continue
            sel = tight_local[a:b] & crit_v[self.edst[a:b]]
            crit_v[self.esrc[a:b][sel]] = True
        crit_e_sorted = tight_local & crit_v[self.edst]
        out = np.zeros(g.num_edges, dtype=bool)
        out[self.eorder] = crit_e_sorted
        return out

    def pairwise_counts(self, sched: Schedule) -> tuple[np.ndarray, np.ndarray]:
        """(D_L, D_G): per rank-pair critical message counts and bytes.

        Appendix I: reduced costs of ℓ_ij / g_ij.  Counts every message edge
        on the critical DAG (all tight constraints) — with degenerate optima
        this is the union of optimal paths, which is the useful signal for
        the placement heuristic (a single path would hide parallel critical
        chains).
        """
        g = self.g
        P = g.nranks
        D_L = np.zeros((P, P))
        D_G = np.zeros((P, P))
        crit = self.critical_edges(sched)
        eids = np.nonzero(crit & (g.ebytes > 0))[0]
        src_r = g.vrank[g.esrc[eids]]
        dst_r = g.vrank[g.edst[eids]]
        np.add.at(D_L, (src_r, dst_r), 1.0)
        np.add.at(D_G, (src_r, dst_r), g.ebytes[eids])
        # symmetrize (paper assumes symmetric L_ij)
        return D_L + D_L.T, D_G + D_G.T

    def _trace_one_path(self, sched: Schedule, atol: float = 1e-9) -> list:
        g = self.g
        Lvec = np.asarray(sched.params.L, dtype=np.float64)
        w_sorted = self.econst + self.elat.astype(np.float64) @ Lvec
        if sched.extra_edge_cost is not None:
            w_sorted = w_sorted + sched.extra_edge_cost[self.eorder]
        w = np.empty_like(w_sorted)
        w[self.eorder] = w_sorted
        v = int(np.argmax(sched.t_end))
        path = []
        while True:
            a, b = g.in_ptr[v], g.in_ptr[v + 1]
            if a == b:
                break
            eids = g.in_edge[a:b]
            vals = sched.t_end[g.esrc[eids]] + w[eids]
            ok = np.nonzero(vals >= sched.t_start[v] - atol)[0]
            if ok.size == 0:
                break
            # prefer max-slope predecessor (consistent with forward tie-break)
            cands = eids[ok]
            sl = sched.slope[g.esrc[cands]].sum(axis=1) + g.elat[cands].sum(axis=1)
            e = int(cands[np.argmax(sl)])
            path.append(e)
            v = int(g.esrc[e])
        return path[::-1]


# -- public API ---------------------------------------------------------------

def evaluate(graph: ExecutionGraph, params: LogGPS,
             plan: Optional[LevelPlan] = None) -> Schedule:
    plan = plan or LevelPlan(graph)
    return plan.forward(params)


def runtime_curve(graph: ExecutionGraph, params: LogGPS, deltas, cls: int = 0,
                  plan: Optional[LevelPlan] = None):
    """T(ΔL) and λ(ΔL) for a sweep of latency deltas on one class."""
    plan = plan or LevelPlan(graph)
    Ts, lams = [], []
    for d in deltas:
        s = plan.forward(params.with_delta(float(d), cls))
        Ts.append(s.T)
        lams.append(float(s.lam[cls]))
    return np.asarray(Ts), np.asarray(lams)


def breakpoints(graph: ExecutionGraph, params: LogGPS, L_min: float, L_max: float,
                cls: int = 0, plan: Optional[LevelPlan] = None,
                tol: float = 1e-9, max_bp: int = 10_000) -> list:
    """Critical latencies (Algorithm 2): kinks of the convex pw-linear T(L).

    Exact recursive bisection on the convex hull: the lines at the interval
    ends either coincide in slope (no kink inside) or intersect at x*; if
    T(x*) lies on those lines the unique kink is x*, otherwise recurse.
    Each probe is one O(V+E) forward pass — the analog of one warm-started
    LP re-solve in the paper.
    """
    plan = plan or LevelPlan(graph)
    base_L = params.L[cls]

    def probe(Lval: float):
        s = plan.forward(params.replace(L=tuple(
            Lval if i == cls else x for i, x in enumerate(params.L))))
        return s.T, float(s.lam[cls])

    out: list = []

    def rec(a, ya, sa, b, yb, sb, depth=0):
        if len(out) >= max_bp or depth > 80:
            return
        if abs(sa - sb) <= tol:
            return
        # intersection of the two supporting lines
        x = (yb - sb * b - (ya - sa * a)) / (sa - sb)
        x = min(max(x, a + tol), b - tol)
        yx, sx = probe(x)
        line = ya + sa * (x - a)
        if yx <= line + max(1e-7, 1e-9 * abs(line)):
            out.append(x)
            return
        rec(a, ya, sa, x, yx, sx, depth + 1)
        rec(x, yx, sx, b, yb, sb, depth + 1)

    ya, sa = probe(L_min)
    yb, sb = probe(L_max)
    rec(L_min, ya, sa, L_max, yb, sb)
    return sorted(out)


def tolerance(graph: ExecutionGraph, params: LogGPS, degradation: float = 0.0,
              cls: int = 0, plan: Optional[LevelPlan] = None,
              L_hi: float = 1e7, tol: float = 1e-6,
              budget: Optional[float] = None) -> float:
    """p% latency tolerance: max L with T(L) ≤ (1+p)·T(L₀)  (§II-D2).

    This is the paper's flipped LP (maximize ℓ s.t. t ≤ T_max).  T(L) is
    convex piecewise-linear and nondecreasing in L, so the solution is the
    unique crossing — found by bisection + one exact linear solve on the
    active segment (the same answer the max-ℓ LP returns).
    Returns ΔL tolerance relative to the base L (as plotted in Fig 1), i.e.
    (L* − L₀).  Returns np.inf if T never exceeds the budget.
    """
    plan = plan or LevelPlan(graph)
    L0 = params.L[cls]

    def probe(Lval: float):
        s = plan.forward(params.replace(L=tuple(
            Lval if i == cls else x for i, x in enumerate(params.L))))
        return s.T, float(s.lam[cls])

    T0, _ = probe(L0)
    if budget is None:
        budget = (1.0 + degradation) * T0
    Thi, lhi = probe(L_hi)
    if Thi <= budget:
        return np.inf
    a, b = L0, L_hi
    Ta, la = T0, None
    for _ in range(200):
        Tb, lb = probe(b)
        # exact solve on b's supporting line: budget = Tb + lb (x - b)
        if lb > 0:
            x = b + (budget - Tb) / lb
        else:
            x = (a + b) / 2
        x = min(max(x, a), b)
        Tx, lx = probe(x)
        if abs(Tx - budget) <= tol * max(1.0, budget):
            return x - L0
        if Tx > budget:
            b = x
        else:
            a = x
        if b - a < tol:
            break
    return a - L0


def l_ratio(sched: Schedule) -> float:
    """ρ_L summed over classes: fraction of critical path spent in latency."""
    return float(sched.rho().sum())
