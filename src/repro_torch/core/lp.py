"""Algorithm 1: execution graph → explicit linear program.

Variables:  x = [ℓ_0..ℓ_{C-1},  t_1..t_nv,  T]
  ℓ_c  — latency decision variable per link class (paper's ℓ), bound ℓ_c ≥ L_c
  t_v  — start time of vertex v
  T    — makespan (the objective)

Constraints (all "≥", flipped to "≤" for solver form):
  t_v ≥ t_u + vcost[u] + econst[e] + Σ_c elat[e,c]·ℓ_c      for every edge e=(u,v)
  T   ≥ t_v + vcost[v]                                       for every sink v
  t_v ≥ 0, ℓ_c ≥ L_c

min T reproduces the paper's runtime LP; `tolerance_lp` flips it into the
maximize-ℓ form of §II-D2.  Reduced costs of ℓ_c come from the lower-bound
marginals and equal λ_L (§II-D1).

The port of the JAX package's ``repro/core/lp.py``: ``build_lp`` builds the
same ``A``, ``b``, ``c``, ``lb`` and ``ub`` (scipy CSR, host-side structure,
as plans stay numpy).  Two solvers:

    solver="ipm"    — :func:`repro_torch.core.ipm.solve_ipm`, the Mehrotra
                      interior-point method in PyTorch, its Newton solves
                      on ``device`` (the CUDA card unless ``device="cpu"``).
                      The default.
    solver="highs"  — scipy's HiGHS on the host: the caller's explicit ask
                      for the CPU.  ``device`` does not apply to it.

The reference defaults to HiGHS; the port's entry points run on the card
unless the caller asks for the CPU, so its default is the card's IPM.  Its
Newton solve is dense (8·n² bytes for n columns) up to
``ipm.MAX_NEWTON_BYTES`` (about 40,000 columns) and sparse past it (PCG
with a tree preconditioner, O(nnz) memory); on the stencils ``PERF.md``
records, both are slower end to end than HiGHS on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp

from repro_torch.device import DeviceLike

from .graph import ExecutionGraph
from .loggps import LogGPS

SOLVERS = ("ipm", "highs")


@dataclasses.dataclass
class LPProblem:
    """min c·x  s.t.  A x ≤ b,  lb ≤ x ≤ ub  (ub may be +inf)."""

    A: sp.csr_matrix
    b: np.ndarray
    c: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    nclass: int
    nv: int

    @property
    def nvars(self) -> int:
        return self.c.shape[0]

    def idx_ell(self, cls: int) -> int:
        return cls

    @property
    def idx_T(self) -> int:
        return self.nvars - 1


def build_lp(g: ExecutionGraph, params: LogGPS,
             objective: str = "makespan",
             max_cls: Optional[int] = None,
             T_budget: Optional[float] = None) -> LPProblem:
    """Build the LP of Algorithm 1.

    objective="makespan": min T with ℓ_c ≥ L_c (runtime prediction).
    objective="tolerance": max ℓ_{max_cls} with T ≤ T_budget (§II-D2);
      other classes stay bounded below by their base latency.
    """
    nc, nv, ne = g.nclass, g.num_vertices, g.num_edges
    n = nc + nv + 1
    iT = n - 1
    vc = g.vcost

    # edge constraints (vectorized):  t_u - t_v + Σ elat·ℓ ≤ -(vcost[u] + econst)
    erows = np.arange(ne, dtype=np.int64)
    lat_e, lat_c = np.nonzero(g.elat)
    rows = np.concatenate([erows, erows, lat_e])
    cols = np.concatenate([nc + g.esrc.astype(np.int64),
                           nc + g.edst.astype(np.int64),
                           lat_c.astype(np.int64)])
    vals = np.concatenate([np.ones(ne), -np.ones(ne),
                           g.elat[lat_e, lat_c].astype(np.float64)])
    rhs = -(vc[g.esrc] + g.econst)

    # sink constraints: t_v + vcost[v] - T ≤ 0 for vertices with no out-edge
    has_out = np.zeros(nv, dtype=bool)
    has_out[g.esrc] = True
    sinks = np.nonzero(~has_out)[0].astype(np.int64)
    ns = sinks.shape[0]
    srows = ne + np.arange(ns, dtype=np.int64)
    rows = np.concatenate([rows, srows, srows])
    cols = np.concatenate([cols, nc + sinks, np.full(ns, iT, dtype=np.int64)])
    vals = np.concatenate([vals, np.ones(ns), -np.ones(ns)])
    rhs = np.concatenate([rhs, -vc[sinks]])

    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    for c in range(nc):
        lb[c] = params.L[c]
    cvec = np.zeros(n)
    if objective == "makespan":
        cvec[iT] = 1.0
    elif objective == "tolerance":
        if max_cls is None or T_budget is None:
            raise ValueError("objective='tolerance' needs max_cls and "
                             "T_budget")
        cvec[max_cls] = -1.0  # maximize ℓ_cls
        ub[iT] = T_budget
    else:
        raise ValueError(objective)

    A = sp.csr_matrix((vals, (rows, cols)), shape=(rhs.shape[0], n))
    return LPProblem(A=A, b=rhs.astype(np.float64), c=cvec,
                     lb=lb, ub=ub, nclass=nc, nv=nv)


@dataclasses.dataclass
class LPSolution:
    T: float                 # objective-relevant value (makespan or max ℓ)
    x: np.ndarray
    lam: np.ndarray          # reduced costs of ℓ (λ per class); makespan LPs only
    status: str              # "optimal", "unbounded" or "iteration_limit"
    iterations: int = 0
    device: str = "cpu"      # where the solve ran: the card's name, or "cpu"
    # the sparse Newton route's PCG steps, one entry a PCG (two an IPM
    # iteration); None on the dense route and HiGHS
    pcg_steps: Optional[list] = None


def solve_highs(prob: LPProblem) -> LPSolution:
    """Solve with scipy's HiGHS, on the host."""
    from scipy.optimize import linprog

    res = linprog(
        prob.c, A_ub=prob.A, b_ub=prob.b,
        bounds=np.stack([prob.lb, prob.ub], axis=1),
        method="highs",
    )
    if res.status == 3:  # unbounded — e.g. maximize-ℓ when λ stays 0 forever
        return LPSolution(T=np.inf, x=np.zeros(prob.nvars),
                          lam=np.zeros(prob.nclass), status="unbounded")
    if not res.success:
        raise RuntimeError(f"HiGHS failed: {res.message}")
    lam = np.asarray(res.lower.marginals[: prob.nclass])
    if prob.c[prob.idx_T] == 1.0:
        val = float(res.x[prob.idx_T])
    else:
        val = float(-res.fun)  # maximize-ℓ value
    nit = int(getattr(res, "nit", 0) or 0)
    return LPSolution(T=val, x=np.asarray(res.x), lam=lam, status="optimal",
                      iterations=nit)


def _solve(prob: LPProblem, solver: str = "ipm",
           device: DeviceLike = None) -> LPSolution:
    """``prob`` on ``solver``; an IPM that stops at its iteration limit
    raises, as it has no answer to give."""
    if solver == "highs":
        return solve_highs(prob)
    if solver != "ipm":
        raise ValueError(f"unknown solver {solver!r} (use one of {SOLVERS})")
    from .ipm import solve_ipm
    sol = solve_ipm(prob, device=device)
    if sol.status != "optimal":
        raise RuntimeError(f"IPM stopped after {sol.iterations} iterations "
                           f"without converging ({sol.status})")
    return sol


def predict_runtime(g: ExecutionGraph, params: LogGPS, solver: str = "ipm",
                    device: DeviceLike = None) -> LPSolution:
    """T and λ from the makespan LP; ``solver="ipm"`` on ``device``."""
    return _solve(build_lp(g, params, objective="makespan"), solver, device)


def tolerance_lp(g: ExecutionGraph, params: LogGPS, degradation: float,
                 cls: int = 0, solver: str = "ipm",
                 device: DeviceLike = None) -> float:
    """The paper's §II-D2 flipped LP. Returns ΔL tolerance (L* − L₀).

    The LP is unbounded exactly when no edge carries a class-``cls``
    latency term: every edge lies on a path to a sink and latency counts
    are nonnegative, so an edge with elat[e, cls] > 0 puts
    elat[e, cls]·ℓ_cls under T, which the budget caps.  Then the tolerance
    is infinite and ``math.inf`` is returned without a solve (an
    interior-point method has no certificate of unboundedness: its iterates
    only grow).
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (use one of {SOLVERS})")
    if not (g.elat[:, cls] > 0).any():
        return math.inf
    base = predict_runtime(g, params, solver=solver, device=device)
    budget = (1.0 + degradation) * base.T
    prob = build_lp(g, params, objective="tolerance", max_cls=cls,
                    T_budget=budget)
    sol = _solve(prob, solver, device)
    if sol.status == "unbounded" or not np.isfinite(sol.T):
        return math.inf
    return float(sol.T - params.L[cls])
