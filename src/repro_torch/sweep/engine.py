"""Dense float32 forward of a compiled plan over a batch of scenarios.

The counterpart of the JAX package's ``_dense_core`` (``repro/sweep/
engine.py:545-644``): each topological level's scatter-max is a (max,+)
mat-vec of the level's 0/−1e30 indicator with per-edge candidate values,
scenarios on the contiguous axis.  Values-only runs call
:func:`~repro_torch.kernels.maxplus.maxplus_matvec`; λ runs call the
argmax-emitting kernel with the cumulative-slope tie keys, record each
level's realizing edge slot, and a reverse backtrace over the recorded
slots recovers λ (the scalar engine's "max slope, then max ordinal" rule).

Tie caveat, as in the reference: the kernels compare candidates exactly,
where ``core.dag`` groups float64 ties within 1e-12, so two paths whose
sums tie only to within that tolerance can resolve differently.

Unlike the reference's pure ``fori_loop`` carry, the forward writes
``t_end``, ``ssum`` and ``chosen_all`` in place, as preallocated device
tensors, one level's slice at a time.

Also here: :func:`tolerance_batched`, the lockstep-batched bisection of
``core.dag.tolerance`` (reference: ``engine.py:1476-1515``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.loggps import LogGPS
from repro_torch.kernels.maxplus import maxplus_matvec, maxplus_matvec_argmax

from .compile import NEG_INF, CompiledPlan
from .scenarios import latency_grid

BIG = -NEG_INF


@dataclasses.dataclass
class DenseArrays:
    """A plan's tensors staged on one device for the dense forward, with
    the float32 casts of the reference's ``_stage_arrays``."""

    A: torch.Tensor             # [nlv, Vmax, Emax] f32 0/−1e30 indicator
    esrc: torch.Tensor          # [nlv, Emax] int64 flat source slot
    emask: torch.Tensor         # [nlv, Emax] bool
    econst: torch.Tensor        # [nlv, Emax] f32
    egap: torch.Tensor          # [nlv, Emax] f32
    egclass: torch.Tensor       # [nlv, Emax] int64
    elat: torch.Tensor          # [nlv, Emax, nc] f32
    vcost_lv: torch.Tensor      # [nlv, Vmax] f32
    valid_flat: torch.Tensor    # [nflat] bool
    vert_of_slot: torch.Tensor  # [nflat] int32


def stage(plan: CompiledPlan, device: torch.device) -> DenseArrays:
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    f32 = torch.float32
    return DenseArrays(
        A=put(plan.dense_indicator(NEG_INF), f32),
        esrc=put(plan.esrc, torch.int64),
        emask=put(plan.emask, torch.bool),
        econst=put(plan.econst.astype(np.float32), f32),
        egap=put(plan.egap.astype(np.float32), f32),
        egclass=put(plan.egclass, torch.int64),
        elat=put(plan.elat.astype(np.float32), f32),
        vcost_lv=put(plan.vcost_lv.astype(np.float32), f32),
        valid_flat=put(plan.valid_flat, torch.bool),
        vert_of_slot=put(plan.vert_of_slot, torch.int32))


def edge_weights(d: DenseArrays, Lmat: torch.Tensor,
                 GSmat: torch.Tensor) -> torch.Tensor:
    """[nlv, Emax, S] f32 edge weights of every level at one go,
    ``econst + egap·(γ − 1) + Σ_c elat_c·L_c`` (reference ``engine.py:
    576-578``), with the class sum spelled out in class order so the card
    and the CPU round alike.  Elementwise, so each weight is the float32
    op sequence a per-level evaluation would do.

    Masked (pad) slots get −1e30: a pad slot's source is the scratch slot,
    whose end time stays 0, so ``t_end[src] + w`` is exactly the −1e30 the
    reference writes with ``where(emask, cand, −BIG)``."""
    gse = GSmat.T[d.egclass]                         # [nlv, Emax, S]
    w = gse.sub_(1.0).mul_(d.egap[..., None]).add_(d.econst[..., None])
    lat = d.elat[..., 0, None] * Lmat[:, 0]
    for c in range(1, d.elat.shape[2]):
        lat.add_(d.elat[..., c, None] * Lmat[:, c])
    w.add_(lat)
    return w.masked_fill_(~d.emask[..., None], -BIG)


def dense_forward(d: DenseArrays, Lmat: torch.Tensor, GSmat: torch.Tensor,
                  want_lam: bool):
    """Lmat/GSmat [S, nc] f32 → (T [S] f32, λ [S, nc] f32 or None)."""
    nlv, Vmax = d.vcost_lv.shape
    S = Lmat.shape[0]
    nflat = d.valid_flat.shape[0]
    dev = Lmat.device
    w = edge_weights(d, Lmat, GSmat)
    vcost = d.vcost_lv[..., None]                    # [nlv, Vmax, 1]
    valid = d.valid_flat.nonzero()[:, 0]
    t_end = torch.zeros((nflat, S), dtype=torch.float32, device=dev)
    dense_forward.runs["lam" if want_lam else "values"] += 1

    if not want_lam:
        for lv in range(nlv):
            cand = t_end.index_select(0, d.esrc[lv]).add_(w[lv])
            ts = maxplus_matvec(d.A[lv], cand).clamp_min_(0.0)
            torch.add(ts, vcost[lv], out=t_end[lv * Vmax:(lv + 1) * Vmax])
        return t_end[valid].amax(0), None

    ssum = torch.zeros((nflat, S), dtype=torch.float32, device=dev)
    chosen_all = torch.empty((nlv, Vmax, S), dtype=torch.int32, device=dev)
    elat_sum = d.elat.sum(2)                         # [nlv, Emax]
    for lv in range(nlv):
        src = d.esrc[lv]
        cand = t_end.index_select(0, src).add_(w[lv])
        cs = ssum.index_select(0, src).add_(elat_sum[lv][:, None])
        raw, eidx = maxplus_matvec_argmax(d.A[lv], cand, cs)
        has = raw >= 0.0                 # a real in-edge realized the max
        e_s = torch.where(has, eidx, 0).long()
        gss = ssum.gather(0, src[e_s])
        rows = slice(lv * Vmax, (lv + 1) * Vmax)
        torch.add(raw.clamp_min_(0.0), vcost[lv], out=t_end[rows])
        ssum[rows] = gss.add_(elat_sum[lv][e_s]).masked_fill_(~has, 0.0)
        chosen_all[lv] = torch.where(has, eidx, -1)

    # sink: the latest-ending valid vertex, ties → larger slope sum, then
    # smaller original vertex id (reference engine.py:618-623)
    T = t_end[valid].amax(0)
    sink = d.valid_flat[:, None] & (t_end >= T)
    mx = torch.where(sink, ssum, -BIG).amax(0)
    top = sink & (ssum >= mx)
    vsel = torch.where(top, d.vert_of_slot[:, None],
                       torch.iinfo(torch.int32).max).argmin(0)

    # reverse backtrace over the recorded slots (reference :625-642)
    sidx = torch.arange(S, device=dev)
    cur = vsel
    lam = torch.zeros((S, d.elat.shape[2]), dtype=torch.float32, device=dev)
    for lv in range(nlv - 1, -1, -1):
        onlvl = (cur >= lv * Vmax) & (cur < (lv + 1) * Vmax)
        off = torch.where(onlvl, cur - lv * Vmax, 0)
        e = chosen_all[lv, off, sidx]
        take = onlvl & (e >= 0)
        e_s = torch.where(take, e, 0).long()
        lam += torch.where(take[:, None], d.elat[lv, e_s], 0.0)
        cur = torch.where(take, d.esrc[lv, e_s], cur)
    return T, lam


#: forwards run, by kind ("values" / "lam"): with the kernels' launch
#: counts, shows that every level of every forward launched its kernel
dense_forward.runs = collections.Counter()


# -- lockstep-batched bisection (dag.tolerance, one engine call per round) --

def _probe(eng, params: LogGPS, Lvals, cls: int):
    batch = latency_grid(params, np.asarray(Lvals, dtype=np.float64),
                         cls=cls, absolute=True)
    res = eng.run(batch, compute_lam=True)
    return res.T, res.lam[:, cls]


def tolerance_batched(eng, params: LogGPS, degradations: Sequence[float],
                      cls: int = 0, L_hi: float = 1e7, tol: float = 1e-6,
                      max_iter: int = 200) -> dict:
    """All of ``dag.tolerance``'s bisections in lockstep: each round probes
    every still-active degradation level in one batched forward.

    One addition to the reference's loop: a level stops as soon as a round
    leaves its bracket [a, b] unchanged.  The rounds are deterministic, so
    every later one would repeat it until ``max_iter``, and the loop would
    return the same ``a − L0``.  In float32 that fixed point is common:
    T's rounding error (a few 1e-6 of T on the 256-rank stencil) exceeds
    the stopping rule's ``tol``, so the secant step from b lands just under
    the budget, a takes it, and b never moves again."""
    degr = np.asarray(list(degradations), dtype=np.float64)
    S = degr.shape[0]
    L0 = float(params.L[cls])
    T0 = _probe(eng, params, [L0], cls)[0][0]
    budgets = (1.0 + degr) * T0
    Thi = _probe(eng, params, [L_hi], cls)[0][0]

    out = np.empty(S)
    done = Thi <= budgets
    out[done] = np.inf
    a = np.full(S, L0)
    b = np.full(S, L_hi)
    for _ in range(max_iter):
        act = np.nonzero(~done)[0]
        if act.size == 0:
            break
        Tb, lb = _probe(eng, params, b[act], cls)
        x = np.where(lb > 0,
                     b[act] + (budgets[act] - Tb) / np.where(lb > 0, lb, 1.0),
                     (a[act] + b[act]) / 2)
        x = np.clip(x, a[act], b[act])
        Tx, _ = _probe(eng, params, x, cls)
        conv = np.abs(Tx - budgets[act]) <= tol * np.maximum(1.0, budgets[act])
        out[act[conv]] = x[conv] - L0
        done[act[conv]] = True
        rest = act[~conv]
        a_prev, b_prev = a.copy(), b.copy()
        hi = Tx[~conv] > budgets[rest]
        b[rest[hi]] = x[~conv][hi]
        a[rest[~hi]] = x[~conv][~hi]
        narrow = ~done & ((b - a < tol) | ((a == a_prev) & (b == b_prev)))
        out[narrow] = a[narrow] - L0
        done |= narrow
    out[~done] = a[~done] - L0
    return {float(p): float(v) for p, v in zip(degr, out)}
