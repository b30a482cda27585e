"""The forwards of the sweep engine over a batch of scenarios: the dense
forward of a compiled plan (solo and packed), and the two flavours of the
sparse slot-list forward.

Dense.  The counterpart of the JAX package's ``_dense_core`` (``repro/sweep/
engine.py:545-644``): each topological level's scatter-max is a (max,+)
mat-vec of the level's 0/−1e30 indicator with per-edge candidate values,
scenarios on the contiguous axis.  Values-only runs call
:func:`~repro_torch.kernels.maxplus.maxplus_matvec`; λ runs call the
argmax-emitting kernel with the cumulative-slope tie keys, record each
level's realizing edge slot, and a reverse backtrace over the recorded
slots recovers λ (the scalar engine's "max slope, then max ordinal" rule).
The kernels see float32 candidates, as the reference's do, but end times
are carried in float64 (:func:`_level_max`).

Tie caveat, as in the reference: the kernels compare candidates exactly,
where ``core.dag`` groups float64 ties within 1e-12, so two paths whose
sums tie only to within that tolerance can resolve differently.

Unlike the reference's pure ``fori_loop`` carry, the forward writes
``t_end``, ``ssum`` and ``chosen_all`` in place, as preallocated device
tensors, one level's slice at a time.

Packed.  A :class:`~repro_torch.sweep.compile.MultiPlan` of G graphs runs
the same forward with a leading graph axis (:func:`stage_multi`,
:func:`dense_forward_multi`, the counterpart of ``_dense_core_multi``,
``engine.py:647-746``): each level's scatter-max for all G graphs is one
launch of the graph-batched kernels, and the backtrace runs per (graph,
scenario).  Every graph's T and λ equal its solo forward's bit for bit.

Sparse.  A :class:`~repro_torch.sweep.compile.SparsePlan` is walked level
by level (:func:`stage_sparse`; memory is O(nv + ne) per scenario).  The
float64 flavour (:func:`sparse_forward_f64`) is plain PyTorch over fixed
``[Emax_lv]`` edge and ``[Vmax_lv]`` vertex windows; the float32 flavour
(:func:`sparse_forward_f32`) runs every level of a weight chunk in one
launch of :func:`~repro_torch.kernels.maxplus.sparse_levels_f32`.  Both
end in one launch of the backtrace walk,
:func:`~repro_torch.kernels.maxplus.sparse_backtrace`.

Also here: :func:`tolerance_batched`, the lockstep-batched bisection of
``core.dag.tolerance`` (reference: ``engine.py:1476-1515``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.loggps import LogGPS
from repro_torch.kernels.maxplus import (maxplus_matvec, maxplus_matvec_argmax,
                                         maxplus_matvec_argmax_batched,
                                         maxplus_matvec_batched,
                                         sparse_backtrace, sparse_levels_f32)

from .compile import NEG_INF, CompiledPlan, MultiPlan, SparsePlan
from .scenarios import latency_grid

BIG = -NEG_INF
ATOL = 1e-12          # the scalar engine's tie tolerance (dag.LevelPlan)


@dataclasses.dataclass
class DenseArrays:
    """A plan's tensors staged on one device for the dense forward: the
    float32 indicator the kernels consume, and the edge and vertex costs in
    float64, in which end times are carried."""

    A: torch.Tensor             # [nlv, Vmax, Emax] f32 0/−1e30 indicator
    esrc: torch.Tensor          # [nlv, Emax] int64 flat source slot
    edst: torch.Tensor          # [nlv, Emax] int64 destination row (pad → 0)
    emask: torch.Tensor         # [nlv, Emax] bool
    econst: torch.Tensor        # [nlv, Emax] f64
    egap: torch.Tensor          # [nlv, Emax] f64
    egclass: torch.Tensor       # [nlv, Emax] int64
    elat: torch.Tensor          # [nlv, Emax, nc] f64
    vcost_lv: torch.Tensor      # [nlv, Vmax] f64
    valid_flat: torch.Tensor    # [nflat] bool
    vert_of_slot: torch.Tensor  # [nflat] int32


def _put(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def stage(plan: CompiledPlan, device: torch.device) -> DenseArrays:
    f64, i64 = torch.float64, torch.int64
    return DenseArrays(
        A=_put(plan.dense_indicator(NEG_INF), device, torch.float32),
        esrc=_put(plan.esrc, device, i64),
        edst=_put(np.where(plan.emask, plan.edstl, 0), device, i64),
        emask=_put(plan.emask, device, torch.bool),
        econst=_put(plan.econst, device, f64),
        egap=_put(plan.egap, device, f64),
        egclass=_put(plan.egclass, device, i64),
        elat=_put(plan.elat, device, f64),
        vcost_lv=_put(plan.vcost_lv, device, f64),
        valid_flat=_put(plan.valid_flat, device, torch.bool),
        vert_of_slot=_put(plan.vert_of_slot, device, torch.int32))


def _weights(egclass, egap, econst, elat, Lmat, GSmat) -> torch.Tensor:
    """``econst + egap·(γ − 1) + Σ_c elat_c·L_c`` per edge and scenario
    ([..., S], in the dtype of the edge tensors), one elementwise op at a
    time with the class sum spelled out in class order: no contraction
    into an FMA and no reordering, so the card and the CPU round alike and
    the float64 result is the reference's (``engine.py:576-578``,
    ``:776-779``) and the scalar oracle's (``dag.py:80``) bit for bit."""
    gse = GSmat.T[egclass]                           # [..., S]
    w = gse.sub_(1.0).mul_(egap[..., None]).add_(econst[..., None])
    lat = elat[..., 0, None] * Lmat[:, 0]
    for c in range(1, elat.shape[-1]):
        lat.add_(elat[..., c, None] * Lmat[:, c])
    return w.add_(lat)


def edge_weights(d: DenseArrays, Lmat: torch.Tensor,
                 GSmat: torch.Tensor) -> torch.Tensor:
    """[nlv, Emax, S] f64 edge weights of every level at one go
    (:func:`_weights`).  Elementwise, so each weight is the op sequence a
    per-level evaluation would do.

    Masked (pad) slots get −1e30: a pad slot's source is the scratch slot,
    whose end time stays 0, so ``t_end[src] + w`` is exactly the −1e30 the
    reference writes with ``where(emask, cand, −BIG)``."""
    w = _weights(d.egclass, d.egap, d.econst, d.elat, Lmat, GSmat)
    return w.masked_fill_(~d.emask[..., None], -BIG)


def _level_max(A, cand, hi, M, dst, emask) -> torch.Tensor:
    """Each row's float64 maximum ``max(0, max_j cand)`` of a level, from
    ``M``, the kernel's float32 maximum of the candidates' roundings
    ``hi``.  Rounding is monotone, so the float64 maximum rounds to M: a
    second launch of the values kernel takes, among each row's real
    candidates that round to M, the largest remainder ``cand − hi``
    (itself rounded to float32, an error of ~2^-48 of M), and M plus that
    remainder is the float64 maximum.  ``dst`` holds each edge's row in
    ``M`` flattened to [rows, S]; ``emask`` the real edges ([..., Emax,
    1]).  Batched (3-D) operands go to the batched kernel."""
    at = M.reshape(-1, M.shape[-1]).index_select(0, dst).view(hi.shape)
    tie = (hi == at).logical_and_(emask)
    rem = torch.where(tie, torch.sub(cand, hi).float(), -BIG)
    kernel = maxplus_matvec if A.dim() == 2 else maxplus_matvec_batched
    return M.double().add_(kernel(A, rem)).clamp_min_(0.0)


def dense_forward(d: DenseArrays, Lmat: torch.Tensor, GSmat: torch.Tensor,
                  want_lam: bool):
    """Lmat/GSmat [S, nc] f64 → (T [S] f64, λ [S, nc] f64 or None).

    The kernels decide every maximum and every λ tie on float32
    candidates, as the reference's do; end times are carried in float64
    and each level's value is the float64 maximum (:func:`_level_max`),
    where the reference stores the kernel's float32 maximum.  Rounding t
    to float32 at every level accumulates along the critical path: on the
    5,050-level allreduce of ``chip_smoke.py`` phase 7 (which measures it)
    T drifts beyond the 1e-5 contract."""
    nlv, Vmax = d.vcost_lv.shape
    S = Lmat.shape[0]
    nflat = d.valid_flat.shape[0]
    dev = Lmat.device
    w = edge_weights(d, Lmat, GSmat)
    vcost = d.vcost_lv[..., None]                    # [nlv, Vmax, 1]
    emask = d.emask[..., None]
    valid = d.valid_flat.nonzero()[:, 0]
    t_end = torch.zeros((nflat, S), dtype=torch.float64, device=dev)
    dense_forward.runs["lam" if want_lam else "values"] += 1

    if not want_lam:
        for lv in range(nlv):
            cand = t_end.index_select(0, d.esrc[lv]).add_(w[lv])
            hi = cand.float()
            M = maxplus_matvec(d.A[lv], hi)
            ts = _level_max(d.A[lv], cand, hi, M, d.edst[lv], emask[lv])
            torch.add(ts, vcost[lv], out=t_end[lv * Vmax:(lv + 1) * Vmax])
        return t_end[valid].amax(0), None

    ssum = torch.zeros((nflat, S), dtype=torch.float32, device=dev)
    chosen_all = torch.empty((nlv, Vmax, S), dtype=torch.int32, device=dev)
    elat_sum = d.elat.sum(2).float()                 # [nlv, Emax]
    for lv in range(nlv):
        src = d.esrc[lv]
        cand = t_end.index_select(0, src).add_(w[lv])
        hi = cand.float()
        cs = ssum.index_select(0, src).add_(elat_sum[lv][:, None])
        raw, eidx = maxplus_matvec_argmax(d.A[lv], hi, cs)
        has = raw >= 0.0                 # a real in-edge realized the max
        rows = slice(lv * Vmax, (lv + 1) * Vmax)
        ts = _level_max(d.A[lv], cand, hi, raw, d.edst[lv], emask[lv])
        torch.add(ts, vcost[lv], out=t_end[rows])
        # the winner's key: ssum[src] + elat_sum[e] (reference :605-607)
        ssum[rows] = cs.gather(0, torch.where(has, eidx, 0).long()
                               ).masked_fill_(~has, 0.0)
        chosen_all[lv] = torch.where(has, eidx, -1)

    T, vsel = _dense_sink(t_end, ssum, valid, d.valid_flat, d.vert_of_slot)

    # reverse backtrace over the recorded slots (reference :625-642)
    sidx = torch.arange(S, device=dev)
    cur = vsel
    lam = torch.zeros((S, d.elat.shape[2]), dtype=torch.float64, device=dev)
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
#: counts, shows that every level of every forward launched its kernels
dense_forward.runs = collections.Counter()


def _dense_sink(t_end, ssum, valid, valid_flat, vert_of_slot):
    """(T [S], the sink's flat slot [S]) of one graph: the latest-ending
    valid vertex, ties → larger slope sum, then smaller original vertex id
    (reference ``engine.py:618-623``)."""
    T = t_end[valid].amax(0)
    sink = valid_flat[:, None] & (t_end >= T)
    mx = torch.where(sink, ssum, -BIG).amax(0)
    top = sink & (ssum >= mx)
    vsel = torch.where(top, vert_of_slot[:, None],
                       torch.iinfo(torch.int32).max).argmin(0)
    return T, vsel


# -- packed multi-graph forward -----------------------------------------------


@dataclasses.dataclass
class MultiArrays:
    """A :class:`MultiPlan` staged on one device for the packed forward.
    The kernels' operands are level-major, so that one level of all G
    graphs is one contiguous slice; the edge-weight inputs stay
    graph-major, as each graph's weights are computed from its own
    scenario batch."""

    A: torch.Tensor             # [nlv, G, Vmax, Emax] f32 0/−1e30 indicator
    gsrc: torch.Tensor          # [nlv, G·Emax] int64 row g·nflat + source slot
    gdst: torch.Tensor          # [nlv, G·Emax] int64 row g·Vmax + dst (pad → g·Vmax)
    esrc: torch.Tensor          # [G, nlv, Emax] int64 flat source slot
    emask: torch.Tensor         # [G, nlv, Emax] bool
    econst: torch.Tensor        # [G, nlv, Emax] f64
    egap: torch.Tensor          # [G, nlv, Emax] f64
    egclass: torch.Tensor       # [G, nlv, Emax] int64
    elat: torch.Tensor          # [G, nlv, Emax, nc] f64
    vcost_lv: torch.Tensor      # [G, nlv, Vmax] f64
    valid_flat: torch.Tensor    # [G, nflat] bool
    vert_of_slot: torch.Tensor  # [G, nflat] int32
    valid: list                 # G index tensors of each graph's valid slots
    nlevels: np.ndarray         # [G] real levels per graph


def stage_multi(mp: MultiPlan, device: torch.device) -> MultiArrays:
    """Stage ``mp`` as :func:`stage` stages one plan.  The indicator is laid
    out on the device itself, level-major."""
    f64, i64 = torch.float64, torch.int64
    G, nlv, Emax = mp.esrc.shape
    Vmax, nflat = mp.Vmax, mp.valid_flat.shape[1]
    A = torch.full((nlv, G, Vmax, Emax), NEG_INF, dtype=torch.float32,
                   device=device)
    gi, lv, sl = np.nonzero(mp.emask)
    A[_put(lv, device, i64), _put(gi, device, i64),
      _put(mp.edstl[gi, lv, sl], device, i64), _put(sl, device, i64)] = 0.0
    g = np.arange(G)[:, None, None]
    rows = mp.esrc.astype(np.int64) + g * nflat
    dst = np.where(mp.emask, mp.edstl, 0).astype(np.int64) + g * Vmax

    def level_major(a):
        return _put(a.transpose(1, 0, 2).reshape(nlv, G * Emax), device, i64)

    valid_flat = _put(mp.valid_flat, device, torch.bool)
    return MultiArrays(
        A=A, gsrc=level_major(rows), gdst=level_major(dst),
        esrc=_put(mp.esrc, device, i64),
        emask=_put(mp.emask, device, torch.bool),
        econst=_put(mp.econst, device, f64), egap=_put(mp.egap, device, f64),
        egclass=_put(mp.egclass, device, i64),
        elat=_put(mp.elat, device, f64),
        vcost_lv=_put(mp.vcost_lv, device, f64),
        valid_flat=valid_flat,
        vert_of_slot=_put(mp.vert_of_slot, device, torch.int32),
        valid=[v.nonzero()[:, 0] for v in valid_flat],
        nlevels=np.asarray(mp.nlevels, dtype=np.int64))


def dense_forward_multi(d: MultiArrays, Lmat: torch.Tensor,
                        GSmat: torch.Tensor, want_lam: bool,
                        nlv: Optional[int] = None):
    """The packed forward: Lmat/GSmat [G, S, nc] f64, one scenario batch per
    graph → (T [G, S] f64, λ [G, S, nc] f64 or None).

    Each level is one launch of
    :func:`~repro_torch.kernels.maxplus.maxplus_matvec_argmax_batched` (λ)
    or :func:`~repro_torch.kernels.maxplus.maxplus_matvec_batched` (values)
    for all G graphs, and one more of the latter for the float64 maximum
    (:func:`_level_max`), as in :func:`dense_forward`.  Graph g's edge
    weights are :func:`_weights` of its own batch, elementwise as in the
    solo forward (the reference's ``einsum`` sums the classes in its own
    order), so each graph's T and λ equal its solo :func:`dense_forward`
    bit for bit.

    The reference walks all ``nlv_p`` levels; levels past a graph's own
    ``nlevels`` only write zeros to its invalid slots, so ``nlv`` defaults
    to the largest ``nlevels`` of the G graphs (tested identical both
    ways)."""
    nlv = int(d.nlevels.max()) if nlv is None else nlv
    G, nflat = d.valid_flat.shape
    Vmax, Emax = d.A.shape[2], d.A.shape[3]
    S = Lmat.shape[1]
    dev = Lmat.device
    w = torch.empty((nlv, G, Emax, S), dtype=torch.float64, device=dev)
    for g in range(G):
        w[:, g] = _weights(d.egclass[g, :nlv], d.egap[g, :nlv],
                           d.econst[g, :nlv], d.elat[g, :nlv], Lmat[g],
                           GSmat[g])
    w.masked_fill_(~d.emask[:, :nlv].transpose(0, 1)[..., None], -BIG)
    t_end = torch.zeros((G, nflat, S), dtype=torch.float64, device=dev)
    t_rows = t_end.view(G * nflat, S)
    vcost = d.vcost_lv[..., None]                    # [G, nlv, Vmax, 1]
    emask = d.emask[..., None]                       # [G, nlv, Emax, 1]
    dense_forward_multi.runs["lam" if want_lam else "values"] += 1

    if not want_lam:
        for lv in range(nlv):
            cand = t_rows.index_select(0, d.gsrc[lv]).view(G, Emax, S)
            cand.add_(w[lv])
            hi = cand.float()
            M = maxplus_matvec_batched(d.A[lv], hi)
            ts = _level_max(d.A[lv], cand, hi, M, d.gdst[lv], emask[:, lv])
            torch.add(ts, vcost[:, lv],
                      out=t_end[:, lv * Vmax:(lv + 1) * Vmax])
        return torch.stack([t_end[g, d.valid[g]].amax(0)
                            for g in range(G)]), None

    ssum = torch.zeros((G, nflat, S), dtype=torch.float32, device=dev)
    s_rows = ssum.view(G * nflat, S)
    chosen_all = torch.empty((nlv, G, Vmax, S), dtype=torch.int32,
                             device=dev)
    elat_sum = d.elat.sum(3).float()[..., None]      # [G, nlv, Emax, 1]
    for lv in range(nlv):
        src = d.gsrc[lv]
        cand = t_rows.index_select(0, src).view(G, Emax, S).add_(w[lv])
        hi = cand.float()
        cs = s_rows.index_select(0, src).view(G, Emax, S)
        cs.add_(elat_sum[:, lv])
        raw, eidx = maxplus_matvec_argmax_batched(d.A[lv], hi, cs)
        has = raw >= 0.0                 # a real in-edge realized the max
        rows = slice(lv * Vmax, (lv + 1) * Vmax)
        ts = _level_max(d.A[lv], cand, hi, raw, d.gdst[lv], emask[:, lv])
        torch.add(ts, vcost[:, lv], out=t_end[:, rows])
        # the winner's key ssum[src] + elat_sum[e], the solo forward's sum
        ssum[:, rows] = cs.gather(1, torch.where(has, eidx, 0).long()
                                  ).masked_fill_(~has, 0.0)
        chosen_all[lv] = torch.where(has, eidx, -1)

    T = torch.empty((G, S), dtype=torch.float64, device=dev)
    cur = torch.empty((G, S), dtype=torch.int64, device=dev)
    for g in range(G):
        T[g], cur[g] = _dense_sink(t_end[g], ssum[g], d.valid[g],
                                   d.valid_flat[g], d.vert_of_slot[g])

    # reverse backtrace per (graph, scenario), as the solo one
    nc = d.elat.shape[3]
    lam = torch.zeros((G, S, nc), dtype=torch.float64, device=dev)
    for lv in range(nlv - 1, -1, -1):
        onlvl = (cur >= lv * Vmax) & (cur < (lv + 1) * Vmax)
        off = torch.where(onlvl, cur - lv * Vmax, 0)
        e = chosen_all[lv].gather(1, off[:, None]).squeeze(1)     # [G, S]
        take = onlvl & (e >= 0)
        e_s = torch.where(take, e, 0).long()
        rows = d.elat[:, lv].gather(1, e_s[..., None].expand(G, S, nc))
        lam += torch.where(take[..., None], rows, 0.0)
        cur = torch.where(take, d.esrc[:, lv].gather(1, e_s), cur)
    return T, lam


#: forwards run, by kind ("values" / "lam"): with the batched kernels'
#: launch counts, shows the launches per level for all G graphs
dense_forward_multi.runs = collections.Counter()


# -- sparse slot-list forwards ------------------------------------------------

#: edge weights are computed for runs of levels at a time, at most this many
#: [edge, scenario] elements per run (float64: 512 MiB)
WEIGHT_CHUNK_ELEMS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_pads(Emax_lv: int, Vmax_lv: int):
    """(E_pad, M_pad): the windows rounded up to the TPU kernel's block
    multiples, as the reference pads them (``engine.py:887-894``).  For the
    bucketed windows of a compiled plan (powers of two ≥ 8) both equal the
    windows themselves."""
    E_pad = _round_up(Emax_lv, min(128, _round_up(Emax_lv, 8)))
    E_pad = _round_up(E_pad, min(128, E_pad))
    M_pad = _round_up(Vmax_lv, min(128, _round_up(Vmax_lv, 8)))
    M_pad = _round_up(M_pad, min(128, M_pad))
    return E_pad, M_pad


@dataclasses.dataclass
class SparseArrays:
    """A :class:`SparsePlan` staged on one device for one flavour of the
    sparse forward.  Edge weights are computed in float64 in both flavours
    (the reference stages the same float64 arrays for both, and its
    float32 flavour casts at the (max,+) reduction boundary)."""

    dtype: torch.dtype          # flavour: float64 (plain) / float32 (kernel)
    esrc: torch.Tensor          # [ne_p] int64 compact source slot
    econst: torch.Tensor        # [ne_p] f64
    egap: torch.Tensor          # [ne_p] f64
    egclass: torch.Tensor       # [ne_p] int64
    elat: torch.Tensor          # [ne_p, nc] f64
    elat_sum: torch.Tensor      # [ne_p] tie-key slopes, in the flavour dtype
    eidx: torch.Tensor          # [ne_p] int64 global edge index
    vcost: torch.Tensor         # [nv_p] f64
    vert_of_slot: torch.Tensor  # [nv_p] int32
    dloc: torch.Tensor          # [nlv_p, E_pad] window-local destination row
    level_ptr: np.ndarray       # [nlv_p + 1] int64 (host: slices need ints)
    v_ptr: np.ndarray           # [nlv_p + 1] int64
    nv: int
    nlevels: int
    Emax_lv: int
    Vmax_lv: int
    # float32 flavour (the level-loop kernel): level lv's rows are
    # v_ptr_dev[lv]..v_ptr_dev[lv+1]-1, row r's in-edges
    # row_ptr[r]..row_ptr[r+1]-1, both int32 on the device
    v_ptr_dev: Optional[torch.Tensor] = None
    row_ptr: Optional[torch.Tensor] = None


def stage_sparse(plan: SparsePlan, device: torch.device,
                 dtype: torch.dtype) -> SparseArrays:
    """Stage ``plan`` for the float64 or the float32 flavour.

    Both flavours rely on the plan's layout, checked here: each level's
    edges are unmasked, land in the level's own rows and are sorted by
    destination (``compile_sparse`` sorts them so), so a row's in-edges
    are one run of increasing edge index.

    Window-local destinations are computed here once for every level:
    ``dloc[lv, j] = edst[level_ptr[lv] + j] − v_ptr[lv]``.  The reference
    hands out-of-range ids to ``segment_max`` (which drops them) or to the
    kernel as rows ≥ M (which never hit); ``scatter_reduce`` raises on them
    instead.  So every window slot that cannot land in the level's rows —
    pad and masked edges, edges of later levels whose row falls outside
    the window, and the E_pad padding — is routed to a trash row: row
    ``Vmax_lv`` of the float64 flavour's scatter buffers, row ``M_pad`` (≥
    M, never hit) for the slot-list kernel.  Edges of later levels whose
    row falls inside the window are kept, as in the reference: they write
    rows of later levels, which those levels overwrite before anything
    reads them.  The float64 forward reduces over these windows; the
    float32 windows are the reference's input to the standalone slot-list
    kernel, which the float32 forward no longer launches.

    Float32 also stages the level and row pointers on the device, for the
    level-loop kernel, which reads only each level's own edges and writes
    only its own rows."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the sparse forward runs in float32 or float64, "
                         f"not {dtype}")
    lp = plan.level_ptr.astype(np.int64)
    vp = plan.v_ptr.astype(np.int64)
    E, V = plan.Emax_lv, plan.Vmax_lv
    ne_p, nv_p = plan.esrc_slot.shape[0], plan.vcost.shape[0]
    # the invariants of SparsePlan: every level's run fits its window, and
    # no window runs past its array, so a slice equals the reference's
    # (start-clamping) dynamic_slice
    if (np.diff(lp) < 0).any() or (np.diff(vp) < 0).any() \
            or np.diff(lp).max() > E or np.diff(vp).max() > V:
        raise ValueError("level_ptr/v_ptr must be level runs of at most "
                         "Emax_lv edges / Vmax_lv vertices")
    if plan.nlevels > lp.shape[0] - 1 or lp.max() + E > ne_p \
            or vp.max() + V > nv_p:
        raise ValueError("the plan's padding is too short for its windows "
                         "(need nlv_p >= nlevels, ne_p >= ne + Emax_lv, "
                         "nv_p >= nv + Vmax_lv)")
    if not np.array_equal(plan.valid, np.arange(nv_p) < plan.nv):
        raise ValueError("valid must be true exactly on the first nv slots")
    nl = plan.nlevels
    own = slice(int(lp[0]), int(lp[nl]))
    dst = plan.edst_slot[own].astype(np.int64)
    runs = np.diff(lp[:nl + 1])
    if not plan.emask[own].all() or (dst < np.repeat(vp[:nl], runs)).any() \
            or (dst >= np.repeat(vp[1:nl + 1], runs)).any() \
            or (np.diff(dst) < 0).any():
        raise ValueError("each level's edges must be unmasked, land in the "
                         "level's own rows and be sorted by destination")

    E_pad, M_pad = kernel_pads(E, V)
    trash = M_pad if dtype == torch.float32 else V
    win = lp[:-1, None] + np.arange(E)                       # [nlv_p, E]
    dl = plan.edst_slot[win].astype(np.int64) - vp[:-1, None]
    keep = plan.emask[win] & (dl >= 0) & (dl < V)
    dloc = np.full((lp.shape[0] - 1, E_pad), trash, dtype=np.int64)
    dloc[:, :E] = np.where(keep, dl, trash)

    def put(a, dt):
        return _put(a, device, dt)

    f64 = torch.float64
    a = SparseArrays(
        dtype=dtype,
        esrc=put(plan.esrc_slot, torch.int64),
        econst=put(plan.econst, f64), egap=put(plan.egap, f64),
        egclass=put(plan.egclass, torch.int64), elat=put(plan.elat, f64),
        elat_sum=put(plan.elat_sum, dtype),
        eidx=torch.arange(ne_p, dtype=torch.int64, device=device),
        vcost=put(plan.vcost, f64),
        vert_of_slot=put(plan.vert_of_slot, torch.int32),
        dloc=put(dloc, torch.int32 if dtype == torch.float32
                 else torch.int64),
        level_ptr=lp, v_ptr=vp, nv=plan.nv, nlevels=nl, Emax_lv=E,
        Vmax_lv=V)
    if dtype == torch.float32:
        a.v_ptr_dev = put(vp, torch.int32)
        a.row_ptr = put(lp[0] + np.searchsorted(dst, np.arange(nv_p + 1)),
                        torch.int32)
    return a


def weight_chunks(level_ptr: np.ndarray, Emax_lv: int, S: int, nlv: int):
    """``[(lv0, lv1, base, end)]``: the runs of levels ``0..nlv-1`` whose
    edge weights are computed at one go, edges ``base..end-1`` (each level's
    ``[Emax_lv]`` window), each run's span holding at most
    :data:`WEIGHT_CHUNK_ELEMS` [edge, scenario] elements (at least one
    level), so memory stays bounded and the launches per level stay few."""
    cap = max(Emax_lv, WEIGHT_CHUNK_ELEMS // S)
    lp = level_ptr[:nlv]
    out = []
    lv = 0
    while lv < nlv:
        base = int(lp[lv])
        hi = max(lv + 1, int(np.searchsorted(lp, base + cap - Emax_lv,
                                             "right")))
        out.append((lv, hi, base, int(lp[hi - 1]) + Emax_lv))
        lv = hi
    return out


def _chunk_weights(a: SparseArrays, Lmat, GSmat, nlv: int):
    """Yield ``(lv0, lv1, base, w)`` for each of :func:`weight_chunks`: its
    levels, its first edge and its [end − base, S] float64 edge weights
    (:func:`_weights`)."""
    for lv0, lv1, base, end in weight_chunks(a.level_ptr, a.Emax_lv,
                                             Lmat.shape[0], nlv):
        sl = slice(base, end)
        yield lv0, lv1, base, _weights(a.egclass[sl], a.egap[sl],
                                       a.econst[sl], a.elat[sl], Lmat, GSmat)


def _weight_windows(a: SparseArrays, Lmat, GSmat, nlv: int):
    """Yield ``(lv, e0, v0, w)`` for levels ``0..nlv-1``: the level's edge
    and vertex window starts and its [Emax_lv, S] float64 edge weights."""
    E = a.Emax_lv
    for lv0, lv1, base, w in _chunk_weights(a, Lmat, GSmat, nlv):
        for lv in range(lv0, lv1):
            e0 = int(a.level_ptr[lv])
            yield lv, e0, int(a.v_ptr[lv]), w[e0 - base:e0 - base + E]


def sparse_forward_f64(a: SparseArrays, Lmat: torch.Tensor,
                       GSmat: torch.Tensor, want_lam: bool,
                       nlv: Optional[int] = None):
    """The float64 slot-list forward, the port of the reference's
    ``_make_sparse_one`` (``engine.py:749-851``) batched over S in plain
    PyTorch (the reference has no kernel here either).  Lmat/GSmat [S, nc]
    f64 → (T [S] f64, λ [S, nc] f64 or None).

    Each level: candidates ``t[src] + w`` of the window's edges, a
    segment max into the level's rows (``scatter_reduce`` into buffers
    seeded with −inf, as ``segment_max`` seeds empty segments, plus the
    trash row of :func:`stage_sparse`), then ``max(seg, 0)`` (reference
    ``:793-794``).  λ keeps the scalar engine's ATOL = 1e-12 tie rules in
    its order (``:812-818``): value hits within ATOL of the level max, the
    largest cumulative slope within ATOL, then the largest edge index.
    Same float64 ops as ``core.dag``, so T, λ and ρ are bit-identical to it.

    The reference walks all ``nlv_p`` levels; the padded ones touch only
    pad slots, so ``nlv`` defaults to the plan's real ``nlevels`` (tested
    bit-identical both ways)."""
    nlv = a.nlevels if nlv is None else nlv
    S = Lmat.shape[0]
    nv_p = a.vcost.shape[0]
    E, V = a.Emax_lv, a.Vmax_lv
    dev, f64 = Lmat.device, torch.float64
    ninf = float("-inf")
    t = torch.zeros((nv_p, S), dtype=f64, device=dev)
    ssum = cho = None
    if want_lam:
        ssum = torch.zeros((nv_p, S), dtype=f64, device=dev)
        cho = torch.full((nv_p, S), -1, dtype=torch.int32, device=dev)
    sparse_forward_f64.runs["lam" if want_lam else "values"] += 1

    for lv, e0, v0, w in _weight_windows(a, Lmat, GSmat, nlv):
        es = a.esrc[e0:e0 + E]
        d1 = a.dloc[lv, :E]
        d = d1[:, None].expand(E, S)
        cand = t.index_select(0, es).add_(w)
        seg = torch.full((V + 1, S), ninf, dtype=f64, device=dev)
        ts = seg.scatter_reduce_(0, d, cand, "amax").clamp_min_(0.0)
        rows = slice(v0, v0 + V)
        if want_lam:
            hit = cand >= ts.index_select(0, d1).sub_(ATOL)
            cs = ssum.index_select(0, es).add_(a.elat_sum[e0:e0 + E, None])
            best = torch.full((V + 1, S), ninf, dtype=f64, device=dev)
            best.scatter_reduce_(0, d, torch.where(hit, cs, -BIG), "amax")
            sel = hit.logical_and_(cs >= best.index_select(0, d1).sub_(ATOL))
            chosen = torch.full((V + 1, S), -1, dtype=torch.int64, device=dev)
            chosen.scatter_reduce_(
                0, d, torch.where(sel, a.eidx[e0:e0 + E, None], -1), "amax")
            ch = chosen[:V]
            lost = ch < 0
            # the winner's key is ssum[src] + elat_sum[e], as the
            # reference recomputes it (:823)
            torch.gather(cs, 0, (ch - e0).clamp_min_(0), out=ssum[rows])
            ssum[rows].masked_fill_(lost, 0.0)
            cho[rows] = ch
        torch.add(ts[:V], a.vcost[rows, None], out=t[rows])
    return _sink_and_backtrace(a, t, ssum, cho, ATOL, nlv)


def sparse_forward_f32(a: SparseArrays, Lmat: torch.Tensor,
                       GSmat: torch.Tensor, want_lam: bool,
                       nlv: Optional[int] = None):
    """The float32 flavour, the port of the reference's
    ``_sparse_pallas_core`` (``engine.py:866-995``): each level's reduction
    is the slot-list (max,+) argmax of the level's candidates and tie keys
    cast to float32, in both the values-only and the λ forward (reference
    call at ``:927``).  Every level of a weight chunk (:func:`weight_chunks`)
    runs in one launch of
    :func:`~repro_torch.kernels.maxplus.sparse_levels_f32`, which reads only
    each level's own edges and writes only its own rows.  Lmat/GSmat [S, nc]
    f64 → (T [S] f64, λ [S, nc] f64 or None).

    One departure from the reference: end times are carried in float64,
    and a level's value is the float64 candidate of the slot the argmax
    picked, where the reference stores the kernel's float32 maximum.
    Rounding t to float32 at every level accumulates along the critical
    path: on the 13,223-level stencil of ``chip_smoke.py`` (which measures
    it) T drifts beyond the 1e-5 contract.  The float32 compares still
    decide every max and every λ tie, so exact float32 ties (the
    exact-compare caveat of the dense forward) resolve as in the reference;
    T can differ from the float64 flavour only where two candidates round
    to one float32 value.

    ``nlv`` as in :func:`sparse_forward_f64`."""
    nlv = a.nlevels if nlv is None else nlv
    S = Lmat.shape[0]
    nv_p = a.vcost.shape[0]
    dev = Lmat.device
    t = torch.zeros((nv_p, S), dtype=torch.float64, device=dev)
    ssum = cho = None
    if want_lam:
        ssum = torch.zeros((nv_p, S), dtype=torch.float32, device=dev)
        cho = torch.full((nv_p, S), -1, dtype=torch.int32, device=dev)
    sparse_forward_f32.runs["lam" if want_lam else "values"] += 1
    sparse_forward_f32.widths[S] += 1
    for lv0, lv1, base, w in _chunk_weights(a, Lmat, GSmat, nlv):
        sparse_levels_f32(t, ssum, cho, w.contiguous(), base, a.esrc,
                          a.row_ptr, a.v_ptr_dev, a.elat_sum, a.vcost, lv0,
                          lv1)
    return _sink_and_backtrace(a, t, ssum, cho, 0.0, nlv)


def _sink_and_backtrace(a: SparseArrays, t, ssum, cho, sink_atol: float,
                        nlv: int):
    """T, and λ by the critical-path backtrace when ``ssum``/``cho`` were
    recorded (reference ``engine.py:834-850``, ``:979-993``).

    The sink is the latest-ending valid vertex (within ``sink_atol``:
    ATOL for float64, exact for float32), ties → larger slope sum, then
    smaller original vertex id.  ``cho`` holds each vertex's chosen in-edge
    (−1: none); :func:`~repro_torch.kernels.maxplus.sparse_backtrace`
    walks from the sink down the chosen edges to their sources, for at
    most ``nlv`` steps: each step goes down at least one level, so the
    chain has reached its source by then.  λ sums the chosen edges'
    ``elat`` rows; they are message counts (integers), so the sum is exact
    in any order."""
    nv = a.nv
    tv = t[:nv]
    T = tv.amax(0)
    if ssum is None:
        return T, None
    sink = tv >= T - sink_atol
    sv = ssum[:nv]
    mx = torch.where(sink, sv, -BIG).amax(0)
    top = sink.logical_and_(sv >= mx)
    vsel = torch.where(top, a.vert_of_slot[:nv, None],
                       torch.iinfo(torch.int32).max).argmin(0)
    return T, sparse_backtrace(vsel, cho[:nv], a.esrc, a.elat, nlv)


#: forwards run, by kind ("values" / "lam"), per flavour
sparse_forward_f64.runs = collections.Counter()
sparse_forward_f32.runs = collections.Counter()
#: float32 forwards run, by scenario width S: with :func:`weight_chunks`,
#: gives the level-loop launches
sparse_forward_f32.widths = collections.Counter()


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
    return the same ``a − L0``.  With end times stored in float32 (the
    reference's dense engine) that fixed point is common: T's rounding
    error (a few 1e-6 of T on a 256-rank stencil) exceeds the stopping
    rule's ``tol``, so the secant step from b lands just under the budget,
    a takes it, and b never moves again."""
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
