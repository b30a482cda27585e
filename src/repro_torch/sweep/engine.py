"""The forwards of the sweep engine over a batch of scenarios: the dense
forward of a compiled plan (solo and packed), the segment forward of a
compiled plan (solo and packed), and the two flavours of the sparse
slot-list forward.

Dense.  The counterpart of the JAX package's ``_dense_core`` (``repro/sweep/
engine.py:545-644``): each topological level's scatter-max is a (max,+)
mat-vec of the level's 0/−1e30 indicator with per-edge candidate values,
scenarios on the contiguous axis, the argmax with the cumulative-slope tie
keys recording each level's realizing edge in a λ run.  The whole level
loop is one launch of :func:`~repro_torch.kernels.maxplus.dense_levels_f32`,
which reads each level's real in-edges from lists staged once
(:func:`stage`), and λ is one launch of the backtrace walk,
:func:`~repro_torch.kernels.maxplus.sparse_backtrace`, down the recorded
edges (the scalar engine's "max slope, then max ordinal" rule).  Every
level loop records, beside each row's chosen edge ``cho``, that edge's
source row ``csrc``, so a step of the walk is one dependent load.  The
maxima and ties are decided on float32 candidates, as the reference's
kernels decide them, but end times are carried in float64: each level's
value is the float64 maximum (:func:`~repro_torch.kernels.maxplus.
dense_levels_f32_ref` says how).

Tie caveat, as in the reference: the kernels compare candidates exactly,
where ``core.dag`` groups float64 ties within 1e-12, so two paths whose
sums tie only to within that tolerance can resolve differently.

Unlike the reference's pure ``fori_loop`` carry, the forward writes
``t_end``, ``ssum`` and ``cho`` in place, as preallocated device tensors.

Packed.  A :class:`~repro_torch.sweep.compile.MultiPlan` of G graphs runs
the same forward with a leading graph axis (:func:`stage_multi`,
:func:`dense_forward_multi`, the counterpart of ``_dense_core_multi``,
``engine.py:647-746``): one launch of the level loop for all G graphs, and
one walk for all G graphs.  Every graph's T and λ equal its solo forward's
bit for bit.

Segment.  The counterpart of the reference's default backend,
``_segment_core`` / ``_segment_core_multi`` (``engine.py:183-388``): the
float64 gather/max forward with ``core.dag``'s ATOL tie rules, so T, λ
and ρ are bit-identical to ``core.dag`` and to the float64 sparse forward.
The reference gathers each vertex's padded row of in-edges ([nlv, Vmax,
Dmax] tensors); the port reads the same edges, in the same order, from the
compiled plan's per-edge view (:func:`stage_segment`: the in-edge lists
and their records, no indicator), and runs every level in one launch of
:func:`~repro_torch.kernels.maxplus.segment_levels_f64`, which forms the
edge weights itself, all G graphs of a packed plan in the same launch
(:func:`segment_forward`, :func:`segment_forward_multi`); λ is one walk
for all G graphs.

Lanes.  The candidate-cost axis K and the structure-variant axis B run as
lanes of the packed forwards (the reference's ``_segment_core_axes`` /
``_dense_core_axes``, ``engine.py:348-376``, ``:517-544``, as vmaps):
lane y = s·K + k is structure s (a packed graph, a structure variant
staged as one graph of a packed plan, or one plan as a packed plan of one
graph, :func:`packed_view`) under cost block k (:class:`Lanes`,
:func:`stage_lanes`).  A structure owns its lists, records and scenarios,
a lane its edge constants and its state and, where a cost batch varies
them, its gap shares, gap classes and latency rows (the kernels then read
those of lane y, the rest of structure y / K), and the level loop's and
the walk's kernels place the lanes on ``blockIdx.y``, so one launch and
one walk run every lane, each equal to a solo forward of its rebuilt plan
bit for bit; the K lanes of a structure share one sink pass.

Sparse.  A :class:`~repro_torch.sweep.compile.SparsePlan` is walked level
by level (:func:`stage_sparse`; memory is O(nv + ne) per scenario).  Each
flavour runs every level of a weight chunk in one launch of its level-loop
kernel: :func:`~repro_torch.kernels.maxplus.sparse_levels_f64` for the
float64 flavour (:func:`sparse_forward_f64`),
:func:`~repro_torch.kernels.maxplus.sparse_levels_f32` for the float32 one
(:func:`sparse_forward_f32`).  Both end in one launch of the backtrace
walk, :func:`~repro_torch.kernels.maxplus.sparse_backtrace`.

Sharding.  :func:`split_forward` runs one forward as equal contiguous
chunks of one axis over a list of devices, one forward a chunk, and
gathers T and λ in order (the reference's ``shard_map``, ``engine.py:
1078-1114``); :func:`_resolve_shard` turns a ``shard=`` request into a
device count that divides the axis, :func:`graph_slice` gives a G
chunk's arrays.

Also here: :func:`tolerance_batched`, the lockstep-batched bisection of
``core.dag.tolerance`` (reference: ``engine.py:1476-1515``), and
:func:`breakpoints_batched`, ``core.dag.breakpoints`` flattened level by
level (reference: ``engine.py:1518-1547``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.loggps import LogGPS
from repro_torch.kernels.maxplus import (dense_levels_f32, segment_levels_f64,
                                         sparse_backtrace, sparse_levels_f32,
                                         sparse_levels_f64)
from repro_torch.kernels.maxplus.ref import _weights

from .compile import NEG_INF, CompiledPlan, MultiPlan, SparsePlan
from .scenarios import latency_grid

BIG = -NEG_INF
ATOL = 1e-12          # the scalar engine's tie tolerance (dag.LevelPlan)


@dataclasses.dataclass
class DenseArrays:
    """A plan's tensors staged on one device for the dense forward: the
    float32 indicator of the kernels' plain versions, the real in-edge
    lists the level-loop kernel reads, and the edge and vertex costs in
    float64, in which end times are carried."""

    A: torch.Tensor             # [nlv, Vmax, Emax] f32 0/−1e30 indicator
    esrc: torch.Tensor          # [nlv, Emax] int64 flat source slot
    emask: torch.Tensor         # [nlv, Emax] bool
    econst: torch.Tensor        # [nlv, Emax] f64
    egap: torch.Tensor          # [nlv, Emax] f64
    egclass: torch.Tensor       # [nlv, Emax] int64
    elat: torch.Tensor          # [nlv, Emax, nc] f64
    elat_sum: torch.Tensor      # [nlv, Emax] f32 tie-key slopes
    vcost_lv: torch.Tensor      # [nlv, Vmax] f64
    valid_flat: torch.Tensor    # [nflat] bool
    vert_of_slot: torch.Tensor  # [nflat] int32
    # the level loop's lists (in_edge_lists): level lv's rows with a real
    # in-edge or a vertex cost are rows[lv_ptr[lv]:lv_ptr[lv+1]], row q's
    # in-edges in_edges[row_ptr[q]:row_ptr[q+1]] as (flat edge id, flat
    # source row)
    lv_ptr: torch.Tensor        # [nlv + 1] int32
    rows: torch.Tensor          # [NR] int32 flat row
    row_ptr: torch.Tensor       # [NR + 1] int32
    in_edges: torch.Tensor      # [NE, 2] int32


def _put(a, device, dtype) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:         # a broadcast view of a batch field
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def in_edge_lists(esrc, edstl, emask, vcost_lv):
    """(lv_ptr, rows, row_ptr, in_edges) of one plan's [nlv_p, Emax] edge
    view, numpy int32: the rows with a real in-edge or a nonzero vertex
    cost (every other row ends as the fresh state: t 0, ssum 0, cho −1),
    level by level in increasing flat row ``lv·Vmax + edstl``, and each
    one's real in-edges in increasing slot j as (flat edge id ``lv·Emax +
    j``, flat source row ``esrc``); a row with no in-edge has an empty run.
    Each list holds at least one entry, so a plan with no row still stages
    non-empty tensors."""
    nlv_p, Emax = esrc.shape
    Vmax = vcost_lv.shape[1]
    lv, j = np.nonzero(emask)                       # by level, then slot
    row = lv.astype(np.int64) * Vmax + edstl[lv, j]
    order = np.argsort(row, kind="stable")          # by row, then slot
    row = row[order]
    in_edges = np.stack([(lv * Emax + j)[order], esrc[lv, j][order]], 1)
    rows = np.union1d(row, np.flatnonzero(vcost_lv))
    row_ptr = np.append(np.searchsorted(row, rows), row.shape[0])
    lv_ptr = np.searchsorted(rows // Vmax, np.arange(nlv_p + 1))
    if rows.shape[0] == 0:
        rows, row_ptr = np.zeros(1), np.zeros(2)
    if row.shape[0] == 0:
        in_edges = np.zeros((1, 2))
    return tuple(a.astype(np.int32) for a in (lv_ptr, rows, row_ptr,
                                               in_edges))


def _stack_lists(per: list, solo: bool, device, dtypes) -> tuple:
    """Lists of one graph (``solo``: ``per`` holds one tuple of numpy
    arrays) or of G graphs (one tuple a graph) on ``device`` in ``dtypes``:
    each list padded with its graph's own last entry to the longest
    graph's (a padded entry lies past its graph's ``lv_ptr[-1]``, so no
    level reads it) and stacked on a leading graph axis."""
    if solo:
        return tuple(_put(a, device, dt) for a, dt in zip(per[0], dtypes))

    def padded(i):
        n = max(p[i].shape[0] for p in per)
        return _put(np.stack([np.concatenate(
            [p[i], np.repeat(p[i][-1:], n - p[i].shape[0], 0)])
            for p in per]), device, dtypes[i])

    return tuple(padded(i) for i in range(len(dtypes)))


def _graphs(*views) -> list:
    """The per-graph tuples of one plan's views ([nlv_p, ...] arrays) or of
    a packed plan's ([G, nlv_p, ...])."""
    return [views] if views[0].ndim == 2 else list(zip(*views))


def staged_lists(esrc, edstl, emask, vcost_lv, device) -> tuple:
    """(lv_ptr, rows, row_ptr, in_edges), int32 on ``device``: the
    :func:`in_edge_lists` of one plan's [nlv_p, Emax] edge view, or of each
    graph of a packed [G, nlv_p, Emax] view (:func:`_stack_lists`)."""
    return _stack_lists([in_edge_lists(*v) for v in _graphs(
        esrc, edstl, emask, vcost_lv)], esrc.ndim == 2, device,
        (torch.int32,) * 4)


def segment_lists(esrc, edstl, emask, vcost_lv, econst, egap, egclass,
                  elat):
    """(lv_ptr, rows, row_ptr, in_edges, erec, rcost) of one plan's [nlv_p,
    Emax] edge view, numpy: :func:`in_edge_lists`' lists with each listed
    edge's records in list order, so a level's edges are one contiguous run
    — in_edges [NE, 4] int32 (flat edge id, flat source row, the source's
    listed row or −1, gap class) and erec [NE, 3 + nc] f64 (econst, egap,
    elat_sum, the elat row) — and each listed row's vertex cost, rcost
    [NR] f64."""
    lv_ptr, rows, row_ptr, ie = in_edge_lists(esrc, edstl, emask, vcost_lv)
    Emax = esrc.shape[1]
    lv, j = ie[:, 0] // Emax, ie[:, 0] % Emax
    q = np.searchsorted(rows, ie[:, 1])
    listed = rows[np.minimum(q, rows.shape[0] - 1)] == ie[:, 1]
    in_edges = np.stack([ie[:, 0], ie[:, 1], np.where(listed, q, -1),
                         egclass[lv, j]], 1).astype(np.int32)
    erec = np.concatenate([econst[lv, j, None], egap[lv, j, None],
                           elat.sum(-1)[lv, j, None], elat[lv, j]], 1)
    return lv_ptr, rows, row_ptr, in_edges, erec, vcost_lv.reshape(-1)[rows]


def stage(plan: CompiledPlan, device: torch.device) -> DenseArrays:
    f64, i64 = torch.float64, torch.int64
    lists = staged_lists(plan.esrc, plan.edstl, plan.emask, plan.vcost_lv,
                         device)
    elat = _put(plan.elat, device, f64)
    return DenseArrays(
        A=_put(plan.dense_indicator(NEG_INF), device, torch.float32),
        esrc=_put(plan.esrc, device, i64),
        emask=_put(plan.emask, device, torch.bool),
        econst=_put(plan.econst, device, f64),
        egap=_put(plan.egap, device, f64),
        egclass=_put(plan.egclass, device, i64),
        elat=elat, elat_sum=elat.sum(-1).float(),
        vcost_lv=_put(plan.vcost_lv, device, f64),
        valid_flat=_put(plan.valid_flat, device, torch.bool),
        vert_of_slot=_put(plan.vert_of_slot, device, torch.int32),
        **dict(zip(("lv_ptr", "rows", "row_ptr", "in_edges"), lists)))


def edge_weights(d: DenseArrays, Lmat: torch.Tensor,
                 GSmat: torch.Tensor) -> torch.Tensor:
    """[nlv, Emax, S] f64 edge weights of every level at one go
    (:func:`_weights`).  Elementwise, so each weight is the op sequence a
    per-level evaluation would do.

    Masked (pad) slots get −1e30: a pad slot's source is the scratch slot,
    whose end time stays 0, so ``t_end[src] + w`` is exactly the −1e30 the
    reference writes with ``where(emask, cand, −BIG)`` (the plain version
    reads them; the kernel reads only real edges)."""
    w = _weights(d.egclass, d.egap, d.econst, d.elat, Lmat, GSmat)
    return w.masked_fill_(~d.emask[..., None], -BIG)


def _state(lead: tuple, S: int, want_lam: bool, dev,
           key_dtype: torch.dtype = torch.float32):
    """(t_end, ssum, cho, csrc) of a fresh forward: zeros, zeros (tie keys
    in ``key_dtype``), −1, −1 (ssum, cho and csrc None in values mode).
    The level loops record each chosen edge's source row in csrc, for the
    walk."""
    t = torch.zeros(lead + (S,), dtype=torch.float64, device=dev)
    if not want_lam:
        return t, None, None, None
    cho = torch.full(lead + (S,), -1, dtype=torch.int32, device=dev)
    return (t, torch.zeros(lead + (S,), dtype=key_dtype, device=dev), cho,
            torch.full_like(cho, -1))


def dense_forward(d: DenseArrays, Lmat: torch.Tensor, GSmat: torch.Tensor,
                  want_lam: bool):
    """Lmat/GSmat [S, nc] f64 → (T [S] f64, λ [S, nc] f64 or None): the
    edge weights, one launch of the level loop over all ``nlv_p`` levels,
    the sink, and in a λ run one walk.

    The kernels decide every maximum and every λ tie on float32
    candidates, as the reference's do; end times are carried in float64
    and each level's value is the float64 maximum, where the reference
    stores the kernel's float32 maximum.  Rounding t to float32 at every
    level accumulates along the critical path: on the 5,050-level
    allreduce of ``chip_smoke.py`` phase 7 (which measures it) T drifts
    beyond the 1e-5 contract."""
    nlv = d.vcost_lv.shape[0]
    S = Lmat.shape[0]
    w = edge_weights(d, Lmat, GSmat)
    valid = d.valid_flat.nonzero()[:, 0]
    t_end, ssum, cho, csrc = _state(d.valid_flat.shape, S, want_lam,
                                    Lmat.device)
    dense_forward.runs["lam" if want_lam else "values"] += 1
    dense_levels_f32(t_end, ssum, cho, w, d.A, d.esrc, d.lv_ptr, d.rows,
                     d.row_ptr, d.in_edges, d.elat_sum, d.vcost_lv, csrc)
    if not want_lam:
        return t_end[valid].amax(0), None
    T, vsel = _dense_sink(t_end, ssum, valid, d.valid_flat, d.vert_of_slot)
    return T, sparse_backtrace(vsel, cho, csrc,
                               d.elat.view(-1, d.elat.shape[2]), nlv)


#: forwards run, by kind ("values" / "lam"): with the kernels' launch
#: counts, shows one level-loop launch a forward and one walk a λ forward
dense_forward.runs = collections.Counter()


def _dense_sink(t_end, ssum, valid, valid_flat, vert_of_slot,
                atol: float = 0.0):
    """(T [..., S], the sink's flat slot [..., S]) of one graph, t_end and
    ssum [..., nflat, S]: no lead, or the K lanes of one structure, which
    share its valid slots and vertex ids.  The sink is the latest-ending
    valid vertex (within ``atol``: exact for the dense forward, ATOL for
    the segment forward, reference ``engine.py:618-623``, ``:253-262``),
    ties → larger slope sum, then smaller original vertex id.  The ties are
    decided on the (lane, slot, scenario) triples within ``atol`` of T, a
    few a scenario, so no [nflat, S] temporary but a boolean one is made
    (the packed segment forward's peak memory is the state and the sink's
    temporaries), and the K lanes take one pass (one host sync); maxima
    and minima are exact, so the choice is the whole-array rule's."""
    T = t_end.index_select(-2, valid).amax(-2)
    nflat, S = t_end.shape[-2:]
    T2 = T.reshape(-1, S)
    y, slot, k = (valid_flat[:, None] & (
        t_end.reshape(-1, nflat, S) >= (T2 - atol)[:, None])).nonzero(
        as_tuple=True)
    col = y * S + k                   # the (lane, scenario) of each triple
    s = ssum.reshape(-1, nflat, S)[y, slot, k]
    n = T2.numel()
    mx = torch.full((n,), -BIG, dtype=s.dtype, device=s.device)
    mx.scatter_reduce_(0, col, s, "amax")
    none = torch.iinfo(torch.int32).max
    vid = torch.where(s >= mx[col], vert_of_slot[slot], none)
    best = torch.full((n,), none, dtype=vid.dtype, device=vid.device)
    best.scatter_reduce_(0, col, vid, "amin")
    # one triple a (lane, scenario) holds its best id: valid slots' ids
    # are unique
    vsel = torch.full((n,), -1, dtype=torch.int64, device=T.device)
    vsel.scatter_reduce_(0, col, torch.where(vid == best[col], slot, -1),
                         "amax")
    return T, vsel.view(T.shape)


# -- packed multi-graph forward -----------------------------------------------


@dataclasses.dataclass
class MultiArrays:
    """A :class:`MultiPlan` staged on one device for the packed forward:
    the fields of :class:`DenseArrays` with a leading graph axis, but for
    the indicator, which is level-major (one level of all G graphs is one
    contiguous slice).  The in-edge lists are padded to the longest
    graph's."""

    A: torch.Tensor             # [nlv, G, Vmax, Emax] f32 0/−1e30 indicator
    esrc: torch.Tensor          # [G, nlv, Emax] int64 flat source slot
    emask: torch.Tensor         # [G, nlv, Emax] bool
    econst: torch.Tensor        # [G, nlv, Emax] f64
    egap: torch.Tensor          # [G, nlv, Emax] f64
    egclass: torch.Tensor       # [G, nlv, Emax] int64
    elat: torch.Tensor          # [G, nlv, Emax, nc] f64
    elat_sum: torch.Tensor      # [G, nlv, Emax] f32
    vcost_lv: torch.Tensor      # [G, nlv, Vmax] f64
    valid_flat: torch.Tensor    # [G, nflat] bool
    vert_of_slot: torch.Tensor  # [G, nflat] int32
    lv_ptr: torch.Tensor        # [G, nlv + 1] int32
    rows: torch.Tensor          # [G, NR] int32
    row_ptr: torch.Tensor       # [G, NR + 1] int32
    in_edges: torch.Tensor      # [G, NE, 2] int32
    valid: list                 # G index tensors of each graph's valid slots
    nlevels: np.ndarray         # [G] real levels per graph


def stage_multi(mp: MultiPlan, device: torch.device) -> MultiArrays:
    """Stage ``mp`` as :func:`stage` stages one plan.  The indicator is laid
    out on the device itself, level-major."""
    f64, i64 = torch.float64, torch.int64
    G, nlv, Emax = mp.esrc.shape
    Vmax = mp.Vmax
    A = torch.full((nlv, G, Vmax, Emax), NEG_INF, dtype=torch.float32,
                   device=device)
    gi, lv, sl = np.nonzero(mp.emask)
    A[_put(lv, device, i64), _put(gi, device, i64),
      _put(mp.edstl[gi, lv, sl], device, i64), _put(sl, device, i64)] = 0.0
    lists = staged_lists(mp.esrc, mp.edstl, mp.emask, mp.vcost_lv, device)
    elat = _put(mp.elat, device, f64)
    valid_flat = _put(mp.valid_flat, device, torch.bool)
    return MultiArrays(
        A=A, esrc=_put(mp.esrc, device, i64),
        emask=_put(mp.emask, device, torch.bool),
        econst=_put(mp.econst, device, f64), egap=_put(mp.egap, device, f64),
        egclass=_put(mp.egclass, device, i64),
        elat=elat, elat_sum=elat.sum(-1).float(),
        vcost_lv=_put(mp.vcost_lv, device, f64),
        valid_flat=valid_flat,
        vert_of_slot=_put(mp.vert_of_slot, device, torch.int32),
        **dict(zip(("lv_ptr", "rows", "row_ptr", "in_edges"), lists)),
        valid=[v.nonzero()[:, 0] for v in valid_flat],
        nlevels=np.asarray(mp.nlevels, dtype=np.int64))


def multi_weights(d: MultiArrays, Lmat: torch.Tensor, GSmat: torch.Tensor,
                  nlv: int, lanes: Optional["Lanes"] = None) -> torch.Tensor:
    """[L, nlv, Emax, S] f64 edge weights of the first ``nlv`` levels of
    every lane, graph g's lanes from its own scenario batch (Lmat/GSmat
    [G, S, nc]) and each lane's own edge constants and the fields it owns
    (``lanes``; without, one lane a graph with the graph's), pad slots
    −1e30, as
    :func:`edge_weights` of each graph.  One :func:`_weights` a graph, the
    K lanes of a graph in it: the kernel count does not grow with K."""
    G, _, Emax = d.esrc.shape
    K = 1 if lanes is None else lanes.K
    w = torch.empty((G, K, nlv, Emax, Lmat.shape[1]), dtype=torch.float64,
                    device=Lmat.device)
    for g in range(G):
        def f(name):
            own = None if lanes is None else getattr(lanes, name)
            return (getattr(d, name)[g, :nlv] if own is None
                    else own[g * K:(g + 1) * K, :nlv])

        w[g] = _weights(f("egclass"), f("egap"), f("econst"), f("elat"),
                        Lmat[g], GSmat[g])
    w.masked_fill_(~d.emask[:, None, :nlv, :, None], -BIG)
    return w.view((G * K,) + w.shape[2:])


def _lane_max(t: torch.Tensor, valid: list, K: int) -> torch.Tensor:
    """[L, S]: each lane's latest end over its structure's valid slots,
    one reduction a structure (its K lanes together)."""
    return torch.cat([t[g * K:(g + 1) * K].index_select(1, v).amax(1)
                      for g, v in enumerate(valid)])


def dense_forward_multi(d: MultiArrays, Lmat: torch.Tensor,
                        GSmat: torch.Tensor, want_lam: bool,
                        nlv: Optional[int] = None,
                        lanes: Optional["Lanes"] = None):
    """The packed forward: Lmat/GSmat [G, S, nc] f64, one scenario batch per
    graph → (T [G, S] f64, λ [G, S, nc] f64 or None); with ``lanes``, K
    cost lanes of each graph, (T [G·K, S], λ [G·K, S, nc]), lane g·K + k
    graph g under cost block k.

    One launch of :func:`~repro_torch.kernels.maxplus.dense_levels_f32`
    runs the level loop of all G graphs (graph g on its own blocks, its own
    pointers), and a λ run walks every graph's chosen edges in one launch
    of :func:`~repro_torch.kernels.maxplus.sparse_backtrace`.  Graph g's
    edge weights are :func:`_weights` of its own batch, elementwise as in
    the solo forward (the reference's ``einsum`` sums the classes in its
    own order), so each graph's T and λ equal its solo
    :func:`dense_forward` bit for bit.

    The reference walks all ``nlv_p`` levels; levels past a graph's own
    ``nlevels`` only write zeros to its invalid slots, so ``nlv`` defaults
    to the largest ``nlevels`` of the G graphs (tested identical both
    ways)."""
    nlv = int(d.nlevels.max()) if nlv is None else nlv
    G, nflat = d.valid_flat.shape
    K = 1 if lanes is None else lanes.K
    S = Lmat.shape[1]
    w = multi_weights(d, Lmat, GSmat, nlv, lanes)
    t_end, ssum, cho, csrc = _state((G * K, nflat), S, want_lam,
                                    Lmat.device)
    dense_forward_multi.runs["lam" if want_lam else "values"] += 1
    elat_sum = d.elat_sum if lanes is None else lanes.field(d, "elat_sum")
    dense_levels_f32(t_end, ssum, cho, w, d.A, d.esrc, d.lv_ptr, d.rows,
                     d.row_ptr, d.in_edges, elat_sum, d.vcost_lv, csrc)
    del w
    if not want_lam:
        return _lane_max(t_end, d.valid, K), None
    return _packed_walk(t_end, ssum, cho, csrc, d, nlv, 0.0, K, lanes)


def _packed_walk(t_end, ssum, cho, csrc, d, nlv: int, atol: float,
                 K: int = 1, lanes: Optional["Lanes"] = None):
    """(T [L, S], λ [L, S, nc]) of a packed λ forward of L = G·K lanes:
    each graph's sink over its K lanes (:func:`_dense_sink`, one pass a
    graph), then one walk for all L lanes, down each structure's latency
    rows or, where ``lanes`` own theirs, each lane's."""
    L, _, S = t_end.shape
    T = torch.empty((L, S), dtype=torch.float64, device=t_end.device)
    vsel = torch.empty((L, S), dtype=torch.int64, device=t_end.device)
    for g, v in enumerate(d.valid):
        y = slice(g * K, (g + 1) * K)
        T[y], vsel[y] = _dense_sink(t_end[y], ssum[y], v, d.valid_flat[g],
                                    d.vert_of_slot[g], atol)
    elat = d.elat if lanes is None else lanes.field(d, "elat")
    return T, sparse_backtrace(vsel, cho, csrc,
                               elat.reshape(elat.shape[0], -1,
                                            elat.shape[-1]), nlv)


#: forwards run, by kind ("values" / "lam"): with the kernels' launch
#: counts, shows one level-loop launch a forward for all G graphs and one
#: walk a λ forward
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

    dtype: torch.dtype          # flavour: float64 / float32
    esrc: torch.Tensor          # [ne_p] int64 compact source slot
    econst: torch.Tensor        # [ne_p] f64
    egap: torch.Tensor          # [ne_p] f64
    egclass: torch.Tensor       # [ne_p] int64
    elat: torch.Tensor          # [ne_p, nc] f64
    elat_sum: torch.Tensor      # [ne_p] tie-key slopes, in the flavour dtype
    vcost: torch.Tensor         # [nv_p] f64
    vert_of_slot: torch.Tensor  # [nv_p] int32
    dloc: torch.Tensor          # [nlv_p, E_pad] window-local destination row
    # the level-loop kernels': level lv's rows are v_ptr_dev[lv]..
    # v_ptr_dev[lv+1]-1, row r's in-edges row_ptr[r]..row_ptr[r+1]-1, both
    # int32 on the device
    v_ptr_dev: torch.Tensor     # [nlv_p + 1] int32
    row_ptr: torch.Tensor       # [nv_p + 1] int32
    level_ptr: np.ndarray       # [nlv_p + 1] int64 (host: slices need ints)
    v_ptr: np.ndarray           # [nlv_p + 1] int64
    nv: int
    nlevels: int
    Emax_lv: int
    Vmax_lv: int


def stage_sparse(plan: SparsePlan, device: torch.device,
                 dtype: torch.dtype) -> SparseArrays:
    """Stage ``plan`` for the float64 or the float32 flavour.

    Both flavours rely on the plan's layout, checked here: each level's
    edges are unmasked, land in the level's own rows and are sorted by
    destination (``compile_sparse`` sorts them so), so a row's in-edges
    are one run of increasing edge index.

    Both flavours stage the level and row pointers on the device, for the
    level-loop kernels, which read only each level's own edges and write
    only their own rows.

    Window-local destinations are also computed here once for every level,
    the reference's windows: ``dloc[lv, j] = edst[level_ptr[lv] + j] −
    v_ptr[lv]``.  The reference hands out-of-range ids to ``segment_max``
    (which drops them) or to the kernel as rows ≥ M (which never hit);
    ``scatter_reduce`` raises on them instead.  So every window slot that
    cannot land in the level's rows — pad and masked edges, edges of later
    levels whose row falls outside the window, and the E_pad padding — is
    routed to a trash row: row ``Vmax_lv`` in the float64 staging (the
    scatter buffers of a per-level segment max), row ``M_pad`` (≥ M, never
    hit) for the slot-list kernel.  Edges of later levels whose row falls inside the window are
    kept, as in the reference: they write rows of later levels, which
    those levels overwrite before anything reads them.  No forward reads
    the windows since both level loops became kernels; they are the
    reference's input to the standalone slot-list kernel."""
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
    return SparseArrays(
        dtype=dtype,
        esrc=put(plan.esrc_slot, torch.int64),
        econst=put(plan.econst, f64), egap=put(plan.egap, f64),
        egclass=put(plan.egclass, torch.int64), elat=put(plan.elat, f64),
        elat_sum=put(plan.elat_sum, dtype),
        vcost=put(plan.vcost, f64),
        vert_of_slot=put(plan.vert_of_slot, torch.int32),
        dloc=put(dloc, torch.int32 if dtype == torch.float32
                 else torch.int64),
        v_ptr_dev=put(vp, torch.int32),
        row_ptr=put(lp[0] + np.searchsorted(dst, np.arange(nv_p + 1)),
                    torch.int32),
        level_ptr=lp, v_ptr=vp, nv=plan.nv, nlevels=nl, Emax_lv=E,
        Vmax_lv=V)


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


def sparse_forward_f64(a: SparseArrays, Lmat: torch.Tensor,
                       GSmat: torch.Tensor, want_lam: bool,
                       nlv: Optional[int] = None):
    """The float64 slot-list forward, the port of the reference's
    ``_make_sparse_one`` (``engine.py:749-851``; the reference has no
    kernel here).  Lmat/GSmat [S, nc] f64 → (T [S] f64, λ [S, nc] f64 or
    None).  Every level of a weight chunk (:func:`weight_chunks`) runs in
    one launch of :func:`~repro_torch.kernels.maxplus.sparse_levels_f64`,
    which reads only each level's own edges and writes only its own rows.

    Each level: candidates ``t[src] + w``, their max into each row (−inf
    for a row with no in-edge, as ``segment_max`` seeds empty segments),
    then ``max(seg, 0)`` (reference ``:793-794``).  λ keeps the scalar
    engine's ATOL = 1e-12 tie rules in its order (``:812-818``): value
    hits within ATOL of the level max, the largest cumulative slope within
    ATOL, then the largest edge index.  Same float64 ops as ``core.dag``,
    so T, λ and ρ are bit-identical to it.

    The reference walks all ``nlv_p`` levels; the padded ones touch only
    pad slots, so ``nlv`` defaults to the plan's real ``nlevels`` (tested
    bit-identical both ways)."""
    nlv = a.nlevels if nlv is None else nlv
    S = Lmat.shape[0]
    nv_p = a.vcost.shape[0]
    t, ssum, cho, csrc = _state((nv_p,), S, want_lam, Lmat.device,
                                torch.float64)
    sparse_forward_f64.runs["lam" if want_lam else "values"] += 1
    sparse_forward_f64.widths[S] += 1
    for lv0, lv1, base, w in _chunk_weights(a, Lmat, GSmat, nlv):
        sparse_levels_f64(t, ssum, cho, w.contiguous(), base, a.esrc,
                          a.row_ptr, a.v_ptr_dev, a.elat_sum, a.vcost, lv0,
                          lv1, csrc)
    return _sink_and_backtrace(a, t, ssum, cho, csrc, ATOL, nlv)


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
    t, ssum, cho, csrc = _state((nv_p,), S, want_lam, Lmat.device)
    sparse_forward_f32.runs["lam" if want_lam else "values"] += 1
    sparse_forward_f32.widths[S] += 1
    for lv0, lv1, base, w in _chunk_weights(a, Lmat, GSmat, nlv):
        sparse_levels_f32(t, ssum, cho, w.contiguous(), base, a.esrc,
                          a.row_ptr, a.v_ptr_dev, a.elat_sum, a.vcost, lv0,
                          lv1, csrc)
    return _sink_and_backtrace(a, t, ssum, cho, csrc, 0.0, nlv)


def _sink_and_backtrace(a: SparseArrays, t, ssum, cho, csrc,
                        sink_atol: float, nlv: int):
    """T, and λ by the critical-path backtrace when ``ssum``/``cho`` were
    recorded (reference ``engine.py:834-850``, ``:979-993``).

    The sink is the latest-ending valid vertex (within ``sink_atol``:
    ATOL for float64, exact for float32), ties → larger slope sum, then
    smaller original vertex id.  ``cho`` holds each vertex's chosen in-edge
    (−1: none) and ``csrc`` its source;
    :func:`~repro_torch.kernels.maxplus.sparse_backtrace` walks from the
    sink down the chosen edges to their sources, for at
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
    return T, sparse_backtrace(vsel, cho[:nv], csrc[:nv], a.elat, nlv)


#: forwards run, by kind ("values" / "lam"), per flavour
sparse_forward_f64.runs = collections.Counter()
sparse_forward_f32.runs = collections.Counter()
#: forwards run, by scenario width S, per flavour: with
#: :func:`weight_chunks`, gives the level-loop launches
sparse_forward_f64.widths = collections.Counter()
sparse_forward_f32.widths = collections.Counter()


# -- segment forward (float64, solo and packed) ------------------------------


@dataclasses.dataclass
class SegmentArrays:
    """A :class:`CompiledPlan` staged for the segment forward, or a
    :class:`MultiPlan` with a leading graph axis on every tensor: the
    per-edge view (costs and slope sums in float64, edge destinations),
    which the level loop's plain version reads, and the real in-edge lists
    with their records in list order (:func:`segment_lists`), which its
    kernel reads.  No indicator and no weights: the segment forward never
    reads the one, and the level loop forms the others."""

    esrc: torch.Tensor          # [G?, nlv, Emax] int64 flat source row
    edst: torch.Tensor          # [G?, nlv, Emax] int64 level-local dst (pad Vmax)
    econst: torch.Tensor        # [G?, nlv, Emax] f64
    egap: torch.Tensor          # [G?, nlv, Emax] f64
    egclass: torch.Tensor       # [G?, nlv, Emax] int64
    elat: torch.Tensor          # [G?, nlv, Emax, nc] f64
    elat_sum: torch.Tensor      # [G?, nlv, Emax] f64 tie-key slopes
    vcost_lv: torch.Tensor      # [G?, nlv, Vmax] f64
    valid_flat: torch.Tensor    # [G?, nflat] bool
    vert_of_slot: torch.Tensor  # [G?, nflat] int32
    lv_ptr: torch.Tensor        # [G?, nlv + 1] int32 (segment_lists)
    rows: torch.Tensor          # [G?, NR] int32
    row_ptr: torch.Tensor       # [G?, NR + 1] int32
    in_edges: torch.Tensor      # [G?, NE, 4] int32 (segment_lists)
    erec: torch.Tensor          # [G?, NE, 3 + nc] f64
    rcost: torch.Tensor         # [G?, NR] f64
    valid: list                 # each graph's valid slots (one, solo)
    nlevels: np.ndarray         # [G] real levels per graph ([1], solo)
    links: Optional["Links"] = None   # a solo plan's (stage_links)


@dataclasses.dataclass
class Links:
    """A plan's physical links staged for the congestion fixed point: each
    edge's link for the level loop (``elink`` per-edge view for its plain
    version, ``in_link`` in list order for its kernel, both with the
    structure's leading axis where the arrays have one), each link's class
    (``cls`` [nl1] int64, the dummy bin's 0), and the message edges in the
    order the offered load adds them (:func:`link_busy`)."""

    nlinks: int
    elink: torch.Tensor         # [G?, nlv, Emax] int64 (dummy bin nlinks)
    in_link: torch.Tensor       # [G?, NE] int32
    cls: torch.Tensor           # [nlinks + 1] int64
    order: torch.Tensor         # [n_msg] int64 list positions, by step
    order_link: torch.Tensor    # [n_msg] int64 their links
    steps: list                 # [maxdeg + 1] step offsets into order


def stage_links(plan: CompiledPlan, a: "SegmentArrays") -> Links:
    """The :class:`Links` of one compiled plan, staged beside its segment
    arrays ``a`` (:func:`stage_segment`, no graph axis) for the congestion
    fixed point (the reference's ``kind="congestion"``, ``:1043-1060``);
    the caller keeps them as ``a.links``.  The offered load sums each
    link's edges in list order (level, row, slot: the reference's ravel
    order of its [nlv, Vmax, Dmax] vertex view, ``engine.py:428-429``), one
    addend a link a step: step d adds every link's d-th edge, so each
    link's sum is one left fold in that order, deterministic and the same
    bits on the card and the CPU."""
    if not isinstance(plan, CompiledPlan) or a.in_edges.dim() != 2:
        raise ValueError("the congestion fixed point stages one compiled "
                         "plan (no graph axis)")
    if plan.elinkp is None:
        raise ValueError(
            "congestion needs per-edge link ids, but this plan carries none "
            "(the graph was built without link interning — use "
            "GraphBuilder.add_message / intern_link, or recompile from a "
            "graph with elink populated)")
    nl = int(plan.nlinks)
    device = a.erec.device
    in_edges = a.in_edges.cpu().numpy()
    link = plan.elinkp.reshape(-1)[in_edges[:, 0]].astype(np.int64)
    # the dummy bin's edges (dependencies) carry no gap.  A link's edges
    # are listed whatever their gap: a lane may own gap shares that its
    # structure's records lack, and an edge of gap 0 adds +0.0, which
    # changes no sum
    msg = np.flatnonzero(link < nl)
    by_link = msg[np.argsort(link[msg], kind="stable")]
    lk = link[by_link]
    first = np.searchsorted(lk, lk)                 # each link's first edge
    rank = np.arange(lk.shape[0]) - first           # its place in the fold
    step = np.argsort(rank, kind="stable")
    counts = np.bincount(rank, minlength=1)
    cls = np.zeros(nl + 1, dtype=np.int64)
    if plan.link_classes is not None:
        cls[:nl] = plan.link_classes[:nl]
    elink = np.where(plan.emask, plan.elinkp, nl)
    return Links(
        nlinks=nl, elink=_put(elink, device, torch.int64),
        in_link=_put(link, device, torch.int32),
        cls=_put(cls, device, torch.int64),
        order=_put(by_link[step], device, torch.int64),
        order_link=_put(lk[step], device, torch.int64),
        steps=[0] + np.cumsum(counts[counts > 0]).tolist())


def stage_segment(plan, device: torch.device) -> SegmentArrays:
    """Stage a :class:`CompiledPlan` or a :class:`MultiPlan` for the segment
    forward (the reference's ``_stage_arrays(kind="segment")``,
    ``engine.py:1028-1037``, on the per-edge view).  The slope sums are
    ``elat.sum(-1)`` in float64, as the reference's ``vlat_sum``."""
    f64, i64 = torch.float64, torch.int64
    lists = _stack_lists([segment_lists(*v) for v in _graphs(
        plan.esrc, plan.edstl, plan.emask, plan.vcost_lv, plan.econst,
        plan.egap, plan.egclass, plan.elat)], plan.esrc.ndim == 2, device,
        (torch.int32,) * 4 + (f64, f64))
    valid_flat = _put(plan.valid_flat, device, torch.bool)
    return SegmentArrays(
        esrc=_put(plan.esrc, device, i64),
        edst=_put(np.where(plan.emask, plan.edstl, plan.Vmax), device, i64),
        econst=_put(plan.econst, device, f64),
        egap=_put(plan.egap, device, f64),
        egclass=_put(plan.egclass, device, i64),
        elat=_put(plan.elat, device, f64),
        elat_sum=_put(plan.elat.sum(-1), device, f64),
        vcost_lv=_put(plan.vcost_lv, device, f64),
        valid_flat=valid_flat,
        vert_of_slot=_put(plan.vert_of_slot, device, torch.int32),
        **dict(zip(("lv_ptr", "rows", "row_ptr", "in_edges", "erec",
                    "rcost"), lists)),
        valid=[v.nonzero()[:, 0] for v in valid_flat.view(
            -1, valid_flat.shape[-1])],
        nlevels=np.atleast_1d(np.asarray(plan.nlevels, dtype=np.int64)))


def segment_inputs(a: SegmentArrays, lanes: Optional["Lanes"] = None
                   ) -> tuple:
    """The tensors :func:`~repro_torch.kernels.maxplus.segment_levels_f64`
    takes after Lmat and GSmat: the per-edge view its plain version reads,
    then the lists its kernel reads; with ``lanes``, each lane's edge
    constants and records, and the fields it owns, in place of the
    structures'."""
    if lanes is None:
        return (a.edst, a.esrc, a.econst, a.egap, a.egclass, a.elat,
                a.elat_sum, a.vcost_lv, a.lv_ptr, a.rows, a.row_ptr,
                a.in_edges, a.erec, a.rcost)
    f = functools.partial(lanes.field, a)
    return (a.edst, a.esrc, lanes.econst, f("egap"), f("egclass"),
            f("elat"), f("elat_sum"), a.vcost_lv, a.lv_ptr, a.rows,
            a.row_ptr, f("in_edges"), lanes.erec, a.rcost)


def _segment_levels(a: SegmentArrays, Lmat, GSmat, want_lam: bool,
                    nlv: int, lanes: Optional["Lanes"] = None, ls=None,
                    t=None):
    """The level loop of the segment forward: levels ``0..nlv-1`` in one
    launch of :func:`~repro_torch.kernels.maxplus.segment_levels_f64`, which
    forms the edge weights itself from Lmat and GSmat ([S, nc] / [S, ngc],
    or [G, S, ·] packed), over K lanes a graph with ``lanes``, each edge's
    gap scale times its link's scale in ``ls`` (the congestion fixed
    point's, ``a.links`` naming the links) when given.  Returns the final
    (t_end, ssum, cho, csrc).  A values loop may reuse a values state ``t``
    that an earlier loop over the same lists wrote: the kernel rewrites
    every listed row before any level reads it, and the unlisted rows stay
    0, so the result is the fresh state's."""
    lead = tuple(a.valid_flat.shape)
    if lanes is not None:
        lead = (lead[0] * lanes.K,) + lead[1:]
    if t is None or want_lam:
        t, ssum, cho, csrc = _state(lead, Lmat.shape[-2], want_lam,
                                    Lmat.device, torch.float64)
    else:
        ssum = cho = csrc = None
    kw = {} if ls is None else {"ls": ls, "elink": a.links.elink,
                                "in_link": a.links.in_link}
    segment_levels_f64(t, ssum, cho, Lmat.contiguous(), GSmat.contiguous(),
                       *segment_inputs(a, lanes), 0, nlv, csrc, **kw)
    return t, ssum, cho, csrc


def segment_forward(a: SegmentArrays, Lmat: torch.Tensor,
                    GSmat: torch.Tensor, want_lam: bool):
    """The segment forward of one plan, the port of the reference's
    ``_segment_core`` (``engine.py:183-388``): Lmat/GSmat [S, nc] f64 → (T
    [S] f64, λ [S, nc] f64 or None).  The level loop is one launch of
    :func:`~repro_torch.kernels.maxplus.segment_levels_f64`; the sink is
    the latest-ending valid vertex within ATOL (``sink_slot``,
    ``:253-262``), and λ one walk down the chosen edges (the reference's
    two passes, ``:264-308``; the rows are message counts, so the sum is
    exact in any order).  Same float64 ops as ``core.dag``, so T, λ and ρ
    are bit-identical to it.  The loop stops at the plan's ``nlevels``: the
    reference's padded levels past it hold no in-edge and no cost."""
    nlv = int(a.nlevels[0])
    segment_forward.runs["lam" if want_lam else "values"] += 1
    t, ssum, cho, csrc = _segment_levels(a, Lmat, GSmat, want_lam, nlv)
    if not want_lam:
        return t[a.valid[0]].amax(0), None
    T, vsel = _dense_sink(t, ssum, a.valid[0], a.valid_flat, a.vert_of_slot,
                          ATOL)
    return T, sparse_backtrace(vsel, cho, csrc,
                               a.elat.view(-1, a.elat.shape[-1]), nlv)


def segment_forward_multi(a: SegmentArrays, Lmat: torch.Tensor,
                          GSmat: torch.Tensor, want_lam: bool,
                          lanes: Optional["Lanes"] = None):
    """The packed segment forward, the port of ``_segment_core_multi``
    (``engine.py:379-388``): Lmat/GSmat [G, S, nc] f64, one scenario batch
    per graph → (T [G, S] f64, λ [G, S, nc] f64 or None).  One launch of
    the level loop for all G graphs (graph g on its own blocks, its own
    lists), then each graph's sink and one walk for all G graphs;
    each graph's T and λ equal its solo forward's bit for bit.  The loop
    stops at the largest ``nlevels`` of the G graphs (later levels of a
    graph hold no listed row).

    With ``lanes`` (the reference's ``_segment_core_axes`` with costs,
    ``engine.py:348-376``), K cost lanes of each graph in the same launch
    and the same walk: (T [G·K, S], λ [G·K, S, nc]), lane g·K + k graph g
    under cost block k, equal to a solo forward of graph g rebuilt with
    that block's constants, bit for bit."""
    nlv = int(a.nlevels.max())
    K = 1 if lanes is None else lanes.K
    segment_forward_multi.runs["lam" if want_lam else "values"] += 1
    t, ssum, cho, csrc = _segment_levels(a, Lmat, GSmat, want_lam, nlv,
                                         lanes)
    if not want_lam:
        return _lane_max(t, a.valid, K), None
    return _packed_walk(t, ssum, cho, csrc, a, nlv, ATOL, K, lanes)


def link_busy(lk: Links, erec: torch.Tensor, in_edges: torch.Tensor,
              GSmat: torch.Tensor) -> torch.Tensor:
    """[..., nl1, S] f64: each link's offered gap time ``Σ egap·GS[gc]``
    over its edges, a scenario (the reference's ``segment_sum``,
    ``engine.py:428-429``), from one structure's listed records (``erec``
    [NE, 3 + nc], ``in_edges`` [NE, 4]) or each lane's (a leading lane
    axis on either: the lanes that own their gap shares or classes) and
    scenarios (GSmat [S, ngc]).  Each link's edges are added in list
    order, one step a place (:func:`stage_links`): a step's links are
    distinct, so its gather, add and scatter make no collision and the sum
    has one fixed order (an ``index_add_`` on the card adds float64 in no
    fixed order).  The dummy bin stays 0."""
    x = erec[..., 1].index_select(-1, lk.order)[..., None] * GSmat.T[
        in_edges[..., 3].index_select(-1, lk.order).long()]
    busy = torch.zeros(x.shape[:-2] + (lk.nlinks + 1, GSmat.shape[0]),
                       dtype=torch.float64, device=GSmat.device)
    for d0, d1 in zip(lk.steps, lk.steps[1:]):
        idx = lk.order_link[d0:d1]
        busy.index_copy_(-2, idx, busy.index_select(-2, idx).add_(
            x[..., d0:d1, :]))
    return busy


def congestion_forward(a: SegmentArrays, Lmat: torch.Tensor,
                       GSmat: torch.Tensor, want_lam: bool, alpha, beta,
                       max_iters: int, tol: float,
                       lanes: Optional["Lanes"] = None):
    """The congestion fixed point over one plan (the reference's
    ``_congestion_core_axes``, ``engine.py:391-466``): ``a`` a plan staged
    with its links (``a.links``, :func:`stage_links`) as a packed view
    of one graph (:func:`packed_view`), Lmat/GSmat [1, S, ·], K cost lanes
    with ``lanes`` → (T [K, S], λ [K, S, nc] or None, iterations [K, S]
    int32), K = 1 without.

    The offered load ``busy`` (:func:`link_busy`) is computed once: [1,
    nl1, S], which the K lanes share, or [K, nl1, S] from each lane's own
    records where the lanes own their gap shares or gap classes.  Each iteration is one values launch of the level loop over
    all lanes with the link scales ``ls`` [K, nl1, S] (1.0 at first), T
    each lane's latest valid end, then for every (lane, scenario), as the
    reference's loop body does::

        util = busy / max(T, 1e-30)
        tgt  = 1 + a_l·max(util − b_l, 0)     (a_l = 0 on the dummy bin)
        new  = ls + 0.5·(tgt − ls)
        fin  = max over links |new − ls| <= tol

    A (lane, scenario) that is done keeps its ``ls`` and its count; the
    others take ``new``, count the iteration and are done once ``fin``.
    The loop asks the card "all done?" once an iteration (its one host
    sync) and stops at ``max_iters``.  Then one forward at the converged
    scales, recording λ when asked (one walk), else values.  With α ≡ 0
    every ``tgt`` is 1, ``ls`` stays exactly 1.0, the loop ends after one
    iteration, and the factor multiplies by 1.0: T, λ and ρ bit-equal to
    the plain forward."""
    lk = a.links
    K = 1 if lanes is None else lanes.K
    dev = Lmat.device
    nlv = int(a.nlevels.max())
    S = Lmat.shape[-2]
    if lanes is None or (lanes.egap is None and lanes.egclass is None):
        busy = link_busy(lk, a.erec[0], a.in_edges[0], GSmat[0])[None]
    else:
        busy = link_busy(lk, lanes.erec, lanes.field(a, "in_edges"),
                         GSmat[0])
    alpha = torch.as_tensor(np.asarray(alpha, dtype=np.float64), device=dev)
    beta = torch.as_tensor(np.asarray(beta, dtype=np.float64), device=dev)
    a_l = alpha[lk.cls]
    a_l[lk.nlinks] = 0.0
    a_l, b_l = a_l[None, :, None], beta[lk.cls][None, :, None]
    ls = torch.ones((K, lk.nlinks + 1, S), dtype=torch.float64, device=dev)
    iters = torch.zeros((K, S), dtype=torch.int32, device=dev)
    done = torch.zeros((K, S), dtype=torch.bool, device=dev)
    t = None
    congestion_forward.runs["solves"] += 1
    for _ in range(int(max_iters)):
        t = _segment_levels(a, Lmat, GSmat, False, nlv, lanes, ls, t)[0]
        T = _lane_max(t, a.valid, K)
        util = busy / T.clamp_min(1e-30)[:, None, :]
        tgt = (util - b_l).clamp_min_(0.0).mul_(a_l).add_(1.0)
        new = ls + (tgt - ls).mul_(0.5)
        fin = (new - ls).abs_().amax(1) <= tol
        ls = torch.where(done[:, None, :], ls, new)
        iters += (~done).int()
        done |= fin
        congestion_forward.runs["iterations"] += 1
        congestion_forward.runs["syncs"] += 1
        if bool(done.all()):
            break
    del t
    st = _segment_levels(a, Lmat, GSmat, want_lam, nlv, lanes, ls)
    if not want_lam:
        return _lane_max(st[0], a.valid, K), None, iters
    T, lam = _packed_walk(*st, a, nlv, ATOL, K, lanes)
    return T, lam, iters


#: fixed-point solves, iterations and host syncs of the iterations, over
#: all calls: with the kernels' launch counts, shows one level-loop launch
#: an iteration, one more a solve, and one sync an iteration
congestion_forward.runs = collections.Counter()


@dataclasses.dataclass
class Lanes:
    """K candidate-cost lanes of each of G staged structures (a packed
    plan's graphs, a structure batch's variants, or one plan as G = 1):
    lane y = g·K + k is structure g under cost block k.  Each lane owns its
    edge constants, ``econst`` [L, nlv_p, Emax] f64 (the dense weights'
    and the plain versions'), and on the segment backend its records
    ``erec`` [L, NE, 3 + nc] f64: the structure's, with the lane's
    constants in column 0 and, where the lanes' differ, its gap shares
    and latency rows in columns 1 to 3 + nc (:func:`stage_lanes`).

    ``egap``, ``egclass`` and ``elat`` are each None while every lane uses
    its structure's, else the lanes' own ([L, nlv_p, Emax(, nc)]); with
    ``elat`` the tie-key slopes ``elat_sum`` (float64 on the segment
    backend, float32 on the dense one), and on the segment backend with
    ``egclass`` the lanes' in-edge records ``in_edges`` [L, NE, 4], whose
    column 3 is the gap class."""

    K: int
    econst: torch.Tensor
    erec: Optional[torch.Tensor] = None
    egap: Optional[torch.Tensor] = None
    egclass: Optional[torch.Tensor] = None
    elat: Optional[torch.Tensor] = None
    elat_sum: Optional[torch.Tensor] = None
    in_edges: Optional[torch.Tensor] = None

    def field(self, a, name: str) -> torch.Tensor:
        """The lanes' own ``name`` where they own it, else the structures'
        (``a``'s)."""
        own = getattr(self, name)
        return getattr(a, name) if own is None else own


#: the per-edge fields a cost block may give its lanes besides econst
LANE_FIELDS = ("egap", "egclass", "elat")


def stage_lanes(a, econst: torch.Tensor, egap=None, egclass=None,
                elat=None) -> Lanes:
    """The :class:`Lanes` of ``econst`` [G, K, nlv_p, Emax] float64 (each
    structure's K blocks of edge constants, on ``a``'s device) for the
    packed arrays ``a`` (:class:`SegmentArrays` or :class:`MultiArrays`, a
    leading G axis), with the lanes' own gap shares, gap classes or
    latency rows where given ([G, K, nlv_p, Emax(, nc)]; None: the
    structure's).  On the segment backend each lane's records are its
    structure's ``erec``, copied on the device, with the lane's fields
    gathered into it at the listed edges' flat ids (the columns
    :func:`segment_lists` fills), so a level's records stay one contiguous
    run a lane; a lane-owned gap class takes a copy of the in-edge records
    too."""
    G, K = econst.shape[:2]
    L = G * K

    def flat(x):
        return None if x is None else x.reshape((L,) + x.shape[2:])

    ec, gap, gcl, lat = (flat(x) for x in (econst, egap, egclass, elat))
    seg = isinstance(a, SegmentArrays)
    lsum = None
    if lat is not None:
        lsum = lat.sum(-1) if seg else lat.sum(-1).float()
    if gcl is not None:
        gcl = gcl.long()
    lanes = Lanes(K, ec, egap=gap, egclass=gcl, elat=lat, elat_sum=lsum)
    if not seg:
        return lanes
    ids = a.in_edges[..., 0].long().repeat_interleave(K, 0)      # [L, NE]
    erec = a.erec.repeat_interleave(K, 0)
    erec[..., 0] = ec.view(L, -1).gather(1, ids)
    if gap is not None:
        erec[..., 1] = gap.view(L, -1).gather(1, ids)
    if lat is not None:
        erec[..., 2] = lsum.view(L, -1).gather(1, ids)
        nc = lat.shape[-1]
        erec[..., 3:] = lat.view(L, -1, nc).gather(
            1, ids[..., None].expand(-1, -1, nc))
    lanes.erec = erec
    if gcl is not None:
        ie = a.in_edges.repeat_interleave(K, 0)
        ie[..., 3] = gcl.view(L, -1).gather(1, ids).int()
        lanes.in_edges = ie
    return lanes


def packed_view(a, nlevels: int):
    """A solo plan's staged arrays as a packed plan of one graph (views,
    nothing copied), so K cost lanes of one plan run the packed forward;
    ``nlevels``, the plan's levels, those the dense packed forward walks
    (the levels past them hold no in-edge and no cost)."""
    if isinstance(a, SegmentArrays):
        out = dataclasses.replace(a, **{
            f.name: getattr(a, f.name)[None]
            for f in dataclasses.fields(a)
            if isinstance(getattr(a, f.name), torch.Tensor)})
        if a.links is not None:
            out.links = dataclasses.replace(
                a.links, elink=a.links.elink[None],
                in_link=a.links.in_link[None])
        return out
    return MultiArrays(
        A=a.A[:, None], **{f.name: getattr(a, f.name)[None]
                           for f in dataclasses.fields(a) if f.name != "A"},
        valid=[a.valid_flat.nonzero()[:, 0]],
        nlevels=np.asarray([nlevels], dtype=np.int64))


#: forwards run, by kind ("values" / "lam"): one level-loop launch each
segment_forward.runs = collections.Counter()
segment_forward_multi.runs = collections.Counter()


# -- per-device sharding ----------------------------------------------------

def local_devices(device: torch.device) -> int:
    """The devices a ``shard=True`` run of an engine on ``device`` may use:
    the cards of the host for an engine on the card, 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _resolve_shard(shard, size: int, avail: int) -> Optional[int]:
    """A ``shard=`` request as a device count that divides the axis of
    ``size`` (None: unsharded), the reference's rule (``engine.py:
    1011-1026``): True or "auto" means all ``avail`` local devices, an int
    at most that many; the count is walked down to the largest divisor of
    ``size``, so sharded and unsharded runs stay bit-equal (no pad rows, no
    uneven splits)."""
    if not shard:
        return None
    ndev = avail if shard is True or shard == "auto" \
        else min(int(shard), avail)
    ndev = max(min(ndev, size), 1)
    while size % ndev:
        ndev -= 1
    return ndev if ndev > 1 else None


def graph_slice(a, g0: int, g1: int):
    """Graphs ``g0..g1-1`` of packed arrays ``a`` (:class:`SegmentArrays`
    or :class:`MultiArrays` with a leading graph axis; the dense indicator
    is level-major, so its graph axis is dim 1 and its slice is copied to
    stay contiguous).  The in-edge lists keep the whole plan's padding:
    a padded entry lies past its graph's last level, so no level reads
    it."""
    out = {f.name: getattr(a, f.name)[g0:g1] for f in dataclasses.fields(a)
           if isinstance(getattr(a, f.name), torch.Tensor) and f.name != "A"}
    if isinstance(a, MultiArrays):
        out["A"] = a.A[:, g0:g1].contiguous()
    return dataclasses.replace(a, **out, valid=a.valid[g0:g1],
                               nlevels=a.nlevels[g0:g1])


def split_forward(forward, devices: Sequence, size: int, dim: int,
                  out_device: torch.device):
    """One forward cut along one axis over an explicit list of devices
    (the port's counterpart of the reference's ``shard_map``,
    ``engine.py:1078-1114``): ``range(size)`` in ``len(devices)``
    contiguous equal chunks, chunk i run by ``forward(devices[i], lo, hi)``
    → (T, λ or None) on that device, one level-loop launch and, for λ, one
    walk each; T and λ gathered onto ``out_device`` in order, concatenated
    on T's dim ``dim`` (λ's: the same dim counted from the front, one
    further from the back).  A device may be listed more than once.  Each
    chunk's lanes and scenarios are computed as in the whole forward, so
    the result is bit-identical to it."""
    n = len(devices)
    if n < 1 or size % n:
        raise ValueError(f"{n} devices do not split an axis of {size} "
                         "evenly")
    step = size // n
    Ts, lams = [], []
    for i, dev in enumerate(devices):
        T, lam = forward(torch.device(dev), i * step, (i + 1) * step)
        Ts.append(T.to(out_device))
        lams.append(None if lam is None else lam.to(out_device))
    split_forward.chunks += n
    split_forward.calls += 1
    T = torch.cat(Ts, dim)
    if lams[0] is None:
        return T, None
    return T, torch.cat(lams, dim if dim >= 0 else dim - 1)


#: split forwards run and the chunks they ran, over all calls
split_forward.calls = 0
split_forward.chunks = 0


# -- lockstep-batched bisection (dag.tolerance, one engine call per round) --

def _probe(eng, params: LogGPS, Lvals, cls: int,
           backend: Optional[str] = None):
    batch = latency_grid(params, np.asarray(Lvals, dtype=np.float64),
                         cls=cls, absolute=True)
    # a probe re-asks only what the search already holds: never cached
    # (the reference's ``_probe``, ``engine.py:1468-1473``)
    res = eng.run(batch, compute_lam=True, use_cache=False, backend=backend)
    return res.T, res.lam[:, cls]


def tolerance_batched(eng, params: LogGPS, degradations: Sequence[float],
                      cls: int = 0, L_hi: float = 1e7, tol: float = 1e-6,
                      max_iter: int = 200,
                      backend: Optional[str] = None) -> dict:
    """All of ``dag.tolerance``'s bisections in lockstep: each round probes
    every still-active degradation level in one batched forward, on
    ``eng``'s backend or the per-call ``backend`` (reference ``engine.py:
    1476-1515``).

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
    T0 = _probe(eng, params, [L0], cls, backend)[0][0]
    budgets = (1.0 + degr) * T0
    Thi = _probe(eng, params, [L_hi], cls, backend)[0][0]

    out = np.empty(S)
    done = Thi <= budgets
    out[done] = np.inf
    a = np.full(S, L0)
    b = np.full(S, L_hi)
    for _ in range(max_iter):
        act = np.nonzero(~done)[0]
        if act.size == 0:
            break
        Tb, lb = _probe(eng, params, b[act], cls, backend)
        x = np.where(lb > 0,
                     b[act] + (budgets[act] - Tb) / np.where(lb > 0, lb, 1.0),
                     (a[act] + b[act]) / 2)
        x = np.clip(x, a[act], b[act])
        Tx, _ = _probe(eng, params, x, cls, backend)
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


#: ``core.dag.breakpoints``'s limits: the slope change that still splits
#: an interval, the most kinks returned, and the deepest split
BP_TOL = 1e-9
BP_MAX = 10_000
BP_MAX_DEPTH = 80


def breakpoints_batched(eng, params: LogGPS, L_min: float, L_max: float,
                        cls: int = 0) -> list:
    """``dag.breakpoints`` with the recursion flattened level by level: each
    round probes every frontier interval's point in one batched forward.

    Each interval's probe depends only on its own ends, so the kinks are
    the scalar search's whenever the forward's T and λ are (the sparse
    float64 forward's are bit-identical to ``core.dag``'s).  Counts the
    rounds and probes it ran in ``breakpoints_batched.stats``."""
    (ya, yb), (sa, sb) = _probe(eng, params, [L_min, L_max], cls)
    breakpoints_batched.stats["rounds"] += 1
    breakpoints_batched.stats["probes"] += 2
    frontier = [(L_min, float(ya), float(sa), L_max, float(yb), float(sb), 0)]
    out: list = []
    while frontier and len(out) < BP_MAX:
        work = [iv for iv in frontier
                if abs(iv[2] - iv[5]) > BP_TOL and iv[6] <= BP_MAX_DEPTH]
        if not work:
            break
        xs = []
        for (A, yA, sA, B, yB, sB, _) in work:
            x = (yB - sB * B - (yA - sA * A)) / (sA - sB)
            xs.append(min(max(x, A + BP_TOL), B - BP_TOL))
        ys, ss = _probe(eng, params, xs, cls)
        breakpoints_batched.stats["rounds"] += 1
        breakpoints_batched.stats["probes"] += len(xs)
        frontier = []
        for (A, yA, sA, B, yB, sB, d), x, yx, sx in zip(work, xs, ys, ss):
            if len(out) >= BP_MAX:
                break
            line = yA + sA * (x - A)
            if yx <= line + max(1e-7, 1e-9 * abs(line)):
                out.append(float(x))
            else:
                frontier.append((A, yA, sA, float(x), float(yx), float(sx),
                                 d + 1))
                frontier.append((float(x), float(yx), float(sx), B, yB, sB,
                                 d + 1))
    return sorted(out)


#: probe rounds (batched forwards) and probes run, over all calls
breakpoints_batched.stats = collections.Counter()
