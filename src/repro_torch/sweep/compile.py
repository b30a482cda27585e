"""ExecutionGraph → padded per-level tensors for the dense (max,+) forward.

The counterpart of the JAX package's ``repro/sweep/compile.py``, cut to
what the dense backend reads: the per-edge view (edges grouped by
destination level, with level-local destination slots) from which
:meth:`CompiledPlan.dense_indicator` derives the 0/−1e30 matrices the
(max,+) kernels consume, plus the per-vertex cost and slot tables.

Vertices live at level-major *flat slots* (``slot = level·Vmax + offset``);
flat slot ``nlv_p·Vmax`` is a scratch cell that padded edges read and
reductions skip (``valid_flat``).  Every dim is rounded up to a power-of-two
bucket, as in the reference, so the tensors here equal the reference's bit
for bit — the λ tie-breaks depend on the edge order, which is the scalar
engine's (destination level, destination, original id) order.

Edge weights at a scenario (L, γ) are reconstructed as

    w = econst + egap·(γ_egclass − 1) + Σ_c elat[:, c]·L_c

so γ = 1 reproduces the built edge constant bitwise.

Graphs whose padded envelope is too large for the dense view compile
instead to :class:`SparsePlan` (:func:`compile_sparse`): compact CSR-style
slot lists in the same edge and vertex orders, at O(nv + ne) memory.
:func:`estimate_dense_bytes` decides between the two from degree
statistics, before anything dense is laid out.

Variant studies pack G plans onto their common envelope
(:func:`repad_plan`, :func:`pack_plans`, :func:`group_plans`) into a
:class:`MultiPlan`, whose every level runs as one batched kernel launch.

The per-vertex (segment) tensors and cost and structure batches belong to
later slices.  Only the size of the per-vertex view is kept (``Dmax``),
because the dense-size guard counts it, as the reference's does.  The
segment forward reads the per-edge view instead
(``engine.stage_segment``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph import ExecutionGraph, edge_gap_shares
from repro_torch.core.loggps import LogGPS

#: the value of an absent edge in the indicator and of a masked candidate
NEG_INF = -1e30


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two ≥ max(n, lo)."""
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def _segment_view_bytes(nlv_p: int, Vmax: int, Dmax: int, nc: int) -> int:
    """Footprint of the reference's padded per-vertex (segment) tensors."""
    slot = nlv_p * Vmax * Dmax
    return (slot * (4 + 1 + 8 + 8 + 4 + 8 * nc + 8)
            + nlv_p * Vmax * 8
            + (nlv_p * Vmax + 1) * 5)


def _dense_view_bytes(nlv_p: int, Vmax: int, Emax: int, nc: int) -> int:
    """Footprint of the per-edge view: the [nlv, Vmax, Emax] indicator, the
    f32 edge tensors, and the per-level λ argmax plane."""
    edge = nlv_p * Emax
    return (nlv_p * Vmax * Emax * 4
            + edge * (4 + 4 + 1 + 4 + 4 + 4 + 4 * nc)
            + nlv_p * Vmax * 4 * 2
            + (nlv_p * Vmax + 1) * 5)


@dataclasses.dataclass
class CompiledPlan:
    """Padded per-level tensors of one graph (numpy, host side)."""

    esrc: np.ndarray          # [nlv_p, Emax] int32 flat source slot (pad → flat_dummy)
    edstl: np.ndarray         # [nlv_p, Emax] int32 level-local dst slot (pad → Vmax)
    emask: np.ndarray         # [nlv_p, Emax] bool
    econst: np.ndarray        # [nlv_p, Emax] float64
    egap: np.ndarray          # [nlv_p, Emax] float64
    egclass: np.ndarray       # [nlv_p, Emax] int32
    elat: np.ndarray          # [nlv_p, Emax, nclass] float64
    vcost_lv: np.ndarray      # [nlv_p, Vmax] float64
    valid_flat: np.ndarray    # [nlv_p·Vmax + 1] bool
    vert_of_slot: np.ndarray  # [nlv_p·Vmax + 1] int32 (original id, pad → nv)
    nv: int
    nclass: int
    nlevels: int
    Dmax: int                 # bucketed max in-degree (size accounting only)

    @property
    def nlv_p(self) -> int:
        return int(self.esrc.shape[0])

    @property
    def Vmax(self) -> int:
        return int(self.vcost_lv.shape[1])

    @property
    def Emax(self) -> int:
        return int(self.esrc.shape[1])

    @property
    def envelope(self) -> tuple:
        """(nlv_p, Vmax, Dmax, Emax): the padded dims packing works on."""
        return (self.nlv_p, self.Vmax, self.Dmax, self.Emax)

    def dense_indicator(self, neg: float = NEG_INF) -> np.ndarray:
        """[nlv_p, Vmax, Emax] float32 0/``neg`` matrix: row v of level lv
        is 0 at the slots of v's in-edges, so the (max,+) product of it with
        per-edge candidate values is the level's scatter-max."""
        A = np.full((self.nlv_p, self.Vmax, self.Emax), neg, dtype=np.float32)
        lv, sl = np.nonzero(self.emask)
        A[lv, self.edstl[lv, sl], sl] = 0.0
        return A

    def dense_bytes(self) -> int:
        """Padded dense footprint across both of the reference's views —
        what the dense-size guard compares with ``Engine.MAX_DENSE_BYTES``."""
        return (_segment_view_bytes(self.nlv_p, self.Vmax, self.Dmax,
                                    self.nclass)
                + _dense_view_bytes(self.nlv_p, self.Vmax, self.Emax,
                                    self.nclass))


def compile_plan(g: ExecutionGraph,
                 params: Optional[LogGPS] = None) -> CompiledPlan:
    """Compile an execution graph into a :class:`CompiledPlan`.

    Gap shares come from the graph's build-time record; ``params`` only
    reconstructs message edges without one (see ``edge_gap_shares``).
    """
    nv, ne = g.num_vertices, g.num_edges
    if nv == 0:
        raise ValueError("cannot compile an empty graph")
    nlevels = g.nlevels

    # edges sorted by (destination level, destination, original id): the
    # scalar engine's order, which the λ tie-breaks depend on
    lvl_of_edge = g.level[g.edst]
    eorder = np.lexsort((g.edst, lvl_of_edge))
    esrc_s = g.esrc[eorder].astype(np.int64)
    edst_s = g.edst[eorder].astype(np.int64)
    elvl_s = lvl_of_edge[eorder].astype(np.int64)
    level_ptr = np.searchsorted(elvl_s, np.arange(nlevels + 1))

    # vertices grouped by level, ascending id within a level
    vorder = np.argsort(g.level, kind="stable").astype(np.int64)
    vlvl_s = g.level[vorder].astype(np.int64)
    v_ptr = np.searchsorted(vlvl_s, np.arange(nlevels + 1))

    indeg = np.bincount(edst_s, minlength=nv)
    Emax = _bucket(np.diff(level_ptr).max(initial=1))
    Vmax = _bucket(np.diff(v_ptr).max(initial=1))
    Dmax = _bucket(indeg.max(initial=1), lo=2)
    nlv_p = _bucket(nlevels)
    flat_dummy = nlv_p * Vmax

    egap_o, egclass_o = edge_gap_shares(g, params)

    vslot = np.arange(nv, dtype=np.int64) - v_ptr[vlvl_s]
    slot_of_vertex = np.empty(nv, dtype=np.int64)
    slot_of_vertex[vorder] = vlvl_s * Vmax + vslot
    eslot = np.arange(ne, dtype=np.int64) - level_ptr[elvl_s]
    edstl_s = slot_of_vertex[edst_s] - elvl_s * Vmax

    vcost_lv = np.zeros((nlv_p, Vmax))
    vcost_lv[vlvl_s, vslot] = g.vcost[vorder]
    valid_flat = np.zeros(flat_dummy + 1, dtype=bool)
    valid_flat[vlvl_s * Vmax + vslot] = True
    vert_of_slot = np.full(flat_dummy + 1, nv, dtype=np.int32)
    vert_of_slot[vlvl_s * Vmax + vslot] = vorder

    esrc = np.full((nlv_p, Emax), flat_dummy, dtype=np.int32)
    edstl = np.full((nlv_p, Emax), Vmax, dtype=np.int32)
    emask = np.zeros((nlv_p, Emax), dtype=bool)
    econst = np.zeros((nlv_p, Emax))
    egap = np.zeros((nlv_p, Emax))
    egclass = np.zeros((nlv_p, Emax), dtype=np.int32)
    elat = np.zeros((nlv_p, Emax, g.nclass))
    esrc[elvl_s, eslot] = slot_of_vertex[esrc_s]
    edstl[elvl_s, eslot] = edstl_s
    emask[elvl_s, eslot] = True
    econst[elvl_s, eslot] = g.econst[eorder].astype(np.float64)
    egap[elvl_s, eslot] = egap_o[eorder]
    egclass[elvl_s, eslot] = egclass_o[eorder]
    elat[elvl_s, eslot] = g.elat[eorder].astype(np.float64)

    return CompiledPlan(
        esrc=esrc, edstl=edstl, emask=emask, econst=econst, egap=egap,
        egclass=egclass, elat=elat, vcost_lv=vcost_lv,
        valid_flat=valid_flat, vert_of_slot=vert_of_slot,
        nv=nv, nclass=g.nclass, nlevels=nlevels, Dmax=Dmax)


# -- multi-graph packing ------------------------------------------------------

def repad_plan(c: CompiledPlan, nlv_p: int, Vmax: int, Dmax: int,
               Emax: int) -> CompiledPlan:
    """Re-lay a compiled plan onto a larger (nlv_p, Vmax, Dmax, Emax)
    envelope (reference: ``repro/sweep/compile.py:856-928``, cut to the
    dense view).

    Flat slots are recomputed for the new Vmax (``slot = lv·Vmax +
    offset``; level-local offsets do not depend on the envelope), pad edges
    read the new scratch slot ``nlv_p·Vmax`` and point at level-local slot
    ``Vmax``, so the repadded plan's forward gives identical results:
    padding only adds masked −1e30 candidates, and max is exact."""
    if (nlv_p, Vmax, Dmax, Emax) == c.envelope:
        return c
    if nlv_p < c.nlv_p or Vmax < c.Vmax or Dmax < c.Dmax or Emax < c.Emax:
        raise ValueError(f"target envelope {(nlv_p, Vmax, Dmax, Emax)} "
                         f"smaller than the plan's {c.envelope}")
    nlv0, V0, E0 = c.nlv_p, c.Vmax, c.Emax
    dummy0, dummy1 = nlv0 * V0, nlv_p * Vmax

    def grow(a, shape, fill=0):
        out = np.full(shape, fill, dtype=a.dtype)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    old = np.nonzero(c.valid_flat[:dummy0])[0]
    new = (old // V0) * Vmax + old % V0
    valid_flat = np.zeros(dummy1 + 1, dtype=bool)
    valid_flat[new] = True
    vert_of_slot = np.full(dummy1 + 1, c.nv, dtype=np.int32)
    vert_of_slot[new] = c.vert_of_slot[old]
    src = c.esrc.astype(np.int64)
    esrc = np.full((nlv_p, Emax), dummy1, dtype=np.int32)
    esrc[:nlv0, :E0] = np.where(src == dummy0, dummy1,
                                (src // V0) * Vmax + src % V0)
    edstl = np.full((nlv_p, Emax), Vmax, dtype=np.int32)
    edstl[:nlv0, :E0] = np.where(c.emask, c.edstl, Vmax)
    return CompiledPlan(
        esrc=esrc, edstl=edstl,
        emask=grow(c.emask, (nlv_p, Emax), False),
        econst=grow(c.econst, (nlv_p, Emax)),
        egap=grow(c.egap, (nlv_p, Emax)),
        egclass=grow(c.egclass, (nlv_p, Emax)),
        elat=grow(c.elat, (nlv_p, Emax, c.nclass)),
        vcost_lv=grow(c.vcost_lv, (nlv_p, Vmax)),
        valid_flat=valid_flat, vert_of_slot=vert_of_slot,
        nv=c.nv, nclass=c.nclass, nlevels=c.nlevels, Dmax=Dmax)


#: the array fields of a :class:`MultiPlan` (each with a leading G axis)
MULTI_ARRAYS = ("esrc", "edstl", "emask", "econst", "egap", "egclass",
                "elat", "vcost_lv", "valid_flat", "vert_of_slot")


@dataclasses.dataclass
class MultiPlan:
    """G compiled plans stacked on a leading graph axis, on their common
    envelope (reference: ``repro/sweep/compile.py:931-1003``, cut to the
    dense view).  Fields mirror :class:`CompiledPlan` with a leading G
    dimension; per-plan scalars become per-graph arrays.  One level of a
    MultiPlan is one batched kernel launch for all G graphs."""

    esrc: np.ndarray          # [G, nlv_p, Emax] int32
    edstl: np.ndarray         # [G, nlv_p, Emax] int32
    emask: np.ndarray         # [G, nlv_p, Emax] bool
    econst: np.ndarray        # [G, nlv_p, Emax] float64
    egap: np.ndarray          # [G, nlv_p, Emax] float64
    egclass: np.ndarray       # [G, nlv_p, Emax] int32
    elat: np.ndarray          # [G, nlv_p, Emax, nclass] float64
    vcost_lv: np.ndarray      # [G, nlv_p, Vmax] float64
    valid_flat: np.ndarray    # [G, nlv_p·Vmax + 1] bool
    vert_of_slot: np.ndarray  # [G, nlv_p·Vmax + 1] int32
    nv: np.ndarray            # [G] int64
    nlevels: np.ndarray       # [G] int64
    nclass: int
    Dmax: int                 # the envelope's Dmax (size accounting only)

    @property
    def G(self) -> int:
        return int(self.esrc.shape[0])

    @property
    def nlv_p(self) -> int:
        return int(self.esrc.shape[1])

    @property
    def Vmax(self) -> int:
        return int(self.vcost_lv.shape[2])

    @property
    def Emax(self) -> int:
        return int(self.esrc.shape[2])

    @property
    def shape_key(self) -> tuple:
        """(G, nlv_p, Vmax, Dmax, Emax, nclass), the reference's key."""
        return (self.G, self.nlv_p, self.Vmax, self.Dmax, self.Emax,
                self.nclass)

    def dense_indicator(self, neg: float = NEG_INF) -> np.ndarray:
        """[G, nlv_p, Vmax, Emax] float32 0/``neg`` matrices, as
        :meth:`CompiledPlan.dense_indicator` for each graph."""
        A = np.full((self.G, self.nlv_p, self.Vmax, self.Emax), neg,
                    dtype=np.float32)
        gi, lv, sl = np.nonzero(self.emask)
        A[gi, lv, self.edstl[gi, lv, sl], sl] = 0.0
        return A

    def dense_bytes(self) -> int:
        """Both of the reference's views, summed over all G graphs: what the
        dense-size guard compares with ``Engine.MAX_DENSE_BYTES``."""
        return self.G * (
            _segment_view_bytes(self.nlv_p, self.Vmax, self.Dmax,
                                self.nclass)
            + _dense_view_bytes(self.nlv_p, self.Vmax, self.Emax,
                                self.nclass))


def pack_plans(plans: Sequence[CompiledPlan]) -> MultiPlan:
    """Pad compiled plans to their common envelope and stack them on a
    graph axis (reference: ``repro/sweep/compile.py:1006-1040``).

    All plans must share ``nclass`` (the scenario row width).  The envelope
    is the per-dimension max, already power-of-two bucketed, so packing
    invents no shape the largest member did not compile to."""
    if not plans:
        raise ValueError("pack_plans needs at least one plan")
    nc = plans[0].nclass
    if any(p.nclass != nc for p in plans):
        raise ValueError("cannot pack plans with different latency-class "
                         "counts into one MultiPlan")
    env = tuple(max(dims) for dims in zip(*(p.envelope for p in plans)))
    padded = [repad_plan(p, *env) for p in plans]
    return MultiPlan(
        **{f: np.stack([getattr(p, f) for p in padded])
           for f in MULTI_ARRAYS},
        nv=np.asarray([p.nv for p in plans], dtype=np.int64),
        nlevels=np.asarray([p.nlevels for p in plans], dtype=np.int64),
        nclass=nc, Dmax=env[2])


def group_plans(plans: Sequence[CompiledPlan],
                max_inflation: float = 64.0) -> list:
    """Partition plan indices into packable groups (reference:
    ``repro/sweep/compile.py:1043-1078``).

    Plans pack together when they share ``nclass`` and no member's padded
    volume (nlv_p · Vmax · max(Dmax, Emax)) inflates beyond
    ``max_inflation`` times its own, so a toy graph never rides a huge
    envelope.  Returns index lists covering ``range(len(plans))`` in
    order; a variant study runs one packed engine per group."""
    def volume(env):
        nlv, V, D, E = env
        return nlv * V * max(D, E)

    groups: list = []
    meta: list = []               # (nclass, envelope) per group
    for i, p in enumerate(plans):
        for gi, (nc, env) in enumerate(meta):
            if nc != p.nclass:
                continue
            new_env = tuple(max(a, b) for a, b in zip(env, p.envelope))
            if all(volume(new_env) <= max_inflation * volume(m)
                   for m in [plans[j].envelope for j in groups[gi]]
                   + [p.envelope]):
                groups[gi].append(i)
                meta[gi] = (nc, new_env)
                break
        else:
            groups.append([i])
            meta.append((p.nclass, p.envelope))
    return groups


# -- sparse slot-list layout (beyond the dense envelope) ----------------------


@dataclasses.dataclass
class SparsePlan:
    """Compact CSR-style slot lists — no ``[nlv, Vmax, Emax]`` padding
    (reference: ``repro/sweep/compile.py:1084-1301``).

    Vertices live at compact level-major slots ``0..nv-1`` (level
    ascending, original id ascending within a level — the order the dense
    view uses, so tie-breaks agree); edges sort by (destination level,
    destination, original id) as in :func:`compile_plan`.
    ``level_ptr``/``v_ptr`` delimit each level's edge and vertex runs, and
    the forward walks levels with fixed ``[Emax_lv]``/``[Vmax_lv]`` windows
    (bucketed per-level maxima), so memory is O(nv + ne).

    Padding invariants the sparse forward relies on:

    - ``ne_p ≥ ne + Emax_lv`` and ``nv_p ≥ nv + Vmax_lv``: no level's
      window runs past the end of its array, so a plain slice equals the
      reference's ``dynamic_slice`` (which would clamp its start), and the
      padded levels' windows (which start at ``ne``/``nv``) touch only pad
      slots.
    - pad edges carry ``edst_slot = nv + Vmax_lv``, so their window-local
      destination is ≥ ``Vmax_lv`` at every level and never negative.
    - ``valid`` is true exactly on the first ``nv`` slots.

    The reference's per-edge link ids (``elink``/``nlinks``/
    ``link_classes``, read only by the congestion fixed point),
    ``from_plan`` and ``content_hash`` (result cache) are not ported.
    """

    esrc_slot: np.ndarray     # [ne_p] int32 compact slot of the edge source
    edst_slot: np.ndarray     # [ne_p] int32 compact slot of the destination
    emask: np.ndarray         # [ne_p] bool
    econst: np.ndarray        # [ne_p] float64
    egap: np.ndarray          # [ne_p] float64
    egclass: np.ndarray       # [ne_p] int32
    elat: np.ndarray          # [ne_p, nclass] float64
    elat_sum: np.ndarray      # [ne_p] float64 (λ tie-break slopes)
    vcost: np.ndarray         # [nv_p] float64
    valid: np.ndarray         # [nv_p] bool
    vert_of_slot: np.ndarray  # [nv_p] int32 (original id, pad → nv)
    level_ptr: np.ndarray     # [nlv_p + 1] int32 edge run starts (pad → ne)
    v_ptr: np.ndarray         # [nlv_p + 1] int32 vertex runs (pad → nv)
    nv: int
    ne: int
    nclass: int
    nlevels: int
    Emax_lv: int              # bucketed max edges in one level (window size)
    Vmax_lv: int              # bucketed max vertices in one level

    @property
    def nlv_p(self) -> int:
        return int(self.level_ptr.shape[0]) - 1

    def sparse_bytes(self) -> int:
        """Bytes the sparse backend stages for this plan (the reference's
        count: the plan's arrays, before the per-device casts)."""
        return sum(getattr(self, n).nbytes for n in SPARSE_ARRAYS)


#: the array fields of a :class:`SparsePlan`, in the reference's staging
#: order (``repro/sweep/engine.py:1039-1043``)
SPARSE_ARRAYS = ("esrc_slot", "edst_slot", "emask", "econst", "egap",
                 "egclass", "elat", "elat_sum", "vcost", "valid",
                 "vert_of_slot", "level_ptr", "v_ptr")


def _assemble_sparse(nv: int, nc: int, nlevels: int,
                     esrc_s: np.ndarray, edst_s: np.ndarray,
                     econst_s: np.ndarray, egap_s: np.ndarray,
                     egclass_s: np.ndarray, elat_s: np.ndarray,
                     vcost_s: np.ndarray, vert_s: np.ndarray,
                     level_ptr: np.ndarray, v_ptr: np.ndarray) -> SparsePlan:
    """Pad level-sorted compact-slot arrays into a :class:`SparsePlan`
    honouring its padding invariants."""
    ne = int(esrc_s.shape[0])
    Emax_lv = _bucket(int(np.diff(level_ptr).max(initial=1)))
    Vmax_lv = _bucket(int(np.diff(v_ptr).max(initial=1)))
    nlv_p = _bucket(nlevels)
    ne_p = _bucket(ne + Emax_lv)
    nv_p = _bucket(nv + Vmax_lv)

    def padv(a, n, fill, dtype=None):
        out = np.full((n,) + a.shape[1:], fill,
                      dtype=a.dtype if dtype is None else dtype)
        out[:a.shape[0]] = a
        return out

    elat_p = padv(elat_s.astype(np.float64), ne_p, 0.0)
    return SparsePlan(
        esrc_slot=padv(esrc_s, ne_p, 0, np.int32),
        edst_slot=padv(edst_s, ne_p, nv + Vmax_lv, np.int32),
        emask=padv(np.ones(ne, dtype=bool), ne_p, False),
        econst=padv(econst_s.astype(np.float64), ne_p, 0.0),
        egap=padv(egap_s.astype(np.float64), ne_p, 0.0),
        egclass=padv(egclass_s, ne_p, 0, np.int32),
        elat=elat_p, elat_sum=elat_p.sum(axis=1),
        vcost=padv(vcost_s.astype(np.float64), nv_p, 0.0),
        valid=padv(np.ones(nv, dtype=bool), nv_p, False),
        vert_of_slot=padv(vert_s, nv_p, nv, np.int32),
        level_ptr=padv(level_ptr, nlv_p + 1, ne, np.int32),
        v_ptr=padv(v_ptr, nlv_p + 1, nv, np.int32),
        nv=nv, ne=ne, nclass=nc, nlevels=nlevels,
        Emax_lv=Emax_lv, Vmax_lv=Vmax_lv)


def compile_sparse(g: ExecutionGraph,
                   params: Optional[LogGPS] = None) -> SparsePlan:
    """Compile an execution graph straight into a :class:`SparsePlan`.

    Same edge/vertex orders and gap decomposition as :func:`compile_plan`,
    but nothing is laid out dense: the entry point for graphs whose padded
    envelope would exceed the dense-size guard."""
    nv = g.num_vertices
    if nv == 0:
        raise ValueError("cannot compile an empty graph")
    nlevels = g.nlevels
    lvl_of_edge = g.level[g.edst]
    eorder = np.lexsort((g.edst, lvl_of_edge))
    elvl_s = lvl_of_edge[eorder].astype(np.int64)
    level_ptr = np.searchsorted(elvl_s, np.arange(nlevels + 1))
    vorder = np.argsort(g.level, kind="stable").astype(np.int64)
    vlvl_s = g.level[vorder].astype(np.int64)
    v_ptr = np.searchsorted(vlvl_s, np.arange(nlevels + 1))
    slot_of_vertex = np.empty(nv, dtype=np.int64)
    slot_of_vertex[vorder] = np.arange(nv, dtype=np.int64)
    egap_o, egclass_o = edge_gap_shares(g, params)
    return _assemble_sparse(
        nv=nv, nc=g.nclass, nlevels=nlevels,
        esrc_s=slot_of_vertex[g.esrc[eorder].astype(np.int64)],
        edst_s=slot_of_vertex[g.edst[eorder].astype(np.int64)],
        econst_s=g.econst[eorder].astype(np.float64),
        egap_s=egap_o[eorder], egclass_s=egclass_o[eorder],
        elat_s=g.elat[eorder].astype(np.float64),
        vcost_s=g.vcost[vorder].astype(np.float64),
        vert_s=vorder, level_ptr=level_ptr, v_ptr=v_ptr)


def estimate_dense_bytes(g: ExecutionGraph) -> int:
    """What :meth:`CompiledPlan.dense_bytes` would report for ``g``,
    computed from degree statistics without laying out the dense envelope:
    the dense materialization is itself the memory cliff, so the
    dense→sparse auto-switch decides before compiling."""
    nv = g.num_vertices
    indeg = np.bincount(g.edst, minlength=nv)
    ecnt = np.bincount(g.level[g.edst], minlength=g.nlevels)
    vcnt = np.bincount(g.level, minlength=g.nlevels)
    Emax = _bucket(int(ecnt.max(initial=1)))
    Vmax = _bucket(int(vcnt.max(initial=1)))
    Dmax = _bucket(int(indeg.max(initial=1)), lo=2)
    nlv_p = _bucket(g.nlevels)
    return (_segment_view_bytes(nlv_p, Vmax, Dmax, g.nclass)
            + _dense_view_bytes(nlv_p, Vmax, Emax, g.nclass))
