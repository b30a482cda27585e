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

The per-vertex (segment) tensors, cost and structure batches, packed
multi-graph plans and sparse slot lists belong to later slices.  Only the
size of the per-vertex view is kept (``Dmax``), because the dense-size
guard counts it, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
