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

Structure vs cost, as in the reference: ``compile_plan`` records each
edge's level and slots in original edge order (``epos_*``), so K candidate
cost blocks patch into a plan's edge constants
(:meth:`CompiledPlan.patch_costs` → :class:`CostBatch`, the candidate axis
K) and B edge rewirings patch into its sources and masks
(:meth:`CompiledPlan.patch_structure` or :meth:`StructureBatch.from_plans`
→ :class:`StructureBatch`, the variant axis B), both bit-identical to
rebuilding.  Both carry the
per-edge view only: the port's plans have no per-vertex view, and both of
its backends read the per-edge one.

The per-vertex (segment) tensors are not laid out.  Only their size is
kept (``Dmax``), because the dense-size guard counts it, as the
reference's does.  The segment forward reads the per-edge view instead
(``engine.stage_segment``).

Physical links, as in the reference (``compile.py:452-461``): every plan
records each edge's interned link id in its edge view (``elinkp``; a
dependency edge, a pad slot or a graph without link records lands in the
dummy bin ``nlinks``), the link count and each link's latency class.
Only the congestion fixed point reads them, so ``content_hash`` stays
link-blind and :meth:`CompiledPlan.link_hash` keys them apart.
"""

from __future__ import annotations

import dataclasses
import hashlib
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


def _canonical_bytes(a: np.ndarray) -> tuple:
    """(header, buffer) of an array: dtype tag and shape, then its C-order
    bytes — the reference's ``cache.canonical_bytes``, so equal arrays hash
    alike in any process and a [2, 3] never collides with a [3, 2]."""
    a = np.ascontiguousarray(a)
    return (f"{a.dtype.str}|{a.shape}|".encode(), a.tobytes())


def _sha1(tag: bytes, arrays, scalars=()) -> str:
    sha = hashlib.sha1(tag)
    if scalars:
        sha.update(np.int64(scalars).tobytes())
    for a in arrays:
        for chunk in _canonical_bytes(a):
            sha.update(chunk)
    return sha.hexdigest()


#: the cost tensors of a plan's per-edge view: what a :class:`CostBatch`
#: stacks K blocks of (reference ``COST_FIELDS``, edge view)
COST_FIELDS = ("econst", "egap", "egclass", "elat")

#: every per-edge-view plan tensor the forwards read: what a
#: :class:`StructureBatch` stacks B variant blocks of (reference
#: ``STRUCT_FIELDS``, edge view) and a :class:`MultiPlan` G graphs of
STRUCT_FIELDS = ("esrc", "edstl", "emask", "econst", "egap", "egclass",
                 "elat", "vcost_lv", "valid_flat", "vert_of_slot")


def _broadcast(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` as n stride-0 blocks on a new leading axis (an unpatched
    field of a cost or structure batch)."""
    return np.broadcast_to(a[None], (n,) + a.shape)


def _pad_blocks(a: np.ndarray, n: int) -> np.ndarray:
    """The leading axis padded to n by repeating its last block; a
    stride-0 (unpatched) field stays stride-0."""
    if a.strides[0] == 0:
        return np.broadcast_to(a[:1], (n,) + a.shape[1:])
    return np.concatenate(
        [a, np.broadcast_to(a[-1:], (n - a.shape[0],) + a.shape[1:])])


def _edge_links(g: ExecutionGraph, eorder: np.ndarray) -> tuple:
    """(nlinks, each sorted edge's link id or None, link classes) of a
    graph (reference ``compile.py:766-778``): a −1 or out-of-range id goes
    to the dummy bin ``nlinks``; a graph without link records has no link
    (None, and no classes)."""
    if g.elink is None or g.elink.shape[0] != g.num_edges:
        return 0, None, np.zeros(0, dtype=np.int32)
    nlinks = int(g.nlinks)
    el = g.elink[eorder].astype(np.int64)
    classes = (g.link_classes.astype(np.int32)
               if g.link_classes is not None
               else np.zeros(nlinks, dtype=np.int32))
    return nlinks, np.where((el < 0) | (el >= nlinks), nlinks, el), classes


@dataclasses.dataclass
class CostBatch:
    """K candidate cost blocks of one :class:`CompiledPlan`'s per-edge view
    (reference: ``repro/sweep/compile.py:129-260``, edge view only).

    The leading axis is the candidate (the K swap candidates of a placement
    step, say).  A field that a patch did not touch is a stride-0 broadcast
    of the plan's own tensor; :meth:`CompiledPlan.patch_costs` materializes
    only ``econst``.  ``Engine.run(costs=...)`` runs the K blocks as K lanes
    of one forward."""

    econst: np.ndarray     # [K, nlv_p, Emax] float64
    egap: np.ndarray       # [K, nlv_p, Emax] float64
    egclass: np.ndarray    # [K, nlv_p, Emax] int32
    elat: np.ndarray       # [K, nlv_p, Emax, nclass] float64
    #: content hash of the plan this batch was patched from: bucketing
    #: gives distinct graphs one envelope, so the engine refuses a batch
    #: minted on another plan of the same shape (None on a hand-assembled
    #: batch: shape check only)
    plan_hash: Optional[str] = None

    @property
    def K(self) -> int:
        return int(self.econst.shape[0])

    def padded(self, Kp: int) -> "CostBatch":
        """The candidate axis padded to ``Kp`` by repeating the last block;
        broadcast fields stay broadcasts."""
        if Kp == self.K:
            return self
        if Kp < self.K:
            raise ValueError(f"cannot pad {self.K} cost blocks down to {Kp}")
        return CostBatch(**{n: _pad_blocks(getattr(self, n), Kp)
                            for n in COST_FIELDS}, plan_hash=self.plan_hash)

    def repad(self, nlv_p: int, Vmax: int, Dmax: int,
              Emax: int) -> "CostBatch":
        """The blocks zero-filled onto a larger (nlv_p, Vmax, Dmax, Emax)
        envelope, as :func:`repad_plan` fills the plan's costs, when per-graph
        batches ride a packed :class:`MultiPlan` (the per-edge view reads
        nlv_p and Emax only).  Padded slots are masked in every forward, so
        a repadded block evaluates bit-identically; broadcast fields stay
        stride-0."""
        K = self.K
        nlv0, E0 = self.econst.shape[1:]
        if (nlv_p, Emax) == (nlv0, E0):
            return self
        if nlv_p < nlv0 or Emax < E0:
            raise ValueError(f"target envelope {(nlv_p, Vmax, Dmax, Emax)} "
                             f"smaller than the cost batch's "
                             f"{(nlv0, E0)} (nlv_p, Emax)")

        def grow(a):
            shape = (nlv_p, Emax) + a.shape[3:]
            inner = tuple(slice(0, n) for n in a.shape[1:])
            if a.strides[0] == 0:
                out = np.zeros(shape, dtype=a.dtype)
                out[inner] = a[0]
                return _broadcast(out, K)
            out = np.zeros((K,) + shape, dtype=a.dtype)
            out[(slice(None),) + inner] = a
            return out

        return CostBatch(**{n: grow(getattr(self, n)) for n in COST_FIELDS},
                         plan_hash=self.plan_hash)


@dataclasses.dataclass
class StructureBatch:
    """B structural variants of one per-edge-view envelope (reference:
    ``repro/sweep/compile.py:263-420``, edge view only).

    Edge sources (``esrc``) and masks (``emask``) become per-variant
    tensors, so a topology study (collective swaps, edge removals and
    re-routes) runs as B structures of one forward.  The λ tie key needs no
    extra tensor: an edge's slot j along ``Emax`` keeps its order per
    destination, so the per-variant lists the engine builds keep the
    rebuild's tie-breaks.

    Two constructors: :meth:`CompiledPlan.patch_structure` rewires one
    plan (only ``esrc`` and ``emask`` are materialized B times, every other
    field is a stride-0 view of the plan's), and :meth:`from_plans` stacks
    separately compiled plans onto their common envelope."""

    esrc: np.ndarray          # [B, nlv_p, Emax] int32
    edstl: np.ndarray         # [B, nlv_p, Emax] int32
    emask: np.ndarray         # [B, nlv_p, Emax] bool
    econst: np.ndarray        # [B, nlv_p, Emax] float64
    egap: np.ndarray          # [B, nlv_p, Emax] float64
    egclass: np.ndarray       # [B, nlv_p, Emax] int32
    elat: np.ndarray          # [B, nlv_p, Emax, nclass] float64
    vcost_lv: np.ndarray      # [B, nlv_p, Vmax] float64
    valid_flat: np.ndarray    # [B, nlv_p·Vmax + 1] bool
    vert_of_slot: np.ndarray  # [B, nlv_p·Vmax + 1] int32
    #: the plan whose envelope the variants share (an Engine built from
    #: the batch binds it)
    base: Optional["CompiledPlan"] = None
    #: content hash of the patched plan (None for :meth:`from_plans`
    #: batches, whose every tensor is per variant)
    plan_hash: Optional[str] = None
    #: optional per-variant names (``Result.split()``)
    names: Optional[tuple] = None

    @property
    def B(self) -> int:
        return int(self.esrc.shape[0])

    @property
    def nclass(self) -> int:
        return int(self.elat.shape[3])

    def padded(self, Bp: int) -> "StructureBatch":
        """The variant axis padded to ``Bp`` by repeating the last block;
        broadcast fields stay broadcasts."""
        if Bp == self.B:
            return self
        if Bp < self.B:
            raise ValueError(f"cannot pad {self.B} structure blocks down "
                             f"to {Bp}")
        return StructureBatch(**{n: _pad_blocks(getattr(self, n), Bp)
                                 for n in STRUCT_FIELDS},
                              base=self.base, plan_hash=self.plan_hash,
                              names=self.names)

    @classmethod
    def from_plans(cls, plans: Sequence["CompiledPlan"],
                   names: Optional[Sequence[str]] = None
                   ) -> "StructureBatch":
        """Separately compiled plans stacked onto their common envelope.
        Every tensor is per variant; repadding is exact
        (:func:`repad_plan`), so each variant evaluates as its plan alone."""
        if not plans:
            raise ValueError("from_plans needs at least one plan")
        nc = plans[0].nclass
        if any(p.nclass != nc for p in plans):
            raise ValueError("cannot batch plans with different latency-"
                             "class counts into one StructureBatch")
        if names is not None and len(names) != len(plans):
            raise ValueError(f"{len(names)} names for {len(plans)} plans")
        env = tuple(max(dims) for dims in zip(*(p.envelope for p in plans)))
        padded = [repad_plan(p, *env) for p in plans]
        return cls(**{n: np.stack([getattr(p, n) for p in padded])
                      for n in STRUCT_FIELDS},
                   base=padded[0], plan_hash=None,
                   names=tuple(names) if names is not None else None)

    def as_multi(self) -> "MultiPlan":
        """The B variants as a :class:`MultiPlan` of B graphs (the engine
        stages a structure batch as it stages a packed plan: each variant's
        lists are built from its own sources and masks).  A variant's
        ``nv`` and ``nlevels`` are read off its valid slots."""
        Vmax = self.vcost_lv.shape[2]
        valid = self.valid_flat[:, :-1]
        last = np.where(valid.any(1),
                        valid.shape[1] - 1 - np.argmax(valid[:, ::-1], 1), 0)
        return MultiPlan(
            **{n: getattr(self, n) for n in STRUCT_FIELDS},
            nv=valid.sum(1).astype(np.int64),
            nlevels=(last // Vmax + 1).astype(np.int64),
            nclass=self.nclass,
            Dmax=self.base.Dmax if self.base is not None else 2)


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
    # each edge's destination level, level-local destination slot and
    # level-local edge slot, in original edge order: the coordinates cost
    # and structure patches write at (level-local, so repadding keeps
    # them).  None on a hand-assembled plan, which then cannot patch.
    epos_lvl: Optional[np.ndarray] = None   # [ne] int32
    epos_dst: Optional[np.ndarray] = None   # [ne] int32
    epos_e: Optional[np.ndarray] = None     # [ne] int32
    # physical links (the congestion fixed point): each edge slot's link id,
    # pad slots and edges without a link in the dummy bin ``nlinks``; each
    # link's latency class.  None on a hand-assembled plan, which then
    # cannot run the fixed point.
    elinkp: Optional[np.ndarray] = None     # [nlv_p, Emax] int32
    nlinks: int = 0
    link_classes: Optional[np.ndarray] = None   # [nlinks] int32

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

    def content_hash(self) -> str:
        """SHA1 over the plan's scalars and per-edge-view tensors
        (memoized): two plans of one envelope hash alike only with equal
        contents, so a cost or structure batch minted on another plan is
        refused (reference ``compile.py:517``, over the vertex view)."""
        h = getattr(self, "_hash", None)
        if h is None:
            h = self._hash = _sha1(
                b"compiled-plan-edge-v1",
                (self.esrc, self.edstl, self.emask, self.econst, self.egap,
                 self.egclass, self.elat, self.vcost_lv, self.vert_of_slot),
                (self.nv, self.nclass, self.nlevels))
        return h

    def link_hash(self) -> str:
        """SHA1 over the link records (memoized; reference
        ``compile.py:537-551``, over the edge view): folded into a result
        key only when the congestion fixed point is on, since no other
        forward reads links."""
        h = getattr(self, "_lhash", None)
        if h is None:
            sha = hashlib.sha1(b"plan-links-edge-v1")
            sha.update(np.int64([self.nlinks]).tobytes())
            for a in (self.elinkp, self.link_classes):
                if a is None:
                    sha.update(b"|none|")
                    continue
                for chunk in _canonical_bytes(a):
                    sha.update(chunk)
            h = self._lhash = sha.hexdigest()
        return h

    def _need_epos(self, what: str) -> None:
        if self.epos_lvl is None:
            raise ValueError(
                "plan carries no edge-position records (hand-assembled?); "
                f"recompile with compile_plan() to enable {what}")

    def patch_costs(self, extra_edge_cost: np.ndarray) -> CostBatch:
        """K candidate cost blocks: the baked costs plus per-edge extras
        (reference ``compile.py:558-609``, edge view).

        ``extra_edge_cost``: [ne] or [K, ne] µs in original edge order, the
        array ``compile_plan(extra_edge_cost=)`` takes.  Block k's
        ``econst`` equals ``compile_plan(g, extra_edge_cost=extra[k])``'s
        bit for bit: the extra is added to the baked float64 constant at
        its recorded slot, the addition the rebuild makes before its
        scatter.  The other fields are stride-0 views of the plan's."""
        self._need_epos("cost patching")
        ex = np.atleast_2d(np.asarray(extra_edge_cost, dtype=np.float64))
        K, ne = ex.shape
        if ne != self.epos_lvl.shape[0]:
            raise ValueError(f"extra_edge_cost has {ne} edges, plan was "
                             f"compiled from {self.epos_lvl.shape[0]}")
        econst = np.repeat(self.econst[None], K, axis=0)
        econst[:, self.epos_lvl, self.epos_e] += ex
        return CostBatch(econst=econst, egap=_broadcast(self.egap, K),
                         egclass=_broadcast(self.egclass, K),
                         elat=_broadcast(self.elat, K),
                         plan_hash=self.content_hash())

    def with_extra_cost(self, extra_edge_cost: np.ndarray) -> "CompiledPlan":
        """A new plan with ``extra_edge_cost`` patched into the baked edge
        constants, the structure arrays shared: bit-identical to
        ``compile_plan(g, extra_edge_cost=...)`` (reference
        ``compile.py:611``)."""
        cb = self.patch_costs(
            np.asarray(extra_edge_cost, dtype=np.float64).ravel())
        return dataclasses.replace(self, econst=cb.econst[0])

    def patch_structure(self, src: Optional[np.ndarray] = None,
                        keep: Optional[np.ndarray] = None,
                        names: Optional[Sequence[str]] = None
                        ) -> StructureBatch:
        """B edge-rewired variants of this plan (reference
        ``compile.py:623-705``, edge view).

        ``src``: [ne] or [B, ne] original vertex ids in original edge order,
        each edge's new source (None keeps the baked ones); ``keep``: [ne]
        or [B, ne] bool, False removes the edge from that variant.
        Destinations, costs and the level schedule stay the envelope's, so
        every kept edge's new source must lie at a lower level than its
        destination (checked).  Removed edges read the scratch slot and are
        masked.  A surviving edge keeps its slot j, and the tie-break reads
        only the slots' order per destination, which a rebuild (whose
        compaction keeps the original edge order) shares."""
        self._need_epos("structure patching")
        if src is None and keep is None:
            raise ValueError("patch_structure needs src and/or keep")
        ne = self.epos_lvl.shape[0]
        if src is not None:
            src = np.atleast_2d(np.asarray(src, dtype=np.int64))
        if keep is not None:
            keep = np.atleast_2d(np.asarray(keep, dtype=bool))
        B = src.shape[0] if src is not None else keep.shape[0]
        if keep is None:
            keep = np.broadcast_to(np.ones(ne, dtype=bool), (B, ne))
        lvl = self.epos_lvl.astype(np.int64)
        es = self.epos_e.astype(np.int64)
        if src is None:
            baked = self.vert_of_slot[self.esrc[lvl, es]].astype(np.int64)
            src = np.broadcast_to(baked, (B, ne))
        if src.shape != (B, ne) or keep.shape != (B, ne):
            raise ValueError(
                f"src/keep must be [B, {ne}] in original edge order, got "
                f"{src.shape} / {keep.shape}")
        flat_dummy = self.nlv_p * self.Vmax
        slots = np.nonzero(self.valid_flat[:flat_dummy])[0]
        sov = np.full(self.nv, -1, dtype=np.int64)
        sov[self.vert_of_slot[slots]] = slots
        ok = (src >= 0) & (src < self.nv)
        if not bool(np.all(ok | ~keep)):
            raise ValueError("src names vertex ids outside [0, nv)")
        srcslot = sov[np.where(keep & ok, src, 0)]
        if bool(np.any(keep & (srcslot // self.Vmax >= lvl))):
            raise ValueError(
                "structure patch violates the level schedule: every kept "
                "edge's new source must sit at a strictly lower "
                "topological level than its destination")
        new_src = np.where(keep, srcslot, flat_dummy).astype(np.int32)
        esrc = np.repeat(self.esrc[None], B, axis=0)
        esrc[:, lvl, es] = new_src
        emask = np.repeat(self.emask[None], B, axis=0)
        emask[:, lvl, es] = keep
        return StructureBatch(
            esrc=esrc, emask=emask,
            **{n: _broadcast(getattr(self, n), B) for n in STRUCT_FIELDS
               if n not in ("esrc", "emask")},
            base=self, plan_hash=self.content_hash(),
            names=tuple(names) if names is not None else None)


def compile_plan(g: ExecutionGraph, params: Optional[LogGPS] = None,
                 extra_edge_cost: Optional[np.ndarray] = None
                 ) -> CompiledPlan:
    """Compile an execution graph into a :class:`CompiledPlan`.

    Gap shares come from the graph's build-time record; ``params`` only
    reconstructs message edges without one (see ``edge_gap_shares``).
    ``extra_edge_cost`` ([ne] µs, original edge order) is added to each
    edge's float64 constant before the scatter, as the reference's
    (``compile.py:737``): the compiled counterpart of a candidate rank
    mapping's link costs.
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
    econst_s = g.econst[eorder].astype(np.float64)
    if extra_edge_cost is not None:
        econst_s = econst_s + np.asarray(extra_edge_cost,
                                         dtype=np.float64)[eorder]
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
    econst[elvl_s, eslot] = econst_s
    egap[elvl_s, eslot] = egap_o[eorder]
    egclass[elvl_s, eslot] = egclass_o[eorder]
    elat[elvl_s, eslot] = g.elat[eorder].astype(np.float64)
    nlinks, elink_s, link_classes = _edge_links(g, eorder)
    elinkp = np.full((nlv_p, Emax), nlinks, dtype=np.int32)
    if elink_s is not None:
        elinkp[elvl_s, eslot] = elink_s

    def unsort(a):
        """Sorted-order coordinates back in original edge order."""
        out = np.empty(ne, dtype=np.int32)
        out[eorder] = a
        return out

    return CompiledPlan(
        esrc=esrc, edstl=edstl, emask=emask, econst=econst, egap=egap,
        egclass=egclass, elat=elat, vcost_lv=vcost_lv,
        valid_flat=valid_flat, vert_of_slot=vert_of_slot,
        nv=nv, nclass=g.nclass, nlevels=nlevels, Dmax=Dmax,
        epos_lvl=unsort(elvl_s), epos_dst=unsort(edstl_s),
        epos_e=unsort(eslot), elinkp=elinkp, nlinks=nlinks,
        link_classes=link_classes)


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
        nv=c.nv, nclass=c.nclass, nlevels=c.nlevels, Dmax=Dmax,
        epos_lvl=c.epos_lvl, epos_dst=c.epos_dst, epos_e=c.epos_e,
        # the new pad slots land in the dummy bin, never on link 0
        elinkp=(None if c.elinkp is None
                else grow(c.elinkp, (nlv_p, Emax), c.nlinks)),
        nlinks=c.nlinks, link_classes=c.link_classes)


#: the array fields of a :class:`MultiPlan` (each with a leading G axis)
MULTI_ARRAYS = STRUCT_FIELDS


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
    #: the member plans' content hashes, in order (None when carried or
    #: assembled by hand: a cost batch is then checked by shape only)
    plan_hashes: Optional[tuple] = None
    #: each graph's link records (None unless every member carries them):
    #: its edge slots' link ids, pads in its own dummy bin nlinks[g]
    elinkp: Optional[np.ndarray] = None     # [G, nlv_p, Emax] int32
    nlinks: Optional[np.ndarray] = None     # [G] int64
    link_classes: Optional[tuple] = None    # G arrays [nlinks[g]] int32

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

    def content_hash(self) -> str:
        """Order-sensitive SHA1 over the envelope and the member plans'
        hashes (reference ``compile.py:993``)."""
        if self.plan_hashes is None:
            raise ValueError("this MultiPlan carries no member plan hashes "
                             "(pack it with pack_plans)")
        sha = hashlib.sha1(b"multi-plan-v1")
        sha.update(repr(self.shape_key).encode())
        for ph in self.plan_hashes:
            sha.update(ph.encode())
        return sha.hexdigest()


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
    links = all(p.elinkp is not None for p in plans)
    return MultiPlan(
        **{f: np.stack([getattr(p, f) for p in padded])
           for f in MULTI_ARRAYS},
        nv=np.asarray([p.nv for p in plans], dtype=np.int64),
        nlevels=np.asarray([p.nlevels for p in plans], dtype=np.int64),
        nclass=nc, Dmax=env[2],
        plan_hashes=tuple(p.content_hash() for p in plans),
        elinkp=np.stack([p.elinkp for p in padded]) if links else None,
        nlinks=(np.asarray([p.nlinks for p in plans], dtype=np.int64)
                if links else None),
        link_classes=(tuple(p.link_classes for p in plans) if links
                      else None))


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

    Each edge's physical link id rides in ``elink`` (pads and edges
    without a link in the dummy bin ``nlinks``), as in the reference;
    :meth:`from_plan` re-lays a dense plan as these lists (the per-call
    ``backend="sparse"`` override) and :meth:`content_hash` keys the
    result cache.
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
    # physical-link ids per edge (pad → nlinks, the dummy bin)
    elink: Optional[np.ndarray] = None        # [ne_p] int32
    nlinks: int = 0
    link_classes: Optional[np.ndarray] = None  # [nlinks] int32

    @property
    def nlv_p(self) -> int:
        return int(self.level_ptr.shape[0]) - 1

    def sparse_bytes(self) -> int:
        """Bytes the sparse backend stages for this plan (the reference's
        count: the plan's arrays, before the per-device casts)."""
        return sum(getattr(self, n).nbytes for n in SPARSE_ARRAYS)

    def content_hash(self) -> str:
        """SHA1 over the plan's scalars and slot lists (memoized;
        reference ``compile.py:1150-1164``), which keys the result cache."""
        h = getattr(self, "_hash", None)
        if h is None:
            h = self._hash = _sha1(
                b"sparse-plan-v1",
                (getattr(self, n) for n in SPARSE_ARRAYS if n != "elat_sum"),
                (self.nv, self.ne, self.nclass, self.nlevels))
        return h

    @classmethod
    def from_plan(cls, c: CompiledPlan) -> "SparsePlan":
        """A dense plan re-laid as slot lists (the per-call
        ``run(backend="sparse")`` override; reference
        ``compile.py:1166-1196``): the edge-position records recover every
        edge in original order, and ascending flat slots are compact
        level-major order, so the result is what :func:`compile_sparse`
        builds from the graph, links included."""
        c._need_epos("re-laying the plan as slot lists")
        Vmax, dummy = c.Vmax, c.nlv_p * c.Vmax
        slots = np.nonzero(c.valid_flat[:dummy])[0]
        compact = np.full(dummy + 1, -1, dtype=np.int64)
        compact[slots] = np.arange(c.nv, dtype=np.int64)
        lvl = c.epos_lvl.astype(np.int64)
        es = c.epos_e.astype(np.int64)
        esrc_c = compact[c.esrc[lvl, es].astype(np.int64)]
        edst_c = compact[lvl * Vmax + c.epos_dst.astype(np.int64)]
        eorder = np.argsort(edst_c, kind="stable")
        vlvl_s = slots // Vmax
        v_ptr = np.searchsorted(vlvl_s, np.arange(c.nlevels + 1))
        level_ptr = np.searchsorted(lvl[eorder], np.arange(c.nlevels + 1))
        return _assemble_sparse(
            nv=c.nv, nc=c.nclass, nlevels=c.nlevels,
            esrc_s=esrc_c[eorder], edst_s=edst_c[eorder],
            econst_s=c.econst[lvl, es][eorder],
            egap_s=c.egap[lvl, es][eorder],
            egclass_s=c.egclass[lvl, es][eorder],
            elat_s=c.elat[lvl, es][eorder],
            vcost_s=c.vcost_lv[vlvl_s, slots % Vmax],
            vert_s=c.vert_of_slot[slots],
            level_ptr=level_ptr, v_ptr=v_ptr,
            elink_s=(None if c.elinkp is None
                     else c.elinkp[lvl, es][eorder]),
            nlinks=c.nlinks, link_classes=c.link_classes)


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
                     level_ptr: np.ndarray, v_ptr: np.ndarray,
                     elink_s: Optional[np.ndarray] = None, nlinks: int = 0,
                     link_classes: Optional[np.ndarray] = None
                     ) -> SparsePlan:
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
        Emax_lv=Emax_lv, Vmax_lv=Vmax_lv,
        elink=(None if elink_s is None
               else padv(elink_s.astype(np.int32), ne_p, nlinks, np.int32)),
        nlinks=nlinks, link_classes=link_classes)


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
    nlinks, elink_s, link_classes = _edge_links(g, eorder)
    return _assemble_sparse(
        nv=nv, nc=g.nclass, nlevels=nlevels,
        esrc_s=slot_of_vertex[g.esrc[eorder].astype(np.int64)],
        edst_s=slot_of_vertex[g.edst[eorder].astype(np.int64)],
        econst_s=g.econst[eorder].astype(np.float64),
        egap_s=egap_o[eorder], egclass_s=egclass_o[eorder],
        elat_s=g.elat[eorder].astype(np.float64),
        vcost_s=g.vcost[vorder].astype(np.float64),
        vert_s=vorder, level_ptr=level_ptr, v_ptr=v_ptr,
        elink_s=elink_s, nlinks=nlinks,
        link_classes=link_classes if elink_s is not None else None)


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
