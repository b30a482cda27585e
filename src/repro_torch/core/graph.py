"""MPI-style execution graphs (Schedgen analog).

An :class:`ExecutionGraph` is a DAG over three vertex kinds — ``calc``,
``send`` and ``recv`` (paper §II-A) — stored as flat numpy arrays so that
multi-million-vertex graphs (paper Table I runs up to 156M events) stay
cheap to traverse.

Edges carry a *latency-class multiplicity vector*: a plain eager message
contributes one unit of its link's latency class (cost ``ℓ_c + (s-1)·G_c``),
while a topology-expanded message may contribute e.g. 3 wire hops and
2 switch constants (Appendix H).  This generalization lets the same engine
answer end-to-end-latency questions (classes = {ICI, DCN}) and wire-latency
questions (classes = {terminal, intra, inter}) without rebuilding graphs.

This is a copy of the JAX package's ``repro/core/graph.py`` (numpy
only): the PyTorch package imports nothing from ``repro``, and the two
copies must build bit-identical graphs for the parity tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Vertex kinds
CALC = 0
SEND = 1
RECV = 2
SYNC = 3  # rendezvous handshake join vertex (Appendix B)

_KIND_NAMES = {CALC: "calc", SEND: "send", RECV: "recv", SYNC: "sync"}


@dataclasses.dataclass
class ExecutionGraph:
    """Immutable CSR view of a built execution graph.

    Vertex arrays (length ``nv``):
      kind     int8     CALC/SEND/RECV/SYNC
      vcost    float64  intrinsic vertex cost in µs (calc time, or ``o`` for send/recv)
      vrank    int32    owning rank (device)

    Edge arrays (length ``ne``), CSR by destination after `finalize`:
      esrc, edst   int32
      econst       float64  constant part of the edge cost in µs (e.g. (s-1)·G)
      ebytes       float64  message payload bytes (0 for dependency edges)
      elat         int16[ne, nclass]  latency-class multiplicities
      egap         float64  the (s-1)·G share of econst recorded at build time
      egclass      int32    latency class of that gap share

    ``egap``/``egclass`` make the gap decomposition self-describing: bandwidth
    scenarios (γ·G sweeps) read the exact build-time share off the graph
    instead of reconstructing it from a parameter object that may no longer
    match (the old ``compile_plan(params=...)`` caveat).  Graphs finalized by
    :class:`GraphBuilder` always carry them; a NaN entry means "share
    unknown" (a raw ``add_edge(nbytes=...)`` call that didn't pass
    ``gap_us``), and hand-constructed graphs may leave the arrays ``None``
    entirely — :func:`edge_gap_shares` resolves either case to a concrete
    decomposition, reconstructing unknown shares from params when given.
    """

    kind: np.ndarray
    vcost: np.ndarray
    vrank: np.ndarray
    esrc: np.ndarray
    edst: np.ndarray
    econst: np.ndarray
    ebytes: np.ndarray
    elat: np.ndarray  # (ne, nclass) int16
    nclass: int
    nranks: int
    egap: Optional[np.ndarray] = None     # (ne,) float64
    egclass: Optional[np.ndarray] = None  # (ne,) int32
    # physical-link interning (congestion analyses aggregate load per link):
    # elink[e] is a dense link id in [0, nlinks) for message edges, -1 for
    # dependency/handshake edges; link_classes[l] is the latency class of
    # link l.  None on hand-constructed graphs (= no link information).
    elink: Optional[np.ndarray] = None    # (ne,) int32
    nlinks: int = 0
    link_classes: Optional[np.ndarray] = None  # (nlinks,) int32
    # CSR-by-destination (computed in finalize)
    in_ptr: np.ndarray = None  # (nv+1,)
    in_edge: np.ndarray = None  # (ne,) edge ids sorted by dst
    level: np.ndarray = None  # (nv,) topological level
    nlevels: int = 0

    @property
    def num_vertices(self) -> int:
        return int(self.kind.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.esrc.shape[0])

    @property
    def num_events(self) -> int:
        """Paper-style event count (vertices + message edges)."""
        return self.num_vertices + int((self.ebytes > 0).sum())

    def validate(self) -> None:
        nv = self.num_vertices
        assert self.esrc.min(initial=0) >= 0 and self.edst.max(initial=-1) < nv
        # topological consistency: every edge goes to a strictly higher level
        assert (self.level[self.esrc] < self.level[self.edst]).all(), "graph has a cycle"

    def summary(self) -> str:
        kinds = {name: int((self.kind == k).sum()) for k, name in _KIND_NAMES.items()}
        return (
            f"ExecutionGraph(nv={self.num_vertices}, ne={self.num_edges}, "
            f"ranks={self.nranks}, levels={self.nlevels}, classes={self.nclass}, "
            f"kinds={kinds})"
        )


class GraphBuilder:
    """Two-phase builder: append vertices/edges freely, then ``finalize()``.

    Per-rank op chains are linked automatically: every vertex added to rank r
    gains a dependency edge from the previous vertex on r (program order),
    mirroring how Schedgen serializes each rank's trace.
    """

    def __init__(self, nranks: int, nclass: int = 1):
        self.nranks = nranks
        self.nclass = nclass
        self._kind: list[int] = []
        self._vcost: list[float] = []
        self._vrank: list[int] = []
        self._esrc: list[int] = []
        self._edst: list[int] = []
        self._econst: list[float] = []
        self._ebytes: list[float] = []
        self._elat: list[tuple] = []  # sparse: list of (class, mult) tuples
        self._egap: list[float] = []  # (s-1)·G share of econst per edge
        self._egclass: list[int] = []
        self._elink: list[int] = []   # interned link id per edge (-1 = none)
        self._links: dict[tuple, int] = {}  # (class, src, dst) -> link id
        self._link_cls: list[int] = []      # class per interned link
        self._tail = [-1] * nranks  # last vertex id per rank
        self._independent = False  # when True, skip program-order chaining

    # -- vertices ----------------------------------------------------------
    def _add_vertex(self, kind: int, cost: float, rank: int, chain: bool = True) -> int:
        vid = len(self._kind)
        self._kind.append(kind)
        self._vcost.append(float(cost))
        self._vrank.append(rank)
        if chain and not self._independent and self._tail[rank] >= 0:
            self.add_dep(self._tail[rank], vid)
        if chain:
            self._tail[rank] = vid
        return vid

    def add_calc(self, rank: int, cost_us: float) -> int:
        return self._add_vertex(CALC, cost_us, rank)

    def add_send_vertex(self, rank: int, o_us: float) -> int:
        return self._add_vertex(SEND, o_us, rank)

    def add_recv_vertex(self, rank: int, o_us: float) -> int:
        return self._add_vertex(RECV, o_us, rank)

    def add_sync_vertex(self, rank: int) -> int:
        return self._add_vertex(SYNC, 0.0, rank, chain=False)

    # -- edges -------------------------------------------------------------
    def add_dep(self, u: int, v: int) -> None:
        """Zero-cost dependency edge (program order / happens-before)."""
        self._esrc.append(u)
        self._edst.append(v)
        self._econst.append(0.0)
        self._ebytes.append(0.0)
        self._elat.append(())
        self._egap.append(0.0)
        self._egclass.append(0)
        self._elink.append(-1)

    def intern_link(self, cls: int, src_rank: int, dst_rank: int) -> int:
        """Dense id for the directed physical link (class, src, dst).

        Repeated messages between the same rank pair on the same class share
        one id, so per-link load aggregation (the congestion fixed point)
        sees the sum of all traffic on that link.
        """
        key = (int(cls), int(src_rank), int(dst_rank))
        lid = self._links.get(key)
        if lid is None:
            lid = self._links[key] = len(self._link_cls)
            self._link_cls.append(int(cls))
        return lid

    def add_edge(self, u: int, v: int, const_us: float = 0.0, nbytes: float = 0.0,
                 lat: tuple = (), gap_us: Optional[float] = None,
                 gclass: int = 0, link: int = -1) -> None:
        """General edge. ``lat`` is a tuple of (class_id, multiplicity).

        ``gap_us`` records how much of ``const_us`` is the (s-1)·G bandwidth
        term and ``gclass`` which latency class's G produced it, so that γ·G
        scenarios can re-scale it exactly without a parameter object.  An
        explicit ``gap_us`` (including 0.0) is authoritative; omitting it on
        a message edge (``nbytes > 0``) records NaN = "share unknown", which
        analyses resolve by reconstructing from whatever params they hold
        (:func:`edge_gap_shares`).
        """
        self._esrc.append(u)
        self._edst.append(v)
        self._econst.append(float(const_us))
        self._ebytes.append(float(nbytes))
        self._elat.append(tuple(lat))
        if gap_us is None:
            self._egap.append(float("nan") if nbytes > 0 else 0.0)
        else:
            self._egap.append(float(gap_us))
        self._egclass.append(int(gclass))
        self._elink.append(int(link))

    # -- messages (LogGPS-costed at analysis time) --------------------------
    def add_message(self, src_rank: int, dst_rank: int, nbytes: float, params,
                    lat: Optional[tuple] = None) -> tuple[int, int]:
        """Add a point-to-point message: send vertex on src, recv vertex on dst.

        Eager (< S): recv_start ≥ send_end + L + (s-1)G       (paper Fig 3)
        Rendezvous (≥ S): handshake join then transfer         (Appendix B):
            x ≥ send_end + L      (RTS)
            x ≥ recv_end_of_post + L  -- receiver must have posted (CTS path)
            recv_done ≥ x + L + (s-1)G
        Returns (send_vid, recv_done_vid).
        """
        if lat is None:
            lat = ((params.link_class(src_rank, dst_rank), 1),)
        gcls = params.link_class(src_rank, dst_rank)
        gcost = params.gap_cost(nbytes, src_rank, dst_rank)
        lid = self.intern_link(gcls, src_rank, dst_rank)
        s_v = self.add_send_vertex(src_rank, params.o)
        r_v = self.add_recv_vertex(dst_rank, params.o)
        if nbytes < params.S:
            self.add_edge(s_v, r_v, const_us=gcost, nbytes=nbytes, lat=lat,
                          gap_us=gcost, gclass=gcls, link=lid)
        else:
            x = self.add_sync_vertex(dst_rank)
            self.add_edge(s_v, x, const_us=0.0, nbytes=0.0, lat=lat)   # RTS
            self.add_dep(r_v, x)                                        # recv posted
            # CTS + data transfer back onto the receiving rank's chain
            done = self._add_vertex(RECV, 0.0, dst_rank)
            self.add_edge(x, done, const_us=gcost, nbytes=nbytes, lat=lat,
                          gap_us=gcost, gclass=gcls, link=lid)
            return s_v, done
        return s_v, r_v

    # -- structured helpers --------------------------------------------------
    def independent_region(self):
        """Context manager: vertices added inside are not chained automatically."""
        builder = self

        class _Region:
            def __enter__(self):
                builder._independent = True
                return builder

            def __exit__(self, *a):
                builder._independent = False

        return _Region()

    def tail(self, rank: int) -> int:
        return self._tail[rank]

    def set_tail(self, rank: int, vid: int) -> None:
        self._tail[rank] = vid

    # -- finalize ------------------------------------------------------------
    def finalize(self) -> ExecutionGraph:
        nv = len(self._kind)
        ne = len(self._esrc)
        kind = np.asarray(self._kind, dtype=np.int8)
        vcost = np.asarray(self._vcost, dtype=np.float64)
        vrank = np.asarray(self._vrank, dtype=np.int32)
        esrc = np.asarray(self._esrc, dtype=np.int32)
        edst = np.asarray(self._edst, dtype=np.int32)
        econst = np.asarray(self._econst, dtype=np.float64)
        ebytes = np.asarray(self._ebytes, dtype=np.float64)
        elat = np.zeros((ne, self.nclass), dtype=np.int16)
        for i, pairs in enumerate(self._elat):
            for c, m in pairs:
                elat[i, c] += m

        level = _topo_levels(nv, esrc, edst)
        nlevels = int(level.max(initial=0)) + 1 if nv else 0

        order = np.argsort(edst, kind="stable")
        in_edge = order.astype(np.int32)
        counts = np.bincount(edst, minlength=nv)
        in_ptr = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum(counts, out=in_ptr[1:])

        egap = np.asarray(self._egap, dtype=np.float64)
        n_unknown = int(np.isnan(egap).sum())
        if n_unknown:
            # NaN shares silently poison any analysis that consumes g.egap
            # without params-backed reconstruction (edge_gap_shares); flag
            # it once per build instead of letting NaN curves escape.
            import warnings
            warnings.warn(
                f"{n_unknown} message edge(s) were added without a gap_us "
                "share (raw add_edge(nbytes=...) calls); bandwidth (γ·G) "
                "analyses will need a params object to reconstruct the "
                "missing (s-1)·G shares, and g.egap contains NaN entries",
                RuntimeWarning, stacklevel=2)

        g = ExecutionGraph(
            kind=kind, vcost=vcost, vrank=vrank,
            esrc=esrc, edst=edst, econst=econst, ebytes=ebytes, elat=elat,
            nclass=self.nclass, nranks=self.nranks,
            egap=egap,
            egclass=np.asarray(self._egclass, dtype=np.int32),
            elink=np.asarray(self._elink, dtype=np.int32),
            nlinks=len(self._link_cls),
            link_classes=np.asarray(self._link_cls, dtype=np.int32),
            in_ptr=in_ptr, in_edge=in_edge, level=level, nlevels=nlevels,
        )
        g.validate()
        return g


def edge_gap_shares(g: ExecutionGraph, params=None) -> tuple:
    """Resolve per-edge (s−1)·G gap shares in original edge order.

    Returns ``(egap, egclass)`` float64/int64 arrays of length ``ne`` with
    the precedence every bandwidth analysis shares (so the compiled sweep
    path and the scalar path can never disagree):

    1. a share the graph recorded at build time — including an explicit
       0.0 (e.g. built under G=0) — is authoritative;
    2. an *unknown* share (NaN entry from a raw ``add_edge(nbytes=...)``
       call, or ``g.egap is None`` on hand-constructed graphs) is
       reconstructed from ``params`` as max(s−1, 0)·G[link class];
    3. without params, unknown shares resolve to 0 (γ·G scenarios become
       no-ops on those edges; latency sweeps are unaffected either way).
    """
    ne = g.num_edges
    egap = np.zeros(ne, dtype=np.float64)
    egclass = np.zeros(ne, dtype=np.int64)
    if g.egap is not None:
        rec = ~np.isnan(g.egap)
        egap[rec] = g.egap[rec]
        egclass[rec] = g.egclass[rec]
        unknown = ~rec & (g.ebytes > 0)
    else:
        unknown = g.ebytes > 0
    if params is not None and unknown.any():
        idx = np.nonzero(unknown)[0]
        G = np.asarray(params.G, dtype=np.float64)
        if params.rank_of_class is None:
            cls = np.zeros(idx.shape[0], dtype=np.int64)
        else:
            src_r = g.vrank[g.esrc[idx]]
            dst_r = g.vrank[g.edst[idx]]
            cls = np.fromiter(
                (params.link_class(int(a), int(b))
                 for a, b in zip(src_r, dst_r)),
                dtype=np.int64, count=idx.shape[0])
        egclass[idx] = cls
        egap[idx] = np.maximum(g.ebytes[idx] - 1.0, 0.0) * G[cls]
    return egap, egclass


def _topo_levels(nv: int, esrc: np.ndarray, edst: np.ndarray) -> np.ndarray:
    """Longest-path topological levels via vectorized Kahn relaxation."""
    level = np.zeros(nv, dtype=np.int32)
    if nv == 0:
        return level
    indeg = np.bincount(edst, minlength=nv).astype(np.int64)
    # CSR by source for frontier expansion
    order = np.argsort(esrc, kind="stable")
    out_edge = order
    counts = np.bincount(esrc, minlength=nv)
    out_ptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(counts, out=out_ptr[1:])

    frontier = np.nonzero(indeg == 0)[0]
    seen = frontier.size
    cur = 0
    while frontier.size:
        # gather all out-edges of the frontier
        starts = out_ptr[frontier]
        stops = out_ptr[frontier + 1]
        nout = stops - starts
        total = int(nout.sum())
        if total == 0:
            break
        idx = np.repeat(starts, nout) + _ragged_arange(nout)
        eids = out_edge[idx]
        dsts = edst[eids]
        np.maximum.at(level, dsts, level[np.repeat(frontier, nout)] + 1)
        np.subtract.at(indeg, dsts, 1)
        frontier = np.unique(dsts[indeg[dsts] == 0])
        seen += frontier.size
        cur += 1
        if cur > nv:
            raise ValueError("cycle detected in execution graph")
    if seen < nv:
        raise ValueError("cycle detected in execution graph (unreached vertices)")
    return level


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (zero-length groups allowed)."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offsets = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - offsets
