"""Discrete-event LogGPS simulator — the LogGOPSim role (paper §II-D3, Fig 7).

Replays an :class:`ExecutionGraph` with a priority queue, modeling per-rank
CPU occupancy (o per message vertex, calc costs) and the message gap g.
This is the *baseline* LLAMP outperforms; it also powers the validation
loop: the latency injector variants of Fig 8 are implemented here, so we can
"measure" runtimes under injected ΔL and compare with LP predictions
(§III) without physical hardware.

Injector modes (Fig 8):
  "flow"      — (D) our delay-thread design: ΔL added per message at the
                flow level; neither sender nor receiver progress is blocked.
  "sender"    — (B) Underwood-style: the *send* operation itself is delayed
                by ΔL, stalling the sender's op chain.
  "progress"  — (C) single progress thread on the receiver: delays are
                serialized per receiving rank (ΔL-busy server), so
                back-to-back messages accumulate ~2ΔL.
  "contention" — per-link single-server queueing on the (s−1)·G gap
                shares: every message edge occupies its physical link
                (``g.elink``, or an interned (class, src, dst) link for
                graphs without recorded ids) for its gap share before the
                wire latency starts, so overlapping transfers on one link
                serialize.  This is the ground truth the sweep engine's
                congestion fixed point (``ExecPolicy(congestion=
                "fixed_point")``) approximates with a utilization-driven
                effective-G inflation; ΔL still injects flow-style on top.
  "fault"     — resilience ground truth (``fault=`` dict): per-vertex
                compute slowdown multipliers (stragglers) plus per-class
                latency additions and gap inflations (degraded links),
                the states ``sensitivity.resilience_curve`` predicts via
                the batched K/S fault axes.  ΔL injects flow-style on top.

This is a copy of the JAX package's ``repro/core/simulator.py`` (numpy
only): the PyTorch package imports nothing from ``repro``.  Like
``core.dag`` it is a host oracle (a heap-driven event loop), not a device
path.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from .graph import ExecutionGraph, SEND, RECV
from .loggps import LogGPS


@dataclasses.dataclass
class SimResult:
    T: float
    t_start: np.ndarray
    t_end: np.ndarray
    events: int


def simulate(g: ExecutionGraph, params: LogGPS, delta_L: float = 0.0,
             injector: str = "flow", inject_class: Optional[int] = None,
             model_gap: bool = True, fault: Optional[dict] = None) -> SimResult:
    """Event-driven replay. delta_L (µs) is injected per message edge.

    inject_class: restrict injection to one latency class (None = all).

    fault (``injector="fault"`` only): a dict of degraded states —
      "slowdown"  {vertex: multiplier} or [nv] array of per-vertex
                  compute-cost multipliers (stragglers),
      "extra_L"   {class: µs} per-class base-latency addition,
      "gscale"    {class: γ} per-class gap inflation (γ > 1 = slower;
                  applied to the per-edge (s−1)·G gap shares).
    Class keys resolve through the params registry (index or name).
    """
    if injector not in ("flow", "sender", "progress", "contention", "fault"):
        raise ValueError(
            f"injector must be 'flow', 'sender', 'progress', 'contention' "
            f"or 'fault', got {injector!r}")
    if (fault is not None) != (injector == "fault"):
        raise ValueError("fault= requires injector='fault' (and vice versa)")
    nv = g.num_vertices
    ne = g.num_edges
    Lvec = np.asarray(params.L, dtype=np.float64)

    slow = None
    gap_extra = None
    if injector == "fault":
        from .loggps import resolve_class
        bad = set(fault) - {"slowdown", "extra_L", "gscale"}
        if bad:
            raise ValueError(f"unknown fault key(s) {sorted(bad)}; expected "
                             "'slowdown', 'extra_L', 'gscale'")
        sl = fault.get("slowdown")
        if sl is not None:
            if isinstance(sl, dict):
                slow = np.ones(nv)
                for v, m in sl.items():
                    slow[int(v)] = float(m)
            else:
                slow = np.asarray(sl, dtype=np.float64)
                if slow.shape != (nv,):
                    raise ValueError(f"slowdown array must be [{nv}], "
                                     f"got {slow.shape}")
        Lvec = Lvec.copy()
        for c, dl in (fault.get("extra_L") or {}).items():
            Lvec[resolve_class(params, c)] += float(dl)
        gs = fault.get("gscale")
        if gs is not None:
            from .graph import edge_gap_shares
            gvec = np.ones(params.nclass)
            for c, gamma in gs.items():
                gvec[resolve_class(params, c)] = float(gamma)
            egap, egclass = edge_gap_shares(g, params)
            gap_extra = egap * (gvec[egclass] - 1.0)

    # per-edge latency cost and message-ness
    lat_edge = g.elat.astype(np.float64) @ Lvec
    is_msg = g.ebytes > 0
    n_lat = (g.elat.sum(axis=1) if inject_class is None
             else g.elat[:, inject_class]).astype(np.float64)

    # contention: per-link single-server occupancy on the gap shares
    link_gap = link_of = link_free = None
    if injector == "contention":
        from .graph import edge_gap_shares
        link_gap, link_cls = edge_gap_shares(g, params)
        if g.elink is not None and g.elink.shape[0] == ne:
            link_of = g.elink.astype(np.int64).copy()
        else:
            link_of = np.full(ne, -1, dtype=np.int64)
        # edges without a recorded link id (hand-built graphs, raw
        # add_edge callers) still need a physical-link key: intern one
        # per (class, src rank, dst rank), matching GraphBuilder's scheme
        need = (link_of < 0) & is_msg
        if need.any():
            nxt = int(link_of.max(initial=-1)) + 1
            interned: dict = {}
            for e in np.nonzero(need)[0]:
                key = (int(link_cls[e]), int(g.vrank[g.esrc[e]]),
                       int(g.vrank[g.edst[e]]))
                lid = interned.get(key)
                if lid is None:
                    lid = interned[key] = nxt
                    nxt += 1
                link_of[e] = lid
            link_free = np.zeros(nxt)
        else:
            link_free = np.zeros(int(link_of.max(initial=-1)) + 1)

    indeg = np.bincount(g.edst, minlength=nv).astype(np.int64)
    # CSR by source
    order = np.argsort(g.esrc, kind="stable")
    out_edge = order
    counts = np.bincount(g.esrc, minlength=nv)
    out_ptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(counts, out=out_ptr[1:])

    t_ready = np.zeros(nv)            # max over arrived deps
    t_start = np.zeros(nv)
    t_end = np.zeros(nv)
    rank_free = np.zeros(g.nranks)    # CPU availability per rank
    rank_gap = np.zeros(g.nranks)     # g-gap: earliest next message op
    delay_server = np.zeros(g.nranks)  # Fig 8C progress-thread serialization

    heap: list = []
    events = 0
    for v in np.nonzero(indeg == 0)[0]:
        heapq.heappush(heap, (0.0, int(v)))

    kind = g.kind
    vcost = g.vcost
    vrank = g.vrank
    ggap = params.g if model_gap else 0.0

    while heap:
        t_avail, v = heapq.heappop(heap)
        events += 1
        r = vrank[v]
        start = max(t_avail, t_ready[v], rank_free[r])
        if ggap and kind[v] in (SEND, RECV):
            start = max(start, rank_gap[r])
            rank_gap[r] = start + ggap
        cost = vcost[v] if slow is None else vcost[v] * slow[v]
        if injector == "sender" and kind[v] == SEND and delta_L > 0:
            cost = cost + delta_L  # Fig 8B: the send op itself stalls ΔL
        t_start[v] = start
        end = start + cost
        t_end[v] = end
        rank_free[r] = end

        # deliver to successors
        for k in range(out_ptr[v], out_ptr[v + 1]):
            e = out_edge[k]
            w = g.edst[e]
            base = end
            if (link_free is not None and is_msg[e] and link_gap[e] > 0
                    and link_of[e] >= 0):
                # the transfer holds its link for the gap share before the
                # wire latency starts; queued transfers wait for release
                l = link_of[e]
                base = max(end, link_free[l])
                link_free[l] = base + link_gap[e]
            arr = base + g.econst[e] + lat_edge[e]
            if gap_extra is not None:
                arr += gap_extra[e]
            if is_msg[e] and delta_L > 0 and n_lat[e] > 0:
                if injector in ("flow", "contention", "fault"):
                    arr += delta_L * n_lat[e]          # Fig 8D: pure flow delay
                elif injector == "progress":
                    # Fig 8C: per-receiver delay server busy ΔL per message
                    rr = vrank[w]
                    rel = max(arr, delay_server[rr]) + delta_L
                    delay_server[rr] = rel
                    arr = rel
                # "sender" already applied at the send vertex
            t_ready[w] = max(t_ready[w], arr)
            indeg_w = indeg[w] - 1
            indeg[w] = indeg_w
            if indeg_w == 0:
                heapq.heappush(heap, (t_ready[w], int(w)))

    return SimResult(T=float(t_end.max(initial=0.0)), t_start=t_start,
                     t_end=t_end, events=events)


def runtime_sweep(g: ExecutionGraph, params: LogGPS, deltas,
                  injector: str = "flow") -> np.ndarray:
    """Measured-runtime curve under injected ΔL (the paper's x-axis)."""
    return np.asarray([simulate(g, params, float(d), injector=injector).T
                       for d in deltas])
