"""Network-topology analysis (paper §IV-2, Appendix H).

The paper replaces each message's end-to-end latency with
``(h+1)·l_wire + h·d_switch`` where ``h`` is the hop count given by the
topology, making the *wire* latency a decision variable.  We implement hop
models for the paper's Fat Tree and Dragonfly plus the TPU 2D/3D torus
(ICI is a torus; DCN connects pods), and a builder hook that stamps edges
with per-class hop multiplicities so the DAG/LP engines can answer
"how much FEC-induced wire latency can this workload absorb?" (Fig 11).

Latency classes under a topology params object:
  class 0 = l_wire   (decision variable; multiplicity h+1 per message)
  const  += h·d_switch (folded into the edge constant)
For Dragonfly, the heterogeneous variant (Fig 19) uses three wire classes
(terminal / intra-group / inter-group).

A numpy copy of the JAX package's ``repro/core/topology.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .loggps import LogGPS


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    nranks: int
    hops: Callable[[int, int], int]        # switch hops between nodes
    # heterogeneous wire classes (Fig 19): returns tuple of (class, count)
    wire_classes: Callable[[int, int], tuple] = None
    nclasses: int = 1


def fat_tree(k: int, tiers: int = 3) -> Topology:
    """Three-tier fat tree, radix k: nodes dense under edge switches.

    k/2 hosts per edge switch; pods of (k/2)^2 hosts share an agg layer.
    hops: same edge switch = 1; same pod = 3; cross-pod = 5 (tiers=3).
    """
    per_edge = k // 2
    per_pod = (k // 2) ** 2
    n = per_pod * k  # k pods

    def hops(a: int, b: int) -> int:
        if a == b:
            return 0
        if a // per_edge == b // per_edge:
            return 1
        if a // per_pod == b // per_pod:
            return 3
        return 5

    return Topology(name=f"fat_tree(k={k})", nranks=n, hops=hops)


def dragonfly(g: int, a: int, p: int) -> Topology:
    """Dragonfly(g groups, a switches/group, p hosts/switch); minimal routing.

    hops: same switch = 1, same group = 2, cross-group = 3 (paper assumes
    minimal routing and disregards h beyond that; we keep the standard
    minimal hop counts).
    """
    per_sw = p
    per_grp = a * p
    n = g * per_grp

    def hops(x: int, y: int) -> int:
        if x == y:
            return 0
        if x // per_sw == y // per_sw:
            return 1
        if x // per_grp == y // per_grp:
            return 2
        return 3

    def wire_classes(x: int, y: int) -> tuple:
        """(terminal, intra, inter) wire counts per Fig 19."""
        if x == y:
            return ()
        if x // per_sw == y // per_sw:
            return ((0, 2),)                       # 2 terminal wires
        if x // per_grp == y // per_grp:
            return ((0, 2), (1, 1))                # + 1 intra-group wire
        return ((0, 2), (1, 1), (2, 1))            # + 1 inter-group wire

    return Topology(name=f"dragonfly(g={g},a={a},p={p})", nranks=n,
                    hops=hops, wire_classes=wire_classes, nclasses=3)


def torus(dims: tuple) -> Topology:
    """TPU ICI torus (e.g. (16,16) for a v5e pod). hops = wrapped manhattan."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))

    def coords(r: int):
        out = []
        for d in reversed(dims):
            out.append(r % d)
            r //= d
        return tuple(reversed(out))

    def hops(a: int, b: int) -> int:
        ca, cb = coords(a), coords(b)
        h = 0
        for d, (x, y) in zip(dims, zip(ca, cb)):
            dist = abs(x - y)
            h += min(dist, d - dist)
        return h

    return Topology(name=f"torus{dims}", nranks=n, hops=hops)


def multipod_torus(pods: int, dims: tuple) -> Topology:
    """`pods` ICI tori joined by DCN: cross-pod hop count set to torus
    diameter + 2 (NIC in/out) — class split done by wire_classes."""
    base = torus(dims)
    n = pods * base.nranks
    diam = sum(d // 2 for d in dims)

    def hops(a: int, b: int) -> int:
        pa, pb = a // base.nranks, b // base.nranks
        if pa == pb:
            return base.hops(a % base.nranks, b % base.nranks)
        return diam + 2

    def wire_classes(a: int, b: int) -> tuple:
        pa, pb = a // base.nranks, b // base.nranks
        if pa == pb:
            h = base.hops(a % base.nranks, b % base.nranks)
            return ((0, h),) if h else ()
        return ((0, diam), (1, 1))   # class 1 = DCN link

    return Topology(name=f"{pods}x torus{dims}+dcn", nranks=n, hops=hops,
                    wire_classes=wire_classes, nclasses=2)


def topology_params(topo: Topology, l_wire_us: float = 0.274,
                    d_switch_us: float = 0.108, ici_gbps: float = 50.0,
                    o_us: float = 0.5) -> LogGPS:
    """LogGPS params whose latency classes are the topology's wire classes.

    Paper constants (Zambre et al.): l_wire = 274 ns, d_switch = 108 ns.
    """
    nc = topo.nclasses
    return LogGPS(L=tuple([l_wire_us] * nc), G=tuple([1.0 / (ici_gbps * 1e3)] * nc),
                  o=o_us, S=1e18,
                  class_names=tuple(f"wire{i}" for i in range(nc)))


def message_lat_spec(topo: Topology, src: int, dst: int,
                     d_switch_us: float = 0.108) -> tuple:
    """(lat_classes, const_us) for a message under this topology.

    lat classes carry (h+1)·l_wire as multiplicities (homogeneous case) or
    the Fig 19 class split; const carries h·d_switch.
    """
    h = topo.hops(src, dst)
    const = h * d_switch_us
    if topo.wire_classes is not None:
        return topo.wire_classes(src, dst), const
    return ((0, h + 1),), const


class TopologyStamper:
    """Adapter: makes GraphBuilder.add_message emit topology-stamped edges.

    Usage:
        topo = fat_tree(16)
        p = topology_params(topo)
        b = GraphBuilder(n, nclass=topo.nclasses)
        stamp = TopologyStamper(topo, p)
        stamp.message(b, src, dst, nbytes)
    """

    def __init__(self, topo: Topology, params: LogGPS, d_switch_us: float = 0.108):
        self.topo = topo
        self.params = params
        self.d_switch = d_switch_us

    def message(self, b, src: int, dst: int, nbytes: float):
        lat, const = message_lat_spec(self.topo, src, dst, self.d_switch)
        gcost = self.params.gap_cost(nbytes)
        s_v = b.add_send_vertex(src, self.params.o)
        r_v = b.add_recv_vertex(dst, self.params.o)
        # gap share recorded so γ·G scenarios re-scale only the (s-1)·G term,
        # never the h·d_switch constant folded in alongside it
        cls = self.params.link_class(src, dst)
        b.add_edge(s_v, r_v, const_us=const + gcost, nbytes=nbytes, lat=lat,
                   gap_us=gcost, gclass=cls,
                   link=b.intern_link(cls, src, dst))
        return s_v, r_v
