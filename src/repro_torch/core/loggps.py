"""LogGPS parameter sets (paper §II-A) with a pluggable network-class registry.

The paper's LogGPS has scalar L/o/g/G/S.  We generalize L and G to *link
classes* so a single parameter object covers:
  - homogeneous clusters (1 class — the paper's main experiments),
  - TPU pods (ICI intra-pod vs DCN pod-crossing),
  - pods with a distinct intra-node fabric (NVLink/shared-memory class for
    same-host ranks), and
  - the heterogeneous HLogGP variant of Appendix I (arbitrary rank→class map).

Classes are declared through :class:`NetworkModel` — an ordered registry of
named :class:`NetClass` entries, each carrying its base latency L, gap/byte G
and congestion parameters α/β (used by the sweep engine's congestion fixed
point: the effective gap of a link is inflated by ``1 + α·max(util − β, 0)``
once its utilization exceeds β).  ``NetworkModel.params()`` lowers the
registry to the flat :class:`LogGPS` tuples every analysis consumes.

o (per-message CPU overhead) and g (msg gap) stay scalar as in the paper
("we assume o, g and computational power are the same across all ranks",
Appendix I).  The paper omits g because o > g on their testbed; we keep it
available but default it to 0 for graph analyses (the DES honors it).

This is a copy of the JAX package's ``repro/core/loggps.py`` (numpy
only): the PyTorch package imports nothing from ``repro``, and the two
copies must build bit-identical graphs for the parity tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LogGPS:
    """All times in µs, G in µs/byte, S in bytes.

    ``alpha``/``beta`` are per-class congestion parameters (dimensionless
    slope / utilization threshold).  Empty tuples mean "no congestion
    declared" and behave as all-zero — the congestion fixed point is then a
    no-op, bit-identical to the plain forward.
    """

    L: tuple = (1.0,)           # per-class base latency (µs)
    G: tuple = (2.0e-5,)        # per-class gap/byte (µs/B); 2e-5 µs/B = 50 GB/s
    o: float = 0.5              # per-message CPU overhead (µs)
    g: float = 0.0              # inter-message gap (µs); 0 = omitted (o > g)
    S: float = 256e3            # rendezvous threshold (bytes)
    class_names: tuple = ("net",)
    # rank → class mapping for p2p links; default: single class
    rank_of_class: Optional[Callable[[int, int], int]] = None
    alpha: tuple = ()           # per-class congestion slope ((), = all zero)
    beta: tuple = ()            # per-class utilization threshold

    @property
    def nclass(self) -> int:
        return len(self.L)

    @property
    def alpha_full(self) -> tuple:
        """``alpha`` padded/defaulted to one entry per class."""
        return self.alpha if len(self.alpha) == self.nclass \
            else (0.0,) * self.nclass

    @property
    def beta_full(self) -> tuple:
        return self.beta if len(self.beta) == self.nclass \
            else (0.0,) * self.nclass

    def class_index(self, name: str) -> int:
        """Registry lookup: class name → index (raises on unknown names)."""
        try:
            return self.class_names.index(name)
        except ValueError:
            raise ValueError(
                f"unknown network class {name!r}; registered classes are "
                f"{list(self.class_names)}") from None

    def link_class(self, src_rank: int, dst_rank: int) -> int:
        if self.rank_of_class is None:
            return 0
        return self.rank_of_class(src_rank, dst_rank)

    def gap_cost(self, nbytes: float, src_rank: int = 0, dst_rank: int = 0) -> float:
        """(s-1)·G for the link's class, in µs."""
        c = self.link_class(src_rank, dst_rank)
        return max(nbytes - 1.0, 0.0) * self.G[c]

    def with_delta(self, dL, cls: Optional[int] = None) -> "LogGPS":
        """Return params with ΔL (µs) added to one class (or all if None)."""
        L = list(self.L)
        if cls is None:
            L = [x + dL for x in L]
        else:
            L[cls] = L[cls] + dL
        return dataclasses.replace(self, L=tuple(L))

    def replace(self, **kw) -> "LogGPS":
        return dataclasses.replace(self, **kw)


def resolve_class(params, cls) -> int:
    """Resolve a class selector (index or registered name) to an index.

    Every N-class grid/curve entry point accepts either form; strings go
    through the params' class-name registry so e.g. ``cls="dcn"`` works on
    any model that registered a "dcn" class, regardless of its position.
    """
    if isinstance(cls, str):
        return params.class_index(cls)
    c = int(cls)
    if not 0 <= c < params.nclass:
        raise ValueError(
            f"class index {c} out of range for {params.nclass}-class params "
            f"{list(params.class_names)}")
    return c


@dataclasses.dataclass(frozen=True)
class NetClass:
    """One registered latency class: name + L/G + congestion α/β."""

    name: str
    L_us: float                 # base latency (µs)
    G_us_per_byte: float        # gap per byte (µs/B)
    alpha: float = 0.0          # congestion slope (0 = load-independent)
    beta: float = 0.0           # utilization threshold before inflation

    @staticmethod
    def from_gbps(name: str, L_us: float, gbps: float,
                  alpha: float = 0.0, beta: float = 0.0) -> "NetClass":
        """Bandwidth-style constructor: GB/s → µs/B (1 GB/s = 1e3 B/µs)."""
        return NetClass(name=name, L_us=L_us, G_us_per_byte=1.0 / (gbps * 1e3),
                        alpha=alpha, beta=beta)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Ordered registry of :class:`NetClass` entries + a rank→class map.

    The class *index* is the position in ``classes``; analyses may select
    classes by name (via :func:`resolve_class`).  ``link_class(src, dst)``
    decides which class a p2p message between two ranks travels on.
    """

    classes: tuple              # tuple[NetClass, ...]
    rank_of_class: Optional[Callable[[int, int], int]] = None
    o: float = 0.5
    g: float = 0.0
    S: float = 256e3

    @property
    def nclass(self) -> int:
        return len(self.classes)

    @property
    def names(self) -> tuple:
        return tuple(c.name for c in self.classes)

    def class_index(self, name: str) -> int:
        for i, c in enumerate(self.classes):
            if c.name == name:
                return i
        raise ValueError(
            f"unknown network class {name!r}; registered classes are "
            f"{list(self.names)}")

    def with_class(self, cls: NetClass) -> "NetworkModel":
        """Return a model with ``cls`` appended (or replaced, by name)."""
        out = list(self.classes)
        for i, c in enumerate(out):
            if c.name == cls.name:
                out[i] = cls
                break
        else:
            out.append(cls)
        return dataclasses.replace(self, classes=tuple(out))

    def params(self) -> LogGPS:
        """Lower the registry to the flat LogGPS tuples analyses consume."""
        if len({c.name for c in self.classes}) != len(self.classes):
            raise ValueError(f"duplicate class names in {self.names}")
        return LogGPS(
            L=tuple(c.L_us for c in self.classes),
            G=tuple(c.G_us_per_byte for c in self.classes),
            o=self.o, g=self.g, S=self.S,
            class_names=self.names,
            rank_of_class=self.rank_of_class,
            alpha=tuple(c.alpha for c in self.classes),
            beta=tuple(c.beta for c in self.classes),
        )


def cluster_params(L_us: float = 3.0, G_ns_per_byte: float = 0.018,
                   o_us: float = 5.0, S_bytes: float = 256e3) -> LogGPS:
    """The paper's CSCS testbed constants (§III-B): L=3µs, G=0.018ns/B, S=256KB.

    o was matched per application (5–32 µs); default to LULESH's 5 µs.
    """
    return LogGPS(L=(L_us,), G=(G_ns_per_byte * 1e-3,), o=o_us, S=S_bytes,
                  class_names=("ib",))


def pod_model(pod_size: int, ranks_per_host: Optional[int] = None,
              L_node_us: float = 0.2, L_ici_us: float = 1.0,
              L_dcn_us: float = 10.0, node_gbps: float = 300.0,
              ici_gbps: float = 50.0, dcn_gbps: float = 25.0,
              o_us: float = 0.5, S_bytes: float = 1e9,
              alpha: Optional[dict] = None,
              beta: Optional[dict] = None) -> NetworkModel:
    """Pod-shaped :class:`NetworkModel`: ICI intra-pod, DCN across pods,
    and — when ``ranks_per_host`` is given — a distinct intra-node class
    (NVLink/shared-memory) for ranks on the same host.

    Ranks are laid out pod-major (and host-major within a pod).  With
    ``ranks_per_host=None`` the model has exactly the two classic classes
    ("ici", "dcn").  ``alpha``/``beta`` are optional dicts keyed by
    class name setting per-class congestion parameters.  S defaults to
    effectively-infinite: XLA collectives are one-sided DMA (no rendezvous
    handshake at the LogGPS level).
    """
    alpha = alpha or {}
    beta = beta or {}

    def nc(name: str, L: float, gbps: float) -> NetClass:
        return NetClass.from_gbps(name, L, gbps,
                                  alpha=float(alpha.get(name, 0.0)),
                                  beta=float(beta.get(name, 0.0)))

    unknown = (set(alpha) | set(beta)) - (
        {"ici", "dcn"} | ({"node"} if ranks_per_host else set()))
    if unknown:
        raise ValueError(f"alpha/beta name(s) {sorted(unknown)} not in model")

    if ranks_per_host is None:
        classes = (nc("ici", L_ici_us, ici_gbps),
                   nc("dcn", L_dcn_us, dcn_gbps))

        def link_class(a: int, b: int) -> int:
            return 0 if (a // pod_size) == (b // pod_size) else 1
    else:
        rph = int(ranks_per_host)
        if not 0 < rph <= pod_size:
            raise ValueError(
                f"ranks_per_host={rph} must be in (0, pod_size={pod_size}]")
        classes = (nc("node", L_node_us, node_gbps),
                   nc("ici", L_ici_us, ici_gbps),
                   nc("dcn", L_dcn_us, dcn_gbps))

        def link_class(a: int, b: int) -> int:
            if a // rph == b // rph:
                return 0
            return 1 if (a // pod_size) == (b // pod_size) else 2

    return NetworkModel(classes=classes, rank_of_class=link_class,
                        o=o_us, S=S_bytes)


def edge_costs(graph, params: LogGPS) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate edge costs for a parameter assignment.

    Returns (w_const, w_total):
      w_const[e] = econst (already includes (s-1)G from build time)
      w_total[e] = w_const + Σ_c elat[e,c] · L_c
    Build-time G is used (graphs embed (s-1)G into econst via add_message);
    analyses that vary G should rebuild or use `rescale_G`.
    """
    Lvec = np.asarray(params.L, dtype=np.float64)
    if graph.nclass != Lvec.shape[0]:
        raise ValueError(f"graph has {graph.nclass} latency classes, params {Lvec.shape[0]}")
    w = graph.econst + graph.elat.astype(np.float64) @ Lvec
    return graph.econst, w
