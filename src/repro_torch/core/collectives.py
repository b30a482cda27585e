"""Collective → point-to-point expansion (the Schedgen role, paper §II-A).

Schedgen "is able to substitute collective operations with p2p algorithms
based on user specifications"; the ICON case study (Fig 10) compares
recursive-doubling vs ring allreduce.  We implement the same expansions on
top of :class:`GraphBuilder`, plus the algorithms XLA actually uses on TPU
meshes (ring reduce-scatter/all-gather along an ICI axis, bidirectional
rings, pairwise all-to-all), so framework step graphs can be analyzed under
different collective implementations — the paper's case-study axis.

Every function appends one collective over ``ranks`` (global rank ids) to a
builder.  Per-rank program order is chained by the builder; cross-rank edges
are LogGPS message edges.  Rounds are explicit: rank i's round-r ops depend
on its round-(r-1) ops, which is how Schedgen schedules them.

This is a copy of the JAX package's ``repro/core/collectives.py`` (numpy
only): the PyTorch package imports nothing from ``repro``, and the two
copies must build bit-identical graphs for the parity tests.
"""

from __future__ import annotations

import math
from typing import Sequence

from .graph import GraphBuilder
from .loggps import LogGPS

ALGORITHMS = (
    "ring",                  # reduce-scatter + all-gather ring: 2(P-1) rounds of s/P
    "bidir_ring",            # both directions at once: (P-1) rounds of s/P each way
    "recursive_doubling",    # log2 P rounds of full s
    "recursive_halving",     # RS (halving) + AG (doubling): 2·log2 P rounds
    "tree",                  # binomial reduce + broadcast
)


def _round(b: GraphBuilder, msgs, p: LogGPS) -> None:
    """Emit one communication round with correct dependency structure.

    All send vertices are created first, then all recv vertices: a rank's
    round-r send depends on its round-(r-1) recv (true data dependency) but
    NOT on its own round-r recv — without this two-phase emission, program-
    order chaining would serialize each ring round around the whole ring.
    """
    svs = []
    for (src, dst, nbytes) in msgs:
        svs.append(b.add_send_vertex(src, p.o))
    for (src, dst, nbytes), sv in zip(msgs, svs):
        rv = b.add_recv_vertex(dst, p.o)
        cls = p.link_class(src, dst)
        gcost = p.gap_cost(nbytes, src, dst)
        b.add_edge(sv, rv, const_us=gcost, nbytes=nbytes, lat=((cls, 1),),
                   gap_us=gcost, gclass=cls,
                   link=b.intern_link(cls, src, dst))


def _pairs_round(b: GraphBuilder, pairs, nbytes, p: LogGPS) -> None:
    """One round of symmetric pairwise exchanges."""
    msgs = []
    for (i, j) in pairs:
        msgs.append((i, j, nbytes))
        msgs.append((j, i, nbytes))
    _round(b, msgs, p)


def allreduce(b: GraphBuilder, ranks: Sequence[int], nbytes: float, p: LogGPS,
              algo: str = "ring") -> None:
    P = len(ranks)
    if P <= 1:
        return
    if algo == "ring":
        chunk = nbytes / P
        for _ in range(2 * (P - 1)):
            _round(b, [(ranks[i], ranks[(i + 1) % P], chunk)
                       for i in range(P)], p)
    elif algo == "bidir_ring":
        chunk = nbytes / (2 * P)
        for _ in range(2 * (P - 1)):
            _round(b, [(ranks[i], ranks[(i + 1) % P], chunk)
                       for i in range(P)]
                   + [(ranks[i], ranks[(i - 1) % P], chunk)
                      for i in range(P)], p)
    elif algo == "recursive_doubling":
        _assert_pow2(P, algo)
        for k in range(int(math.log2(P))):
            pairs = [(ranks[i], ranks[i ^ (1 << k)]) for i in range(P)
                     if i < i ^ (1 << k)]
            _pairs_round(b, pairs, nbytes, p)
    elif algo == "recursive_halving":
        _assert_pow2(P, algo)
        logp = int(math.log2(P))
        for k in range(logp):
            sz = nbytes / (2 ** (k + 1))
            pairs = [(ranks[i], ranks[i ^ (1 << k)]) for i in range(P)
                     if i < i ^ (1 << k)]
            _pairs_round(b, pairs, sz, p)
        for k in range(logp - 1, -1, -1):
            sz = nbytes / (2 ** (k + 1))
            pairs = [(ranks[i], ranks[i ^ (1 << k)]) for i in range(P)
                     if i < i ^ (1 << k)]
            _pairs_round(b, pairs, sz, p)
    elif algo == "tree":
        _assert_pow2(P, algo)
        logp = int(math.log2(P))
        for k in range(logp):  # binomial reduce to rank 0
            stride = 1 << k
            _round(b, [(ranks[i + stride], ranks[i], nbytes)
                       for i in range(0, P, stride * 2)], p)
        for k in range(logp - 1, -1, -1):  # broadcast back
            stride = 1 << k
            _round(b, [(ranks[i], ranks[i + stride], nbytes)
                       for i in range(0, P, stride * 2)], p)
    else:
        raise ValueError(f"unknown allreduce algorithm {algo!r}")


def reduce_scatter(b: GraphBuilder, ranks: Sequence[int], nbytes: float, p: LogGPS,
                   algo: str = "ring") -> None:
    """nbytes = full (unsharded) buffer size; each rank ends with nbytes/P."""
    P = len(ranks)
    if P <= 1:
        return
    if algo == "ring":
        chunk = nbytes / P
        for _ in range(P - 1):
            _round(b, [(ranks[i], ranks[(i + 1) % P], chunk)
                       for i in range(P)], p)
    elif algo == "recursive_halving":
        _assert_pow2(P, algo)
        for k in range(int(math.log2(P))):
            sz = nbytes / (2 ** (k + 1))
            pairs = [(ranks[i], ranks[i ^ (1 << k)]) for i in range(P)
                     if i < i ^ (1 << k)]
            _pairs_round(b, pairs, sz, p)
    else:
        raise ValueError(algo)


def all_gather(b: GraphBuilder, ranks: Sequence[int], nbytes: float, p: LogGPS,
               algo: str = "ring") -> None:
    """nbytes = full gathered size; each rank contributes nbytes/P."""
    P = len(ranks)
    if P <= 1:
        return
    if algo == "ring":
        chunk = nbytes / P
        for _ in range(P - 1):
            _round(b, [(ranks[i], ranks[(i + 1) % P], chunk)
                       for i in range(P)], p)
    elif algo == "recursive_doubling":
        _assert_pow2(P, algo)
        for k in range(int(math.log2(P))):
            sz = nbytes * (2 ** k) / P
            pairs = [(ranks[i], ranks[i ^ (1 << k)]) for i in range(P)
                     if i < i ^ (1 << k)]
            _pairs_round(b, pairs, sz, p)
    elif algo == "bruck":
        # log rounds, rank i sends to i - 2^k (concatenation doubling)
        logp = math.ceil(math.log2(P))
        for k in range(logp):
            sz = nbytes * min(2 ** k, P - 2 ** k) / P
            _round(b, [(ranks[i], ranks[(i - (1 << k)) % P], sz)
                       for i in range(P)], p)
    else:
        raise ValueError(algo)


def all_to_all(b: GraphBuilder, ranks: Sequence[int], nbytes: float, p: LogGPS) -> None:
    """Pairwise-exchange all-to-all; nbytes = per-rank total payload."""
    P = len(ranks)
    if P <= 1:
        return
    chunk = nbytes / P
    _assert_pow2(P, "all_to_all(pairwise)")
    for k in range(1, P):
        pairs = [(ranks[i], ranks[i ^ k]) for i in range(P) if i < (i ^ k)]
        _pairs_round(b, pairs, chunk, p)


def collective_permute(b: GraphBuilder, pairs: Sequence[tuple], nbytes: float,
                       p: LogGPS) -> None:
    """One round of point-to-point permutation (XLA collective-permute)."""
    for src, dst in pairs:
        b.add_message(src, dst, nbytes, p)


def broadcast(b: GraphBuilder, ranks: Sequence[int], nbytes: float, p: LogGPS) -> None:
    P = len(ranks)
    if P <= 1:
        return
    _assert_pow2(P, "broadcast")
    for k in range(int(math.log2(P)) - 1, -1, -1):
        stride = 1 << k
        _round(b, [(ranks[i], ranks[i + stride], nbytes)
                   for i in range(0, P, stride * 2)], p)


def barrier(b: GraphBuilder, ranks: Sequence[int], p: LogGPS) -> None:
    allreduce(b, ranks, 8.0, p, algo="recursive_doubling" if _ispow2(len(ranks)) else "ring")


def _ispow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _assert_pow2(n: int, what: str) -> None:
    if not _ispow2(n):
        raise ValueError(f"{what} requires power-of-two participants, got {n}")


def round_bound_latency_hops(algo: str, P: int) -> int:
    """Number of serialized message rounds (lower bound on λ_L contribution).

    ring: 2(P-1) dependent hops; recursive doubling: log2 P.  This is the
    analytical check behind Fig 10 ("dependent sends and receives" of the
    ring make λ_L ≈ 4× larger at P=256 ⇒ tolerance 4× smaller).
    """
    if algo in ("ring", "bidir_ring"):
        return 2 * (P - 1)
    if algo in ("recursive_doubling",):
        return int(math.log2(P))
    if algo in ("recursive_halving", "tree"):
        return 2 * int(math.log2(P))
    raise ValueError(algo)
