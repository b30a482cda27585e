"""Synthetic MPI-style applications (paper's validation workloads, §III).

Real MILC/LULESH/HPCG traces can't be collected in this container, so we
generate execution graphs with the same *communication skeletons* the paper
validates on — these drive the solver-speed (Table I), validation (Fig 9),
and collective/topology case-study benchmarks at paper-like event counts.

  stencil2d / stencil3d — nearest-neighbor halo exchange + compute
                          (LULESH/MILC su3_rmd skeletons)
  cg_like               — halo exchange + 2 scalar allreduces per iteration
                          (HPCG skeleton: dot products dominate λ_L)
  sweep2d               — wavefront dependency (NPB LU skeleton)
  allreduce_chain       — compute + one big allreduce per step
                          (ICON dynamical-core skeleton, Fig 10)
  ring_pipeline         — P-stage pipeline (latency-dominated)
  random_dag            — property-test fodder

This is a copy of the JAX package's ``repro/core/synth.py`` (numpy
only): the PyTorch package imports nothing from ``repro``, and the two
copies must build bit-identical graphs for the parity tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import ExecutionGraph, GraphBuilder
from .loggps import LogGPS
from . import collectives as coll


def stencil2d(px: int, py: int, iters: int, halo_bytes: float = 64e3,
              comp_us: float = 500.0, params: Optional[LogGPS] = None,
              jitter: float = 0.0, seed: int = 0) -> ExecutionGraph:
    params = params or LogGPS()
    P = px * py
    b = GraphBuilder(P, params.nclass)
    rng = np.random.default_rng(seed)

    def rid(i, j):
        return (i % px) * py + (j % py)

    for _ in range(iters):
        for i in range(px):
            for j in range(py):
                r = rid(i, j)
                c = comp_us * (1.0 + jitter * rng.standard_normal()) if jitter else comp_us
                b.add_calc(r, max(c, 1e-3))
        for i in range(px):
            for j in range(py):
                r = rid(i, j)
                for (ni, nj) in ((i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)):
                    b.add_message(r, rid(ni, nj), halo_bytes, params)
    return b.finalize()


def stencil3d(px: int, py: int, pz: int, iters: int, halo_bytes: float = 64e3,
              comp_us: float = 500.0, params: Optional[LogGPS] = None) -> ExecutionGraph:
    params = params or LogGPS()
    P = px * py * pz
    b = GraphBuilder(P, params.nclass)

    def rid(i, j, k):
        return ((i % px) * py + (j % py)) * pz + (k % pz)

    for _ in range(iters):
        for i in range(px):
            for j in range(py):
                for k in range(pz):
                    b.add_calc(rid(i, j, k), comp_us)
        for i in range(px):
            for j in range(py):
                for k in range(pz):
                    r = rid(i, j, k)
                    for (ni, nj, nk) in ((i + 1, j, k), (i - 1, j, k), (i, j + 1, k),
                                         (i, j - 1, k), (i, j, k + 1), (i, j, k - 1)):
                        b.add_message(r, rid(ni, nj, nk), halo_bytes, params)
    return b.finalize()


def cg_like(px: int, py: int, iters: int, halo_bytes: float = 32e3,
            comp_us: float = 800.0, params: Optional[LogGPS] = None,
            allreduce_algo: Optional[str] = None) -> ExecutionGraph:
    """HPCG skeleton: SpMV halo + 2 dot-product allreduces per iteration."""
    params = params or LogGPS()
    P = px * py
    if allreduce_algo is None:
        allreduce_algo = "recursive_doubling" if (P & (P - 1)) == 0 else "ring"
    b = GraphBuilder(P, params.nclass)
    ranks = list(range(P))

    def rid(i, j):
        return (i % px) * py + (j % py)

    for _ in range(iters):
        for i in range(px):
            for j in range(py):
                b.add_calc(rid(i, j), comp_us)
        for i in range(px):
            for j in range(py):
                r = rid(i, j)
                for (ni, nj) in ((i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)):
                    b.add_message(r, rid(ni, nj), halo_bytes, params)
        for r in ranks:
            b.add_calc(r, comp_us * 0.1)
        coll.allreduce(b, ranks, 8.0, params, algo=allreduce_algo)
        for r in ranks:
            b.add_calc(r, comp_us * 0.05)
        coll.allreduce(b, ranks, 8.0, params, algo=allreduce_algo)
    return b.finalize()


def sweep2d(px: int, py: int, sweeps: int, msg_bytes: float = 16e3,
            comp_us: float = 50.0, params: Optional[LogGPS] = None) -> ExecutionGraph:
    """NPB-LU-style wavefront: long dependent message chains ⇒ high λ_L."""
    params = params or LogGPS()
    P = px * py
    b = GraphBuilder(P, params.nclass)

    def rid(i, j):
        return i * py + j

    for s in range(sweeps):
        fwd = (s % 2 == 0)
        rng_i = range(px) if fwd else range(px - 1, -1, -1)
        for i in rng_i:
            rng_j = range(py) if fwd else range(py - 1, -1, -1)
            for j in rng_j:
                r = rid(i, j)
                b.add_calc(r, comp_us)
                di, dj = (1, 1) if fwd else (-1, -1)
                if 0 <= i + di < px:
                    b.add_message(r, rid(i + di, j), msg_bytes, params)
                if 0 <= j + dj < py:
                    b.add_message(r, rid(i, j + dj), msg_bytes, params)
    return b.finalize()


def allreduce_chain(P: int, steps: int, nbytes: float = 4e6,
                    comp_us: float = 5_000.0, params: Optional[LogGPS] = None,
                    algo: str = "recursive_doubling") -> ExecutionGraph:
    """ICON-dycore skeleton (Fig 10): compute then a big allreduce, repeated."""
    params = params or LogGPS()
    b = GraphBuilder(P, params.nclass)
    ranks = list(range(P))
    for _ in range(steps):
        for r in ranks:
            b.add_calc(r, comp_us)
        coll.allreduce(b, ranks, nbytes, params, algo=algo)
    return b.finalize()


def ring_pipeline(P: int, items: int, nbytes: float = 1e5,
                  comp_us: float = 100.0, params: Optional[LogGPS] = None) -> ExecutionGraph:
    params = params or LogGPS()
    b = GraphBuilder(P, params.nclass)
    for _ in range(items):
        for r in range(P):
            b.add_calc(r, comp_us)
            if r + 1 < P:
                b.add_message(r, r + 1, nbytes, params)
    return b.finalize()


def random_dag(rng: np.random.Generator, nranks: int = 4, nops: int = 64,
               p_msg: float = 0.4, max_bytes: float = 1e5,
               params: Optional[LogGPS] = None) -> ExecutionGraph:
    """Random rank-chained DAG with random messages; for property tests."""
    params = params or LogGPS()
    b = GraphBuilder(nranks, params.nclass)
    for _ in range(nops):
        if rng.random() < p_msg and nranks > 1:
            src, dst = rng.choice(nranks, size=2, replace=False)
            b.add_message(int(src), int(dst), float(rng.uniform(8, max_bytes)), params)
        else:
            b.add_calc(int(rng.integers(nranks)), float(rng.uniform(0.1, 50.0)))
    return b.finalize()


WORKLOADS = {
    "stencil2d": lambda scale=4, iters=10: stencil2d(scale, scale, iters),
    "stencil3d": lambda scale=3, iters=8: stencil3d(scale, scale, scale, iters),
    "cg": lambda scale=4, iters=10: cg_like(scale, scale, iters),
    "sweep": lambda scale=4, iters=6: sweep2d(scale, scale, iters),
    "allreduce_chain": lambda scale=16, iters=10: allreduce_chain(scale, iters),
    "ring_pipeline": lambda scale=8, iters=16: ring_pipeline(scale, iters),
}
