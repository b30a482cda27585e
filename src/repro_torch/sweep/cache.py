"""Content-addressed memoization of sweep results (the counterpart of the
JAX package's ``repro/sweep/cache.py``).

A key is a SHA1 over the plan's content hash, the scenario batches and the
query's flags: two structurally identical graphs, however they were built,
with the same scenarios share one entry, so re-running a study, or a search
re-probing a grid it has already seen, costs a hash instead of a forward.
LRU-bounded and in memory; results are small ([S] and [S, nclass] float64),
the inputs were the expensive part.

Hashes are taken over *canonical bytes* (dtype tag, shape, then the C-order
buffer), never over object identities, so a key minted in one process
matches the same logical inputs hashed in another.

The hit, miss and eviction counts live on :class:`CacheStats` and, as in
the reference, on the ``sweep_cache_*_total`` counters of
:mod:`repro_torch.obs.metrics`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as _obs_metrics

from .compile import _canonical_bytes

_HITS = _obs_metrics.counter(
    "sweep_cache_hits_total", "Sweep result-cache hits.",
    labels=("patched",))
_MISSES = _obs_metrics.counter(
    "sweep_cache_misses_total", "Sweep result-cache misses.",
    labels=("patched",))
_EVICTIONS = _obs_metrics.counter(
    "sweep_cache_evictions_total", "Sweep result-cache LRU evictions.")

#: an array's (header, buffer) chunk pair, dtype tag and shape then the
#: C-order bytes: collision-safe across shapes and dtypes, the same in
#: every process (the plans' content hashes use it too)
canonical_bytes = _canonical_bytes


def _update(sha, arr) -> None:
    for chunk in canonical_bytes(arr):
        sha.update(chunk)


def result_key(plan_hash: str, scenarios, compute_lam: bool,
               backend: str, cost_hash: Optional[str] = None) -> str:
    """Key of one plan's run over ``scenarios``; ``cost_hash`` (a cost
    batch's content hash) folds patched costs in, so one plan under two
    cost blocks never collides."""
    sha = hashlib.sha1(b"sweep-result-v2|")
    sha.update(plan_hash.encode())
    _update(sha, scenarios.L)
    _update(sha, scenarios.gscale)
    sha.update(f"|{int(compute_lam)}|{backend}".encode())
    if cost_hash is not None:
        sha.update(f"|costs:{cost_hash}".encode())
    return sha.hexdigest()


def query_key(plan_hash: str, batches: Sequence, want_lam: bool,
              backend: str, cost_hash: Optional[str] = None,
              lam_mode: str = "exact",
              fd_eps: Optional[float] = None,
              structure_hash: Optional[str] = None,
              congestion_hash: Optional[str] = None) -> str:
    """Key of an :class:`~repro_torch.sweep.api.Engine` query: the plan (or
    packed plan) content hash, the per-graph scenario batches in order, the
    sensitivity flag, the backend kind, the λ mode (finite-difference λ is
    another numeric contract than the exact walk, and its key folds the
    step in), and the cost-batch, structure-batch and congestion hashes
    where those are in play."""
    sha = hashlib.sha1(b"sweep-query-v1|")
    sha.update(plan_hash.encode())
    for b in batches:
        _update(sha, b.L)
        _update(sha, b.gscale)
    sha.update(f"|{int(want_lam)}|{backend}|{lam_mode}".encode())
    if lam_mode == "fd":
        sha.update(repr(float(fd_eps)).encode())
    if cost_hash is not None:
        sha.update(f"|costs:{cost_hash}".encode())
    if structure_hash is not None:
        sha.update(f"|structure:{structure_hash}".encode())
    if congestion_hash is not None:
        # the links, the (α, β) registry and the stopping rule: two runs
        # differing only in congestion parameters never collide
        sha.update(f"|congestion:{congestion_hash}".encode())
    return sha.hexdigest()


def graph_content_key(g) -> str:
    """Content hash of an :class:`~repro_torch.core.graph.ExecutionGraph`:
    its build-time arrays (vertices, edges, latency classes, gap shares,
    interned links), everything :func:`~repro_torch.sweep.compile.
    compile_plan` reads.  The CSR and level arrays derive from them and are
    left out.  Two graphs built apart with equal contents share one key, so
    a detached ``Query(graphs=...)`` that rebuilds a graph lands on the
    engine it memoized."""
    sha = hashlib.sha1(b"graph-content-v1|")
    for arr in (g.kind, g.vcost, g.vrank, g.esrc, g.edst, g.econst,
                g.ebytes, g.elat):
        _update(sha, arr)
    for opt in (g.egap, g.egclass, g.elink, g.link_classes):
        if opt is None:
            sha.update(b"|none")
        else:
            sha.update(b"|arr")
            _update(sha, opt)
    sha.update(f"|{int(g.nclass)}|{int(g.nranks)}|{int(g.nlinks)}".encode())
    return sha.hexdigest()


def multi_result_key(multi_hash: str, batches: Sequence, compute_lam: bool,
                     backend: str) -> str:
    """Key of a packed plan's run: the per-graph scenario batches hashed in
    order."""
    sha = hashlib.sha1(b"sweep-multi-result-v1|")
    sha.update(multi_hash.encode())
    for b in batches:
        _update(sha, b.L)
        _update(sha, b.gscale)
    sha.update(f"|{int(compute_lam)}|{backend}".encode())
    return sha.hexdigest()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    #: the lookups of patched queries (a cost or structure batch), counted
    #: in hits and misses as well
    patched_hits: int = 0
    patched_misses: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "patched_hits": self.patched_hits,
                "patched_misses": self.patched_misses}


class SweepCache:
    """LRU map from a key to a stored result.

    Thread-safe: every read-modify-write of the LRU order and the counters
    happens under one lock, so one instance may serve several threads."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._store: OrderedDict = OrderedDict()
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def get(self, key: str, patched: bool = False):
        with self._lock:
            hit = self._store.get(key)
            if hit is None:
                self.stats.misses += 1
                self.stats.patched_misses += patched
            else:
                self._store.move_to_end(key)
                self.stats.hits += 1
                self.stats.patched_hits += patched
        patched_s = "true" if patched else "false"
        if hit is None:
            _MISSES.inc(patched=patched_s)
            return None
        _HITS.inc(patched=patched_s)
        return hit

    def put(self, key: str, value) -> None:
        evicted = 0
        with self._lock:
            self._store[key] = value
            self._store.move_to_end(key)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.stats.evictions += 1
                evicted += 1
        if evicted:
            _EVICTIONS.inc(evicted)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.stats = CacheStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


#: the shared instance a policy names to cache across engines
#: (``ExecPolicy(cache=DEFAULT_CACHE)``)
DEFAULT_CACHE = SweepCache()


def array_hash(*arrays: np.ndarray) -> str:
    """SHA1 over arrays' canonical bytes, in order."""
    sha = hashlib.sha1(b"arrays-v1|")
    for a in arrays:
        _update(sha, a)
    return sha.hexdigest()
