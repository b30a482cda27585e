"""Lower candidate batches onto the sweep engine's axes — few queries, not N runs.

A search generation hands the :class:`Stamper` N lowered candidates; it
comes back with ``T[N, S]`` having dispatched a HANDFUL of packed
``Query``\\ s instead of N solo evaluations.  Lane assignment depends only
on each candidate's *content* (never on who else is in the generation), so
the set of engines and staged plans is stable across generations — cold
cost ≤ the number of distinct dispatch shapes, warm generations compile
and stage nothing:

``keep`` lane (same-envelope rewirings)
    candidates sharing a base graph whose variants are edge keep-masks —
    unique masks become ``patch_structure`` B-rows, unique cost extras
    become ``patch_costs`` K-rows, ONE B×K×S dispatch per base plan
    (members read their ``[b, k]`` cell).

``cost`` lane (cost-only deltas)
    candidates sharing graph content and differing only in
    ``extra_edge_cost`` (placement seeds, link re-costings) — extras stack
    to ``CostBatch`` K-rows on the memoized plan, one K×S dispatch per
    graph content.

``pack`` lane (differently-shaped candidates)
    structurally distinct candidates — each compiles once
    (content-memoized, extras baked), groups by padded envelope
    (``CompiledPlan.envelope`` and the class count), and every group runs
    as one
    ``StructureBatch.from_plans`` B×S dispatch.

Identical candidates (same graph + params + mask + extra content) are
deduplicated before dispatch and share one result row.  Plans and warm
engines are memoized by content across generations, so re-sampling a
previously seen design costs a hash lookup; the shared ``SweepCache``
then serves repeated (plan, scenarios) queries without a forward pass.

The counterpart of the JAX package's ``repro/explore/stamp.py`` on the
port's :class:`~repro_torch.sweep.api.Engine` (a dispatch is one
level-loop launch for all its lanes).  The reference's engines name its
shared ``DEFAULT_CACHE``; the port's name no cache by default, so the
stamper owns a named :class:`~repro_torch.sweep.cache.SweepCache`, which
its policy names unless the caller's already names one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.loggps import LogGPS
from repro_torch.device import DeviceLike
from repro_torch.sweep import (Engine, ExecPolicy, Query, ScenarioBatch,
                               StructureBatch, SweepCache, compile_plan)
from repro_torch.sweep.api import _params_content_key
from repro_torch.sweep.cache import canonical_bytes, graph_content_key


@dataclasses.dataclass
class Lowered:
    """One candidate, lowered to engine inputs.

    ``graph``/``params`` carry the structural identity.  ``keep`` (a bool
    edge mask over ``graph``'s edges) marks the candidate as a rewiring of
    that base graph; ``extra_edge_cost`` ([ne] µs, original edge order)
    carries cost-only knobs (placement, link re-costing).  ``meta`` rides
    along untouched.
    """

    graph: ExecutionGraph
    params: LogGPS
    extra_edge_cost: Optional[np.ndarray] = None
    keep: Optional[np.ndarray] = None
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StampInfo:
    """What one generation's lowering actually dispatched."""

    candidates: int = 0
    unique: int = 0
    dispatches: int = 0
    lanes: dict = dataclasses.field(default_factory=dict)  # lane → groups

    def as_dict(self) -> dict:
        return {"candidates": self.candidates, "unique": self.unique,
                "dispatches": self.dispatches, "lanes": dict(self.lanes)}


@dataclasses.dataclass
class EvalBatch:
    """Per-candidate result rows, in the caller's candidate order."""

    T: np.ndarray                       # [N, S]
    lam: Optional[np.ndarray]           # [N, S, nclass] or None
    info: StampInfo


def _arr_hash(a: Optional[np.ndarray]) -> str:
    if a is None:
        return "none"
    sha = hashlib.sha1()
    for chunk in canonical_bytes(np.asarray(a)):
        sha.update(chunk)
    return sha.hexdigest()


class Stamper:
    """Persistent lowering context: plan + engine memos across generations.

    Keep ONE stamper alive for the whole search — that is what makes
    generation 2 a pure-dispatch replay (no plan recompiles, no staging)
    of generation 1's envelope.  Its engines run on ``device`` (the CUDA
    card unless ``device="cpu"``) under ``policy``; ``cache`` (default: a
    fresh :class:`SweepCache` of the stamper's own) is named in the policy
    unless the policy names one already, and ``evaluate(use_cache=True)``
    then serves a repeated generation with no launch.
    """

    def __init__(self, policy: Optional[ExecPolicy] = None,
                 plan_capacity: int = 256, engine_capacity: int = 64,
                 cache: Optional[SweepCache] = None,
                 device: DeviceLike = None):
        pol = policy if policy is not None else ExecPolicy()
        self.cache = (pol.cache if pol.cache is not None
                      else cache if cache is not None else SweepCache())
        self.policy = (pol if pol.cache is self.cache
                       else pol.replace(cache=self.cache))
        self.device = device
        self._plans: OrderedDict = OrderedDict()
        self._engines: OrderedDict = OrderedDict()
        self._plan_cap = int(plan_capacity)
        self._eng_cap = int(engine_capacity)
        self._lock = threading.Lock()
        self.stats = {"plan_hits": 0, "plan_misses": 0,
                      "engine_hits": 0, "engine_misses": 0}

    # -- memos ---------------------------------------------------------------
    def _plan_for(self, low: Lowered, baked_extra: Optional[np.ndarray],
                  pkey):
        """Content-memoized ``compile_plan`` (extras baked when given)."""
        key = None
        if pkey is not None and pkey[0] != "pid":
            key = (graph_content_key(low.graph), pkey,
                   _arr_hash(baked_extra))
        with self._lock:
            if key is not None and key in self._plans:
                self._plans.move_to_end(key)
                self.stats["plan_hits"] += 1
                return self._plans[key]
        self.stats["plan_misses"] += 1
        plan = compile_plan(low.graph, low.params,
                            extra_edge_cost=baked_extra)
        if key is not None:
            with self._lock:
                self._plans[key] = plan
                while len(self._plans) > self._plan_cap:
                    self._plans.popitem(last=False)
        return plan

    def _engine_for(self, key, build: Callable[[], Engine]) -> Engine:
        with self._lock:
            eng = self._engines.get(key)
            if eng is not None:
                self._engines.move_to_end(key)
                self.stats["engine_hits"] += 1
                return eng
        self.stats["engine_misses"] += 1
        eng = build()
        with self._lock:
            self._engines[key] = eng
            while len(self._engines) > self._eng_cap:
                self._engines.popitem(last=False)
        return eng

    # -- the lowering --------------------------------------------------------
    def evaluate(self, lowered: Sequence[Lowered],
                 scenarios: ScenarioBatch, *,
                 outputs: tuple = ("T",),
                 use_cache: bool = True) -> EvalBatch:
        """Evaluate N lowered candidates against one scenario grid."""
        lowered = list(lowered)
        N = len(lowered)
        if N == 0:
            raise ValueError("nothing to evaluate")
        want_lam = "lam" in outputs or "rho" in outputs
        outs = ("T", "lam") if want_lam else ("T",)

        # 1. dedupe by content -------------------------------------------------
        uniq: OrderedDict = OrderedDict()   # ckey → unique slot index
        owners = []                         # candidate i → unique slot
        entries = []                        # slot → (low, pkey)
        for low in lowered:
            pkey = _params_content_key(low.params, low.graph.nranks)
            if pkey is None:
                # unkeyable params: dedupe by object identity within this
                # call (safe — the lowered list pins the object alive)
                pkey = ("pid", id(low.params))
            ckey = (graph_content_key(low.graph), pkey,
                    _arr_hash(low.keep), _arr_hash(low.extra_edge_cost))
            slot = uniq.get(ckey)
            if slot is None:
                slot = len(entries)
                uniq[ckey] = slot
                entries.append((low, pkey))
            owners.append(slot)

        # 2. lane assignment (content-only, generation-independent) -----------
        keep_groups: OrderedDict = OrderedDict()   # (gk, pkey) → [slots]
        cost_groups: OrderedDict = OrderedDict()   # (gk, pkey) → [slots]
        pack_slots = []                            # [(slot, plan)]
        for slot, (low, pkey) in enumerate(entries):
            gk = (graph_content_key(low.graph), pkey)
            if low.keep is not None:
                keep_groups.setdefault(gk, []).append(slot)
            elif low.extra_edge_cost is not None:
                cost_groups.setdefault(gk, []).append(slot)
            else:
                plan = self._plan_for(low, None, pkey)
                pack_slots.append((slot, plan))

        nclass = entries[0][0].graph.nclass
        T = np.empty((len(entries), scenarios.S), dtype=np.float64)
        lam = (np.empty((len(entries), scenarios.S, nclass),
                        dtype=np.float64) if want_lam else None)
        info = StampInfo(candidates=N, unique=len(entries))

        def _write(slot, t_row, l_row):
            T[slot] = t_row
            if lam is not None:
                lam[slot] = l_row

        # 3. keep lane: B×K×S per base plan ------------------------------------
        for (gk, pkey), slots in keep_groups.items():
            low0 = entries[slots[0]][0]
            plan = self._plan_for(low0, None, pkey)
            keeps, keep_idx = [], {}
            extras, extra_idx = [], {}
            cells = []
            ne = low0.graph.num_edges
            any_extra = any(entries[s][0].extra_edge_cost is not None
                            for s in slots)
            for s in slots:
                low = entries[s][0]
                kh = _arr_hash(low.keep)
                b = keep_idx.setdefault(kh, len(keeps))
                if b == len(keeps):
                    keeps.append(np.asarray(low.keep, dtype=bool))
                k = 0
                if any_extra:
                    ex = (low.extra_edge_cost if low.extra_edge_cost
                          is not None else np.zeros(ne))
                    eh = _arr_hash(ex)
                    k = extra_idx.setdefault(eh, len(extras))
                    if k == len(extras):
                        extras.append(np.asarray(ex, dtype=np.float64))
                cells.append((s, b, k))
            eng = self._engine_for(
                ("plan", plan.content_hash(), pkey, self.policy.key()),
                lambda p=plan, lw=low0: Engine(p, params=lw.params,
                                               policy=self.policy,
                                               device=self.device))
            sb = plan.patch_structure(keep=np.stack(keeps))
            costs = (plan.patch_costs(np.stack(extras)) if any_extra
                     else None)
            res = eng.run(Query(scenarios=scenarios, structure=sb,
                                costs=costs, outputs=outs),
                          use_cache=use_cache)
            for s, b, k in cells:
                if any_extra:
                    _write(s, res.T[b, k],
                           res.lam[b, k] if want_lam else None)
                else:
                    _write(s, res.T[b], res.lam[b] if want_lam else None)
            info.dispatches += 1
            info.lanes["keep"] = info.lanes.get("keep", 0) + 1

        # 4. cost lane: K×S per graph content ----------------------------------
        for (gk, pkey), slots in cost_groups.items():
            low0 = entries[slots[0]][0]
            plan = self._plan_for(low0, None, pkey)
            extras = np.stack([
                np.asarray(entries[s][0].extra_edge_cost, dtype=np.float64)
                for s in slots])
            eng = self._engine_for(
                ("plan", plan.content_hash(), pkey, self.policy.key()),
                lambda p=plan, lw=low0: Engine(p, params=lw.params,
                                               policy=self.policy,
                                               device=self.device))
            res = eng.run(Query(scenarios=scenarios,
                                costs=plan.patch_costs(extras),
                                outputs=outs),
                          use_cache=use_cache)
            for k, s in enumerate(slots):
                _write(s, res.T[k], res.lam[k] if want_lam else None)
            info.dispatches += 1
            info.lanes["cost"] = info.lanes.get("cost", 0) + 1

        # 5. pack lane: from_plans B×S per shape bucket ------------------------
        buckets: OrderedDict = OrderedDict()
        for slot, plan in pack_slots:
            buckets.setdefault((plan.envelope, plan.nclass),
                               []).append((slot, plan))
        for _, members in buckets.items():
            # hash-ordered members: the same design set re-sampled in a
            # later generation lands on the same engine-memo key
            members = sorted(members, key=lambda sp: sp[1].content_hash())
            plans = [p for _, p in members]
            key = ("pack", tuple(p.content_hash() for p in plans),
                   self.policy.key())
            eng = self._engine_for(
                key, lambda ps=plans: Engine(
                    StructureBatch.from_plans(ps), policy=self.policy,
                    device=self.device))
            res = eng.run(Query(scenarios=scenarios, outputs=outs),
                          use_cache=use_cache)
            for b, (slot, _) in enumerate(members):
                _write(slot, res.T[b], res.lam[b] if want_lam else None)
            info.dispatches += 1
            info.lanes["pack"] = info.lanes.get("pack", 0) + 1

        # 6. scatter unique rows back to candidate order -----------------------
        idx = np.asarray(owners)
        return EvalBatch(T=T[idx],
                         lam=None if lam is None else lam[idx],
                         info=info)


def solo_objective(low: Lowered, scenarios: ScenarioBatch, objective, *,
                   policy: Optional[ExecPolicy] = None,
                   device: DeviceLike = None) -> float:
    """Independent solo-rebuild evaluation of ONE candidate — a fresh
    ``compile_plan`` with extras baked, no stamper, no memo, no cache — the
    reference the packed path must match bit-for-bit (segment backend), on
    ``device`` (the CUDA card unless ``device="cpu"``).
    ``keep``-lane candidates need the base graph rebuilt by the caller;
    this helper rejects them rather than guess."""
    if low.keep is not None:
        raise ValueError("solo_objective expects a fully-built graph; "
                         "rebuild the keep-mask variant explicitly")
    plan = compile_plan(low.graph, low.params,
                        extra_edge_cost=low.extra_edge_cost)
    pol = policy if policy is not None else ExecPolicy()
    outs = ("T", "lam") if getattr(objective, "needs_lam", False) else ("T",)
    res = Engine(plan, params=low.params, policy=pol, device=device).run(
        Query(scenarios=scenarios, outputs=outs), use_cache=False)
    return float(objective(res.T[None], None if res.lam is None
                           else res.lam[None])[0])
