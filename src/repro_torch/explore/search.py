"""Ask/tell searchers + the generation loop driving the sweep engine.

Searchers follow a minimal ask/tell protocol — ``ask(n)`` proposes up to
``n`` candidates, ``tell(cands, objectives)`` feeds results back — so the
evaluation machinery (the :class:`~repro_torch.explore.stamp.Stamper` packing a
generation into a handful of engine queries) is identical under every
strategy.  Three baselines ship:

:class:`RandomSearch`
    i.i.d. rejection samples from the space — the control arm.
:class:`RegularizedEvolution`
    the aging-evolution GA (Real et al. 2019): tournament selection from
    a sliding population, one mutation per child, oldest-out.
:class:`SuccessiveHalving`
    budget = the SCENARIO-GRID size.  Rung 0 scores every candidate on a
    scenario subset, survivors promote to wider subsets; only full-budget
    scores are comparable, so ``best`` is tracked exclusively there.

All randomness flows through an explicit ``np.random.Generator``
(:func:`repro_torch.core.rng.as_rng`), searcher state (including
``rng.bit_generator.state``) round-trips through ``state_dict`` /
``load_state_dict``, and :func:`run_search` writes a deterministic
JSON-lines trajectory — no timestamps, no timings — so two searches with
the same ``seed=`` produce byte-identical artifacts.

The counterpart of the JAX package's ``repro/explore/search.py``, with the
same ``explore_*`` metrics and ``explore.generation`` span; a generation
evaluates on the port's engine through the :class:`Stamper` it is given
(a default one runs on the CUDA card).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.rng import as_rng
from repro_torch.sweep import ScenarioBatch

from .objectives import ObjectiveSpec, robust_makespan
from .space import DesignSpace
from .stamp import EvalBatch, Lowered, Stamper

CANDIDATES = obs.metrics.counter(
    "explore_candidates_total", "candidates evaluated by design-space "
    "searches", labels=("searcher",))
GENERATIONS = obs.metrics.counter(
    "explore_generations_total", "search generations dispatched")
BEST = obs.metrics.gauge(
    "explore_best_objective", "best (lowest) objective seen by the "
    "current search", labels=("searcher",))


class Searcher:
    """Ask/tell base: dedup bookkeeping, best tracking, state round-trip."""

    name = "searcher"

    def __init__(self, space: DesignSpace, seed):
        self.space = space
        self.rng = as_rng(seed)
        self.n_told = 0
        self.best: Optional[dict] = None
        self.best_objective = float("inf")

    # -- protocol ------------------------------------------------------------
    def ask(self, n: int) -> List[dict]:
        raise NotImplementedError

    def tell(self, cands: Sequence[dict], objectives: Sequence[float]):
        if len(cands) != len(objectives):
            raise ValueError(f"{len(cands)} candidates, "
                             f"{len(objectives)} objectives")
        for cand, obj in zip(cands, objectives):
            self._observe(self.space.validate(cand), float(obj))
            self.n_told += 1

    def _observe(self, cand: dict, obj: float) -> None:
        if obj < self.best_objective:
            self.best_objective = obj
            self.best = dict(cand)

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"name": self.name,
                "rng": self.rng.bit_generator.state,
                "n_told": self.n_told,
                "best": self.best,
                "best_objective": self.best_objective}

    def load_state_dict(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(f"state for {state.get('name')!r} loaded "
                             f"into a {self.name!r} searcher")
        self.rng.bit_generator.state = state["rng"]
        self.n_told = int(state["n_told"])
        self.best = (None if state["best"] is None else dict(state["best"]))
        self.best_objective = float(state["best_objective"])


class RandomSearch(Searcher):
    """i.i.d. rejection sampling — the baseline every GA must beat."""

    name = "random"

    def ask(self, n: int) -> List[dict]:
        return self.space.sample(self.rng, n=int(n))


class RegularizedEvolution(Searcher):
    """Aging evolution: tournament-select a parent from a sliding
    population, mutate once, drop the oldest member (Real et al. 2019 —
    regularization is the aging, not a penalty)."""

    name = "evolution"

    def __init__(self, space: DesignSpace, seed, *,
                 population_size: int = 32, tournament: int = 4):
        super().__init__(space, seed)
        if population_size < 2:
            raise ValueError("population_size must be >= 2")
        self.population_size = int(population_size)
        self.tournament = max(1, min(int(tournament), population_size))
        self._population: deque = deque(maxlen=self.population_size)

    def ask(self, n: int) -> List[dict]:
        out = []
        for _ in range(int(n)):
            if len(self._population) < self.population_size:
                out.append(self.space.sample(self.rng))
            else:
                idx = self.rng.choice(len(self._population),
                                      size=self.tournament, replace=False)
                parent = min((self._population[int(i)] for i in idx),
                             key=lambda e: e[1])[0]
                out.append(self.space.mutate(parent, self.rng))
        return out

    def _observe(self, cand: dict, obj: float) -> None:
        super()._observe(cand, obj)
        self._population.append((dict(cand), obj))

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["population"] = [[c, o] for c, o in self._population]
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._population = deque(
            ((dict(c), float(o)) for c, o in state["population"]),
            maxlen=self.population_size)


class SuccessiveHalving(Searcher):
    """Scenario-budget successive halving.

    The evaluation budget here is the SCENARIO-GRID size: rung r scores
    its cohort on the first ``ceil(S * eta**(r - rungs + 1))`` scenarios
    and promotes the best ``1/eta`` fraction to the next rung.  The
    generation loop reads :attr:`scenario_fraction` before each
    generation; only full-budget rungs update ``best`` (partial-budget
    objectives are not comparable across rungs).
    """

    name = "halving"

    def __init__(self, space: DesignSpace, seed, *, eta: int = 2,
                 rungs: int = 3):
        super().__init__(space, seed)
        if eta < 2 or rungs < 1:
            raise ValueError("need eta >= 2 and rungs >= 1")
        self.eta = int(eta)
        self.rungs = int(rungs)
        self.rung = 0
        self._cohort: List[dict] = []

    @property
    def scenario_fraction(self) -> float:
        return float(self.eta) ** (self.rung - self.rungs + 1)

    @property
    def at_full_budget(self) -> bool:
        return self.rung >= self.rungs - 1

    def ask(self, n: int) -> List[dict]:
        if self.rung == 0 and not self._cohort:
            return self.space.sample(self.rng, n=int(n))
        return [dict(c) for c in self._cohort[:int(n)]]

    def tell(self, cands, objectives):
        if len(cands) != len(objectives):
            raise ValueError(f"{len(cands)} candidates, "
                             f"{len(objectives)} objectives")
        scored = sorted(zip([self.space.validate(c) for c in cands],
                            [float(o) for o in objectives]),
                        key=lambda e: e[1])
        if self.at_full_budget:
            for cand, obj in scored:
                self._observe(cand, obj)
        self.n_told += len(scored)
        keep = max(1, len(scored) // self.eta)
        self._cohort = [dict(c) for c, _ in scored[:keep]]
        self.rung = min(self.rung + 1, self.rungs - 1)

    def state_dict(self) -> dict:
        d = super().state_dict()
        d.update(rung=self.rung, cohort=[dict(c) for c in self._cohort])
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.rung = int(state["rung"])
        self._cohort = [dict(c) for c in state["cohort"]]


SEARCHERS = {"random": RandomSearch,
             "evolution": RegularizedEvolution,
             "halving": SuccessiveHalving}


def make_searcher(name: str, space: DesignSpace, seed, **kw) -> Searcher:
    try:
        cls = SEARCHERS[name]
    except KeyError:
        raise ValueError(f"unknown searcher {name!r} "
                         f"(one of {sorted(SEARCHERS)})") from None
    return cls(space, seed, **kw)


@dataclasses.dataclass
class SearchResult:
    """What :func:`run_search` hands back."""

    best: Optional[dict]
    best_objective: float
    n_evaluated: int
    generations: int
    history: List[dict]                  # one record per generation
    trajectory_path: Optional[str] = None

    def as_dict(self) -> dict:
        return {"best": self.best, "best_objective": self.best_objective,
                "n_evaluated": self.n_evaluated,
                "generations": self.generations,
                "trajectory_path": self.trajectory_path}


def run_search(searcher: Searcher,
               lower: Callable[[dict], Lowered],
               scenarios: ScenarioBatch, *,
               generations: int,
               population: int,
               objective: Optional[ObjectiveSpec] = None,
               stamper: Optional[Stamper] = None,
               trajectory: Optional[str] = None,
               use_cache: bool = True) -> SearchResult:
    """The generation loop: ask → lower → ONE packed evaluation → tell.

    ``lower`` maps a candidate dict to a :class:`Lowered`; the whole
    generation then evaluates through ``stamper.evaluate`` as a handful
    of packed dispatches.  Each generation appends one JSON line to
    ``trajectory`` (when given) containing the generation index, the
    candidate keys, their objectives, the running best, and the stamp
    accounting — and deliberately NO wall-clock fields, so identical
    seeds yield byte-identical files.
    """
    objective = objective if objective is not None else robust_makespan()
    stamper = stamper if stamper is not None else Stamper()
    outputs = ("T", "lam") if objective.needs_lam else ("T",)
    history: List[dict] = []
    sink = None
    if trajectory:
        os.makedirs(os.path.dirname(trajectory) or ".", exist_ok=True)
        sink = open(trajectory, "w")
    try:
        for gen in range(int(generations)):
            with obs.span("explore.generation", searcher=searcher.name,
                          gen=gen, population=int(population)):
                cands = searcher.ask(int(population))
                if not cands:
                    break
                frac = getattr(searcher, "scenario_fraction", 1.0)
                scen = _scenario_slice(scenarios, frac)
                batch: EvalBatch = stamper.evaluate(
                    [lower(c) for c in cands], scen,
                    outputs=outputs, use_cache=use_cache)
                objs = objective(batch.T, batch.lam)
                searcher.tell(cands, [float(o) for o in objs])
            CANDIDATES.inc(len(cands), searcher=searcher.name)
            GENERATIONS.inc()
            if np.isfinite(searcher.best_objective):
                BEST.set(searcher.best_objective, searcher=searcher.name)
            rec = {"gen": gen,
                   "searcher": searcher.name,
                   "scenario_fraction": frac,
                   "candidates": [searcher.space.key(c) for c in cands],
                   "objectives": [float(o) for o in objs],
                   "best_objective": searcher.best_objective,
                   "best": searcher.best,
                   "stamp": batch.info.as_dict()}
            history.append(rec)
            if sink is not None:
                sink.write(json.dumps(rec, sort_keys=True) + "\n")
                sink.flush()
    finally:
        if sink is not None:
            sink.close()
    return SearchResult(best=searcher.best,
                        best_objective=searcher.best_objective,
                        n_evaluated=searcher.n_told,
                        generations=len(history),
                        history=history,
                        trajectory_path=trajectory)


def _scenario_slice(scenarios: ScenarioBatch, frac: float) -> ScenarioBatch:
    """Leading-prefix scenario subset for partial-budget rungs."""
    if frac >= 1.0:
        return scenarios
    n = max(1, int(np.ceil(scenarios.S * float(frac))))
    return ScenarioBatch(L=scenarios.L[:n], gscale=scenarios.gscale[:n],
                         meta=(None if scenarios.meta is None
                               else list(scenarios.meta[:n])))
