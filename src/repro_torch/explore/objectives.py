"""Vectorized search objectives over batched sweep results.

A generation of candidates evaluates as a handful of packed ``Query``
dispatches whose results stack to ``T[N, S]`` (and optionally
``lam[N, S, nclass]``).  An :class:`ObjectiveSpec` reduces the scenario
axis to one scalar per candidate — LOWER IS BETTER — as a weighted sum of
:class:`Term`\\ s:

    ``mean`` / ``max`` / ``quantile``
        robust makespan statistics over the scenario grid (the paper's
        "how does this design hold up as latency degrades" axis);
    ``tolerance``
        the first-order latency-tolerance proxy ``rtol·T/λ_c`` (paper
        Eq. for L_max under a ρ budget), worst case over scenarios,
        SUBTRACTED — more tolerance is better;
    ``resilience``
        scenario-weighted expected slowdown vs scenario row 0 (the
        ``resilience_curve`` E[slowdown] contract: row 0 is the healthy
        baseline, the weights are the fault distribution).

Every reduction is a plain NumPy op along the last axes, so a candidate's
objective is bit-identical whether its ``T`` row came from a packed
B×K×S dispatch or a solo rebuild — the property the acceptance gate pins.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

_KINDS = ("mean", "max", "quantile", "tolerance", "resilience")


@dataclasses.dataclass(frozen=True)
class Term:
    """One scalarization term; see module docstring for kinds."""

    kind: str
    weight: float = 1.0
    q: float = 0.95            # quantile level (kind="quantile")
    cls: int = 0               # latency class (kind="tolerance")
    rtol: float = 0.01         # tolerated degradation (kind="tolerance")

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown objective term {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.kind == "quantile" and not (0.0 <= self.q <= 1.0):
            raise ValueError(f"quantile level {self.q} outside [0, 1]")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Term":
        bad = set(d) - {f.name for f in dataclasses.fields(cls)}
        if bad:
            raise ValueError(f"unknown Term fields {sorted(bad)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """Weighted sum of terms, evaluated candidate-wise (minimize)."""

    terms: Tuple[Term, ...]
    #: scenario weights for ``resilience`` terms ([S], normalized here);
    #: None = uniform
    scenario_weights: Optional[tuple] = None

    def __post_init__(self):
        object.__setattr__(self, "terms", tuple(self.terms))
        if not self.terms:
            raise ValueError("an ObjectiveSpec needs at least one term")
        if self.scenario_weights is not None:
            w = np.asarray(self.scenario_weights, dtype=np.float64)
            if w.ndim != 1 or (w < 0).any() or w.sum() <= 0:
                raise ValueError("scenario_weights must be a non-negative "
                                 "1-D vector with positive mass")
            object.__setattr__(self, "scenario_weights",
                               tuple((w / w.sum()).tolist()))

    @property
    def needs_lam(self) -> bool:
        return any(t.kind == "tolerance" for t in self.terms)

    def __call__(self, T: np.ndarray,
                 lam: Optional[np.ndarray] = None) -> np.ndarray:
        """``T[..., S]`` (+ ``lam[..., S, nclass]``) → objective ``[...]``."""
        T = np.asarray(T, dtype=np.float64)
        out = np.zeros(T.shape[:-1], dtype=np.float64)
        for t in self.terms:
            if t.kind == "mean":
                v = T.mean(axis=-1)
            elif t.kind == "max":
                v = T.max(axis=-1)
            elif t.kind == "quantile":
                v = np.quantile(T, t.q, axis=-1)
            elif t.kind == "tolerance":
                if lam is None:
                    raise ValueError(
                        "a 'tolerance' term needs λ — evaluate with "
                        "outputs=('T', 'lam')")
                lam_c = np.asarray(lam, dtype=np.float64)[..., t.cls]
                tol = t.rtol * T / np.maximum(lam_c, 1e-12)
                v = -tol.min(axis=-1)          # more tolerance = better
            else:  # resilience
                if self.scenario_weights is None:
                    w = np.full(T.shape[-1], 1.0 / T.shape[-1])
                else:
                    w = np.asarray(self.scenario_weights, dtype=np.float64)
                    if w.shape[0] != T.shape[-1]:
                        raise ValueError(
                            f"{w.shape[0]} scenario weights for "
                            f"{T.shape[-1]} scenarios")
                slowdown = T / T[..., :1]
                v = (slowdown * w).sum(axis=-1)
            out = out + t.weight * v
        return out

    def to_dict(self) -> dict:
        d = {"terms": [t.to_dict() for t in self.terms]}
        if self.scenario_weights is not None:
            d["scenario_weights"] = list(self.scenario_weights)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectiveSpec":
        bad = set(d) - {"terms", "scenario_weights"}
        if bad:
            raise ValueError(f"unknown ObjectiveSpec fields {sorted(bad)}")
        return cls(terms=tuple(Term.from_dict(t) for t in d["terms"]),
                   scenario_weights=(tuple(d["scenario_weights"])
                                     if d.get("scenario_weights") else None))


def robust_makespan(q: float = 0.95) -> ObjectiveSpec:
    """The default search objective: the q-quantile makespan over the
    scenario grid — "pick the design whose tail behavior is best"."""
    return ObjectiveSpec(terms=(Term(kind="quantile", q=q),))
