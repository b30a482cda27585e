"""Declarative design spaces: the knobs a co-design search turns.

A :class:`DesignSpace` is a tuple of typed :class:`Dim`\\ s — categorical
(collective algorithm, topology family, mapping scheme), integer
(parallelism splits, ranks-per-host, placement seeds) and log-float
(``NetworkModel`` class parameters, message-size scales) — plus named
validity constraints (``data * model == P``).  A *candidate* is a plain
``{dim name: value}`` dict of JSON-able primitives, so candidates travel
over the analysis-service wire and into trajectory artifacts unchanged.

Everything stochastic takes an EXPLICIT ``rng``
(:func:`repro_torch.core.rng.as_rng`; ``None`` raises) — sampling and mutation
are pure functions of the stream, which is what makes two identical
``seed=`` searches produce bit-identical trajectories.

Encoding is deterministic and content-addressed: :meth:`DesignSpace.encode`
maps a candidate to a dim-ordered tuple of primitives,
:meth:`DesignSpace.decode` inverts it, and :meth:`DesignSpace.key` renders
a canonical string for dedup tables and cache keys.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rng import as_rng


class Dim:
    """One named knob.  Subclasses implement sample/validate/encode."""

    name: str

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def validate(self, value):
        """Return the canonical value or raise :class:`ValueError`."""
        raise NotImplementedError

    def encode(self, value):
        """Candidate value → JSON-able primitive (index or number)."""
        raise NotImplementedError

    def decode(self, code):
        raise NotImplementedError

    def mutate(self, value, rng: np.random.Generator):
        """A *different* valid value near ``value`` (resample fallback)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Categorical(Dim):
    """Unordered finite choices; encoded as the choice index."""

    name: str
    choices: tuple

    def __post_init__(self):
        object.__setattr__(self, "choices", tuple(self.choices))
        if len(self.choices) == 0:
            raise ValueError(f"dim {self.name!r} needs at least one choice")
        if len(set(self.choices)) != len(self.choices):
            raise ValueError(f"dim {self.name!r} has duplicate choices")

    def sample(self, rng):
        return self.choices[int(rng.integers(len(self.choices)))]

    def validate(self, value):
        if value not in self.choices:
            raise ValueError(
                f"dim {self.name!r}: {value!r} not in {self.choices}")
        return value

    def encode(self, value):
        return self.choices.index(self.validate(value))

    def decode(self, code):
        return self.choices[int(code)]

    def mutate(self, value, rng):
        if len(self.choices) == 1:
            return value
        others = [c for c in self.choices if c != value]
        return others[int(rng.integers(len(others)))]


@dataclasses.dataclass(frozen=True)
class IntDim(Dim):
    """Integer in ``[lo, hi]`` inclusive; encoded as the int itself."""

    name: str
    lo: int
    hi: int

    def __post_init__(self):
        if int(self.lo) > int(self.hi):
            raise ValueError(f"dim {self.name!r}: lo {self.lo} > hi {self.hi}")

    def sample(self, rng):
        return int(rng.integers(self.lo, self.hi + 1))

    def validate(self, value):
        v = int(value)
        if v != value or not (self.lo <= v <= self.hi):
            raise ValueError(
                f"dim {self.name!r}: {value!r} outside [{self.lo}, {self.hi}]")
        return v

    encode = validate

    def decode(self, code):
        return self.validate(int(code))

    def mutate(self, value, rng):
        if self.lo == self.hi:
            return int(self.lo)
        v = int(value)
        while True:
            nv = int(rng.integers(self.lo, self.hi + 1))
            if nv != v:
                return nv


@dataclasses.dataclass(frozen=True)
class LogFloat(Dim):
    """Log-uniform float in ``[lo, hi]`` (both > 0); encoded as the float.

    Mutation perturbs multiplicatively in log space (clamped), the natural
    neighborhood for scale-like knobs (bandwidth, α, message scales).
    """

    name: str
    lo: float
    hi: float
    mut_sigma: float = 0.5   # std-dev of the log-space perturbation

    def __post_init__(self):
        if not (0 < float(self.lo) <= float(self.hi)):
            raise ValueError(
                f"dim {self.name!r}: need 0 < lo <= hi, got "
                f"[{self.lo}, {self.hi}]")

    def sample(self, rng):
        return float(np.exp(rng.uniform(math.log(self.lo),
                                        math.log(self.hi))))

    def validate(self, value):
        v = float(value)
        if not (self.lo <= v <= self.hi) or not np.isfinite(v):
            raise ValueError(
                f"dim {self.name!r}: {value!r} outside [{self.lo}, {self.hi}]")
        return v

    encode = validate

    def decode(self, code):
        return self.validate(float(code))

    def mutate(self, value, rng):
        v = float(value) * float(np.exp(rng.normal(0.0, self.mut_sigma)))
        return float(min(max(v, self.lo), self.hi))


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Dims + named validity constraints over whole candidates.

    ``constraints`` is a tuple of ``(name, predicate)`` pairs; a predicate
    takes the candidate dict and returns truthy iff valid.  Sampling and
    mutation are rejection-based against the constraints, bounded by
    ``max_tries`` per accepted candidate (a loud error beats silently
    spinning on an over-constrained space).
    """

    dims: Tuple[Dim, ...]
    constraints: Tuple[Tuple[str, Callable[[dict], bool]], ...] = ()
    max_tries: int = 10_000

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(self.dims))
        object.__setattr__(self, "constraints", tuple(self.constraints))
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dim names: {names}")

    @property
    def names(self) -> tuple:
        return tuple(d.name for d in self.dims)

    def dim(self, name: str) -> Dim:
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(name)

    # -- validation ----------------------------------------------------------
    def validate(self, cand: dict) -> dict:
        """Canonicalized copy of ``cand``; raises on unknown/missing dims,
        per-dim violations, and failed constraints (naming the first)."""
        extra = set(cand) - set(self.names)
        missing = set(self.names) - set(cand)
        if extra or missing:
            raise ValueError(
                f"candidate keys do not match space dims: "
                f"missing={sorted(missing)}, unknown={sorted(extra)}")
        out = {d.name: d.validate(cand[d.name]) for d in self.dims}
        self._check_constraints(out)
        return out

    def _check_constraints(self, cand: dict) -> None:
        for name, pred in self.constraints:
            if not pred(cand):
                raise ValueError(
                    f"candidate violates constraint {name!r}: {cand}")

    def _satisfies(self, cand: dict) -> bool:
        return all(pred(cand) for _, pred in self.constraints)

    # -- deterministic encoding ----------------------------------------------
    def encode(self, cand: dict) -> tuple:
        """Dim-ordered tuple of primitives (validates on the way)."""
        c = self.validate(cand)
        return tuple(d.encode(c[d.name]) for d in self.dims)

    def decode(self, codes: Sequence) -> dict:
        if len(codes) != len(self.dims):
            raise ValueError(
                f"{len(codes)} codes for {len(self.dims)} dims")
        return self.validate(
            {d.name: d.decode(c) for d, c in zip(self.dims, codes)})

    def key(self, cand: dict) -> str:
        """Canonical content string (dedup tables, trajectory artifacts)."""
        return json.dumps(self.encode(cand), sort_keys=True,
                          separators=(",", ":"))

    # -- stochastic ops (explicit rng only) ----------------------------------
    def sample(self, rng, n: Optional[int] = None):
        """``n`` valid candidates (or one dict when ``n`` is None) via
        rejection sampling from an explicit stream."""
        rng = as_rng(rng)
        one = n is None
        out = []
        for _ in range(1 if one else int(n)):
            for _try in range(self.max_tries):
                cand = {d.name: d.sample(rng) for d in self.dims}
                if self._satisfies(cand):
                    out.append(cand)
                    break
            else:
                raise RuntimeError(
                    f"no valid candidate in {self.max_tries} tries — "
                    "constraints too tight for rejection sampling")
        return out[0] if one else out

    def mutate(self, cand: dict, rng, n_dims: int = 1) -> dict:
        """A valid neighbor: ``n_dims`` randomly chosen dims re-drawn via
        their ``mutate``; re-tries (fresh dim choices each time) until the
        constraints accept, widening the neighborhood every few tries —
        coupled constraints (``data * model == P``) are unsatisfiable by
        any single-dim move, so the escalation is what keeps those dims
        reachable by evolution at all."""
        rng = as_rng(rng)
        base = self.validate(cand)
        for _try in range(self.max_tries):
            child = dict(base)
            k = min(n_dims + _try // 8, len(self.dims))
            idx = rng.choice(len(self.dims), size=k, replace=False)
            for i in np.atleast_1d(idx):
                d = self.dims[int(i)]
                child[d.name] = d.mutate(child[d.name], rng)
            if self._satisfies(child):
                return child
        raise RuntimeError(
            f"no valid mutation of {base} in {self.max_tries} tries")
