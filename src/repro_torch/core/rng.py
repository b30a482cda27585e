"""Explicit-RNG discipline for every stochastic search-adjacent path.

Search reproducibility is a product requirement (two identical ``seed=``
searches must produce bit-identical trajectories), so no library code may
draw from NumPy's *global* generator: callers always pass a seed or a
:class:`numpy.random.Generator` and this module normalizes it.  Passing
``None`` is a :class:`TypeError` on purpose — "use whatever global state
happens to be lying around" is exactly the bug class this bans.

A copy of the JAX package's ``repro/core/rng.py``.
"""

from __future__ import annotations

import numpy as np


def as_rng(rng) -> np.random.Generator:
    """Normalize an explicit seed into a :class:`numpy.random.Generator`.

    Accepts an int seed, an int tuple/``SeedSequence`` (the
    ``default_rng`` spellings), or an already-built ``Generator`` (passed
    through, so callers can thread one stream across phases).  ``None``
    raises: implicit global-``np.random`` state is never used.
    """
    if isinstance(rng, np.random.Generator):
        return rng
    if rng is None:
        raise TypeError(
            "an explicit rng is required: pass an int seed or a "
            "numpy.random.Generator — implicit global np.random state "
            "would make searches irreproducible")
    if isinstance(rng, (int, np.integer, tuple, list, np.random.SeedSequence)):
        return np.random.default_rng(rng)
    raise TypeError(f"cannot build a Generator from {type(rng).__name__!r}")
