"""The PyTorch package's graphs and compiled plans against the JAX package's.

On the five conformance graphs (``tests/test_conformance.py``: stencil, cg,
tie-heavy allreduce, 2-class, 3-class), each built by its own package's
``synth``, the graphs and the dense view of ``compile_plan`` must agree
field by field, bit for bit (``array_equal``): the λ tie-breaks depend on
the edge order.  ``graph_from_arrays`` / ``plan_from_arrays`` must carry a
reference graph and plan across unchanged.
"""

import numpy as np
import pytest

from repro.core import loggps as ref_loggps, synth as ref_synth
from repro.sweep import compile_plan as ref_compile_plan

from repro_torch.carry import (GRAPH_ARRAYS, PLAN_ARRAYS, graph_from_arrays,
                               plan_from_arrays)
from repro_torch.core import loggps, synth
from repro_torch.sweep import Engine, compile_plan

NAMES = ("stencil", "cg", "allreduce", "stencil2c", "stencil3c")


def build(name, S, L):
    """One conformance case built with a package's ``synth``/``loggps``."""
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    p2 = L.pod_model(pod_size=2).params()
    p3 = L.pod_model(pod_size=4, ranks_per_host=2).params()
    return {
        "stencil": lambda: (S.stencil2d(3, 3, 4, params=p1), p1),
        "cg": lambda: (S.cg_like(2, 2, 3, params=p1), p1),
        "allreduce": lambda: (S.allreduce_chain(8, 3, params=p1), p1),
        "stencil2c": lambda: (S.stencil2d(2, 2, 3, params=p2), p2),
        "stencil3c": lambda: (S.stencil2d(4, 2, 3, params=p3), p3),
    }[name]()


GRAPH_SCALARS = ("nclass", "nranks", "nlevels", "nlinks")


@pytest.mark.parametrize("name", NAMES)
def test_synth_graphs_equal(name):
    g_ref, _ = build(name, ref_synth, ref_loggps)
    g, _ = build(name, synth, loggps)
    for f in list(GRAPH_ARRAYS) + list(GRAPH_SCALARS):
        np.testing.assert_array_equal(getattr(g, f), getattr(g_ref, f),
                                      err_msg=f)


@pytest.mark.parametrize("name", NAMES)
def test_compile_plan_equals_reference(name):
    g_ref, p_ref = build(name, ref_synth, ref_loggps)
    g, p = build(name, synth, loggps)
    ref = ref_compile_plan(g_ref, p_ref)
    plan = compile_plan(g, p)
    for f in PLAN_ARRAYS:
        a, b = getattr(plan, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (plan.nv, plan.nclass, plan.nlevels) == (ref.nv, ref.nclass,
                                                    ref.nlevels)
    assert plan.Dmax == ref.vsrc.shape[2]
    np.testing.assert_array_equal(plan.dense_indicator(),
                                  ref.dense_indicator(-1e30))
    assert plan.dense_bytes() == ref.dense_bytes()


@pytest.mark.parametrize("name", NAMES)
def test_carry_round_trips(name):
    g_ref, p_ref = build(name, ref_synth, ref_loggps)
    g = graph_from_arrays({f: getattr(g_ref, f) for f in GRAPH_ARRAYS},
                          g_ref.nclass, g_ref.nranks, g_ref.nlevels,
                          g_ref.nlinks)
    for f in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(g, f), getattr(g_ref, f))
    ref = ref_compile_plan(g_ref, p_ref)
    fields = {f.name: getattr(ref, f.name)
              for f in ref.__dataclass_fields__.values()
              if isinstance(getattr(ref, f.name), np.ndarray)}
    carried = plan_from_arrays(fields, ref.nv, ref.nclass, ref.nlevels)
    rebuilt = compile_plan(g, p_ref)          # the carried graph compiles alike
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(carried, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(rebuilt, f), getattr(ref, f))
    assert carried.dense_bytes() == ref.dense_bytes()


def test_plan_from_arrays_rejects_bad_fields():
    g_ref, p_ref = build("stencil", ref_synth, ref_loggps)
    ref = ref_compile_plan(g_ref, p_ref)
    fields = {f: getattr(ref, f) for f in PLAN_ARRAYS}
    with pytest.raises(ValueError, match="vsrc"):
        plan_from_arrays(fields, ref.nv, ref.nclass, ref.nlevels)
    fields["vsrc"] = ref.vsrc
    with pytest.raises(ValueError, match="elat"):
        plan_from_arrays(fields, ref.nv, ref.nclass + 1, ref.nlevels)
    with pytest.raises(ValueError, match="missing"):
        plan_from_arrays({"vsrc": ref.vsrc}, ref.nv, ref.nclass, ref.nlevels)


def test_dense_size_guard():
    """The reference's 256 MiB guard: a plan over the limit is refused
    before anything is staged."""
    g, p = build("stencil", synth, loggps)
    plan = compile_plan(g, p)

    class Small(Engine):
        MAX_DENSE_BYTES = plan.dense_bytes() - 1

    with pytest.raises(ValueError, match="MiB"):
        Small(plan, device="cpu")
    Engine(plan, device="cpu")                # at the default limit: staged
