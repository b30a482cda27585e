"""Per-device sharding of ``Engine.run`` on the port
(``repro_torch.sweep.engine._resolve_shard`` / ``split_forward``,
``ExecPolicy(shard=, shard_axis=)``, ``run(shard_devices=)``).

On the CPU (``device="cpu"``, the kernels' plain versions), where one
device exists: ``shard=True`` resolves to it alone, and a split over a
device list that names the CPU twice or four times runs the split path:

* ``_resolve_shard``'s walk-down to the largest divisor of the axis, as
  the reference's (``repro/sweep/engine.py:1011-1026``);
* split equal to unsplit, bit for bit (T, λ, ρ), on the S, G and K axes,
  on the segment and dense backends, λ and values forwards, with fd λ on
  S, over ``["cpu", "cpu"]`` and ``["cpu"] * 4``; one forward (one
  level-loop launch and, for λ, one walk on the card) a chunk;
* the reference's five refusals, with its words;
* ``shard=True`` on the CPU equal to ``shard=None``, nothing split.
"""

import numpy as np
import pytest

from repro_torch.core import synth
from repro_torch.core.loggps import cluster_params, pod_model
from repro_torch.sweep import (Engine, ExecPolicy, Query, collective_variants,
                               compile_plan, latency_grid)
from repro_torch.sweep import engine as eng

CPU = "cpu"
DEVICES = {"x2": [CPU, CPU], "x4": [CPU] * 4}
ALGOS = ("ring", "bidir_ring", "recursive_doubling", "tree")


@pytest.mark.parametrize("shard, size, avail, want", [
    (None, 8, 4, None), (False, 8, 4, None), (0, 8, 4, None),
    (True, 8, 4, 4), ("auto", 8, 4, 4), (True, 8, 1, None),
    ("auto", 6, 4, 3), (3, 8, 8, 2), (8, 8, 4, 4), (True, 7, 4, None),
    (2, 1, 4, None), (True, 12, 8, 6), (5, 10, 8, 5), (1, 8, 8, None),
    (True, 3, 8, 3), (np.int64(4), 16, 8, 4)])
def test_resolve_shard_walks_down_to_a_divisor(shard, size, avail, want):
    assert eng._resolve_shard(shard, size, avail) == want


def test_local_devices_on_the_cpu_is_one():
    import torch
    assert eng.local_devices(torch.device("cpu")) == 1


@pytest.fixture(scope="module")
def stencil():
    p = pod_model(pod_size=4).params()
    return synth.stencil2d(4, 4, 2, params=p), p


@pytest.fixture(scope="module")
def study():
    p = cluster_params(L_us=3.0, o_us=5.0)
    vs = collective_variants(
        lambda a: synth.allreduce_chain(8, 2, params=p, algo=a), ALGOS, p)
    return vs, p


def extras(g, K, seed):
    """[K, ne] extra edge costs on the message edges, from a numpy seed."""
    rng = np.random.default_rng(seed)
    msg = (g.ebytes > 0).astype(float)
    return rng.uniform(0.0, 5.0, (K, g.num_edges)) * msg


def _equal(a, b):
    assert a.axes == b.axes and a.backend == b.backend
    for f in ("T", "lam", "rho"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


def runs_of(backend, packed):
    """The forward counter of one backend's solo or packed forward."""
    fn = {("segment", False): eng.segment_forward,
          ("segment", True): eng.segment_forward_multi,
          ("dense", False): eng.dense_forward,
          ("dense", True): eng.dense_forward_multi}[(backend, packed)]
    return fn.runs


def check_split(e, query, axis, devices, packed, **kw):
    """The run split over ``devices`` on ``axis`` equals the whole run bit
    for bit, with one forward a chunk."""
    whole = e.run(query, use_cache=False, **kw)
    runs = runs_of(e.policy.backend, packed)
    n0, c0 = sum(runs.values()), eng.split_forward.chunks
    split = e.run(query, use_cache=False, shard_axis=axis,
                  shard_devices=devices, **kw)
    assert sum(runs.values()) - n0 == len(devices)
    assert eng.split_forward.chunks - c0 == len(devices)
    _equal(split, whole)
    return split


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("lam", [True, False])
@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_split_S_equals_unsplit(stencil, backend, lam, devices):
    g, p = stencil
    e = Engine(g, params=p, policy=ExecPolicy(backend), device=CPU)
    b = latency_grid(p, np.linspace(0.0, 40.0, 7))        # Sp 8
    check_split(e, b, "S", DEVICES[devices], False, compute_lam=lam)
    # "auto" is S on an engine with no graph axis
    check_split(e, b, "auto", DEVICES[devices], False, compute_lam=lam)


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_split_S_fd_lambda_equals_unsplit(stencil, backend):
    g, p = stencil
    e = Engine(g, params=p, policy=ExecPolicy(backend, lam="fd"),
               device=CPU)
    b = latency_grid(p, np.linspace(0.3, 30.3, 5))  # (nc + 1)·5 rows, Sp 16
    check_split(e, b, "S", DEVICES["x4"], False)


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("lam", [True, False])
@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_split_G_equals_unsplit(study, backend, lam, devices):
    vs, p = study
    e = Engine([(v.graph, v.params) for v in vs], names=[v.name for v in vs],
               policy=ExecPolicy(backend), device=CPU)
    b = latency_grid(p, np.linspace(0.0, 60.0, 6))
    res = check_split(e, b, "G", DEVICES[devices], True, compute_lam=lam)
    assert res.names == e.names and res.rank() == e.run(b).rank()
    # "auto" is G on a packed engine; each chunk stages its graphs once
    check_split(e, b, "auto", DEVICES[devices], True, compute_lam=lam)
    # per-graph scenario batches split with their graphs
    per = [latency_grid(p, np.linspace(0.0, 10.0 * (i + 1), 6))
           for i in range(len(vs))]
    check_split(e, per, "G", DEVICES[devices], True, compute_lam=lam)


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("lam", [True, False])
@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_split_K_equals_unsplit(stencil, backend, lam, devices):
    g, p = stencil
    e = Engine(g, params=p, policy=ExecPolicy(backend), device=CPU)
    q = Query(latency_grid(p, [0.0, 5.0, 9.0]), costs=extras(g, 8, 3))
    res = check_split(e, q, "K", DEVICES[devices], True, compute_lam=lam)
    assert res.axes == ("K", "S")
    # a CostBatch splits as the raw extras it patches
    plan = compile_plan(g, p)
    eb = Engine(plan, params=p, policy=ExecPolicy(backend), device=CPU)
    qb = Query(q.scenarios, costs=plan.patch_costs(extras(g, 8, 3)))
    _equal(check_split(eb, qb, "K", DEVICES[devices], True,
                       compute_lam=lam), res)


@pytest.mark.parametrize("axis", ["G", "K", "S"])
@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_split_GxK_on_each_axis(study, backend, axis):
    vs, p = study
    e = Engine([(v.graph, v.params) for v in vs], names=[v.name for v in vs],
               policy=ExecPolicy(backend), device=CPU)
    q = Query(latency_grid(p, [0.0, 3.0, 7.0, 11.0]),
              costs=[extras(v.graph, 4, i) for i, v in enumerate(vs)])
    res = check_split(e, q, axis, DEVICES["x2"], True)
    assert res.axes == ("G", "K", "S")


def test_shard_true_on_the_cpu_equals_unsharded(stencil, study):
    g, p = stencil
    e = Engine(g, params=p, device=CPU)
    b = latency_grid(p, np.linspace(0.0, 40.0, 8))
    c0 = eng.split_forward.calls
    for kw in ({"shard": True}, {"shard": "auto"}, {"shard": 4},
               {"shard": True, "shard_axis": "S"}):
        _equal(e.run(b, **kw), e.run(b))
    vs, pv = study
    m = Engine([(v.graph, v.params) for v in vs], device=CPU,
               policy=ExecPolicy(shard=True))
    _equal(m.run(latency_grid(pv, [0.0, 9.0])),
           m.run(latency_grid(pv, [0.0, 9.0]), shard=False))
    assert eng.split_forward.calls == c0        # one device: never split


def test_five_refusals_with_the_reference_words(stencil, study):
    g, p = stencil
    b = latency_grid(p, [0.0, 5.0])
    with pytest.raises(ValueError, match="the sparse backend does not "
                                         "shard yet"):
        Engine(g, params=p, policy=ExecPolicy("sparse"), device=CPU).run(
            b, shard=True)
    plan = compile_plan(g, p)
    sb = plan.patch_structure(keep=np.ones((2, g.num_edges), dtype=bool))
    with pytest.raises(ValueError, match="sharding a structure-batched "
                                         "query is not supported yet"):
        Engine(plan, params=p, device=CPU).run(Query(b, structure=sb),
                                               shard=2)
    with pytest.raises(ValueError, match=r"congestion='fixed_point' does "
                                         "not shard yet"):
        Engine(plan, params=p, policy=ExecPolicy(congestion="fixed_point"),
               device=CPU).run(b, shard_devices=[CPU, CPU])
    with pytest.raises(ValueError, match="shard_axis='G' needs a "
                                         "multi-graph engine"):
        Engine(g, params=p, device=CPU).run(b, shard=True, shard_axis="G")
    with pytest.raises(ValueError, match="shard_axis='K' needs a cost "
                                         "batch"):
        Engine(g, params=p, device=CPU).run(b, shard=True, shard_axis="K")
    # an uneven device list is refused, never padded
    with pytest.raises(ValueError, match="evenly"):
        Engine(g, params=p, device=CPU).run(b, shard_axis="S",
                                            shard_devices=[CPU] * 3)
