"""Design-space exploration on the port (``repro_torch.explore``) against
the JAX package's ``repro.explore``.

On the CPU (``device="cpu"``), at ``preset("codesign", P=16)`` and the
reference's tiny P 4 setup, from numpy seeds:

* space sampling, encoding, mutation and the three searchers' ask
  sequences (for the same seeds and the same tells) equal the
  reference's, as do the objectives and the searchers' states;
* ``Stamper.evaluate`` is bit-equal to ``solo_objective`` and to solo
  rebuilds on segment (cost, pack and keep lanes), and within 1e-5 of the
  reference's stamper under ``ExecPolicy("pallas")`` (the port's dense);
* ``run_search``'s trajectory and best on dense equal the reference's on
  pallas (objectives within 1e-5), and two runs with one seed write the
  same bytes;
* a repeated generation hits the stamper's own cache with no level-loop
  launch; the watcher's warm rerun counts 0 new programs;
* an engine error reaches the caller of ``run_search``.

On the card (``-m gpu``): one explore generation bit-equal to the CPU's.
"""

import filecmp
import json

import numpy as np
import pytest
import torch

from repro_torch import explore, obs
from repro_torch.core import synth
from repro_torch.core.loggps import LogGPS
from repro_torch.core.rng import as_rng
from repro_torch.sweep import (Engine, ExecPolicy, Query, api, compile_plan,
                               latency_grid, sample_grid)
from repro_torch.sweep import engine as eng

SEG = ExecPolicy("segment")
DENSE = ExecPolicy("dense")


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.explore`` and ``repro.sweep`` (JAX inside:
    imported in a fixture, since the card's host has none)."""
    pytest.importorskip("jax")
    from repro import explore as rx
    from repro import sweep as rs
    return rx, rs


def stamper(policy=SEG):
    return explore.Stamper(policy, device="cpu")


def tiny():
    params = LogGPS()
    space = explore.codesign_space(4)
    lower = explore.lower_codesign(4, 2, pod=2, params=params)
    return space, lower, sample_grid(params, 6, rng=1)


def codesign16():
    params = LogGPS()
    space, lower = explore.preset("codesign", P=16, iters=2)
    return space, lower, latency_grid(params, np.linspace(0.0, 20.0, 8))


# -- spaces and searchers against the reference ---------------------------------

@pytest.mark.parametrize("P", [4, 16])
def test_space_sampling_encoding_mutation_equal_reference(P):
    from repro import explore as rx
    space, rspace = explore.codesign_space(P), rx.codesign_space(P)
    assert space.names == rspace.names
    cands = space.sample(3, n=12)
    assert cands == rspace.sample(3, n=12)
    for c in cands:
        assert space.encode(c) == rspace.encode(c)
        assert space.key(c) == rspace.key(c)
        assert space.decode(space.encode(c)) == rspace.decode(
            rspace.encode(c))
    r1, r2 = as_rng(8), np.random.default_rng(8)
    assert [space.mutate(c, r1) for c in cands] == \
        [rspace.mutate(c, r2) for c in cands]
    with pytest.raises(ValueError, match="constraint"):
        space.validate({**cands[0], "px": 1, "py": 1})
    with pytest.raises(TypeError):
        space.sample(None)


def _objective(key: str) -> float:
    """A deterministic stand-in objective with no ties."""
    return float(int.from_bytes(key.encode()[-6:], "little") % 100003) \
        + len(key) * 1e-3


@pytest.mark.parametrize("name,kw", [("random", {}),
                                     ("evolution", {"population_size": 6}),
                                     ("halving", {"rungs": 3})])
def test_searchers_ask_the_reference_sequence(name, kw):
    from repro import explore as rx
    space = explore.codesign_space(16)
    s = explore.make_searcher(name, space, 17, **kw)
    r = rx.make_searcher(name, rx.codesign_space(16), 17, **kw)
    for _ in range(4):
        a, b = s.ask(6), r.ask(6)
        assert a == b
        objs = [_objective(space.key(c)) for c in a]
        s.tell(a, objs)
        r.tell(b, objs)
        assert s.best == r.best and s.best_objective == r.best_objective
    assert json.dumps(s.state_dict(), sort_keys=True) == \
        json.dumps(r.state_dict(), sort_keys=True)
    s2 = explore.make_searcher(name, space, 0, **kw)
    s2.load_state_dict(json.loads(json.dumps(s.state_dict())))
    assert s2.ask(4) == s.ask(4)
    with pytest.raises(ValueError, match="unknown searcher"):
        explore.make_searcher("annealing", space, 0)


def test_objectives_equal_reference():
    from repro import explore as rx
    rng = np.random.default_rng(4)
    T = rng.uniform(100.0, 200.0, (5, 7))
    lam = rng.uniform(0.0, 9.0, (5, 7, 2))
    terms = [("mean", {}), ("max", {}), ("quantile", {"q": 0.9}),
             ("tolerance", {"cls": 1, "rtol": 0.02}), ("resilience", {})]
    for kind, kw in terms:
        spec = explore.ObjectiveSpec(terms=(explore.Term(kind, **kw),))
        rspec = rx.ObjectiveSpec(terms=(rx.Term(kind, **kw),))
        np.testing.assert_array_equal(spec(T, lam), rspec(T, lam))
        assert spec.to_dict() == rspec.to_dict()
        assert explore.ObjectiveSpec.from_dict(spec.to_dict()) == spec
    w = (0.5, 0.25, 0.25, 0.0, 0.0, 0.0, 0.0)
    spec = explore.ObjectiveSpec((explore.Term("resilience"),), w)
    np.testing.assert_array_equal(
        spec(T), rx.ObjectiveSpec((rx.Term("resilience"),), w)(T))
    np.testing.assert_array_equal(explore.robust_makespan(0.95)(T),
                                  rx.robust_makespan(0.95)(T))


# -- the stamper ------------------------------------------------------------------

def test_cost_pack_and_keep_lanes_equal_solo_rebuilds():
    params = LogGPS()
    scen = sample_grid(params, 8, rng=0, lat_deltas=(0.0, 80.0))
    g1 = synth.cg_like(2, 2, 2, params=params)
    g2 = synth.allreduce_chain(4, 2, params=params)
    g3 = synth.cg_like(4, 1, 2, params=params)
    rng = as_rng(5)
    msg = np.nonzero(g2.ebytes > 0)[0]
    keep = np.ones(g2.num_edges, dtype=bool)
    keep[rng.choice(msg, size=2, replace=False)] = False
    lows = [explore.Lowered(g1, params, rng.uniform(0, 9, g1.num_edges)),
            explore.Lowered(g1, params, rng.uniform(0, 9, g1.num_edges)),
            explore.Lowered(g2, params),
            explore.Lowered(g3, params),
            explore.Lowered(g2, params, keep=keep),
            explore.Lowered(g2, params, rng.uniform(0, 4, g2.num_edges),
                            keep=keep)]
    batch = stamper().evaluate(lows, scen)
    assert batch.info.lanes["keep"] == batch.info.lanes["cost"] == 1
    assert batch.info.lanes["pack"] >= 1
    for i, low in enumerate(lows):
        if low.keep is None:
            plan = compile_plan(low.graph, params,
                                extra_edge_cost=low.extra_edge_cost)
            T = Engine(plan, params=params, device="cpu").run(scen).T
        else:
            plan = compile_plan(low.graph, params)
            sb = plan.patch_structure(keep=low.keep[None])
            costs = (None if low.extra_edge_cost is None
                     else plan.patch_costs(low.extra_edge_cost[None]))
            r = Engine(sb, params=params, device="cpu").run(
                Query(scen, costs=costs))
            T = r.T[0, 0] if costs is not None else r.T[0]
        assert np.array_equal(batch.T[i], T), i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stamper_bit_equal_to_solo_objective(seed):
    space, lower, scen = codesign16()
    lows = [lower(c) for c in space.sample(seed, n=6)]
    obj = explore.robust_makespan()
    batch = stamper().evaluate(lows, scen)
    packed = obj(batch.T)
    for i, low in enumerate(lows):
        assert explore.solo_objective(low, scen, obj, device="cpu") == \
            float(packed[i])


@pytest.mark.parametrize("seed", [0, 3])
def test_stamper_dense_within_1e5_of_reference_pallas(ref, seed):
    rx, rs = ref
    params = LogGPS()
    scen = latency_grid(params, np.linspace(0.0, 20.0, 8))
    rscen = rs.latency_grid(rx.presets.LogGPS(), np.linspace(0.0, 20.0, 8))
    space, lower = explore.preset("codesign", P=16, iters=2)
    _, rlower = rx.preset("codesign", P=16, iters=2)
    cands = space.sample(seed, n=6)
    batch = stamper(DENSE).evaluate([lower(c) for c in cands], scen)
    rbatch = rx.Stamper(rs.ExecPolicy(backend="pallas")).evaluate(
        [rlower(c) for c in cands], rscen)
    np.testing.assert_allclose(batch.T, rbatch.T, rtol=1e-5)
    seg = stamper(SEG).evaluate([lower(c) for c in cands], scen)
    np.testing.assert_allclose(seg.T, rbatch.T, rtol=1e-5)


def test_repeated_generation_hits_the_stampers_cache(monkeypatch):
    space, lower, scen = codesign16()
    lows = [lower(c) for c in space.sample(2, n=6)]
    st = stamper()
    assert st.policy.cache is st.cache
    first = st.evaluate(lows, scen)
    hits0 = st.cache.stats.hits
    calls = []
    fn = eng.segment_levels_f64
    monkeypatch.setattr(eng, "segment_levels_f64",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    with obs.WATCHER.watch("warm") as rec:
        again = st.evaluate(lows, scen)
    assert calls == [] and rec.new_programs == 0
    assert st.cache.stats.hits - hits0 == again.info.dispatches
    np.testing.assert_array_equal(first.T, again.T)
    st.evaluate(lows, scen, use_cache=False)
    assert len(calls) == again.info.dispatches
    # a policy that names a cache keeps it
    from repro_torch.sweep import SweepCache
    mine = SweepCache()
    assert explore.Stamper(ExecPolicy(cache=mine)).cache is mine


def test_dedupe_and_refusals():
    params = LogGPS()
    scen = latency_grid(params, [0.0, 5.0])
    g = synth.cg_like(2, 2, 2, params=params)
    extra = np.full(g.num_edges, 3.0)
    lows = [explore.Lowered(g, params, extra.copy()) for _ in range(5)]
    batch = stamper().evaluate(lows, scen)
    assert (batch.info.candidates, batch.info.unique) == (5, 1)
    with pytest.raises(ValueError, match="nothing to evaluate"):
        stamper().evaluate([], scen)
    with pytest.raises(ValueError, match="solo_objective expects"):
        explore.solo_objective(
            explore.Lowered(g, params, keep=np.ones(g.num_edges, bool)),
            scen, explore.robust_makespan(), device="cpu")


# -- the search loop --------------------------------------------------------------

def test_run_search_equals_reference_pallas(ref, tmp_path):
    rx, rs = ref
    space, lower, scen = codesign16()
    rspace, rlower = rx.preset("codesign", P=16, iters=2)
    rscen = rs.latency_grid(rx.presets.LogGPS(), np.linspace(0.0, 20.0, 8))
    res = explore.run_search(explore.RandomSearch(space, seed=0), lower, scen,
                             generations=3, population=8,
                             objective=explore.robust_makespan(0.95),
                             stamper=stamper(DENSE))
    rres = rx.run_search(rx.RandomSearch(rspace, seed=0), rlower, rscen,
                         generations=3, population=8,
                         objective=rx.robust_makespan(0.95),
                         stamper=rx.Stamper(rs.ExecPolicy(backend="pallas")))
    assert res.best == rres.best
    assert res.best_objective == pytest.approx(rres.best_objective, rel=1e-5)
    for h, rh in zip(res.history, rres.history):
        assert h["candidates"] == rh["candidates"]
        np.testing.assert_allclose(h["objectives"], rh["objectives"],
                                   rtol=1e-5)
        assert h["stamp"] == rh["stamp"]


def test_identical_seeds_write_identical_trajectories(tmp_path):
    space, lower, scen = tiny()
    paths = [str(tmp_path / f"t{i}.jsonl") for i in range(2)]
    for p in paths:
        explore.run_search(
            explore.RegularizedEvolution(space, seed=13, population_size=6),
            lower, scen, generations=3, population=6, stamper=stamper(),
            trajectory=p)
    assert filecmp.cmp(paths[0], paths[1], shallow=False)
    rec = json.loads(open(paths[0]).readline())
    assert set(rec) == {"gen", "searcher", "scenario_fraction", "candidates",
                        "objectives", "best_objective", "best", "stamp"}


def test_halving_budget_metrics_and_span():
    space, lower, scen = tiny()
    gens = obs.REGISTRY.get("explore_generations_total")
    g0 = gens.value()
    with obs.collect() as spans:
        res = explore.run_search(explore.SuccessiveHalving(space, seed=2),
                                 lower, scen, generations=3, population=8,
                                 stamper=stamper())
    assert [h["scenario_fraction"] for h in res.history] == [0.25, 0.5, 1.0]
    assert np.isfinite(res.best_objective)
    assert gens.value() == g0 + 3
    assert [e.name for e in spans].count("explore.generation") == 3


def test_engine_error_reaches_the_caller(monkeypatch):
    space, lower, scen = tiny()

    def boom(self, *a, **kw):
        raise RuntimeError("engine failed")
    monkeypatch.setattr(api.Engine, "run", boom)
    with pytest.raises(RuntimeError, match="engine failed"):
        explore.run_search(explore.RandomSearch(space, seed=0), lower, scen,
                           generations=1, population=4, stamper=stamper())


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("policy", [SEG, DENSE], ids=["segment", "dense"])
def test_generation_on_card_equals_cpu(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    space, lower, scen = codesign16()
    lows = [lower(c) for c in space.sample(5, n=8)]
    card = explore.Stamper(policy).evaluate(lows, scen)
    cpu = explore.Stamper(policy, device="cpu").evaluate(lows, scen)
    np.testing.assert_array_equal(card.T, cpu.T)
