"""K cost lanes that own their gap shares, gap classes and latency rows.

A ``CostBatch`` whose ``egap``, ``egclass`` or ``elat`` vary across its
blocks (or, hand-assembled, differ from the plan's) runs as K lanes that
own those fields (``sweep.api._owned``, ``sweep.engine.stage_lanes``).
The batches here are the same graph built under three two-class
``pod_model`` networks whose rank-to-class maps differ (pods of 2, 4 and
8 ranks), stacked with ``plan_hash`` None: the structure is one, the
classes, gap shares, latency rows and constants differ by block.

On the CPU (the kernels' plain versions, ``device="cpu"``):

* segment lanes bit-equal (T, λ, ρ) to each block's solo rebuild and to
  ``core.dag`` under the block's own model, on ``stencil2d(4, 4, 10)``;
* dense lanes bit-equal to their solo rebuilds, and within T 1e-5, λ 1e-5
  and ρ 1e-4 relative of the reference's pallas ``Engine.run(costs=cb)``
  on the same batch;
* congested lanes bit-equal to solo congested runs (each rebuild keeps
  the structure's link classes, which the lanes share, as the
  reference's vmap shares them);
* packed G × K on an allreduce pair (ring, recursive doubling), both
  backends;
* a batch that owns no field stages and answers as today's lanes;
* the result cache keys on the owned fields.

On the card (``-m gpu``): the level loops and the walk over owned lanes
against their plain versions, bit for bit.  JAX is imported inside a
fixture only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import dag, loggps, synth
from repro_torch.kernels.maxplus import (dense_levels_f32, segment_levels_f64,
                                         segment_levels_f64_ref,
                                         sparse_backtrace)
from repro_torch.sweep import (CostBatch, Engine, ExecPolicy, Query,
                               SweepCache, compile_plan, latency_grid,
                               pack_plans)
from repro_torch.sweep import api, engine as eng

SEG = ExecPolicy("segment")
DENSE = ExecPolicy("dense")
PODS = (2, 4, 8)
ALPHA = {"ici": 0.3, "dcn": 0.8}
BETA = {"ici": 0.05, "dcn": 0.1}
FIELDS = ("econst", "egap", "egclass", "elat")


def models(congested=False):
    kw = dict(alpha=ALPHA, beta=BETA) if congested else {}
    return [loggps.pod_model(pod_size=s, **kw).params() for s in PODS]


def stencils(congested=False):
    """[(graph, params)] of stencil2d(4, 4, 10) under each pod model (with
    halos of 20 MB when congested, so that links fill)."""
    halo = 2e7 if congested else 64e3
    return [(synth.stencil2d(4, 4, 10, halo_bytes=halo, params=p), p)
            for p in models(congested)]


def allreduces(algo):
    return [(synth.allreduce_chain(8, 2, params=p, algo=algo), p)
            for p in models()]


def stacked(plans) -> CostBatch:
    """The plans' fields stacked as K blocks of one hand-assembled batch."""
    return CostBatch(**{f: np.stack([getattr(pl, f) for pl in plans])
                        for f in FIELDS}, plan_hash=None)


#: the two classes' gap scales: unequal, so a lane's gap classes matter
GSCALE = np.array([1.0, 1.5])


def grid(p, S=6, top=40.0):
    b = latency_grid(p, np.linspace(0.0, top, S))
    return dataclasses.replace(b, gscale=b.gscale * GSCALE)


def triple(r, *idx):
    return tuple(None if x is None else x[idx] for x in (r.T, r.lam, r.rho))


def same(got, want, msg=""):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=msg)


def close(got, want, msg=""):
    for a, b, rtol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7, err_msg=msg)


def solo(plan, policy, batch, params=None):
    return Engine(plan, params=params, policy=policy,
                  device="cpu").run(Query(batch))


@pytest.fixture(scope="module")
def case():
    gps = stencils()
    plans = [compile_plan(g, p) for g, p in gps]
    for f in ("egap", "egclass", "elat"):
        assert not np.array_equal(getattr(plans[0], f),
                                  getattr(plans[1], f)), f
    return gps, plans, stacked(plans), grid(gps[0][1])


def test_owned_fields_are_the_ones_that_differ(case):
    _, plans, cb, _ = case
    fields = {n: getattr(plans[0], n) for n in eng.LANE_FIELDS}
    assert api._owned(cb, fields) == ("egap", "egclass", "elat")
    ex = plans[0].patch_costs(np.ones((3, plans[0].epos_e.shape[0])))
    assert api._owned(ex, fields) == ()
    hand = dataclasses.replace(ex, plan_hash=None)
    assert api._owned(hand, fields) == ()
    only = dataclasses.replace(ex, egclass=cb.egclass)
    assert api._owned(only, fields) == ("egclass",)


def test_segment_lanes_equal_rebuilds_and_core_dag(case):
    gps, plans, cb, batch = case
    res = Engine(plans[0], policy=SEG, device="cpu").run(
        Query(batch, costs=cb))
    assert res.axes == ("K", "S") and res.K == len(PODS)
    # core.dag reads a scenario's latencies from its params, its gap
    # scales as 1
    plain = latency_grid(gps[0][1], np.linspace(0.0, 40.0, 6))
    res1 = Engine(plans[0], policy=SEG, device="cpu").run(
        Query(plain, costs=cb))
    for k, ((g, p), pl) in enumerate(zip(gps, plans)):
        same(triple(res, k), triple(solo(pl, SEG, batch)), f"rebuild {k}")
        lp = dag.LevelPlan(g)
        out = [lp.forward(p.replace(L=tuple(plain.L[i])))
               for i in range(plain.S)]
        same(triple(res1, k), (np.array([s.T for s in out]),
                               np.stack([s.lam for s in out]),
                               np.stack([s.rho() for s in out])),
             f"core.dag {k}")
    assert len({float(t) for t in res.T[:, -1]}) == len(PODS)
    # values only: the same T
    vals = Engine(plans[0], policy=SEG, device="cpu").run(
        Query(batch, costs=cb, outputs=("T",)))
    np.testing.assert_array_equal(vals.T, res.T)


@pytest.fixture(scope="module")
def ref_sweep():
    pytest.importorskip("jax")
    from repro import sweep
    return sweep


def _ref_batch(plans_ref):
    """The reference's hand-assembled batch of the same blocks: every cost
    field of each rebuilt plan, stacked, no plan hash."""
    from repro.sweep.compile import COST_FIELDS, CostBatch as RefBatch
    cbs = [pl.patch_costs(np.zeros((1, pl.epos_e.shape[0])))
           for pl in plans_ref]
    return RefBatch(**{f: np.concatenate([np.asarray(getattr(c, f))
                                          for c in cbs])
                       for f in COST_FIELDS}, plan_hash=None)


def test_dense_lanes_match_rebuilds_and_reference_pallas(case, ref_sweep):
    from repro.core import loggps as rl, synth as rs
    gps, plans, cb, batch = case
    res = Engine(plans[0], policy=DENSE, device="cpu").run(
        Query(batch, costs=cb))
    for k, pl in enumerate(plans):
        same(triple(res, k), triple(solo(pl, DENSE, batch)), f"rebuild {k}")
    refs = []
    for s in PODS:
        p = rl.pod_model(pod_size=s).params()
        refs.append((rs.stencil2d(4, 4, 10, params=p), p))
    plans_ref = [ref_sweep.compile_plan(g, p) for g, p in refs]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(plans_ref[1], f),
                                      getattr(plans[1], f), err_msg=f)
    p_ref = refs[0][1]
    b_ref = ref_sweep.latency_grid(p_ref, batch.L[:, 0] - p_ref.L[0])
    b_ref = dataclasses.replace(b_ref, gscale=b_ref.gscale * GSCALE)
    np.testing.assert_array_equal(b_ref.L, batch.L)
    np.testing.assert_array_equal(b_ref.gscale, batch.gscale)
    want = ref_sweep.Engine(
        plans_ref[0], params=p_ref,
        policy=ref_sweep.ExecPolicy(backend="pallas", cache=None)).run(
        ref_sweep.Query(b_ref, costs=_ref_batch(plans_ref)))
    assert want.axes == res.axes == ("K", "S")
    close((res.T, res.lam, res.rho), (want.T, want.lam, want.rho))


def test_congested_lanes_equal_solo_congested_runs():
    gps = stencils(congested=True)
    plans = [compile_plan(g, p) for g, p in gps]
    batch = grid(gps[0][1], 4)
    pol = ExecPolicy("segment", congestion="fixed_point", max_iters=40)
    res = Engine(plans[0], params=gps[0][1], policy=pol,
                 device="cpu").run(Query(batch, costs=stacked(plans)))
    assert res.congestion_iters.shape == (len(PODS), batch.S)
    for k, ((g, p), pl) in enumerate(zip(gps, plans)):
        # the lanes share the structure's links and their classes
        rebuilt = dataclasses.replace(pl, link_classes=plans[0].link_classes)
        want = solo(rebuilt, pol, batch, params=p)
        same(triple(res, k), triple(want), f"lane {k}")
        np.testing.assert_array_equal(res.congestion_iters[k],
                                      want.congestion_iters)
    assert (res.congestion_iters > 1).any()
    assert len({float(t) for t in res.T[:, -1]}) == len(PODS)


@pytest.mark.parametrize("policy", [SEG, DENSE], ids=["segment", "dense"])
def test_packed_gk_owned_lanes_equal_rebuilds(policy):
    algos = ("ring", "recursive_doubling")
    gps = [allreduces(a) for a in algos]
    plans = [[compile_plan(g, p) for g, p in row] for row in gps]
    batches = [grid(gps[0][0][1], 5, top) for top in (40.0, 12.0)]
    e = Engine([row[0] for row in plans], names=list(algos), policy=policy,
               device="cpu")
    res = e.run(Query(batches, costs=[stacked(row) for row in plans]))
    assert res.axes == ("G", "K", "S") and (res.G, res.K) == (2, len(PODS))
    for gi, row in enumerate(plans):
        for k, pl in enumerate(row):
            same(triple(res, gi, k), triple(solo(pl, policy, batches[gi])),
                 f"g={gi} k={k}")
    # one graph's blocks own the fields, the other's are extras
    raw = np.zeros((len(PODS), plans[1][0].epos_e.shape[0]))
    mixed = e.run(Query(batches, costs=[stacked(plans[0]), raw]))
    same(triple(mixed, 0), triple(res, 0))
    for k in range(len(PODS)):
        same(triple(mixed, 1, k), triple(solo(plans[1][0], policy,
                                              batches[1])))


@pytest.mark.parametrize("policy", [SEG, DENSE], ids=["segment", "dense"])
def test_batch_owning_nothing_runs_as_todays_lanes(case, policy,
                                                   monkeypatch):
    _, plans, _, batch = case
    plan = plans[1]
    ex = np.random.default_rng(3).uniform(0, 5, (3, plan.epos_e.shape[0]))
    patched = plan.patch_costs(ex)
    hand = CostBatch(**{f: np.array(getattr(patched, f)) for f in FIELDS},
                     plan_hash=None)
    staged = []
    real = eng.stage_lanes

    def spy(a, econst, **kw):
        staged.append(kw)
        return real(a, econst, **kw)

    monkeypatch.setattr(eng, "stage_lanes", spy)
    e = Engine(plan, policy=policy, device="cpu")
    want = e.run(Query(batch, costs=patched))
    got = e.run(Query(batch, costs=hand))
    same(triple(got), triple(want))
    assert all(all(v is None for v in kw.values()) for kw in staged)
    assert len(staged) == 2


def test_cache_keys_on_the_owned_fields(case):
    _, plans, cb, batch = case
    base = plans[0].patch_costs(np.zeros((3, plans[0].epos_e.shape[0])))
    only_cls = dataclasses.replace(base, egclass=cb.egclass)
    only_lat = dataclasses.replace(base, elat=cb.elat)
    cache = SweepCache()
    e = Engine(plans[0], policy=ExecPolicy("segment", cache=cache),
               device="cpu")
    runs = {n: e.run(Query(batch, costs=c)) for n, c in
            (("base", base), ("egclass", only_cls), ("elat", only_lat))}
    assert not any(r.from_cache for r in runs.values())
    assert len(cache) == 3
    for n in ("egclass", "elat"):
        assert not np.array_equal(runs[n].T, runs["base"].T), n
        assert e.run(Query(batch, costs=dataclasses.replace(
            base, **{n: getattr(cb, n)}))).from_cache, n
    keys = {api._cost_hash(plans[0], c) for c in (base, only_cls, only_lat)}
    assert len(keys) == 3
    # extras and their patch_costs batch still share a key
    ex = np.random.default_rng(5).uniform(0, 5, (3, plans[0].epos_e.shape[0]))
    assert api._cost_hash(plans[0], ex) == \
        api._cost_hash(plans[0], plans[0].patch_costs(ex))
    cache.clear()
    e.run(Query(batch, costs=plans[0].patch_costs(ex)))
    assert e.run(Query(batch, costs=ex)).from_cache


def test_padding_slots_own_nothing(case):
    """A hand-assembled batch that differs from the plan only in padding
    slots (which no lane reads) owns no field: staging and the cache key
    take that one decision, so it runs and keys as its constants."""
    _, plans, _, batch = case
    pl = plans[0]
    base = pl.patch_costs(np.zeros((3, pl.epos_e.shape[0])))
    pad = np.ones(pl.egclass.shape, dtype=bool)
    pad[pl.epos_lvl, pl.epos_e] = False
    assert pad.any()
    egclass = np.broadcast_to(pl.egclass, (3,) + pl.egclass.shape).copy()
    egclass[:, pad] = pl.egclass.max() + 1
    hand = dataclasses.replace(base, egclass=egclass, plan_hash=None)
    fields = {n: getattr(pl, n) for n in eng.LANE_FIELDS}
    assert api._owned(hand, fields) == ("egclass",)
    assert api._owned(hand, fields, api._real(pl)) == ()
    assert api._cost_hash(pl, hand) == api._cost_hash(pl, base)
    cache = SweepCache()
    e = Engine(pl, policy=ExecPolicy("segment", cache=cache), device="cpu")
    want = e.run(Query(batch, costs=base))
    got = e.run(Query(batch, costs=hand))
    assert got.from_cache
    same(triple(got), triple(want))
    cache.clear()
    same(triple(e.run(Query(batch, costs=hand))), triple(want))


def test_link_busy_of_owned_lanes_is_each_solo_load():
    gps = stencils(congested=True)
    plans = [compile_plan(g, p) for g, p in gps]
    cpu = torch.device("cpu")
    a = eng.stage_segment(plans[0], cpu)
    a.links = eng.stage_links(plans[0], a)
    pv = eng.packed_view(a, plans[0].nlevels)
    cb = stacked(plans)
    lanes = eng.stage_lanes(pv, **{f: torch.from_numpy(
        np.ascontiguousarray(getattr(cb, f)))[None] for f in FIELDS})
    GS = torch.from_numpy(grid(gps[0][1], 3).gscale)
    busy = eng.link_busy(a.links, lanes.erec, lanes.in_edges, GS)
    for k, pl in enumerate(plans):
        ak = eng.stage_segment(pl, cpu)
        want = eng.link_busy(a.links, ak.erec, ak.in_edges, GS)
        assert torch.equal(busy[k], want), k


# -- on the card --------------------------------------------------------------

def _plain_segment(t, ssum, cho, *rest):
    *rest, lv0, lv1, csrc = rest
    segment_levels_f64_ref(t, ssum, cho, *rest[:10], lv0, lv1, csrc)


def _plain_dense(t, ssum, cho, w, A, esrc, lv_ptr, rows, row_ptr, in_edges,
                 elat_sum, vcost, csrc):
    from repro_torch.kernels.maxplus import dense_levels_f32_ref
    dense_levels_f32_ref(t, ssum, cho, w, A, esrc, elat_sum, vcost, csrc)


@pytest.mark.gpu
def test_owned_lane_kernels_match_plain_versions_on_card(monkeypatch):
    """``segment_levels_f64``, ``dense_levels_f32`` and the walk over lanes
    that own their gap shares, classes and latency rows, one plan (K 3)
    and the packed allreduce pair (G 2 × K 3), against their plain
    versions on the same card tensors, bit for bit, values and λ, at S
    256, 37 and 1; one level-loop launch and one walk each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.maxplus import sparse_walk_ref
    cuda = torch.device("cuda")
    sets = [[compile_plan(g, p) for g, p in stencils()],
            [compile_plan(g, p) for g, p in allreduces("ring")],
            [compile_plan(g, p) for g, p in allreduces("recursive_doubling")]]
    q = models()[0]
    for rows in (sets[:1], sets[1:]):
        G = len(rows)
        mp = pack_plans([r[0] for r in rows])
        cbs = [stacked(r).repad(mp.nlv_p, mp.Vmax, mp.Dmax, mp.Emax)
               for r in rows]
        blocks = {f: torch.from_numpy(np.stack(
            [np.asarray(getattr(c, f)) for c in cbs])).cuda() for f in FIELDS}
        for stage, loop, plain in (
                (eng.stage_segment, segment_levels_f64, _plain_segment),
                (eng.stage_multi, dense_levels_f32, _plain_dense)):
            a = stage(mp, cuda)
            lanes = eng.stage_lanes(a, **blocks)
            fwd = (eng.segment_forward_multi if loop is segment_levels_f64
                   else eng.dense_forward_multi)
            for S in (256, 37, 1):
                b = grid(q, S)
                LG = [torch.from_numpy(np.stack([x] * G)).cuda()
                      for x in (b.L, b.gscale)]
                for lam in (False, True):
                    n0 = (loop.launches, sparse_backtrace.launches)
                    got = fwd(a, *LG, lam, lanes=lanes)
                    torch.cuda.synchronize()
                    assert (loop.launches - n0[0],
                            sparse_backtrace.launches - n0[1]) == (1, int(lam))
                    name = loop.__name__
                    monkeypatch.setattr(eng, name, plain)
                    monkeypatch.setattr(eng, "sparse_backtrace",
                                        sparse_walk_ref)
                    want = fwd(a, *LG, lam, lanes=lanes)
                    monkeypatch.undo()
                    for u, v in zip(got, want):
                        assert (u is None and v is None) or torch.equal(u, v), \
                            (name, G, S, lam)
            del a, lanes
