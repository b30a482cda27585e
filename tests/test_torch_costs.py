"""The candidate-cost axis K: ``compile_plan(extra_edge_cost=)``,
``CostBatch`` / ``patch_costs`` / ``with_extra_cost``, and K lanes of
``Engine.run(Query(costs=...))`` on the segment and dense backends, solo
and on a packed graph axis (G×K).

On the CPU (the kernels' plain versions, ``device="cpu"``):

* the compiled fields, the edge-position records and the cost batches
  equal the reference's edge-view fields bit for bit, on a random DAG, a
  2-D stencil and a two-class stencil, with extras drawn from numpy seeds;
* segment K lanes are bit-equal (T, λ, ρ) to ``repro.core.dag`` on the
  graph whose edge constants carry the extras, to a solo forward of
  ``compile_plan(g, p, extra_edge_cost=extras[k])``, and to the
  reference's ``_segment_core_costs`` / ``_segment_core_axes`` (under
  ``jax.enable_x64(True)``; the reference's ``Engine`` fails on this JAX's
  ``jax.experimental.enable_x64`` import on that route);
* dense K lanes are within T 1e-5, λ 1e-5 and ρ 1e-4 relative of the
  reference's pallas ``Engine.run(Query(...))`` on the same query;
* the unified axis matrix (the reference's S / KS / GS / GKS cells of
  ``tests/test_conformance.py``, and BS and BKS) on both backends, every
  lane equal to a solo forward of its rebuilt plan;
* the refusals of the reference's ``_costs`` and ``run`` raise
  ``ValueError``; one level-loop run and one walk a forward whatever K.

On the card (``-m gpu``): the lane kernels (``segment_levels_f64``,
``dense_levels_f32``, ``sparse_backtrace``) against their plain versions
at S 1056, 37 and 1 and K 1, 3 and 64, bit for bit.  JAX is imported
inside fixtures only: the card's host has none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dag as ref_dag, loggps as ref_loggps
from repro.core import synth as ref_synth
from repro.sweep import compile as ref_compile, engine as ref_engine

from repro_torch.core import loggps, synth
from repro_torch.kernels.maxplus import (dense_levels_f32, segment_levels_f64,
                                         segment_levels_f64_ref,
                                         sparse_backtrace)
from repro_torch.sweep import (CostBatch, Engine, ExecPolicy, Query,
                               compile_plan, latency_grid, pack_plans)
from repro_torch.sweep import engine as eng
from repro_torch.sweep.compile import COST_FIELDS

SEG = ExecPolicy("segment")
DENSE = ExecPolicy("dense")
CASES = ("random", "stencil", "stencil2c")
K = 3
CPU = torch.device("cpu")
EPOS = ("epos_lvl", "epos_dst", "epos_e")
PLAN_FIELDS = ("esrc", "edstl", "emask", "econst", "egap", "egclass",
               "elat", "vcost_lv", "valid_flat", "vert_of_slot")


def build(name, S, L):
    """(graph, params) of one case with a package's ``synth``/``loggps``."""
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    if name == "random":
        return S.random_dag(np.random.default_rng(3), nranks=4, nops=40,
                            p_msg=0.5, params=p1), p1
    if name == "random4":
        return S.random_dag(np.random.default_rng(4), nranks=4, nops=40,
                            p_msg=0.5, params=p1), p1
    if name == "stencil2c":
        p2 = L.pod_model(pod_size=4).params()
        return S.stencil2d(4, 4, 3, params=p2), p2
    return S.stencil2d(4, 4, 3, params=p1), p1


def port_case(name):
    return build(name, synth, loggps)


def ref_case(name):
    return build(name, ref_synth, ref_loggps)


def extras(g, seed, n=K):
    """[n, ne] nonnegative extra edge costs (µs) from a numpy seed."""
    return np.random.default_rng(seed).uniform(0.0, 5.0, (n, g.num_edges))


def grid(p, S=6, top=40.0):
    return latency_grid(p, np.linspace(0.0, top, S))


def _rho(T, lam, L):
    return np.where(T[..., None] > 0,
                    L * lam / np.maximum(T[..., None], 1e-300), 0.0)


def _same(got, want, msg=""):
    for a, b in zip((got.T, got.lam, got.rho), want):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=msg)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.T, want.T, rtol=1e-5, atol=1e-7,
                               err_msg=msg)
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5, atol=1e-5,
                               err_msg=msg)
    np.testing.assert_allclose(got.rho, want.rho, rtol=1e-4, atol=1e-5,
                               err_msg=msg)


def _ref_grid(ref_sweep, p_ref, batch):
    """The reference's ScenarioBatch of the same latencies as ``batch``."""
    b = ref_sweep.latency_grid(p_ref, batch.L[:, 0] - p_ref.L[0])
    np.testing.assert_array_equal(b.L, batch.L)
    return b


def _solo(g, p, ex, policy, batch):
    r = Engine(compile_plan(g, p, extra_edge_cost=ex), policy=policy,
               device="cpu").run(batch)
    return r.T, r.lam, r.rho


@pytest.fixture(scope="module")
def ref_sweep():
    pytest.importorskip("jax")
    from repro import sweep
    return sweep


@pytest.fixture(scope="module")
def ref_axes():
    """``run(plan, L, GS, cost_block, multi)`` → (T, λ, ρ) of the
    reference's ``_segment_core_axes`` with the candidate axis over the
    patched constants (``vconst``), under 64-bit JAX."""
    jax = pytest.importorskip("jax")
    fwds = {}

    def run(plan, L, GS, vconst, multi=False):
        costs = (0, None, None, None, None)
        if multi not in fwds:
            fwds[multi] = jax.jit(ref_engine._segment_core_axes(
                True, multi, costs))
        with jax.enable_x64(True):
            arrs = list(ref_engine._stage_arrays(plan, "segment", 1 << 40))
            arrs[2] = jax.numpy.asarray(vconst)
            T, lam = fwds[multi](*arrs, L, GS)
            T, lam = np.asarray(T), np.asarray(lam)
        assert T.dtype == lam.dtype == np.float64
        Lb = L[:, None] if multi else L
        return T, lam, _rho(T, lam, Lb)

    return run


# -- fields -------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_compile_extra_cost_equals_reference(name):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    ex = extras(g, 1)[0]
    plan = compile_plan(g, p, extra_edge_cost=ex)
    ref = ref_compile.compile_plan(g_ref, p_ref, extra_edge_cost=ex)
    for f in PLAN_FIELDS + EPOS:
        a, b = getattr(plan, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert not np.array_equal(plan.econst, compile_plan(g, p).econst)


@pytest.mark.parametrize("name", CASES)
def test_patch_costs_and_with_extra_cost_equal_reference(name):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    ex = extras(g, 2)
    plan, ref = compile_plan(g, p), ref_compile.compile_plan(g_ref, p_ref)
    cb, cb_ref = plan.patch_costs(ex), ref.patch_costs(ex)
    assert isinstance(cb, CostBatch) and cb.K == cb_ref.K == K
    assert cb.plan_hash == plan.content_hash()
    for f in COST_FIELDS:
        a, b = getattr(cb, f), getattr(cb_ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # only the constants are materialized; the rest are stride-0 views
    assert cb.econst.strides[0] != 0
    assert all(getattr(cb, f).strides[0] == 0 for f in COST_FIELDS[1:])
    for k in range(K):
        np.testing.assert_array_equal(
            cb.econst[k], compile_plan(g, p, extra_edge_cost=ex[k]).econst)
    w = plan.with_extra_cost(ex[1])
    np.testing.assert_array_equal(w.econst, ref.with_extra_cost(ex[1]).econst)
    assert w.esrc is plan.esrc and w.content_hash() != plan.content_hash()
    # padding repeats the last block, broadcasts stay broadcasts
    pd, pd_ref = cb.padded(5), cb_ref.padded(5)
    for f in COST_FIELDS:
        np.testing.assert_array_equal(getattr(pd, f), getattr(pd_ref, f))
    assert pd.K == 5 and pd.egap.strides[0] == 0
    with pytest.raises(ValueError, match="pad"):
        cb.padded(2)


@pytest.mark.parametrize("name", CASES)
def test_repad_equals_reference(name):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    ex = extras(g, 3)
    plan, ref = compile_plan(g, p), ref_compile.compile_plan(g_ref, p_ref)
    env = (2 * plan.nlv_p, 2 * plan.Vmax, 2 * plan.Dmax, 2 * plan.Emax)
    cb = plan.patch_costs(ex).repad(*env)
    cb_ref = ref.patch_costs(ex).repad(*env)
    for f in COST_FIELDS:
        np.testing.assert_array_equal(getattr(cb, f), getattr(cb_ref, f))
    assert cb.egclass.strides[0] == 0
    with pytest.raises(ValueError, match="smaller"):
        cb.repad(plan.nlv_p, plan.Vmax, plan.Dmax, plan.Emax)


def test_content_hashes():
    g, p = port_case("random")
    a, b = compile_plan(g, p), compile_plan(g, p)
    assert a.content_hash() == b.content_hash()
    g4, _ = port_case("random4")
    assert compile_plan(g4, p).content_hash() != a.content_hash()
    mp = pack_plans([a, compile_plan(g4, p)])
    assert mp.plan_hashes == (a.content_hash(),
                              compile_plan(g4, p).content_hash())
    assert mp.content_hash() == pack_plans([b, compile_plan(g4, p)]
                                           ).content_hash()
    assert mp.content_hash() != pack_plans([compile_plan(g4, p), b]
                                           ).content_hash()


def test_carry_takes_the_records():
    from repro_torch.carry import PLAN_ARRAYS, plan_from_arrays
    g_ref, p_ref = ref_case("stencil")
    ref = ref_compile.compile_plan(g_ref, p_ref)
    fields = {f: getattr(ref, f) for f in list(PLAN_ARRAYS) + list(EPOS)
              + ["vsrc"]}
    plan = plan_from_arrays(fields, ref.nv, ref.nclass, ref.nlevels)
    for f in EPOS:
        np.testing.assert_array_equal(getattr(plan, f), getattr(ref, f))
    ex = extras(g_ref, 4)
    np.testing.assert_array_equal(plan.patch_costs(ex).econst,
                                  ref.patch_costs(ex).econst)
    fields.pop("epos_e")
    with pytest.raises(ValueError, match="come together"):
        plan_from_arrays(fields, ref.nv, ref.nclass, ref.nlevels)


# -- segment K lanes ----------------------------------------------------------

@pytest.mark.parametrize("raw", [True, False], ids=["extras", "costbatch"])
@pytest.mark.parametrize("name", CASES)
def test_segment_lanes_equal_core_dag_rebuild_and_reference(name, raw,
                                                            ref_axes):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    ex = extras(g, 5)
    plan = compile_plan(g, p)
    batch = grid(p)
    res = Engine(plan, policy=SEG, device="cpu").run(
        Query(batch, costs=ex if raw else plan.patch_costs(ex)))
    assert res.axes == ("K", "S") and res.K == K and res.backend == "segment"
    assert res.T.shape == (K, batch.S) and res.lam.shape[:2] == (K, batch.S)
    for k in range(K):
        _same(_lane(res, k), _solo(g, p, ex[k], SEG, batch),
              f"rebuild k={k}")
        # core.dag on the graph whose edge constants carry the extras
        gk = dataclasses.replace(g_ref, econst=g_ref.econst + ex[k])
        lp = ref_dag.LevelPlan(gk)
        out = [lp.forward(p_ref.replace(L=tuple(batch.L[i])))
               for i in range(batch.S)]
        _same(_lane(res, k), (np.array([s.T for s in out]),
                              np.stack([s.lam for s in out]),
                              np.stack([s.rho() for s in out])),
              f"core.dag k={k}")
    ref = ref_compile.compile_plan(g_ref, p_ref)
    want = ref_axes(ref, batch.L, batch.gscale, ref.patch_costs(ex).vconst)
    _same(res, want, "reference _segment_core_axes")
    assert (res.lam >= 1).any() and len({float(t) for t in res.T[:, -1]}) > 1


def _lane(res, k):
    """Lane k of a ("K", "S") result as a (T, λ, ρ)-carrying object."""
    return dataclasses.replace(res, T=res.T[k], lam=res.lam[k],
                               rho=res.rho[k], axes=("S",))


def test_segment_gk_equals_rebuilds_and_reference(ref_axes):
    """G = 2 packed graphs × K = 3 cost blocks, each graph with its own
    scenario batch: every (g, k) lane equals its solo rebuild and the
    reference's ``_segment_core_axes`` with G and K."""
    names = ("random", "random4")
    ports, refs = [port_case(n) for n in names], [ref_case(n) for n in names]
    exs = [extras(g, 6 + i) for i, (g, _) in enumerate(ports)]
    plans = [compile_plan(g, q) for g, q in ports]
    batches = [grid(ports[0][1], 5, top) for top in (40.0, 12.0)]
    e = Engine(plans, names=list(names), policy=SEG, device="cpu")
    res = e.run(Query(batches, costs=exs))
    assert res.axes == ("G", "K", "S") and (res.G, res.K) == (2, K)
    for gi, (g, q) in enumerate(ports):
        for k in range(K):
            got = dataclasses.replace(res, T=res.T[gi, k],
                                      lam=res.lam[gi, k], rho=res.rho[gi, k])
            _same(got, _solo(g, q, exs[gi][k], SEG, batches[gi]),
                  f"g={gi} k={k}")
    mp = ref_compile.pack_plans([ref_compile.compile_plan(g, q)
                                 for g, q in refs])
    vconst = np.stack([ref_compile.repad_plan(
        ref_compile.compile_plan(g, q), *mp.vsrc.shape[1:],
        mp.esrc.shape[2]).patch_costs(x).vconst for (g, q), x in
        zip(refs, exs)])
    L = np.stack([b.L for b in batches])
    GS = np.stack([b.gscale for b in batches])
    _same(res, ref_axes(mp, L, GS, vconst, multi=True), "reference G x K")
    # one batch broadcast to both graphs equals passing it twice
    once = e.run(Query(batches[0], costs=exs))
    twice = e.run(Query([batches[0]] * 2, costs=exs))
    _same(once, (twice.T, twice.lam, twice.rho))


# -- dense K lanes against the reference pallas backend --------------------------

@pytest.mark.parametrize("name", CASES)
def test_dense_lanes_match_reference_pallas(name, ref_sweep):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    ex = extras(g, 8)
    batch = grid(p)
    res = Engine(compile_plan(g, p), policy=DENSE, device="cpu").run(
        Query(batch, costs=ex))
    ref_eng = ref_sweep.Engine(
        ref_sweep.compile_plan(g_ref, p_ref), params=p_ref,
        policy=ref_sweep.ExecPolicy(backend="pallas", cache=None))
    want = ref_eng.run(ref_sweep.Query(_ref_grid(ref_sweep, p_ref, batch),
                                       costs=ex))
    assert want.axes == res.axes == ("K", "S")
    _close(res, want, name)
    for k in range(K):
        _same(_lane(res, k), _solo(g, p, ex[k], DENSE, batch), f"k={k}")


def test_dense_gk_matches_reference_pallas(ref_sweep):
    names = ("random", "random4")
    ports, refs = [port_case(n) for n in names], [ref_case(n) for n in names]
    exs = [extras(g, 9 + i) for i, (g, _) in enumerate(ports)]
    batches = [grid(ports[0][1], 5, top) for top in (40.0, 12.0)]
    res = Engine([compile_plan(g, q) for g, q in ports], policy=DENSE,
                 device="cpu").run(Query(batches, costs=exs))
    want = ref_sweep.Engine(
        [ref_sweep.compile_plan(g, q) for g, q in refs],
        policy=ref_sweep.ExecPolicy(backend="pallas", cache=None)).run(
        ref_sweep.Query([_ref_grid(ref_sweep, refs[0][1], b)
                         for b in batches], costs=exs))
    assert res.axes == want.axes == ("G", "K", "S")
    _close(res, want)


# -- the unified axis matrix ----------------------------------------------------

AXISSETS = ("S", "KS", "GS", "GKS", "BS", "BKS")
MATRIX = ("random", "stencil")


@pytest.fixture(scope="module")
def matrix():
    """The port's cases, their extras and keep masks, and each (case, b, k)
    lane's solo rebuild on both backends (``b`` None: no structure axis,
    ``k`` None: no cost axis)."""
    cases = {n: port_case(n) for n in MATRIX}
    ex = {n: extras(g, 11 + i) for i, (n, (g, _)) in enumerate(cases.items())}
    g0, p0 = cases[MATRIX[0]]
    rng = np.random.default_rng(12)
    keeps = rng.random((2, g0.num_edges)) > 0.15
    batch = grid(p0, 5)
    solo = {}
    for be, pol in (("segment", SEG), ("dense", DENSE)):
        for n, (g, q) in cases.items():
            for k in (None,) + tuple(range(K)):
                plan = compile_plan(g, q, extra_edge_cost=(
                    None if k is None else ex[n][k]))
                solo[(be, n, None, k)] = Engine(
                    plan, policy=pol, device="cpu").run(batch)
                if n != MATRIX[0]:
                    continue
                for b in range(keeps.shape[0]):
                    solo[(be, n, b, k)] = Engine(
                        plan.patch_structure(keep=keeps[b]), policy=pol,
                        device="cpu").run(batch)
    return cases, ex, keeps, batch, solo


@pytest.mark.parametrize("axisset", AXISSETS)
@pytest.mark.parametrize("backend", ("segment", "dense"))
def test_unified_axis_matrix(backend, axisset, matrix):
    """Every populated-axis combination against the solo forward of each
    lane's rebuilt plan, bit for bit, on both backends: the reference's S /
    KS / GS / GKS cells (``tests/test_conformance.py``), and BS and BKS
    (B = 2 edge-removal variants of the first case)."""
    cases, ex, keeps, batch, solo = matrix
    pol = SEG if backend == "segment" else DENSE
    has_G, has_K, has_B = ("G" in axisset, "K" in axisset, "B" in axisset)
    names = MATRIX if has_G else MATRIX[:1]
    plans = [compile_plan(*cases[n]) for n in names]
    eng_ = (Engine(plans, names=list(names), policy=pol, device="cpu")
            if has_G else Engine(plans[0], policy=pol, device="cpu"))
    q = Query(batch,
              costs=(None if not has_K else [ex[n] for n in names]
                     if has_G else ex[names[0]]),
              structure=(plans[0].patch_structure(keep=keeps)
                         if has_B else None))
    res = eng_.run(q)
    assert res.axes == tuple(axisset) and res.backend == backend
    lead = [(gi, n, None) for gi, n in enumerate(names)] if has_G else (
        [(b, names[0], b) for b in range(keeps.shape[0])] if has_B
        else [(None, names[0], None)])
    for i, n, b in lead:
        for k in (range(K) if has_K else [None]):
            idx = tuple(x for x in (i, k) if x is not None)
            want = solo[(backend, n, b, k)]
            wT, wl, wr = ((want.T[0], want.lam[0], want.rho[0])
                          if b is not None else (want.T, want.lam, want.rho))
            for got, w in ((res.T[idx], wT), (res.lam[idx], wl),
                           (res.rho[idx], wr)):
                np.testing.assert_array_equal(got, w,
                                              err_msg=f"{n} {idx} {axisset}")


# -- refusals -----------------------------------------------------------------

def test_cost_refusals():
    """The reference's ``_costs`` and ``run`` refusals, each a
    ValueError: a foreign envelope, a batch patched from another plan of
    the same envelope, per-graph K mismatch, a single CostBatch or a wrong
    count on a packed engine, raw extras on a bare MultiPlan, a wrong edge
    count, the sparse backend, and outputs outside T/lam/rho; a batch
    varying more than the constants runs, each lane its solo forward."""
    g, p = port_case("random")
    g4, _ = port_case("random4")
    gs, ps = port_case("stencil")
    plan, plan4 = compile_plan(g, p), compile_plan(g4, p)
    assert plan.envelope == plan4.envelope
    batch = grid(p)
    e = Engine(plan, policy=SEG, device="cpu")
    ex = extras(g, 13)
    with pytest.raises(ValueError, match="envelope"):
        e.run(Query(batch, costs=compile_plan(gs, ps).patch_costs(
            extras(gs, 1))))
    with pytest.raises(ValueError, match="different plan"):
        e.run(Query(batch, costs=plan4.patch_costs(extras(g4, 1))))
    with pytest.raises(ValueError, match="edges"):
        e.run(Query(batch, costs=ex[:, :-1]))
    cb = plan.patch_costs(ex)
    # a batch varying more than the constants is no longer refused: its
    # lanes own those fields, each lane a solo forward of its fields
    bad = dataclasses.replace(cb, egap=np.stack([cb.egap[0]] * K) +
                              np.arange(K)[:, None, None])
    hand = dataclasses.replace(cb, plan_hash=None,
                               elat=np.broadcast_to(cb.elat[:1] + 1.0,
                                                    cb.elat.shape))
    for cbk, n in ((bad, "egap"), (hand, "elat")):
        res = e.run(Query(batch, costs=cbk))
        for k in range(K):
            solo = Engine(dataclasses.replace(
                plan, econst=cb.econst[k], **{n: getattr(cbk, n)[k]}),
                policy=SEG, device="cpu").run(Query(batch))
            for got, want in ((res.T[k], solo.T), (res.lam[k], solo.lam),
                              (res.rho[k], solo.rho)):
                np.testing.assert_array_equal(got, want, f"{n} lane {k}")
    # a hand-assembled batch that keeps the plan's fields runs
    ok = e.run(Query(batch, costs=dataclasses.replace(cb, plan_hash=None)))
    np.testing.assert_array_equal(ok.T, e.run(Query(batch, costs=cb)).T)
    packed = Engine([plan, plan4], policy=SEG, device="cpu")
    with pytest.raises(ValueError, match="single CostBatch"):
        packed.run(Query(batch, costs=cb))
    with pytest.raises(ValueError, match="cost batches for"):
        packed.run(Query(batch, costs=[ex]))
    with pytest.raises(ValueError, match="share K"):
        packed.run(Query(batch, costs=[ex, extras(g4, 2, n=2)]))
    with pytest.raises(ValueError, match="graph 1"):
        packed.run(Query(batch, costs=[ex, cb]))
    bare = Engine(pack_plans([plan, plan4]), policy=SEG, device="cpu")
    with pytest.raises(ValueError, match="member plans"):
        bare.run(Query(batch, costs=[ex, extras(g4, 2)]))
    # per-graph CostBatches ride a bare MultiPlan
    bare.run(Query(batch, costs=[cb, plan4.patch_costs(extras(g4, 2))]))
    sparse = Engine(g, params=p, policy=ExecPolicy("sparse"), device="cpu")
    with pytest.raises(ValueError, match="sparse backend"):
        sparse.run(Query(batch, costs=ex))
    with pytest.raises(ValueError, match="subset"):
        e.run(Query(batch, outputs=("T", "grad")))
    with pytest.raises(ValueError, match="subset"):
        e.run(Query(batch, outputs=()))
    with pytest.raises(ValueError, match="needs scenarios"):
        e.run(Query(costs=ex))
    with pytest.raises(ValueError, match="not both"):
        e.run(batch, scenarios=batch)
    stripped = dataclasses.replace(plan, epos_lvl=None, epos_dst=None,
                                   epos_e=None)
    with pytest.raises(ValueError, match="edge-position"):
        stripped.patch_costs(ex)


def test_query_detached_engine_not_ported():
    """The detached engine is ported with the result cache:
    ``Query(graphs=..., params=...)`` builds and runs, and gives the bound
    engine's answer (the name records the test's first form, which
    expected the refusal)."""
    g, p = port_case("random")
    e = Engine(compile_plan(g, p), policy=SEG, device="cpu")
    got = e.run(Query(grid(p), graphs=[(g, p)]))
    want = Engine([(g, p)], policy=SEG, device="cpu").run(grid(p))
    assert got.axes == ("G", "S")
    _same(got, (want.T, want.lam, want.rho))
    assert Query(grid(p), params=p).params is p


def test_outputs_and_the_legacy_flag():
    g, p = port_case("stencil")
    e = Engine(compile_plan(g, p), policy=SEG, device="cpu")
    batch, ex = grid(p), extras(g, 14)
    full = e.run(Query(batch, costs=ex))
    vals = e.run(Query(batch, costs=ex, outputs=("T",)))
    assert vals.lam is None and vals.rho is None
    np.testing.assert_array_equal(vals.T, full.T)
    for outs in (("lam",), ("rho",), ("T", "rho")):
        r = e.run(Query(batch, costs=ex, outputs=outs))
        np.testing.assert_array_equal(r.lam, full.lam)
    # compute_lam wins over the query's outputs, as in the reference
    assert e.run(Query(batch, costs=ex), compute_lam=False).lam is None
    np.testing.assert_array_equal(
        e.run(Query(batch, outputs=("T",)), compute_lam=True).lam,
        e.run(batch).lam)
    # keyword axes equal the Query
    kw = e.run(scenarios=batch, costs=ex)
    np.testing.assert_array_equal(kw.T, full.T)


def test_result_candidate_axis_helpers():
    g, p = port_case("random")
    ex = extras(g, 15)
    ex[1] = 0.0
    res = Engine(compile_plan(g, p), policy=SEG, device="cpu").run(
        Query(grid(p), costs=ex))
    assert res.K == K and res.G is None and res.B is None
    assert res.argbest() == 1 == res.argbest("final") == res.argbest("max")
    with pytest.raises(ValueError, match="reduce"):
        res.argbest("median")
    with pytest.raises(TypeError, match="variant axis"):
        res[0]


# -- counters -----------------------------------------------------------------

def _count(monkeypatch, names):
    calls = {n: 0 for n in names}

    def wrap(name):
        fn = getattr(eng, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    for n in names:
        monkeypatch.setattr(eng, n, wrap(n))
    return calls


@pytest.mark.parametrize("backend", ("segment", "dense"))
def test_one_level_loop_and_one_walk_whatever_k(backend, monkeypatch):
    """A K-lane forward makes one level-loop call and one walk, and one
    forward run, at K = 1, 3 and 8, solo and G = 2."""
    loop = ("segment_levels_f64" if backend == "segment"
            else "dense_levels_f32")
    fwd = (eng.segment_forward_multi if backend == "segment"
           else eng.dense_forward_multi)
    g, p = port_case("random")
    g4, _ = port_case("random4")
    pol = SEG if backend == "segment" else DENSE
    batch = grid(p)
    solo = Engine(compile_plan(g, p), policy=pol, device="cpu")
    packed = Engine([compile_plan(g, p), compile_plan(g4, p)], policy=pol,
                    device="cpu")
    for k in (1, 3, 8):
        for e, costs in ((solo, extras(g, k, n=k)),
                         (packed, [extras(g, k, n=k), extras(g4, k, n=k)])):
            for lam in (True, False):
                calls = _count(monkeypatch, (loop, "sparse_backtrace"))
                runs = dict(fwd.runs)
                r = e.run(Query(batch, costs=costs), compute_lam=lam)
                assert r.K == k
                assert calls == {loop: 1, "sparse_backtrace": int(lam)}
                kind = "lam" if lam else "values"
                assert fwd.runs[kind] == runs.get(kind, 0) + 1
                monkeypatch.undo()


# -- the plain versions and the wrappers, lane by lane ------------------------

def _lane_inputs(name, Kl, S, lam, seed=0):
    """A segment call of Kl lanes on one plan (the packed view), its state,
    scenarios and each lane's constants."""
    g, p = port_case(name)
    plan = compile_plan(g, p)
    a = eng.packed_view(eng.stage_segment(plan, CPU), plan.nlv_p)
    ex = extras(g, seed, n=Kl)
    lanes = eng.stage_lanes(a, torch.from_numpy(
        plan.patch_costs(ex).econst[None]))
    b = grid(p, S)
    LG = [torch.from_numpy(x)[None] for x in (b.L, b.gscale)]
    return plan, a, lanes, LG


@pytest.mark.parametrize("lam", [True, False])
def test_segment_lanes_plain_version_equals_each_lane_alone(lam):
    """The plain version over Kl lanes equals, lane by lane, a one-lane
    call with that lane's constants; the lanes' records are the
    structure's with column 0 the lane's constants at the listed edges."""
    plan, a, lanes, LG = _lane_inputs("stencil2c", 4, 5, lam)
    nlv = plan.nlevels
    t, ssum, cho, csrc = eng._segment_levels(a, *LG, lam, nlv, lanes)
    assert t.shape[0] == 4
    ids = a.in_edges[0, :, 0].long()
    for y in range(4):
        np.testing.assert_array_equal(lanes.erec[y, :, 1:], a.erec[0, :, 1:])
        np.testing.assert_array_equal(
            lanes.erec[y, :, 0], lanes.econst[y].reshape(-1)[ids])
        one = eng.Lanes(1, lanes.econst[y:y + 1], lanes.erec[y:y + 1])
        want = eng._segment_levels(a, *LG, lam, nlv, one)
        for u, v in zip((t, ssum, cho, csrc), want):
            assert (u is None and v is None) or torch.equal(u[y], v[0])


def test_lane_wrappers_refuse_uneven_lanes():
    plan, a, lanes, LG = _lane_inputs("random", 3, 4, True)
    t, ssum, cho, csrc = eng._state((3, a.valid_flat.shape[-1]), 4, True,
                                    CPU, torch.float64)
    args = list(eng.segment_inputs(a, lanes))
    segment_levels_f64(t, ssum, cho, *LG, *args, 0, plan.nlevels, csrc)
    # the lanes' constants and records lead with the lanes, as t does
    two = [x[:2] if x is lanes.econst or x is lanes.erec else x
           for x in args]
    with pytest.raises(ValueError, match="expected"):
        segment_levels_f64(t, ssum, cho, *LG, *two, 0, plan.nlevels, csrc)
    pair = [torch.cat([x, x]) if x is not lanes.econst
            and x is not lanes.erec else x for x in args]
    with pytest.raises(ValueError, match="evenly"):
        segment_levels_f64(t, ssum, cho, *(torch.cat([x, x]) for x in LG),
                           *pair, 0, plan.nlevels, csrc)
    vsel = torch.zeros((3, 4), dtype=torch.int64)
    elat = a.elat.view(1, -1, a.elat.shape[-1])
    sparse_backtrace(vsel, cho, csrc, elat, plan.nlevels)
    with pytest.raises(ValueError, match="evenly"):
        sparse_backtrace(vsel[:2], cho[:2], csrc[:2],
                         torch.cat([elat] * 3), plan.nlevels)


# -- on the card ------------------------------------------------------------

def _plain_segment(t, ssum, cho, *rest):
    *rest, lv0, lv1, csrc = rest
    segment_levels_f64_ref(t, ssum, cho, *rest[:10], lv0, lv1, csrc)


@pytest.mark.gpu
@pytest.mark.parametrize("Kl", [1, 3, 64])
def test_lane_kernels_match_plain_versions_on_card(Kl, monkeypatch):
    """``segment_levels_f64``, ``dense_levels_f32`` and the walk over Kl
    cost lanes of one plan and of two packed plans, against their plain
    versions on the same card tensors, bit for bit (t, ssum, cho, csrc,
    λ), values and λ, at S 1056, 37 and 1; one launch each a forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.maxplus import sparse_walk_ref
    cuda = torch.device("cuda")
    (g, p), (g3, p1), (g4, _) = (port_case(n) for n in
                                 ("stencil2c", "random", "random4"))
    for plans, q in (([compile_plan(g, p)], p),
                     ([compile_plan(g3, p1), compile_plan(g4, p1)], p1)):
        G = len(plans)
        mp = pack_plans(plans)
        econst = np.stack([pl.patch_costs(_plan_extras(pl, 20 + i, Kl)).repad(
            mp.nlv_p, mp.Vmax, mp.Dmax, mp.Emax).econst
            for i, pl in enumerate(plans)])
        for stage, loop, plain in (
                (eng.stage_segment, segment_levels_f64, _plain_segment),
                (eng.stage_multi, dense_levels_f32, None)):
            a = stage(mp, cuda)
            lanes = eng.stage_lanes(a, torch.from_numpy(econst).cuda())
            for S in (1056, 37, 1):
                b = grid(q, S)
                LG = [torch.from_numpy(np.stack([x] * G)).cuda()
                      for x in (b.L, b.gscale)]
                for lam in (False, True):
                    fwd = (eng.segment_forward_multi
                           if loop is segment_levels_f64
                           else eng.dense_forward_multi)
                    n0 = (loop.launches, sparse_backtrace.launches)
                    got = fwd(a, *LG, lam, lanes=lanes)
                    torch.cuda.synchronize()
                    assert (loop.launches - n0[0],
                            sparse_backtrace.launches - n0[1]) == (1, int(lam))
                    name = ("segment_levels_f64" if loop is segment_levels_f64
                            else "dense_levels_f32")
                    monkeypatch.setattr(eng, name, plain or _plain_dense)
                    monkeypatch.setattr(eng, "sparse_backtrace",
                                        sparse_walk_ref)
                    want = fwd(a, *LG, lam, lanes=lanes)
                    monkeypatch.undo()
                    for u, v in zip(got, want):
                        assert (u is None and v is None) or torch.equal(u, v), \
                            (name, G, Kl, S, lam)
            del a, lanes


def _plan_extras(plan, seed, n):
    ne = plan.epos_lvl.shape[0]
    return np.random.default_rng(seed).uniform(0.0, 5.0, (n, ne))


def _plain_dense(t, ssum, cho, w, A, esrc, lv_ptr, rows, row_ptr, in_edges,
                 elat_sum, vcost, csrc):
    from repro_torch.kernels.maxplus import dense_levels_f32_ref
    dense_levels_f32_ref(t, ssum, cho, w, A, esrc, elat_sum, vcost, csrc)
