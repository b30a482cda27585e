"""The result cache, finite-difference λ, per-call overrides and the
detached engine of the PyTorch package's ``Engine.run`` (the counterparts
of the JAX package's ``repro/sweep/cache.py`` and ``api.py``).

On the CPU (the kernels' plain versions, ``device="cpu"``):

* keys keep apart congestion on and off, two α registries, exact and fd
  λ, two fd steps, two K batches of one plan and two B batches of
  different bases; a raw-extras run and ``patch_costs()`` of the same
  extras share one;
* a hit runs no forward and returns a bit-equal copy; editing a hit or a
  miss leaves the cache unchanged; LRU eviction and the stats behave as
  the reference's (``tests/test_sweep.py:127``, ``:434``, ``:713-790``);
* fd λ equals exact λ at scenarios off the breakpoints on all three
  backends: segment and sparse within 1e-6 of ``core.dag``'s λ (float64),
  dense within 1e-5 of the reference's pallas ``Engine`` (float32
  decisions), T bit-equal to the exact run's;
* ``Query(graphs=...)`` and the module-level ``run`` give the bound
  engine's result and memoize the engine by content
  (``tests/test_sweep_api.py:81``); ``run(backend=, policy=,
  use_cache=)`` overrides one call only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import loggps as ref_loggps, synth as ref_synth

from repro_torch.core import dag, loggps, synth
from repro_torch.sweep import (DEFAULT_CACHE, Engine, ExecPolicy, Query,
                               SweepCache, canonical_bytes, compile_plan,
                               detached_engine_stats, latency_grid, run)
from repro_torch.sweep import engine as eng

#: off-grid latency deltas: no scenario lands on a breakpoint
DELTAS = (0.317, 7.713, 23.131)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: under the
    suite's parallel workers, each worker's full thread pool on a shared
    machine made this file ~20x slower (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(name, S, L):
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    if name == "cg":
        return S.cg_like(2, 2, 3, params=p1), p1
    if name == "stencil2c":
        p2 = L.pod_model(pod_size=2).params()
        return S.stencil2d(2, 2, 3, params=p2), p2
    if name == "incast":
        p = L.pod_model(pod_size=1, alpha={"dcn": 1.0}).params()
        return S.stencil2d(2, 2, 2, halo_bytes=4e5, params=p), p
    return S.stencil2d(3, 3, 4, params=p1), p1


def port_case(name):
    return build(name, synth, loggps)


def grid(p, deltas=DELTAS):
    return latency_grid(p, list(deltas))


def extras(g, seed, n=2):
    return np.where(g.ebytes[None] > 0, np.random.default_rng(seed).uniform(
        0.0, 5.0, (n, g.num_edges)), 0.0)


def _runs():
    return sum(sum(f.runs.values()) for f in (
        eng.segment_forward, eng.segment_forward_multi, eng.dense_forward,
        eng.dense_forward_multi))


def _equal(a, b):
    for f in ("T", "lam", "rho"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# -- keys ---------------------------------------------------------------------

def test_keys_keep_every_pair_apart():
    """Each pair is one engine run twice under one cache: the second run of
    each pair must miss, and its repeat must hit."""
    g, p = port_case("incast")
    p2 = loggps.pod_model(pod_size=1, alpha={"dcn": 2.0}).params()
    plan, b = compile_plan(g, p), grid(p)
    other = compile_plan(synth.stencil2d(2, 2, 2, halo_bytes=4e5,
                                         params=p, jitter=0.3, seed=4), p)
    assert other.envelope == plan.envelope
    cache = SweepCache()
    keep = np.ones((2, g.num_edges), dtype=bool)
    keep[:, np.flatnonzero(g.ebytes > 0)[:2]] = False
    pairs = {
        "congestion": ((plan, p, {}, {}),
                       (plan, p, dict(congestion="fixed_point"), {})),
        "alpha": ((plan, p, dict(congestion="fixed_point"), {}),
                  (plan, p2, dict(congestion="fixed_point"), {})),
        "lam mode": ((plan, p, {}, {}), (plan, p, dict(lam="fd"), {})),
        "fd step": ((plan, p, dict(lam="fd"), {}),
                    (plan, p, dict(lam="fd", fd_eps=2.0 ** -8), {})),
        "K batches": ((plan, p, {}, dict(costs=extras(g, 1))),
                      (plan, p, {}, dict(costs=extras(g, 2)))),
        "B bases": ((plan, p, {}, dict(structure=plan.patch_structure(
                        keep=keep))),
                    (other, p, {}, dict(structure=other.patch_structure(
                        keep=keep)))),
    }
    for what, runs in pairs.items():
        cache.clear()
        got = []
        for pl, pp, pol, axes in runs:
            e = Engine(pl, params=pp, policy=ExecPolicy(cache=cache, **pol),
                       device="cpu")
            got.append(e.run(Query(b, **axes)))
            assert not got[-1].from_cache, what
            assert e.run(Query(b, **axes)).from_cache, what
        assert len(cache) == 2, what
        assert not np.array_equal(got[0].T, got[1].T) or not \
            np.array_equal(got[0].lam, got[1].lam) or what in (
                "lam mode", "fd step"), what


def test_raw_extras_share_the_patch_costs_key():
    g, p = port_case("stencil")
    plan, b = compile_plan(g, p), grid(p)
    cache = SweepCache()
    e = Engine(plan, policy=ExecPolicy(cache=cache), device="cpu")
    ex = extras(g, 3)
    r1 = e.run(Query(b, costs=plan.patch_costs(ex)))
    r2 = e.run(Query(b, costs=ex))
    assert not r1.from_cache and r2.from_cache
    _equal(r1, r2)
    assert (cache.stats.patched_hits, cache.stats.patched_misses) == (1, 1)
    assert not e.run(Query(b, costs=extras(g, 4))).from_cache


def test_canonical_bytes_tell_shapes_and_dtypes_apart():
    a = np.arange(6.0)
    join = b"".join
    assert join(canonical_bytes(a.reshape(2, 3))) \
        != join(canonical_bytes(a.reshape(3, 2)))
    assert join(canonical_bytes(a)) != join(canonical_bytes(
        a.astype(np.float32)))
    f = np.asfortranarray(a.reshape(2, 3))
    assert join(canonical_bytes(f)) == join(canonical_bytes(a.reshape(2, 3)))


# -- hits ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["segment", "dense", "sparse"])
def test_a_hit_runs_nothing_and_returns_a_copy(backend):
    g, p = port_case("stencil")
    cache = SweepCache(capacity=8)
    e = Engine(g, params=p, policy=ExecPolicy(backend, cache=cache),
               device="cpu")
    b = grid(p)
    r1 = e.run(b)
    n, calls = _runs(), e.calls
    r2 = e.run(b)
    assert r2.from_cache and not r1.from_cache
    assert _runs() == n and e.calls == calls
    _equal(r1, r2)
    ref = r1.T.copy()
    r1.T[:] = -2.0
    r2.T[:] = -1.0
    r2.lam[:] = -1.0
    r3 = e.run(b)
    np.testing.assert_array_equal(r3.T, ref)
    assert (r3.lam >= 0).all()
    # a structurally identical graph built apart hits the same entry
    e2 = Engine(build("stencil", synth, loggps)[0], params=p,
                policy=ExecPolicy(backend, cache=cache), device="cpu")
    assert e2.run(b).from_cache
    assert not e.run(grid(p, (0.0, 7.0))).from_cache


def test_eviction_and_stats():
    cache = SweepCache(capacity=2)
    g, p = port_case("stencil")
    e = Engine(g, params=p, policy=ExecPolicy(cache=cache), device="cpu")
    grids = [grid(p, (float(k),)) for k in range(3)]
    for b in grids:
        e.run(b)
    assert len(cache) == 2
    st = cache.stats
    assert (st.hits, st.misses, st.evictions) == (0, 3, 1)
    # grid 0 was evicted (LRU): re-running it misses and evicts grid 1
    assert not e.run(grids[0]).from_cache
    assert cache.stats.misses == 4 and cache.stats.evictions == 2
    assert e.run(grids[2]).from_cache and e.run(grids[0]).from_cache
    assert cache.stats.hits == 2
    assert cache.stats.hit_rate == pytest.approx(2 / 6)
    assert cache.stats.snapshot()["evictions"] == 2
    cache.clear()
    assert len(cache) == 0 and cache.stats.misses == 0


def test_patched_stats_and_eviction():
    """The reference's ``test_cache_patched_cost_stats_and_eviction``:
    patched lookups count in their own subset, cost blocks are distinct
    entries under LRU eviction, and edits never poison a later hit."""
    g, p = port_case("stencil")
    base = compile_plan(g, p)
    cache = SweepCache(capacity=2)
    e = Engine(base, params=p, policy=ExecPolicy(cache=cache), device="cpu")
    b = grid(p, (0.0, 5.0))
    exs = [extras(g, 10 + i, n=1)[0] for i in range(3)]
    r1 = e.run(b, costs=base.patch_costs(exs[0]))
    assert not r1.from_cache
    r2 = e.run(b, costs=base.patch_costs(exs[0]))
    assert r2.from_cache
    np.testing.assert_array_equal(r1.T, r2.T)
    assert (cache.stats.patched_hits, cache.stats.patched_misses) == (1, 1)
    assert e.run(b, costs=exs[0]).from_cache         # raw extras, same key
    assert cache.stats.patched_hits == 2
    assert not e.run(b, costs=base.patch_costs(exs[1])).from_cache
    assert not e.run(b, costs=base.patch_costs(exs[2])).from_cache
    assert cache.stats.evictions == 1
    assert not e.run(b, costs=base.patch_costs(exs[0])).from_cache
    assert cache.stats.patched_misses == 4
    e.run(b)
    e.run(b)
    assert (cache.stats.patched_misses, cache.stats.patched_hits) == (4, 2)
    assert (cache.stats.hits, cache.stats.misses) == (3, 5)
    ra = e.run(b, costs=base.patch_costs(exs[0]), use_cache=False)
    rb = e.run(b, costs=base.patch_costs(exs[0]))
    ref = rb.T.copy()
    rb.T[:] = -1.0
    np.testing.assert_array_equal(
        e.run(b, costs=base.patch_costs(exs[0])).T, ref)
    np.testing.assert_array_equal(ra.T, ref)


def test_cache_counts_hold_under_threads():
    """More threads than cores hammer one small cache with a shortened
    switch interval: every lookup is counted once and the LRU never holds
    more than its capacity (a lost read-modify-write would break both)."""
    import os
    import sys
    import threading
    cache = SweepCache(capacity=4)
    n_threads = 2 * len(os.sched_getaffinity(0)) + 1
    per = 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per):
                key = f"k{(t * 7 + i) % 11}"
                if cache.get(key) is None:
                    cache.put(key, i)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    st = cache.stats
    # each lookup counted once; each miss puts one entry at most, and an
    # eviction removes one that a put inserted
    assert st.hits + st.misses == n_threads * per
    assert len(cache) <= 4
    assert len(cache) + st.evictions <= st.misses


def test_congestion_hit_keeps_the_iteration_counts():
    g, p = port_case("incast")
    cache = SweepCache()
    pol = ExecPolicy(congestion="fixed_point", cache=cache)
    b = grid(p)
    r1 = Engine(g, params=p, policy=pol, device="cpu").run(b)
    r2 = Engine(g, params=p, policy=pol, device="cpu").run(b)
    assert r2.from_cache and (r1.congestion_iters >= 2).all()
    np.testing.assert_array_equal(r1.congestion_iters, r2.congestion_iters)
    r2.congestion_iters[:] = 0
    np.testing.assert_array_equal(
        Engine(g, params=p, policy=pol, device="cpu").run(
            b).congestion_iters, r1.congestion_iters)


# -- finite-difference λ ------------------------------------------------------

@pytest.mark.parametrize("name", ["stencil", "cg", "stencil2c"])
@pytest.mark.parametrize("backend", ["segment", "sparse"])
def test_fd_lambda_float64_equals_core_dag(name, backend):
    g, p = port_case(name)
    b = grid(p)
    exact = Engine(g, params=p, policy=ExecPolicy(backend),
                   device="cpu").run(b)
    fd = Engine(g, params=p, policy=ExecPolicy(backend, lam="fd"),
                device="cpu").run(b)
    assert fd.lam_mode == "fd" and exact.lam_mode == "exact"
    np.testing.assert_array_equal(fd.T, exact.T)
    lp = dag.LevelPlan(g)
    want = np.stack([lp.forward(p.replace(L=tuple(b.L[i]))).lam
                     for i in range(b.S)])
    np.testing.assert_allclose(fd.lam, want, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(fd.rho, exact.rho, rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("name", ["stencil", "cg", "stencil2c"])
def test_fd_lambda_dense_equals_reference_pallas(name):
    pytest.importorskip("jax")
    from repro import sweep as ref_sweep
    g, p = port_case(name)
    g_ref, p_ref = build(name, ref_synth, ref_loggps)
    b = grid(p)
    fd = Engine(g, params=p, policy=ExecPolicy("dense", lam="fd"),
                device="cpu").run(b)
    exact = Engine(g, params=p, policy=ExecPolicy("dense"),
                   device="cpu").run(b)
    np.testing.assert_array_equal(fd.T, exact.T)
    ref = ref_sweep.Engine(g_ref, params=p_ref, policy=ref_sweep.ExecPolicy(
        backend="pallas", cache=None)).run(ref_sweep.latency_grid(
            p_ref, list(DELTAS)))
    np.testing.assert_allclose(fd.T, ref.T, rtol=1e-5)
    np.testing.assert_allclose(fd.lam, ref.lam, rtol=1e-5, atol=1e-5)


def test_fd_lambda_composes_with_the_candidate_axis():
    g, p = port_case("stencil")
    plan, b = compile_plan(g, p), grid(p, DELTAS[:2])
    ex = extras(g, 5, n=3)
    exact = Engine(plan, device="cpu").run(Query(b, costs=ex))
    fd = Engine(plan, policy=ExecPolicy(lam="fd"), device="cpu").run(
        Query(b, costs=ex))
    assert fd.axes == ("K", "S")
    np.testing.assert_array_equal(fd.T, exact.T)
    np.testing.assert_allclose(fd.lam, exact.lam, rtol=0.0, atol=1e-6)


def test_policy_validates_the_new_fields():
    for bad, match in ((dict(lam="secant"), "lam mode"),
                       (dict(fd_eps=0.0), "fd_eps"),
                       (dict(cache="yes"), "SweepCache")):
        with pytest.raises(ValueError, match=match):
            ExecPolicy(**bad).validate()
    pol = ExecPolicy().replace(lam="fd", backend="dense")
    assert (pol.backend, pol.lam) == ("dense", "fd")
    assert pol.key() != ExecPolicy().key()
    assert ExecPolicy(cache=SweepCache()).key() \
        != ExecPolicy(cache=SweepCache()).key()
    assert ExecPolicy().cache is None and DEFAULT_CACHE is not None


# -- the detached engine and per-call overrides -------------------------------

def test_detached_query_and_module_run():
    g, p = port_case("stencil")
    b = grid(p, (0.0, 5.0, 10.0))
    res = run(Query(b, graphs=g, params=p), device="cpu")
    want = Engine(g, params=p, device="cpu").run(b)
    _equal(res, want)
    with pytest.raises(ValueError, match="graphs"):
        run(Query(b))
    # a rebuilt graph with equal contents lands on the memoized engine
    before = detached_engine_stats()
    again = run(Query(b, graphs=build("stencil", synth, loggps)[0],
                      params=p), device="cpu")
    after = detached_engine_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    _equal(again, want)
    # through an engine: its params and policy, the query's graphs
    g2, _ = port_case("cg")
    e = Engine(g, params=p, policy=ExecPolicy("dense"), device="cpu")
    via = e.run(Query(b, graphs=g2))
    _equal(via, Engine(g2, params=p, policy=ExecPolicy("dense"),
                       device="cpu").run(b))
    assert via.backend == "dense"


def test_overrides_last_one_call():
    g, p = port_case("stencil")
    cache = SweepCache()
    e = Engine(g, params=p, policy=ExecPolicy(cache=cache), device="cpu")
    b = grid(p)
    seg = e.run(b)
    dense = e.run(b, backend="dense", use_cache=False)
    assert dense.backend == "dense" and not dense.from_cache
    sparse = e.run(b, policy=ExecPolicy("sparse"))
    assert sparse.backend == "sparse" and not sparse.from_cache
    _equal(sparse, seg)                       # float64 sparse ≡ segment
    np.testing.assert_allclose(dense.T, seg.T, rtol=1e-5)
    assert len(cache) == 1                    # neither override was stored
    again = e.run(b)
    assert again.backend == "segment" and again.from_cache
    assert e.policy.backend == "segment" and e.policy.cache is cache
    assert not e.run(b, use_cache=False).from_cache
    # shard resolves to one device on the CPU (no split), and a split over
    # a device listed twice gives the unsplit run's bits; neither changes
    # the cache key
    _equal(e.run(b, shard=2, use_cache=False), seg)
    split = e.run(b, shard_devices=["cpu", "cpu"])
    assert split.from_cache
    _equal(split, seg)
    _equal(e.run(b, shard_devices=["cpu", "cpu"], use_cache=False), seg)
    with pytest.raises(ValueError, match="unknown backend"):
        e.run(b, backend="pallas")


def test_sparse_override_relays_the_plan_with_its_links():
    g, p = port_case("incast")
    plan = compile_plan(g, p)
    e = Engine(plan, device="cpu")
    r = e.run(grid(p), backend="sparse")
    _equal(r, e.run(grid(p)))
    assert e.sparse is not None and e.sparse.nlinks == plan.nlinks
    np.testing.assert_array_equal(
        e.sparse.elink[:e.sparse.ne],
        plan.elinkp[plan.epos_lvl, plan.epos_e][
            np.argsort(plan.epos_lvl.astype(np.int64) * plan.Vmax
                       + plan.epos_dst, kind="stable")])
    assert dataclasses.replace(e.policy).backend == "segment"
    assert torch.is_tensor(e.arrays.esrc)
