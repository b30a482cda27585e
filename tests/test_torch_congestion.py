"""The congestion fixed point on the segment level loop (``ExecPolicy(
congestion="fixed_point")``) and the physical links it reads.

On the CPU (the kernels' plain versions, ``device="cpu"``):

* the plans carry links edge for edge: ``compile_plan``'s ``elinkp``,
  ``nlinks`` and ``link_classes`` equal the reference's, ``SparsePlan.
  from_plan`` equals ``compile_sparse`` (and the reference's) edge for
  edge, repadding and packing keep the dummy bin, ``carry`` takes them;
* α ≡ 0 gives T, λ and ρ bit-equal to the plain segment forward, solo and
  under K, in one iteration;
* the fixed point equals the reference's ``_congestion_core_axes`` (its
  ``_get_forward("congestion", ...)`` on its ``_stage_arrays(plan,
  "congestion")``, under ``jax.enable_x64(True)``: the reference's
  ``Engine`` fails on this JAX's ``jax.experimental.enable_x64`` import on
  that route) within 1e-12 relative in T and 1e-9 in λ, with equal
  iteration counts, on the six-message incast and on two-class
  ``pod_model`` stencils, with and without the candidate axis K (XLA's
  CPU backend contracts the reference's ``1 + a·max(u − b, 0)`` into a
  fused multiply-add, which the port does not, so a scale can differ in
  its last bit); the offered load equals the reference's ``segment_sum``
  bit for bit;
* inflation grows with α, the refusals carry the reference's messages,
  the congested T lies closer to the DES ``contention`` injector than the
  plain T, and fd λ under congestion is a total derivative (≤ exact λ);
* the forward's launch structure: one level loop an iteration and one
  more, one walk, one host sync an iteration.

On the card (``-m gpu``): ``segment_levels_f64`` with a random link-scale
table against its plain version, bit for bit (t, ssum, cho, csrc) at S
1056, 37 and 1, solo and over K lanes; the fixed point on the card equal
to the CPU's.  JAX is imported inside fixtures only: the card's host has
none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import loggps as ref_loggps, synth as ref_synth
from repro.core.graph import GraphBuilder as RefBuilder
from repro.sweep import compile as ref_compile, engine as ref_engine

from repro_torch.carry import plan_from_arrays
from repro_torch.core import loggps, simulator, synth
from repro_torch.core.graph import GraphBuilder
from repro_torch.kernels.maxplus import (segment_levels_f64,
                                         segment_levels_f64_ref)
from repro_torch.sweep import (Engine, ExecPolicy, Query, SparsePlan,
                               compile_plan, compile_sparse, latency_grid,
                               pack_plans, repad_plan)
from repro_torch.sweep import engine as eng
from repro_torch.sweep.scenarios import base_batch

CPU = torch.device("cpu")
CASES = ("incast", "stencil", "stencil_hot")
ITERS = ((16, 1e-6), (32, 1e-9))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: under the
    suite's parallel workers, each worker's full thread pool on a shared
    machine made this file ~20x slower (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(name, S, L, B, alpha=None):
    """(graph, params) of one case with a package's ``synth``/``loggps``
    and ``GraphBuilder``; ``alpha`` overrides the case's α registry."""
    if name == "incast":
        p = L.pod_model(pod_size=1, alpha=alpha if alpha is not None
                        else {"dcn": 1.0}).params()
        b = B(nclass=p.nclass, nranks=2)
        for _ in range(6):
            b.add_message(0, 1, nbytes=1e6, params=p)
        return b.finalize(), p
    hot = name == "stencil_hot"
    p = L.pod_model(pod_size=4, ranks_per_host=2,
                    alpha=alpha if alpha is not None
                    else {"ici": 2.0, "dcn": 2.0} if hot
                    else {"ici": 1.0, "dcn": 2.0},
                    beta={"ici": 0.05} if hot else None).params()
    return S.stencil2d(4, 4, 3, halo_bytes=4e5 if hot else 64e3,
                       comp_us=20.0 if hot else 50.0, params=p), p


def port_case(name, alpha=None):
    return build(name, synth, loggps, GraphBuilder, alpha)


def ref_case(name, alpha=None):
    return build(name, ref_synth, ref_loggps, RefBuilder, alpha)


def grid(p, S=9, top=40.0):
    return latency_grid(p, np.linspace(0.0, top, S))


def extras(g, seed, n=3):
    """[n, ne] extra edge costs on the message edges, from a numpy seed."""
    msg = g.ebytes > 0
    return np.random.default_rng(seed).uniform(0.0, 10.0,
                                               (n, g.num_edges)) * msg


def cong(max_iters=16, tol=1e-6, **kw):
    return ExecPolicy(congestion="fixed_point", max_iters=max_iters, tol=tol,
                      **kw)


def staged(plan, device=CPU):
    """A plan's segment arrays with its links, as a congestion run stages
    them."""
    a = eng.stage_segment(plan, device)
    a.links = eng.stage_links(plan, a)
    return a


def _near_reference(res, T, lam, it):
    """T within 1e-12 relative, λ within 1e-9, the same iteration counts."""
    np.testing.assert_allclose(res.T, T, rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(res.lam, lam, rtol=0.0, atol=1e-9)
    np.testing.assert_array_equal(res.congestion_iters, it)


def _same(got, want, msg=""):
    for f in ("T", "lam", "rho"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{f} {msg}")


@pytest.fixture(scope="module")
def ref_fixed_point():
    """``run(plan, params, L, GS, max_iters, tol, vconst=None)`` → (T, λ,
    iterations) of the reference's congestion core (with the candidate
    axis over ``vconst`` [K, ...] when given), under 64-bit JAX."""
    jax = pytest.importorskip("jax")
    fwds = {}

    def run(plan, p, L, GS, max_iters, tol, vconst=None):
        costs = None if vconst is None else (0, None, None, None, None)
        if costs not in fwds:
            fwds[costs] = jax.jit(ref_engine._congestion_core_axes(True,
                                                                   costs))
        with jax.enable_x64(True):
            arrs = list(ref_engine._stage_arrays(plan, "congestion", 1 << 40))
            if vconst is not None:
                arrs[2] = jax.numpy.asarray(vconst)
            out = fwds[costs](*arrs, np.asarray(p.alpha_full),
                              np.asarray(p.beta_full), np.int32(max_iters),
                              np.float64(tol), L, GS)
            T, lam, it = (np.asarray(x) for x in out)
        assert T.dtype == lam.dtype == np.float64
        return T, lam, it

    return run


# -- the links the plans carry -----------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_plans_carry_links_edge_for_edge(name):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    plan, ref = compile_plan(g, p), ref_compile.compile_plan(g_ref, p_ref)
    assert plan.nlinks == ref.nlinks == g.nlinks > 0
    np.testing.assert_array_equal(plan.elinkp, ref.elinkp)
    np.testing.assert_array_equal(plan.link_classes, ref.link_classes)
    assert plan.elinkp.dtype == ref.elinkp.dtype
    # pads and dependency edges land in the dummy bin, never on a link
    assert (plan.elinkp[~plan.emask] == plan.nlinks).all()
    msg = np.zeros_like(plan.emask)
    msg[plan.epos_lvl, plan.epos_e] = g.ebytes > 0
    assert (plan.elinkp[msg] < plan.nlinks).all()
    sp, sp_ref = compile_sparse(g, p), ref_compile.compile_sparse(g_ref,
                                                                  p_ref)
    relaid = SparsePlan.from_plan(plan)
    np.testing.assert_array_equal(sp.elink, relaid.elink)
    np.testing.assert_array_equal(sp.elink, sp_ref.elink)
    np.testing.assert_array_equal(
        relaid.elink, ref_compile.SparsePlan.from_plan(ref).elink)
    assert sp.content_hash() == relaid.content_hash()
    for f in ("esrc_slot", "edst_slot", "econst", "egap", "egclass", "elat",
              "vcost", "vert_of_slot", "level_ptr", "v_ptr"):
        np.testing.assert_array_equal(getattr(sp, f), getattr(relaid, f))


def test_repad_pack_and_carry_keep_the_dummy_bin():
    g, p = port_case("stencil")
    plan = compile_plan(g, p)
    inc = compile_plan(synth.stencil2d(2, 2, 2, params=p), p)
    env = tuple(max(a, b) for a, b in zip(plan.envelope, inc.envelope))
    big = repad_plan(inc, env[0], env[1], env[2], env[3] * 2)
    assert big.nlinks == inc.nlinks
    assert (big.elinkp[~big.emask] == inc.nlinks).all()
    np.testing.assert_array_equal(
        big.elinkp[:inc.nlv_p, :inc.Emax], inc.elinkp)
    mp = pack_plans([plan, inc])
    np.testing.assert_array_equal(mp.nlinks, [plan.nlinks, inc.nlinks])
    for gi_, pl in enumerate((plan, inc)):
        assert (mp.elinkp[gi_][~mp.emask[gi_]] == pl.nlinks).all()
    # the plain key is link-blind, the link key is not
    bare = dataclasses.replace(plan, elinkp=None, nlinks=0,
                               link_classes=None)
    assert bare.content_hash() == plan.content_hash()
    assert bare.link_hash() != plan.link_hash()
    g_ref, p_ref = ref_case("stencil")
    ref = ref_compile.compile_plan(g_ref, p_ref)
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref)
              if isinstance(getattr(ref, f.name), np.ndarray)}
    carried = plan_from_arrays(fields, ref.nv, ref.nclass, ref.nlevels)
    np.testing.assert_array_equal(carried.elinkp, ref.elinkp)
    assert carried.nlinks == ref.nlinks
    assert carried.link_hash() == plan.link_hash()


# -- α ≡ 0: the plain forward, bit for bit -----------------------------------

@pytest.mark.parametrize("name", CASES)
def test_zero_alpha_is_the_plain_forward(name):
    g, p = port_case(name, alpha={})
    assert not any(p.alpha_full)
    plan, b = compile_plan(g, p), grid(p)
    plain = Engine(plan, params=p, device="cpu")
    e = Engine(plan, params=p, policy=cong(), device="cpu")
    res = e.run(b)
    _same(res, plain.run(b), name)
    assert (res.congestion_iters == 1).all()
    ex = extras(g, 5)
    rk, pk = e.run(Query(b, costs=ex)), plain.run(Query(b, costs=ex))
    _same(rk, pk, f"{name} K")
    assert rk.congestion_iters.shape == (3, b.S)
    assert (rk.congestion_iters == 1).all()
    vals = e.run(b, compute_lam=False)
    np.testing.assert_array_equal(vals.T, res.T)


# -- against the reference's fixed point --------------------------------------

@pytest.mark.parametrize("max_iters,tol", ITERS)
@pytest.mark.parametrize("name", CASES)
def test_fixed_point_equals_reference(name, max_iters, tol,
                                      ref_fixed_point):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    b = grid(p, 16)
    res = Engine(compile_plan(g, p), params=p, policy=cong(max_iters, tol),
                 device="cpu").run(b)
    T, lam, it = ref_fixed_point(ref_compile.compile_plan(g_ref, p_ref),
                                 p_ref, b.L, b.gscale, max_iters, tol)
    _near_reference(res, T, lam, it)
    assert res.congestion_iters.dtype == np.int32
    assert (res.congestion_iters >= 2).all()


@pytest.mark.parametrize("name", CASES)
def test_fixed_point_k_lanes_equal_reference(name, ref_fixed_point):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    plan, ref = compile_plan(g, p), ref_compile.compile_plan(g_ref, p_ref)
    b, ex = grid(p, 7), extras(g, 8)
    res = Engine(plan, params=p, policy=cong(32, 1e-9), device="cpu").run(
        Query(b, costs=ex))
    T, lam, it = ref_fixed_point(ref, p_ref, b.L, b.gscale, 32, 1e-9,
                                 ref.patch_costs(ex).vconst)
    assert res.axes == ("K", "S") and res.T.shape == T.shape
    _near_reference(res, T, lam, it)
    # each lane equals a solo congested run of its rebuilt plan
    for k in range(3):
        solo = Engine(plan.with_extra_cost(ex[k]), params=p,
                      policy=cong(32, 1e-9), device="cpu").run(b)
        np.testing.assert_array_equal(res.T[k], solo.T)
        np.testing.assert_array_equal(res.lam[k], solo.lam)
        np.testing.assert_array_equal(res.congestion_iters[k],
                                      solo.congestion_iters)


@pytest.mark.parametrize("name", CASES)
def test_offered_load_equals_reference_segment_sum(name):
    """``link_busy`` adds each link's edges in the reference's order (the
    ravel order of its vertex view), so the sums are the same bits."""
    jax = pytest.importorskip("jax")
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    plan, ref = compile_plan(g, p), ref_compile.compile_plan(g_ref, p_ref)
    b = grid(p, 5)
    a = staged(plan)
    busy = eng.link_busy(a.links, a.erec, a.in_edges,
                         torch.from_numpy(b.gscale)).numpy()
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jax.ops.segment_sum(
            (ref.vgap * gs[ref.vgclass]).ravel(), ref.vlink.ravel(),
            num_segments=ref.nlinks + 1)) for gs in b.gscale], 1)
    np.testing.assert_array_equal(busy[:-1], want[:-1])
    assert (busy[-1] == 0).all()


# -- behaviour ----------------------------------------------------------------

def test_inflation_grows_with_alpha():
    b = grid(port_case("incast")[1], 8)
    Ts = []
    for a in (0.0, 1.0, 2.0):
        g, p = port_case("incast", alpha={"dcn": a} if a else {})
        res = Engine(g, params=p, policy=cong(32, 1e-9),
                     device="cpu").run(b)
        assert (res.congestion_iters < 32).all()
        Ts.append(res.T)
    assert (Ts[1] > Ts[0]).all() and (Ts[2] > Ts[1]).all()


def test_closer_to_des_contention_than_the_plain_forward():
    """On the incast the DES ``contention`` injector is ground truth: the
    congested T lies strictly closer to it than the load-blind T."""
    g, p = port_case("incast")
    b = base_batch(p)
    base_T = float(Engine(g, params=p, device="cpu").run(b).T[0])
    cong_T = float(Engine(g, params=p, policy=cong(32, 1e-9),
                          device="cpu").run(b).T[0])
    sim_T = simulator.simulate(g, p, injector="contention").T
    assert sim_T > base_T
    assert base_T < cong_T <= sim_T * 1.5
    assert abs(cong_T - sim_T) < abs(base_T - sim_T)


@pytest.mark.parametrize("name", ["incast", "stencil"])
def test_fd_lambda_under_congestion_is_a_total_derivative(name):
    """fd λ is dT*/dL of the fixed point, feedback included (L up, T up,
    utilization down), so it is at most the exact λ read at the converged
    scales (reference ``test_congestion.py:244-263``); T is the same."""
    g, p = port_case(name)
    b = grid(p, 8, 30.0)
    exact = Engine(g, params=p, policy=cong(), device="cpu").run(b)
    fd = Engine(g, params=p, policy=cong(lam="fd"), device="cpu").run(b)
    assert fd.lam_mode == "fd" and fd.lam.shape == exact.lam.shape
    np.testing.assert_array_equal(fd.T, exact.T)
    np.testing.assert_array_equal(fd.congestion_iters,
                                  exact.congestion_iters)
    assert (fd.lam <= exact.lam + 1e-9).all()
    assert np.isfinite(fd.lam).all()


def test_refusals_carry_the_reference_messages():
    g, p = port_case("incast")
    with pytest.raises(ValueError, match="segment backend only"):
        ExecPolicy("dense", congestion="fixed_point").validate()
    with pytest.raises(ValueError, match="congestion mode"):
        ExecPolicy(congestion="bursty").validate()
    with pytest.raises(ValueError, match="max_iters"):
        cong(max_iters=0).validate()
    with pytest.raises(ValueError, match="tol"):
        cong(tol=0.0).validate()
    plan, b = compile_plan(g, p), grid(p, 3)
    with pytest.raises(ValueError, match="bound LogGPS params"):
        Engine(plan, policy=cong(), device="cpu").run(b)
    with pytest.raises(ValueError, match="multi-graph G"):
        Engine([(g, p), (g, p)], params=p, policy=cong(),
               device="cpu").run(b)
    with pytest.raises(ValueError, match="structure blocks"):
        Engine(plan, params=p, policy=cong(), device="cpu").run(
            Query(b, structure=plan.patch_structure(
                keep=np.ones((2, g.num_edges), dtype=bool))))
    with pytest.raises(ValueError, match="shard"):
        Engine(plan, params=p, policy=cong(), device="cpu").run(b, shard=2)
    with pytest.raises(ValueError, match="segment backend only"):
        Engine(plan, params=p, policy=cong(), device="cpu").run(
            b, backend="dense")
    bare = dataclasses.replace(plan, elinkp=None)
    with pytest.raises(ValueError, match="link ids"):
        Engine(bare, params=p, policy=cong(), device="cpu").run(b)


def test_launch_structure_and_syncs(monkeypatch):
    """One values level loop an iteration, one more for the final forward,
    one walk a λ forward, and one host sync an iteration."""
    g, p = port_case("stencil")
    e = Engine(g, params=p, policy=cong(32, 1e-9), device="cpu")
    b = grid(p, 6)
    calls = {"segment_levels_f64": 0, "sparse_backtrace": 0}

    def wrap(name):
        fn = getattr(eng, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    for n in calls:
        monkeypatch.setattr(eng, n, wrap(n))
    runs = dict(eng.congestion_forward.runs)
    res = e.run(b)
    it = int(res.congestion_iters.max())
    got = {k: v - runs.get(k, 0) for k, v in eng.congestion_forward.runs.items()}
    assert got == {"solves": 1, "iterations": it, "syncs": it}
    assert calls == {"segment_levels_f64": it + 1, "sparse_backtrace": 1}


def test_wrapper_checks_the_link_table():
    g, p = port_case("stencil")
    plan = compile_plan(g, p)
    a = staged(plan)
    b = grid(p, 4)
    LG = [torch.from_numpy(x) for x in (b.L, b.gscale)]
    t = eng._state(tuple(a.valid_flat.shape), 4, False, CPU,
                   torch.float64)[0]
    args = eng.segment_inputs(a)
    ls = torch.ones((plan.nlinks + 1, 4), dtype=torch.float64)
    lk = a.links
    segment_levels_f64(t, None, None, *LG, *args, 0, plan.nlevels, None,
                       ls=ls, elink=lk.elink, in_link=lk.in_link)
    for bad, match in (
            (dict(ls=ls.float(), elink=lk.elink, in_link=lk.in_link),
             "float64"),
            (dict(ls=ls[:, :3].contiguous(), elink=lk.elink,
                  in_link=lk.in_link), "expected"),
            (dict(ls=ls, elink=lk.elink.int(), in_link=lk.in_link),
             "int64"),
            (dict(ls=ls, elink=lk.elink, in_link=lk.in_link[:-1]),
             "expected"),
            (dict(ls=ls, elink=lk.elink), "come together")):
        with pytest.raises((TypeError, ValueError), match=match):
            segment_levels_f64(t, None, None, *LG, *args, 0, plan.nlevels,
                               None, **bad)


@pytest.mark.parametrize("lam", [True, False])
def test_plain_version_link_factor(lam):
    """A table of ones gives the factorless loop's bits; a random table
    gives each edge the weight ``_weights`` forms with γ·ls."""
    from repro_torch.kernels.maxplus.ref import _weights
    g, p = port_case("stencil")
    plan = compile_plan(g, p)
    a = staged(plan)
    b = grid(p, 5)
    LG = [torch.from_numpy(x) for x in (b.L, b.gscale)]
    nlv = plan.nlevels
    one = torch.ones((plan.nlinks + 1, 5), dtype=torch.float64)
    plain = eng._segment_levels(a, *LG, lam, nlv)
    ones = eng._segment_levels(a, *LG, lam, nlv, ls=one)
    for u, v in zip(plain, ones):
        assert (u is None and v is None) or torch.equal(u, v)
    rnd = torch.from_numpy(np.random.default_rng(3).uniform(
        1.0, 3.0, (plan.nlinks + 1, 5)))
    rnd[-1] = 1.0
    got = eng._segment_levels(a, *LG, lam, nlv, ls=rnd)
    assert not torch.equal(got[0], plain[0])
    lv = int(plan.epos_lvl[np.flatnonzero(g.ebytes > 0)[0]])
    w = _weights(a.egclass[lv], a.egap[lv], a.econst[lv], a.elat[lv], *LG,
                 rnd.index_select(0, a.links.elink[lv]))
    wp = _weights(a.egclass[lv], a.egap[lv], a.econst[lv], a.elat[lv], *LG)
    scaled = (a.links.elink[lv] < plan.nlinks) & (a.egap[lv] > 0)
    assert scaled.any()
    assert (w[scaled] > wp[scaled]).all()
    assert torch.equal(w[~scaled], wp[~scaled])


# -- on the card --------------------------------------------------------------

def _plain_segment(t, ssum, cho, *rest, **kw):
    *rest, lv0, lv1, csrc = rest
    segment_levels_f64_ref(t, ssum, cho, *rest[:10], lv0, lv1, csrc,
                           kw.get("ls"), kw.get("elink"))


@pytest.mark.gpu
def test_link_factor_kernel_matches_plain_version_on_card(monkeypatch):
    """``segment_levels_f64`` with a random link-scale table, solo and over
    K 3 lanes, against its plain version on the same card tensors, bit for
    bit (t, ssum, cho, csrc), values and λ, at S 1056, 37 and 1; one launch
    a call; then the fixed point on the card equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    g, p = port_case("stencil_hot")
    plan = compile_plan(g, p)
    solo = staged(plan, cuda)
    packed = eng.packed_view(solo, plan.nlevels)
    lanes = eng.stage_lanes(packed, torch.from_numpy(
        plan.patch_costs(extras(g, 2)).econst[None]).cuda())
    for a, ln, L in ((solo, None, 0), (packed, lanes, 3)):
        for S in (1056, 37, 1):
            b = grid(p, S)
            LG = [torch.from_numpy(x[None] if L else x).cuda()
                  for x in (b.L, b.gscale)]
            shape = ((L,) if L else ()) + (plan.nlinks + 1, S)
            ls = torch.from_numpy(np.random.default_rng(S).uniform(
                1.0, 4.0, shape)).cuda()
            ls[..., -1, :] = 1.0
            for lam in (False, True):
                n0 = segment_levels_f64.launches
                got = eng._segment_levels(a, *LG, lam, plan.nlevels, ln,
                                          ls=ls)
                torch.cuda.synchronize()
                assert segment_levels_f64.launches == n0 + 1
                monkeypatch.setattr(eng, "segment_levels_f64",
                                    _plain_segment)
                want = eng._segment_levels(a, *LG, lam, plan.nlevels, ln,
                                           ls=ls)
                monkeypatch.undo()
                for u, v in zip(got, want):
                    assert (u is None and v is None) or torch.equal(u, v), \
                        (L, S, lam)
    b = grid(p, 16)
    card = Engine(plan, params=p, policy=cong(32, 1e-9)).run(b)
    host = Engine(plan, params=p, policy=cong(32, 1e-9), device="cpu").run(b)
    _same(card, host)
    np.testing.assert_array_equal(card.congestion_iters,
                                  host.congestion_iters)
