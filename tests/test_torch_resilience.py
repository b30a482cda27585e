"""The fault families, ``fault_axes`` and ``resilience_curve`` on the port
(``repro_torch.sweep.scenarios``, ``repro_torch.core.sensitivity``)
against the JAX package's.

On the CPU (``device="cpu"``), on a 4 × 4 × 2 stencil under
``pod_model(pod_size=4)`` (P 16, two classes), faults from numpy seeds:

* the fault specs' validation and ``recovery_cost_us`` as the reference's;
* ``fault_axes`` equal to the reference's field by field (scenarios,
  extras, the structure batch's edge view, cells, names, warnings);
* straggler and link faults within 1e-12 of the reference's
  ``engine="scalar"`` (its host loop forms γ·G as an extra edge cost, the
  engine as γ on each edge's gap share), and bit-equal to the port's
  ``core.dag`` on the faulted graph (the extras and γ − 1 gap shares in
  the edge constants, the scenario's L);
* device faults bit-equal to ``core.dag`` on the graph with the rank's
  message edges dropped (plus the recovery extras), and within 1e-5 of
  the reference's ``ExecPolicy("pallas")``; dense within 1e-5 too;
* the whole distribution is one query: one level-loop launch, no walk;
* the validation errors, and an engine error reaching the caller.

On the card (``-m gpu``): one resilience query bit-equal to the CPU's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import loggps as ref_loggps
from repro.core import sensitivity as ref_sens
from repro.core import synth as ref_synth

from repro_torch.core import dag, loggps, sensitivity, synth
from repro_torch.core.graph import CALC, _topo_levels, edge_gap_shares
from repro_torch.sweep import (DeviceFault, ExecPolicy, LinkFault,
                               StragglerFault, api, fault_axes,
                               recovery_cost_us)
from repro_torch.sweep import engine as eng
from repro_torch.sweep.compile import STRUCT_FIELDS


def build(S, L):
    p = L.pod_model(pod_size=4).params()
    return S.stencil2d(4, 4, 2, params=p), p


@pytest.fixture(scope="module")
def gp():
    return build(synth, loggps)


@pytest.fixture(scope="module")
def ref_gp():
    return build(ref_synth, ref_loggps)


def calc_vertices(g, n, seed):
    """n compute vertices with in-edges and a cost, from a numpy seed."""
    indeg = np.bincount(g.edst, minlength=g.num_vertices)
    picks = np.nonzero((g.kind == CALC) & (indeg > 0) & (g.vcost > 0))[0]
    return np.random.default_rng(seed).choice(picks, n, replace=False)


def faults(g, kind, seed=3):
    """A handful of faults of one family (or "mixed"), from a seed."""
    rng = np.random.default_rng(seed)
    vs = calc_vertices(g, 4, seed)
    out = []
    if kind in ("straggler", "mixed"):
        out += [StragglerFault([int(v)], float(rng.uniform(1.5, 3.0)))
                for v in vs[:3]]
        out.append(StragglerFault([int(v) for v in vs[2:]], 2.0))
    if kind in ("link", "mixed"):
        out += [LinkFault(c, extra_L_us=float(rng.uniform(1.0, 20.0)),
                          gscale=float(rng.uniform(1.0, 2.0)),
                          duty=float(rng.uniform(0.25, 1.0)))
                for c in ("ici", "dcn", 0)]
    if kind in ("device", "mixed"):
        out += [DeviceFault(rank=1), DeviceFault(rank=6, recovery_us=250.0),
                DeviceFault(rank=11, recovery_us=250.0),
                DeviceFault(rank=14, recovery_us=40.0)]
    return out


def faulted_graph(g, p, ax, cell):
    """The graph and params of one fault cell, rebuilt for ``core.dag``:
    the cell's extras (and γ − 1 times the edges' gap shares) in the edge
    constants, the rank's message edges dropped, the scenario's L."""
    b, k, s = cell
    econst = g.econst.copy()
    if ax.extras is not None and k:
        econst = econst + ax.extras[k]
    gs = ax.scenarios.gscale[s]
    if (gs != 1.0).any():
        egap, egclass = edge_gap_shares(g, p)
        econst = egap * (gs[egclass] - 1.0) + econst
    keep = (np.ones(g.num_edges, bool) if b == 0
            else ax.structure.emask[b][ax.structure.base.epos_lvl,
                                       ax.structure.base.epos_e])
    esrc, edst = g.esrc[keep], g.edst[keep]
    nv = g.num_vertices
    level = _topo_levels(nv, esrc, edst)
    in_ptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(edst, minlength=nv), out=in_ptr[1:])

    def cut(a):
        return None if a is None else a[keep]

    gf = dataclasses.replace(
        g, esrc=esrc, edst=edst, econst=econst[keep], ebytes=g.ebytes[keep],
        elat=g.elat[keep], egap=cut(g.egap), egclass=cut(g.egclass),
        elink=cut(g.elink), in_ptr=in_ptr,
        in_edge=np.argsort(edst, kind="stable").astype(np.int32),
        level=level, nlevels=int(level.max(initial=0)) + 1)
    return gf, p.replace(L=tuple(ax.scenarios.L[s]))


# -- the specs and the lowering ------------------------------------------------

def test_fault_spec_validation_and_recovery_cost(gp):
    g, p = gp
    with pytest.raises(ValueError, match="≥ 1"):
        StragglerFault([1], 0.5)
    for duty in (0.0, 1.5):
        with pytest.raises(ValueError, match="duty"):
            LinkFault("dcn", duty=duty)
    with pytest.raises(ValueError, match="gscale"):
        LinkFault("dcn", gscale=0.5)
    with pytest.raises(ValueError, match="recovery_us"):
        DeviceFault(rank=0, recovery_us=-1.0)
    with pytest.raises(TypeError, match="faults must be"):
        fault_axes(g, p, ["not a fault"])
    with pytest.raises(ValueError, match="out of range"):
        fault_axes(g, p, [StragglerFault([g.num_vertices], 2.0)])
    assert recovery_cost_us(100.0, restore_us=30.0, lost_steps=4) == 430.0
    assert recovery_cost_us(100.0, ckpt_every=5) == 200.0
    for kw, msg in (({}, "lost_steps or"), ({"ckpt_every": 0}, "ckpt_every"),
                    ({"lost_steps": -1}, "lost_steps")):
        with pytest.raises(ValueError, match=msg):
            recovery_cost_us(100.0, **kw)


@pytest.mark.parametrize("kind", ["straggler", "link", "device", "mixed"])
def test_fault_axes_equal_reference(gp, ref_gp, kind):
    from repro import sweep as ref_sweep_pkg
    from repro.sweep import scenarios as ref_scen
    g, p = gp
    rg, rp = ref_gp
    fs = faults(g, kind)
    conv = {StragglerFault: ref_scen.StragglerFault,
            LinkFault: ref_scen.LinkFault, DeviceFault: ref_scen.DeviceFault}
    rfs = [conv[type(f)](**dataclasses.asdict(f)) for f in fs]
    ax = fault_axes(g, p, fs)
    rax = ref_sweep_pkg.fault_axes(rg, rp, rfs)
    assert ax.cells == rax.cells and ax.names == rax.names
    for f in ("L", "gscale"):
        np.testing.assert_array_equal(getattr(ax.scenarios, f),
                                      getattr(rax.scenarios, f))
    assert ax.scenarios.meta == rax.scenarios.meta
    if rax.extras is None:
        assert ax.extras is None
    else:
        np.testing.assert_array_equal(ax.extras, rax.extras)
    if rax.structure is None:
        assert ax.structure is None
    else:
        sb, rsb = ax.structure, rax.structure
        assert sb.names == rsb.names and sb.B == rsb.B
        for f in STRUCT_FIELDS:
            np.testing.assert_array_equal(getattr(sb, f), getattr(rsb, f),
                                          err_msg=f)


def test_fault_axes_warns_on_inexpressible_faults(gp):
    g, p = gp
    indeg = np.bincount(g.edst, minlength=g.num_vertices)
    src = int(np.nonzero(indeg == 0)[0][0])
    with pytest.warns(UserWarning, match="no in-edges"):
        ax = fault_axes(g, p, [StragglerFault([src], 3.0)])
    np.testing.assert_array_equal(ax.extras[1], 0.0)
    with pytest.warns(UserWarning, match="no message edges"):
        fault_axes(g, p, [DeviceFault(rank=g.nranks + 5)])


# -- resilience_curve ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["straggler", "link"])
def test_host_families_against_reference_scalar_and_core_dag(gp, ref_gp,
                                                             kind):
    from repro.sweep import scenarios as ref_scen
    g, p = gp
    rg, rp = ref_gp
    fs = faults(g, kind)
    conv = {StragglerFault: ref_scen.StragglerFault,
            LinkFault: ref_scen.LinkFault}
    rfs = [conv[type(f)](**dataclasses.asdict(f)) for f in fs]
    rep = sensitivity.resilience_curve(g, p, fs, device="cpu")
    ref = ref_sens.resilience_curve(rg, rp, rfs, engine="scalar")
    assert rep.names == ref.names and rep.cells == ref.cells
    assert rep.T0 == ref.T0
    np.testing.assert_allclose(rep.T_fault, ref.T_fault, rtol=1e-12, atol=0)
    # the port's host loop is the reference's, bit for bit
    host = sensitivity.resilience_curve(g, p, fs, engine="scalar")
    assert host.result is None and host.T0 == ref.T0
    np.testing.assert_array_equal(host.T_fault, ref.T_fault)
    # the engine bit-equal to core.dag on each faulted graph
    ax = fault_axes(g, p, fs)
    for c, T in zip(ax.cells, rep.T_fault):
        gf, pf = faulted_graph(g, p, ax, c)
        assert T == dag.evaluate(gf, pf).T, c
    assert rep.result.axes == (("K", "S") if kind == "straggler" else ("S",))


def test_device_faults_against_core_dag_and_reference_pallas(gp, ref_gp):
    pytest.importorskip("jax")
    from repro import sweep as ref_sweep_pkg
    from repro.sweep import scenarios as ref_scen
    g, p = gp
    rg, rp = ref_gp
    fs = faults(g, "mixed")
    conv = {StragglerFault: ref_scen.StragglerFault,
            LinkFault: ref_scen.LinkFault, DeviceFault: ref_scen.DeviceFault}
    rfs = [conv[type(f)](**dataclasses.asdict(f)) for f in fs]
    rep = sensitivity.resilience_curve(g, p, fs, device="cpu")
    assert rep.result.axes == ("B", "K", "S")
    ax = fault_axes(g, p, fs)
    assert rep.T0 == dag.evaluate(g, p).T
    for c, T in zip(ax.cells, rep.T_fault):
        gf, pf = faulted_graph(g, p, ax, c)
        assert T == dag.evaluate(gf, pf).T, c
    ref = ref_sens.resilience_curve(
        rg, rp, rfs, policy=ref_sweep_pkg.ExecPolicy(backend="pallas"))
    np.testing.assert_allclose(rep.T_fault, ref.T_fault, rtol=1e-5)
    dense = sensitivity.resilience_curve(g, p, fs, device="cpu",
                                         policy=ExecPolicy("dense"))
    np.testing.assert_allclose(dense.T_fault, ref.T_fault, rtol=1e-5)
    np.testing.assert_allclose(dense.T_fault, rep.T_fault, rtol=1e-5)


def test_recovery_is_additive_and_outage_no_slower(gp):
    g, p = gp
    rec = 1234.5
    rep = sensitivity.resilience_curve(
        g, p, [DeviceFault(rank=5), DeviceFault(rank=5, recovery_us=rec)],
        device="cpu")
    assert rep.T_fault[0] <= rep.T0
    assert rep.T_fault[1] == pytest.approx(rep.T_fault[0] + rec)
    with pytest.raises(ValueError, match="batched sweep engine"):
        sensitivity.resilience_curve(g, p, [DeviceFault(rank=5)],
                                     engine="scalar")


def test_weighted_expectation_and_quantiles(gp):
    g, p = gp
    v = int(calc_vertices(g, 1, 7)[0])
    fs = [StragglerFault([v], 1.5), StragglerFault([v], 2.0),
          StragglerFault([v], 4.0)]
    w = np.array([0.2, 0.1, 0.05])
    rep = sensitivity.resilience_curve(g, p, fs, weights=w, device="cpu")
    expect = 0.65 * 1.0 + float((w * rep.slowdown).sum())
    assert rep.expected_slowdown == pytest.approx(expect, rel=1e-12)
    assert rep.quantiles["p50"] == 1.0
    assert rep.quantiles["p99"] == pytest.approx(float(rep.slowdown.max()))
    assert rep.rank()[0][0] == rep.names[int(np.argmax(rep.slowdown))]
    assert "E[slowdown]" in str(rep)
    vals = np.array([1.0, 3.0, 2.0])
    ws = np.array([0.5, 0.2, 0.3])
    assert sensitivity._weighted_quantiles(vals, ws, (0.5, 0.9)) == \
        ref_sens._weighted_quantiles(vals, ws, (0.5, 0.9))


def test_one_query_one_level_loop_no_walk(gp, monkeypatch):
    g, p = gp
    calls = {"segment_levels_f64": 0, "sparse_backtrace": 0}
    for name in calls:
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(eng, name, counted)
    runs = []
    run = api.Engine.run
    monkeypatch.setattr(api.Engine, "run",
                        lambda self, *a, **kw: runs.append(1) or
                        run(self, *a, **kw))
    sensitivity.resilience_curve(g, p, faults(g, "mixed"), device="cpu")
    assert len(runs) == 1
    assert calls == {"segment_levels_f64": 1, "sparse_backtrace": 0}


def test_argument_validation(gp):
    g, p = gp
    v = int(calc_vertices(g, 1, 7)[0])
    f = [StragglerFault([v], 2.0)]
    with pytest.raises(ValueError, match="at least one fault"):
        sensitivity.resilience_curve(g, p, [], device="cpu")
    with pytest.raises(ValueError, match="weights"):
        sensitivity.resilience_curve(g, p, f, weights=[0.5, 0.5],
                                     device="cpu")
    with pytest.raises(ValueError, match="nonnegative"):
        sensitivity.resilience_curve(g, p, f, weights=[-0.1], device="cpu")
    with pytest.raises(ValueError, match="sum to"):
        sensitivity.resilience_curve(g, p, f, weights=[1.5], device="cpu")
    with pytest.raises(ValueError, match="engine must be"):
        sensitivity.resilience_curve(g, p, f, engine="fastest")


def test_engine_error_reaches_the_caller(gp, monkeypatch):
    g, p = gp

    def boom(self, *a, **kw):
        raise RuntimeError("engine failed")
    monkeypatch.setattr(api.Engine, "run", boom)
    for kind in ("straggler", "mixed"):
        for engine in ("auto", "sweep"):
            with pytest.raises(RuntimeError, match="engine failed"):
                sensitivity.resilience_curve(g, p, faults(g, kind),
                                             engine=engine, device="cpu")
    sensitivity.resilience_curve(g, p, faults(g, "link"), engine="scalar")


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_resilience_query_on_card_equals_cpu(gp, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g, p = gp
    fs = faults(g, "mixed")
    out = [sensitivity.resilience_curve(g, p, fs, device=dev,
                                        policy=ExecPolicy(backend))
           for dev in (None, "cpu")]
    assert out[0].T0 == out[1].T0
    np.testing.assert_array_equal(out[0].T_fault, out[1].T_fault)
    np.testing.assert_array_equal(out[0].result.T, out[1].result.T)
