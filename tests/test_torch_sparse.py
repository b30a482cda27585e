"""The PyTorch package's sparse slot-list backend against the JAX package's.

On the five conformance cases (``tests/test_conformance.py``) and a stencil
whose widest level is its last (its last window runs into the padding):

* ``compile_sparse`` and ``estimate_dense_bytes`` equal the reference's,
  field by field, bit for bit; ``sparse_plan_from_arrays`` carries a
  reference plan across unchanged.
* The float64 flavour is bit-equal (T, λ, ρ) to the scalar oracle
  ``core.dag.LevelPlan.forward``, as the reference's sparse backend is
  (``test_conformance.py``'s sparse rows).
* The float32 flavour (the slot-list kernel's plain version, on the CPU)
  is within the contract of the pallas rows — T and λ 1e-5 relative, ρ
  1e-4 — of the scalar oracle and of the reference's own float32 sparse
  forward, ``_get_forward("sparse_pallas", …)``, fed the identical plan.
  The reference's ``Engine`` cannot run its sparse backend on this JAX
  (its ``enable_x64`` import fails), so its forward is called directly,
  without x64, its kernel in interpret mode.

Then the seam: the dense→sparse auto-switch, the guard's resolution order,
and the sensitivity front with ``policy=``.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import dag
from repro.core import graph as ref_graph, loggps as ref_loggps
from repro.core import synth as ref_synth
from repro.sweep import compile as ref_compile, engine as ref_engine

from repro_torch.carry import SPARSE_PLAN_ARRAYS, sparse_plan_from_arrays
from repro_torch.core import graph, loggps, sensitivity, synth
from repro_torch.sweep import (Engine, ExecPolicy, compile_plan,
                               compile_sparse, estimate_dense_bytes,
                               latency_grid)
from repro_torch.sweep import engine as eng

NAMES = ("stencil", "cg", "allreduce", "stencil2c", "stencil3c", "widelast")
RTOL_T = RTOL_LAM = 1e-5
RTOL_RHO = 1e-4
DELTAS = np.linspace(0.0, 60.0, 5)
F32 = ExecPolicy(backend="sparse", dtype="float32")
F64 = ExecPolicy(backend="sparse")


def _wide_last(G, L):
    """A 4-rank ring stencil of 3 iterations, then 6 vertices per rank
    that each wait for every rank's last vertex: its last level (24
    vertices) is its widest, so that level's window reaches into the
    padding."""
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    b = G.GraphBuilder(4, p.nclass)
    for it in range(3):
        for r in range(4):
            b.add_calc(r, 100.0 + 10 * r + it)
        for r in range(4):
            b.add_message(r, (r + 1) % 4, 2e3 * (1 + r), p)
    tails = [b.tail(r) for r in range(4)]
    for r in range(4):
        for k in range(6):
            v = b.add_sync_vertex(r)
            for q in range(4):
                b.add_edge(tails[q], v, const_us=1.0 + k + q)
    return b.finalize(), p


def build(name, S, L, G):
    """One case built with a package's ``synth``/``loggps``/``graph``."""
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    p2 = L.pod_model(pod_size=2).params()
    p3 = L.pod_model(pod_size=4, ranks_per_host=2).params()
    return {
        "stencil": lambda: (S.stencil2d(3, 3, 4, params=p1), p1),
        "cg": lambda: (S.cg_like(2, 2, 3, params=p1), p1),
        "allreduce": lambda: (S.allreduce_chain(8, 3, params=p1), p1),
        "stencil2c": lambda: (S.stencil2d(2, 2, 3, params=p2), p2),
        "stencil3c": lambda: (S.stencil2d(4, 2, 3, params=p3), p3),
        "widelast": lambda: _wide_last(G, L),
    }[name]()


def ref_case(name):
    return build(name, ref_synth, ref_loggps, ref_graph)


def port_case(name):
    return build(name, synth, loggps, graph)


def carry(sp):
    """The port's SparsePlan from a reference SparsePlan's arrays."""
    return sparse_plan_from_arrays(
        {k: getattr(sp, k) for k in SPARSE_PLAN_ARRAYS}, sp.nv, sp.ne,
        sp.nclass, sp.nlevels, sp.Emax_lv, sp.Vmax_lv)


def _scalar(g, p, batch):
    plan = dag.LevelPlan(g)
    out = [plan.forward(p.replace(L=tuple(batch.L[i])))
           for i in range(batch.S)]
    return (np.array([s.T for s in out]), np.stack([s.lam for s in out]),
            np.stack([s.rho() for s in out]))


def _reference_sparse_pallas(sp, batch):
    """The reference's float32 sparse forward on its own staged arrays
    (``engine.py:1039-1043``), in float32 (x64 off), kernel in
    interpret mode."""
    import jax.numpy as jnp
    arrs = ref_engine._stage_arrays(sp, "sparse", 1 << 40)
    fwd = ref_engine._get_forward("sparse_pallas", True,
                                  sparse_dims=(sp.Emax_lv, sp.Vmax_lv))
    T, lam = fwd(*arrs, jnp.asarray(batch.L, dtype=jnp.float32),
                 jnp.asarray(batch.gscale, dtype=jnp.float32))
    T = np.asarray(T).astype(np.float64)
    lam = np.asarray(lam).astype(np.float64)
    rho = np.where(T[:, None] > 0, batch.L * lam / T[:, None], 0.0)
    return T, lam, rho


@pytest.fixture(scope="module")
def runs():
    """Per case: the scalar oracle, the reference's float32 sparse forward,
    and the port's two flavours on the carried plan and on its own."""
    out = {}
    for name in NAMES:
        g_ref, p_ref = ref_case(name)
        g, p = port_case(name)
        ref_sp = ref_compile.compile_sparse(g_ref, p_ref)
        carried = carry(ref_sp)
        ref_batch = latency_grid(p, DELTAS)
        r = {"scalar": _scalar(g_ref, p_ref, ref_batch),
             "sparse_pallas": _reference_sparse_pallas(ref_sp, ref_batch)}
        for key, policy in (("f64", F64), ("f32", F32)):
            e = Engine(carried, policy=policy, device="cpu")
            r[key] = e.run(ref_batch)
            r[key + "_values"] = e.run(ref_batch, compute_lam=False)
            r[key + "_own"] = Engine(g, params=p, policy=policy,
                                     device="cpu").run(ref_batch)
        out[name] = r
    return out


@pytest.mark.parametrize("name", NAMES)
def test_compile_sparse_equals_reference(name):
    g_ref, p_ref = ref_case(name)
    g, p = port_case(name)
    ref = ref_compile.compile_sparse(g_ref, p_ref)
    sp = compile_sparse(g, p)
    for f in SPARSE_PLAN_ARRAYS:
        a, b = getattr(sp, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("nv", "ne", "nclass", "nlevels", "Emax_lv", "Vmax_lv"):
        assert getattr(sp, f) == getattr(ref, f), f
    assert sp.sparse_bytes() == ref.sparse_bytes()
    assert estimate_dense_bytes(g) == ref_compile.estimate_dense_bytes(g_ref)
    assert estimate_dense_bytes(g) == compile_plan(g, p).dense_bytes()
    # the padding invariants the forward's plain slices rely on
    assert sp.esrc_slot.shape[0] >= sp.ne + sp.Emax_lv
    assert sp.vcost.shape[0] >= sp.nv + sp.Vmax_lv
    carried = carry(ref)
    for f in SPARSE_PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(carried, f), getattr(ref, f))


def test_widelast_is_widest_at_its_last_level():
    sp = compile_sparse(*port_case("widelast"))
    counts = np.diff(sp.v_ptr[:sp.nlevels + 1])
    assert counts.argmax() == sp.nlevels - 1 and counts[-1] == 24
    assert sp.v_ptr[sp.nlevels - 1] + sp.Vmax_lv > sp.nv   # runs into pad
    assert sp.nlevels & (sp.nlevels - 1)                    # not a power of 2


def test_bad_sparse_plans_are_refused():
    g_ref, p_ref = ref_case("stencil")
    ref = ref_compile.compile_sparse(g_ref, p_ref)
    fields = {k: getattr(ref, k) for k in SPARSE_PLAN_ARRAYS}
    args = (ref.nv, ref.ne, ref.nclass, ref.nlevels, ref.Emax_lv,
            ref.Vmax_lv)
    with pytest.raises(ValueError, match="missing"):
        sparse_plan_from_arrays({k: v for k, v in fields.items()
                                 if k != "v_ptr"}, *args)
    with pytest.raises(ValueError, match="elat"):
        sparse_plan_from_arrays(fields, ref.nv, ref.ne, ref.nclass + 1,
                                *args[3:])
    # the forward's invariants are checked where the plan is staged
    for bad, match in (
            (sparse_plan_from_arrays(fields, *args[:4],
                                     ref.esrc_slot.shape[0], ref.Vmax_lv),
             "padding"),
            (sparse_plan_from_arrays(fields, *args[:4], 1, ref.Vmax_lv),
             "runs"),
            (sparse_plan_from_arrays(dict(fields,
                                          valid=np.ones_like(ref.valid)),
                                     *args), "valid")):
        with pytest.raises(ValueError, match=match):
            Engine(bad, policy=F64, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_sparse_f64_bit_equal_to_scalar(runs, name):
    T, lam, rho = runs[name]["scalar"]
    for key in ("f64", "f64_own"):
        res = runs[name][key]
        np.testing.assert_array_equal(res.T, T)
        np.testing.assert_array_equal(res.lam, lam)
        np.testing.assert_array_equal(res.rho, rho)
        assert res.backend == "sparse" and res.device == "cpu"
    np.testing.assert_array_equal(runs[name]["f64_values"].T, T)


@pytest.mark.parametrize("oracle", ["scalar", "sparse_pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_sparse_f32_matches_scalar_and_reference(runs, name, oracle):
    T, lam, rho = runs[name][oracle]
    for key in ("f32", "f32_own"):
        res = runs[name][key]
        np.testing.assert_allclose(res.T, T, rtol=RTOL_T, atol=0)
        np.testing.assert_allclose(res.lam, lam, rtol=RTOL_LAM, atol=0)
        np.testing.assert_allclose(res.rho, rho, rtol=RTOL_RHO, atol=0)
        assert res.backend == "sparse"
    vals = runs[name]["f32_values"]
    np.testing.assert_allclose(vals.T, T, rtol=RTOL_T, atol=0)
    assert vals.lam is None and vals.rho is None


@pytest.mark.parametrize("flavour", ["f64", "f32"])
def test_padded_levels_change_nothing(flavour):
    """Walking only the plan's real levels (the port's default) gives T
    and λ identical to walking all nlv_p padded levels (the reference's
    loop), on a case whose nlevels is not a power of two."""
    g, p = port_case("widelast")
    sp = compile_sparse(g, p)
    dt = torch.float32 if flavour == "f32" else torch.float64
    fwd = eng.sparse_forward_f32 if flavour == "f32" else \
        eng.sparse_forward_f64
    a = eng.stage_sparse(sp, torch.device("cpu"), dt)
    batch = latency_grid(p, DELTAS)
    L = torch.from_numpy(batch.L)
    GS = torch.from_numpy(batch.gscale)
    assert sp.nlv_p > sp.nlevels
    for want_lam in (False, True):
        T1, l1 = fwd(a, L, GS, want_lam)
        T2, l2 = fwd(a, L, GS, want_lam, nlv=sp.nlv_p)
        assert torch.equal(T1, T2)
        if want_lam:
            assert torch.equal(l1, l2)


@pytest.mark.parametrize("flavour", ["f64", "f32"])
def test_weight_chunks_change_nothing(flavour, monkeypatch):
    """Edge weights computed a few levels at a time give the same bits as
    computed at one go."""
    g, p = port_case("stencil2c")
    policy = F32 if flavour == "f32" else F64
    batch = latency_grid(p, DELTAS)
    whole = Engine(g, params=p, policy=policy, device="cpu").run(batch)
    monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", 3 * 8 * 8)
    chunked = Engine(g, params=p, policy=policy, device="cpu").run(batch)
    np.testing.assert_array_equal(whole.T, chunked.T)
    np.testing.assert_array_equal(whole.lam, chunked.lam)


def test_stage_sparse_routes_foreign_slots_to_trash():
    """Window slots that cannot land in the level's rows (pad edges, and
    later levels' edges outside the window) go to the trash row of each
    flavour: Vmax_lv for the scatter buffers, M_pad for the kernel."""
    g, p = port_case("widelast")
    sp = compile_sparse(g, p)
    for dt, trash in ((torch.float64, sp.Vmax_lv),
                      (torch.float32, eng.kernel_pads(sp.Emax_lv,
                                                      sp.Vmax_lv)[1])):
        a = eng.stage_sparse(sp, torch.device("cpu"), dt)
        d = a.dloc.numpy()
        assert ((d >= 0) & (d < sp.Vmax_lv) | (d == trash)).all()
        last = sp.nlevels - 1
        e0, e1 = sp.level_ptr[last], sp.level_ptr[last + 1]
        own = d[last, :e1 - e0]
        np.testing.assert_array_equal(
            own, sp.edst_slot[e0:e1] - sp.v_ptr[last])
        assert (d[last, e1 - e0:] == trash).all()       # pad edges
        assert (d[sp.nlevels:] == trash).all()          # padded levels


def test_kernel_pads_follow_the_reference():
    assert eng.kernel_pads(256, 1024) == (256, 1024)
    assert eng.kernel_pads(8, 8) == (8, 8)
    assert eng.kernel_pads(300, 12) == (384, 16)


# -- the seam ----------------------------------------------------------------

def _small():
    return port_case("stencil")


def test_auto_switch_warns_and_lands_on_sparse_f64(runs):
    g, p = _small()
    limit = estimate_dense_bytes(g) - 1
    with pytest.warns(RuntimeWarning, match="auto-switching"):
        e = Engine(g, params=p, policy=ExecPolicy(max_dense_bytes=limit),
                   device="cpu")
    assert e.policy.backend == "sparse" and e.policy.dtype == "auto"
    assert e.plan is None and e.arrays.dtype == torch.float64
    res = e.run(latency_grid(p, DELTAS))
    assert res.backend == "sparse"
    np.testing.assert_array_equal(res.T, runs["stencil"]["scalar"][0])
    with pytest.raises(ValueError, match="dtype='float32'"):
        Engine(g, params=p, device="cpu",
               policy=ExecPolicy(dtype="float32", max_dense_bytes=limit))


def test_guard_resolution_order(monkeypatch):
    """The policy field, then ``REPRO_MAX_DENSE_BYTES``, then the class
    attribute; at the limit itself the graph stays dense."""
    g, p = _small()
    est = estimate_dense_bytes(g)

    def backend(policy=None, cls=Engine):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return cls(g, params=p, policy=policy,
                       device="cpu").policy.backend

    class Small(Engine):
        MAX_DENSE_BYTES = est - 1

    assert backend() == "dense"
    assert backend(cls=Small) == "sparse"
    monkeypatch.setenv("REPRO_MAX_DENSE_BYTES", str(est - 1))
    assert backend() == "sparse"
    monkeypatch.setenv("REPRO_MAX_DENSE_BYTES", str(est))
    assert backend(cls=Small) == "dense"
    assert backend(ExecPolicy(max_dense_bytes=est - 1)) == "sparse"
    assert backend(ExecPolicy(max_dense_bytes=est)) == "dense"


@pytest.mark.parametrize("backend,dtype,ok", [
    ("sparse", "auto", True), ("sparse", "float32", True),
    ("sparse", "float64", True), ("dense", "auto", True),
    ("dense", "float32", True), ("dense", "float64", False),
    ("sparse", "float16", False)])
def test_policy_dtypes(backend, dtype, ok):
    policy = ExecPolicy(backend=backend, dtype=dtype)
    if ok:
        assert policy.validate() is policy
        assert policy.float32 == (backend == "dense" or dtype == "float32")
    else:
        with pytest.raises(ValueError, match="dtype"):
            policy.validate()
    with pytest.raises(ValueError, match="max_dense_bytes"):
        ExecPolicy(max_dense_bytes=0).validate()


def test_engine_refuses_mismatched_plans():
    g, p = _small()
    with pytest.raises(ValueError, match="SparsePlan"):
        Engine(compile_plan(g, p), policy=F64, device="cpu")
    with pytest.raises(ValueError, match="backend='sparse'"):
        Engine(compile_sparse(g, p), device="cpu")


# -- the sensitivity front ---------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    p = loggps.cluster_params(L_us=3.0, o_us=5.0)
    return synth.stencil2d(4, 4, 10, halo_bytes=64e3, comp_us=500.0,
                           params=p), p


def test_curves_with_sparse_f32_policy_match_dense(quickstart):
    g, p = quickstart
    deltas = np.linspace(0.0, 50.0, 11)
    for fn, xs in ((sensitivity.latency_curve, deltas),
                   (sensitivity.bandwidth_curve, np.linspace(1.0, 8.0, 8))):
        want = fn(g, p, xs, device="cpu")
        got = fn(g, p, xs, device="cpu", policy=F32)
        np.testing.assert_allclose(got.T, want.T, rtol=RTOL_T, atol=0)
        np.testing.assert_allclose(got.lam, want.lam, rtol=RTOL_LAM, atol=0)
        np.testing.assert_allclose(got.rho, want.rho, rtol=RTOL_RHO, atol=0)


def test_tolerance_with_sparse_f32_policy_matches_dense(quickstart):
    """Both are float32 bisections within 1e-5 of the float64 curve, so
    they differ by at most twice the bound of
    ``test_torch_sensitivity.py``'s tolerance test."""
    g, p = quickstart
    degr = (0.01, 0.02, 0.05)
    want = sensitivity.latency_tolerance(g, p, degr, device="cpu")
    eng.sparse_forward_f32.runs.clear()
    got = sensitivity.latency_tolerance(g, p, degr, device="cpu", policy=F32)
    assert eng.sparse_forward_f32.runs["lam"] > 0
    base = sensitivity.latency_curve(g, p, [0.0], device="cpu", policy=F64)
    for deg in degr:
        budget = (1.0 + deg) * base.T[0]
        atol = (2 * 1e-6 * budget + (2 + deg) * 1e-5 * budget) / base.lam[0]
        assert abs(got[deg] - want[deg]) <= 2 * atol + 1e-6 * abs(want[deg])
    assert got[0.01] < got[0.02] < got[0.05]
