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
from repro_torch.kernels.maxplus import (maxplus_slotlist_argmax_ref,
                                         sparse_backtrace,
                                         sparse_backtrace_ref,
                                         sparse_levels_f32,
                                         sparse_levels_f32_ref)
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


@pytest.mark.parametrize("name", ["widelast", "stencil3c"])
def test_stage_sparse_f32_row_pointers_give_each_row_its_in_edges(name):
    """The level-loop kernel's pointers: row_ptr gives each row exactly its
    own in-edges (pad rows none), v_ptr_dev each level's rows."""
    sp = compile_sparse(*port_case(name))
    a32 = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    rp = a32.row_ptr.numpy()
    assert rp[0] == 0 and rp[sp.nv] == sp.ne and (rp[sp.nv:] == sp.ne).all()
    for v in range(sp.nv):
        assert (sp.edst_slot[rp[v]:rp[v + 1]] == v).all()
    np.testing.assert_array_equal(a32.v_ptr_dev.numpy(), sp.v_ptr)


def _unsorted(sp, kind):
    """``sp`` with one level broken: its edges in reverse order, one of them
    masked, or one landing in the next level's rows."""
    lv = int(np.argmax(np.diff(sp.level_ptr[:sp.nlevels + 1])))
    e0, e1 = int(sp.level_ptr[lv]), int(sp.level_ptr[lv + 1])
    fields = {k: getattr(sp, k).copy() for k in SPARSE_PLAN_ARRAYS}
    if kind == "reversed":
        assert len(np.unique(sp.edst_slot[e0:e1])) > 1
        for k in ("esrc_slot", "edst_slot", "econst", "egap", "egclass",
                  "elat", "elat_sum"):
            fields[k][e0:e1] = fields[k][e0:e1][::-1]
    elif kind == "masked":
        fields["emask"][e0] = False
    else:
        fields["edst_slot"][e1 - 1] = sp.v_ptr[lv + 1]
    return sparse_plan_from_arrays(fields, sp.nv, sp.ne, sp.nclass,
                                   sp.nlevels, sp.Emax_lv, sp.Vmax_lv)


@pytest.mark.parametrize("kind", ["reversed", "masked", "foreign"])
def test_stage_sparse_refuses_unsorted_levels(kind):
    """The level-loop kernel takes a row's in-edges as one run: a level
    whose edges are not sorted by destination, are masked or land outside
    the level's rows is refused, in both flavours."""
    sp = compile_sparse(*port_case("stencil"))
    bad = _unsorted(sp, kind)
    for dt in (torch.float32, torch.float64):
        eng.stage_sparse(sp, torch.device("cpu"), dt)
        with pytest.raises(ValueError, match="sorted by destination"):
            eng.stage_sparse(bad, torch.device("cpu"), dt)


# -- the float32 level loop and the backtrace against today's per-level body -

def _grid(p, S):
    batch = latency_grid(p, np.linspace(0.0, 60.0, S))
    return torch.from_numpy(batch.L), torch.from_numpy(batch.gscale)


def _state(nv_p, S, want_lam, device="cpu"):
    return eng._state((nv_p,), S, want_lam, torch.device(device))


def _window_oracle(sp, L, GS, want_lam):
    """The float32 level loop as the forward ran it before the level-loop
    kernel: each level's fixed [Emax_lv] window of edges (later levels'
    edges included) reduced by ``maxplus_slotlist_argmax_ref`` into the
    window's [Vmax_lv] rows, slots that cannot land there pointed at row
    Vmax_lv (never hit), then the winners' gathers."""
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    lp, vp = sp.level_ptr.astype(np.int64), sp.v_ptr.astype(np.int64)
    E, V = sp.Emax_lv, sp.Vmax_lv
    win = lp[:-1, None] + np.arange(E)
    dl = sp.edst_slot[win].astype(np.int64) - vp[:-1, None]
    keep = sp.emask[win] & (dl >= 0) & (dl < V)
    dloc = torch.from_numpy(np.where(keep, dl, V).astype(np.int32))
    w = eng._weights(a.egclass, a.egap, a.econst, a.elat, L, GS)
    t, ssum, cho, _ = _state(sp.vcost.shape[0], L.shape[0], want_lam)
    for lv in range(sp.nlevels):
        e0, rows = int(lp[lv]), slice(int(vp[lv]), int(vp[lv]) + V)
        es = a.esrc[e0:e0 + E]
        cand = t.index_select(0, es).add_(w[e0:e0 + E])
        key = torch.zeros((E, L.shape[0]), dtype=torch.float32)
        if want_lam:
            key = ssum.index_select(0, es).add_(a.elat_sum[e0:e0 + E, None])
        raw, idx = maxplus_slotlist_argmax_ref(dloc[lv, :, None],
                                               cand.float(), key, V)
        lost = raw < 0.0
        if want_lam:
            lost |= idx < 0
        ce = idx.masked_fill(lost, 0).long()
        torch.add(cand.gather(0, ce).masked_fill_(lost, 0.0),
                  a.vcost[rows, None], out=t[rows])
        if want_lam:
            ssum[rows] = key.gather(0, ce).masked_fill_(lost, 0.0)
            cho[rows] = (idx + e0).masked_fill_(lost, -1)
    return t, ssum, cho


def _level_loop(a, L, GS, want_lam, levels=sparse_levels_f32_ref):
    """The forward's state after running ``levels`` (the plain version or
    its wrapper) over each weight chunk; (t, ssum, cho, chunks)."""
    t, ssum, cho, csrc = _state(a.vcost.shape[0], L.shape[0], want_lam,
                                L.device)
    chunks = 0
    for lv0, lv1, base, w in eng._chunk_weights(a, L, GS, a.nlevels):
        levels(t, ssum, cho, w.contiguous(), base, a.esrc, a.row_ptr,
               a.v_ptr_dev, a.elat_sum, a.vcost, lv0, lv1, csrc)
        chunks += 1
    return t, ssum, cho, chunks


@pytest.mark.parametrize("want_lam", [False, True], ids=["values", "lam"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", NAMES)
def test_level_loop_plain_version_equals_window_oracle(name, chunked,
                                                       want_lam, monkeypatch):
    """The plain version of the level-loop kernel, which reads only each
    level's own edges and writes only its own rows, leaves t, ssum and cho
    of every real vertex bit-equal to the windowed per-level body."""
    g, p = port_case(name)
    sp = compile_sparse(g, p)
    L, GS = _grid(p, 5)
    if chunked:
        monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", 3 * 8 * 8)
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    t, ssum, cho, chunks = _level_loop(a, L, GS, want_lam)
    assert chunks == len(eng.weight_chunks(sp.level_ptr, sp.Emax_lv, 5,
                                           sp.nlevels))
    assert (chunks > 1) == chunked
    wt, ws, wc = _window_oracle(sp, L, GS, want_lam)
    nv = sp.nv
    assert torch.equal(t[:nv], wt[:nv])
    if want_lam:
        assert torch.equal(ssum[:nv], ws[:nv])
        assert torch.equal(cho[:nv], wc[:nv])
        assert (cho[:nv] >= 0).any()


def _walk(vsel, cho, esrc, elat, nlv):
    """λ by a scalar walk per scenario."""
    S, nc = vsel.shape[0], elat.shape[1]
    lam = np.zeros((S, nc))
    for k in range(S):
        v = int(vsel[k])
        for _ in range(nlv):
            e = int(cho[v, k])
            if e < 0:
                break
            lam[k] += elat[e]
            v = int(esrc[e])
    return lam


@pytest.mark.parametrize("name", NAMES)
def test_backtrace_plain_version_equals_a_scalar_walk(runs, name):
    """The plain version of the walk kernel gives λ equal to a scalar walk
    down the chosen edges, and the forward's λ equals the reference
    flavour's (float64 flavour: the scalar oracle's)."""
    g, p = port_case(name)
    sp = compile_sparse(g, p)
    L, GS = _grid(p, 5)
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    t, ssum, cho, _ = _level_loop(a, L, GS, True)
    nv = sp.nv
    T = t[:nv].amax(0)
    sink = t[:nv] >= T
    mx = torch.where(sink, ssum[:nv], -1e30).amax(0)
    vsel = torch.where(sink & (ssum[:nv] >= mx), a.vert_of_slot[:nv, None],
                       2 ** 31 - 1).argmin(0)
    lam = sparse_backtrace_ref(vsel, cho[:nv], a.esrc, a.elat, sp.nlevels)
    np.testing.assert_array_equal(
        lam.numpy(), _walk(vsel.numpy(), cho.numpy(), a.esrc.numpy(),
                           a.elat.numpy(), sp.nlevels))
    assert (lam.sum(1) > 0).all()
    np.testing.assert_array_equal(lam.numpy(), runs[name]["f32_own"].lam)


def test_level_loop_and_walk_wrappers_run_plain_versions_on_cpu():
    g, p = port_case("stencil3c")
    sp = compile_sparse(g, p)
    L, GS = _grid(p, 4)
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    n0, n1 = sparse_levels_f32.launches, sparse_backtrace.launches
    for want_lam in (False, True):
        got = _level_loop(a, L, GS, want_lam, levels=sparse_levels_f32)
        want = _level_loop(a, L, GS, want_lam)
        for x, y in zip(got[:3], want[:3]):
            assert (x is None and y is None) or torch.equal(x, y)
    vsel = torch.zeros(4, dtype=torch.int64) + sp.nv - 1
    cho = got[2][:sp.nv]
    csrc = torch.where(cho >= 0, a.esrc[cho.long().clamp(min=0)], -1).int()
    assert torch.equal(sparse_backtrace(vsel, cho, csrc, a.elat, 7),
                       sparse_backtrace_ref(vsel, cho, a.esrc, a.elat, 7))
    assert (sparse_levels_f32.launches, sparse_backtrace.launches) == (n0, n1)


def _wrapper_args():
    sp = compile_sparse(*port_case("stencil"))
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    t, ssum, cho, csrc = _state(sp.vcost.shape[0], 4, True)
    w = torch.zeros((sp.esrc_slot.shape[0], 4), dtype=torch.float64)
    return dict(t=t, ssum=ssum, cho=cho, w=w, w_base=0, esrc=a.esrc,
                row_ptr=a.row_ptr, v_ptr=a.v_ptr_dev, elat_sum=a.elat_sum,
                vcost=a.vcost, lv0=0, lv1=sp.nlevels, csrc=csrc)


LEVELS_BAD = [
    ("t-dtype", TypeError, lambda k: dict(t=k["t"].float())),
    ("t-rank", ValueError, lambda k: dict(t=k["t"][:, 0])),
    ("w-width", ValueError, lambda k: dict(w=k["w"][:, :3].contiguous())),
    ("row_ptr-dtype", TypeError, lambda k: dict(row_ptr=k["row_ptr"].long())),
    ("elat_sum-len", ValueError, lambda k: dict(elat_sum=k["elat_sum"][1:])),
    ("ssum-only", ValueError, lambda k: dict(cho=None)),
    ("csrc-missing", ValueError, lambda k: dict(csrc=None)),
    ("cho-contiguous", ValueError,
     lambda k: dict(cho=k["cho"].T.contiguous().T)),
    ("levels", ValueError, lambda k: dict(lv0=2, lv1=2)),
    ("w_base", ValueError, lambda k: dict(w_base=-1)),
    ("lv1-past", ValueError, lambda k: dict(lv1=k["v_ptr"].shape[0])),
    ("numpy", TypeError, lambda k: dict(vcost=k["vcost"].numpy())),
]


@pytest.mark.parametrize("change", [pytest.param((e, f), id=n)
                                    for n, e, f in LEVELS_BAD])
def test_level_loop_wrapper_rejects_bad_inputs(change):
    exc, fn = change
    kw = _wrapper_args()
    sparse_levels_f32(**kw)
    kw.update(fn(kw))
    with pytest.raises(exc):
        sparse_levels_f32(**kw)


WALK_BAD = [
    ("vsel-dtype", TypeError, lambda k: dict(vsel=k["vsel"].int())),
    ("vsel-len", ValueError, lambda k: dict(vsel=k["vsel"][1:])),
    ("cho-dtype", TypeError, lambda k: dict(cho=k["cho"].long())),
    ("elat-rank", ValueError, lambda k: dict(elat=k["elat"][:, 0])),
    ("csrc-shape", ValueError, lambda k: dict(csrc=k["csrc"][1:])),
    ("csrc-dtype", TypeError, lambda k: dict(csrc=k["csrc"].long())),
    ("nlv", ValueError, lambda k: dict(nlv=0)),
]


@pytest.mark.parametrize("change", [pytest.param((e, f), id=n)
                                    for n, e, f in WALK_BAD])
def test_walk_wrapper_rejects_bad_inputs(change):
    exc, fn = change
    sp = compile_sparse(*port_case("stencil"))
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    kw = dict(vsel=torch.zeros(4, dtype=torch.int64),
              cho=torch.full((sp.nv, 4), -1, dtype=torch.int32),
              csrc=torch.full((sp.nv, 4), -1, dtype=torch.int32),
              elat=a.elat, nlv=sp.nlevels)
    sparse_backtrace(**kw)
    kw.update(fn(kw))
    with pytest.raises(exc):
        sparse_backtrace(**kw)


@pytest.mark.gpu
def test_cuda_level_loop_and_walk_match_plain_versions_on_card(monkeypatch):
    """The level-loop and walk kernels against their plain versions on the
    card, bit for bit, on every case at S = 4, 32 and 256 with weight
    chunks of a few levels: one level-loop launch per chunk, one walk
    launch per λ forward, and the forward's T and λ equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", 1 << 12)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name in NAMES:
        g, p = port_case(name)
        sp = compile_sparse(g, p)
        a_card = eng.stage_sparse(sp, cuda, torch.float32)
        a_cpu = eng.stage_sparse(sp, cpu, torch.float32)
        for S in (4, 32, 256):
            L, GS = _grid(p, S)
            chunks = len(eng.weight_chunks(sp.level_ptr, sp.Emax_lv, S,
                                           sp.nlevels))
            for want_lam in (False, True):
                n0 = sparse_levels_f32.launches
                got = _level_loop(a_card, L.cuda(), GS.cuda(), want_lam,
                                  levels=sparse_levels_f32)
                torch.cuda.synchronize()
                assert sparse_levels_f32.launches == n0 + chunks
                assert got[3] == chunks
                want = _level_loop(a_cpu, L, GS, want_lam)
                for x, y in zip(got[:3], want[:3]):
                    assert (x is None and y is None) or \
                        torch.equal(x.cpu(), y), (name, S, want_lam)
            n1 = sparse_backtrace.launches
            vsel = torch.arange(S, dtype=torch.int64) % sp.nv
            cho = got[2][:sp.nv]
            csrc = torch.where(cho >= 0, a_card.esrc[cho.long().clamp(min=0)],
                               -1).int()
            lam = sparse_backtrace(vsel.cuda(), cho, csrc, a_card.elat,
                                   sp.nlevels)
            torch.cuda.synchronize()
            assert sparse_backtrace.launches == n1 + 1
            assert torch.equal(lam.cpu(), sparse_backtrace_ref(
                vsel, cho.cpu(), a_cpu.esrc, a_cpu.elat, sp.nlevels))
        batch = latency_grid(p, DELTAS)
        n0, n1 = sparse_levels_f32.launches, sparse_backtrace.launches
        card = Engine(g, params=p, policy=F32).run(batch)
        host = Engine(g, params=p, policy=F32, device="cpu").run(batch)
        assert sparse_backtrace.launches == n1 + 1
        assert sparse_levels_f32.launches == n0 + len(eng.weight_chunks(
            sp.level_ptr, sp.Emax_lv, 8, sp.nlevels))
        np.testing.assert_array_equal(card.T, host.T)
        np.testing.assert_array_equal(card.lam, host.lam)


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
               policy=ExecPolicy("dense", dtype="float32",
                                 max_dense_bytes=limit))


def test_guard_resolution_order(monkeypatch):
    """The policy field, then ``REPRO_MAX_DENSE_BYTES``, then the class
    attribute; at the limit itself the graph stays on the default
    (segment) backend."""
    g, p = _small()
    est = estimate_dense_bytes(g)

    def backend(policy=None, cls=Engine):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return cls(g, params=p, policy=policy,
                       device="cpu").policy.backend

    class Small(Engine):
        MAX_DENSE_BYTES = est - 1

    assert backend() == "segment"
    assert backend(cls=Small) == "sparse"
    monkeypatch.setenv("REPRO_MAX_DENSE_BYTES", str(est - 1))
    assert backend() == "sparse"
    monkeypatch.setenv("REPRO_MAX_DENSE_BYTES", str(est))
    assert backend(cls=Small) == "segment"
    assert backend(ExecPolicy(max_dense_bytes=est - 1)) == "sparse"
    assert backend(ExecPolicy(max_dense_bytes=est)) == "segment"


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
