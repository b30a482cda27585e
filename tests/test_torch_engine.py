"""The PyTorch package's dense engine against the JAX package's.

On the five conformance cases (``tests/test_conformance.py``), the port's
``Engine(device="cpu")`` — the kernels' plain versions — is held against
the JAX package's ``Engine(policy=ExecPolicy(backend="pallas"))`` (its
kernels in interpret mode) and against the float64 scalar oracle
``core.dag.LevelPlan.forward``.  The contract is the reference pallas
backend's own (``test_conformance.py``): T and λ within 1e-5 relative
(float32 accumulators against float64), ρ within 1e-4 (a ratio of the
two).  Both engines are fed the identical plan, carried across with
``plan_from_arrays``, and the port's own ``compile_plan`` output besides.
"""

import numpy as np
import pytest
import torch

from repro import sweep as ref_sweep
from repro.core import dag, loggps as ref_loggps, synth as ref_synth
from repro.sweep.api import ExecPolicy as RefPolicy

from repro_torch.carry import plan_from_arrays
from repro_torch.core import loggps, synth
from repro_torch.sweep import Engine, ExecPolicy, compile_plan, latency_grid

NAMES = ("stencil", "cg", "allreduce", "stencil2c", "stencil3c")
RTOL_T = RTOL_LAM = 1e-5
RTOL_RHO = 1e-4
# the dense backend this file holds against the reference's "pallas" one
# (the default is segment, as the reference's is)
DENSE = ExecPolicy("dense")


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


DELTAS = np.linspace(0.0, 60.0, 5)


def _scalar(g, p, batch):
    plan = dag.LevelPlan(g)
    out = [plan.forward(p.replace(L=tuple(batch.L[i])))
           for i in range(batch.S)]
    return (np.array([s.T for s in out]), np.stack([s.lam for s in out]),
            np.stack([s.rho() for s in out]))


@pytest.fixture(scope="module")
def runs():
    """Per case: the scalar oracle, the reference pallas engine and the
    port's engine on the carried and on its own plan (λ and values-only)."""
    out = {}
    for name in NAMES:
        g_ref, p_ref = build(name, ref_synth, ref_loggps)
        g, p = build(name, synth, loggps)
        ref_plan = ref_sweep.compile_plan(g_ref, p_ref)
        fields = {k: v for k, v in vars(ref_plan).items()
                  if isinstance(v, np.ndarray)}
        carried = plan_from_arrays(fields, ref_plan.nv, ref_plan.nclass,
                                   ref_plan.nlevels)
        ref_batch = ref_sweep.latency_grid(p_ref, DELTAS)
        batch = latency_grid(p, DELTAS)
        r = ref_sweep.Engine(ref_plan, params=p_ref,
                             policy=RefPolicy(backend="pallas", cache=None)
                             ).run(ref_batch)
        eng = Engine(carried, policy=DENSE, device="cpu")
        own = Engine(compile_plan(g, p), policy=DENSE, device="cpu")
        out[name] = {
            "scalar": _scalar(g_ref, p_ref, ref_batch),
            "pallas": (r.T, r.lam, r.rho),
            "port": eng.run(batch),
            "own": own.run(batch),
            "values": eng.run(batch, compute_lam=False),
        }
    return out


@pytest.mark.parametrize("oracle", ["scalar", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_T_lam_rho_match(runs, name, oracle):
    T, lam, rho = runs[name][oracle]
    for key in ("port", "own"):
        res = runs[name][key]
        np.testing.assert_allclose(res.T, T, rtol=RTOL_T, atol=0)
        np.testing.assert_allclose(res.lam, lam, rtol=RTOL_LAM, atol=0)
        np.testing.assert_allclose(res.rho, rho, rtol=RTOL_RHO, atol=0)
        assert res.device == "cpu" and res.backend == "dense"


@pytest.mark.parametrize("name", NAMES)
def test_values_only_T_equals_lam_run(runs, name):
    res, vals = runs[name]["port"], runs[name]["values"]
    np.testing.assert_array_equal(vals.T, res.T)
    assert vals.lam is None and vals.rho is None


@pytest.mark.parametrize("name", NAMES)
def test_own_plan_equals_carried_plan(runs, name):
    """The port's compile_plan equals the reference's, so the two runs are
    bit-identical."""
    a, b = runs[name]["own"], runs[name]["port"]
    np.testing.assert_array_equal(a.T, b.T)
    np.testing.assert_array_equal(a.lam, b.lam)


def test_no_device_means_the_card(monkeypatch):
    """``device=None`` asks for CUDA and raises without a card; it never
    falls back to the CPU."""
    g, p = build("stencil", synth, loggps)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g, params=p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g, params=p, device="cuda")


# "sparse" and "segment" are ported now: their cases hold each backend to
# the dtypes it has (tests/test_torch_sparse.py and
# tests/test_torch_segment.py run them)
@pytest.mark.parametrize("backend", ["segment", "sparse", "pallas", "bogus"])
def test_policy_refuses_other_backends(backend):
    policy = {"sparse": ExecPolicy(backend="sparse", dtype="float16"),
              "segment": ExecPolicy(backend="segment", dtype="float32")}.get(
                  backend, ExecPolicy(backend=backend))
    with pytest.raises(ValueError, match={
            "segment": "computes in float64", "sparse": "unknown dtype"}.get(
                backend, "unknown backend")):
        policy.validate()
    g, p = build("stencil", synth, loggps)
    with pytest.raises(ValueError):
        Engine(g, params=p, policy=policy, device="cpu")


def test_run_rejects_wrong_class_count():
    g, p = build("stencil", synth, loggps)
    eng = Engine(g, params=p, device="cpu")
    p2 = loggps.pod_model(pod_size=2).params()
    with pytest.raises(ValueError, match="classes"):
        eng.run(latency_grid(p2, DELTAS))
