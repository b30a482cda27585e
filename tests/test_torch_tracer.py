"""The PyTorch package's step tracer against the JAX package's, and the
slice as a whole: a traced step through the port's engine.

``repro_torch.core.tracer`` is a numpy copy of ``repro.core.tracer`` on
the port's ``models.config``: for every config of ``repro_torch.configs``
× {``TRAIN_4K``, ``DECODE_32K``} at meshes (pods × data × model) 1×2×2 and
2×2×2, and with ``ranks_per_host`` set (three latency classes), the traced
graph equals the reference's field for field, arrays bit for bit.

Then a traced training step at 2×2×2 through the port's ``Engine(device=
"cpu")`` under the default policy with a dense-size guard it exceeds: the
engine warns and switches to sparse float64, and T, λ and ρ are
bit-identical to the reference's ``core.dag`` over a ΔL grid on the dcn
class; the dcn tolerances agree with ``core.dag.tolerance`` within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import dag as ref_dag, tracer as ref_tracer
from repro.models import config as ref_config

from repro_torch import configs
from repro_torch.core import dag, sensitivity, tracer
from repro_torch.models import config
from repro_torch.sweep import Engine, ExecPolicy, latency_grid

ARCHS = configs.all_archs()
MESHES = {"1x2x2": (1, 2, 2), "2x2x2": (2, 2, 2)}
SHAPES = ("TRAIN_4K", "DECODE_32K")


def assert_graph_equal(got, want):
    """Every field of two ExecutionGraphs equal, arrays bit for bit."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def traced(arch, shape, mesh, **kw):
    """(port graph, reference graph) of one step, or the exception both
    packages raise."""
    pods, data, model = mesh
    out = []
    for C, T, M in ((configs, tracer, config),
                    (ref_configs, ref_tracer, ref_config)):
        cfg, _ = C.get(arch)
        ts = T.TraceSpec(pods=pods, data=data, model=model, **kw)
        try:
            out.append(T.trace_step(cfg, getattr(M, shape), ts))
        except Exception as e:                    # noqa: BLE001
            out.append(e)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_step_equals_reference(arch, shape, mesh):
    got, want = traced(arch, shape, MESHES[mesh])
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
        return
    assert_graph_equal(got, want)
    assert got.nclass == 2 and got.num_vertices > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b",
                                  "deepseek-v2-lite-16b", "rwkv6-7b"])
def test_trace_with_ranks_per_host(arch):
    """ranks_per_host set: the node/ici/dcn registry, three classes; the
    collective algorithms of the Fig 10 axis on both TP and DP."""
    for shape in ("TRAIN_4K", "DECODE_32K", "PREFILL_32K"):
        got, want = traced(arch, shape, (2, 2, 2), ranks_per_host=2,
                           allreduce_algo="recursive_doubling",
                           dp_algo="ring")
        assert_graph_equal(got, want)
        assert got.nclass == 3


def test_trace_spec_and_params():
    kw = dict(pods=2, data=4, model=8, mfu=0.4, ranks_per_host=4)
    ts, rs = tracer.TraceSpec(**kw), ref_tracer.TraceSpec(**kw)
    assert dataclasses.asdict(ts) == dataclasses.asdict(rs)
    assert ts.n_devices == rs.n_devices == 64
    assert ts.device(1, 2, 3) == rs.device(1, 2, 3)
    p, pr = ts.params(), rs.params()
    for f in dataclasses.fields(pr):
        a, b = getattr(p, f.name), getattr(pr, f.name)
        if callable(b):
            assert all(a(x, y) == b(x, y) for x in range(64)
                       for y in range(0, 64, 7))
        else:
            assert a == b, f.name


@pytest.fixture(scope="module")
def llama_step():
    """llama3.2-3b's traced training step at 2×2×2, both packages."""
    got, want = traced("llama3.2-3b", "TRAIN_4K", (2, 2, 2))
    return got, want, tracer.TraceSpec(pods=2, data=2, model=2).params(), \
        ref_tracer.TraceSpec(pods=2, data=2, model=2).params()


def test_traced_step_through_the_engine_is_bit_identical(llama_step):
    g, g_ref, p, p_ref = llama_step
    with pytest.warns(RuntimeWarning, match="auto-switching"):
        eng = Engine(g, params=p, device="cpu",
                     policy=ExecPolicy(max_dense_bytes=1 << 16))
    assert eng.policy.backend == "sparse"
    assert eng.sparse is not None and not eng.policy.float32
    batch = latency_grid(p, np.linspace(0.0, 40.0, 5), cls="dcn")
    res = eng.run(batch)
    plan = ref_dag.LevelPlan(g_ref)
    for i in range(batch.S):
        s = plan.forward(p_ref.replace(L=tuple(batch.L[i])))
        assert res.T[i] == s.T
        np.testing.assert_array_equal(res.lam[i], s.lam)
        np.testing.assert_array_equal(res.rho[i], s.rho())
    assert res.lam[0, 1] > 0                    # dcn messages on the path
    # the port's own oracle (its forward finds levels from an index): the
    # same schedule, bit for bit
    mine = dag.LevelPlan(g).forward(p)
    want = plan.forward(p_ref)
    assert mine.T == want.T
    for f in ("lam", "t_start", "t_end", "slope"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(want, f))


def test_traced_step_tolerance_matches_reference_dag(llama_step,
                                                     monkeypatch):
    g, g_ref, p, p_ref = llama_step
    monkeypatch.setenv("REPRO_MAX_DENSE_BYTES", str(1 << 16))
    with pytest.warns(RuntimeWarning, match="auto-switching"):
        tol = sensitivity.latency_tolerance(g, p, (0.01, 0.05), cls="dcn",
                                            device="cpu")
    plan = ref_dag.LevelPlan(g_ref)
    for d in (0.01, 0.05):
        want = ref_dag.tolerance(g_ref, p_ref, d, cls=1, plan=plan)
        assert np.isfinite(want) and want > 0
        assert abs(tol[d] - want) <= 1e-5 * want
