"""The PyTorch package's (max,+) kernels against the JAX package's: the
dense mat-vecs, their graph-batched twins and the slot-list segment
reduction.

On the CPU the wrappers run their plain PyTorch versions; those are held
bit for bit (``array_equal``, no tolerance: every candidate is one float32
add, and max and the lexicographic compares are exact) against the JAX
package's Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them, and against its ``ref.py`` oracles.  The ``gpu``-marked tests
hold the CUDA kernels against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.maxplus import (maxplus_matvec,
                                         maxplus_matvec_argmax,
                                         maxplus_matvec_argmax_batched,
                                         maxplus_matvec_argmax_batched_ref,
                                         maxplus_matvec_argmax_ref,
                                         maxplus_matvec_batched,
                                         maxplus_matvec_batched_ref,
                                         maxplus_matvec_ref,
                                         maxplus_slotlist_argmax,
                                         maxplus_slotlist_argmax_ref)

NEG = np.float32(-1e30)


@pytest.fixture(scope="module")
def jaxk():
    """The JAX package's kernels and oracles.  Imported here, not at the top,
    so the ``gpu`` test also runs where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import maxplus
    return jnp, maxplus


def _inputs(kind, M, N, K, seed):
    """(A, t, c) float32 numpy inputs of one family."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        # test_kernels.py's family: 30 % edges with costs in [0, 10)
        A = np.where(rng.random((M, N)) < 0.3,
                     rng.uniform(0.0, 10.0, (M, N)), NEG)
        t = rng.uniform(0.0, 100.0, (N, K))
        c = rng.integers(0, 6, (N, K))
    elif kind == "ties":
        # integer-valued floats and one tie key: value ties everywhere,
        # the ordinal decides
        A = np.where(rng.random((M, N)) < 0.5, rng.integers(0, 3, (M, N)), NEG)
        t = rng.integers(0, 4, (N, K))
        c = np.ones((N, K))
    elif kind == "empty":
        # a third of the rows have no edge at all, and some candidates are
        # masked to −1e30 as the engine masks pad slots: rows whose every
        # candidate lies at or below −1e30
        A = np.where(rng.random((M, N)) < 0.2, 0.0, NEG)
        A[::3] = NEG
        t = rng.uniform(0.0, 50.0, (N, K))
        t[rng.random((N, K)) < 0.3] = NEG
        t[:, 0] = NEG                    # scenario 0: every candidate masked
        c = rng.integers(0, 3, (N, K))
    else:
        raise ValueError(kind)
    return (A.astype(np.float32), t.astype(np.float32),
            c.astype(np.float32))


# (M, N, K, bm, bn): test_kernels.py's shapes, then shapes that are not
# powers of two (the JAX kernel needs bm | M and bn | N)
SHAPES = [(128, 128, 8, 64, 64), (256, 384, 16, 64, 64),
          (64, 64, 128, 64, 64), (64, 128, 8, 32, 32),
          (100, 77, 13, 50, 77), (48, 200, 3, 16, 40)]
KINDS = ("random", "ties", "empty")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N,K,bm,bn", SHAPES)
def test_matvec_matches_jax_kernel(jaxk, kind, M, N, K, bm, bn):
    jnp, jm = jaxk
    A, t, c = _inputs(kind, M, N, K, seed=M + N + K)
    got = maxplus_matvec(torch.from_numpy(A), torch.from_numpy(t)).numpy()
    want = np.asarray(jm.maxplus_matvec(jnp.asarray(A), jnp.asarray(t),
                                        bm=bm, bn=bn))
    np.testing.assert_array_equal(got, want)
    # the JAX oracle has no −1e30 floor: compare the rows it defines alike
    ref = np.asarray(jm.maxplus_matvec_ref(jnp.asarray(A), jnp.asarray(t)))
    rows = (ref >= NEG).all(axis=1)
    assert rows.any()
    np.testing.assert_array_equal(got[rows], ref[rows])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N,K,bm,bn", SHAPES)
def test_argmax_matches_jax_kernel(jaxk, kind, M, N, K, bm, bn):
    jnp, jm = jaxk
    A, t, c = _inputs(kind, M, N, K, seed=7 * M + N + K)
    if kind == "random":
        # exact value and key ties across block boundaries (test_kernels.py)
        t[3] = t[N - 5]
        A[7, 3] = A[7, N - 5] = 1.0
        c[3] = c[N - 5]
    out, idx = maxplus_matvec_argmax(torch.from_numpy(A), torch.from_numpy(t),
                                     torch.from_numpy(c))
    wo, wi = jm.maxplus_matvec_argmax(jnp.asarray(A), jnp.asarray(t),
                                      jnp.asarray(c), bm=bm, bn=bn)
    np.testing.assert_array_equal(out.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    assert idx.dtype == torch.int32
    ro, ri = jm.maxplus_matvec_argmax_ref(jnp.asarray(A), jnp.asarray(t),
                                          jnp.asarray(c))
    ro, ri = np.asarray(ro), np.asarray(ri)
    rows = (ro >= NEG).all(axis=1)
    assert rows.any()
    np.testing.assert_array_equal(out.numpy()[rows], ro[rows])
    np.testing.assert_array_equal(idx.numpy()[rows], ri[rows])
    if kind == "empty":
        # rows with no edge: the −1e30 floor; below it the −1 sentinel
        assert (out.numpy()[::3] == NEG).all()
        assert (idx.numpy()[~(ro >= NEG)] == -1).all()


def test_values_equal_argmax_values():
    A, t, c = _inputs("random", 96, 160, 24, seed=3)
    At, tt, ct = map(torch.from_numpy, (A, t, c))
    assert torch.equal(maxplus_matvec(At, tt),
                       maxplus_matvec_argmax(At, tt, ct)[0])


def test_cpu_runs_plain_version_and_counts_no_launch():
    A, t, c = _inputs("ties", 32, 48, 8, seed=5)
    At, tt, ct = map(torch.from_numpy, (A, t, c))
    n0, n1 = maxplus_matvec.launches, maxplus_matvec_argmax.launches
    assert torch.equal(maxplus_matvec(At, tt), maxplus_matvec_ref(At, tt))
    o, i = maxplus_matvec_argmax(At, tt, ct)
    ro, ri = maxplus_matvec_argmax_ref(At, tt, ct)
    assert torch.equal(o, ro) and torch.equal(i, ri)
    assert (maxplus_matvec.launches, maxplus_matvec_argmax.launches) == (n0, n1)


def test_plain_version_chunks_rows(monkeypatch):
    """Chunking over M (to bound the [rows, N, K] candidate tensor) does not
    change a bit."""
    from repro_torch.kernels.maxplus import ref
    A, t, c = _inputs("random", 70, 33, 9, seed=9)
    At, tt, ct = map(torch.from_numpy, (A, t, c))
    whole = maxplus_matvec_argmax_ref(At, tt, ct)
    monkeypatch.setattr(ref, "CHUNK_ELEMS", 33 * 9 * 4)
    chunked = maxplus_matvec_argmax_ref(At, tt, ct)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])
    assert torch.equal(maxplus_matvec_ref(At, tt), whole[0])


_A, _T, _C = torch.zeros((8, 4)), torch.zeros((4, 3)), torch.zeros((4, 3))
BAD_CALLS = [
    ("dtype", TypeError, lambda: maxplus_matvec(_A.double(), _T)),
    ("dtype-c", TypeError,
     lambda: maxplus_matvec_argmax(_A, _T, _C.to(torch.float16))),
    ("int-t", TypeError, lambda: maxplus_matvec(_A, _T.int())),
    ("numpy", TypeError, lambda: maxplus_matvec(_A.numpy(), _T)),
    ("shape", ValueError, lambda: maxplus_matvec(_A, torch.zeros((5, 3)))),
    ("shape-c", ValueError,
     lambda: maxplus_matvec_argmax(_A, _T, torch.zeros((4, 2)))),
    ("rank", ValueError, lambda: maxplus_matvec(_A, torch.zeros(4))),
    ("empty", ValueError, lambda: maxplus_matvec(torch.zeros((0, 4)), _T)),
    ("contiguous", ValueError,
     lambda: maxplus_matvec(_A, torch.zeros((3, 4)).T)),
]


@pytest.mark.parametrize("exc,call", [pytest.param(e, f, id=n)
                                      for n, e, f in BAD_CALLS])
def test_wrappers_reject_bad_inputs(exc, call):
    with pytest.raises(exc):
        call()


def test_parse_ptxas_reads_registers_smem_and_spills():
    from repro_torch.kernels.build import parse_ptxas
    log = """ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 6208 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 12 registers, 384 bytes cmem[0]
"""
    assert parse_ptxas(log) == {
        "_Z6kernelPf": {"spill_stores": 8, "spill_loads": 4,
                        "registers": 40, "smem_bytes": 6208},
        "_Z5otherv": {"registers": 12, "smem_bytes": 0}}


def test_build_all_keeps_ptxas_report_of_a_built_library(tmp_path,
                                                         monkeypatch):
    """A library found already built reports ptxas's lines of its build
    (kept beside it), as the build that made it did."""
    import sys
    from repro_torch.kernels import build
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!{sys.executable}
import sys
open(sys.argv[sys.argv.index("-o") + 1], "w").close()
print("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'")
print("ptxas info    : Used 7 registers, 16 bytes smem")
""")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    want = {"_Z1kv": {"registers": 7, "smem_bytes": 16}}
    first = build.build_all(["tree_precond"])["tree_precond"]
    assert first.ptxas == want
    again = build.build_all(["tree_precond"])["tree_precond"]
    assert again.path == first.path and again.ptxas == want


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_card():
    """Kernel vs plain version on the card, bit for bit, at the main path's
    shape (M = Vmax = 256, N = Emax = 128, K = 256) and at ragged ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in KINDS:
        for M, N, K in ((256, 128, 256), (100, 77, 13), (1, 1, 1),
                        (33, 300, 70)):
            A, t, c = (torch.from_numpy(x).cuda()
                       for x in _inputs(kind, M, N, K, seed=M * K))
            n0, n1 = maxplus_matvec.launches, maxplus_matvec_argmax.launches
            out = maxplus_matvec(A, t)
            o, i = maxplus_matvec_argmax(A, t, c)
            torch.cuda.synchronize()
            assert maxplus_matvec.launches == n0 + 1
            assert maxplus_matvec_argmax.launches == n1 + 1
            assert torch.equal(out, maxplus_matvec_ref(A, t))
            ro, ri = maxplus_matvec_argmax_ref(A, t, c)
            assert torch.equal(o, ro) and torch.equal(i, ri)


# -- the slot-list segment reduction (kernel 5) ------------------------------

def _slot_inputs(kind, M, E, K, seed):
    """(dst [E, 1] int32, cand, c [E, K] float32) of one family: rows
    M-4..M-1 empty, the last 3 slots pad slots at row M, and an exact
    value and key tie between slots 3 and E-5 on row 7, which dominates
    the row (``test_kernels.py:108-140``).  ``ties``: integer values and
    keys everywhere, so full ties (the ordinal decides) are common;
    ``empty``: negative rows, rows past M, and candidates at or below
    −1e30."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, M - 4, E)
    dst[-3:] = M
    if kind == "random":
        cand = rng.uniform(0.0, 100.0, (E, K))
        c = rng.integers(0, 5, (E, K))
    elif kind == "ties":
        cand = rng.integers(0, 3, (E, K))
        c = rng.integers(0, 2, (E, K))
    elif kind == "empty":
        cand = rng.uniform(0.0, 50.0, (E, K))
        cand[rng.random((E, K)) < 0.3] = NEG
        cand[rng.random((E, K)) < 0.1] = 2 * NEG
        cand[:, 0] = NEG
        c = rng.integers(0, 3, (E, K))
        dst[rng.random(E) < 0.1] = M + 7
        dst[rng.random(E) < 0.05] = -1
    else:
        raise ValueError(kind)
    dst[3] = dst[E - 5] = 7
    cand[3] = cand[E - 5] = 1000.0
    c[3] = c[E - 5]
    return (dst.astype(np.int32)[:, None], cand.astype(np.float32),
            c.astype(np.float32))


# (M, E, K, bm, be): test_kernels.py's shapes, then K and E off the TPU's
# and the CUDA kernel's tile multiples (the JAX kernel needs bm | M, be | E)
SLOT_SHAPES = [(64, 128, 8, 32, 32), (128, 256, 16, 64, 64),
               (100, 60, 13, 50, 20), (40, 200, 37, 40, 40),
               (1024, 256, 33, 128, 128)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,E,K,bm,be", SLOT_SHAPES)
def test_slotlist_matches_jax_kernel_and_oracle(jaxk, kind, M, E, K, bm, be):
    jnp, jm = jaxk
    dst, cand, c = _slot_inputs(kind, M, E, K, seed=M + E + K)
    out, idx = maxplus_slotlist_argmax(torch.from_numpy(dst),
                                       torch.from_numpy(cand),
                                       torch.from_numpy(c), M)
    assert out.shape == (M, K) and idx.dtype == torch.int32
    wo, wi = jm.maxplus_slotlist_argmax(jnp.asarray(dst), jnp.asarray(cand),
                                        jnp.asarray(c), M=M, bm=bm, be=be)
    np.testing.assert_array_equal(out.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    ro, ri = jm.maxplus_slotlist_argmax_ref(jnp.asarray(dst[:, 0]),
                                            jnp.asarray(cand), jnp.asarray(c),
                                            M)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert (idx.numpy()[M - 4:] == -1).all()           # empty rows
    assert (out.numpy()[M - 4:] == NEG).all()
    assert (idx.numpy()[7] == E - 5).all()              # largest ordinal


def test_slotlist_cpu_runs_plain_version_and_counts_no_launch():
    dst, cand, c = map(torch.from_numpy, _slot_inputs("ties", 32, 48, 8, 5))
    n0 = maxplus_slotlist_argmax.launches
    o, i = maxplus_slotlist_argmax(dst, cand, c, 32)
    ro, ri = maxplus_slotlist_argmax_ref(dst, cand, c, 32)
    assert torch.equal(o, ro) and torch.equal(i, ri)
    assert maxplus_slotlist_argmax.launches == n0


_D, _V = torch.zeros((4, 1), dtype=torch.int32), torch.zeros((4, 3))
SLOT_BAD_CALLS = [
    ("dst-dtype", TypeError,
     lambda: maxplus_slotlist_argmax(_D.long(), _V, _V, 8)),
    ("cand-dtype", TypeError,
     lambda: maxplus_slotlist_argmax(_D, _V.double(), _V, 8)),
    ("dst-shape", ValueError,
     lambda: maxplus_slotlist_argmax(_D[:3], _V, _V, 8)),
    ("c-shape", ValueError,
     lambda: maxplus_slotlist_argmax(_D, _V, torch.zeros((4, 2)), 8)),
    ("rank", ValueError,
     lambda: maxplus_slotlist_argmax(_D[:, 0], _V, _V, 8)),
    ("M", ValueError, lambda: maxplus_slotlist_argmax(_D, _V, _V, 0)),
    ("numpy", TypeError,
     lambda: maxplus_slotlist_argmax(_D, _V.numpy(), _V, 8)),
    ("contiguous", ValueError,
     lambda: maxplus_slotlist_argmax(_D, _V, torch.zeros((3, 4)).T, 8)),
]


@pytest.mark.parametrize("exc,call", [pytest.param(e, f, id=n)
                                      for n, e, f in SLOT_BAD_CALLS])
def test_slotlist_wrapper_rejects_bad_inputs(exc, call):
    with pytest.raises(exc):
        call()


@pytest.mark.gpu
def test_cuda_slotlist_matches_plain_version_on_card():
    """Kernel vs plain version on the card, bit for bit, at the sparse
    forward's shape (M = Vmax_lv = 1024, E = Emax_lv = 256, K = 256) and
    at ragged ones: K not a multiple of 32, E not a multiple of the slot
    tile, pad slots at M and past it, ties across slot tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in KINDS:
        for M, E, K in ((1024, 256, 256), (100, 77, 13), (8, 8, 1),
                        (33, 300, 70), (64, 129, 32)):
            dst, cand, c = (torch.from_numpy(x).cuda()
                            for x in _slot_inputs(kind, M, E, K, M * K + E))
            n0 = maxplus_slotlist_argmax.launches
            o, i = maxplus_slotlist_argmax(dst, cand, c, M)
            torch.cuda.synchronize()
            assert maxplus_slotlist_argmax.launches == n0 + 1
            ro, ri = maxplus_slotlist_argmax_ref(dst, cand, c, M)
            assert torch.equal(o, ro) and torch.equal(i, ri), (kind, M, E, K)


def _smoke_slot_inputs(kind, M, E, K, seed):
    """``chip_smoke.py`` phase 3's slot-list inputs: ``main`` a sparse
    level's window (destinations sorted, the last sixteenth pad slots at
    M), ``empty`` a quarter of the rows empty, ``pad`` slots at M and past
    it, ``ties`` full ties across slot tiles (slots 3 and E-5 on row 1)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, M, E)
    cand = rng.uniform(0.0, 1e4, (E, K))
    c = rng.integers(0, 200, (E, K))
    if kind == "main":
        dst = np.sort(dst)
        dst[-E // 16:] = M
    elif kind == "empty":
        dst = rng.integers(0, (3 * M) // 4, E)
        cand[rng.random((E, K)) < 0.2] = NEG
        cand[:, 0] = NEG
    elif kind == "pad":
        dst[rng.random(E) < 0.3] = M
        dst[rng.random(E) < 0.1] = M + 5
    else:
        dst = rng.integers(0, 8, E)
        cand = rng.integers(0, 2, (E, K))
        c = rng.integers(0, 2, (E, K))
        cand[3] = cand[E - 5] = 7.0
        c[3] = c[E - 5] = 3.0
        dst[3] = dst[E - 5] = 1
    return (torch.from_numpy(dst.astype(np.int32)[:, None]).cuda(),
            *(torch.from_numpy(x.astype(np.float32)).cuda()
              for x in (cand, c)))


@pytest.mark.gpu
def test_cuda_slotlist_matches_plain_version_on_smoke_cases():
    """The slot-list kernel bit-equal to its plain version on the seven
    cases of ``chip_smoke.py`` phase 3 (seeds 100 + i, as there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [("main", 1024, 256, 256), ("empty", 500, 300, 64),
             ("pad", 1024, 256, 256), ("ties", 16, 200, 64),
             ("main", 1024, 256, 37), ("pad", 100, 100, 33),
             ("empty", 64, 70, 1)]
    for i, (kind, M, E, K) in enumerate(cases):
        dst, cand, c = _smoke_slot_inputs(kind, M, E, K, seed=100 + i)
        n0 = maxplus_slotlist_argmax.launches
        o, idx = maxplus_slotlist_argmax(dst, cand, c, M)
        torch.cuda.synchronize()
        assert maxplus_slotlist_argmax.launches == n0 + 1
        ro, ri = maxplus_slotlist_argmax_ref(dst, cand, c, M)
        assert torch.equal(o, ro) and torch.equal(idx, ri), (kind, M, E, K)
        if kind == "ties":
            assert bool((idx[1] == E - 5).all())


# -- the graph-batched mat-vecs (kernels 3 and 4) ----------------------------

def _batched_inputs(kind, G, M, N, K, seed):
    """(A [G, M, N], t, c [G, N, K]) float32: graph g is :func:`_inputs` of
    its own seed, and for ``random`` (where M > 7 and N > 8) an exact value
    and key tie across column blocks on row 7 of every graph
    (``test_kernels.py:140``)."""
    per = [_inputs(kind, M, N, K, seed + g) for g in range(G)]
    A, t, c = (np.stack([x[i] for x in per]) for i in range(3))
    if kind == "random" and M > 7 and N > 8:
        t[:, 3] = t[:, N - 5]
        A[:, 7, 3] = A[:, 7, N - 5] = 1.0
        c[:, 3] = c[:, N - 5]
    return A, t, c


# (G, M, N, K, bm, bn): test_kernels.py's batched shape, the packed study's
# (M = Vmax = 64, N = Emax = 128) at a small K, one graph, and M, N, K off
# the TPU's and the CUDA kernel's block multiples (bm | M, bn | N)
BATCHED_SHAPES = [(3, 32, 64, 8, 16, 16), (4, 64, 128, 16, 64, 64),
                  (1, 48, 200, 3, 16, 40), (5, 100, 77, 13, 50, 77)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G,M,N,K,bm,bn", BATCHED_SHAPES)
def test_batched_matches_jax_kernels(jaxk, kind, G, M, N, K, bm, bn):
    """Both batched plain versions equal the JAX package's batched Pallas
    kernels (interpret mode) bit for bit, and each graph equals the 2-D
    plain version on its slice."""
    jnp, jm = jaxk
    A, t, c = _batched_inputs(kind, G, M, N, K, seed=G * M + N + K)
    At, tt, ct = map(torch.from_numpy, (A, t, c))
    out = maxplus_matvec_batched(At, tt)
    o, idx = maxplus_matvec_argmax_batched(At, tt, ct)
    assert out.shape == (G, M, K) and idx.dtype == torch.int32
    want = jm.maxplus_matvec_batched(jnp.asarray(A), jnp.asarray(t),
                                     bm=bm, bn=bn)
    wo, wi = jm.maxplus_matvec_argmax_batched(
        jnp.asarray(A), jnp.asarray(t), jnp.asarray(c), bm=bm, bn=bn)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(o.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    for g in range(G):
        ro, ri = maxplus_matvec_argmax_ref(At[g], tt[g], ct[g])
        assert torch.equal(o[g], ro) and torch.equal(idx[g], ri)
        assert torch.equal(out[g], maxplus_matvec_ref(At[g], tt[g]))
    if kind == "random":
        assert (idx.numpy()[:, 7] >= 0).all()


def test_batched_cpu_runs_plain_version_and_counts_no_launch():
    A, t, c = map(torch.from_numpy, _batched_inputs("ties", 3, 32, 48, 8, 5))
    n0 = maxplus_matvec_batched.launches
    n1 = maxplus_matvec_argmax_batched.launches
    assert torch.equal(maxplus_matvec_batched(A, t),
                       maxplus_matvec_batched_ref(A, t))
    o, i = maxplus_matvec_argmax_batched(A, t, c)
    ro, ri = maxplus_matvec_argmax_batched_ref(A, t, c)
    assert torch.equal(o, ro) and torch.equal(i, ri)
    assert (maxplus_matvec_batched.launches,
            maxplus_matvec_argmax_batched.launches) == (n0, n1)


_A3, _T3 = torch.zeros((2, 8, 4)), torch.zeros((2, 4, 3))
BATCHED_BAD_CALLS = [
    ("dtype", TypeError, lambda: maxplus_matvec_batched(_A3.double(), _T3)),
    ("dtype-c", TypeError,
     lambda: maxplus_matvec_argmax_batched(_A3, _T3, _T3.half())),
    ("numpy", TypeError, lambda: maxplus_matvec_batched(_A3.numpy(), _T3)),
    ("rank-2", ValueError, lambda: maxplus_matvec_batched(_A3[0], _T3[0])),
    ("graphs", ValueError,
     lambda: maxplus_matvec_batched(_A3, torch.zeros((3, 4, 3)))),
    ("shape", ValueError,
     lambda: maxplus_matvec_batched(_A3, torch.zeros((2, 5, 3)))),
    ("shape-c", ValueError,
     lambda: maxplus_matvec_argmax_batched(_A3, _T3, torch.zeros((2, 4, 2)))),
    ("empty", ValueError,
     lambda: maxplus_matvec_batched(torch.zeros((0, 8, 4)),
                                    torch.zeros((0, 4, 3)))),
    ("contiguous", ValueError,
     lambda: maxplus_matvec_batched(_A3, torch.zeros((2, 3, 4)).mT)),
    ("size", ValueError,
     lambda: maxplus_matvec_batched(
         torch.zeros((1, 1, 1)).expand(2 ** 16, 1, 1).contiguous(),
         torch.zeros((2 ** 16, 1, 1)))),
]


@pytest.mark.parametrize("exc,call", [pytest.param(e, f, id=n)
                                      for n, e, f in BATCHED_BAD_CALLS])
def test_batched_wrappers_reject_bad_inputs(exc, call):
    with pytest.raises(exc):
        call()


@pytest.mark.gpu
def test_cuda_batched_kernels_match_plain_versions_on_card():
    """Both batched kernels vs their plain versions on the card, bit for
    bit, at the packed study's shape (G = 4, M = Vmax = 64, N = Emax = 128,
    K = 256) and at ragged ones: K = 37 and 1, G = 1 and 5, M and N off
    the block multiples."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in KINDS:
        for G, M, N, K in ((4, 64, 128, 256), (4, 64, 128, 37),
                           (1, 100, 77, 13), (5, 33, 300, 1),
                           (2, 1, 1, 1)):
            A, t, c = (torch.from_numpy(x).cuda() for x in
                       _batched_inputs(kind, G, M, N, K, seed=G * M * K))
            n0 = maxplus_matvec_batched.launches
            n1 = maxplus_matvec_argmax_batched.launches
            out = maxplus_matvec_batched(A, t)
            o, i = maxplus_matvec_argmax_batched(A, t, c)
            torch.cuda.synchronize()
            assert maxplus_matvec_batched.launches == n0 + 1
            assert maxplus_matvec_argmax_batched.launches == n1 + 1
            assert torch.equal(out, maxplus_matvec_batched_ref(A, t))
            ro, ri = maxplus_matvec_argmax_batched_ref(A, t, c)
            assert torch.equal(o, ro) and torch.equal(i, ri), (kind, G, M,
                                                               N, K)
            # graph g of a batched launch equals a solo launch on its slice
            for g in range(G):
                so, si = maxplus_matvec_argmax(A[g], t[g], c[g])
                assert torch.equal(o[g], so) and torch.equal(i[g], si)
