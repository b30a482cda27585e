"""The PyTorch package's linear scan against the JAX package's.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the JAX package's ``linear_scan_ref`` oracle and its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs them, within that
file's tolerances: 1e-4 in float32 and 5e-2 in bfloat16 (both sides
compute in float32; the sums over the state run in another order, and
bfloat16 y rounds once at the end).  The inputs are made with numpy and
handed to both.  The ``gpu``-marked test holds the CUDA kernel against the
plain version on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref

# B, T, D, S   (tests/test_kernels.py:43)
SCAN_CASES = [(2, 64, 128, 8), (1, 128, 256, 16), (3, 32, 64, 4)]
# decode (T = 1), a ragged T and D, the widest state the kernel takes
EXTRA_CASES = [(4, 1, 128, 16), (2, 77, 100, 8), (1, 5, 64, 4),
               (2, 9, 48, 32)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(scope="module")
def jls():
    """The JAX package's linear scan.  Imported here, not at the top, so the
    ``gpu`` test also runs where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.linear_scan import linear_scan as jscan
    from repro.kernels.linear_scan.ref import linear_scan_ref as jref
    return jnp, jscan, jref


def _inputs(B, T, D, S, seed):
    """a ∈ [0.5, 0.99), b ~ 0.1·N(0, 1), c ~ N(0, 1), h0 ~ N(0, 1)
    (``tests/test_kernels.py``'s distributions), float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.99, (B, T, D, S)).astype(np.float32),
            (rng.standard_normal((B, T, D, S)) * 0.1).astype(np.float32),
            rng.standard_normal((B, T, S)).astype(np.float32),
            rng.standard_normal((B, D, S)).astype(np.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("case", SCAN_CASES + EXTRA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(case, dtype, jls):
    jnp, _, jref = jls
    a, b, c, h0 = _inputs(*case, seed=1)
    jd = getattr(jnp, dtype)
    yr, hr = jref(jnp.asarray(a, jd), jnp.asarray(b, jd), jnp.asarray(c, jd),
                  jnp.asarray(h0))
    y, h = linear_scan(_torch(a, dtype), _torch(b, dtype), _torch(c, dtype),
                       torch.from_numpy(h0))
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert y.shape == case[:3] and h.shape == (case[0], case[2], case[3])
    _close(y, yr, TOL[dtype])
    _close(h, hr, TOL[dtype])


@pytest.mark.parametrize("case", SCAN_CASES + EXTRA_CASES[:3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(case, dtype, jls):
    """Against the TPU kernel in interpret mode, with the blocks
    ``tests/test_kernels.py`` gives it where they divide D and T (one
    block over the whole axis otherwise, as the kernel asserts)."""
    jnp, jscan, _ = jls
    B, T, D, S = case
    a, b, c, h0 = _inputs(*case, seed=2)
    jd = getattr(jnp, dtype)
    bd = 64 if D % 64 == 0 else D
    ct = 32 if T % 32 == 0 else T
    yk, hk = jscan(jnp.asarray(a, jd), jnp.asarray(b, jd), jnp.asarray(c, jd),
                   jnp.asarray(h0), bd=bd, ct=ct)
    y, h = linear_scan(_torch(a, dtype), _torch(b, dtype), _torch(c, dtype),
                       torch.from_numpy(h0))
    _close(y, yk, TOL[dtype])
    _close(h, hk, TOL[dtype])


def test_h0_carries_the_state():
    """Two calls over halves of T, the second from the first's h, equal
    one call over the whole (bit for bit: the same operations in order)."""
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(2, 10, 24, 8, 3))
    y, h = linear_scan(a, b, c, h0)
    y1, h1 = linear_scan(a[:, :4].contiguous(), b[:, :4].contiguous(),
                         c[:, :4].contiguous(), h0)
    y2, h2 = linear_scan(a[:, 4:].contiguous(), b[:, 4:].contiguous(),
                         c[:, 4:].contiguous(), h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(1, 4, 8, 4, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        linear_scan(a.half(), b.half(), c.half(), h0)
    with pytest.raises(TypeError, match="is torch.bfloat16"):
        linear_scan(a, b.bfloat16(), c, h0)
    with pytest.raises(ValueError, match="4-D"):
        linear_scan(a[0], b, c, h0)
    with pytest.raises(ValueError, match="do not fit"):
        linear_scan(a, b, c[:, :3].contiguous(), h0)
    with pytest.raises(ValueError, match="do not fit"):
        linear_scan(a, b, c, h0[:, :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        linear_scan(a.transpose(1, 2), b.transpose(1, 2), c, h0)
    with pytest.raises(ValueError, match="exceeds 32"):
        big = torch.zeros(1, 2, 3, 33)
        linear_scan(big, big, torch.zeros(1, 2, 33), torch.zeros(1, 3, 33))
    with pytest.raises(ValueError, match=">= 1"):
        linear_scan(a[:, :0], b[:, :0], c[:, :0], h0)


def test_cpu_calls_launch_nothing():
    """The plain version on the CPU is not a kernel launch."""
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(1, 4, 8, 4, 6))
    n = linear_scan.launches
    linear_scan(a, b, c, h0)
    assert linear_scan.launches == n


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    """Kernel vs plain version on the card, in both types: jamba's decode
    (B = 4, T = 1) and a prefill chunk at its width (D = 16384, S = 16),
    ragged T and D, and every state width the kernel has a path for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(4, 1, 16384, 16), (1, 256, 16384, 16), (2, 77, 100, 8),
             (1, 5, 64, 4), (3, 130, 33, 1), (2, 70, 50, 2), (1, 64, 40, 3),
             (2, 65, 70, 12), (1, 129, 31, 32)]
    for dtype in ("float32", "bfloat16"):
        for B, T, D, S in cases:
            a, b, c, h0 = (_torch(x, dtype if i < 3 else "float32").cuda()
                           for i, x in enumerate(_inputs(B, T, D, S,
                                                         seed=T * D + S)))
            n = linear_scan.launches
            y, h = linear_scan(a, b, c, h0)
            torch.cuda.synchronize()
            assert linear_scan.launches == n + 1
            yr, hr = linear_scan_ref(a, b, c, h0)
            assert y.dtype == a.dtype and h.dtype == torch.float32
            ey = (y.float() - yr.float()).abs().max().item()
            eh = (h - hr).abs().max().item()
            assert ey <= TOL[dtype] and eh <= TOL[dtype], (dtype, B, T, D, S,
                                                           ey, eh)
