"""The wkv6 kernel (RWKV-6's time-mix recurrence, ``kernels/rwkv``) and its
plain version.

On the CPU: ``wkv6_ref`` against the reference's recurrence, its step
(the body of ``rwkv6_apply``, ``repro/models/ssm.py:233-239``) scanned
by the reference's ``checkpointed_scan`` at T 1, 7, 64 and 128 (one scan,
one chunk, two checkpointed chunks): the state S within 1e-5 and y within
1e-5 (the reference's einsum sums over the key index in another order);
the wrapper's checks; its CPU route is the plain version.

On the card (``-m gpu``): the kernel against ``wkv6_ref`` on the same
card tensors at T 1 and 4096, hd 64 and 32, from a zero and a given
state, and at hd 64 with T off the kernel's 16-step chunk, at the
prefill's 64 heads and at too few heads to fill the card: S bit for bit,
y within 1e-5 of the call's largest |y| (the kernel sums over the key
index by row groups, with FMAs, so a y that cancels to near 0 has no
elementwise relative bound); one launch a call.  The launch's plan
(``wkv6_plan``: columns of S a block) is pinned on the CPU.  JAX is
imported inside a fixture only.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv import wkv6, wkv6_plan, wkv6_ref


def inputs(B, T, H, hd, seed, state=False):
    """r, k, v [B, T, H, hd] ~ 0.5·N(0, 1), w ~ U(0.5, 1), u [H, hd] ~
    0.1·N(0, 1), and S0 ~ 0.1·N(0, 1) when ``state``: float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hd)) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, T, H, hd))
    u = 0.1 * rng.standard_normal((H, hd))
    S0 = 0.1 * rng.standard_normal((B, H, hd, hd)) if state else None
    return [None if a is None else a.astype(np.float32)
            for a in (r, k, v, w, u, S0)]


@pytest.fixture(scope="module")
def ref_scan():
    """The reference's recurrence over T: its step, scanned by its
    ``checkpointed_scan`` (chunk 64), as ``rwkv6_apply`` runs it."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.ssm import checkpointed_scan

    def run(r, k, v, w, u, S0):
        B, T, H, hd = r.shape
        u = jnp.asarray(u)

        def step(S, inp):
            r_t, k_t, v_t, w_t = inp
            kv = jnp.einsum("bhk,bhv->bhkv", k_t, v_t)
            y = jnp.einsum("bhk,bhkv->bhv", r_t,
                           S + u[None, :, :, None] * kv)
            return w_t[..., None] * S + kv, y

        xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (r, k, v, w))
        S = (jnp.zeros((B, H, hd, hd), jnp.float32) if S0 is None
             else jnp.asarray(S0))
        S, yT = checkpointed_scan(step, S, xs, chunk=64)
        return np.asarray(jnp.moveaxis(yT, 0, 1)), np.asarray(S)

    return run


@pytest.mark.parametrize("T", [1, 7, 64, 128])
@pytest.mark.parametrize("state", [False, True])
def test_wkv6_ref_matches_the_reference_scan(T, state, ref_scan):
    args = inputs(2, T, 3, 16, seed=T, state=state)
    y, S = wkv6_ref(*(None if a is None else torch.from_numpy(a)
                      for a in args))
    wy, wS = ref_scan(*args)
    assert y.shape == (2, T, 3, 16) and S.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(S.numpy(), wS, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), wy, atol=1e-5, rtol=1e-5)


def test_wkv6_on_the_cpu_is_the_plain_version():
    args = [None if a is None else torch.from_numpy(a)
            for a in inputs(1, 9, 2, 8, seed=3, state=True)]
    n = wkv6.launches
    for got, want in zip(wkv6(*args), wkv6_ref(*args)):
        assert torch.equal(got, want)
    assert wkv6.launches == n
    # the state carries: two halves equal the whole
    r, k, v, w, u, S0 = args
    y1, S1 = wkv6(r[:, :4].contiguous(), k[:, :4].contiguous(),
                  v[:, :4].contiguous(), w[:, :4].contiguous(), u, S0)
    y2, S2 = wkv6(r[:, 4:].contiguous(), k[:, 4:].contiguous(),
                  v[:, 4:].contiguous(), w[:, 4:].contiguous(), u, S1)
    y, S = wkv6_ref(*args)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(S2, S)


def test_wkv6_checks_its_arguments():
    r, k, v, w, u, _ = (None if a is None else torch.from_numpy(a)
                        for a in inputs(1, 3, 2, 8, seed=4))
    with pytest.raises(TypeError, match="float32"):
        wkv6(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="u is"):
        wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r, k, v.transpose(2, 3).contiguous().transpose(2, 3), w, u)
    with pytest.raises(ValueError, match="S0 is"):
        wkv6(r, k, v, w, u, torch.zeros((1, 2, 8, 4)))
    with pytest.raises(ValueError, match=r"\[B, T, H, hd\]"):
        wkv6(r[0], k, v, w, u)


@pytest.mark.parametrize("shape, want", [
    ((1, 64, 64), (16, 256, 128)),     # rwkv6-7b's prefill: 4 blocks a head
    ((4, 64, 64), (16, 1024, 128)),    # its decode (B 4)
    ((1, 32, 64), (8, 256, 64)),       # 128 blocks at JB 16: halved once
    ((1, 2, 64), (4, 32, 32)),         # too few heads: down to JB 4
    ((2, 4, 64), (4, 128, 32)),
    ((1, 64, 32), (8, 256, 32)),       # hd 32: 4 blocks a head
    ((1, 8, 32), (4, 64, 16)),
])
def test_wkv6_plan_is_pinned(shape, want):
    """Columns of S a block (JB), blocks and threads a block on an H100's
    132 SMs: hd / 4 columns (4 blocks a head) where the blocks cover the
    SMs, halved down to 4 columns while they do not; a thread owns 4 rows
    of 2 columns."""
    B, H, hd = shape
    jb, blocks, threads = wkv6_plan(B, H, hd, 132)
    assert (jb, blocks, threads) == want
    assert blocks * threads * 8 == B * H * hd * hd     # every (i, j) once
    with pytest.raises(ValueError, match="head dims"):
        wkv6_plan(B, H, 48, 132)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 32])
@pytest.mark.parametrize("T", [1, 4096])
def test_wkv6_kernel_matches_plain_version_on_card(T, hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for state in (False, True):
        args = [None if a is None else torch.from_numpy(a).cuda()
                for a in inputs(2, T, 4, hd, seed=T + hd, state=state)]
        n = wkv6.launches
        y, S = wkv6(*args)
        torch.cuda.synchronize()
        assert wkv6.launches == n + 1
        wy, wS = wkv6_ref(*args)
        assert torch.equal(S, wS), (T, hd, state)
        # relative to the call's largest |y|: a y that cancels to near 0
        # among its hd terms has no elementwise relative bound
        rel = float((y - wy).abs().max() / wy.abs().max())
        assert rel <= 1e-5, (T, hd, state, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("B, T, H", [(1, 1000, 2), (1, 4099, 64)])
def test_wkv6_spread_state_matches_plain_version_on_card(B, T, H):
    """hd 64 with T off the 16-step chunk: 2 heads (too few to fill the
    card, 4 columns a block) and rwkv6-7b's 64 heads (16 columns a block),
    from a given state: S equal to the plain version's, y within 1e-5 of
    the largest |y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [torch.from_numpy(a).cuda()
            for a in inputs(B, T, H, 64, seed=T + H, state=True)]
    y, S = wkv6(*args)
    torch.cuda.synchronize()
    wy, wS = wkv6_ref(*args)
    assert torch.equal(S, wS), (B, T, H)
    assert float((y - wy).abs().max() / wy.abs().max()) <= 1e-5
