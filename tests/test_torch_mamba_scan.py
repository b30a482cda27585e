"""The PyTorch package's Mamba scan against the JAX package's Mamba block.

``mamba_scan`` is one Mamba layer's scan: the decay a = exp(Δ·A), the
input b·x = (Δ·x)·B, the recurrence, the read-out through C and the skip
x·D, with y cast to x's dtype.  On the CPU the wrapper runs its plain
version, ``mamba_scan_ref``, which is the expression the Mamba block used
to hold inline; it is held

- against the JAX package's block (``repro/models/ssm.py:154-166``) built
  with ``jnp`` around the reference scan, through the scan's
  ``linear_scan_ref`` oracle and through its Pallas kernel in interpret
  mode: within 1e-5 of the largest output in float32 (both compute in
  float32; exp and the sums over the state run in other orders), and one
  bfloat16 step in bfloat16 (y rounds once, from float32 values that may
  fall on either side of a rounding boundary; near 0, where the skip
  cancels the scan's output, the float32 tolerance);
- bit for bit against that old inline expression, alone and inside the
  Mamba block.

Inputs are made with numpy: Δ = softplus(N(0, 1)), A = −(1..S) on every
channel, x, B, C, D and h0 ~ N(0, 1).  The ``gpu``-marked tests hold the
CUDA kernel against the plain version on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels.linear_scan import (linear_scan, mamba_decay,
                                             mamba_decay_ref, mamba_scan,
                                             mamba_scan_ref)
from repro_torch.models.ssm import Mamba, _dims

# B, T, Di, S: decode (T = 1), ragged T and Di, S of 1, 4, 16 and 32
CASES = [(4, 1, 64, 16), (2, 77, 100, 4), (1, 33, 48, 1), (2, 20, 40, 32),
         (3, 9, 24, 16), (1, 40, 33, 16)]
# the Pallas kernel in interpret mode is slow: a few of them
KERNEL_CASES = [(4, 1, 64, 16), (1, 64, 128, 16), (2, 32, 64, 4)]
DTYPES = ["float32", "bfloat16"]
TOL_F32 = 1e-5            # of the largest output
# on the card: y's sum over the state runs in another order (the linear
# scan's tolerances, tests/test_kernels.py); h bit for bit
CARD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def card_y_err(y: torch.Tensor, yr: torch.Tensor) -> float:
    """The largest |y − y_plain| beyond what rounding allows: in bfloat16
    each y rounds once from float32 sums taken in another order, so it may
    land one bfloat16 step from the plain version's, which exceeds 5e-2 where
    |y| ≥ 8; that step is subtracted.  0 when y is within one step."""
    e = (y.float() - yr.float()).abs()
    if y.dtype == torch.bfloat16:
        mag = torch.maximum(y.float().abs(), yr.float().abs())
        step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2 ** -126)))
                          - 7)
        e = torch.where(e <= step, torch.zeros_like(e), e)
    return e.max().item()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's scan.  Imported here, not at the top, so the
    ``gpu`` tests also run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.linear_scan import linear_scan as jscan
    from repro.kernels.linear_scan.ref import linear_scan_ref as jref
    return jnp, jscan, jref


def _inputs(B, T, Di, S, seed):
    """(x, dt, A, Bm, Cm, D, h0) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Di)))).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, S + 1, dtype=np.float32), (Di, S))
    Bm = rng.standard_normal((B, T, S)).astype(np.float32)
    Cm = rng.standard_normal((B, T, S)).astype(np.float32)
    D = rng.standard_normal(Di).astype(np.float32)
    h0 = rng.standard_normal((B, Di, S)).astype(np.float32)
    return x, dt, np.ascontiguousarray(A), Bm, Cm, D, h0


def _torch(arrays, dtype, device="cpu"):
    """x, Bm and Cm in ``dtype``, the rest float32, on ``device``."""
    x, dt, A, Bm, Cm, D, h0 = (torch.from_numpy(a).to(device)
                               for a in arrays)
    dt_ = getattr(torch, dtype)
    return x.to(dt_), dt, A, Bm.to(dt_), Cm.to(dt_), D, h0


def _jax_block(jx, scan, tensors):
    """``repro/models/ssm.py:155-166`` in ``jnp`` on the same values: a,
    b·x, the scan ``scan``, the skip and the cast."""
    jnp = jx[0]
    x, dt, A, Bm, Cm, D, h0 = tensors
    jd = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    xs, Bj, Cj = (jnp.asarray(t.float().numpy(), jd) for t in (x, Bm, Cm))
    dtj, Aj, Dj, h0j = (jnp.asarray(t.numpy()) for t in (dt, A, D, h0))
    f32 = jnp.float32
    a = jnp.exp(dtj[..., None] * Aj)
    bx = (dtj * xs.astype(f32))[..., None] * Bj.astype(f32)[:, :, None, :]
    y, h = scan(a, bx, Cj.astype(f32), h0j)
    y = y + xs.astype(f32) * Dj
    return np.asarray(y.astype(jd).astype(f32)), np.asarray(h)


def _bf16_step(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(v)) - 7)


def _hold(got, want, dtype):
    """y and h of the port against the JAX block's, at this file's
    tolerances."""
    (y, h), (yr, hr) = got, want
    y = y.float().numpy()
    h = h.numpy()
    np.testing.assert_allclose(h, hr, rtol=0,
                               atol=TOL_F32 * np.abs(hr).max())
    if dtype == "float32":
        np.testing.assert_allclose(y, yr, rtol=0,
                                   atol=TOL_F32 * np.abs(yr).max())
    else:
        # one step at the value; near 0, where y + x·D cancels, the float32
        # tolerance of the terms
        step = np.maximum(_bf16_step(np.maximum(np.abs(y), np.abs(yr))),
                          TOL_F32 * np.abs(yr).max())
        assert (np.abs(y - yr) <= step).all(), np.abs(y - yr).max()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_jax_block_with_oracle_scan(case, dtype, jx):
    t = _torch(_inputs(*case, seed=1), dtype)
    y, h = mamba_scan(*t)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    assert y.shape == case[:3] and h.shape == (case[0], case[2], case[3])
    _hold((y, h), _jax_block(jx, jx[2], t), dtype)


@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_jax_block_with_pallas_scan(case, dtype, jx):
    """The scan through the TPU kernel in interpret mode, with the blocks
    ``tests/test_kernels.py`` gives it where they divide Di and T."""
    B, T, Di, S = case
    bd = 64 if Di % 64 == 0 else Di
    ct = 32 if T % 32 == 0 else T

    def scan(a, b, c, h0):
        return jx[1](a, b, c, h0, bd=bd, ct=ct)

    t = _torch(_inputs(*case, seed=2), dtype)
    _hold(mamba_scan(*t), _jax_block(jx, scan, t), dtype)


def _old_inline(x, dt, A, Bm, Cm, D, h0):
    """The Mamba block's scan as it was written inline before the fused
    kernel (``models/ssm.py``): a and b·x built, the linear scan, the skip,
    the cast."""
    a = torch.exp_(dt[..., None] * A)
    xf = x.float()
    bx = (dt * xf)[..., None] * Bm.float()[:, :, None, :]
    y, h = linear_scan(a, bx, Cm.float().contiguous(), h0.contiguous())
    del a, bx
    y = y + xf * D
    return y.to(x.dtype), h


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_old_inline_expression(case, dtype):
    """Bit for bit, with B and C given as the strided views a split of one
    [B, T, 2·S + r] projection makes (as the Mamba block passes them)."""
    B, T, Di, S = case
    x, dt, A, Bm, Cm, D, h0 = _torch(_inputs(*case, seed=3), dtype)
    bcdt = torch.cat([Bm, Cm, torch.zeros((B, T, 3), dtype=Bm.dtype)], -1)
    Bv, Cv, _ = bcdt.split([S, S, 3], dim=-1)
    got = mamba_scan(x, dt, A, Bv, Cv, D, h0)
    want = _old_inline(x, dt, A, Bm, Cm, D, h0)
    ref = mamba_scan_ref(x, dt, A, Bm, Cm, D, h0)
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w) and torch.equal(r, w)


def _old_block_forward(blk, x, state=None):
    """``Mamba.forward`` with the old inline scan, for the bit-for-bit
    check of the block."""
    B, T, _ = x.shape
    Di, S, K, _ = _dims(blk.cfg)
    xs, z = (x @ blk.w_in).chunk(2, dim=-1)
    if state is not None:
        xs_full = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
    else:
        xs_full = F.pad(xs, (0, 0, K - 1, 0))
    new_conv = xs_full[:, T:].contiguous()
    xs = F.conv1d(xs_full.transpose(1, 2),
                  blk.conv_w.t().to(xs.dtype)[:, None, :],
                  groups=Di).transpose(1, 2)
    xs = F.silu(xs + blk.conv_b)
    Bm, Cm, dt_r = (xs @ blk.w_bcdt).split([S, S, blk.w_dt.shape[0]], dim=-1)
    dt = F.softplus((dt_r @ blk.w_dt).float() + blk.dt_bias)
    A = -torch.exp(blk.A_log)
    h0 = (state["h"] if state is not None else
          torch.zeros((B, Di, S), dtype=torch.float32))
    y, h = _old_inline(xs, dt, A, Bm, Cm, blk.D, h0)
    out = (y * F.silu(z)) @ blk.w_out
    return out, ({"h": h, "conv": new_conv} if state is not None else None)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_is_bit_equal_to_the_old_inline_scan(dtype):
    """The jamba SMOKE Mamba block, uncached over T = 13 and cached over
    single tokens and a 3-token chunk from a random state: out, h and the
    conv state equal the old forward's bit for bit."""
    cfg = dataclasses.replace(configs.get("jamba-1.5-large-398b")[1],
                              dtype=dtype)
    dt_ = getattr(torch, dtype)
    blk = Mamba(cfg, device="cpu", dtype=dt_)
    with torch.no_grad():
        blk.reset_parameters(torch.Generator().manual_seed(5))
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.standard_normal(
            (2, 13, cfg.d_model)).astype(np.float32)).to(dt_)
        got, _ = blk(x)
        want, _ = _old_block_forward(blk, x)
        assert torch.equal(got, want)
        Di, S, K, _ = _dims(cfg)
        state = {"h": torch.from_numpy(rng.standard_normal(
                     (2, Di, S)).astype(np.float32)),
                 "conv": torch.from_numpy(rng.standard_normal(
                     (2, K - 1, Di)).astype(np.float32)).to(dt_)}
        old = dict(state)
        for t0, t1 in ((0, 1), (1, 2), (2, 5)):
            got, state = blk(x[:, t0:t1], state)
            want, old = _old_block_forward(blk, x[:, t0:t1], old)
            assert torch.equal(got, want)
            assert torch.equal(state["h"], old["h"])
            assert torch.equal(state["conv"], old["conv"])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm, D, h0 = _torch(_inputs(2, 4, 8, 4, seed=4), "float32")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mamba_scan(x.half(), dt, A, Bm.half(), Cm.half(), D, h0)
    with pytest.raises(TypeError, match="Bm is torch.bfloat16"):
        mamba_scan(x, dt, A, Bm.bfloat16(), Cm, D, h0)
    with pytest.raises(TypeError, match="dt must be float32"):
        mamba_scan(x, dt.bfloat16(), A, Bm, Cm, D, h0)
    with pytest.raises(TypeError, match="h0 must be float32"):
        mamba_scan(x, dt, A, Bm, Cm, D, h0.double())
    with pytest.raises(TypeError, match="torch.Tensor"):
        mamba_scan(x, dt, A, Bm, Cm, 1.0, h0)
    with pytest.raises(ValueError, match=r"\[B, T, Di\]"):
        mamba_scan(x[0], dt, A, Bm, Cm, D, h0)
    with pytest.raises(ValueError, match="do not fit"):
        mamba_scan(x, dt, A, Bm[:, :, :3], Cm, D, h0)
    with pytest.raises(ValueError, match="do not fit"):
        mamba_scan(x, dt, A, Bm, Cm, D[:5], h0)
    with pytest.raises(ValueError, match="do not fit"):
        mamba_scan(x, dt[:, :3], A, Bm, Cm, D, h0)
    with pytest.raises(ValueError, match="x must be contiguous"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        mamba_scan(xt, dt, A, Bm, Cm, D, h0)
    with pytest.raises(ValueError, match="A must be contiguous"):
        mamba_scan(x, dt, A.t().contiguous().t(), Bm, Cm, D, h0)
    with pytest.raises(ValueError, match="rows of S must be contiguous"):
        Bt = Bm.transpose(1, 2).contiguous().transpose(1, 2)
        mamba_scan(x, dt, A, Bt, Cm, D, h0)
    with pytest.raises(ValueError, match="exceeds 32"):
        z = torch.zeros
        mamba_scan(x, dt, z(8, 33), z(2, 4, 33), z(2, 4, 33), D, z(2, 8, 33))
    with pytest.raises(ValueError, match=">= 1"):
        mamba_scan(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], D, h0)
    with pytest.raises(ValueError, match="schedule"):
        mamba_scan(x, dt, A, Bm, Cm, D, h0, schedule="chunked")
    with pytest.raises(TypeError, match="float32"):
        mamba_decay(dt.double(), A)
    with pytest.raises(ValueError, match="do not fit"):
        mamba_decay(dt[..., :5].contiguous(), A)


def test_cpu_calls_launch_nothing():
    """The plain versions on the CPU are no kernel launch, in either
    schedule."""
    t = _torch(_inputs(1, 4, 8, 4, seed=6), "float32")
    n, routes = mamba_scan.launches, dict(mamba_scan.route_launches)
    nd = mamba_decay.launches
    for schedule in ("auto", "decode", "prefill"):
        mamba_scan(*t, schedule=schedule)
    mamba_decay(t[1], t[2])
    assert mamba_scan.launches == n and mamba_scan.route_launches == routes
    assert mamba_decay.launches == nd


def test_decay_plain_is_torch_exp_of_the_rounded_product():
    x, dt, A, *_ = _torch(_inputs(2, 5, 12, 16, seed=7), "float32")
    a = mamba_decay(dt, A)
    assert a.shape == (2, 5, 12, 16)
    assert torch.equal(a, torch.exp(dt[..., None] * A))
    assert torch.equal(a, mamba_decay_ref(dt, A))


def test_h0_carries_the_state():
    """Two calls over parts of T, the second from the first's h, equal one
    call over the whole, bit for bit."""
    x, dt, A, Bm, Cm, D, h0 = _torch(_inputs(2, 10, 24, 8, seed=8),
                                     "float32")
    y, h = mamba_scan(x, dt, A, Bm, Cm, D, h0)
    parts = [mamba_scan(x[:, :4].contiguous(), dt[:, :4].contiguous(), A,
                        Bm[:, :4], Cm[:, :4], D, h0)]
    parts.append(mamba_scan(x[:, 4:].contiguous(), dt[:, 4:].contiguous(), A,
                            Bm[:, 4:], Cm[:, 4:], D, parts[0][1]))
    assert torch.equal(torch.cat([parts[0][0], parts[1][0]], dim=1), y)
    assert torch.equal(parts[1][1], h)


# -- on the card -------------------------------------------------------------

# jamba's Mamba decode (B 4, T 1, Di 16384, S 16), a 256-step prefill chunk
# at its width, and ragged shapes (T, Di off the tiles; S 1 .. 32; rows
# that are not whole 16-byte pieces)
CARD_CASES = [(4, 1, 16384, 16), (1, 256, 16384, 16), (2, 77, 100, 8),
              (1, 5, 64, 4), (3, 130, 33, 1), (2, 70, 50, 2), (1, 64, 40, 3),
              (2, 65, 70, 12), (1, 129, 31, 32), (2, 77, 48, 8),
              (5, 3, 40, 32), (1, 40, 96, 16)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    """Each schedule on every case, in both types: h bit for bit, y within
    CARD_TOL; the decay alone bit-equal to torch.exp; one launch a call,
    counted on its schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in DTYPES:
        for i, (B, T, Di, S) in enumerate(CARD_CASES):
            t = _torch(_inputs(B, T, Di, S, seed=100 + i), dtype, "cuda")
            yr, hr = mamba_scan_ref(*t)
            a = mamba_decay(t[1], t[2])
            assert torch.equal(a, torch.exp(t[1][..., None] * t[2]))
            for schedule in ("decode", "prefill"):
                n = mamba_scan.route_launches[schedule]
                y, h = mamba_scan(*t, schedule=schedule)
                torch.cuda.synchronize()
                assert mamba_scan.route_launches[schedule] == n + 1
                assert y.dtype == t[0].dtype and h.dtype == torch.float32
                ey = card_y_err(y, yr)
                assert torch.equal(h, hr), (dtype, B, T, Di, S, schedule)
                assert ey <= CARD_TOL[dtype], (dtype, B, T, Di, S, schedule,
                                               ey)


@pytest.mark.gpu
def test_mamba_block_on_card_is_one_fused_launch():
    """A Mamba block's forward on the card, uncached and cached, is one
    ``mamba_scan`` launch a call and no ``linear_scan`` launch, and agrees
    with the same block on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("jamba-1.5-large-398b")[1]
    cpu = Mamba(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        cpu.reset_parameters(torch.Generator().manual_seed(9))
        card = Mamba(cfg, device="cuda", dtype=torch.float32)
        card.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32))
        n, nl = mamba_scan.launches, linear_scan.launches
        got, _ = card(x.cuda())
        Di, S, K, _ = _dims(cfg)
        state = {"h": torch.zeros((2, Di, S), device="cuda"),
                 "conv": torch.zeros((2, K - 1, Di), device="cuda")}
        card(x[:, :1].cuda(), state)
        torch.cuda.synchronize()
        assert mamba_scan.launches == n + 2 and linear_scan.launches == nl
        want, _ = cpu(x)
        assert (got.cpu() - want).abs().max().item() <= 1e-4
