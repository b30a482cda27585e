"""The PyTorch package's flash attention against the JAX package's.

On the CPU the wrappers run their plain PyTorch version; it is held
against the JAX package's ``flash_attention_ref`` oracle and its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs them, within
that file's tolerances: 2e-5 in float32 and 2e-2 in bfloat16 (both sides
compute in float32; ``exp`` and the order of the sums differ, and bfloat16
output rounds once at the end).  At ``kv_len = 0`` (no live key) the
interpret-mode kernel, not the ``-inf`` oracle (NaN there), fixes the
semantics: every score is −1e30, so the row averages all values.  The
route table (which of the three CUDA kernels a call takes) and the decode
kernel's split arithmetic (``flash_attention_split_ref``) are checked here
too.  The ``gpu``-marked test holds each CUDA kernel against the plain
version on the card.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (decode_rows, decode_splits,
                                                 flash_attention,
                                                 flash_attention_flat,
                                                 flash_attention_ref,
                                                 flash_attention_split_ref,
                                                 live_keys, select_route,
                                                 split_plan)

ATTN_CASES = [
    # B, Tq, Tk, H, Hkv, d, dv, causal   (tests/test_kernels.py:13)
    (2, 128, 128, 4, 2, 64, 64, True),
    (1, 256, 256, 8, 8, 128, 128, True),
    (2, 128, 256, 4, 1, 64, 32, False),
    (1, 64, 512, 2, 2, 128, 128, False),
    (1, 128, 128, 16, 4, 192, 128, True),   # MLA-like dk≠dv
    (1, 128, 128, 4, 4, 80, 80, False),     # hubert-like: d 80, non-causal
]

KV_CASES = [
    # B, Tq, Tk, H, Hkv, d, dv, causal, kv_len: decode (Tq = 1, Tk off the
    # 64-multiples), a short chunk, kv_len = 0, and kv_len with causal
    (2, 1, 97, 6, 2, 32, 32, False, 50),
    (2, 1, 97, 6, 2, 32, 32, False, 97),
    (1, 1, 192, 6, 2, 64, 64, False, 1),
    (2, 1, 100, 4, 4, 48, 16, False, 100),
    (2, 3, 77, 4, 2, 32, 32, False, 40),
    (2, 1, 97, 6, 2, 32, 32, False, 0),
    (1, 64, 64, 4, 2, 32, 48, True, 0),
    (1, 64, 128, 4, 2, 64, 64, True, 40),
    (2, 1, 97, 4, 4, 192, 128, False, 60),  # MLA decode: d 192, dv 128
]

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the serve path's shapes: B, Tq, Tk, H, Hkv, d, dv (llama; jamba has 64
# query heads over 8, same head_dim)
MAIN_DECODE = (4, 1, 192, 24, 8, 128, 128)
MAIN_PREFILL = (1, 4096, 4096, 24, 8, 128, 128)

# (Tq, d, dv) → route for bfloat16 / float32, every pointer and stride
# 16-byte aligned
ROUTE_TABLE = [
    *[((c[1], c[5], c[6]), r) for c, r in zip(ATTN_CASES, [
        ("prefill", "simple"), ("prefill", "simple"), ("simple", "simple"),
        ("prefill", "simple"), ("prefill", "simple"),
        ("prefill", "simple")])],
    *[((c[1], c[5], c[6]), r) for c, r in zip(KV_CASES, [
        ("decode", "decode"), ("decode", "decode"), ("decode", "decode"),
        ("simple", "simple"), ("decode", "decode"), ("decode", "decode"),
        ("simple", "simple"), ("prefill", "simple"), ("decode", "simple")])],
    ((1, 128, 128), ("decode", "decode")),           # MAIN_DECODE
    ((4096, 128, 128), ("prefill", "simple")),       # MAIN_PREFILL
    ((4095, 128, 128), ("prefill", "simple")),
    ((16, 128, 128), ("decode", "decode")),           # DECODE_MAX_TQ
    ((17, 128, 128), ("prefill", "simple")),
    ((3, 36, 20), ("simple", "simple")),    # d ≠ dv
    ((70, 256, 256), ("simple", "simple")),
    ((5, 192, 128), ("decode", "simple")),   # MLA: bf16 only
    ((1, 192, 128), ("decode", "simple")),
    ((16, 192, 128), ("decode", "simple")),
    ((17, 192, 128), ("prefill", "simple")),
    ((4096, 192, 128), ("prefill", "simple")),
    ((4096, 80, 80), ("prefill", "simple")),   # hubert
    ((17, 80, 80), ("prefill", "simple")),
    ((1, 80, 80), ("simple", "simple")),       # 160 / 320-byte rows
    ((4096, 128, 192), ("simple", "simple")),
    ((1, 128, 192), ("simple", "simple")),
    ((4096, 192, 192), ("simple", "simple")),
    ((1, 256, 256), ("decode", "simple")),   # 1,024-byte float32 rows
    ((1, 96, 96), ("simple", "simple")),     # 192 / 384-byte rows
    ((1, 16, 16), ("simple", "decode")),     # 32 / 64-byte rows
    ((77, 96, 96), ("simple", "simple")),
]


@pytest.fixture(scope="module")
def jfa():
    """The JAX package's flash attention.  Imported here, not at the top, so
    the ``gpu`` test also runs where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro.kernels.flash_attention.kernel import flash_attention_kernel
    from repro.kernels.flash_attention.ref import flash_attention_ref as jref
    return jnp, jflash, flash_attention_kernel, jref


def _inputs(B, Tq, Tk, H, Hkv, d, dv, seed):
    """q [B, Tq, H, d], k [B, Tk, Hkv, d], v [B, Tk, Hkv, dv] float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, d)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, d)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, dv)).astype(np.float32))


def _flat(x):
    """[B, T, H, d] → [B·H, T, d] (numpy)."""
    return np.ascontiguousarray(np.moveaxis(x, 2, 1).reshape(
        -1, x.shape[1], x.shape[3]))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(case, dtype, jfa):
    jnp, _, _, jref = jfa
    B, Tq, Tk, H, Hkv, d, dv, causal = case
    q, k, v = (_flat(x) for x in _inputs(B, Tq, Tk, H, Hkv, d, dv, seed=1))
    want = jref(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
                causal=causal)
    got = flash_attention_flat(*(_torch(x, dtype) for x in (q, k, v)),
                               causal=causal)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_matches_jax_kernel(case, dtype, jfa):
    """The model-layout wrapper against the JAX wrapper (interpret mode)."""
    jnp, jflash, _, _ = jfa
    B, Tq, Tk, H, Hkv, d, dv, causal = case
    q, k, v = _inputs(B, Tq, Tk, H, Hkv, d, dv, seed=2)
    want = jflash(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
                  causal=causal, bq=64, bk=64)
    got = flash_attention(*(_torch(x, dtype) for x in (q, k, v)),
                          causal=causal)
    assert got.shape == (B, Tq, H, dv)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", KV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_len_matches_jax_kernel(case, dtype, jfa):
    """Decode shapes with a scalar ``kv_len`` against the JAX kernel in
    interpret mode (one tile over the whole of Tq and Tk, which the TPU
    kernel needs when Tk is not a multiple of its tile)."""
    jnp, _, jkernel, _ = jfa
    B, Tq, Tk, H, Hkv, d, dv, causal, kv_len = case
    q, k, v = (_flat(x) for x in _inputs(B, Tq, Tk, H, Hkv, d, dv, seed=3))
    want = jkernel(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
                   causal=causal, bq=Tq, bk=Tk, kv_len=kv_len, interpret=True)
    got = flash_attention_flat(*(_torch(x, dtype) for x in (q, k, v)),
                               causal=causal, kv_len=kv_len)
    _close(got, want, dtype)
    if kv_len == 0:       # no live key: the mean of all Tk values
        vt = _torch(v, dtype).float().repeat_interleave(H // Hkv, dim=0)
        mean = vt.mean(dim=1, keepdim=True).expand(-1, Tq, -1)
        _close(got, mean.numpy(), dtype)


def test_model_layout_equals_kernel_layout():
    """The two wrappers are one function: [B, T, H, d] in, [B, T, H, dv]
    out, equal to the kernel layout's rows moved back."""
    B, Tq, Tk, H, Hkv, d, dv = 2, 5, 33, 6, 2, 16, 24
    q, k, v = _inputs(B, Tq, Tk, H, Hkv, d, dv, seed=4)
    for causal, kv_len in ((True, None), (False, 20), (False, 0)):
        a = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal, kv_len=kv_len)
        b = flash_attention_flat(*(torch.from_numpy(_flat(x))
                                   for x in (q, k, v)),
                                 causal=causal, kv_len=kv_len)
        assert torch.equal(a, b.reshape(B, H, Tq, dv).transpose(1, 2))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 8, 4, 2, 16, 16, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="is torch.bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="evenly"):
        flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :8].contiguous(), k, v)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k, v[:, :7].contiguous())
    with pytest.raises(ValueError, match="exceed 256"):
        big = torch.zeros(1, 2, 2, 264)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="kv_len must be >= 0"):
        flash_attention(q, k, v, kv_len=-1)
    with pytest.raises(TypeError, match="Python int"):
        flash_attention(q, k, v, kv_len=torch.tensor(3))
    with pytest.raises(ValueError, match="65535"):
        flash_attention_flat(torch.zeros(65536, 1, 4), torch.zeros(1, 1, 4),
                             torch.zeros(1, 1, 4))


def test_cpu_calls_launch_nothing():
    """The plain version on the CPU is not a kernel launch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 8, 4, 2, 16, 16, 6))
    n = flash_attention.launches
    flash_attention(q, k, v)
    flash_attention_flat(_flat_t(q), _flat_t(k), _flat_t(v))
    assert flash_attention.launches == n


def _flat_t(x):
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]).contiguous()


@pytest.mark.parametrize("shape, routes", ROUTE_TABLE)
def test_route_table(shape, routes):
    """The route is a pure function of (dtype, Tq, d, dv, alignment); the
    main path's shapes (bf16: d = dv = 128, MLA's d 192 / dv 128, hubert's
    d = dv = 80 at prefill) take the prefill and decode kernels, and an
    unaligned call the simple one."""
    Tq, d, dv = shape
    for dtype, want in zip((torch.bfloat16, torch.float32), routes):
        assert select_route(dtype, Tq, d, dv) == want, (dtype, shape)
        assert select_route(dtype, Tq, d, dv, aligned=False) == "simple"


@pytest.mark.parametrize("kv_len, heads, want", [
    (192, (24, 8), 6), (97, (24, 8), 4), (1, (24, 8), 1),
    (192, (64, 8), 6), (97, (64, 8), 4), (0, (24, 8), 6)])
def test_decode_splits_cover_the_card(kv_len, heads, want):
    """At the decode shape (B 4, a 192-key cache) 32 groups take 4–6 key
    splits of whole 32-key tiles: B·Hkv·splits covers an H100's 132 SMs
    where the keys allow it; no split is empty, and the splits cover the
    live keys exactly."""
    B, Tq, Tk, _, _, d, dv = MAIN_DECODE
    H, Hkv = heads
    kend = live_keys(Tq, Tk, False, kv_len)
    rc, chunks = decode_rows(H // Hkv, Tq)
    assert chunks == 1 and rc >= H // Hkv
    n, kps = split_plan(kend, decode_splits(kend, B * Hkv * chunks, 132))
    assert n == want
    assert (n - 1) * kps < kend <= n * kps
    if kend >= 6 * 32:
        assert B * Hkv * n >= 132


def test_decode_splits_bounded():
    """Many keys over few groups: at most 16 splits of whole tiles."""
    for kend, blocks in ((4096, 1), (100_000, 2), (33, 1), (5000, 200)):
        n, kps = split_plan(kend, decode_splits(kend, blocks, 132))
        assert 1 <= n <= 16 and (n - 1) * kps < kend <= n * kps


@functools.lru_cache(maxsize=None)
def _kv_case_jax(case, dtype, jfa):
    """The JAX kernel (interpret mode) at a KV_CASES entry, kernel layout,
    with the inputs it was given (numpy float32)."""
    jnp, _, jkernel, _ = jfa
    B, Tq, Tk, H, Hkv, d, dv, causal, kv_len = case
    q, k, v = (_flat(x) for x in _inputs(B, Tq, Tk, H, Hkv, d, dv, seed=7))
    want = jkernel(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
                   causal=causal, bq=Tq, bk=Tk, kv_len=kv_len, interpret=True)
    return (q, k, v), np.asarray(want, np.float32)


@pytest.mark.parametrize("splits", [1, 2, 1000])
@pytest.mark.parametrize("case", KV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_arithmetic_matches(case, splits, dtype, jfa):
    """The decode kernel's arithmetic — per-split (m, l, acc), merged in
    split order — against the plain version and the JAX kernel in
    interpret mode: one split, two, and more splits than keys (each key
    its own split), kv_len = 0 included."""
    B, Tq, Tk, H, Hkv, d, dv, causal, kv_len = case
    (q, k, v), want = _kv_case_jax(case, dtype, jfa)
    args = [_torch(x, dtype) for x in (q, k, v)]
    got = flash_attention_split_ref(*args, causal=causal, kv_len=kv_len,
                                    splits=splits)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    _close(got, flash_attention_ref(*args, causal=causal, kv_len=kv_len)
           .float().numpy(), dtype)


@pytest.mark.parametrize("T", [256, 1024])
def test_p_rounded_to_bf16_stays_in_tolerance(T, jfa):
    """The prefill kernel's one new rounding, P to bf16 before the PV
    product (l from the unrounded p), at a causal d = 128 case: within the
    bf16 tolerance of the JAX package's oracle."""
    jnp, _, _, jref = jfa
    q, k, v = (_flat(x) for x in _inputs(1, T, T, 4, 2, 128, 128, seed=8))
    qt, kt, vt = (_torch(x, "bfloat16") for x in (q, k, v))
    got = flash_attention_ref(qt, kt, vt, causal=True, round_p=True)
    want = jref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                causal=True)
    _close(got, want, "bfloat16")
    assert not torch.equal(got, flash_attention_ref(qt, kt, vt, causal=True))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` loaded as a module (its checks' constants and
    inputs; nothing runs)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", [
    # B, Tq, Tk, H, d, dv, causal
    (1, 256, 256, 2, 80, 80, False),     # hubert prefill
    (1, 256, 256, 2, 192, 128, True),    # MLA prefill
    (4, 1, 192, 2, 192, 128, False),     # MLA decode
])
def test_family_check_catches_planted_faults(case):
    """``chip_smoke.py``'s limit at the new families' shapes, min(2e-2,
    FAMILY_REL x max|plain|): p rounded to bf16 before PV (the prefill
    kernel's one extra rounding) stays within it, and each of
    ``planted_faults``' inputs, through the plain version, breaks it."""
    smoke = _chip_smoke()
    B, Tq, Tk, H, d, dv, causal = case
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g).bfloat16()
               for shape in ((B * H, Tq, d), (B * H, Tk, d), (B * H, Tk, dv)))
    ref = flash_attention_ref(q, k, v, causal=causal).float()
    limit = min(smoke.FLASH_TOL[torch.bfloat16],
                smoke.FAMILY_REL * float(ref.abs().max()))
    rounded = flash_attention_ref(q, k, v, causal=causal, round_p=True)
    assert float((rounded.float() - ref).abs().max()) <= limit
    for fault, args in smoke.planted_faults(q, k, v).items():
        got = flash_attention_ref(*args, causal=causal).float()
        assert float((got - ref).abs().max()) > limit, fault


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    """Kernel vs plain version on the card, in both types, at the serve
    path's decode shape (B = 4, 24 heads over 8, Tq = 1 against a 192-key
    cache), a causal prefill, ragged tiles, d ≠ dv, n_rep = 1, and
    kv_len = 0; then each route: the prefill route at ragged Tq (77, 130,
    4095), the decode route at n_rep 1, 3 and 8, both at kv_len 0, 1,
    mid-cache and full; both layouts bit-equal, and the per-route counters
    showing which kernel served each call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(4, 1, 192, 24, 8, 128, 128, False, 97),
             (4, 1, 192, 24, 8, 128, 128, False, 192),
             (1, 1024, 1024, 24, 8, 128, 128, True, None),
             (2, 77, 77, 4, 2, 64, 64, True, None),
             (1, 5, 300, 6, 6, 192, 128, False, 250),
             (1, 70, 70, 16, 4, 256, 256, True, None),
             (2, 3, 50, 4, 2, 36, 20, False, 0)]
    # prefill route (bf16): ragged Tq, n_rep 1 / 3 / 8, kv_len masks, d 64
    cases += [(2, 77, 77, 6, 2, 128, 128, True, None),
              (1, 130, 300, 8, 1, 128, 128, False, 200),
              (1, 4095, 4095, 8, 8, 128, 128, True, None),
              (1, 130, 130, 8, 8, 128, 128, True, 0),
              (1, 130, 130, 8, 1, 128, 128, False, 1),
              (1, 300, 300, 3, 1, 128, 128, True, 150),
              (2, 200, 200, 4, 2, 64, 64, False, None)]
    # decode route: n_rep 1 / 3 / 8, kv_len 0 / 1 / mid / full, Tq up to 16
    cases += [(4, 1, 192, 8, 8, 128, 128, False, kv) for kv in (0, 1, 97)]
    cases += [(4, 1, 192, 64, 8, 128, 128, False, kv)
              for kv in (0, 1, 97, 192)]
    cases += [(2, 16, 1000, 24, 8, 128, 128, False, 700),
              (1, 16, 16, 24, 8, 128, 128, True, None),
              (1, 1, 4096, 32, 1, 128, 128, False, 4000)]
    # MLA (d 192, dv 128) and hubert (d = dv = 80) on the prefill route
    # (bf16): Tq and Tk off the 128-row tiles, kv_len 0 and below Tk
    cases += [(1, 200, 200, 4, 4, 192, 128, True, None),
              (2, 77, 300, 3, 1, 192, 128, True, 250),
              (1, 130, 130, 4, 4, 192, 128, False, 0),
              (1, 300, 300, 4, 4, 80, 80, False, None),
              (2, 77, 200, 3, 3, 80, 80, False, 150),
              (1, 130, 130, 2, 2, 80, 80, False, 0),
              (1, 129, 129, 2, 1, 80, 80, True, None)]
    # MLA on the decode route (bf16): B 4, 16 heads, a 192-key cache (3
    # key splits), kv_len 0 / 1 / mid / full (Tq 5, eight rows a block:
    # the first list's (1, 5, 300, 6, 6, 192, 128) case)
    cases += [(4, 1, 192, 16, 16, 192, 128, False, kv)
              for kv in (0, 1, 97, 192)]
    counts = flash_attention.route_launches
    for dtype in ("float32", "bfloat16"):
        for B, Tq, Tk, H, Hkv, d, dv, causal, kv_len in cases:
            q, k, v = (_torch(x, dtype).cuda() for x in
                       _inputs(B, Tq, Tk, H, Hkv, d, dv, seed=Tq * Tk))
            route = select_route(getattr(torch, dtype), Tq, d, dv)
            n, before = flash_attention.launches, dict(counts)
            got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
            flat = flash_attention_flat(_flat_t(q), _flat_t(k), _flat_t(v),
                                        causal=causal, kv_len=kv_len)
            torch.cuda.synchronize()
            assert flash_attention.launches == n + 2
            assert {r: counts[r] - before[r] for r in counts} == {
                r: 2 * (r == route) for r in counts}, (dtype, Tq, d, dv)
            want = flash_attention_ref(_flat_t(q), _flat_t(k), _flat_t(v),
                                       causal=causal, kv_len=kv_len)
            want = want.reshape(B, H, Tq, dv).transpose(1, 2)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dtype], (dtype, route, B, Tq, Tk, H, Hkv, err)
            assert torch.equal(flat.reshape(B, H, Tq, dv).transpose(1, 2), got)
            if kv_len == 0:       # no live key: the mean of all Tk values
                mean = v.float().repeat_interleave(H // Hkv, dim=2) \
                    .mean(dim=1, keepdim=True)
                assert (got.float() - mean).abs().max().item() <= TOL[dtype]
    assert counts["prefill"] > 0 and counts["decode"] > 0


def test_mla_decode_splits_the_keys():
    """MLA's decode shape (B 4, 16 heads over 16, one token against a
    192-key cache) runs in more than one key split, so the card test's
    (192, 128) decode cases hold the merge across splits."""
    kend = live_keys(1, 192, False, 192)
    rc, chunks = decode_rows(1, 1)
    n, kps = split_plan(kend, decode_splits(kend, 4 * 16 * chunks, 132))
    assert (rc, chunks, n, kps) == (4, 1, 3, 64)
