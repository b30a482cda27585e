"""Wrappers of the flash-attention kernel, in the model layout
[B, T, H, d] (:func:`flash_attention`, as ``repro/kernels/flash_attention/
ops.py`` takes it) and in the kernel layout [BH, T, d]
(:func:`flash_attention_flat`).

A CUDA tensor goes to one of three hand-written kernels (built on first
use, launched on the current stream), chosen before the launch by
:func:`select_route` from the call's dtype, Tq, d, dv and the 16-byte
alignment of its pointers and strides:

- ``"prefill"``, ``csrc/flash_prefill.cu``: bf16 on the tensor cores
  (wgmma, TMA), Tq > ``DECODE_MAX_TQ``, (d, dv) in ``PREFILL_PAIRS``: 64
  and 128 with dv = d, MLA's (192, 128) and hubert's (80, 80), the last
  run at width 128 over zero-filled columns;
- ``"decode"``, ``csrc/flash_decode.cu``: Tq <= ``DECODE_MAX_TQ``, float32
  or bf16 with d = dv and a row of ``DECODE_ROW_BYTES``, or bf16 (d, dv)
  in ``DECODE_BF16_PAIRS`` (MLA's (192, 128)), split over the keys;
- ``"simple"``, ``csrc/flash_attention.cu``: everything else (float32 at
  prefill lengths, other head dims, unaligned tensors).

A CPU tensor goes to the plain version in :mod:`.ref`.  There is no other
route: on a CUDA tensor the wrappers launch the chosen kernel or raise,
and no route gives way to another.  Both wrappers count their launches in
``flash_attention.launches`` and, per route, in
``flash_attention.route_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

from .ref import flash_attention_ref, live_keys, split_plan

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
ROUTES = ("prefill", "decode", "simple")
DECODE_MAX_TQ = 16            # query positions a call for the decode route
DECODE_ROW_BYTES = (64, 128, 256, 512)   # d = dv: 4–32 lanes of 16 bytes
DECODE_BF16_PAIRS = ((192, 128),)        # (d, dv): 8 lanes, 3 / 2 chunks
PREFILL_PAIRS = ((64, 64), (128, 128), (192, 128), (80, 80))   # bf16
DECODE_MAX_SPLITS = 16        # csrc/flash_decode.cu MAX_SPLITS
DECODE_KEY_TILE = 32          # keys a row group's batch in flash_decode.cu
# per-device merge counters, one a block column (B·Hkv·row chunks): enough
# for B·H <= 65535 and Tq <= 16 at 4 rows a block
_DECODE_COUNTERS = 1 << 19

#: route → (library, C function, argtypes)
_SIGNATURES = {
    "simple": ("flash_attention", "flash_attention",
               [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _S, _I, _I,
                _F, _P]),
    "prefill": ("flash_prefill", "flash_prefill",
                [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _S, _I, _I,
                 _F, _P]),
    "decode": ("flash_decode", "flash_decode",
               [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _S,
                _I, _I, _I, _I, _I, _I, _I, _F, _P]),
}


@functools.lru_cache(maxsize=None)
def _fn(route: str):
    """The C function of ``route``'s kernel, built on first use."""
    lib_name, fn_name, argtypes = _SIGNATURES[route]
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def select_route(dtype: torch.dtype, Tq: int, d: int, dv: int,
                 aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"prefill"``, ``"decode"`` or
    ``"simple"`` (module docstring).  ``aligned``: every pointer and every
    (b, h, t) stride of q, k, v and out is a multiple of 16 bytes."""
    if not aligned:
        return "simple"
    bf16 = dtype == torch.bfloat16
    if Tq <= DECODE_MAX_TQ:
        row_bytes = d * (2 if bf16 else 4)
        if d == dv and row_bytes in DECODE_ROW_BYTES \
                or bf16 and (d, dv) in DECODE_BF16_PAIRS:
            return "decode"
        return "simple"
    if bf16 and (d, dv) in PREFILL_PAIRS:
        return "prefill"
    return "simple"


def decode_rows(n_rep: int, Tq: int) -> Tuple[int, int]:
    """(rows a decode block, row chunks a KV group) for n_rep·Tq rows."""
    rows = n_rep * Tq
    rc = 4 if rows <= 4 else 8
    return rc, -(-rows // rc)


def decode_splits(kend: int, blocks: int, sms: int) -> int:
    """Splits of the ``kend`` live keys for ``blocks`` decode blocks (B·Hkv
    × row chunks) on ``sms`` SMs: about sms / blocks key ranges of whole
    32-key tiles, so that blocks × splits covers the SMs where the keys
    allow it, and at most ``DECODE_MAX_SPLITS``."""
    tiles = -(-kend // DECODE_KEY_TILE)
    want = max(1, -(-sms // blocks))
    per = max(1, tiles // want, -(-tiles // DECODE_MAX_SPLITS))
    return -(-kend // (per * DECODE_KEY_TILE))


@functools.lru_cache(maxsize=4096)
def _decode_plan(index: int, B: int, H: int, Hkv: int, Tq: int, Tk: int,
                 causal: bool, kv_len: Optional[int]):
    """(kend, rows a block, row chunks, blocks, splits, keys a split) of a
    decode launch on device ``index``."""
    kend = live_keys(Tq, Tk, causal, kv_len)
    rc, nchunks = decode_rows(H // Hkv, Tq)
    blocks = B * Hkv * nchunks
    if blocks > _DECODE_COUNTERS:
        raise ValueError(f"{blocks} decode blocks a launch, at most "
                         f"{_DECODE_COUNTERS}")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    splits, kps = split_plan(kend, decode_splits(kend, blocks, sms))
    return kend, rc, nchunks, blocks, splits, kps


_counters: Dict[int, torch.Tensor] = {}


def _decode_counters(index: int, device: torch.device) -> torch.Tensor:
    """Device ``index``'s merge counters, zeroed once; each launch leaves
    them 0.  Calls on one device must not overlap on two streams."""
    if index not in _counters:
        _counters[index] = torch.zeros(_DECODE_COUNTERS, dtype=torch.int32,
                                       device=device)
    return _counters[index]


def _check(q, k, v, kv_len, ndim: int) -> Optional[int]:
    """Types, devices, contiguity and shapes of one call (``ndim`` 4: the
    model layout, 3: the kernel layout); returns ``kv_len`` as an int."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape "
                             f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # heads and batch of the model layout; the kernel layout is B = 1
    bq, bk = ((q.shape[0], q.shape[2]), (k.shape[0], k.shape[2])) \
        if ndim == 4 else ((1, q.shape[0]), (1, k.shape[0]))
    if k.shape[:-1] != v.shape[:-1] or bq[0] != bk[0]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError(f"k's head dim {k.shape[-1]} != q's {q.shape[-1]}")
    if bk[1] < 1 or bq[1] % bk[1]:
        raise ValueError(f"{bq[1]} query heads do not share {bk[1]} key/value "
                         "heads evenly")
    if min(q.shape) < 1 or min(k.shape) < 1 or min(v.shape) < 1:
        raise ValueError("every dimension must be >= 1")
    if max(q.shape[-1], v.shape[-1]) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {q.shape[-1]}/{v.shape[-1]} exceed "
                         f"{MAX_HEAD_DIM}")
    if bq[0] * bq[1] > 65535:
        raise ValueError(f"at most 65535 (batch x head) rows a launch, got "
                         f"{bq[0] * bq[1]}")
    if max(q.shape[1], k.shape[1]) >= 2 ** 31:     # T: axis 1 in both layouts
        raise ValueError("sequence lengths must be below 2**31")
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor):
            raise TypeError("kv_len must be a Python int, not a tensor")
        kv_len = operator.index(kv_len)
        if kv_len < 0:
            raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    dev = q.device
    if dev.type == "cuda":
        if dev.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"tensors are on {dev}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return kv_len


def _launch(q, k, v, out, B: int, H: int, Hkv: int, Tq: int, Tk: int,
            strides, causal: bool, kv_len: Optional[int]) -> None:
    """One launch of the route :func:`select_route` picks; ``strides``: the
    (b, h, t) element strides of q, k, v, out."""
    d, dv = q.shape[-1], v.shape[-1]
    esize = q.element_size()
    aligned = (all(x.data_ptr() % 16 == 0 for x in (q, k, v, out))
               and all(s * esize % 16 == 0 for s in strides))
    route = select_route(q.dtype, Tq, d, dv, aligned)
    kv = min(Tk if kv_len is None else kv_len, 2 ** 31 - 1)
    arr = (ctypes.c_longlong * 12)(*strides)
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if route == "prefill":
        err = _fn(route)(*ptrs, B, H, Hkv, Tq, Tk, d, dv, arr, int(causal),
                         kv, scale, stream)
    elif route == "decode":
        index = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        kend, rc, nchunks, blocks, splits, kps = _decode_plan(
            index, B, H, Hkv, Tq, Tk, causal, kv_len)
        # the splits' (acc, m, l): acc is dv wide
        part = torch.empty(blocks * splits * rc * (dv + 2) if splits > 1
                           else 1, dtype=torch.float32, device=q.device)
        ml = part.data_ptr() + 4 * blocks * splits * rc * dv
        err = _fn(route)(*ptrs, part.data_ptr(), ml,
                         _decode_counters(index, q.device).data_ptr(),
                         _DTYPES[q.dtype], B, H, Hkv, Tq, d, dv, arr,
                         int(causal), kv, kend, splits, kps, rc, nchunks,
                         scale, stream)
    else:
        err = _fn(route)(*ptrs, _DTYPES[q.dtype], B, H, Hkv, Tq, Tk, d, dv,
                         arr, int(causal), kv, scale, stream)
    if err == -1:
        raise RuntimeError("flash_attention (prefill): the driver's "
                           "cuTensorMapEncodeTiled was not found")
    if err <= -1000:
        raise RuntimeError(f"flash_attention (prefill): the driver refused a "
                           f"tensor map, CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"flash_attention ({route}) launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q [B, Tq, H, d], k [B, Tk, Hkv, d], v [B, Tk, Hkv, dv] (float32 or
    bfloat16, contiguous) → [B, Tq, H, dv]: attention with query head h
    reading key/value head ``h // (H // Hkv)``, keys ``j < kv_len`` (all
    when None) and, if ``causal``, ``j <=`` the query's position; the
    conventions of :func:`.ref.flash_attention_ref`."""
    kv_len = _check(q, k, v, kv_len, ndim=4)
    B, Tq, H, d = q.shape
    _, Tk, Hkv, dv = v.shape
    if q.device.type == "cpu":
        def flat(x):
            return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])
        o = flash_attention_ref(flat(q), flat(k), flat(v), causal=causal,
                                kv_len=kv_len)
        return o.reshape(B, H, Tq, dv).transpose(1, 2).contiguous()
    out = torch.empty((B, Tq, H, dv), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out)
               for s in (x.stride(0), x.stride(2), x.stride(1))]
    _launch(q, k, v, out, B, H, Hkv, Tq, Tk, strides, causal, kv_len)
    return out


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """The kernel layout: q [BH, Tq, d], k [BHkv, Tk, d], v [BHkv, Tk, dv]
    → [BH, Tq, dv], query row b reading key/value row ``b // (BH //
    BHkv)``, as ``flash_attention_kernel`` of the JAX package takes it."""
    kv_len = _check(q, k, v, kv_len, ndim=3)
    BH, Tq, d = q.shape
    BHkv, Tk, dv = v.shape
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    out = torch.empty((BH, Tq, dv), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out) for s in (0, x.stride(0), x.stride(1))]
    _launch(q, k, v, out, 1, BH, BHkv, Tq, Tk, strides, causal, kv_len)
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
