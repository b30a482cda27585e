"""Wrappers of the flash-attention kernel, in the model layout
[B, T, H, d] (:func:`flash_attention`, as ``repro/kernels/flash_attention/
ops.py`` takes it) and in the kernel layout [BH, T, d]
(:func:`flash_attention_flat`).

A CUDA tensor goes to the hand-written kernel in
``csrc/flash_attention.cu`` (built on first use, launched on the current
stream); a CPU tensor goes to the plain version in :mod:`.ref`.  There is
no other route: on a CUDA tensor the wrappers launch the kernel or raise.
Both count their launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import Optional

import torch

from repro_torch.kernels import build

from .ref import flash_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, ctypes.POINTER(ctypes.c_longlong),
                                    _I, _I, ctypes.c_float, _P]
    lib.flash_attention.restype = ctypes.c_int
    return lib


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
    """One launch; ``strides``: the (b, h, t) element strides of q, k, v,
    out."""
    d, dv = q.shape[-1], v.shape[-1]
    arr = (ctypes.c_longlong * 12)(*strides)
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, H, Hkv, Tq, Tk, d, dv, arr, int(causal),
        min(Tk if kv_len is None else kv_len, 2 ** 31 - 1), 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream)
    flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")


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
