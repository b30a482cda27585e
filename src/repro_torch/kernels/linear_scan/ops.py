"""Wrapper of the linear-scan kernel, in the layout of
``repro/kernels/linear_scan/ops.py``: a, b [B, T, D, S], c [B, T, S], h0
[B, D, S].

A CUDA tensor goes to the hand-written kernel in ``csrc/linear_scan.cu``
(built on first use, launched on the current stream); a CPU tensor goes to
the plain version in :mod:`.ref`.  There is no other route: on a CUDA
tensor the wrapper launches the kernel or raises.  It counts its launches
in ``linear_scan.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import linear_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = build.load("linear_scan")
    lib.linear_scan.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P]
    lib.linear_scan.restype = ctypes.c_int
    return lib


def _check(a, b, c, h0) -> None:
    """Types, devices, contiguity and shapes of one call."""
    for name, x in (("a", a), ("b", b), ("c", c), ("h0", h0)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("b", b), ("c", c)):
        if x.dtype != a.dtype:
            raise TypeError(f"{name} is {x.dtype}, a is {a.dtype}")
    if a.dim() != 4:
        raise ValueError(f"a must be 4-D [B, T, D, S], got {tuple(a.shape)}")
    B, T, D, S = a.shape
    if (tuple(b.shape) != (B, T, D, S) or tuple(c.shape) != (B, T, S)
            or tuple(h0.shape) != (B, D, S)):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} and h0 {tuple(h0.shape)} do not "
                         "fit together (b [B, T, D, S], c [B, T, S], h0 "
                         "[B, D, S])")
    if min(a.shape) < 1:
        raise ValueError("every dimension must be >= 1")
    if S > MAX_STATE:
        raise ValueError(f"the state dimension {S} exceeds {MAX_STATE}")
    if B > 65535:
        raise ValueError(f"at most 65535 sequences a launch, got {B}")
    if D >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("T and D must be below 2**31")
    dev = a.device
    if dev.type == "cuda":
        if dev.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"tensors are on {dev}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def linear_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                h0: torch.Tensor):
    """a, b [B, T, D, S], c [B, T, S] (float32 or bfloat16, one type), h0
    [B, D, S] → (y [B, T, D] in a's type, h [B, D, S] float32): the
    recurrence ``h_t = a_t ⊙ h_{t−1} + b_t``, ``y_t[d] = Σ_s h_t[d, s] ·
    c_t[s]`` of :func:`.ref.linear_scan_ref`, with S at most 32."""
    _check(a, b, c, h0)
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, c, h0)
    B, T, D, S = a.shape
    h0 = h0.float()
    y = torch.empty((B, T, D), dtype=a.dtype, device=a.device)
    h = torch.empty((B, D, S), dtype=torch.float32, device=a.device)
    err = _lib().linear_scan(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), _DTYPES[a.dtype], B, T, D, S,
        torch.cuda.current_stream().cuda_stream)
    linear_scan.launches += 1
    if err != 0:
        raise RuntimeError(f"linear_scan launch failed: cudaError {err}")
    return y, h


linear_scan.launches = 0
