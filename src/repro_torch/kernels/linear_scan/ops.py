"""Wrappers of the linear-scan and Mamba-scan kernels.

``linear_scan`` takes the layout of ``repro/kernels/linear_scan/ops.py``:
a, b [B, T, D, S], c [B, T, S], h0 [B, D, S].  ``mamba_scan`` takes a
Mamba layer's own tensors (x, Δ, A, B, C, D, h0) and forms the decay and
the input itself (``csrc/mamba_scan.cu``); it is what the Mamba blocks
call.

A CUDA tensor goes to the hand-written kernel in ``csrc/`` (built on first
use, launched on the current stream); a CPU tensor goes to the plain
version in :mod:`.ref`.  There is no other route: on a CUDA tensor a
wrapper launches its kernel or raises.  Each counts its launches in
``<wrapper>.launches``; ``mamba_scan.route_launches`` also counts them by
schedule.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import linear_scan_ref, mamba_decay_ref, mamba_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32
#: the Mamba scan's schedules, by the C interface's number
SCHEDULES = {"decode": 0, "prefill": 1}
#: the longest T that ``mamba_scan`` gives the decode schedule: on an H100
#: the prefill schedule is faster from T = 2 (``chip_smoke.py`` phase 3
#: times both at T = 1 .. 64, B 1 and 4)
DECODE_MAX_T = 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = build.load("linear_scan")
    lib.linear_scan.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P]
    lib.linear_scan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _mamba_lib() -> ctypes.CDLL:
    """The Mamba-scan library, built on first use, with its C signatures."""
    lib = build.load("mamba_scan")
    lib.mamba_scan.argtypes = [_P] * 9 + [_I] * 5 + [_L] * 4 + [_I, _P]
    lib.mamba_scan.restype = ctypes.c_int
    lib.mamba_decay.argtypes = [_P, _P, _P, _L, _I, _I, _P]
    lib.mamba_decay.restype = ctypes.c_int
    return lib


def _check_device(dev: torch.device) -> None:
    """A CUDA device must be the current one; CUDA and the CPU only."""
    if dev.type == "cuda":
        if dev.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"tensors are on {dev}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


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
    _check_device(a.device)


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


def _check_mamba(x, dt, A, Bm, Cm, D, h0) -> None:
    """Types, devices, layouts and shapes of one ``mamba_scan`` call."""
    named = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "h0": h0}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    dev = x.device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name in ("Bm", "Cm"):
        if named[name].dtype != x.dtype:
            raise TypeError(f"{name} is {named[name].dtype}, x is {x.dtype}")
    for name in ("dt", "A", "D", "h0"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got "
                            f"{named[name].dtype}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be [B, T, Di] and A [Di, S], got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    B, T, Di = x.shape
    S = A.shape[1]
    if (dt.shape, A.shape, Bm.shape, Cm.shape, D.shape, h0.shape) != (
            (B, T, Di), (Di, S), (B, T, S), (B, T, S), (Di,), (B, Di, S)):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
            f"{tuple(D.shape)} and h0 {tuple(h0.shape)} do not fit together "
            "(dt [B, T, Di], A [Di, S], Bm and Cm [B, T, S], D [Di], h0 "
            "[B, Di, S])")
    if min(B, T, Di, S) < 1:
        raise ValueError("every dimension must be >= 1")
    for name in ("x", "dt", "A", "D", "h0"):
        if not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("Bm", "Cm"):
        if S > 1 and named[name].stride(2) != 1:
            raise ValueError(f"{name}'s rows of S must be contiguous "
                             "(stride 1 on the last dimension)")
    if S > MAX_STATE:
        raise ValueError(f"the state dimension {S} exceeds {MAX_STATE}")
    if B > 65535:
        raise ValueError(f"at most 65535 sequences a launch, got {B}")
    if Di >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("T and Di must be below 2**31")
    _check_device(dev)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
               h0: torch.Tensor, *, schedule: str = "auto"):
    """A Mamba layer's scan: x [B, T, Di] (float32 or bfloat16), dt [B, T,
    Di], A [Di, S], D [Di] and h0 [B, Di, S] float32, Bm and Cm [B, T, S]
    in x's dtype (rows of S contiguous; any strides over B and T, so the
    views ``split`` gives are taken as they are) → (y [B, T, Di] in x's
    dtype, h [B, Di, S] float32), the function of
    :func:`.ref.mamba_scan_ref` with S at most 32.  x, dt, A, D and h0
    must be contiguous.  ``schedule``: "decode", "prefill", or "auto" —
    decode for T up to ``DECODE_MAX_T``."""
    _check_mamba(x, dt, A, Bm, Cm, D, h0)
    if schedule != "auto" and schedule not in SCHEDULES:
        raise ValueError(f"schedule must be 'auto' or one of "
                         f"{sorted(SCHEDULES)}, got {schedule!r}")
    if x.device.type == "cpu":
        return mamba_scan_ref(x, dt, A, Bm, Cm, D, h0)
    B, T, Di = x.shape
    S = A.shape[1]
    if schedule == "auto":
        schedule = "decode" if T <= DECODE_MAX_T else "prefill"
    y = torch.empty((B, T, Di), dtype=x.dtype, device=x.device)
    h = torch.empty((B, Di, S), dtype=torch.float32, device=x.device)
    err = _mamba_lib().mamba_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), _DTYPES[x.dtype], B, T, Di, S, Bm.stride(0),
        Bm.stride(1), Cm.stride(0), Cm.stride(1), SCHEDULES[schedule],
        torch.cuda.current_stream().cuda_stream)
    mamba_scan.launches += 1
    mamba_scan.route_launches[schedule] += 1
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {err}")
    return y, h


mamba_scan.launches = 0
mamba_scan.route_launches = {name: 0 for name in SCHEDULES}


def mamba_decay(dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dt [..., Di], A [Di, S] float32, contiguous → exp(dt·A) [..., Di,
    S] float32, formed on the card by the Mamba scan's own ``decay``: for
    holding the kernel's expf against ``torch.exp`` alone."""
    for name, t in (("dt", dt), ("A", A)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")
    if A.dim() != 2 or dt.dim() < 1 or dt.shape[-1] != A.shape[0] \
            or min(A.shape) < 1 or dt.numel() < 1:
        raise ValueError(f"dt {tuple(dt.shape)} and A {tuple(A.shape)} do "
                         "not fit together (dt [..., Di], A [Di, S])")
    _check_device(dt.device)
    if dt.device.type == "cpu":
        return mamba_decay_ref(dt, A)
    Di, S = A.shape
    a = torch.empty((*dt.shape, S), dtype=torch.float32, device=dt.device)
    err = _mamba_lib().mamba_decay(dt.data_ptr(), A.data_ptr(), a.data_ptr(),
                                   dt.numel() // Di, Di, S,
                                   torch.cuda.current_stream().cuda_stream)
    mamba_decay.launches += 1
    if err != 0:
        raise RuntimeError(f"mamba_decay launch failed: cudaError {err}")
    return a


mamba_decay.launches = 0
