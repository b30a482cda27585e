"""The wrapper of the wkv6 kernel (``csrc/wkv6.cu``): RWKV-6's time-mix
recurrence over a layer's whole sequence in one launch.

A CUDA tensor goes to the hand-written kernel (built on first use,
launched on the current stream, its grid from :func:`wkv6_plan`); a CPU
tensor goes to the plain version :func:`.ref.wkv6_ref`.  There is no
other route: on a CUDA tensor the wrapper launches its kernel or raises.
It counts its launches in ``wkv6.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

from .ref import wkv6_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the head dims the kernel is built for
HEAD_DIMS = (32, 64)
TILE = (4, 2)        # rows i and columns j of S a thread (csrc/wkv6.cu)
MIN_JB = 4           # columns a block: one 16-byte copy of v a step


def wkv6_plan(B: int, H: int, hd: int, sms: int) -> Tuple[int, int, int]:
    """(JB, blocks, threads a block) of a wkv6 launch on ``sms`` SMs: a
    block owns JB columns of one head's S, a thread 4 rows of 2 columns.
    JB is hd / 4 (4 blocks a head) where B·H·4 blocks cover the SMs, and
    is halved, down to ``MIN_JB``, while the blocks do not."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    jb = hd // 4
    while jb > MIN_JB and B * H * (hd // jb) < sms:
        jb //= 2
    return jb, B * H * (hd // jb), hd // TILE[0] * (jb // TILE[1])


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = build.load("wkv6")
    lib.wkv6.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.wkv6.restype = ctypes.c_int
    return lib


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         S0: Optional[torch.Tensor] = None):
    """r, k, v, w [B, T, H, hd] float32, u [H, hd] float32, S0 [B, H, hd,
    hd] float32 or None (zeros), all contiguous on one device → (y [B, T,
    H, hd], S [B, H, hd, hd]): :func:`.ref.wkv6_ref`'s function, the state
    bit for bit, in one launch for all T steps."""
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if r.dim() != 4:
        raise ValueError(f"r must be [B, T, H, hd], got {tuple(r.shape)}")
    B, T, H, hd = r.shape
    want = [("r", r, r.shape), ("k", k, r.shape), ("v", v, r.shape),
            ("w", w, r.shape), ("u", u, (H, hd))]
    if S0 is not None:
        want.append(("S0", S0, (B, H, hd, hd)))
    for name, x, shape in want:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, T, H, hd) < 1:
        raise ValueError("B, T, H and hd must all be >= 1")
    if r.numel() >= 2 ** 31 or B * H >= 2 ** 31:
        raise ValueError("the inputs must hold fewer than 2**31 elements")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, S0)
    jb, _, _ = wkv6_plan(B, H, hd, _sms(r.device))
    if any(x.data_ptr() % 16 for x in (r, k, v, w)) \
            or S0 is not None and S0.data_ptr() % 8:
        raise ValueError("the wkv6 kernel copies r, k, v and w 16 bytes and "
                         "S0 8 bytes at a time: each must start on such a "
                         "boundary")
    y = torch.empty_like(r)
    S = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    err = _lib().wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), 0 if S0 is None else S0.data_ptr(),
                      y.data_ptr(), S.data_ptr(), B, T, H, hd, jb,
                      torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    wkv6.launches += 1
    return y, S


wkv6.launches = 0
