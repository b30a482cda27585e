"""Wrappers of the tree-preconditioner kernels (``csrc/tree_precond.cu``):
``tree_factor`` (the pivots of a forest's elimination, once an IPM
iteration) and ``tree_solve`` (its up and down sweeps over R lanes, once a
PCG step) for the sparse Newton solve of ``repro_torch.core.ipm``.

A CUDA tensor goes to the hand-written kernel (built on first use,
launched on the current stream); a CPU tensor goes to the plain version in
:mod:`.ref`.  There is no other route: on a CUDA tensor a wrapper launches
its kernel or raises.  Each counts its launches in ``<wrapper>.launches``.
The kernels read the staged layout of :mod:`.stage`, which the wrappers
make once a forest (``tree_factor``) and once a ``g`` (``tree_solve``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import Forest, tree_factor_ref, tree_solve_ref
from .stage import factor_layout, solve_layout

_P = ctypes.c_void_p
_I = ctypes.c_int


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (the package's build of ``tree_precond.cu``, or its
    ``-DTP_CHAIN_ONLY`` build) with its C signatures."""
    lib.tree_factor.argtypes = [_P] * 8 + [_I, _I, _P, _P, _P]
    lib.tree_solve.argtypes = [_P] * 10 + [_I, _I, _I, _P, _P]
    lib.tree_window.argtypes = [ctypes.POINTER(_I)]
    lib.tree_block.argtypes = [_I, ctypes.POINTER(_I)]
    for fn in (lib.tree_factor, lib.tree_solve, lib.tree_window,
               lib.tree_block):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    return bind(build.load("tree_precond"))


def window_positions(lib: ctypes.CDLL = None) -> int:
    """The positions the kernels' window holds on the current card."""
    W = _I()
    err = (lib or _lib()).tree_window(ctypes.byref(W))
    if err != 0:
        raise RuntimeError(f"tree_window failed: cudaError {err}")
    return W.value


def block_shape(f: Forest, lib: ctypes.CDLL = None) -> tuple:
    """(consumer warps, producer warps, levels a ring slot holds) of the
    kernels for forest ``f``."""
    out = (_I * 3)()
    (lib or _lib()).tree_block(factor_layout(f).width, out)
    return tuple(out)


def _check_forest(f: Forest) -> torch.device:
    """Types, devices and shapes of a forest; returns its device."""
    dev = f.parent.device
    nv = f.parent.shape[0]
    for name, x, dtype, shape in (
            ("parent", f.parent, torch.int32, (nv,)),
            ("w", f.w, torch.float64, (nv,)),
            ("ch_ptr", f.ch_ptr, torch.int32, (nv + 1,)),
            ("ch", f.ch, torch.int32, None),
            ("lv_ptr", f.lv_ptr, torch.int32, (len(f.levels),))):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, parent on {dev}")
        if not x.is_contiguous() or x.dim() != 1:
            raise ValueError(f"{name} must be a contiguous vector")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
    if len(f.levels) < 1 or f.levels[0] != 0 or f.levels[-1] != nv:
        raise ValueError(f"the levels must cover positions 0 .. {nv}")
    if nv >= 2 ** 31:
        raise ValueError("a forest holds fewer than 2**31 positions")
    if dev.type == "cuda":
        if dev.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"tensors are on {dev}, but the current CUDA "
                             f"device is {torch.cuda.current_device()}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_vec(name: str, x: torch.Tensor, f: Forest, dev, ndim: int = 1):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != torch.float64:
        raise TypeError(f"{name} must be float64, got {x.dtype}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the forest on {dev}")
    if x.dim() != ndim or x.shape[0] != f.nv or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous and {ndim}-D with "
                         f"{f.nv} rows, got {tuple(x.shape)}")


def tree_factor(f: Forest, diag: torch.Tensor):
    """diag [nv] float64 → (piv, g) [nv] float64, the function of
    :func:`.ref.tree_factor_ref`."""
    dev = _check_forest(f)
    _check_vec("diag", diag, f, dev)
    if dev.type == "cpu":
        return tree_factor_ref(f, diag)
    piv = torch.empty_like(diag)
    g = torch.empty_like(diag)
    err = launch_factor(_lib(), f, diag, piv, g)
    tree_factor.launches += 1
    if err != 0:
        raise RuntimeError(f"tree_factor launch failed: cudaError {err}")
    return piv, g


def launch_factor(lib: ctypes.CDLL, f: Forest, diag: torch.Tensor,
                  piv: torch.Tensor, g: torch.Tensor) -> int:
    """One launch of ``lib``'s ``tree_factor`` on checked card tensors,
    uncounted: its CUDA error code."""
    lay = factor_layout(f)
    return lib.tree_factor(
        diag.data_ptr(), f.w.data_ptr(), lay.wk.data_ptr(),
        lay.c01.data_ptr(), lay.w01.data_ptr(), f.ch_ptr.data_ptr(),
        f.ch.data_ptr(), lay.lv_tab.data_ptr(), f.nlv, lay.width,
        piv.data_ptr(), g.data_ptr(), torch.cuda.current_stream().cuda_stream)


tree_factor.launches = 0


def tree_solve(f: Forest, piv: torch.Tensor, g: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """r [nv, R] float64 (R lanes, at most 65,535) → x [nv, R] = P⁻¹r, the
    function of :func:`.ref.tree_solve_ref`."""
    dev = _check_forest(f)
    _check_vec("piv", piv, f, dev)
    _check_vec("g", g, f, dev)
    _check_vec("r", r, f, dev, ndim=2)
    R = r.shape[1]
    if not 1 <= R <= 65535:
        raise ValueError(f"1 to 65535 lanes a launch, got {R}")
    if dev.type == "cpu":
        return tree_solve_ref(f, piv, g, r)
    x = torch.empty_like(r)
    err = launch_solve(_lib(), f, piv, g, r, x)
    tree_solve.launches += 1
    if err != 0:
        raise RuntimeError(f"tree_solve launch failed: cudaError {err}")
    return x


def launch_solve(lib: ctypes.CDLL, f: Forest, piv: torch.Tensor,
                 g: torch.Tensor, r: torch.Tensor, x: torch.Tensor) -> int:
    """One launch of ``lib``'s ``tree_solve`` on checked card tensors,
    uncounted: its CUDA error code."""
    lay = factor_layout(f)
    gk, g01 = solve_layout(f, g)
    return lib.tree_solve(
        r.data_ptr(), f.parent.data_ptr(), f.w.data_ptr(), piv.data_ptr(),
        gk.data_ptr(), lay.c01.data_ptr(), g01.data_ptr(),
        f.ch_ptr.data_ptr(), f.ch.data_ptr(), lay.lv_tab.data_ptr(), f.nlv,
        lay.width, r.shape[1], x.data_ptr(),
        torch.cuda.current_stream().cuda_stream)


tree_solve.launches = 0
