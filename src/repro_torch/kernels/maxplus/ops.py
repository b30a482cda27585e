"""Wrappers of the (max,+) kernels: the dense mat-vecs, their graph-batched
twins and the slot-list segment reduction (``csrc/maxplus.cu``), the dense
float32 forward's level loop (``csrc/dense_levels.cu``), and the sparse
forward's level loops (float32 and float64), the segment forward's level
loop (which forms its edge weights itself) and the backtrace
(``csrc/sparse_levels.cu``).

A CUDA tensor goes to the hand-written kernel (built on first use,
launched on the current stream); a CPU tensor goes to the plain version in
:mod:`.ref`.  There is no other route: on a CUDA tensor
the wrapper launches its kernel or raises.  Each wrapper counts its kernel
launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import (dense_levels_f32_ref, maxplus_matvec_argmax_batched_ref,
                  maxplus_matvec_argmax_ref, maxplus_matvec_batched_ref,
                  maxplus_matvec_ref, maxplus_slotlist_argmax_ref,
                  segment_levels_f64_ref, sparse_levels_f32_ref,
                  sparse_levels_f64_ref, sparse_walk_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = build.load("maxplus")
    lib.maxplus_matvec.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.maxplus_matvec.restype = ctypes.c_int
    lib.maxplus_matvec_argmax.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.maxplus_matvec_argmax.restype = ctypes.c_int
    lib.maxplus_matvec_batched.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.maxplus_matvec_batched.restype = ctypes.c_int
    lib.maxplus_matvec_argmax_batched.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                                  _I, _I, _P]
    lib.maxplus_matvec_argmax_batched.restype = ctypes.c_int
    lib.maxplus_slotlist_argmax.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _P]
    lib.maxplus_slotlist_argmax.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _levels_lib() -> ctypes.CDLL:
    """The sparse level-loop library, built on first use."""
    lib = build.load("sparse_levels")
    lib.sparse_levels_f32.argtypes = [_P, _P, _P, _P, _P, _LL, _P, _P, _P,
                                      _P, _P, _I, _I, _I, _P]
    lib.sparse_levels_f32.restype = ctypes.c_int
    lib.sparse_levels_f64.argtypes = lib.sparse_levels_f32.argtypes
    lib.sparse_levels_f64.restype = ctypes.c_int
    lib.segment_levels_f64.argtypes = [_P] * 14 + [_I] * 13 + [_P]
    lib.segment_levels_f64.restype = ctypes.c_int
    lib.sparse_backtrace.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _LL, _LL, _P]
    lib.sparse_backtrace.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _dense_levels_lib() -> ctypes.CDLL:
    """The dense level-loop library, built on first use."""
    lib = build.load("dense_levels")
    lib.dense_levels_f32.argtypes = [_P] * 11 + [_I] * 11 + [_P]
    lib.dense_levels_f32.restype = ctypes.c_int
    return lib


def _check(A: torch.Tensor, t: torch.Tensor, c=None, ndim: int = 2) -> None:
    """Types, shapes, devices and sizes of a dense (max,+) call: ``ndim`` 2
    (A [M, N], t/c [N, K]) or 3 (A [G, M, N], t/c [G, N, K])."""
    named = [("A", A), ("t", t)] + ([("c", c)] if c is not None else [])
    for name, x in named:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape "
                             f"{tuple(x.shape)}")
        if x.device != A.device:
            raise ValueError(f"{name} is on {x.device}, A on {A.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    G = A.shape[0] if ndim == 3 else 1
    M, N = A.shape[-2:]
    K = t.shape[-1]
    if t.shape[:-1] != A.shape[:-2] + (N,):
        raise ValueError(f"A is {tuple(A.shape)} but t is {tuple(t.shape)}")
    if c is not None and c.shape != t.shape:
        raise ValueError(f"c is {tuple(c.shape)}, t is {tuple(t.shape)}")
    if min(G, M, N, K) < 1:
        raise ValueError("G, M, N and K must all be >= 1"
                         if ndim == 3 else "M, N and K must all be >= 1")
    if max(A.numel(), t.numel(), G * M * K) >= 2 ** 31:
        raise ValueError("tensors must hold fewer than 2**31 elements")
    if G > 65535:
        raise ValueError(f"at most 65535 graphs a launch, got {G}")
    _check_device(A.device)


def _check_device(dev: torch.device) -> None:
    """A CPU device, or the current CUDA device."""
    if dev.type == "cuda":
        if dev.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"tensors are on {dev}, but the current "
                             f"CUDA device is {torch.cuda.current_device()}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def maxplus_matvec(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A [M, N] f32 (−1e30 = no edge), t [N, K] f32 → out [M, K] f32,
    ``out[i, k] = max(−1e30, max_j A[i, j] + t[j, k])``."""
    _check(A, t)
    if A.device.type == "cpu":
        return maxplus_matvec_ref(A, t)
    M, N = A.shape
    K = t.shape[1]
    out = torch.empty((M, K), dtype=torch.float32, device=A.device)
    err = _lib().maxplus_matvec(A.data_ptr(), t.data_ptr(), out.data_ptr(),
                                M, N, K, torch.cuda.current_stream().cuda_stream)
    maxplus_matvec.launches += 1
    _raise_on(err, "maxplus_matvec")
    return out


def maxplus_matvec_argmax(A: torch.Tensor, t: torch.Tensor, c: torch.Tensor):
    """A [M, N], t/c [N, K] f32 → (out [M, K] f32, idx [M, K] int32), idx
    the lexicographic argmax of ``(A[i,j] + t[j,k], c[j,k], j)`` seeded
    with (−1e30, −1e30, −1); callers mask rows with ``out >= 0``."""
    _check(A, t, c)
    if A.device.type == "cpu":
        return maxplus_matvec_argmax_ref(A, t, c)
    M, N = A.shape
    K = t.shape[1]
    out = torch.empty((M, K), dtype=torch.float32, device=A.device)
    idx = torch.empty((M, K), dtype=torch.int32, device=A.device)
    err = _lib().maxplus_matvec_argmax(
        A.data_ptr(), t.data_ptr(), c.data_ptr(), out.data_ptr(),
        idx.data_ptr(), M, N, K, torch.cuda.current_stream().cuda_stream)
    maxplus_matvec_argmax.launches += 1
    _raise_on(err, "maxplus_matvec_argmax")
    return out, idx


def maxplus_matvec_batched(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A [G, M, N], t [G, N, K] f32 → out [G, M, K] f32: :func:`maxplus_matvec`
    of every graph of the leading axis, in one launch."""
    _check(A, t, ndim=3)
    if A.device.type == "cpu":
        return maxplus_matvec_batched_ref(A, t)
    G, M, N = A.shape
    K = t.shape[2]
    out = torch.empty((G, M, K), dtype=torch.float32, device=A.device)
    err = _lib().maxplus_matvec_batched(
        A.data_ptr(), t.data_ptr(), out.data_ptr(), G, M, N, K,
        torch.cuda.current_stream().cuda_stream)
    maxplus_matvec_batched.launches += 1
    _raise_on(err, "maxplus_matvec_batched")
    return out


def maxplus_matvec_argmax_batched(A: torch.Tensor, t: torch.Tensor,
                                  c: torch.Tensor):
    """A [G, M, N], t/c [G, N, K] f32 → (out [G, M, K] f32, idx [G, M, K]
    int32): :func:`maxplus_matvec_argmax` of every graph of the leading
    axis, in one launch."""
    _check(A, t, c, ndim=3)
    if A.device.type == "cpu":
        return maxplus_matvec_argmax_batched_ref(A, t, c)
    G, M, N = A.shape
    K = t.shape[2]
    out = torch.empty((G, M, K), dtype=torch.float32, device=A.device)
    idx = torch.empty((G, M, K), dtype=torch.int32, device=A.device)
    err = _lib().maxplus_matvec_argmax_batched(
        A.data_ptr(), t.data_ptr(), c.data_ptr(), out.data_ptr(),
        idx.data_ptr(), G, M, N, K, torch.cuda.current_stream().cuda_stream)
    maxplus_matvec_argmax_batched.launches += 1
    _raise_on(err, "maxplus_matvec_argmax_batched")
    return out, idx


def maxplus_slotlist_argmax(dst: torch.Tensor, cand: torch.Tensor,
                            c: torch.Tensor, M: int):
    """dst [E, 1] int32, cand/c [E, K] f32 → (out [M, K] f32, idx [M, K]
    int32): per row m the max over slots e with ``dst[e] == m`` of
    ``cand[e, k]`` and the lexicographic argmax of ``(cand, c, e)``,
    seeded with (−1e30, −1e30, −1); slots pointing outside [0, M) never
    hit, rows with no slot give −1e30 / −1."""
    named = (("dst", dst, torch.int32), ("cand", cand, torch.float32),
             ("c", c, torch.float32))
    for name, x, dt in named:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
    for name, x, _ in named:
        if x.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(x.shape)}")
        if x.device != cand.device:
            raise ValueError(f"{name} is on {x.device}, cand on {cand.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    E, K = cand.shape
    M = int(M)
    if dst.shape != (E, 1) or c.shape != (E, K):
        raise ValueError(f"dst is {tuple(dst.shape)}, c {tuple(c.shape)}; "
                         f"expected ({E}, 1) and ({E}, {K})")
    if min(M, E, K) < 1:
        raise ValueError("M, E and K must all be >= 1")
    if max(cand.numel(), M * K) >= 2 ** 31:
        raise ValueError("tensors must hold fewer than 2**31 elements")
    _check_device(cand.device)
    if cand.device.type == "cpu":
        return maxplus_slotlist_argmax_ref(dst, cand, c, M)
    out = torch.empty((M, K), dtype=torch.float32, device=cand.device)
    idx = torch.empty((M, K), dtype=torch.int32, device=cand.device)
    err = _lib().maxplus_slotlist_argmax(
        dst.data_ptr(), cand.data_ptr(), c.data_ptr(), out.data_ptr(),
        idx.data_ptr(), M, E, K, torch.cuda.current_stream().cuda_stream)
    maxplus_slotlist_argmax.launches += 1
    _raise_on(err, "maxplus_slotlist_argmax")
    return out, idx


def _check_args(dev: torch.device, named) -> None:
    """Each ``(name, tensor, dtype, shape)`` a contiguous tensor of that
    dtype and shape on ``dev``."""
    for name, x, dt, shape in named:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_device(dev)


def _lanes(lead: tuple, structures: torch.Tensor, name: str) -> tuple:
    """(the structure lead, K) of a level-loop or walk call whose lane-owned
    tensors lead with ``lead`` (() solo, or (L,)): the structure-owned
    tensor ``structures`` leads with (G,), G dividing L, and each structure
    owns K = L / G lanes, lane y belonging to structure y // K."""
    if not lead:
        return (), 1
    if structures.dim() < 1 or structures.shape[0] < 1 \
            or lead[0] % structures.shape[0]:
        raise ValueError(f"{lead[0]} lanes cannot share the "
                         f"{tuple(structures.shape)[:1]} structures of "
                         f"{name} evenly")
    return (structures.shape[0],), lead[0] // structures.shape[0]


def _own(lead: tuple, slead: tuple, x: torch.Tensor) -> tuple:
    """The lead of a tensor that is the structures' (``slead``) or, where
    the lanes' values differ, the lanes' own (``lead``, (L,)): the one
    ``x`` has."""
    return lead if lead and x.dim() > 0 and x.shape[0] == lead[0] else slead


def _check_lam(ssum, cho, csrc) -> None:
    """ssum, cho and csrc come together (λ mode) or not at all."""
    if not (ssum is None) == (cho is None) == (csrc is None):
        raise ValueError("ssum, cho and csrc are all given (λ) or all None")


def _ptrs(*xs) -> tuple:
    """Device pointers, 0 for a buffer not given."""
    return tuple(0 if x is None else x.data_ptr() for x in xs)


def _lam_checks(ssum, cho, csrc, key_dtype, shape) -> list:
    """The checks of the λ state (none in values mode): ssum in
    ``key_dtype``, cho and csrc int32, each of ``shape``."""
    if ssum is None:
        return []
    return [("ssum", ssum, key_dtype, shape), ("cho", cho, torch.int32, shape),
            ("csrc", csrc, torch.int32, shape)]


def _sparse_levels(key_dtype: torch.dtype, t: torch.Tensor, ssum, cho,
                   w: torch.Tensor, w_base: int, esrc: torch.Tensor,
                   row_ptr: torch.Tensor, v_ptr: torch.Tensor,
                   elat_sum: torch.Tensor, vcost: torch.Tensor, lv0: int,
                   lv1: int, csrc):
    """The checks of a sparse level-loop call, its tie keys (ssum,
    elat_sum) in ``key_dtype``; the launch arguments after t, ssum, cho and
    csrc, or None when the tensors lie on the CPU (the caller runs the
    plain version)."""
    _check_lam(ssum, cho, csrc)
    for label, x, ndim in (("t", t, 2), ("w", w, 2), ("esrc", esrc, 1),
                           ("v_ptr", v_ptr, 1)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{label} must be a torch.Tensor")
        if x.dim() != ndim:
            raise ValueError(f"{label} must be {ndim}-D, got shape "
                             f"{tuple(x.shape)}")
    nv_p, S = t.shape
    ne_p, nlv_p = esrc.shape[0], v_ptr.shape[0] - 1
    f64, i32 = torch.float64, torch.int32
    _check_args(t.device, [
        ("t", t, f64, (nv_p, S)), ("w", w, f64, (w.shape[0], S)),
        ("esrc", esrc, torch.int64, (ne_p,)),
        ("row_ptr", row_ptr, i32, (nv_p + 1,)),
        ("v_ptr", v_ptr, i32, (nlv_p + 1,)),
        ("elat_sum", elat_sum, key_dtype, (ne_p,)),
        ("vcost", vcost, f64, (nv_p,))]
        + _lam_checks(ssum, cho, csrc, key_dtype, (nv_p, S)))
    lv0, lv1, w_base = int(lv0), int(lv1), int(w_base)
    if min(nv_p, S) < 1 or not 0 <= lv0 < lv1 <= nlv_p:
        raise ValueError(f"need nv_p, S >= 1 and 0 <= lv0 < lv1 <= nlv_p, "
                         f"got {nv_p}, {S}, {lv0}, {lv1}, {nlv_p}")
    if not 0 <= w_base < ne_p:
        raise ValueError(f"w_base {w_base} outside the {ne_p} edges")
    if max(nv_p, ne_p, S) >= 2 ** 31:
        raise ValueError("rows, edges and scenarios must be fewer than 2**31")
    if t.device.type == "cpu":
        return None
    return (w.data_ptr(), w_base, esrc.data_ptr(), row_ptr.data_ptr(),
            v_ptr.data_ptr(), elat_sum.data_ptr(), vcost.data_ptr(), lv0,
            lv1, S, torch.cuda.current_stream().cuda_stream)


def sparse_levels_f32(t: torch.Tensor, ssum, cho, w: torch.Tensor,
                      w_base: int, esrc: torch.Tensor, row_ptr: torch.Tensor,
                      v_ptr: torch.Tensor, elat_sum: torch.Tensor,
                      vcost: torch.Tensor, lv0: int, lv1: int,
                      csrc=None) -> None:
    """Levels ``lv0..lv1-1`` of the sparse float32 forward, in place, in one
    launch (:func:`~.ref.sparse_levels_f32_ref` says what it computes and
    what each argument holds).  ``ssum``, ``cho`` and ``csrc`` are all None
    in values mode; in λ mode ``csrc`` records each row's chosen source.
    The caller guarantees the plan's invariants (each level's rows'
    in-edge runs lie in ``w``'s edges ``w_base..w_base+len(w)-1`` and read
    only earlier levels' rows), as ``sweep.engine.stage_sparse`` checks
    them."""
    args = _sparse_levels(torch.float32, t, ssum, cho, w, w_base, esrc,
                          row_ptr, v_ptr, elat_sum, vcost, lv0, lv1, csrc)
    if args is None:
        sparse_levels_f32_ref(t, ssum, cho, w, w_base, esrc, row_ptr, v_ptr,
                              elat_sum, vcost, lv0, lv1, csrc)
        return
    err = _levels_lib().sparse_levels_f32(
        t.data_ptr(), *_ptrs(ssum, cho, csrc), *args)
    sparse_levels_f32.launches += 1
    _raise_on(err, "sparse_levels_f32")


def sparse_levels_f64(t: torch.Tensor, ssum, cho, w: torch.Tensor,
                      w_base: int, esrc: torch.Tensor, row_ptr: torch.Tensor,
                      v_ptr: torch.Tensor, elat_sum: torch.Tensor,
                      vcost: torch.Tensor, lv0: int, lv1: int,
                      csrc=None) -> None:
    """Levels ``lv0..lv1-1`` of the sparse float64 forward, in place, in one
    launch (:func:`~.ref.sparse_levels_f64_ref` says what it computes): the
    arguments of :func:`sparse_levels_f32`, with ssum and elat_sum in
    float64, and the same invariants."""
    args = _sparse_levels(torch.float64, t, ssum, cho, w, w_base, esrc,
                          row_ptr, v_ptr, elat_sum, vcost, lv0, lv1, csrc)
    if args is None:
        sparse_levels_f64_ref(t, ssum, cho, w, w_base, esrc, row_ptr, v_ptr,
                              elat_sum, vcost, lv0, lv1, csrc)
        return
    err = _levels_lib().sparse_levels_f64(
        t.data_ptr(), *_ptrs(ssum, cho, csrc), *args)
    sparse_levels_f64.launches += 1
    _raise_on(err, "sparse_levels_f64")


def sparse_backtrace(vsel: torch.Tensor, cho: torch.Tensor,
                     csrc: torch.Tensor, elat: torch.Tensor,
                     nlv: int) -> torch.Tensor:
    """λ by the critical-path walk, one dependent load a step, in one
    launch (:func:`~.ref.sparse_walk_ref` says what it computes): solo,
    vsel [S] int64 vertex slots in [0, nv), cho and csrc [nv, S] int32 (the
    chosen in-edges and their source rows, as the level loops record them),
    elat [ne, nc] f64 → λ [S, nc] f64; or L lanes, a leading axis L on
    vsel, cho and csrc and G on elat (G dividing L: K = L / G lanes a
    structure, lane y reading structure y // K's elat; K = 1 is a packed
    forward's G graphs) → [L, S, nc], all L walks in the one launch.  The
    caller guarantees the plan's invariants (``csrc`` is the chosen edge's
    source, which lies in [0, nv), wherever ``cho`` is not −1)."""
    for name, x in (("vsel", vsel), ("cho", cho), ("elat", elat)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    lead = tuple(vsel.shape[:-1])
    if vsel.dim() not in (1, 2) or cho.dim() != 2 + len(lead) \
            or elat.dim() != 2 + len(lead):
        raise ValueError("vsel [S] with cho, csrc [nv, S] and elat [ne, nc], "
                         "or a leading lane axis on all four")
    slead, K = _lanes(lead, elat, "elat")
    nv, S = cho.shape[-2:]
    ne, nc = elat.shape[-2:]
    _check_args(cho.device, [("vsel", vsel, torch.int64, lead + (S,)),
                             ("cho", cho, torch.int32, lead + (nv, S)),
                             ("csrc", csrc, torch.int32, lead + (nv, S)),
                             ("elat", elat, torch.float64, slead + (ne, nc))])
    L = lead[0] if lead else 1
    nlv = int(nlv)
    if min(L, nv, S, nc, nlv) < 1:
        raise ValueError("L, nv, S, nc and nlv must all be >= 1")
    if max(nv, ne, S, nlv) >= 2 ** 31 or L > 65535:
        raise ValueError("rows, edges, scenarios and levels must be fewer "
                         "than 2**31, lanes at most 65535")
    if cho.device.type == "cpu":
        return sparse_walk_ref(vsel, cho, csrc, elat, nlv)
    lam = torch.empty(lead + (S, nc), dtype=torch.float64, device=cho.device)
    err = _levels_lib().sparse_backtrace(
        vsel.data_ptr(), cho.data_ptr(), csrc.data_ptr(), elat.data_ptr(),
        lam.data_ptr(), L, K, S, nc, nlv, nv, ne,
        torch.cuda.current_stream().cuda_stream)
    sparse_backtrace.launches += 1
    _raise_on(err, "sparse_backtrace")
    return lam


def dense_levels_f32(t: torch.Tensor, ssum, cho, w: torch.Tensor,
                     A: torch.Tensor, esrc: torch.Tensor, lv_ptr: torch.Tensor,
                     rows: torch.Tensor, row_ptr: torch.Tensor,
                     in_edges: torch.Tensor, elat_sum: torch.Tensor,
                     vcost: torch.Tensor, csrc=None) -> None:
    """Levels ``0..nlv-1`` (``nlv = w.shape[-3]``) of the dense float32
    forward, in place, in one launch: solo, or L lanes with a leading axis
    L on the lane-owned t, ssum, cho, csrc and w and G on every other
    tensor but A, [nlv_p, G, Vmax, Emax] (G dividing L: K = L / G lanes a
    structure, lane y running structure y // K with its own weights; K = 1
    is a packed forward's G graphs); ``elat_sum`` leads with L where the
    lanes' latency rows differ (:func:`~.ref.dense_levels_f32_ref`
    says what it computes and what t, ssum, cho, csrc, w, A, esrc,
    elat_sum and vcost hold; ``ssum``, ``cho`` and ``csrc`` are all None in
    values mode).  The kernel reads the
    staged lists, the plain version the indicator A and esrc: lv_ptr [nlv_p
    + 1] int32, level lv's rows with a real in-edge or a vertex cost being
    ``rows[lv_ptr[lv]:lv_ptr[lv+1]]`` (int32 flat rows, [NR]), row q's real
    in-edges ``in_edges[row_ptr[q]:row_ptr[q+1]]`` ([NR + 1] int32; [NE, 2]
    int32 of (flat edge id ``lv·Emax + j``, flat source row), increasing
    j).  The kernel writes only the listed rows, so t, ssum, cho and csrc
    must arrive fresh (0, 0, −1, −1), as the forwards allocate them; the
    plain version writes every row of the walked levels.  The caller
    guarantees that and the plan's invariants (the lists are A's real
    edges and its nonzero costs, and each level reads only earlier levels'
    rows), as ``sweep.engine.stage`` builds them."""
    _check_lam(ssum, cho, csrc)
    if not isinstance(t, torch.Tensor) or t.dim() not in (2, 3):
        raise ValueError("t must be a 2-D (solo) or 3-D (packed) tensor")
    lead = tuple(t.shape[:-2])
    for name, x, ndim in (("w", w, 3), ("A", A, 3), ("rows", rows, 1),
                          ("in_edges", in_edges, 2), ("vcost", vcost, 2)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dim() != ndim + len(lead):
            raise ValueError(f"{name} must be {ndim + len(lead)}-D, got "
                             f"shape {tuple(x.shape)}")
    slead, K = _lanes(lead, vcost, "vcost")
    klead = _own(lead, slead, elat_sum)
    Ks = K if klead == slead else 1
    nflat, S = t.shape[-2:]
    nlv, Emax = w.shape[-3:-1]
    nlv_p, Vmax = vcost.shape[-2:]
    NR, NE = rows.shape[-1], in_edges.shape[-2]
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    _check_args(t.device, [
        ("t", t, f64, lead + (nflat, S)), ("w", w, f64, lead + (nlv, Emax, S)),
        ("A", A, f32, (nlv_p,) + slead + (Vmax, Emax)),
        ("esrc", esrc, torch.int64, slead + (nlv_p, Emax)),
        ("lv_ptr", lv_ptr, i32, slead + (nlv_p + 1,)),
        ("rows", rows, i32, slead + (NR,)),
        ("row_ptr", row_ptr, i32, slead + (NR + 1,)),
        ("in_edges", in_edges, i32, slead + (NE, 2)),
        ("elat_sum", elat_sum, f32, klead + (nlv_p, Emax)),
        ("vcost", vcost, f64, slead + (nlv_p, Vmax))]
        + _lam_checks(ssum, cho, csrc, f32, lead + (nflat, S)))
    L = lead[0] if lead else 1
    if min(L, S, NR, NE, Vmax, Emax) < 1 or not 1 <= nlv <= nlv_p:
        raise ValueError(f"need L, S, NR, NE, Vmax, Emax >= 1 and 1 <= nlv "
                         f"<= nlv_p, got {L}, {S}, {NR}, {NE}, {Vmax}, "
                         f"{Emax}, {nlv}, {nlv_p}")
    if nflat != nlv_p * Vmax + 1:
        raise ValueError(f"t has {nflat} rows, not nlv_p·Vmax + 1 = "
                         f"{nlv_p * Vmax + 1}")
    if max(nflat, nlv_p * Emax, NE, S) >= 2 ** 31 or L > 65535:
        raise ValueError("rows, edges and scenarios must be fewer than "
                         "2**31, lanes at most 65535")
    if t.device.type == "cpu":
        dense_levels_f32_ref(t, ssum, cho, w, A, esrc, elat_sum, vcost, csrc)
        return
    err = _dense_levels_lib().dense_levels_f32(
        t.data_ptr(), *_ptrs(ssum, cho, csrc), w.data_ptr(),
        lv_ptr.data_ptr(), rows.data_ptr(), row_ptr.data_ptr(),
        in_edges.data_ptr(), elat_sum.data_ptr(), vcost.data_ptr(), L, K,
        Ks, nlv, nlv_p, nflat, Vmax, Emax, NR, NE, S,
        torch.cuda.current_stream().cuda_stream)
    dense_levels_f32.launches += 1
    _raise_on(err, "dense_levels_f32")


def segment_levels_f64(t: torch.Tensor, ssum, cho, Lmat: torch.Tensor,
                       GSmat: torch.Tensor, edst: torch.Tensor,
                       esrc: torch.Tensor, econst: torch.Tensor,
                       egap: torch.Tensor, egclass: torch.Tensor,
                       elat: torch.Tensor, elat_sum: torch.Tensor,
                       vcost: torch.Tensor, lv_ptr: torch.Tensor,
                       rows: torch.Tensor, row_ptr: torch.Tensor,
                       in_edges: torch.Tensor, erec: torch.Tensor,
                       rcost: torch.Tensor, lv0: int, lv1: int,
                       csrc=None, ls=None, elink=None,
                       in_link=None) -> None:
    """Levels ``lv0..lv1-1`` of the segment forward, in place, in one
    launch, each edge's weight formed from the scenarios' Lmat and GSmat:
    solo, or L lanes with a leading axis L on the lane-owned t, ssum, cho,
    csrc, econst and erec and G on every other tensor (G dividing L: K = L
    / G lanes a structure, lane y running structure y // K's lists and
    scenarios with its own edge constants; K = 1 is a packed forward's G
    graphs; egap, egclass, elat and elat_sum, and in_edges with egclass,
    lead with L where the lanes' values differ: a lane's gap shares, gap
    classes and latency rows) (:func:`~.ref.segment_levels_f64_ref` says
    what it computes
    and what t, ssum, cho, csrc, Lmat, GSmat and the per-edge view edst …
    vcost hold; ``ssum``, ``cho`` and ``csrc`` are all None in values
    mode).  The plain
    version reads the per-edge view, the kernel the staged lists in list
    order: lv_ptr [nlv_p + 1] int32, level lv's listed rows being ``q in
    lv_ptr[lv] .. lv_ptr[lv+1] − 1``; rows [NR] int32 their flat rows and
    rcost [NR] f64 their vertex costs; row_ptr [NR + 1] int32, row q's
    in-edges being the listed edges ``row_ptr[q] .. row_ptr[q+1] − 1``;
    in_edges [NE, 4] int32 each one's (flat edge id ``lv·Emax + j``, flat
    source row, the source's listed row or −1, gap class) and erec [NE, 3 +
    nc] f64 its (econst, egap, elat_sum, elat row).  The kernel writes only
    the listed rows, so t, ssum, cho and csrc must arrive fresh (0, 0, −1,
    −1) on the walked levels, as the forwards allocate them.  The caller
    guarantees that and the plan's invariants (the lists are the per-edge
    view's real edges and nonzero costs, gap classes lie below ngc, and
    each level reads only earlier levels' rows), as
    ``sweep.engine.stage_segment`` builds them.

    The link factor (the congestion fixed point): ``ls`` [L?, nl1, S] f64,
    each lane's scale of each physical link a scenario (its last bin the
    dummy, 1.0), scales an edge's gap scale GS[gc] by its link's before the
    weight is formed; the plain version reads each edge's link from
    ``elink`` (the per-edge view, [G?, nlv_p, Emax] int64), the kernel from
    ``in_link`` ([G?, NE] int32, list order).  All three None (no factor)
    or all given; the link ids lie below nl1."""
    _check_lam(ssum, cho, csrc)
    if not (ls is None) == (elink is None) == (in_link is None):
        raise ValueError("ls, elink and in_link come together: all None "
                         "(no link factor) or all given")
    if not isinstance(t, torch.Tensor) or t.dim() not in (2, 3):
        raise ValueError("t must be a 2-D (solo) or 3-D (packed) tensor")
    lead = tuple(t.shape[:-2])
    for name, x, ndim in (("Lmat", Lmat, 2), ("GSmat", GSmat, 2),
                          ("edst", edst, 2), ("elat", elat, 3),
                          ("vcost", vcost, 2), ("rows", rows, 1),
                          ("in_edges", in_edges, 2), ("erec", erec, 2)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dim() != ndim + len(lead):
            raise ValueError(f"{name} must be {ndim + len(lead)}-D, got "
                             f"shape {tuple(x.shape)}")
    slead, K = _lanes(lead, lv_ptr, "lv_ptr")
    own = {n: _own(lead, slead, x) for n, x in (
        ("egap", egap), ("egclass", egclass), ("elat", elat),
        ("elat_sum", elat_sum), ("in_edges", in_edges))}
    if (own["egclass"] == lead) != (own["in_edges"] == lead) and lead:
        raise ValueError("egclass and in_edges (its gap classes) are both "
                         "the structures' or both the lanes'")
    Kc = K if own["in_edges"] == slead else 1
    nflat, S = t.shape[-2:]
    nc, ngc = Lmat.shape[-1], GSmat.shape[-1]
    nlv_p, Emax = edst.shape[-2:]
    Vmax = vcost.shape[-1]
    NR, NE = rows.shape[-1], in_edges.shape[-2]
    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    view = (nlv_p, Emax)
    _check_args(t.device, [
        ("t", t, f64, lead + (nflat, S)),
        ("Lmat", Lmat, f64, slead + (S, nc)),
        ("GSmat", GSmat, f64, slead + (S, ngc)),
        ("edst", edst, i64, slead + view), ("esrc", esrc, i64, slead + view),
        ("econst", econst, f64, lead + view),
        ("egap", egap, f64, own["egap"] + view),
        ("egclass", egclass, i64, own["egclass"] + view),
        ("elat", elat, f64, own["elat"] + view + (nc,)),
        ("elat_sum", elat_sum, f64, own["elat_sum"] + view),
        ("vcost", vcost, f64, slead + (nlv_p, Vmax)),
        ("lv_ptr", lv_ptr, i32, slead + (nlv_p + 1,)),
        ("rows", rows, i32, slead + (NR,)),
        ("row_ptr", row_ptr, i32, slead + (NR + 1,)),
        ("in_edges", in_edges, i32, own["in_edges"] + (NE, 4)),
        ("erec", erec, f64, lead + (NE, 3 + nc)),
        ("rcost", rcost, f64, slead + (NR,))]
        + _lam_checks(ssum, cho, csrc, f64, lead + (nflat, S)))
    nl1 = 0
    if ls is not None:
        if not isinstance(ls, torch.Tensor) or ls.dim() != 2 + len(lead):
            raise ValueError(f"ls must be a {2 + len(lead)}-D tensor "
                             "[L?, nl1, S]")
        nl1 = ls.shape[-2]
        _check_args(t.device, [
            ("ls", ls, f64, lead + (nl1, S)),
            ("elink", elink, i64, slead + view),
            ("in_link", in_link, i32, slead + (NE,))])
        if nl1 < 1 or nl1 * S >= 2 ** 31:
            raise ValueError(f"ls needs 1 <= nl1 and nl1·S < 2**31, got "
                             f"nl1 {nl1}, S {S}")
    L = lead[0] if lead else 1
    lv0, lv1 = int(lv0), int(lv1)
    if min(L, S, nc, ngc, NR, NE, Vmax, Emax) < 1 \
            or not 0 <= lv0 < lv1 <= nlv_p:
        raise ValueError(f"need L, S, nc, ngc, NR, NE, Vmax, Emax >= 1 and "
                         f"0 <= lv0 < lv1 <= nlv_p, got {L}, {S}, {nc}, "
                         f"{ngc}, {NR}, {NE}, {Vmax}, {Emax}, {lv0}, {lv1}, "
                         f"{nlv_p}")
    if nflat != nlv_p * Vmax + 1:
        raise ValueError(f"t has {nflat} rows, not nlv_p·Vmax + 1 = "
                         f"{nlv_p * Vmax + 1}")
    if max(nflat, nlv_p * Emax, NE * (3 + nc), S) >= 2 ** 31 or L > 65535:
        raise ValueError("rows, edges and scenarios must be fewer than "
                         "2**31, lanes at most 65535")
    if t.device.type == "cpu":
        segment_levels_f64_ref(t, ssum, cho, Lmat, GSmat, edst, esrc, econst,
                               egap, egclass, elat, elat_sum, vcost, lv0,
                               lv1, csrc, ls, elink)
        return
    if in_edges.data_ptr() % 16:
        raise ValueError("in_edges must be 16-byte aligned (int4 records)")
    err = _levels_lib().segment_levels_f64(
        t.data_ptr(), *_ptrs(ssum, cho, csrc), Lmat.data_ptr(),
        GSmat.data_ptr(), lv_ptr.data_ptr(), rows.data_ptr(),
        row_ptr.data_ptr(), in_edges.data_ptr(), erec.data_ptr(),
        rcost.data_ptr(), *_ptrs(in_link, ls), nl1, L, K, Kc, lv0, lv1,
        nlv_p, nflat, NR, NE, S, nc, ngc,
        torch.cuda.current_stream().cuda_stream)
    segment_levels_f64.launches += 1
    _raise_on(err, "segment_levels_f64")


maxplus_matvec.launches = 0
maxplus_matvec_argmax.launches = 0
maxplus_matvec_batched.launches = 0
maxplus_matvec_argmax_batched.launches = 0
maxplus_slotlist_argmax.launches = 0
dense_levels_f32.launches = 0
sparse_levels_f32.launches = 0
sparse_levels_f64.launches = 0
sparse_backtrace.launches = 0
segment_levels_f64.launches = 0
