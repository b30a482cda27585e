"""The staged layout of the tree kernels (``csrc/tree_precond.cu``) and
their window rule.

A level's operands are contiguous runs: its positions ``[a, b)`` of every
vector by position, and, since ``ch`` is sorted by parent, its children
``[e0, e1) = [ch_ptr[a], ch_ptr[b])``; so are a run of levels'.  Once a
forest (an IPM iteration) the wrappers lay out what the kernels read
beside it (:class:`Layout`): the level table; each position's first two
children ``c01`` with their ``w`` (``w01``, for ``tree_factor``) or ``g``
(``g01``, for ``tree_solve``), so that most positions find their children
in their own record; and ``w`` and ``g`` in child order (``wk = w[ch]``,
``gk = g[ch]``) for the children past the second.

The kernels keep the last W values a block wrote in a window in shared
memory; the rule for what they read from it is :func:`up_hits` /
:func:`down_hits`, and :func:`window_misses` counts the reads that go to
device memory instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ref import Forest


class Layout(NamedTuple):
    """A forest's staged layout, on its device."""

    lv_tab: torch.Tensor     # [nlv + 1, 2] int32: (lv_ptr[L], ch_ptr[lv_ptr[L]])
    wk: torch.Tensor         # [nch] float64: w[ch]
    width: int               # the mean level's positions, rounded up
    c01: torch.Tensor        # [nv, 2] int32: first two children, -1: none
    w01: torch.Tensor        # [nv, 2] float64: w at c01, 0 where none


def level_table(f: Forest) -> torch.Tensor:
    """[nlv + 1, 2] int32: (lv_ptr[L], ch_ptr[lv_ptr[L]]) for every level
    boundary L, on the forest's device."""
    return torch.stack([f.lv_ptr, f.ch_ptr.index_select(0, f.lv_ptr)],
                       1).contiguous()


def widest_level(f: Forest) -> int:
    """The positions of the forest's widest level (0 without a level)."""
    lv = np.asarray(f.levels, dtype=np.int64)
    return int(np.diff(lv).max(initial=0))


def first_children(f: Forest) -> torch.Tensor:
    """[nv, 2] int32: each position's first two children in list order,
    -1 where it has fewer."""
    t = torch.arange(2, device=f.ch.device)
    k0 = f.ch_ptr[:-1].long()
    has = (f.ch_ptr[1:].long() - k0)[:, None] > t
    if f.ch.numel() == 0:
        return torch.full((f.nv, 2), -1, dtype=torch.int32,
                          device=f.ch.device)
    k = (k0[:, None] + t).clamp(max=f.ch.numel() - 1)
    return torch.where(has, f.ch[k], -1).to(torch.int32).contiguous()


def at_children(v: torch.Tensor, c01: torch.Tensor) -> torch.Tensor:
    """[nv, 2] float64: v at each position's first two children, 0 where
    there is none."""
    if v.numel() == 0:
        return torch.zeros(c01.shape, dtype=v.dtype, device=v.device)
    return torch.where(c01 >= 0, v[c01.clamp(min=0).long()],
                       0.0).contiguous()


def factor_layout(f: Forest) -> Layout:
    """The layout of ``f``, kept on it while the same, unchanged ``f.w``
    comes back (its coefficients ``wk`` and ``w01`` are ``w``'s)."""
    kept = f._stage
    if kept is not None and kept[0] is f.w and kept[1] == f.w._version:
        return kept[2]
    c01 = first_children(f)
    out = Layout(level_table(f), f.w.index_select(0, f.ch),
                 -(-f.nv // max(f.nlv, 1)), c01, at_children(f.w, c01))
    f._stage = (f.w, f.w._version, out)
    return out


def solve_layout(f: Forest, g: torch.Tensor) -> tuple:
    """``(gk, g01)``: ``g[ch]`` and ``g`` at each position's first two
    children, kept on ``f`` while the same, unchanged ``g`` comes back
    (every PCG step of an iteration)."""
    kept = f._gk
    if kept is not None and kept[0] is g and kept[1] == g._version:
        return kept[2]
    out = (g.index_select(0, f.ch), at_children(g, factor_layout(f).c01))
    f._gk = (g, g._version, out)
    return out


def _level_of(f: Forest) -> np.ndarray:
    lv = np.asarray(f.levels, dtype=np.int64)
    return np.repeat(np.arange(f.nlv, dtype=np.int64), np.diff(lv))


def up_hits(f: Forest, W: int) -> np.ndarray:
    """[nch] bool: child k's value (x, or piv in the factor) is read from
    the window, not device memory, by its parent's level [a, b): ch[k] <
    a + W.  Child k's parent is position p with ch_ptr[p] <= k <
    ch_ptr[p + 1]."""
    ch = f.ch.cpu().numpy().astype(np.int64)
    cnt = np.diff(f.ch_ptr.cpu().numpy().astype(np.int64))
    par = np.repeat(np.arange(f.nv, dtype=np.int64), cnt)
    a = np.asarray(f.levels, dtype=np.int64)[_level_of(f)[par]]
    return ch - a < W


def down_hits(f: Forest, W: int) -> np.ndarray:
    """[nv] bool: position i's parent's x is read from the window by i's
    level [a, b): parent[i] >= b - W (False at a root, which reads none)."""
    parent = f.parent.cpu().numpy().astype(np.int64)
    b = np.asarray(f.levels, dtype=np.int64)[_level_of(f) + 1]
    return (parent >= 0) & (b - parent <= W)


def window_misses(f: Forest, W: int) -> dict:
    """The dependent reads that miss a window of W positions: ``up`` (a
    child's value, one a tree arc, the factor's as the up sweep's) and
    ``down`` (a parent's, one a non-root), with ``arcs`` the tree arcs."""
    arcs = int(f.ch.numel())
    return {"arcs": arcs, "up": arcs - int(up_hits(f, W).sum()),
            "down": arcs - int(down_hits(f, W).sum())}
