"""Plain PyTorch versions of the tree-preconditioner kernels.

The preconditioner of the sparse Newton solve (``repro_torch.core.ipm``,
:class:`~repro_torch.core.ipm.SparseNewton`) is a forest over the vertex
columns of the Newton matrix, in level order: position i of a vector is
the i-th vertex of the DAG's topological levels, level L owns the
positions ``[levels[L], levels[L + 1])``, and a vertex's parent lies on a
lower level.  The matrix is

    P = diag(d) − Σ over tree arcs (v, parent(v)) of w_v·(e_v e_pᵀ + e_p e_vᵀ)

and its LDLᵀ factor has no fill.  Eliminating children before parents:

    piv[v] = d[v] − Σ_children c (w_c · w_c) / piv[c]      (children in order)
    g[v]   = w[v] / piv[v]
    up     r'[v] = r[v] + Σ_children c g[c] · r'[c]
    down   x[v] = (r'[v] + w[v] · x[parent(v)]) / piv[v]   (roots: r'[v] / piv[v])

Each vertex's children are summed in the order of the forest's child
list, one rounding an operation and no fused multiply-add, so the kernels
in ``csrc/tree_precond.cu`` give these values bit for bit.  Within a
level the plain versions are vectorized: the k-th children of the level's
vertices form one gather.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Forest:
    """A forest over ``nv`` positions in level order.

    parent  [nv] int32: the parent's position, −1 at a root;
    w       [nv] float64: the weight of the arc to the parent (0 at a root);
    ch_ptr  [nv + 1] int32, ch [nch] int32: each position's children, in
            increasing position;
    lv_ptr  [nlv + 1] int32: the levels' position ranges, on the forest's
            device; ``levels`` the same as Python ints.
    """

    parent: torch.Tensor
    w: torch.Tensor
    ch_ptr: torch.Tensor
    ch: torch.Tensor
    lv_ptr: torch.Tensor
    levels: Tuple[int, ...]
    _plan: Optional[list] = dataclasses.field(default=None, init=False,
                                              repr=False)
    _solve_plan: Optional[tuple] = dataclasses.field(default=None,
                                                     init=False, repr=False)
    # the kernels' staged layout (stage.py): (w, its version, Layout) and
    # (g, its version, (gk, g01)); the structure's tensors (parent, ch_ptr,
    # ch, lv_ptr) are not to change once it is made
    _stage: Optional[tuple] = dataclasses.field(default=None, init=False,
                                                repr=False)
    _gk: Optional[tuple] = dataclasses.field(default=None, init=False,
                                             repr=False)

    @property
    def nv(self) -> int:
        return self.parent.shape[0]

    @property
    def nlv(self) -> int:
        return len(self.levels) - 1

    def level_plan(self) -> List[tuple]:
        """For every level: ``(up, down)``.  ``up`` lists the slices of
        the level's k-th children, k = 0, 1, …: (rows, kids) int64
        tensors, rows the positions that have a k-th child and kids those
        children.  ``down`` is None when every position of the level has
        a parent, else (roots, others) int64 tensors."""
        if self._plan is not None:
            return self._plan
        ch_ptr = self.ch_ptr.cpu().numpy().astype(np.int64)
        ch = self.ch.cpu().numpy().astype(np.int64)
        cnt = np.diff(ch_ptr)
        rows = np.repeat(np.arange(self.nv, dtype=np.int64), cnt)
        k = np.arange(ch.shape[0], dtype=np.int64) - np.repeat(ch_ptr[:-1],
                                                              cnt)
        lv = np.repeat(np.arange(self.nlv, dtype=np.int64),
                       np.diff(np.asarray(self.levels, dtype=np.int64)))
        order = np.lexsort((rows, k, lv[rows]))
        rows, kids, k, lvr = rows[order], ch[order], k[order], lv[rows[order]]
        cut = np.flatnonzero((np.diff(lvr) != 0) | (np.diff(k) != 0)) + 1
        bounds = np.concatenate([[0], cut, [rows.shape[0]]])
        dev = self.parent.device
        rows_t = torch.from_numpy(rows).to(dev)
        kids_t = torch.from_numpy(kids).to(dev)
        up: List[list] = [[] for _ in range(self.nlv)]
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            if s1 > s0:
                up[int(lvr[s0])].append((rows_t[s0:s1], kids_t[s0:s1]))
        root = self.parent.cpu().numpy() < 0
        plan = []
        for L in range(self.nlv):
            a, b = self.levels[L], self.levels[L + 1]
            down = None
            if root[a:b].any():
                pos = np.arange(a, b, dtype=np.int64)
                down = (torch.from_numpy(pos[root[a:b]]).to(dev),
                        torch.from_numpy(pos[~root[a:b]]).to(dev))
            plan.append((up[L], down))
        self._plan = plan
        return plan


def tree_factor_ref(f: Forest, diag: torch.Tensor):
    """diag [nv] float64 → (piv, g) [nv] float64: the pivots of P's
    elimination, children before parents, and g = w / piv."""
    piv = diag.clone()
    w = f.w
    for up, _ in reversed(f.level_plan()):
        for rows, kids in up:
            wk = w.index_select(0, kids)
            piv.index_copy_(0, rows, piv.index_select(0, rows)
                            - (wk * wk) / piv.index_select(0, kids))
    return piv, w / piv


def _solve_plan(f: Forest, piv: torch.Tensor, g: torch.Tensor) -> list:
    """The sweeps' per-level operands for (piv, g), kept on the forest
    while the same piv and g come back (every PCG step of an iteration):
    up, per level, (rows, kids, g[kids]); down, per level, (level slice,
    parents, w, piv) for its positions with a parent and (roots, piv) for
    its roots."""
    cached = f._solve_plan
    if cached is not None and cached[0] is piv and cached[1] is g:
        return cached[2]
    plan = f.level_plan()
    parent = f.parent.long()
    up = [[(rows, kids, g.index_select(0, kids)[:, None])
           for rows, kids in lv_up] for lv_up, _ in reversed(plan)]
    down = []
    for L, (_, roots) in enumerate(plan):
        a, b = f.levels[L], f.levels[L + 1]
        if roots is None:
            down.append((slice(a, b), parent[a:b], f.w[a:b, None],
                         piv[a:b, None], None))
        else:
            rt, others = roots
            down.append((others, parent.index_select(0, others),
                         f.w.index_select(0, others)[:, None],
                         piv.index_select(0, others)[:, None],
                         (rt, piv.index_select(0, rt)[:, None])))
    f._solve_plan = (piv, g, (up, down))
    return up, down


def tree_solve_ref(f: Forest, piv: torch.Tensor, g: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """r [nv, R] float64 (R right-hand sides as lanes) → x [nv, R] = P⁻¹r:
    the up sweep (children before parents), then the down sweep.  Each
    add and each division rounds once, as in the kernel: ``index_add_``
    adds one term to each of its (distinct) rows."""
    x = r.clone()
    up, down = _solve_plan(f, piv, g)
    for lv_up in up:
        for rows, kids, gk in lv_up:
            x.index_add_(0, rows, gk * x.index_select(0, kids))
    for at, par, w, pv, roots in down:
        if roots is not None:
            rt, rpiv = roots
            x.index_copy_(0, rt, x.index_select(0, rt) / rpiv)
        if isinstance(at, slice):
            x[at].add_(w * x.index_select(0, par)).div_(pv)
        else:
            x.index_copy_(0, at, (x.index_select(0, at)
                                  + w * x.index_select(0, par)) / pv)
    return x
