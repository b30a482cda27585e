"""Mehrotra predictor–corrector interior-point solver in PyTorch, float64.

The port of the JAX package's ``repro/core/ipm.py`` — the barrier method
the paper runs through Gurobi (§II-D3) — for

    min c·x   s.t.  A x ≤ b,   lb ≤ x ≤ ub.

Bounds are folded into A as explicit rows, keeping the KKT system in pure
inequality form:

    r_d = c + Aᵀz = 0,   s = b − Ax ≥ 0,   z ≥ 0,   s∘z = 0.

Newton system per step (d⁻¹ = z/s):

    Aᵀ diag(d⁻¹) A Δx = −r_d − Aᵀ(d⁻¹ ∘ r_p) + Aᵀ(r_c / s)
    Δs = −r_p − A Δx
    Δz = (−r_c − z∘Δs) / s

with r_c = s∘z − σμ𝟙 (+ ΔS_aff ΔZ_aff 𝟙 for the corrector).  The reduced
cost of ℓ_c is the dual of its lower-bound row (λ_L, §II-D1).

One code path on every device: A and Aᵀ are staged as sparse CSR tensors
on ``device`` (the CUDA card unless ``device="cpu"``), and the Newton
system M Δx = rhs, M = AᵀD⁻¹A + 1e-10·I, is solved there by one of two
routes, chosen from the number of columns n alone:

* **dense** (:class:`NewtonSystem`, while M's 8·n² bytes are at most
  :data:`MAX_NEWTON_BYTES`, about 40,000 columns): M is formed as a dense
  float64 matrix once per iteration and factorized once by Cholesky
  (``torch.linalg.cholesky_ex``, cuSOLVER on the card), the factor serving
  both the predictor's and the corrector's solve.  M is formed with
  ``index_add_``, which on the card sums with atomic adds in no fixed
  order: the card's iterates may differ between runs in the last bits.
* **sparse** (:class:`SparseNewton`, past that size): M is never formed.
  Its vertex block is a weighted graph Laplacian plus a positive diagonal;
  the ℓ columns (one a link class) drop out by a Schur complement, and
  the vertex block is solved by preconditioned CG whose preconditioner is
  the forest of each vertex's heaviest in-arc, factored and swept over
  the DAG's levels by the hand-written kernels of
  :mod:`repro_torch.kernels.ipm`.  Memory is O(nnz + n·lanes).

Every variable of Algorithm 1's LPs has a finite lower bound (ℓ ≥ L, t ≥
0, T ≥ 0), so every column of the folded A has a bound row, A has full
column rank and M is symmetric positive definite.  A failed pivot or a
PCG that does not converge raises; nothing is rerouted to another route,
factorization or device.  Results are held to tolerances, not bits.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.device import DeviceLike, device_name, resolve_device

from repro_torch.kernels.ipm import Forest, tree_factor, tree_solve

from .graph import _ragged_arange, _topo_levels
from .lp import LPProblem, LPSolution

#: the largest dense Newton matrix M (float64 bytes) a solve may form; the
#: 256-rank stencil's LP (23,042 columns) needs 4.25 GB of it, and M and its
#: factor together stay under a third of an 80 GB card at the limit.  Past
#: it the solve takes the sparse route.
MAX_NEWTON_BYTES = 12 << 30
#: the sparse route's PCG: a lane stops at a relative residual
#: ‖r‖ ≤ PCG_TOL·‖b‖; past PCG_MAX_STEPS steps the solve raises
PCG_TOL = 1e-10
PCG_MAX_STEPS = 20_000
#: the diagonal shift of M, as in the reference
REG = 1e-10
#: the reference's stopping constants: residuals, μ and the gap below
#: TOL·(1 + max|b|), at most MAX_ITER iterations
TOL = 1e-8
MAX_ITER = 120


def _fold_bounds(prob: LPProblem):
    """Append finite bounds of x as rows of A. Returns (A, b, lb_row_idx)."""
    A, b = prob.A, prob.b
    n = prob.nvars
    m0 = A.shape[0]

    lo_j = np.nonzero(np.isfinite(prob.lb))[0]
    hi_j = np.nonzero(np.isfinite(prob.ub))[0]
    nlo, nhi = lo_j.shape[0], hi_j.shape[0]
    rows = np.arange(nlo + nhi)
    cols = np.concatenate([lo_j, hi_j])
    vals = np.concatenate([-np.ones(nlo), np.ones(nhi)])
    eb = np.concatenate([-prob.lb[lo_j], prob.ub[hi_j]])
    E = sp.csr_matrix((vals, (rows, cols)), shape=(nlo + nhi, n))
    A = sp.vstack([A, E]).tocsr()
    b = np.concatenate([b, eb])

    lb_row = {int(j): m0 + k for k, j in enumerate(lo_j)}
    return A, b, lb_row


def newton_bytes(n: int) -> int:
    """Bytes of the dense float64 Newton matrix of an LP with n columns."""
    return 8 * n * n


def _csr(A: sp.csr_matrix, device: torch.device) -> torch.Tensor:
    with warnings.catch_warnings(), \
            torch.sparse.check_sparse_tensor_invariants():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
        return torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int64)),
            torch.from_numpy(A.indices.astype(np.int64)),
            torch.from_numpy(A.data.astype(np.float64)), size=A.shape,
            dtype=torch.float64).to(device)


class NewtonSystem:
    """The Newton matrix M = Aᵀ diag(d) A + 1e-10·I of a folded constraint
    matrix ``A`` (scipy CSR, m × n), dense float64 on ``device``, and its
    Cholesky factor.

    Row r of A adds d[r]·A[r, i]·A[r, j] to M[i, j] for every pair (i, j)
    of its nonzeros: the pairs' flat indices into M and their coefficients
    are laid out once, here; each :meth:`form` is one ``index_add_`` of the
    coefficients scaled by d and the diagonal shift, each :meth:`factor`
    one ``cholesky_ex``.  Raises ``ValueError`` before allocating anything
    when M would exceed :data:`MAX_NEWTON_BYTES`.  ``nclass`` is the
    sparse route's; the dense M takes every column alike.
    """

    def __init__(self, A: sp.csr_matrix, device: torch.device,
                 nclass: int = 0):
        m, n = A.shape
        self.n = n
        self.nbytes = newton_bytes(n)
        if self.nbytes > MAX_NEWTON_BYTES:
            raise ValueError(
                f"the LP's Newton matrix has n = {n} columns: dense float64 "
                f"it needs {self.nbytes} B ({self.nbytes / 2**30:.2f} GiB), "
                f"more than MAX_NEWTON_BYTES = {MAX_NEWTON_BYTES} B; "
                "solve_ipm takes the sparse route (SparseNewton) for LPs "
                "this large")
        k = np.diff(A.indptr)
        row_of = np.repeat(np.arange(m, dtype=np.int64), k)   # per nonzero
        cnt = k[row_of]                         # partners of each nonzero
        i_nz = np.repeat(np.arange(A.nnz, dtype=np.int64), cnt)
        j_nz = np.repeat(A.indptr[row_of].astype(np.int64), cnt) \
            + _ragged_arange(cnt)
        cols = A.indices.astype(np.int64)
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        self.flat = put(cols[i_nz] * n + cols[j_nz])
        self.coef = put(A.data[i_nz] * A.data[j_nz])
        self.row = put(row_of[i_nz])
        self.M = torch.empty((n, n), dtype=torch.float64, device=device)
        # column-major, the layout LAPACK and cuSOLVER factor in: a
        # row-major ``out=`` makes ``cholesky_ex`` factor into a third n × n
        # buffer and copy it over
        self.L = torch.empty_strided((n, n), (1, n), dtype=torch.float64,
                                     device=device)
        self.info = torch.empty((), dtype=torch.int32, device=device)

    def form(self, d: torch.Tensor) -> None:
        """M ← Aᵀ diag(d) A + 1e-10·I."""
        self.M.zero_()
        self.M.view(-1).index_add_(0, self.flat, self.coef * d[self.row])
        self.M.diagonal().add_(REG)

    def factor(self) -> None:
        """The Cholesky factor of M; raises on a failed pivot."""
        torch.linalg.cholesky_ex(self.M, out=(self.L, self.info))
        bad = int(self.info.item())
        if bad:
            raise RuntimeError(
                f"Cholesky of the {self.n} × {self.n} Newton matrix failed: "
                f"leading minor {bad} is not positive definite")

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """M⁻¹·rhs by the factor's two triangular solves
        (``cholesky_solve`` copies the n × n factor on every call)."""
        y = torch.linalg.solve_triangular(self.L, rhs[:, None], upper=False)
        return torch.linalg.solve_triangular(self.L.mT, y, upper=True)[:, 0]


class SparseNewton:
    """The Newton system M = Aᵀ diag(d) A + 1e-10·I of a folded constraint
    matrix ``A`` (scipy CSR, m × n) of Algorithm 1's shape, solved on
    ``device`` without forming M.

    Columns ``0 .. nclass-1`` are the ℓ columns, ``nclass .. n-1`` the
    vertex columns (T last).  Every row has at most two vertex entries:
    an arc row (an edge, or a sink's row into T) has +1 at its source and
    −1 at its destination, a bound row one entry.  So M's vertex block
    M₁₁ is a weighted graph Laplacian plus a positive diagonal, and with
    B = M[vertices, ℓ], C = M[ℓ, ℓ]:

        X = M₁₁⁻¹B,  S = C − BᵀX  (nclass × nclass)
        y = M₁₁⁻¹r_t,  Δℓ = S⁻¹(r_ℓ − Bᵀy),  Δt = y − XΔℓ.

    M₁₁⁻¹ is preconditioned CG, M₁₁·v = Aᵀ(d ∘ Av) over the vertex
    columns.  Its preconditioner P, once an iteration: each vertex's
    parent is the source of its in-arc of largest d (ties to the lowest
    row), and P = diag(M₁₁) − Σ over tree arcs of d·(e_v e_pᵀ + e_p e_vᵀ),
    strictly diagonally dominant (every vertex has its bound row).  Its
    parents lie on lower topological levels, so the DAG's levels order its
    elimination: :func:`~repro_torch.kernels.ipm.tree_factor` once an
    iteration, :func:`~repro_torch.kernels.ipm.tree_solve` once a PCG
    step.  The iteration's first :meth:`solve` (the predictor) runs B's
    columns and its right-hand side as lanes of one PCG; the next (the
    corrector) one lane.  Vectors live in level order; nothing n × n is
    allocated.

    Raises ``ValueError`` naming the first row of another shape, or a
    vertex column without a bound row; ``RuntimeError`` when a lane has
    not converged after :data:`PCG_MAX_STEPS` steps.
    """

    def __init__(self, A: sp.csr_matrix, device: torch.device,
                 nclass: int):
        m, n = A.shape
        nc = nclass
        nv = n - nc
        if not 0 <= nc < n:
            raise ValueError(f"nclass {nc} does not fit {n} columns")
        A = A.tocsr()
        row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(A.indptr))
        is_v = A.indices >= nc
        kv = np.bincount(row_of[is_v], minlength=m)
        vsum = np.bincount(row_of[is_v], weights=A.data[is_v], minlength=m)
        vpos = np.bincount(row_of[is_v], weights=A.data[is_v] == 1.0,
                           minlength=m)
        bad = (kv > 2) | ((kv == 2) & ((vsum != 0.0) | (vpos != 1)))
        if bad.any():
            r = int(np.flatnonzero(bad)[0])
            cols = A.indices[A.indptr[r]:A.indptr[r + 1]].tolist()
            vals = A.data[A.indptr[r]:A.indptr[r + 1]].tolist()
            raise ValueError(
                f"row {r} of the folded constraint matrix (columns {cols}, "
                f"values {vals}) is neither an arc row (+1 at its source "
                f"and -1 at its destination among the vertex columns "
                f"{nc}..{n - 1}) nor a bound row (one vertex entry): the "
                "sparse Newton solve takes Algorithm 1's LPs only")
        bound = np.zeros(nv, dtype=bool)
        one = is_v & (kv[row_of] == 1)
        bound[A.indices[one] - nc] = True
        if not bound.all():
            raise ValueError(
                f"vertex column {nc + int(np.flatnonzero(~bound)[0])} has "
                "no bound row: the sparse Newton solve needs one a vertex")
        arc_nz = is_v & (kv[row_of] == 2)
        arc_row = row_of[arc_nz & (A.data == 1.0)]
        src = A.indices[arc_nz & (A.data == 1.0)].astype(np.int64) - nc
        dst = A.indices[arc_nz & (A.data == -1.0)].astype(np.int64) - nc
        level = _topo_levels(nv, src, dst)
        order = np.lexsort((np.arange(nv), level))       # position → vertex
        pos = np.empty(nv, dtype=np.int64)
        pos[order] = np.arange(nv)
        levels = np.zeros(int(level.max(initial=-1)) + 2, dtype=np.int64)
        np.cumsum(np.bincount(level, minlength=levels.shape[0] - 1),
                  out=levels[1:])
        # the arcs by destination position, then row: a vertex's in-arcs
        # are a run, ties broken to the lowest row by the lowest index
        a_src, a_dst = pos[src], pos[dst]
        ao = np.lexsort((arc_row, a_dst))

        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        Av = A[:, nc:][:, order].tocsr()
        self.n, self.nc, self.nv = n, nc, nv
        self.Av = _csr(Av, device)
        self.AvT = _csr(Av.T.tocsr(), device)
        Av.data = Av.data * Av.data
        self.AvT_sq = _csr(Av.T.tocsr(), device)
        self.Al = put(A[:, :nc].toarray())
        self.order = put(order + nc)                  # position → column
        self.arc_row = put(arc_row[ao])
        self.arc_src = put(np.append(a_src[ao], -1).astype(np.int32))
        self.arc_dst = put(a_dst[ao])
        self.lv_ptr = put(levels.astype(np.int32))
        self.levels = tuple(int(x) for x in levels)
        self.iteration = 0
        self.pcg_steps = []                   # steps of every PCG, in order
        self._fresh = False

    def form(self, d: torch.Tensor) -> None:
        """B, C, diag(M₁₁) and the preconditioner's forest for this d."""
        self.iteration += 1
        self.d = d
        dv = self.Al * d[:, None]
        self.B = self.AvT @ dv
        self.C = self.Al.mT @ dv + REG * torch.eye(self.nc, dtype=d.dtype,
                                                   device=d.device)
        self.diag = self.AvT_sq @ d + REG
        # the segmented argmax: each vertex's in-arc of largest d, the
        # lowest row among equals; a vertex with no in-arc keeps the
        # sentinel arc na (source −1, weight 0): a root
        nv, na = self.nv, self.arc_row.shape[0]
        da = d[self.arc_row]
        top = torch.full((nv,), -math.inf, dtype=d.dtype, device=d.device)
        top.scatter_reduce_(0, self.arc_dst, da, "amax")
        tie = da == top[self.arc_dst]
        idx = torch.full((nv,), na, dtype=torch.int64, device=d.device)
        idx.scatter_reduce_(0, self.arc_dst[tie], torch.arange(
            na, device=d.device)[tie], "amin")
        parent = self.arc_src[idx]
        w = torch.cat([da, da.new_zeros(1)])[idx]
        key = torch.where(parent >= 0, parent.long(), nv)
        ch = torch.sort(key, stable=True).indices[:int((parent >= 0).sum())]
        ch_ptr = torch.zeros(nv + 1, dtype=torch.int64, device=d.device)
        torch.cumsum(torch.bincount(key, minlength=nv + 1)[:nv], 0,
                     out=ch_ptr[1:])
        self.forest = Forest(parent, w, ch_ptr.to(torch.int32),
                             ch.to(torch.int32), self.lv_ptr, self.levels)

    def factor(self) -> None:
        """The forest's pivots (one ``tree_factor``)."""
        self.piv, self.g = tree_factor(self.forest, self.diag)
        self._fresh = True

    def _m11(self, p: torch.Tensor) -> torch.Tensor:
        return self.AvT @ (self.d[:, None] * (self.Av @ p)) + REG * p

    def _pcg(self, b: torch.Tensor) -> torch.Tensor:
        """M₁₁⁻¹b for b [nv, R], each lane its own CG, stopped when every
        lane's ‖r‖ ≤ PCG_TOL·‖b‖ (a lane that got there is frozen)."""
        x = torch.zeros_like(b)
        r = b.clone()
        bnorm = torch.linalg.vector_norm(b, dim=0)
        tol = PCG_TOL * bnorm
        z = tree_solve(self.forest, self.piv, self.g, r)
        p = z
        rz = (r * z).sum(0)
        for step in range(PCG_MAX_STEPS + 1):
            res = torch.linalg.vector_norm(r, dim=0)
            live = ~(res <= tol)
            if not bool(live.any()):
                self.pcg_steps.append(step)
                return x
            if step == PCG_MAX_STEPS:
                break
            q = self._m11(p)
            alpha = torch.where(live, rz / (p * q).sum(0), 0.0)
            x = x + alpha * p
            r = r - alpha * q
            z = tree_solve(self.forest, self.piv, self.g, r)
            rz_new = (r * z).sum(0)
            beta = torch.where(live, rz_new / rz, 0.0)
            rz = torch.where(live, rz_new, rz)
            p = z + beta * p
        j = int(torch.nonzero(live)[0])
        rel = float(res[j] / bnorm[j])
        raise RuntimeError(
            f"PCG of IPM iteration {self.iteration}: lane {j} of "
            f"{b.shape[1]} is at relative residual {rel:.3e} after "
            f"{PCG_MAX_STEPS} steps (PCG_TOL {PCG_TOL:g}, PCG_MAX_STEPS "
            f"{PCG_MAX_STEPS})")

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """M⁻¹·rhs by the Schur complement over ℓ; the iteration's first
        call also solves for X = M₁₁⁻¹B, as lanes of its PCG."""
        nc = self.nc
        r_l, r_t = rhs[:nc], rhs[self.order]
        if self._fresh:
            sol = self._pcg(torch.cat([self.B, r_t[:, None]], 1))
            self.X, y = sol[:, :nc], sol[:, nc]
            self.S = self.C - self.B.mT @ self.X
            self._fresh = False
        else:
            y = self._pcg(r_t[:, None].contiguous())[:, 0]
        dl = torch.linalg.solve(self.S, r_l - self.B.mT @ y)
        out = torch.empty_like(rhs)
        out[:nc] = dl
        out[self.order] = y - self.X @ dl
        return out


def _max_step(v: torch.Tensor, dv: torch.Tensor) -> float:
    """The largest α ≤ 1 with v + α·dv ≥ 0."""
    neg = dv < -1e-300
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), 1.0)
    return min(1.0, float(ratio.amin()))


def solve_ipm(prob: LPProblem, device: DeviceLike = None) -> LPSolution:
    """The LP on ``device`` (the CUDA card unless ``device="cpu"``; raises
    without one).

    The stopping rule is the reference's — primal and dual residuals and μ
    below :data:`TOL`·(1 + max|b|), at most :data:`MAX_ITER` iterations —
    and one more test: the duality gap s·z at most :data:`TOL`·(1 + |c·x|).
    Without it the maximize-ℓ LP stops with a gap of up to m·μ, which is
    the objective's error: on an 8-rank ring allreduce (1,032 rows, a
    budget of 1.6·10⁴ µs) the 1 % tolerance came out 1.1e-2 relative off
    ``core.dag``'s; with it, 8e-9, at one more iteration.  ``status`` is "optimal" when the
    rule was met, else "iteration_limit".  The Newton route follows from
    n alone: dense while :func:`newton_bytes` is at most
    :data:`MAX_NEWTON_BYTES`, sparse past it."""
    return _solve(prob, resolve_device(device))


def _solve(prob: LPProblem, dev: torch.device, newton=None) -> LPSolution:
    """:func:`solve_ipm` on ``dev`` with the Newton system class
    ``newton`` (:class:`NewtonSystem` or :class:`SparseNewton`; ``None``
    chooses from n)."""
    A_np, b_np, lb_row = _fold_bounds(prob)
    m, n = A_np.shape
    if newton is None:
        newton = (NewtonSystem if newton_bytes(n) <= MAX_NEWTON_BYTES
                  else SparseNewton)
    system = newton(A_np, dev, prob.nclass)
    A = _csr(A_np, dev)
    AT = _csr(A_np.T.tocsr(), dev)
    f64 = dict(dtype=torch.float64, device=dev)
    b = torch.as_tensor(b_np, **f64)
    c = torch.as_tensor(prob.c, **f64)
    tol = TOL * (1.0 + float(np.abs(b_np).max(initial=0.0)))

    # infeasible warm start: x = 0 clipped into bounds, s/z positive
    x = torch.as_tensor(np.clip(
        np.zeros(n), np.where(np.isfinite(prob.lb), prob.lb, 0.0),
        np.where(np.isfinite(prob.ub), prob.ub, 0.0)), **f64)
    s = (b - A @ x).clamp_min_(1.0)
    z = torch.ones(m, **f64)

    status = "iteration_limit"
    it = 0
    for it in range(MAX_ITER):
        r_d = c + AT @ z
        r_p = A @ x + s - b
        rp, rd, gap, obj = torch.stack([r_p.abs().amax(), r_d.abs().amax(),
                                        s @ z, c @ x]).tolist()
        mu = gap / m
        if max(rp, rd) < tol and mu < tol \
                and gap <= TOL * (1.0 + abs(obj)):
            status = "optimal"
            break

        d_inv = z / s
        system.form(d_inv)
        system.factor()

        def solve_newton(r_c):
            rhs = -r_d - AT @ (d_inv * r_p) + AT @ (r_c / s)
            dx = system.solve(rhs)
            ds = -r_p - A @ dx
            dz = (-r_c - z * ds) / s
            return dx, ds, dz

        # predictor
        dx_a, ds_a, dz_a = solve_newton(s * z)
        a_p = _max_step(s, ds_a)
        a_d = _max_step(z, dz_a)
        mu_aff = float((s + a_p * ds_a) @ (z + a_d * dz_a)) / m
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.1

        # corrector
        r_c = s * z - sigma * mu + ds_a * dz_a
        dx, ds, dz = solve_newton(r_c)

        a_p = min(1.0, 0.995 * _max_step(s, ds))
        a_d = min(1.0, 0.995 * _max_step(z, dz))
        x += a_p * dx
        s += a_p * ds
        z += a_d * dz
        s.clamp_min_(1e-300)
        z.clamp_min_(1e-300)

    x_np = x.cpu().numpy()
    z_np = z.cpu().numpy()
    lam = np.zeros(prob.nclass)
    for cls in range(prob.nclass):
        r = lb_row.get(cls)
        if r is not None:
            lam[cls] = z_np[r]

    if prob.c[prob.idx_T] == 1.0:
        val = float(x_np[prob.idx_T])
    else:
        val = float(-(prob.c @ x_np))
    return LPSolution(T=val, x=x_np, lam=lam, status=status,
                      iterations=it + 1, device=device_name(dev),
                      pcg_steps=getattr(system, "pcg_steps", None))
