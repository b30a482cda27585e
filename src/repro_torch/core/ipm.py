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
on ``device`` (the CUDA card unless ``device="cpu"``), and
M = AᵀD⁻¹A + 1e-10·I is formed there as a dense float64 matrix once per
iteration and factorized once by Cholesky (``torch.linalg.cholesky_ex``,
cuSOLVER on the card), the factor serving both the predictor's and the
corrector's solve.  Every variable of Algorithm 1's LPs has a finite lower
bound (ℓ ≥ L, t ≥ 0, T ≥ 0), so every column of the folded A has a bound
row, A has full column rank and M is symmetric positive definite.  A failed
pivot raises; nothing is rerouted to another factorization or device.

M is formed with ``index_add_``, which on the card sums with atomic adds in
no fixed order: the card's iterates may differ between runs in the last
bits.  Results are held to tolerances, not bits.

A dense M of n columns takes 8·n² bytes (the factor as much again, and
nothing else of that size is allocated); past :data:`MAX_NEWTON_BYTES` the
solve is refused.  Graphs of 10⁵–10⁶ vertices
need a sparse Newton solve, which is not ported.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.device import DeviceLike, device_name, resolve_device

from .graph import _ragged_arange
from .lp import LPProblem, LPSolution

#: the largest dense Newton matrix M (float64 bytes) a solve may form; the
#: 256-rank stencil's LP (23,042 columns) needs 4.25 GB of it, and M and its
#: factor together stay under a third of an 80 GB card at the limit
MAX_NEWTON_BYTES = 12 << 30
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
    when M would exceed :data:`MAX_NEWTON_BYTES`.
    """

    def __init__(self, A: sp.csr_matrix, device: torch.device):
        m, n = A.shape
        self.n = n
        self.nbytes = newton_bytes(n)
        if self.nbytes > MAX_NEWTON_BYTES:
            raise ValueError(
                f"the LP's Newton matrix has n = {n} columns: dense float64 "
                f"it needs {self.nbytes} B ({self.nbytes / 2**30:.2f} GiB), "
                f"more than MAX_NEWTON_BYTES = {MAX_NEWTON_BYTES} B; a "
                "sparse Newton solve for LPs this large is not ported (use "
                "solver='highs' on the host, or core.dag)")
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
    rule was met, else "iteration_limit"."""
    dev = resolve_device(device)
    A_np, b_np, lb_row = _fold_bounds(prob)
    m, n = A_np.shape
    newton = NewtonSystem(A_np, dev)
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
        newton.form(d_inv)
        newton.factor()

        def solve_newton(r_c):
            rhs = -r_d - AT @ (d_inv * r_p) + AT @ (r_c / s)
            dx = newton.solve(rhs)
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
                      iterations=it + 1, device=device_name(dev))
