"""Plain PyTorch versions of the (max,+) kernels: the two dense mat-vecs,
their graph-batched twins and the slot-list segment reduction.

All follow the TPU kernels' accumulator rule (``repro/kernels/maxplus/
kernel.py``: ``acc`` starts at −1e30, the argmax state at (−1e30, −1e30,
−1)), so a row whose every candidate lies below −1e30 returns −1e30 and
index −1, and a row whose best candidate rounds to exactly −1e30 still
names it.  The CUDA kernels compute the same, bit for bit: each candidate
is one float32 add, and max and the lexicographic compares are exact.

Tie keys ``c`` are assumed ≥ −1e30 (the engine's are cumulative slope
sums ≥ 0), the domain on which the TPU kernel's blocked reduction and the
sequential lexicographic rule agree.

The dense versions process rows in chunks so the [rows, N, K] candidate
tensor stays under :data:`CHUNK_ELEMS` elements; the batched versions apply
them to each graph of the leading axis; the slot-list version is a
segment reduction (``scatter_reduce``) at O(E·K).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK_ELEMS = 1 << 24


def _row_chunks(M: int, N: int, K: int):
    step = max(1, CHUNK_ELEMS // max(N * K, 1))
    for r0 in range(0, M, step):
        yield r0, min(M, r0 + step)


def maxplus_matvec_ref(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[i, k] = max(−1e30, max_j A[i, j] + t[j, k])."""
    M, N = A.shape
    K = t.shape[1]
    out = torch.empty((M, K), dtype=t.dtype, device=t.device)
    for r0, r1 in _row_chunks(M, N, K):
        cand = A[r0:r1, :, None] + t[None]
        out[r0:r1] = cand.amax(1).clamp_min(NEG_INF)
    return out


def maxplus_matvec_argmax_ref(A: torch.Tensor, t: torch.Tensor,
                              c: torch.Tensor):
    """(out, idx): out as :func:`maxplus_matvec_ref`; ``idx[i, k]`` is the
    lexicographic argmax over j of ``(A[i,j] + t[j,k], c[j,k], j)`` with
    exact compares, seeded with (−1e30, −1e30, −1)."""
    M, N = A.shape
    K = t.shape[1]
    out = torch.empty((M, K), dtype=t.dtype, device=t.device)
    idx = torch.empty((M, K), dtype=torch.int32, device=t.device)
    jidx = torch.arange(N, dtype=torch.int32, device=t.device)[None, :, None]
    for r0, r1 in _row_chunks(M, N, K):
        cand = A[r0:r1, :, None] + t[None]
        bv = cand.amax(1).clamp_min(NEG_INF)
        tie = cand >= bv[:, None]
        bk = torch.where(tie, c[None], NEG_INF).amax(1)
        tie &= c[None] >= bk[:, None]
        out[r0:r1] = bv
        idx[r0:r1] = torch.where(tie, jidx, -1).amax(1)
    return out, idx


def maxplus_matvec_batched_ref(A: torch.Tensor,
                               t: torch.Tensor) -> torch.Tensor:
    """A [G, M, N], t [G, N, K] → [G, M, K]: :func:`maxplus_matvec_ref`
    of each graph."""
    return torch.stack([maxplus_matvec_ref(A[g], t[g])
                        for g in range(A.shape[0])])


def maxplus_matvec_argmax_batched_ref(A: torch.Tensor, t: torch.Tensor,
                                      c: torch.Tensor):
    """A [G, M, N], t/c [G, N, K] → (out [G, M, K], idx [G, M, K] int32):
    :func:`maxplus_matvec_argmax_ref` of each graph."""
    per = [maxplus_matvec_argmax_ref(A[g], t[g], c[g])
           for g in range(A.shape[0])]
    return (torch.stack([o for o, _ in per]),
            torch.stack([i for _, i in per]))


def maxplus_slotlist_argmax_ref(dst: torch.Tensor, cand: torch.Tensor,
                                c: torch.Tensor, M: int):
    """(out [M, K], idx [M, K] int32) of the slot-list reduction: for each
    row m, ``out[m, k] = max(−1e30, max over {e : dst[e] = m} of
    cand[e, k])`` and ``idx[m, k]`` the lexicographic argmax over those e of
    ``(cand[e, k], c[e, k], e)`` with exact compares, seeded with (−1e30,
    −1e30, −1).  ``dst`` [E, 1] or [E] int32; slots whose row is outside
    [0, M) never hit.

    Torch's ``scatter_reduce`` raises on an out-of-range index where the
    TPU kernel drops it, so such slots go to a trash row M, dropped at the
    end; the buffers are seeded with the kernel's −1e30 / −1."""
    d = dst.reshape(-1).long()
    E, K = cand.shape
    d = torch.where((d >= 0) & (d < M), d, M)
    dk = d[:, None].expand(E, K)
    out = torch.full((M + 1, K), NEG_INF, dtype=cand.dtype,
                     device=cand.device)
    out.scatter_reduce_(0, dk, cand, "amax")
    tie = cand >= out[d]              # cand == the row's max (≥ −1e30)
    bk = torch.full_like(out, NEG_INF)
    bk.scatter_reduce_(0, dk, torch.where(tie, c, NEG_INF), "amax")
    tie &= c >= bk[d]
    eidx = torch.arange(E, dtype=torch.int32, device=cand.device)[:, None]
    idx = torch.full((M + 1, K), -1, dtype=torch.int32, device=cand.device)
    idx.scatter_reduce_(0, dk, torch.where(tie, eidx, -1), "amax")
    return out[:M], idx[:M]
