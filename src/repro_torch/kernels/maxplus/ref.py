"""Plain PyTorch versions of the two dense (max,+) kernels.

Both follow the TPU kernels' accumulator rule (``repro/kernels/maxplus/
kernel.py``: ``acc`` starts at −1e30, the argmax state at (−1e30, −1e30,
−1)), so a row whose every candidate lies below −1e30 returns −1e30 and
index −1, and a row whose best candidate rounds to exactly −1e30 still
names it.  The CUDA kernels compute the same, bit for bit: each candidate
is one float32 add, and max and the lexicographic compares are exact.

Tie keys ``c`` are assumed ≥ −1e30 (the engine's are cumulative slope
sums ≥ 0), the domain on which the TPU kernel's blocked reduction and the
sequential lexicographic rule agree.

Rows are processed in chunks so the [rows, N, K] candidate tensor stays
under :data:`CHUNK_ELEMS` elements.
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
