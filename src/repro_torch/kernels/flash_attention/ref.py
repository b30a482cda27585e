"""Plain PyTorch versions of the flash-attention kernels.

Dense softmax attention with the TPU kernel's conventions
(``repro/kernels/flash_attention/kernel.py`` ``_attn_kernel``): scores in
float32 from ``q · scale`` with scale 1/√d, a masked score is −1e30 (not
−inf), the row maximum is seeded at −1e30, and the output is
``(p @ v) / max(l, 1e-30)`` cast to q's type.  So a row with no live key
(``kv_len = 0``) averages the values of all Tk keys, as the TPU kernel
does, where the JAX package's ``-inf`` oracle gives NaN.

:func:`flash_attention_split_ref` is the decode kernel's arithmetic: the
live keys cut into contiguous splits (:func:`split_plan`), each split's
(m, l, acc), then the merge in split order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def live_keys(Tq: int, Tk: int, causal: bool, kv_len: Optional[int]) -> int:
    """The keys a row of the call can see: up to the last live one (the
    causal bound taken at the last query), or all Tk when none is live
    (``kv_len = 0``: every score −1e30, the row averages all values).
    Keys past it are masked for every row, so they add exactly nothing."""
    kv = Tk if kv_len is None else int(kv_len)
    if kv == 0:
        return Tk
    end = min(Tk, kv)
    return min(end, Tq) if causal else end


def split_plan(kend: int, splits: int) -> Tuple[int, int]:
    """(splits, keys a split) for ``kend`` keys cut into at most ``splits``
    contiguous ranges of equal length (the last one shorter), none empty."""
    kps = -(-kend // max(1, min(splits, kend)))
    return -(-kend // kps), kps


def _mask(Tq: int, Tk: int, causal: bool, kv_len: Optional[int], device):
    kpos = torch.arange(Tk, device=device)
    mask = kpos[None, :] < (Tk if kv_len is None else int(kv_len))
    if causal:
        mask = mask & (kpos[None, :] <= torch.arange(Tq, device=device)[:, None])
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, kv_len: Optional[int] = None,
                        round_p: bool = False) -> torch.Tensor:
    """q [BH, Tq, d], k [BHkv, Tk, d], v [BHkv, Tk, dv] → [BH, Tq, dv] in
    q's dtype.  Query row b reads key/value row ``b // (BH // BHkv)``;
    key position j is live when ``j < kv_len`` and, if ``causal``, ``j <=``
    the query's position (both counted from 0).  ``round_p``: p rounded to
    bfloat16 before the PV product, l summed from the unrounded p (the
    prefill kernel's one extra rounding)."""
    BH, Tq, d = q.shape
    BHkv, Tk, dv = v.shape
    n_rep = BH // BHkv
    qf = q.float() * (1.0 / math.sqrt(d))
    kf = k.float().repeat_interleave(n_rep, dim=0)
    vf = v.float().repeat_interleave(n_rep, dim=0)
    s = qf @ kf.transpose(1, 2)                                  # [BH, Tq, Tk]
    s = torch.where(_mask(Tq, Tk, causal, kv_len, q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if round_p:
        p = p.bfloat16().float()
    return ((p @ vf) / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              kv_len: Optional[int] = None,
                              splits: int = 1) -> torch.Tensor:
    """:func:`flash_attention_ref` computed as the decode kernel splits it:
    the :func:`live_keys` cut by :func:`split_plan` into ``splits`` ranges
    (fewer when there are fewer keys), each range's row maximum m (seeded
    at −1e30), l = Σ exp(s − m) and acc = Σ exp(s − m) v, then, in split
    order, M = max m, w = exp(m − M), out = Σ w·acc / max(Σ w·l, 1e-30)."""
    BH, Tq, d = q.shape
    BHkv, Tk, dv = v.shape
    n_rep = BH // BHkv
    kend = live_keys(Tq, Tk, causal, kv_len)
    n, kps = split_plan(kend, splits)
    kf = k.float()[:, :kend].repeat_interleave(n_rep, dim=0)
    vf = v.float()[:, :kend].repeat_interleave(n_rep, dim=0)
    s = (q.float() @ kf.transpose(1, 2)) * (1.0 / math.sqrt(d))
    s = torch.where(_mask(Tq, Tk, causal, kv_len, q.device)[:, :kend], s,
                    NEG_INF)
    parts = []
    for i in range(n):
        si = s[..., i * kps:(i + 1) * kps]
        m = si.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.exp(si - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      p @ vf[:, i * kps:(i + 1) * kps]))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    acc = torch.zeros((BH, Tq, dv), dtype=torch.float32, device=q.device)
    for m, l, a in parts:
        w = torch.exp(m - M)
        L = L + w * l
        acc = acc + w * a
    return (acc / L.clamp_min(1e-30)).to(q.dtype)
