"""Plain PyTorch version of the flash-attention kernel.

Dense softmax attention with the TPU kernel's conventions
(``repro/kernels/flash_attention/kernel.py`` ``_attn_kernel``): scores in
float32 from ``q · scale`` with scale 1/√d, a masked score is −1e30 (not
−inf), the row maximum is seeded at −1e30, and the output is
``(p @ v) / max(l, 1e-30)`` cast to q's type.  So a row with no live key
(``kv_len = 0``) averages the values of all Tk keys, as the TPU kernel
does, where the JAX package's ``-inf`` oracle gives NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """q [BH, Tq, d], k [BHkv, Tk, d], v [BHkv, Tk, dv] → [BH, Tq, dv] in
    q's dtype.  Query row b reads key/value row ``b // (BH // BHkv)``;
    key position j is live when ``j < kv_len`` and, if ``causal``, ``j <=``
    the query's position (both counted from 0)."""
    BH, Tq, d = q.shape
    BHkv, Tk, dv = v.shape
    n_rep = BH // BHkv
    qf = q.float() * (1.0 / math.sqrt(d))
    kf = k.float().repeat_interleave(n_rep, dim=0)
    vf = v.float().repeat_interleave(n_rep, dim=0)
    s = qf @ kf.transpose(1, 2)                                  # [BH, Tq, Tk]
    kpos = torch.arange(Tk, device=q.device)
    mask = kpos[None, :] < (Tk if kv_len is None else int(kv_len))
    if causal:
        mask = mask & (kpos[None, :] <= torch.arange(Tq, device=q.device)[:, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ vf) / l.clamp_min(1e-30)).to(q.dtype)
