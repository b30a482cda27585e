"""The plain PyTorch version of the wkv6 kernel: RWKV-6's time-mix
recurrence, a loop over T.

The JAX package runs the recurrence as a ``lax.scan`` over
``rwkv6_apply``'s step (``repro/models/ssm.py:233-246``, through
``checkpointed_scan``, ``:27-51``); no TPU kernel computes it.  This is
that step, one elementwise op at a time, so that its state is the
kernel's bit for bit (``csrc/wkv6.cu``).
"""

from __future__ import annotations

from typing import Optional

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             S0: Optional[torch.Tensor] = None):
    """r, k, v, w [B, T, H, hd] float32 (w the decay, in (0, 1)), u [H, hd]
    float32 (the bonus), S0 [B, H, hd, hd] float32 or None (zeros) → (y
    [B, T, H, hd] float32, S [B, H, hd, hd] float32, the state after the
    last step).  Per head, for t = 0 .. T − 1, with S[i, j] over key
    index i and value index j::

        kv  = k_t[i] · v_t[j]
        y_t[j] = Σ_i r_t[i] · (S[i, j] + u[i] · kv)
        S[i, j] = w_t[i] · S[i, j] + kv

    Each product and each add of the state update is one rounded float32
    op (no contraction into an FMA), so S is the kernel's bit for bit; y
    sums over i in another order than the kernel and the reference's
    ``einsum``, and is held to a tolerance."""
    B, T, H, hd = r.shape
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if S0 is None else S0.clone())
    y = torch.empty_like(r)
    uu = u[None, :, :, None]
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, hd, hd]
        y[:, t] = (r[:, t, :, :, None] * (S + uu * kv)).sum(-2)
        S = (w[:, t, :, :, None] * S).add_(kv)
    return y, S


__all__ = ["wkv6_ref"]
