"""Plain PyTorch version of the linear-scan kernel.

The recurrence of ``repro/kernels/linear_scan/ref.py``, a Python loop over
time: per (batch b, channel d, state s)

    h_t = a_t ⊙ h_{t−1} + b_t,      y_t[d] = Σ_s h_t[d, s] · c_t[s]

in float32, y cast to a's dtype and the final h kept in float32.
"""

from __future__ import annotations

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor):
    """a, b [B, T, D, S]; c [B, T, S]; h0 [B, D, S] → (y [B, T, D] in a's
    dtype, h [B, D, S] float32)."""
    B, T, D, _ = a.shape
    h = h0.float()
    y = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = a[:, t].float() * h + b[:, t].float()
        y[:, t] = torch.einsum("bds,bs->bd", h, c[:, t].float())
    return y.to(a.dtype), h
