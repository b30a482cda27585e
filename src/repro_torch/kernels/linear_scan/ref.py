"""Plain PyTorch versions of the linear-scan and Mamba-scan kernels.

The recurrence of ``repro/kernels/linear_scan/ref.py``, a Python loop over
time: per (batch b, channel d, state s)

    h_t = a_t ⊙ h_{t−1} + b_t,      y_t[d] = Σ_s h_t[d, s] · c_t[s]

in float32, y cast to a's dtype and the final h kept in float32.  The
Mamba scan is that recurrence with its inputs built and its output
finished as ``repro/models/ssm.py:155-166`` does: a = exp(dt·A), b =
(dt·x)·B, y + x·D, cast to x's dtype.
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


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor):
    """x [B, T, Di] (the model's dtype), dt [B, T, Di] float32, A [Di, S]
    float32, Bm, Cm [B, T, S] (x's dtype), D [Di] float32, h0 [B, Di, S]
    float32 → (y [B, T, Di] in x's dtype, h [B, Di, S] float32).  The
    decay ``a`` and the input ``b·x`` exist as [B, T, Di, S] float32."""
    a = torch.exp_(dt[..., None] * A)                        # [B,T,Di,S]
    xf = x.float()
    bx = (dt * xf)[..., None] * Bm.float()[:, :, None, :]
    y, h = linear_scan_ref(a, bx, Cm.float().contiguous(), h0.contiguous())
    del a, bx
    y = y + xf * D
    return y.to(x.dtype), h


def mamba_decay_ref(dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dt [..., Di], A [Di, S] float32 → exp(dt·A) [..., Di, S]: the Mamba
    scan's decay alone."""
    return torch.exp(dt[..., None] * A)
