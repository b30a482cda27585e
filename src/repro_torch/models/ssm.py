"""State-space blocks in PyTorch: the Mamba mixer of Jamba.

The port of the Mamba part of ``repro.models.ssm`` (arXiv:2312.00752:
diagonal A, per-channel Δ).  The reference runs the recurrence as XLA
twins of ``kernels/linear_scan``: ``_mamba_scan_seq`` (``mode="scan"``,
also the decode step) and ``_mamba_scan_chunked`` (``mode="chunked"``,
an associative scan inside chunks).  Both compute the kernel's function,
so here one path serves both, and the port has no mode: one call of the
Mamba-scan kernel's wrapper (``kernels.linear_scan.ops.mamba_scan``),
which forms the decay ``a = exp(Δ·A)`` and the input ``b·x = (Δ·x)·B``
in registers, runs the recurrence and adds the skip ``x·D``.  RWKV-6 is
not ported yet (``ROADMAP.md``).

Dtype policy as in the reference: the projections and the causal conv in
the model's dtype; Δ, the decay, the input, C, the scan and the skip in
float32, y cast back before the gate.  ``dt_bias``, ``A_log`` and ``D``
are float32 parameters in every model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.linear_scan.ops import mamba_scan

from .layers import dense_init_, empty_param


def _dims(cfg):
    """(Di, S, K, dt_rank) of a config's Mamba block."""
    Di = cfg.ssm_expand * cfg.d_model
    return Di, cfg.ssm_state_dim, cfg.ssm_conv_dim, max(Di // 16, 1)


class Mamba(nn.Module):
    """The Mamba mixer with the reference's parameters: ``w_in`` [D, 2·Di]
    (x and z), ``conv_w`` [K, Di], ``conv_b`` [Di], ``w_bcdt`` [Di, 2·S +
    dt_rank] (B, C, Δ's low rank), ``w_dt`` [dt_rank, Di], ``dt_bias``
    [Di], ``A_log`` [Di, S] and ``D`` [Di] (those three float32), ``w_out``
    [Di, D]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D = cfg.d_model
        Di, S, K, dtr = _dims(cfg)
        self.cfg = cfg
        f32 = torch.float32
        self.w_in = empty_param(D, 2 * Di, device=device, dtype=dtype)
        self.conv_w = empty_param(K, Di, device=device, dtype=dtype)
        self.conv_b = empty_param(Di, device=device, dtype=dtype)
        self.w_bcdt = empty_param(Di, 2 * S + dtr, device=device, dtype=dtype)
        self.w_dt = empty_param(dtr, Di, device=device, dtype=dtype)
        self.dt_bias = empty_param(Di, device=device, dtype=f32)
        self.A_log = empty_param(Di, S, device=device, dtype=f32)
        self.D = empty_param(Di, device=device, dtype=f32)
        self.w_out = empty_param(Di, D, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``mamba_init``: the weights from ``generator``
        (the distribution of ``dense_init``), ``conv_b`` 0, ``dt_bias`` =
        log(expm1(u)) with u ~ U(1e-3, 0.1) from numpy's
        ``default_rng(0)`` (the reference's numbers), ``A_log`` = log(1..S)
        on every channel, ``D`` 1."""
        Di, S, _, _ = _dims(self.cfg)
        dense_init_(self.w_in, generator)
        dense_init_(self.conv_w, generator, scale=0.5)
        self.conv_b.zero_()
        dense_init_(self.w_bcdt, generator)
        dense_init_(self.w_dt, generator)
        u = np.random.default_rng(0).uniform(1e-3, 0.1, Di)
        self.dt_bias.copy_(torch.from_numpy(
            np.log(np.expm1(u)).astype(np.float32)))
        A = torch.arange(1, S + 1, dtype=torch.float32).expand(Di, S)
        self.A_log.copy_(torch.log(A))
        self.D.fill_(1.0)
        dense_init_(self.w_out, generator)

    def forward(self, x: torch.Tensor, state: Optional[dict] = None):
        """x [B, T, D] → (out [B, T, D], state).  ``state`` (decode) =
        {'h': [B, Di, S] float32, 'conv': [B, K−1, Di]}: the conv window
        is stitched from its tail and the scan starts from its h; the new
        state comes back (None without one)."""
        B, T, _ = x.shape
        Di, S, K, _ = _dims(self.cfg)
        xs, z = (x @ self.w_in).chunk(2, dim=-1)                 # [B, T, Di]

        # depthwise causal conv over time: the reference's feature-grouped
        # conv_general_dilated (NWC, WIO) is a cross-correlation, so the
        # taps go in unflipped as [Di, 1, K]
        if state is not None:
            xs_full = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
        else:
            xs_full = F.pad(xs, (0, 0, K - 1, 0))
        new_conv = xs_full[:, T:].contiguous()                  # last K − 1
        xs = F.conv1d(xs_full.transpose(1, 2),
                      self.conv_w.t().to(xs.dtype)[:, None, :],
                      groups=Di).transpose(1, 2)
        xs = F.silu(xs + self.conv_b)

        Bm, Cm, dt_r = (xs @ self.w_bcdt).split([S, S, self.w_dt.shape[0]],
                                                 dim=-1)
        dt = F.softplus((dt_r @ self.w_dt).float() + self.dt_bias)  # [B,T,Di]
        A = -torch.exp(self.A_log)                               # [Di, S]
        h0 = (state["h"] if state is not None else
              torch.zeros((B, Di, S), dtype=torch.float32, device=x.device))
        # the conv leaves xs channel-major ([B, Di, T] in memory): the one
        # copy, [B, T, Di] in the model's dtype (134 MB at a 4096-token
        # bf16 prefill of Di 16384), happens only for T > 1; Bm and Cm go
        # in as the strided views split gives (the kernel takes their row
        # strides)
        y, h = mamba_scan(xs.contiguous(), dt, A, Bm, Cm, self.D,
                          h0.contiguous())
        out = (y * F.silu(z)) @ self.w_out
        return out, ({"h": h, "conv": new_conv} if state is not None else None)


def mamba_init_state(cfg, batch: int, dtype: torch.dtype = torch.float32,
                     device=None) -> dict:
    """Zeros: {'h': [batch, Di, S] float32, 'conv': [batch, K−1, Di] in
    ``dtype``}."""
    Di, S, K, _ = _dims(cfg)
    return {"h": torch.zeros((batch, Di, S), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, K - 1, Di), dtype=dtype,
                                device=device)}


__all__ = ["Mamba", "mamba_init_state"]
