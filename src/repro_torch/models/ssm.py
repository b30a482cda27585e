"""State-space blocks in PyTorch: the Mamba mixer of Jamba and RWKV-6's
time mix and channel mix.

The port of ``repro.models.ssm``.  Mamba (arXiv:2312.00752:
diagonal A, per-channel Δ).  The reference runs the recurrence as XLA
twins of ``kernels/linear_scan``: ``_mamba_scan_seq`` (``mode="scan"``,
also the decode step) and ``_mamba_scan_chunked`` (``mode="chunked"``,
an associative scan inside chunks).  Both compute the kernel's function,
so here one path serves both, and the port has no mode: one call of the
Mamba-scan kernel's wrapper (``kernels.linear_scan.ops.mamba_scan``),
which forms the decay ``a = exp(Δ·A)`` and the input ``b·x = (Δ·x)·B``
in registers, runs the recurrence and adds the skip ``x·D``.  RWKV-6
(arXiv:2404.05892, "Finch": data-dependent decay): the reference's
``lax.scan`` over its step is one call of the wkv6 kernel's wrapper
(``kernels.rwkv.ops.wkv6``) a layer, at prefill and at decode.

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
from repro_torch.kernels.rwkv.ops import wkv6

from .layers import dense_init_, empty_param, rms_norm


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


# -- RWKV-6 -------------------------------------------------------------------

def _shifted(x: torch.Tensor, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """The token shift: each position's previous token, the first one's
    from ``shift`` [B, D] (the last token of the previous call) or zeros."""
    first = (torch.zeros_like(x[:, :1]) if shift is None
             else shift[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


class RWKV6(nn.Module):
    """RWKV-6's time mix (the reference's ``rwkv6_init`` / ``rwkv6_apply``,
    ``ssm.py:179-247``): the token-shift mixes ``mu_r``, ``mu_k``,
    ``mu_v``, ``mu_w`` [D]; ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_out``
    [D, D]; the decay's ``decay_base`` [D] (float32) and its LoRA
    ``decay_lora_a`` [D, lora], ``decay_lora_b`` [lora, D] (lora =
    max(D/16, 32)); the bonus ``bonus_u`` [H, hd] (float32); ``ln_w``
    [D]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, hd = cfg.d_model, cfg.rwkv_head_dim
        lora = max(D // 16, 32)
        self.cfg = cfg
        f32 = torch.float32
        for n in ("mu_r", "mu_k", "mu_v", "mu_w"):
            setattr(self, n, empty_param(D, device=device, dtype=dtype))
        for n in ("w_r", "w_k", "w_v", "w_g"):
            setattr(self, n, empty_param(D, D, device=device, dtype=dtype))
        self.decay_base = empty_param(D, device=device, dtype=f32)
        self.decay_lora_a = empty_param(D, lora, device=device, dtype=dtype)
        self.decay_lora_b = empty_param(lora, D, device=device, dtype=dtype)
        self.bonus_u = empty_param(D // hd, hd, device=device, dtype=f32)
        self.w_out = empty_param(D, D, device=device, dtype=dtype)
        self.ln_w = empty_param(D, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``rwkv6_init``: mixes 0.5, ``decay_base`` −0.5,
        ``ln_w`` 1, the weights the distribution of ``dense_init`` (the
        LoRA's second factor at scale 0.01, the bonus at 0.1)."""
        for n in ("mu_r", "mu_k", "mu_v", "mu_w"):
            getattr(self, n).fill_(0.5)
        for w in (self.w_r, self.w_k, self.w_v, self.w_g, self.decay_lora_a):
            dense_init_(w, generator)
        dense_init_(self.decay_lora_b, generator, scale=0.01)
        dense_init_(self.bonus_u, generator, scale=0.1)
        dense_init_(self.w_out, generator)
        self.decay_base.fill_(-0.5)
        self.ln_w.fill_(1.0)

    def forward(self, x: torch.Tensor, state: Optional[dict] = None):
        """x [B, T, D] → (out [B, T, D], state).  ``state`` (decode) =
        {'S': [B, H, hd, hd] float32, 'shift': [B, D]}: the shift supplies
        the first token's previous one and the recurrence starts from S;
        the new state comes back (None without one).  The decay is
        ``exp(−exp(clip(decay_base + lora, −8, 4)))`` in float32; r, k, v
        and the recurrence run in float32 (one :func:`~repro_torch.kernels.
        rwkv.ops.wkv6` call), y is cast back, RMS-normed with ``ln_w`` and
        gated by ``silu(mix_w · w_g)``."""
        cfg = self.cfg
        B, T, D = x.shape
        hd = cfg.rwkv_head_dim
        H = D // hd
        prev = _shifted(x, None if state is None else state["shift"])

        def mix(mu):
            return x * mu + prev * (1 - mu)

        r, k, v = ((mix(mu) @ wt).reshape(B, T, H, hd).float()
                   for mu, wt in ((self.mu_r, self.w_r), (self.mu_k, self.w_k),
                                  (self.mu_v, self.w_v)))
        dec_in = mix(self.mu_w)
        g = F.silu(dec_in @ self.w_g)
        lora = torch.tanh(dec_in @ self.decay_lora_a) @ self.decay_lora_b
        logw = -torch.exp(torch.clamp(self.decay_base + lora.float(),
                                      -8.0, 4.0))
        w = torch.exp(logw).reshape(B, T, H, hd)
        y, S = wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                    w.contiguous(), self.bonus_u,
                    None if state is None else state["S"].contiguous())
        y = rms_norm(y.reshape(B, T, D).to(x.dtype), self.ln_w,
                     cfg.norm_eps) * g
        out = y @ self.w_out
        return out, ({"S": S, "shift": x[:, -1]} if state is not None
                     else None)


class RWKVChannelMix(nn.Module):
    """RWKV's channel mix (the reference's ``rwkv_channel_mix``,
    ``ssm.py:257-276``): ``mu`` [D], ``w_in`` [D, F], ``w_out`` [F, D];
    ``relu(·)²`` between the two products."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, F_ = cfg.d_model, cfg.d_ff
        self.mu = empty_param(D, device=device, dtype=dtype)
        self.w_in = empty_param(D, F_, device=device, dtype=dtype)
        self.w_out = empty_param(F_, D, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mu.fill_(0.5)
        dense_init_(self.w_in, generator)
        dense_init_(self.w_out, generator)

    def forward(self, x: torch.Tensor, shift: Optional[torch.Tensor] = None):
        """x [B, T, D] → (out [B, T, D], the last token [B, D], the next
        call's ``shift``)."""
        prev = _shifted(x, shift)
        xm = x * self.mu + prev * (1 - self.mu)
        h = torch.square(F.relu(xm @ self.w_in))
        return h @ self.w_out, x[:, -1]


def rwkv6_init_state(cfg, batch: int, dtype: torch.dtype = torch.float32,
                     device=None) -> dict:
    """Zeros: {'S': [batch, H, hd, hd] float32, 'shift': [batch, D] in
    ``dtype``}."""
    hd = cfg.rwkv_head_dim
    return {"S": torch.zeros((batch, cfg.d_model // hd, hd, hd),
                             dtype=torch.float32, device=device),
            "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device)}


__all__ = ["Mamba", "mamba_init_state", "RWKV6", "RWKVChannelMix",
           "rwkv6_init_state"]
