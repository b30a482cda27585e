"""Model-zoo building blocks of the dense and MoE families, in PyTorch.

The port of ``repro.models.layers``:

  - RMSNorm / LayerNorm
  - RoPE and M-RoPE (Qwen2-VL §3: temporal/height/width sections)
  - the GQA block with its KV cache, whose attention core is the
    flash-attention kernel (``kernels.flash_attention.ops.flash_attention``:
    the counterpart of the reference's ``sdpa``, ``sdpa_simple`` and the
    unsharded branch of ``decode_attention_sharded``, which all compute the
    kernel's function)
  - MLA (DeepSeek-V2) with its compressed KV cache, on the same kernel
  - the SwiGLU MLP and the GELU MLP (HuBERT's)
  - MoE with top-k routing, the reference's capacity-based scatter
    dispatch (GShard-style: static shapes, a drop bucket), shared experts
    and the aux load-balance loss; its expert products are batched
    matrix products, as the reference leaves them to XLA

Weights keep the reference's ``[in, out]`` layout (``x @ W``), so a parameter tree
carries across unchanged (:mod:`repro_torch.carry`).  Dtype policy as in
the reference: params and activations in the config's dtype, norms, RoPE
and softmax in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention


# -- initializers -------------------------------------------------------------

def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: Optional[float] = None) -> torch.Tensor:
    """``normal · scale`` in float32, cast into ``w`` (scale 1/√fan_in,
    fan_in = ``w.shape[0]``): the distribution of the reference's
    ``dense_init``, not its numbers."""
    fan_in = w.shape[0] if w.dim() >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    if w.dim() >= 3:       # expert by expert: no float32 copy of the whole
        for part in w:
            dense_init_(part, generator, scale)
        return w
    x = torch.randn(w.shape, generator=generator, device=w.device,
                    dtype=torch.float32)
    return w.copy_(x * scale)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return dense_init_(w, generator, scale=0.02)


def empty_param(*shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter (the model's initialiser fills it)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# -- norms --------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.w = empty_param(d, device=device, dtype=dtype)

    def reset_parameters(self) -> None:
        self.w.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.w, self.eps)


class LayerNorm(nn.Module):
    """:func:`layer_norm` with ``w`` (ones) and ``b`` (zeros): the
    reference's ``_norm_init`` / ``_norm_apply`` for ``norm_type ==
    "layer"``."""

    def __init__(self, d: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.w = empty_param(d, device=device, dtype=dtype)
        self.b = empty_param(d, device=device, dtype=dtype)

    def reset_parameters(self) -> None:
        self.w.fill_(1.0)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.w, self.b, self.eps)


def make_norm(cfg, *, device, dtype) -> nn.Module:
    """The config's norm over d_model: :class:`LayerNorm` for
    ``norm_type == "layer"``, else :class:`RMSNorm`."""
    cls = LayerNorm if cfg.norm_type == "layer" else RMSNorm
    return cls(cfg.d_model, cfg.norm_eps, device=device, dtype=dtype)


# -- rotary embeddings ----------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] or [3, B, T] for M-RoPE.

    M-RoPE (Qwen2-VL): the head_dim/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position id.
    """
    B, T, H, D = x.shape
    freqs = torch.from_numpy(rope_freqs(D, theta)).to(x.device)   # [D/2]
    if mrope_sections is None:
        ang = positions[..., None].float() * freqs                  # [B,T,D/2]
    else:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs [3, B, T] positions")
        if sum(mrope_sections) != D // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to head_dim / 2 = {D // 2}")
        parts, off = [], 0
        for i, s in enumerate(mrope_sections):
            parts.append(positions[i][..., None].float() * freqs[off:off + s])
            off += s
        ang = torch.cat(parts, dim=-1)                               # [B,T,D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- GQA attention block --------------------------------------------------------

class GQA(nn.Module):
    """Grouped-query attention with RoPE and a KV cache; weights
    ``wq`` [D, H·hd], ``wk``/``wv`` [D, Hkv·hd], ``wo`` [H·hd, D]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = empty_param(D, H * hd, device=device, dtype=dtype)
        self.wk = empty_param(D, Hkv * hd, device=device, dtype=dtype)
        self.wv = empty_param(D, Hkv * hd, device=device, dtype=dtype)
        self.wo = empty_param(H * hd, D, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache=None,
                cache_index: int = 0):
        """Returns (out, cache).  ``cache`` = {'k', 'v'}: [B, S, Hkv, hd],
        updated in place at ``cache_index`` (the reference returns a new
        one; in place keeps one copy of the cache on the card)."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (x @ self.wq).reshape(B, T, H, hd)
        k = (x @ self.wk).reshape(B, T, Hkv, hd)
        v = (x @ self.wv).reshape(B, T, Hkv, hd)
        mrope = cfg.mrope_sections if cfg.mrope else None
        q = apply_rope(q, positions, cfg.rope_theta, mrope)
        k = apply_rope(k, positions, cfg.rope_theta, mrope)
        if cache is None:
            o = flash_attention(q, k, v, causal=cfg.causal)
        else:
            S = cache["k"].shape[1]
            if not 0 <= cache_index <= S - T:
                raise ValueError(f"cache_index {cache_index} + {T} tokens "
                                 f"overruns the {S}-position cache")
            cache["k"][:, cache_index:cache_index + T] = k
            cache["v"][:, cache_index:cache_index + T] = v
            # one kv_len for the batch, as the reference's cached forward
            # builds it (jnp.full((B,), cache_index + T))
            o = flash_attention(q, cache["k"], cache["v"], causal=False,
                                kv_len=cache_index + T)
        return o.reshape(B, T, H * hd) @ self.wo, cache


# -- MLA (DeepSeek-V2) ----------------------------------------------------------

class MLA(nn.Module):
    """Multi-head latent attention (the reference's ``mla_init`` /
    ``mla_apply``, ``layers.py:323-391``): ``wq`` [D, H·(d_nope + d_rope)]
    (no query compression, as in V2-Lite), ``wkv_a`` [D, r_kv + d_rope]
    (the joint KV compression and the decoupled RoPE key), ``kv_norm``
    [r_kv], ``wkv_b`` [r_kv, H·(d_nope + dv)], ``wo`` [H·dv, D]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim, cfg.v_head_dim)
        self.cfg = cfg
        self.wq = empty_param(D, H * (dn + dr), device=device, dtype=dtype)
        self.wkv_a = empty_param(D, r + dr, device=device, dtype=dtype)
        self.kv_norm = empty_param(r, device=device, dtype=dtype)
        self.wkv_b = empty_param(r, H * (dn + dv), device=device, dtype=dtype)
        self.wo = empty_param(H * dv, D, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wkv_a, self.wkv_b, self.wo):
            dense_init_(w, generator)
        self.kv_norm.fill_(1.0)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache=None,
                cache_index: int = 0):
        """Returns (out, cache).  ``cache`` = {'ckv': [B, S, r_kv],
        'krope': [B, S, 1, d_rope]}, the compressed cache, updated in place
        at ``cache_index`` and expanded to per-head keys and values every
        step, as the reference does (no absorbed form).  Attention is the
        flash kernel at head dim d_nope + d_rope for q and k and dv for v
        (softmax scale 1/√(d_nope + d_rope))."""
        cfg = self.cfg
        B, T, _ = x.shape
        H = cfg.n_heads
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim, cfg.v_head_dim)
        q = (x @ self.wq).reshape(B, T, H, dn + dr)
        q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
        kv_a = x @ self.wkv_a                                # [B, T, r + dr]
        ckv = rms_norm(kv_a[..., :r], self.kv_norm, cfg.norm_eps)
        k_rope = apply_rope(kv_a[..., r:][:, :, None, :], positions,
                            cfg.rope_theta)                  # [B, T, 1, dr]
        kv_len = None
        if cache is not None:
            S = cache["ckv"].shape[1]
            if not 0 <= cache_index <= S - T:
                raise ValueError(f"cache_index {cache_index} + {T} tokens "
                                 f"overruns the {S}-position cache")
            cache["ckv"][:, cache_index:cache_index + T] = ckv
            cache["krope"][:, cache_index:cache_index + T] = k_rope
            ckv, k_rope = cache["ckv"], cache["krope"]
            kv_len = cache_index + T
        S = ckv.shape[1]
        kv = (ckv @ self.wkv_b).reshape(B, S, H, dn + dv)
        k = torch.cat([kv[..., :dn], k_rope.expand(B, S, H, dr)], dim=-1)
        q = torch.cat([q[..., :dn], q_rope], dim=-1)
        o = flash_attention(q, k, kv[..., dn:].contiguous(),
                            causal=cfg.causal if cache is None else False,
                            kv_len=kv_len)
        return o.reshape(B, T, H * dv) @ self.wo, cache


# -- MLPs ------------------------------------------------------------------------

class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        self.w_gate = empty_param(d_model, d_ff, device=device, dtype=dtype)
        self.w_up = empty_param(d_model, d_ff, device=device, dtype=dtype)
        self.w_down = empty_param(d_ff, d_model, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class GELUMLP(nn.Module):
    """The reference's ``gelu_mlp`` (``layers.py:407-417``): ``w_in`` [D,
    F], ``b_in`` [F], ``w_out`` [F, D], ``b_out`` [D]; ``jax.nn.gelu``'s
    default, the tanh approximation."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        self.w_in = empty_param(d_model, d_ff, device=device, dtype=dtype)
        self.b_in = empty_param(d_ff, device=device, dtype=dtype)
        self.w_out = empty_param(d_ff, d_model, device=device, dtype=dtype)
        self.b_out = empty_param(d_model, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.w_in, generator)
        dense_init_(self.w_out, generator)
        self.b_in.zero_()
        self.b_out.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(x @ self.w_in + self.b_in, approximate="tanh")
        return h @ self.w_out + self.b_out


# -- Mixture of Experts ----------------------------------------------------------

class MoE(nn.Module):
    """Top-k MoE: ``router`` [D, E] (float32 in every model), ``w_gate`` /
    ``w_up`` [E, D, F], ``w_down`` [E, F, D], and ``shared``, a SwiGLU of
    width F · n_shared_experts, when the config has shared experts."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.cfg = cfg
        self.router = empty_param(D, E, device=device, dtype=torch.float32)
        self.w_gate = empty_param(E, D, F_, device=device, dtype=dtype)
        self.w_up = empty_param(E, D, F_, device=device, dtype=dtype)
        self.w_down = empty_param(E, F_, D, device=device, dtype=dtype)
        self.shared = (SwiGLU(D, F_ * cfg.n_shared_experts, device=device,
                              dtype=dtype)
                       if cfg.n_shared_experts else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init``: router at scale 0.02, the expert
        weights with ``dense_init``'s fan-in (their leading axis, E)."""
        dense_init_(self.router, generator, scale=0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        """x [B, T, D] → (out [B, T, D], aux), the reference's ``moe_apply``:
        softmax routing in float32, top-k gates renormalised by max(sum,
        1e-9), capacity C = max(⌈K·N·cf / E⌉, 4) slots an expert with cf
        the config's ``capacity_factor``; a token's k-th assignment takes
        the next free slot of its expert in token-major order (k inner),
        and assignments past C are dropped (they add nothing).  aux = E · Σ_e f_e · p_e over the top-1
        choices (Switch).  ``torch.topk`` and ``lax.top_k`` may order exact
        ties of probabilities differently; random inputs have none."""
        cfg = self.cfg
        B, T, D = x.shape
        E, K = cfg.n_experts, cfg.top_k
        N = B * T
        xt = x.reshape(N, D)
        probs = torch.softmax(xt.float() @ self.router, dim=-1)     # [N, E]
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)          # [N, K]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        fe = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
        aux = E * torch.sum(fe * probs.mean(dim=0))

        C = max(int(np.ceil(K * N * cfg.capacity_factor / E)), 4)
        flat_idx = gate_idx.reshape(-1)                             # [N·K]
        pos = F.one_hot(flat_idx, E).cumsum(dim=0) - 1    # position in expert
        pos_in_e = pos.gather(1, flat_idx[:, None])[:, 0]
        keep = pos_in_e < C
        dest_e = torch.where(keep, flat_idx, E)           # E: the drop bucket
        dest_c = torch.where(keep, pos_in_e, 0)

        # kept slots are distinct, so setting them equals the reference's
        # scatter-add into zeros; the drop bucket is never read
        buf = torch.zeros((E + 1, C, D), dtype=x.dtype, device=x.device)
        buf[dest_e, dest_c] = xt.repeat_interleave(K, dim=0)
        ex = buf[:E]                                                # [E, C, D]
        h = F.silu(torch.bmm(ex, self.w_gate)) * torch.bmm(ex, self.w_up)
        eo = torch.bmm(h, self.w_down)                              # [E, C, D]

        gathered = eo[dest_e.clamp(max=E - 1), dest_c]              # [N·K, D]
        gathered = torch.where(keep[:, None], gathered, 0.0)
        w = gate_vals.reshape(-1)[:, None].to(x.dtype)
        out = (gathered * w).reshape(N, K, D).sum(dim=1)
        if self.shared is not None:
            out = out + self.shared(xt)
        return out.reshape(B, T, D), aux


__all__ = ["dense_init_", "embed_init_", "rms_norm", "layer_norm", "RMSNorm",
           "LayerNorm", "make_norm", "rope_freqs", "apply_rope", "GQA", "MLA",
           "SwiGLU", "GELUMLP", "MoE", "empty_param"]
