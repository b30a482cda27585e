"""Architecture config schema (one instance per assigned architecture).

A copy of ``repro.models.config`` for the PyTorch package: the same
fields, layer layout and analytic counts, with ``torch_dtype`` in place of
``jnp_dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention
    attn_type: str = "gqa"           # gqa | mla | none
    causal: bool = True
    rope_theta: float = 1e4
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # Qwen2-VL t/h/w freq split

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1               # MoE FFN on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    first_dense_layers: int = 0      # leading layers with dense FFN (DeepSeek-V2)
    capacity_factor: float = 1.25    # MoE dispatch capacity (E/K = dropless)

    # mixer pattern, cycled across layers: entries in {"attn", "mamba", "rwkv"}
    block_pattern: Tuple[str, ...] = ("attn",)

    # SSM (Mamba)
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_mode: str = "scan"           # scan (exact lax.scan) | chunked (assoc-scan)

    # RWKV
    rwkv_head_dim: int = 64

    # embeddings / head
    embed_input: bool = True         # False: inputs are precomputed embeddings (stub frontends)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    norm_type: str = "rms"           # rms | layer (hubert)
    ffn_type: str = "swiglu"         # swiglu | gelu | rwkv_cm

    # numerics / runtime
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # group this many base periods into one scan step: fewer period-boundary
    # activation saves (remat checkpoints) at the cost of a bigger scan body
    scan_period_multiplier: int = 1

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    # ---- layer layout -------------------------------------------------------
    @property
    def period_len(self) -> int:
        base = len(self.block_pattern)
        if self.n_experts and self.moe_every > 1:
            base = _lcm(base, self.moe_every)
        return base * self.scan_period_multiplier

    @property
    def n_prefix_layers(self) -> int:
        return self.first_dense_layers

    @property
    def n_periods(self) -> int:
        body = self.n_layers - self.n_prefix_layers
        if body % self.period_len:
            raise ValueError(f"{self.name}: {body} body layers not divisible "
                             f"by period {self.period_len}")
        return body // self.period_len

    def layer_spec(self, idx: int) -> tuple[str, str]:
        """(mixer, ffn) for absolute layer index."""
        mixer = self.block_pattern[idx % len(self.block_pattern)]
        if idx < self.first_dense_layers:
            ffn = self.ffn_type
        elif self.n_experts and (idx % self.moe_every == self.moe_offset):
            ffn = "moe"
        else:
            ffn = self.ffn_type
        if mixer == "rwkv":
            ffn = "rwkv_cm"
        return mixer, ffn

    def period_specs(self, period_pos: int = 0) -> list:
        """Layer specs for one scan period (offset past prefix layers)."""
        start = self.n_prefix_layers
        return [self.layer_spec(start + i) for i in range(self.period_len)]

    # ---- analytic FLOPs (per token, fwd only) — used by the tracer ----------
    def flops_per_token_fwd(self, seq_len: int, decode: bool = False) -> float:
        D, H, Hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        total = 0.0
        ctx = seq_len if decode else seq_len / 2  # avg causal context
        for i in range(self.n_layers):
            mixer, ffn = self.layer_spec(i)
            if mixer == "attn":
                if self.attn_type == "mla":
                    r, dn, dr, dv = (self.kv_lora_rank, self.qk_nope_head_dim,
                                     self.qk_rope_head_dim, self.v_head_dim)
                    proj = D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D
                    attn = H * ((dn + dr) + dv) * ctx
                else:
                    proj = D * (H * hd) + 2 * D * (Hkv * hd) + (H * hd) * D
                    attn = H * hd * 2 * ctx
                total += 2 * (proj + attn)
            elif mixer == "mamba":
                Di = self.ssm_expand * D
                S = self.ssm_state_dim
                dtr = max(Di // 16, 1)
                total += 2 * (D * 2 * Di + Di * (2 * S + dtr) + dtr * Di
                              + Di * S * 3 + Di * D)
            elif mixer == "rwkv":
                total += 2 * (5 * D * D + (D // self.rwkv_head_dim)
                              * self.rwkv_head_dim ** 2 * 2)
            if ffn == "moe":
                F = self.moe_d_ff
                total += 2 * (3 * D * F * self.top_k + D * self.n_experts
                              + 3 * D * F * self.n_shared_experts)
            elif ffn == "rwkv_cm":
                total += 2 * (2 * D * self.d_ff)
            else:
                mult = 3 if self.ffn_type == "swiglu" else 2
                total += 2 * (mult * D * self.d_ff)
        total += 2 * D * self.vocab  # lm head
        return total

    # ---- analytic param count ------------------------------------------------
    def param_count(self) -> float:
        D = self.d_model
        total = 0.0
        if self.embed_input:
            total += self.vocab * D
        total += self.vocab * D  # head
        for i in range(self.n_layers):
            mixer, ffn = self.layer_spec(i)
            if mixer == "attn":
                if self.attn_type == "mla":
                    r, dn, dr, dv = (self.kv_lora_rank, self.qk_nope_head_dim,
                                     self.qk_rope_head_dim, self.v_head_dim)
                    total += (D * self.n_heads * (dn + dr) + D * (r + dr)
                              + r * self.n_heads * (dn + dv) + self.n_heads * dv * D)
                else:
                    total += (D * self.n_heads * self.head_dim
                              + 2 * D * self.n_kv_heads * self.head_dim
                              + self.n_heads * self.head_dim * D)
            elif mixer == "mamba":
                Di = self.ssm_expand * D
                S = self.ssm_state_dim
                dtr = max(Di // 16, 1)
                total += D * 2 * Di + Di * (2 * S + dtr) + dtr * Di + Di * S + Di * D
            elif mixer == "rwkv":
                total += 5 * D * D
            if ffn == "moe":
                total += (3 * D * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
                          + D * self.n_experts)
            elif ffn == "rwkv_cm":
                total += 2 * D * self.d_ff
            else:
                mult = 3 if self.ffn_type == "swiglu" else 2
                total += mult * D * self.d_ff
        return total

    def active_param_count(self) -> float:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        dense = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.layer_spec(i)[1] == "moe")
        unused = (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
        return dense - n_moe_layers * unused


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
