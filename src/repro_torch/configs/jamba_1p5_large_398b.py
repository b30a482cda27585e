"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887 / 2408.12570].

Hybrid Mamba+attention, attn:mamba = 1:7 (one attention layer per 8-layer
period), MoE every 2nd layer with 16 experts top-2.
72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536.
"""

from repro_torch.models.config import ModelConfig

_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    block_pattern=_PERIOD,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    block_pattern=_PERIOD,
    n_experts=4,
    top_k=2,
    moe_d_ff=256,
    moe_every=2,
    moe_offset=1,
    capacity_factor=2.0,
    ssm_state_dim=8,
    ssm_conv_dim=4,
    ssm_expand=2,
    dtype="float32",
)

# long_500k runs: only 9 of 72 layers carry KV (≈39 GB total at 500k) and the
# Mamba state is O(1) — the hybrid is exactly the sub-quadratic case the
# shape targets.
SHAPE_SKIPS: dict = {}
