"""Grok-1 (314B total / ~86B active) [hf:xai-org/grok-1; unverified].

64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768, vocab=131072,
MoE 8 experts top-2 on every layer.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="grok-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    n_experts=4,
    top_k=2,
    moe_d_ff=256,
    capacity_factor=2.0,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "pure full attention: 500k KV cache ≈ 537 GB/sequence "
                 "(64L × 8 kv-heads × 128) and quadratic prefill; see DESIGN.md",
}
