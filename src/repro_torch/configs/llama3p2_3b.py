"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B; unverified].

28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    rope_theta=5e5,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "pure full attention; see DESIGN.md",
}
