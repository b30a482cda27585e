"""Yi-6B [arXiv:2403.04652]. Llama-arch with aggressive GQA (kv=4).

32L, d_model=4096, 32 heads, d_ff=11008, vocab=64000.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "pure full attention; see DESIGN.md",
}
