"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab=1024,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "pure full attention; see DESIGN.md",
}
