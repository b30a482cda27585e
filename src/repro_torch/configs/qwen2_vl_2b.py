"""Qwen2-VL-2B [arXiv:2409.12191]. M-RoPE decoder; vision frontend stubbed.

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
Per the assignment spec, the modality frontend is a stub: ``input_specs``
provides precomputed patch embeddings merged into the token sequence, and
positions are [3, B, T] M-RoPE ids (text stub: t=h=w).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),
    embed_input=False,        # stub frontend supplies merged embeddings
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    mrope=True,
    mrope_sections=(4, 6, 6),
    embed_input=False,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "pure full attention; see DESIGN.md",
}
