"""DeepSeek-LLM 7B [arXiv:2401.02954]. Llama-arch, MHA (kv=32).

30L, d_model=4096, 32 heads, d_ff=11008, vocab=102400.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    scan_period_multiplier=2,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "pure full attention (MHA kv=32): 500k KV ≈ 123 GB/sequence; "
                 "see DESIGN.md",
}
