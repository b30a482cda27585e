"""DeepSeek-V2-Lite (15.7B total / 2.4B active) [arXiv:2405.04434].

MLA attention (kv_lora_rank=512, decoupled RoPE 64, nope 128, v 128);
MoE: 64 routed top-6 + 2 shared experts, moe_d_ff=1408; layer 0 dense
(d_ff=10944).  27L, d_model=2048, 16 heads, vocab=102400.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab=102400,
    attn_type="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,           # nope + rope
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    scan_period_multiplier=2,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=384,
    vocab=512,
    attn_type="mla",
    kv_lora_rank=64,
    qk_nope_head_dim=32,
    qk_rope_head_dim=16,
    v_head_dim=32,
    head_dim=48,
    n_experts=8,
    n_shared_experts=2,
    top_k=2,
    moe_d_ff=96,
    first_dense_layers=1,
    capacity_factor=4.0,
    dtype="float32",
)

# long_500k runs: MLA's compressed cache is (512+64) per token per layer —
# ≈16 GB total at 500k — and decode attention is linear per step.
SHAPE_SKIPS: dict = {}
