"""RWKV6 "Finch" 7B [arXiv:2404.05892]. Attention-free, data-dependent decay.

32L, d_model=4096, d_ff=14336, vocab=65536; time-mix heads of dim 64.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # d_model / rwkv_head_dim (bookkeeping only)
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    block_pattern=("rwkv",),
    rwkv_head_dim=32,
    dtype="float32",
)

# Attention-free: O(1) recurrent state → long_500k runs.
SHAPE_SKIPS: dict = {}
