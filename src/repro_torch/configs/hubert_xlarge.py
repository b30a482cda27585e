"""HuBERT X-Large [arXiv:2106.07447]. Encoder-only (wav2vec2 arch).

48L, d_model=1280, 16 heads, d_ff=5120, vocab=504 (cluster targets).
Encoder: non-causal attention, LayerNorm, GELU FFN.  The convolutional
waveform frontend is a stub per the assignment spec — ``input_specs``
provides precomputed frame embeddings [B, T, 1280].
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    norm_type="layer",
    ffn_type="gelu",
    embed_input=False,
    scan_period_multiplier=4,
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=32,
    causal=False,
    norm_type="layer",
    ffn_type="gelu",
    embed_input=False,
    dtype="float32",
)

SHAPE_SKIPS = {
    "decode_32k": "encoder-only architecture: no autoregressive decode step",
    "long_500k": "encoder-only architecture: no decode step",
}
