"""The model stack of the PyTorch package: dense GQA, MoE, the Mamba
hybrid, MLA (DeepSeek-V2), RWKV-6 and the LayerNorm/GELU encoder."""

from .config import ModelConfig, ShapeConfig  # noqa: F401
from .model import Model, init_params  # noqa: F401
