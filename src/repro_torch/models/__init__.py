"""The LLM model stack of the PyTorch package: dense GQA, MoE and the
Mamba hybrid."""

from .config import ModelConfig, ShapeConfig  # noqa: F401
from .model import Model, init_params  # noqa: F401
