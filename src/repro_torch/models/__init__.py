"""The LLM model stack (dense family) of the PyTorch package."""

from .config import ModelConfig, ShapeConfig  # noqa: F401
from .model import Model, init_params  # noqa: F401
