from .ops import flash_attention, flash_attention_flat  # noqa: F401
from .ref import flash_attention_ref  # noqa: F401
