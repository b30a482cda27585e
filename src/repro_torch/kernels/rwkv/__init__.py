from .ops import wkv6  # noqa: F401
from .ref import wkv6_ref  # noqa: F401
