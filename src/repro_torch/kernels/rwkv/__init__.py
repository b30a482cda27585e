from .ops import wkv6, wkv6_plan  # noqa: F401
from .ref import wkv6_ref  # noqa: F401
