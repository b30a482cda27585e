from .ops import linear_scan  # noqa: F401
from .ref import linear_scan_ref  # noqa: F401
