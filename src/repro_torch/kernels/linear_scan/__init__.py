from .ops import linear_scan, mamba_decay, mamba_scan  # noqa: F401
from .ref import linear_scan_ref, mamba_decay_ref, mamba_scan_ref  # noqa: F401
