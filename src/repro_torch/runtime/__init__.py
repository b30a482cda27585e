"""Serve and prefill steps of the PyTorch package (training is not
ported)."""

from .steps import build_prefill_step, build_serve_step  # noqa: F401
