"""The serve and prefill steps: the counterparts of ``repro.runtime.steps``'s
``build_serve_step`` and ``build_prefill_step``.  The training step, the
optimizer and the mesh policy are not ported yet (``ROADMAP.md``)."""

from __future__ import annotations

from typing import Callable

from ..models.config import ModelConfig
from ..models.model import Model


def _check(model: Model, cfg: ModelConfig) -> None:
    if model.cfg is not cfg and model.cfg != cfg:
        raise ValueError(f"the model is {model.cfg.name}, the step was built "
                         f"for {cfg.name}")


def build_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(model, batch, cache, cache_index) -> (logits [B, vocab],
    cache): one decode token for the whole batch, the cache updated in
    place."""

    def serve_step(model: Model, batch: dict, cache, cache_index: int):
        _check(model, cfg)
        return model.decode_step(batch, cache, cache_index)

    return serve_step


def build_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill(model, batch) -> logits [B, T, vocab]: the full-sequence
    forward (causal, or not for an encoder such as hubert-xlarge, whose
    batch is ``{"embeds": [B, T, d_model]}`` frame embeddings)."""

    def prefill(model: Model, batch: dict):
        _check(model, cfg)
        logits, _ = model(batch)
        return logits

    return prefill
