"""The model stack of the dense family as an ``nn.Module``.

The port of ``repro.models.model`` for models whose every layer is a GQA
attention block followed by a SwiGLU MLP, with RMSNorm: llama3.2-3b,
yi-6b, deepseek-7b, minitron-8b and qwen2-vl-2b (embeddings in, M-RoPE).
The reference scans over stacked periods of layers; here the layers are
an ``nn.ModuleList`` in absolute order, walked in a Python loop, so its
``remat`` and ``scan_layers`` have no meaning.  A configuration that needs
a block not ported yet (MLA, MoE, GELU MLP, LayerNorm, Mamba, RWKV) raises
``NotImplementedError`` when the model is built.

    model = init_params(cfg, seed=0)              # on the card
    logits, _ = model({"tokens": tokens})         # full-sequence forward
    cache = model.init_cache(batch, max_seq)
    logits, cache = model.decode_step({"tokens": tok}, cache, t)
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .config import ModelConfig
from .layers import (GQA, RMSNorm, SwiGLU, dense_init_, embed_init_,
                     empty_param)

PORTED_BLOCKS = ("attn", "swiglu")


def _check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first block of ``cfg`` that
    the PyTorch package does not have yet."""
    if cfg.norm_type != "rms":
        raise NotImplementedError(
            f"{cfg.name}: the '{cfg.norm_type}' norm block is not ported to "
            "PyTorch yet; see ROADMAP.md")
    for i in range(cfg.n_layers):
        mixer, ffn = cfg.layer_spec(i)
        if mixer == "attn" and cfg.attn_type != "gqa":
            mixer = cfg.attn_type
        for block in (mixer, ffn):
            if block not in PORTED_BLOCKS:
                raise NotImplementedError(
                    f"{cfg.name}: layer {i} needs the '{block}' block, which "
                    "is not ported to PyTorch yet; see ROADMAP.md")


class Block(nn.Module):
    """norm → GQA → residual, norm → SwiGLU → residual."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device, dtype=dtype)
        self.mixer = GQA(cfg, device=device, dtype=dtype)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device, dtype=dtype)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()
        self.mixer.reset_parameters(generator)
        self.ffn.reset_parameters(generator)

    def forward(self, x, positions, cache=None, cache_index: int = 0):
        mo, cache = self.mixer(self.norm1(x), positions, cache, cache_index)
        x = x + mo
        return x + self.ffn(self.norm2(x)), cache


class Model(nn.Module):
    """``n_layers`` blocks between the embedding and the LM head, with the
    reference's parameter names (``embed`` [vocab, D], ``lm_head`` [D,
    vocab], ``final_norm.w``, ``blocks.<layer>.{norm1,norm2}.w``,
    ``.mixer.{wq,wk,wv,wo}``, ``.ffn.{w_gate,w_up,w_down}``).  The
    parameters are allocated, not initialised: :func:`init_params` draws
    them, :func:`repro_torch.carry.model_params_from_arrays` copies them."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        dtype = dtype or cfg.torch_dtype
        self.cfg = cfg
        if cfg.embed_input:
            self.embed = empty_param(cfg.vocab, cfg.d_model, device=device,
                                     dtype=dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device,
                                  dtype=dtype)
        self.lm_head = empty_param(cfg.d_model, cfg.vocab, device=device,
                                   dtype=dtype)
        self.blocks = nn.ModuleList(Block(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions (``layers.py`` ``dense_init`` /
        ``embed_init``, norms at 1), drawn from ``generator`` in parameter
        order."""
        if self.cfg.embed_input:
            embed_init_(self.embed, generator)
        dense_init_(self.lm_head, generator)
        self.final_norm.reset_parameters()
        for blk in self.blocks:
            blk.reset_parameters(generator)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> List[dict]:
        """One ``{'k', 'v'}`` of zeros [batch, max_seq, Hkv, hd] a layer, in
        layer order (the reference stacks them by scan period)."""
        cfg = self.cfg
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        dtype = dtype or self.dtype
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(cfg.n_layers)]

    def _embed(self, batch: dict) -> torch.Tensor:
        if self.cfg.embed_input and "tokens" in batch:
            return self.embed[batch["tokens"]]
        return batch["embeds"].to(self.dtype)

    def _positions(self, batch: dict, B: int, T: int, offset: int):
        if "positions" in batch:
            return batch["positions"]
        pos = (offset + torch.arange(T, device=self.device))[None, :].expand(B, T)
        if self.cfg.mrope:
            return pos[None].expand(3, B, T)   # text-only stub: t = h = w
        return pos

    def forward(self, batch: dict, cache: Optional[List[dict]] = None,
                cache_index: int = 0):
        """Returns (logits [B, T, vocab], cache).  ``cache=None``: the
        full-sequence (causal) forward.  With a cache, ``batch`` holds one
        token a sequence at position ``cache_index``; the cache is updated
        in place."""
        x = self._embed(batch)
        B, T = x.shape[0], x.shape[1]
        if cache is not None and T != 1:
            raise ValueError(
                f"forward with a KV cache takes one token a step, got T = {T}: "
                "the reference's cached forward attends non-causally within "
                "a multi-token chunk (repro/models/layers.py, gqa_apply → "
                "decode_attention_sharded → sdpa_simple(causal=False)), so it "
                "differs from the uncached forward; prefill token by token "
                "through the serve step, or run forward without a cache")
        positions = self._positions(batch, B, T,
                                    cache_index if cache is not None else 0)
        for i, blk in enumerate(self.blocks):
            x, _ = blk(x, positions, None if cache is None else cache[i],
                       cache_index)
        return self.final_norm(x) @ self.lm_head, cache

    def decode_step(self, batch: dict, cache: List[dict], cache_index: int):
        """One-token serve step: (logits [B, vocab], cache)."""
        logits, cache = self(batch, cache=cache, cache_index=cache_index)
        return logits[:, -1], cache


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Model:
    """A :class:`Model` drawn from ``generator`` (a fresh one seeded with
    ``seed`` on the model's device when None)."""
    model = Model(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    model.reset_parameters(generator)
    return model
