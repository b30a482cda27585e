"""The model stack as an ``nn.Module``.

The port of ``repro.models.model``: layers that mix a GQA or MLA
attention, a Mamba block or RWKV-6's time mix with a SwiGLU MLP, an MoE, a
GELU MLP or RWKV's channel mix, under RMSNorm or LayerNorm — the dense
llama3.2-3b, yi-6b, deepseek-7b, minitron-8b and qwen2-vl-2b (embeddings
in, M-RoPE), grok-1-314b (MoE on every layer), the hybrid
jamba-1.5-large-398b (Mamba and attention, MoE on every other layer),
deepseek-v2-lite-16b (MLA, MoE with shared experts past a dense first
layer), rwkv6-7b, and the encoder hubert-xlarge (frame embeddings in,
non-causal attention, LayerNorm, GELU MLP).  Layer ``i`` is built from
``cfg.layer_spec(i)``.  The reference scans over stacked periods of
layers; here the layers are an ``nn.ModuleList`` in absolute order, walked
in a Python loop, so its ``remat`` and ``scan_layers`` have no meaning.

    model = init_params(cfg, seed=0)              # on the card
    logits, _ = model({"tokens": tokens})         # full-sequence forward
    logits, _, aux = model({"tokens": tokens}, return_aux=True)
    cache = model.init_cache(batch, max_seq)
    logits, cache = model.decode_step({"tokens": tok}, cache, t)
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .config import ModelConfig
from .layers import (GELUMLP, GQA, MLA, MoE, SwiGLU, dense_init_, embed_init_,
                     empty_param, make_norm)
from .ssm import (RWKV6, Mamba, RWKVChannelMix, mamba_init_state,
                  rwkv6_init_state)


def _mixer(cfg: ModelConfig, mixer: str, **kw) -> nn.Module:
    """The mixer of a layer spec (the reference's ``block_init``; a name
    it does not know raises ``ValueError``, as there)."""
    if mixer == "attn":
        if cfg.attn_type not in ("gqa", "mla"):
            raise ValueError(cfg.attn_type)
        return (MLA if cfg.attn_type == "mla" else GQA)(cfg, **kw)
    if mixer == "mamba":
        return Mamba(cfg, **kw)
    if mixer == "rwkv":
        return RWKV6(cfg, **kw)
    raise ValueError(mixer)


def _ffn(cfg: ModelConfig, ffn: str, **kw) -> nn.Module:
    """The FFN of a layer spec; an unknown name raises ``ValueError``."""
    if ffn == "moe":
        return MoE(cfg, **kw)
    if ffn == "gelu":
        return GELUMLP(cfg.d_model, cfg.d_ff, **kw)
    if ffn == "rwkv_cm":
        return RWKVChannelMix(cfg, **kw)
    if ffn == "swiglu":
        return SwiGLU(cfg.d_model, cfg.d_ff, **kw)
    raise ValueError(ffn)


class Block(nn.Module):
    """norm → mixer (GQA, MLA, Mamba or RWKV-6) → residual, norm → FFN
    (SwiGLU, MoE, GELU MLP or RWKV's channel mix) → residual, for the
    layer spec ``(mixer, ffn)``; the norms are the config's (RMSNorm or
    LayerNorm)."""

    def __init__(self, cfg: ModelConfig, spec: tuple, *, device, dtype):
        super().__init__()
        mixer, ffn = spec
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.spec = spec
        self.norm1 = make_norm(cfg, **kw)
        self.mixer = _mixer(cfg, mixer, **kw)
        self.norm2 = make_norm(cfg, **kw)
        self.ffn = _ffn(cfg, ffn, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()
        self.mixer.reset_parameters(generator)
        self.ffn.reset_parameters(generator)

    def forward(self, x, positions, cache=None, cache_index: int = 0):
        """Returns (x, cache, aux): the layer's cache updated in place, and
        the MoE's aux loss (None without an MoE)."""
        h = self.norm1(x)
        if self.spec[0] == "attn":
            mo, cache = self.mixer(h, positions, cache, cache_index)
        else:
            # Mamba: the reference's scan modes (cfg.ssm_mode) compute one
            # function, the port runs the Mamba-scan kernel for both
            mo, state = self.mixer(h, cache)
            if cache is not None:
                cache.update(state)
        x = x + mo
        h = self.norm2(x)
        aux = None
        if self.spec[1] == "moe":
            fo, aux = self.ffn(h)
        elif self.spec[1] == "rwkv_cm":
            fo, shift = self.ffn(h, None if cache is None
                                 else cache["cm_shift"])
            if cache is not None:
                cache["cm_shift"] = shift
        else:
            fo = self.ffn(h)
        return x + fo, cache, aux


class Model(nn.Module):
    """``n_layers`` blocks between the embedding and the LM head, with the
    reference's parameter names (``embed`` [vocab, D], ``lm_head`` [D,
    vocab], ``final_norm.w`` (and ``.b`` under LayerNorm),
    ``blocks.<layer>.{norm1,norm2}.w``, ``.mixer.{wq,wk,wv,wo}``, MLA's
    ``.mixer.{wq,wkv_a,kv_norm,wkv_b,wo}``, Mamba's ``.mixer.{w_in,
    conv_w,...}`` or RWKV-6's ``.mixer.{mu_r,...,w_out,ln_w}``,
    ``.ffn.{w_gate,w_up,w_down}``, the MoE's ``.ffn.{router,w_gate,w_up,
    w_down,shared.*}``, the GELU MLP's ``.ffn.{w_in,b_in,w_out,b_out}``
    or the channel mix's ``.ffn.{mu,w_in,w_out}``).  The
    parameters are allocated, not initialised: :func:`init_params` draws
    them, :func:`repro_torch.carry.model_params_from_arrays` copies them."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or cfg.torch_dtype
        self.cfg = cfg
        if cfg.embed_input:
            self.embed = empty_param(cfg.vocab, cfg.d_model, device=device,
                                     dtype=dtype)
        self.final_norm = make_norm(cfg, device=device, dtype=dtype)
        self.lm_head = empty_param(cfg.d_model, cfg.vocab, device=device,
                                   dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.layer_spec(i), device=device, dtype=dtype)
            for i in range(cfg.n_layers))

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
        """A cache of zeros a layer, in layer order (the reference's
        ``block_cache_init``, which stacks them by scan period):
        ``{'k', 'v'}`` [batch, max_seq, Hkv, hd] for a GQA layer, ``{'ckv'``
        [batch, max_seq, r_kv], ``'krope'`` [batch, max_seq, 1,
        d_rope]``}`` for an MLA layer, ``{'h'`` [batch, Di, S] float32,
        ``'conv'`` [batch, K−1, Di]``}`` for a Mamba layer, ``{'S'``
        [batch, H, hd, hd] float32, ``'shift'`` [batch, D]``}`` for an
        RWKV layer, with ``'cm_shift'`` [batch, D] beside a channel mix."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        caches = []
        for blk in self.blocks:
            mixer, ffn = blk.spec
            if mixer == "attn" and cfg.attn_type == "mla":
                c = {"ckv": zeros(batch, max_seq, cfg.kv_lora_rank),
                     "krope": zeros(batch, max_seq, 1, cfg.qk_rope_head_dim)}
            elif mixer == "attn":
                shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
                c = {"k": zeros(*shape), "v": zeros(*shape)}
            elif mixer == "mamba":
                c = mamba_init_state(cfg, batch, dtype, dev)
            else:
                c = rwkv6_init_state(cfg, batch, dtype, dev)
            if ffn == "rwkv_cm":
                c["cm_shift"] = zeros(batch, cfg.d_model)
            caches.append(c)
        return caches

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
                cache_index: int = 0, return_aux: bool = False):
        """Returns (logits [B, T, vocab], cache), and the sum of the MoE
        layers' aux losses (a float32 scalar, 0 without MoE) as a third
        item when ``return_aux``.  ``cache=None``: the full-sequence
        (causal) forward.  With a cache, ``batch`` holds one token a
        sequence at position ``cache_index``; the cache is updated in
        place."""
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
        aux = None
        for i, blk in enumerate(self.blocks):
            x, _, a = blk(x, positions, None if cache is None else cache[i],
                          cache_index)
            if a is not None:
                aux = a if aux is None else aux + a
        logits = self.final_norm(x) @ self.lm_head
        if not return_aux:
            return logits, cache
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return logits, cache, aux

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
