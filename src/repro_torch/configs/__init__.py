"""Architecture registry: ``get(name)`` → (full_config, smoke_config)."""

from __future__ import annotations

import importlib

ARCHS = (
    "jamba_1p5_large_398b",
    "deepseek_v2_lite_16b",
    "grok_1_314b",
    "rwkv6_7b",
    "deepseek_7b",
    "yi_6b",
    "llama3p2_3b",
    "minitron_8b",
    "qwen2_vl_2b",
    "hubert_xlarge",
)

# CLI ids (--arch <id>) → module names
ALIASES = {
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "grok-1-314b": "grok_1_314b",
    "rwkv6-7b": "rwkv6_7b",
    "deepseek-7b": "deepseek_7b",
    "yi-6b": "yi_6b",
    "llama3.2-3b": "llama3p2_3b",
    "minitron-8b": "minitron_8b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "hubert-xlarge": "hubert_xlarge",
}


def get(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.FULL, mod.SMOKE


def shape_skips(name: str) -> dict:
    mod_name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return getattr(mod, "SHAPE_SKIPS", {})


def all_archs():
    return [a for a in ALIASES]
