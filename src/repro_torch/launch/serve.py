"""Batched serving entry point: prefill a batch of prompts, decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
      --batch 4 --prompt-len 32 --gen 32 --device cpu

The counterpart of ``repro.launch.serve``, with the same flags plus
``--device`` (the CUDA card unless ``cpu`` is asked for).  The prompts are
prefilled token by token through the serve step, as the reference does.
Every decoder of ``repro_torch.configs`` is served (GQA and MLA attention,
Mamba and RWKV-6 mixers); an encoder (hubert-xlarge) has no decode path
and is refused, as there: its entry is the prefill step,
``runtime.build_prefill_step(cfg)(model, {"embeds": x})``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import Model, init_params
from repro_torch.runtime import build_serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor      # [B, gen] greedy tokens
    prefill_s: float          # wall of the P prefill steps (device synced)
    decode_s: float           # wall of the gen − 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen: int) -> ServeResult:
    """Prefill ``prompts`` [B, P] (on the model's device) one token a step
    through the serve step, then decode ``gen`` tokens greedily: P + gen − 1
    serve steps against a cache of P + gen positions."""
    B, P = prompts.shape
    if P < 1 or gen < 1:
        raise ValueError(f"need a prompt and a token to generate, got "
                         f"prompt length {P} and gen {gen}")
    serve = build_serve_step(model.cfg)
    cache = model.init_cache(B, P + gen)
    _sync(model.device)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = serve(model, {"tokens": prompts[:, t:t + 1]}, cache, t)
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(model.device)
    t1 = time.perf_counter()
    out = [tok]
    for t in range(P, P + gen - 1):
        logits, cache = serve(model, {"tokens": tok}, cache, t)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    _sync(model.device)
    return ServeResult(tokens, t1 - t0, time.perf_counter() - t1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    full, smoke = configs.get(args.arch)
    cfg = smoke if args.smoke else full
    if not cfg.embed_input:
        raise SystemExit(f"{args.arch}: encoder/stub-frontend arch has no "
                         f"autoregressive serving path")
    if not cfg.causal:
        raise SystemExit(f"{args.arch}: encoder-only, no decode")

    device = resolve_device(args.device)
    model = init_params(cfg, seed=args.seed, device=device)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab, (B, P), device=device,
                            generator=torch.Generator(device).manual_seed(1))
    res = generate(model, prompts, G)
    print(f"[serve] prefill {P} tok × {B} seqs in {res.prefill_s:.2f}s; "
          f"decoded {G} tok in {res.decode_s:.2f}s "
          f"({B * G / max(res.decode_s, 1e-9):.1f} tok/s) on {device}")
    print("[serve] sample:", res.tokens[0, :16].tolist())
    return res.tokens


if __name__ == "__main__":
    main()
