#!/usr/bin/env python3
"""Jamba's hybrid serve steps on one CUDA card, for comparing two trees of
the PyTorch package on one card in one run.

    python3 tools/hybrid_steps.py [--src DIR]

Imports ``repro_torch`` from DIR (default: the ``src`` of this checkout),
builds its CUDA kernels, draws jamba-1.5-large-398b at full width cut to
its first 5 layers in bfloat16 from seed 0 (``chip_smoke.py`` phase 9's
cut and weights), and measures

- the 4096-token prefill step: its wall (unprofiled, the mean of 3 after
  a warm-up), the peak device memory of one step (and its rise above what was
  allocated before it), and
  one step under the profiler: device busy, kernels, the elementwise
  kernels' and the Mamba scan's device time;
- one decode step (batch 4 at position 128, as ``chip_smoke.py``
  profiles it): its wall (unprofiled, the mean of 20) and the same
  profile.

Prints one JSON line, with the card's name and power limit.  Run the two
trees in turns (parent, change, change, parent) in one call to compare
them on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

LAYERS = 5
PREFILL_T = 4096
BATCH, POS = 4, 128


def wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile(fn) -> dict:
    """One call of ``fn`` under the profiler: device busy (the sum of the
    device activities), kernel count, and the elementwise kernels' and the
    Mamba scan's device time, from the raw events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    n = busy = elem = scan = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        n += 1
        busy += e.duration_ns()
        if "elementwise" in e.name():
            elem += e.duration_ns()
        if "linear_scan" in e.name() or "mamba_scan" in e.name():
            scan += e.duration_ns()
    return {"wall_ms": secs * 1e3, "busy_ms": busy / 1e6, "kernels": n,
            "elementwise_ms": elem / 1e6, "scan_ms": scan / 1e6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hybrid_steps: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.runtime import build_prefill_step, build_serve_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.build_all()
    cfg = dataclasses.replace(configs.get("jamba-1.5-large-398b")[0],
                              n_layers=LAYERS)
    with torch.no_grad():
        model = init_params(cfg, seed=0)
        g = torch.Generator(device="cuda").manual_seed(1)
        long = torch.randint(0, cfg.vocab, (1, PREFILL_T), device="cuda",
                             generator=g)
        tok = torch.randint(0, cfg.vocab, (BATCH, 1), device="cuda",
                            generator=g)
        prefill = build_prefill_step(cfg)
        step = build_serve_step(cfg)
        cache = model.init_cache(BATCH, POS + 64)

        def prefill_once():
            return prefill(model, {"tokens": long})

        def decode_once():
            return step(model, {"tokens": tok}, cache, POS)

        prefill_once()
        decode_once()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prefill_once()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out = {"src": args.src, "card": smi,
               "prefill": {"wall_ms_unprofiled": wall_ms(prefill_once, 3),
                           "peak_bytes": peak,
                           "peak_above_start_bytes": peak - base,
                           **profile(prefill_once)},
               "decode": {"wall_ms_unprofiled": wall_ms(decode_once, 20),
                          **profile(decode_once)}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
