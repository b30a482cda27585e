#!/usr/bin/env python3
"""Where the float64 sparse level loop spends its time, and which block
width suits it, on one CUDA card: builds of ``csrc/sparse_levels.cu`` with
its compile-time knobs (the file's header names them), timed side by side.

    python3 tools/levels_probe.py [--reps N] [--only a,b]

Each variant is the package's source built with its -D flags (one nvcc a
variant, all started together) into ``build/probe/``.  Each runs in a
process of its own, every variant twice, in turns.  A variant times
``sparse_levels_f64`` (λ) on the first weight chunk of ``chip_smoke.py``
phase 6's stencil at each of its widths: CUDA events over N launches back
to back, with no synchronize between them.  The variants that keep the
semantics are checked bit-equal to the package's kernel on t, ssum, cho
and csrc, before and after the timed launches:

- ``base``: the package's build;
- ``no_window``: every source row's t and ssum from device memory;
- ``no_ring``: every level's inputs from device memory (the window then
  has the ring's room too);
- ``ring_d4``: the ring 4 levels ahead instead of 2;
- ``no_row``: no row body, so copies, waits and barriers only (wrong
  results, not checked);
- ``kb1`` .. ``kb8``: a fixed block width of 1 .. 8 scenarios, at widths
  around the card's SM count.

Prints one line a measurement, then one JSON line with the card's name
and power limit and every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/maxplus/csrc/sparse_levels.cu"
OUT = ROOT / "build" / "probe"
STENCIL = (32, 32, 100)                  # chip_smoke.py's SPARSE_STENCIL
WIDTHS = (256, 4)       # chip_smoke.py phase 3's width; the default Engine's
KB_WIDTHS = (128, 133, 192, 256)         # around an H100's 132 SMs

# variant -> (nvcc -D flags, widths, kept semantics)
VARIANTS = {
    "base": ((), WIDTHS, True),
    "no_window": (("-DSL_NO_WINDOW",), WIDTHS, True),
    "no_ring": (("-DSL_SLOT_E=0", "-DSL_SLOT_R=0"), WIDTHS, True),
    "ring_d4": (("-DSL_RING_D=4",), WIDTHS, True),
    "no_row": (("-DSL_NO_ROW",), WIDTHS, False),
    "kb1": (("-DSL_KB=1",), KB_WIDTHS[:2], True),
    "kb2": (("-DSL_KB=2",), KB_WIDTHS, True),
    "kb4": (("-DSL_KB=4",), KB_WIDTHS, True),
    "kb8": (("-DSL_KB=8",), KB_WIDTHS, True),
}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def lib_path(name: str) -> pathlib.Path:
    return OUT / f"libsparse_levels_{name}.so"


def build(names) -> None:
    """Every variant's library, one nvcc each, all at once; prints the
    float64 kernel's registers and spills."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [kb.find_nvcc(), *kb.NVCC_FLAGS, *VARIANTS[n][0], "-o",
         str(lib_path(n)), str(SRC)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{n}: nvcc failed:\n{log}")
        for kernel, info in kb.parse_ptxas(log).items():
            if "sparse_levels_f64_kernel" in kernel:
                print(f"built {n}: {info}", flush=True)


def events_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` launches back to back, after
    a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def run_variant(name: str, reps: int) -> list:
    """One variant in this process, at each of its widths: its first
    chunk's λ launch checked against the package's kernel and timed."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.kernels.maxplus import sparse_levels_f64
    from repro_torch.sweep import compile_sparse, latency_grid
    from repro_torch.sweep import engine as eng
    fn = ctypes.CDLL(str(lib_path(name))).sparse_levels_f64
    fn.argtypes = [_P] * 5 + [_LL] + [_P] * 5 + [_I] * 3 + [_P]
    _, widths, exact = VARIANTS[name]
    p = cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(*STENCIL, halo_bytes=64e3, comp_us=500.0, params=p)
    sp = compile_sparse(g, p)
    cuda = torch.device("cuda")
    a = eng.stage_sparse(sp, cuda, torch.float64)
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for S in widths:
        b = latency_grid(p, np.linspace(0.0, 100.0, S))
        L, GS = (torch.from_numpy(x).cuda() for x in (b.L, b.gscale))
        lv0, lv1, base, w = next(iter(eng._chunk_weights(a, L, GS,
                                                         sp.nlevels)))
        w = w.contiguous()
        args = (w, base, a.esrc, a.row_ptr, a.v_ptr_dev, a.elat_sum,
                a.vcost, lv0, lv1)

        def state():
            return eng._state((a.vcost.shape[0],), S, True, cuda,
                              torch.float64)

        want = state()
        sparse_levels_f64(*want[:3], *args, want[3])
        st = state()

        def launch():
            err = fn(*(x.data_ptr() for x in st), w.data_ptr(), base,
                     *(x.data_ptr() for x in args[2:7]), lv0, lv1, S,
                     stream)
            if err:
                raise SystemExit(f"{name}: launch failed: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        r = {"variant": name, "S": S, "levels": lv1 - lv0}
        equal = all(torch.equal(x, y) for x, y in zip(st, want))
        if exact and not equal:
            raise SystemExit(f"{name} S {S}: results differ from the "
                             "package's kernel")
        r["ms"] = events_ms(launch, reps)
        if exact:
            # the chunk is final, so the timed reruns leave it unchanged
            r["bit_equal"] = all(torch.equal(x, y) for x, y in zip(st, want))
            if not r["bit_equal"]:
                raise SystemExit(f"{name} S {S}: back-to-back launches "
                                 "changed the results")
        out.append(r)
        del want, st, w, args
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated variants (default: all)")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("levels_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.variant:
        print(json.dumps(run_variant(args.variant, args.reps)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    names = [n for n in VARIANTS
             if not args.only or n in args.only.split(",")]
    build(names)
    results: dict = {}
    for name in names + names[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--variant", name,
                               "--reps", str(args.reps)],
                              capture_output=True, text=True)
        line = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode or not line.startswith("["):
            print(f"{name}: exit {proc.returncode}: "
                  f"{(proc.stdout + proc.stderr)[-800:]}", flush=True)
            continue
        for r in json.loads(line):
            results.setdefault(f"{name} S {r['S']}", []).append(r["ms"])
            print(f"{name} S {r['S']}: {r['ms']:.6f} ms "
                  f"({r['ms'] * 1e3 / r['levels']:.4f} us a level); {r}",
                  flush=True)
    print(json.dumps({"card": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
