#!/usr/bin/env python3
"""Where the float64 level loops spend their time, and which block width
suits them, on one CUDA card: builds of ``csrc/sparse_levels.cu`` with its
compile-time knobs (the file's header names them), timed side by side.

    python3 tools/levels_probe.py [--reps N] [--only a,b]

Each variant is the package's source built with its -D flags (one nvcc a
variant, all started together) into ``build/probe/``.  Each runs in a
process of its own, every variant twice, in turns.  A variant times its
kernel (λ) on its cases: CUDA events over N launches back to back, with
no synchronize between them.  The cases are ``chunk``, ``sparse_levels_f64``
on the first weight chunk of ``chip_smoke.py`` phase 6's stencil, and
``solo`` and ``packed``, ``segment_levels_f64`` over every level of phase
4's stencil and of phase 7's packed allreduce study (G 4), and ``lanes``,
the same over phase 4's stencil with K = 64 cost lanes (placement's
shape: ``chip_smoke.py`` phase 12's extras), each at a width S.  The variants that keep the semantics are checked bit-equal to
the package's kernel on t, ssum, cho and csrc, before and after the
timed launches:

- ``base`` / ``seg_base``: the package's build;
- ``no_window`` / ``seg_no_window``: every source row's t and ssum from
  device memory;
- ``no_ring`` / ``seg_no_ring``: every level's inputs from device memory
  (the window then has the ring's room too);
- ``ring_d4``: the ring 4 levels ahead instead of 2;
- ``no_row`` / ``seg_no_row``: no row body, so copies, waits and barriers
  only (wrong results, not checked);
- ``kb1`` .. ``kb8``, ``seg_kb1`` .. ``seg_kb8``: a fixed block width of
  1 .. 8 scenarios, at widths around the card's SM count;
- ``seg_t1024``, ``seg_t256``: the segment loop at 1,024 and 256 threads
  a block (the package's build: 512).

Prints ptxas's registers and spills of each build, one line a
measurement, then one JSON line with the card's name and power limit and
every time.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
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
SEG_STENCIL = (16, 16, 10)               # chip_smoke.py phase 4's stencil
STUDY = (64, 10)                         # chip_smoke.py phase 7's study
STUDY_ALGOS = ("ring", "bidir_ring", "recursive_doubling", "tree")
WIDTHS = (256, 4)       # chip_smoke.py phase 3's width; the default Engine's
KB_WIDTHS = (128, 133, 192, 256)         # around an H100's 132 SMs


def cases(plan: str, widths) -> tuple:
    return tuple((plan, S) for S in widths)


LANES = 64                               # chip_smoke.py's PLACEMENT_K
SEG = cases("solo", WIDTHS) + cases("packed", (256,)) + cases("lanes", (4,))
SEG_KB = (cases("solo", KB_WIDTHS) + cases("packed", (256,))
          + cases("lanes", (4,)))
# variant -> (nvcc -D flags, (plan, S) cases, kept semantics)
VARIANTS = {
    "base": ((), cases("chunk", WIDTHS), True),
    "no_window": (("-DSL_NO_WINDOW",), cases("chunk", WIDTHS), True),
    "no_ring": (("-DSL_SLOT_E=0", "-DSL_SLOT_R=0"), cases("chunk", WIDTHS),
                True),
    "ring_d4": (("-DSL_RING_D=4",), cases("chunk", WIDTHS), True),
    "no_row": (("-DSL_NO_ROW",), cases("chunk", WIDTHS), False),
    "kb1": (("-DSL_KB=1",), cases("chunk", KB_WIDTHS[:2]), True),
    "kb2": (("-DSL_KB=2",), cases("chunk", KB_WIDTHS), True),
    "kb4": (("-DSL_KB=4",), cases("chunk", KB_WIDTHS), True),
    "kb8": (("-DSL_KB=8",), cases("chunk", KB_WIDTHS), True),
    "seg_base": ((), SEG, True),
    "seg_no_window": (("-DSL_NO_WINDOW",), SEG, True),
    "seg_no_ring": (("-DSL_SLOT_E=0", "-DSL_SLOT_R=0"), SEG, True),
    "seg_no_row": (("-DSL_NO_ROW",), SEG, False),
    "seg_kb1": (("-DSL_KB=1",), cases("solo", KB_WIDTHS[:2])
                + cases("lanes", (4,)), True),
    "seg_kb2": (("-DSL_KB=2",), SEG_KB, True),
    "seg_kb4": (("-DSL_KB=4",), SEG_KB, True),
    "seg_kb8": (("-DSL_KB=8",), SEG_KB, True),
    "seg_t1024": (("-DSL_SEG_THREADS=1024",), SEG, True),
    "seg_t256": (("-DSL_SEG_THREADS=256",), SEG, True),
}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def lib_path(name: str) -> pathlib.Path:
    return OUT / f"libsparse_levels_{name}.so"


def build(names) -> None:
    """Every variant's library, one nvcc each, all at once; prints the
    float64 level loops' registers and spills."""
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
            if "levels_f64_kernel" in kernel:
                print(f"built {n}: {kernel}: {info}", flush=True)


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


@functools.lru_cache(maxsize=None)
def staged(plan: str):
    """(params, the plan staged on the card, the lanes or None): phase 6's
    stencil for the sparse float64 forward (``chunk``), phase 4's stencil
    (``solo``), phase 7's packed study (``packed``) or phase 4's stencil
    as one graph of K = 64 cost lanes (``lanes``) for the segment
    forward."""
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.sweep import (collective_variants, compile_plan,
                                   compile_sparse, pack_plans)
    from repro_torch.sweep import engine as eng
    p = cluster_params(L_us=3.0, o_us=5.0)
    cuda = torch.device("cuda")
    if plan == "chunk":
        g = synth.stencil2d(*STENCIL, halo_bytes=64e3, comp_us=500.0,
                            params=p)
        return (p, eng.stage_sparse(compile_sparse(g, p), cuda,
                                    torch.float64), None)
    if plan in ("solo", "lanes"):
        g = synth.stencil2d(*SEG_STENCIL, halo_bytes=64e3, comp_us=500.0,
                            params=p)
        cp = compile_plan(g, p)
        if plan == "lanes":
            a = eng.packed_view(eng.stage_segment(cp, cuda), cp.nlv_p)
            rng = np.random.default_rng(0)
            msg = g.elat.sum(1) > 0
            ex = rng.uniform(0.0, 10.0, (LANES, g.num_edges)) * msg
            return p, a, eng.stage_lanes(a, torch.from_numpy(
                cp.patch_costs(ex).econst[None]).cuda())
    else:
        P, steps = STUDY
        cp = pack_plans([compile_plan(v.graph, v.params) for v in
                         collective_variants(lambda al: synth.allreduce_chain(
                             P, steps, nbytes=4e6, comp_us=5000.0, params=p,
                             algo=al), STUDY_ALGOS, p)])
    return p, eng.stage_segment(cp, cuda), None


def chunk_case(S: int):
    """(levels, the package's state, a fresh state, launch(lib, state))
    of ``sparse_levels_f64`` on phase 6's first weight chunk at width S."""
    from repro_torch.kernels.maxplus import sparse_levels_f64
    from repro_torch.sweep import latency_grid
    from repro_torch.sweep import engine as eng
    p, a, _ = staged("chunk")
    cuda = torch.device("cuda")
    b = latency_grid(p, np.linspace(0.0, 100.0, S))
    L, GS = (torch.from_numpy(x).cuda() for x in (b.L, b.gscale))
    lv0, lv1, base, w = next(iter(eng._chunk_weights(a, L, GS, a.nlevels)))
    w = w.contiguous()
    args = (w, base, a.esrc, a.row_ptr, a.v_ptr_dev, a.elat_sum, a.vcost,
            lv0, lv1)

    def state():
        return eng._state((a.vcost.shape[0],), S, True, cuda, torch.float64)

    want = state()
    sparse_levels_f64(*want[:3], *args, want[3])
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, st):
        fn = lib.sparse_levels_f64
        fn.argtypes = [_P] * 5 + [_LL] + [_P] * 5 + [_I] * 3 + [_P]
        return fn(*(x.data_ptr() for x in st), w.data_ptr(), base,
                  *(x.data_ptr() for x in args[2:7]), lv0, lv1, S, stream)

    return lv1 - lv0, want, state(), launch


def segment_case(plan: str, S: int):
    """The same for ``segment_levels_f64`` over every level of phase 4's
    stencil (``solo``), of phase 7's packed study (``packed``) or of phase
    4's stencil in K = 64 cost lanes (``lanes``)."""
    from repro_torch.sweep import latency_grid
    from repro_torch.sweep import engine as eng
    p, a, lanes = staged(plan)
    cuda = torch.device("cuda")
    G = a.esrc.shape[0] if a.esrc.dim() == 3 else 0
    K = 1 if lanes is None else lanes.K
    b = latency_grid(p, np.linspace(0.0, 100.0, S))
    L, GS = (torch.from_numpy(np.stack([x] * G) if G else x).cuda()
             for x in (b.L, b.gscale))
    nlv = int(a.nlevels.max())
    want = eng._segment_levels(a, L, GS, True, nlv, lanes)
    erec = a.erec if lanes is None else lanes.erec
    lists = (L, GS, a.lv_ptr, a.rows, a.row_ptr, a.in_edges, erec, a.rcost)
    nlv_p, Vmax = a.vcost_lv.shape[-2:]
    # the lanes share their structure's gap classes: Kc = K
    ints = (max(G, 1) * K, K, K, 0, nlv, nlv_p, nlv_p * Vmax + 1,
            a.rows.shape[-1], a.in_edges.shape[-2], S, L.shape[-1],
            GS.shape[-1])
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, st):
        # no link table (the congestion fixed point's factor): null
        # in_link and ls, nl1 0
        fn = lib.segment_levels_f64
        fn.argtypes = [_P] * 14 + [_I] * 13 + [_P]
        return fn(*(x.data_ptr() for x in st + lists), None, None, 0, *ints,
                  stream)

    def state():
        lead = tuple(a.valid_flat.shape)
        return eng._state((lead[0] * K,) + lead[1:] if G else lead, S, True,
                          cuda, torch.float64)

    return nlv, want, state(), launch


def run_variant(name: str, reps: int) -> list:
    """One variant in this process, at each of its cases: its λ launch
    checked against the package's kernel and timed."""
    sys.path.insert(0, str(ROOT / "src"))
    lib = ctypes.CDLL(str(lib_path(name)))
    _, todo, exact = VARIANTS[name]
    out = []
    for plan, S in todo:
        levels, want, st, launch = (chunk_case(S) if plan == "chunk"
                                    else segment_case(plan, S))

        def once():
            err = launch(lib, st)
            if err:
                raise SystemExit(f"{name}: launch failed: cudaError {err}")

        once()
        torch.cuda.synchronize()
        r = {"variant": name, "plan": plan, "S": S, "levels": levels}
        equal = all(torch.equal(x, y) for x, y in zip(st, want))
        if exact and not equal:
            raise SystemExit(f"{name} {plan} S {S}: results differ from "
                             "the package's kernel")
        r["ms"] = events_ms(once, reps)
        if exact:
            # the levels are final, so the timed reruns leave them unchanged
            r["bit_equal"] = all(torch.equal(x, y) for x, y in zip(st, want))
            if not r["bit_equal"]:
                raise SystemExit(f"{name} {plan} S {S}: back-to-back "
                                 "launches changed the results")
        out.append(r)
        del want, st
        torch.cuda.empty_cache()
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
            key = f"{name} {r['plan']} S {r['S']}"
            results.setdefault(key, []).append(r["ms"])
            print(f"{key}: {r['ms']:.6f} ms "
                  f"({r['ms'] * 1e3 / r['levels']:.4f} us a level); {r}",
                  flush=True)
    print(json.dumps({"card": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
