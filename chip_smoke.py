#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one CUDA card (an H100).

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. device  — the card's name and count, and ``nvidia-smi``'s name and
             power limit;
2. build   — compiles every CUDA source of the package with ``nvcc``
             (``-Xptxas -v``), printing build seconds and each kernel's
             registers, shared memory and spills (none allowed in the two
             float64 level loops, the dense level loop and the walk, the
             kernels that run phase 12's lanes);
3. kernels — each kernel against its plain PyTorch version on the card,
             bit for bit, at the main path's shape (dense: M = Vmax = 256,
             N = Emax = 128, K = 256 scenarios; graph-batched: G = 4, M =
             64, N = 128, K = 256; slot list: M = Vmax_lv = 1024, E =
             Emax_lv = 256, K = 256), ragged shapes, tie-heavy
             inputs and rows with no finite candidate (slot list: random
             rows with empty ones, pad slots at M, ties across slot tiles,
             K and E off the tile multiples); then each kernel's and plain
             version's time at the main-path shape (CUDA events) beside
             the least time the card could take.  The sparse float32
             forward's level-loop kernel against its plain version on the
             first weight chunk of phase 6's stencil at S = 256 (values and
             λ), and the walk kernel (one dependent load a step, over the
             chosen sources csrc the level loops record beside cho) after a
             whole λ forward, its plain version equal to the two-load walk
             over esrc, with their bounds (bytes, and the chain of
             dependent loads).  The dense level-loop kernel (the dense and
             packed forwards' whole level loop) against its plain version
             on phase 4's whole plan and on phase 7's packed plan at S =
             256 (values and λ), bit for bit on t, ssum, cho and csrc with
             the mismatches counted, and its time beside its bounds (bytes,
             and the chain of levels × the dependent-load time the walk
             measured); the packed walk (four graphs, one launch) on the
             packed plan's state against its plain version and each
             graph's solo walk.  The sparse float64 forward's level-loop
             kernel (a cp.async ring of the next levels' inputs and a
             window of recent rows in shared memory) against its plain
             version, bit for bit on t, ssum, cho and csrc with the
             mismatches counted, at S = 256, 37 and 1 (values and λ), on
             the levels of the first weight chunk of phase 6's stencil, on
             a tie-heavy plan (integer costs, ties within 1e-12, rows of 7
             in-edges) and on a wide plan (levels wider than a ring slot,
             sources past the window); its time on the chunk beside its
             bounds, registers and spills, within 5 % of its time before
             its row body became the function it shares with the segment
             kernel.  The segment forward's level-loop kernel (one launch
             over every level, the edge weights formed in it, a cp.async
             ring and a window of recent rows) against its plain version,
             bit for bit on t, ssum, cho and csrc with the mismatches
             counted, on phase 4's whole plan (also split in two
             launches), on phase 7's packed plan, on the tie-heavy plan
             and on the wide plan, at S = 256, 37 and 1 (values and λ);
             its time on phase 4's plan and on the packed plan at S = 256
             beside its bounds (bytes, and the chain of levels) and beside
             its time before it formed the weights plus their elementwise
             time.  The
             flash-attention kernels (three routes: the wgmma/TMA prefill kernel, the
             split-KV decode kernel, the simple CUDA-core kernel) against
             their plain version in bfloat16 and float32 at the serve
             paths' decode shapes (B = 4, 24 or 64 query heads over 8 KV
             heads, d = 128, one token against a 192-key cache, kv_len 1,
             97 and 192) and causal prefill shapes (B = 1, T = 4096), at
             ragged shapes (Tq and Tk off the tiles, d ≠ dv, n_rep 1, 3
             and 8, d = 64 and 256, Tq up to 16 at decode) and at kv_len
             = 0 (the mean of all values), printing the route each case
             took; the two layouts bit-equal; the decode and prefill
             kernels', the plain version's and
             ``scaled_dot_product_attention``'s times at both serve paths'
             decode and prefill shapes beside the bound.  The linear-scan
             kernel against its plain version in float32 and bfloat16 at
             jamba's Mamba decode shape (B = 4, T = 1, D = 16384, S = 16,
             h0 ≠ 0), its 4096-token prefill shape and ragged shapes (T,
             D off the tiles, S of 1, 4, 8 and 32); its and the plain
             version's times at both main shapes beside the bound.  The
             Mamba-scan kernel (the fused kernel the Mamba blocks call):
             its decay alone against torch.exp on every dt·A of its check
             shapes (differing elements and ulps counted), then each of
             its two schedules against the plain version in float32 and
             bfloat16 at jamba's decode (B 4, T 1, Di 16384, S 16), its
             4096-token prefill, a 256-step chunk and ragged shapes: h bit
             for bit, y within 1e-4 (float32) and 5e-2 or one bfloat16
             step; the peak-memory rise of one prefill call (at most y +
             h + 1 MiB); the SASS's MUFU.EX2 counts; both schedules' times
             at T = 1 .. 64; its and the plain version's times at decode
             and prefill beside the bound (bytes, expf over the
             special-function unit, flops: the largest).  The flash
             kernels at the new families' shapes on their routes (MLA: d
             192, dv 128, decode on the decode kernel and causal
             4096-token prefill on the prefill kernel; hubert: d 80,
             non-causal, 4096 frames, on the prefill kernel at width 128)
             against their plain version, both layouts bit-equal, and the
             simple kernel at the same shapes through unaligned copies;
             their, the plain version's and
             ``scaled_dot_product_attention``'s times beside the bound.
             The wkv6 kernel (RWKV-6's recurrence, the state spread over
             blocks of 4 × 2 (i, j) tiles) against its plain version at
             rwkv6-7b's decode (B 4, T 1, H 64, hd 64) and 4096-token
             prefill and at ragged shapes (hd 32, T off the staging
             chunk, too few heads to fill the card), from a zero and a
             given state: S bit for bit, y within 1e-5 of its largest
             |y|; its and the plain version's times beside the bound
             (bytes and flops), the exact form's instruction floor and
             the chain of T dependent steps;
4. main    — LLAMP's latency analysis of a 256-rank 2-D halo-exchange
             stencil (23,040 vertices, 1,024 padded levels) on the card,
             on the dense backend (named: the default is segment):
             a 256-point latency curve with λ, the 1/2/5 % latency
             tolerances, then one values-only and one λ forward on a
             staged engine, with wall times, peak memory and the kernels'
             launch counts (one dense level-loop launch a forward, one walk
             a λ forward, no launch of the dense mat-vecs), then a profile
             of one forward of each kind; then the same on the segment
             backend (the curve, the tolerances, a values and a λ
             forward): T, λ and ρ bit-equal to the sparse float64 forward
             and T within 1e-5 of a numpy longest path at 4 points, one
             segment level-loop launch a forward and one walk a λ
             forward, a profile of each kind with no per-level kernels,
             walls and peak memory;
5. cpu     — the same graph on the CPU (plain versions) over 16 of the
             curve's points: T within 1e-6 relative of the card's and λ
             equal; T also within 1e-5 of an independent float64 numpy
             longest-path evaluation;
6. sparse  — the sparse slot-list backend on a 1024-rank stencil of 100
             iterations (921,600 vertices, 13,223 levels; an 18 GiB dense
             envelope): the default ``Engine`` must warn and switch to
             sparse float64; a 256-point latency curve with λ, a
             values-only forward and the 1/2/5 % tolerances on the float32
             flavour, with one more λ forward on a staged engine: the
             level-loop kernel must launch once per weight chunk of each
             forward, the walk once per λ forward, the standalone
             slot-list kernel never; the float64 flavour (the default
             Engine's λ run: one float64 level-loop launch a weight chunk
             and one walk, a profile showing no per-level kernels) and an
             independent numpy float64 longest path at 4 points, which the
             float32 flavour's T and λ must meet within 1e-5; the float32
             flavour
             on the CPU (plain kernel) at those 4 points, which must equal
             the card's; a profile of one values-only and one λ forward;
             peak device memory, at most one cho above its value before
             csrc was recorded;
7. study   — the paper's allreduce-algorithm study (Fig 10) on the graph
             axis: the four algorithms of a 64-rank × 10-step ICON-dycore
             skeleton packed into one plan (G = 4, nlv_p 8,192, Vmax 64,
             Emax 128; 1,340 MiB dense, under max_dense_bytes = 2 GiB), on
             the dense backend (named), one λ forward over a 256-point ΔL
             grid and one values-only forward, each one launch of the dense
             level-loop kernel for all four graphs, with one walk launch
             for all four graphs of the λ forward and no launch of the
             graph-batched mat-vecs, then the ranking; each
             graph's T and λ
             bit-equal to its solo dense engine, within 1e-5 (T) and equal
             (λ) to its sparse float64 forward at 4 points, and the CPU's
             packed run (plain versions) equal to the card's at every 16th
             point; wall times, a profile of one λ and one values-only
             forward, peak memory (at most one cho above its value before
             csrc); then the study packed on the segment backend (one λ and
             one values forward): each graph's T and λ bit-equal to its
             solo segment engine and, at 4 points, to its sparse float64
             forward, one segment level-loop launch a forward for all four
             graphs and one walk launch, the ranking, walls, profiles, and
             a peak memory no higher than the dense packed forwards'
             (printed beside its value when the forward built weight
             chunks);
8. serve   — the LLM serving path: llama3.2-3b at full width (28 layers,
             d_model 3072, 24 heads over 8 KV heads, vocab 128,256) in
             bfloat16 from seeded random weights, through
             ``repro_torch.launch.serve.generate`` at batch 4, prompt 128
             (prefilled a token a step), 64 generated tokens, then one
             4096-token prefill step; the flash kernels' launches must be
             28 × (128 + 64 − 1) + 28, the decode kernel's 28 × 191 and
             the prefill kernel's 28 (the route counters), none through
             the simple kernel; prefill and decode wall, decode tokens/s,
             peak memory, a profile of the prefill step and of one decode
             step; then
             the same model cut to 2 layers, in float32, on the card and
             on the CPU (plain versions, the card's weights moved over)
             over 8 prompt + 8 generated tokens: greedy tokens equal and
             logits within 1e-3 at every step;
9. hybrid  — the hybrid serving path: jamba-1.5-large-398b at full width
             (d_model 8192, Mamba Di 16384 with S = 16, 64 heads over 8,
             16-expert top-2 MoE of d_ff 24576, vocab 65,536) cut to its
             first 5 layers (four Mamba, one attention; MoE on layers 1
             and 3), bfloat16 from seeded random weights, served like
             phase 8 (batch 4, prompt 128 token by token, 64 generated,
             then one 4096-token prefill step); the launches must be
             4 Mamba layers × (128 + 64 − 1) + 4 for the Mamba scan (the
             decode schedule 4 × 191, the prefill schedule 4), none for
             the standalone linear scan, and 1 × (128 + 64 − 1) + 1 for
             flash (191 decode, 1 prefill route); walls, tokens/s, peak
             memory (the prefill step's own beside its wall), a profile of
             the prefill step and of one decode step (the Mamba scan's and
             the elementwise kernels' shares) and one MoE layer's share of
             the decode step; then layer 0 alone (Mamba + SwiGLU) in float32
             on the card and on the CPU over 8 + 8 steps: greedy tokens
             equal and logits within 1e-3;
10. solvers — LLAMP's own solvers on phase 4's stencil: the LP of
             Algorithm 1 (56,321 folded rows × 23,042 columns) through
             ``core.lp.predict_runtime`` on the card's IPM, against HiGHS
             on the host, the sparse float64 forward and ``core.dag``: T
             within 1e-5, λ within 1e-3 of HiGHS's; its iterations and
             wall, one factorization of the Newton matrix (CUDA events)
             beside its bound n³/3 over the FP64 tensor-core peak, M's
             bytes, the IPM's peak memory, HiGHS's wall; the IPM on
             stencil2d(8, 8, 10), card against CPU, T within 1e-6;
             ``tolerance_lp`` at 1 % and 5 % against ``latency_tolerance``
             within 1e-5; ``critical_latencies`` (Algorithm 2) on
             cg_like(16, 16, 10) (110,080 vertices, float32 on the sparse
             level loop) and a 64-rank random DAG (5,602 vertices, float32
             on the dense level loop, named) under sparse float64 (kinks
             equal to ``core.dag.breakpoints``) and float32 (as many, within
             1e-6), with rounds, probes and walls; ``analyze`` (the default
             policy: segment) bit-equal to ``core.dag``;
             ``examples/quickstart.py``'s flow on the port (the default),
             its latency curve against the event simulator (RRMSE ≤
             1e-9).  Every call's launches as phases 4 and 6 count them,
             added to the level-loop and walk rows; then each call once
             more with every level-loop and walk launch also run through
             the kernel's plain version on copies of the same inputs,
             bit-equal on t, ssum, cho, csrc and λ;
11. traced — the slice's path at the examples' widths: the training
             steps of six of the model stack's configs
             (``examples/latency_tolerance.py``: TraceSpec(pods 2, data 4,
             model 8, mfu 0.5), TRAIN_4K) traced by the port's tracer; the
             default Engine must warn and switch to sparse float64 exactly
             when a step's dense envelope exceeds the guard, and stay on
             segment float64 below it; ``analyze`` and the 1/2/5 % dcn
             tolerances with the launches counted as in phase 10;
             llama3.2-3b and jamba against ``core.dag`` (T and λ
             bit-identical, tolerances within 1e-5), llama3.2-3b's and the
             first segment-routed step's ``analyze`` held against the plain
             versions; then the Fig 11
             topology study (``examples/topology_study.py``'s 256-rank
             workload on fat_tree(16), dragonfly(8, 4, 8) and torus((16,
             16)) through ``topology_variants``): T, λ and the 1 %
             tolerance on wire class 0 held to the route's contract
             against ``core.dag``, then the ranking by T at +0.5 µs a
             wire over 11 points;
12. lanes  — the candidate-cost (K) and structure-variant (B) axes of
             ``Engine.run(Query(...))``: placement's shape (K 64 cost
             blocks of extras on phase 4's message edges, S 4; values and
             λ on segment and on dense), each lane against a solo forward
             of its rebuilt plan (segment bit for bit, dense within
             1e-5); phase 7's four plans with K 4 blocks a graph (G×K, S
             16, segment), each lane bit-equal to its solo rebuild;
             ``StructureBatch.from_plans`` over the same plans (B 4, S
             256) bit-equal to phase 7's packed study; ``patch_structure``
             on phase 4's stencil (B 4, each dropping 1 % of its message
             edges, × K 4, S 16), each lane bit-equal to ``core.dag`` on
             its rebuilt graph.  Each run: one level-loop launch and one
             walk a forward, whatever K and B; its kernels a forward under
             100 a structure (a bound that does not grow with K); walls,
             profiled busy shares, peak memory; every launch held against
             its plain version (t, ssum, cho, csrc and λ bit-equal); then
             lanes that own their gap shares, gap classes and latency
             rows: phase 4's stencil built under 8 two-class pod models
             whose rank-to-class maps differ (pods of 2 .. 256 ranks), the
             8 plans' fields stacked as one hand-assembled CostBatch, S 4
             with unequal gap scales a class, on segment (bit-equal to
             the 8 solo forwards) and dense (within 1e-5, λ equal), one
             level-loop launch a forward and one walk a λ forward;
13. congestion — the congestion fixed point, fd λ and the result cache on
             phase 4's stencil under ``pod_model(pod_size=64,
             ranks_per_host=4, alpha={"ici": 1, "dcn": 2})``: the segment
             level loop with a random link-scale table held against its
             plain version (t, ssum, cho, csrc; values and λ; S 256), its
             time with the factor and without (phase 3's time within 5 %
             of its 0.846 ms before the factor: a guard against a gross
             loss, since one call's time varies more than that) beside
             the bytes bound (the scales and link ids read once; the
             scales' re-reads, one an edge and a scenario, printed
             beside); α = 0 bit-equal to the plain forward (T, λ, ρ) in
             one iteration; the congested fixed point
             at S 256 (max_iters 32, tol 1e-9): under 32 iterations, T at
             least the plain T, 4 scenarios bit-equal (T, λ, iterations)
             to the CPU's own fixed point, one level-loop launch an
             iteration and one more, one walk, one host sync an
             iteration, wall, profiled busy share and peak memory; K 64 ×
             S 4 under congestion, lanes 0, 21, 42 and 63 bit-equal to
             solo congested runs of their rebuilt plans; the six-message
             incast strictly closer to the DES ``contention`` injector
             than the plain forward; fd λ at S 256 on segment and dense, T
             bit-equal to the exact run's, segment λ within 1e-6 of exact
             λ at every scenario whose exact λ is the same at each fd
             probe (T is convex in L, so no kink lies between), dense's
             largest gap printed; a repeat of phase 4's segment λ query
             served by a result cache with no launch and the same bits,
             and a detached ``run(Query(graphs=...))`` made twice building
             its engine once.
14. consumers — the Engine's consumers at full width, under
             ``obs.collect()``: Algorithm 3's placement search
             (``core.placement.place``) on phase 4's stencil built under
             zero link costs on ``two_tier(256, pod=64)``, ΔL 0/1/5/10 µs,
             top-64 candidates, 8 steps from a seeded random mapping (one
             plan compile; one ``segment_levels_f64`` launch and no walk a
             step; the wall a step split into host and query; a profiled
             step; peak memory; step 1's 64 × 4 objectives and every
             accepted candidate's objective bit-equal to ``core.dag`` on the
             host); ``resilience_curve`` over 32 faults on phase 4's stencil
             (16 stragglers, 8 link faults on class 0, 8 device faults on
             ranks 0, 32, ..., 224 with a checkpoint-restart recovery cost)
             as one B × K × S query (one level-loop launch, no walk; every
             fault's T bit-equal to ``core.dag`` on its faulted inputs);
             ``explore.run_search`` of ``preset("codesign", P=256,
             iters=3)``, 2 generations of 4 random candidates over 16 ΔL
             points (the queries and launches a generation, each
             generation's best bit-equal to ``solo_objective`` and to
             ``core.dag`` at every scenario, a rerun of generation 1 served
             by the stamper's cache with no launch); the spans and counters
             collected, and a ``CompileWatcher`` around a warm rerun of a
             placement query reporting 0 new programs;
15. service — the analysis service (``repro_torch.launch.analysis``) on
             the card, each part's wall, launches and peak memory printed:
             phase 7's four allreduce variants registered and warmed
             (one λ probe a variant, a λ and a values probe a bucket), a
             256-point rank (one segment level-loop launch a bucket, no
             walk, ``compiled_calls`` the bucket count, phase 7's ranking
             bit for bit), a curve, a bandwidth and a tolerance query on
             one variant bit-equal to the same calls on an ``Engine``, the
             curve again from the cache with no launch, a curve and a rank
             on dense and a curve on sparse float32 (policy blocks) equal
             to the direct calls; phase 14's 32 faults and 2 of its
             placement steps through the service, equal to phase 14's
             answers; ``examples/collective_study.py`` (jamba-1.5-large-398b
             at TraceSpec(2, 4, 8), four allreduce algorithms) and
             ``examples/topology_study.py`` (256 ranks, three fabrics)
             through the service, T, λ, the tolerance and the ranking held
             to each route's contract against ``core.dag``; the JSON-lines
             protocol on a loopback TCP socket queried by two client
             threads, their responses equal to ``handle_json`` in the
             process and ``/metrics`` counting their requests (the
             loopback is tried right after phase 1); sharding:
             ``torch.cuda.device_count()`` and what ``shard=True``
             resolves to, ``shard=True`` bit-equal to the unsharded run,
             then phase 4's curve split on S (256 → 2 × 128), phase 7's
             packed study on G (4 → 2 + 2) and placement's K 64 × S 4 on K
             (values and λ) over ``["cuda:0", "cuda:0"]``, each bit-equal
             to the unsplit forward with one level-loop launch a chunk and
             one walk a chunk of a λ forward;
16. sparse LP — the IPM's sparse Newton route (``core.ipm.SparseNewton``:
             the Schur complement over ℓ, PCG on the vertex block, the
             tree preconditioner's kernels ``tree_factor`` and
             ``tree_solve``): (a) phase 4's LP (23,042 columns) through
             the private seam ``ipm._solve(..., newton=SparseNewton)``, T
             within 1e-5 of ``core.dag`` and of phase 10's dense route, λ
             within 1e-3 of HiGHS, its iterations, PCG steps a Newton
             solve (min / median / max), wall beside the dense route's,
             launches (one ``tree_factor`` an iteration, one
             ``tree_solve`` a PCG step and one a PCG) and peak memory;
             (b) ``lp.predict_runtime`` on stencil2d(16, 16, 40) (92,162
             columns, past ``MAX_NEWTON_BYTES``: the default route) against
             ``core.dag`` and HiGHS on the host (T within 1e-5, λ within
             1e-3), HiGHS's wall, the peak's rise under 1/64 of a dense M;
             (c) ``tolerance_lp`` at 1 % on stencil2d(16, 16, 20) (46,082
             columns, also past the cap) against ``latency_tolerance``
             within 1e-5; (d) ``tree_factor`` and ``tree_solve`` (R 2 and
             1 lanes) on (b)'s last iteration's forest against their plain
             versions with 0 mismatches, their times (CUDA events) and µs
             a level a sweep beside their bounds (bytes; the device-memory
             chain of 2 sweeps × levels × ``TRIP_US``; the on-chip chain,
             the time of the ``-DTP_CHAIN_ONLY`` build of
             ``tree_precond.cu``, phase 2's extra build), the block width,
             the reads that miss the window, the staged layout's time an
             iteration and ptxas's report.  The kernels' launches in the
             last line are (b)'s and (c)'s.
17. families — the model blocks one card serves: deepseek-v2-lite-16b
             (27 layers, MLA with d 192 / dv 128 over a compressed cache,
             64-expert top-6 MoE with 2 shared experts past a dense first
             layer) and rwkv6-7b (32 RWKV-6 layers, wkv6 kernel) at full
             depth and width in bfloat16 from seeded random weights, each
             served like phase 8 (batch 4, prompt 128 a token a step, 64
             generated, then one 4096-token prefill step); hubert-xlarge
             (48 layers, LayerNorm, GELU MLP, non-causal) at full depth,
             one [1, 4096, 1280] frame-embedding forward.  The counters are
             0 before each main path: flash launches 27 × (128 + 64 − 1)
             through the decode kernel and 27 through the prefill kernel
             (deepseek), 48 through the prefill kernel (hubert), none
             through the simple one; wkv6 32 ×
             (128 + 64 − 1) + 32; the Mamba scan 0.  Decode ms a step, tokens/s,
             prefill wall, peak memory, profiles of the prefill and a
             decode step (and of one MoE FFN at decode, which reads all 64
             experts); then each SMOKE config in float32 on the card
             against the CPU (greedy tokens equal, logits within 1e-3; the
             encoder's logits).  The card is freed between models.

Each phase's wall is printed as a ``[phase wall]`` line.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero before doing anything.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAIN_SHAPE = (256, 128, 256)             # M = Vmax, N = Emax, K = scenarios
STUDY_SHAPE = (4, 64, 128, 256)          # G graphs, M = Vmax, N = Emax, K
SLOT_SHAPE = (1024, 256, 256)            # M = Vmax_lv, E = Emax_lv, K
CURVE_POINTS = 256
CPU_EVERY = 16                           # CPU phase: every 16th curve point
SPIN_CYCLES = 500_000_000                # ~0.3 s at the H100's clocks
SPARSE_STENCIL = (32, 32, 100)           # ranks px × py, iterations
SPARSE_POINTS = 4                        # float64 / numpy / CPU checks
STUDY = (64, 10)                         # allreduce study: ranks, steps
STUDY_ALGOS = ("ring", "bidir_ring", "recursive_doubling", "tree")
STUDY_MAX_DENSE = 2 << 30                # the packed plan needs 1,340 MiB
BF16_OPS_PER_S = 989e12                  # dense tensor-core peak
FLASH_DECODE = (4, 1, 192, 24, 8, 128, 128)     # B, Tq, Tk, H, Hkv, d, dv
FLASH_PREFILL = (1, 4096, 4096, 24, 8, 128, 128)
# exp and the order of the sums differ from the plain version; bfloat16
# rounds the output once (tests/test_kernels.py's tolerances)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the new families' flash shapes (MLA, hubert): also within this share of
# the plain version's largest |out|.  On an H100: hubert prefill 9.8e-4 of
# 0.244, MLA prefill 7.8e-3 of 3.17 (each the error that p rounded to
# bfloat16 before PV gives alone), MLA decode 1.9e-6 of 0.469.  Each shape
# also runs on inputs that plant a fault, which must exceed it.
FAMILY_REL = 1e-2
SERVE_ARCH = "llama3.2-3b"
SERVE = (4, 128, 64)                     # batch, prompt, generated tokens
PREFILL_T = 4096
XCHECK = (2, 8, 8)                       # layers, prompt, generated tokens
# float32 on both sides; matmul sums in another order on each (observed
# ~1e-5 on logits of magnitude ~5)
XCHECK_TOL = 1e-3
SCAN_DECODE = (4, 1, 16384, 16)          # B, T, D = Di, S: jamba's Mamba
SCAN_PREFILL = (1, 4096, 16384, 16)
# the sum over S runs in another order than the plain version's; bfloat16
# y rounds once (tests/test_kernels.py's tolerances)
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the Mamba scan (the fused kernel): jamba's Mamba decode and its 4096-token
# prefill, a 256-step prefill chunk, and ragged shapes (T, Di off the
# tiles; S 1 .. 32; rows that are not whole 16-byte pieces): the cases of
# tests/test_torch_mamba_scan.py's card test
MAMBA_CASES = [("decode", 4, 1, 16384, 16), ("prefill", 1, 4096, 16384, 16),
               ("chunk", 1, 256, 16384, 16), ("ragged", 2, 77, 100, 8),
               ("ragged", 1, 5, 64, 4), ("ragged", 3, 130, 33, 1),
               ("ragged", 2, 70, 50, 2), ("ragged", 1, 64, 40, 3),
               ("ragged", 2, 65, 70, 12), ("ragged", 1, 129, 31, 32),
               ("ragged", 2, 77, 48, 8), ("ragged", 5, 3, 40, 32),
               ("ragged", 1, 40, 96, 16)]
# h bit for bit; y's sum over S runs in another order (the linear scan's
# tolerances), and a bfloat16 y may land one bfloat16 step from the plain
# version's, which exceeds 5e-2 where |y| >= 8
MAMBA_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the H100's special-function unit: 16 results a clock an SM (one MUFU.EX2
# an expf), 132 SMs at the 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9
HYBRID_ARCH = "jamba-1.5-large-398b"
# layers 0-4 (48.2 GB in bf16): one 8-layer period is 90.7 GB, more than
# the card.  With a and b·x formed in the Mamba-scan kernel, the 4096-token
# prefill step peaks at 47,902 MiB (H100, 700 W), 1.96 GB above what was
# allocated before it, against 10.08 GB while a and b·x were built
# (tools/hybrid_steps.py); 6 layers are 68.4 GB of weights.  The cut stays
# at 5 layers so the hybrid's numbers compare with earlier runs.
HYBRID_LAYERS = 5
HYBRID_XCHECK = (1, 8, 8)                # layers, prompt, generated tokens
# the FP64 rate outside the tensor cores (the H100 SXM data sheet)
FP64_VECTOR_OPS_PER_S = 34e12
TIE_GRAPH = (16, 6)                      # ranks, rounds (phase 3, float64)
# the most device activities one float64 λ forward of phase 6, or one
# segment forward of phases 4 and 7, may take a graph, whatever its
# levels: the weights (sparse), the state, the level-loop launches, the
# graph's sink, the walk and the copies (a few dozen)
F64_FORWARD_KERNELS = 100
# segment_levels_f64 over phase 4's plan and over the packed study (10
# weight chunks) at S 256 before it formed the weights itself (H100 80GB
# HBM3, 700 W; ROADMAP's redesign order), and the packed study's segment
# peak then (PERF.md, the walk's findings)
SEG_MS_BEFORE = {"phase 4": 1.660, "packed": 12.08}
SEG_STUDY_PEAK_MIB_BEFORE = 14017.6
# the FP64 tensor-core peak (the H100 SXM data sheet, dense)
FP64_OPS_PER_S = 67e12
LP_SMALL = (8, 8, 10)                    # the IPM card against CPU
BP_CG = (16, 16, 10)                     # 110,080 vertices, one kink
BP_RANDOM = (64, 4000)                   # 5,602 vertices, six kinks
BP_RANGE = (0.5, 500.0)                  # µs
QUICKSTART = (4, 4, 10)                  # examples/quickstart.py's stencil
# phase 11: examples/latency_tolerance.py's defaults (pods, data, model,
# mfu) and archs; the first two of TRACE_HELD are held against core.dag
TRACE_SPEC = (2, 4, 8, 0.5)
TRACE_ARCHS = ("jamba-1.5-large-398b", "deepseek-v2-lite-16b", "grok-1-314b",
               "rwkv6-7b", "yi-6b", "llama3.2-3b")
TRACE_HELD = ("llama3.2-3b", "jamba-1.5-large-398b")
# examples/topology_study.py's workload: ranks, iterations, bytes a
# message, compute µs; the ranking's ΔL a wire and points
TOPO_STUDY = (256, 3, 4e5, 2000.0)
TOPO_RANK_DL = 0.5
TOPO_RANK_POINTS = 11
# the kernels phase 10 counts (each must launch as phases 4 and 6 say)
SOLVER_KERNELS = ("maxplus_matvec", "maxplus_matvec_argmax",
                  "maxplus_slotlist_argmax", "dense_levels_f32",
                  "sparse_levels_f32", "sparse_levels_f64",
                  "segment_levels_f64", "sparse_backtrace")
# sparse_levels_f64 on phase 6's first weight chunk before its row body
# became the function segment_levels_f64 shares (H100 80GB HBM3, 700 W;
# PERF.md, kernel table row 5''), and the slack the shared body may cost
F64_CHUNK_MS_BEFORE = 6.038374
F64_CHUNK_SLACK = 1.05
# one dependent device-memory load, the unit of every dependent-load
# chain below: the time a load of the walk when each step took two (cho,
# then esrc), H100 80GB HBM3, 700 W, chip_smoke.py phase 3 (PERF.md, row
# 5'); a constant, so no chain is measured by the kernel it judges
TRIP_US = 0.2624
# phase 3's wide plan for the float64 level loop (ranks, rounds, the rounds
# a join reaches back): levels of up to 320 rows and 297 edges, more than
# a ring slot of sparse_levels_f64 holds (128 and 160), and sources up to
# ~14,700 rows back, past its window at every block width (13,386 rows at
# its widest, one scenario a block, on an H100)
WIDE_GRAPH = (320, 22, 19)
# peak device memory of phase 6's float32 runs and of phase 7's dense and
# segment packed runs before csrc was recorded beside cho (H100 80GB HBM3,
# 700 W; PERF.md, section 6, the walk's findings): each may rise by one
# cho at most
PEAK_BEFORE_CSRC = {"sparse": 6385446400, "study": 15241674752,
                    "segment study": 12551058432}
# phase 12: placement's shape (K cost blocks on phase 4's message edges, S
# latency points); the G x K study (K blocks a graph of phase 7's four
# plans, S); the patched-structure study on phase 4's stencil (B variants,
# each dropping this share of the message edges, K blocks, S)
PLACEMENT = (64, 4)
STUDY_GK = (4, 16)
STRUCT_PATCH = (4, 4, 16, 0.01)
LANE_KERNELS = ("segment_levels_f64", "dense_levels_f32", "sparse_backtrace")
# phase 13: the congestion registry on phase 4's stencil; the fixed point's
# stopping rule; K x S of placement's shape under congestion and the lanes
# held against solo rebuilds; the scenarios held against the CPU;
# segment_levels_f64 on phase 4's plan at S 256 before it took the link
# factor (H100 80GB HBM3, 700 W; PERF.md, the row of the segment level
# loop) and the slack a run without congestion may read above it: a guard
# against a gross loss only, as one call's reading varies by ~5 % (0.840 to
# 0.884 ms); parity with the loop before the factor is shown in turns by
# tools/levels_probe.py and in the machine code by tools/sass_diff.py
CONG_ALPHA = {"ici": 1.0, "dcn": 2.0}
CONG_ITERS = (32, 1e-9)
CONG_LANES = (64, 4, (0, 21, 42, 63))
CONG_CPU_ROWS = (0, 85, 170, 255)
SEG_MS_NO_LINKS = 0.846
SEG_SLACK = 1.05
# phase 14: placement (ranks, pod size, ΔL points, top-k, steps; the random
# start's seed); the fault distribution (seed, stragglers, their slowdown
# range, link faults, device faults, restore µs, checkpoint interval); the
# co-design search (ranks, iterations, generations, population, ΔL points,
# largest ΔL: 2 generations of 4, since 4 of 16 spent most of the script's
# time building graphs on the host, and 2 of 8 still 114 s of a 900 s run) and its dense-size guard: most of the preset's graphs exceed
# the default 256 MiB (its ring allreduces at 256 ranks have up to 3.1 M
# vertices; the bidirectional ring's plan counts 17,648 MiB), which would
# switch them to the sparse backend, which takes no cost lanes
PLACE_GRAPH = (16, 16, 10)
PLACE_SEARCH = (256, 64, (0.0, 1.0, 5.0, 10.0), 64, 8)
PLACE_SEED = 28
FAULTS = (14, 16, (1.5, 3.0), 8, 8, 2000.0, 5)
EXPLORE = (256, 3, 2, 4, 16, 20.0)
EXPLORE_DENSE_BYTES = 64 << 30
# phase 15: the analysis service.  The ΔL grid of its rank and curve on
# phase 7's study (phase 7's); the placement steps it runs from phase 14's
# start; examples/collective_study.py's arch, TraceSpec (pods, data, model)
# and the rank's ΔL points up to 50 µs; the socket's client threads; the
# device list each axis is split over (the one card, twice)
SERVICE_POINTS = CURVE_POINTS
SERVICE_PLACE_STEPS = 2
COLL_STUDY = ("jamba-1.5-large-398b", (2, 4, 8), 25)
SOCKET_CLIENTS = 2
SPLIT_DEVICES = ("cuda:0", "cuda:0")
# phase 16: the IPM's sparse Newton route.  (b)'s stencil (92,162 columns)
# and (c)'s (46,082) are past the dense route's cap, so the default
# solve_ipm takes the sparse route; (c)'s degradation
LP_SPARSE = (16, 16, 40)
LP_TOL = (16, 16, 20)
LP_TOL_DEGR = 0.01
IPM_KERNELS = ("tree_factor", "tree_solve")
# builds of a source with compile-time knobs that phase 2 makes beside the
# package's (label -> library, nvcc flags): phase 16's on-chip chain
KNOB_BUILDS = {"tree_precond chain": ("tree_precond", ("-DTP_CHAIN_ONLY",))}
# phase 12's lanes that own their gap shares, gap classes and latency
# rows: phase 4's stencil built under two-class pod models of these pod
# sizes (K 8 rank-to-class maps), with unequal gap scales a class
OWNED_PODS = (2, 4, 8, 16, 32, 64, 128, 256)
OWNED_GSCALE = (1.0, 1.5)
# phase 17: the model blocks one card serves
MLA_ARCH, RWKV_ARCH, ENCODER_ARCH = ("deepseek-v2-lite-16b", "rwkv6-7b",
                                     "hubert-xlarge")
FAMILY_XCHECK = (8, 8)                   # SMOKE card vs CPU: prompt, gen
ENCODER_XCHECK = (2, 16)                 # hubert SMOKE: batch, frames
# wkv6: S bit for bit, y within 1e-5 of its plain version relative to
# the call's largest |y| (the kernel sums the 64 terms over the key index
# in another order; elementwise, a y that cancels to near 0 has no
# relative bound)
WKV_RTOL = 1e-5
# float32 multiply and add latency on the H100's cores (cycles) and its
# boost clock: a wkv6 step's dependent pair, for the chain of T steps
FP32_LATENCY_CYCLES = 4
SM_CLOCK_HZ = 1.98e9
# instructions a (step, i, j) of wkv6's exact form: kv's, S's multiply and
# add (unfused, for S's bits), y's two multiply-adds, and a share of loads
WKV_INSTR = 6
# ptxas's registers, shared memory and spills of every kernel (phase 2)
KERNEL_INFO: dict = {}
# the knob builds' libraries (phase 2)
KNOB_LIBS: dict = {}


def ptxas_of(kernel: str) -> dict:
    """ptxas's report of the kernel whose (mangled) name holds ``kernel``."""
    return next((v for k, v in KERNEL_INFO.items() if kernel in k), {})


def check_peak(label: str, peak: int, one_cho: int) -> None:
    """A peak may exceed the one before csrc by one ``cho`` at most."""
    before = PEAK_BEFORE_CSRC[label]
    say(f"{label} peak {peak} B against {before} B before csrc: rise "
        f"{peak - before} B, one cho {one_cho} B")
    if peak - before > one_cho:
        fail(f"{label}: the peak rose {peak - before} B, more than one cho "
             f"({one_cho} B)")


def say(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 10) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls.

    A spin kernel holds the card while the host enqueues the calls, so they
    run back to back and the host's per-call cost stays out of the time;
    the run fails if the host took longer to enqueue than the spin lasted.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    if host_ms >= spin_ms:
        fail(f"enqueueing {reps} calls took {host_ms:.1f} ms, longer than "
             f"the {spin_ms:.1f} ms spin: the timing would include host gaps")
    return ev[1].elapsed_time(ev[2]) / reps


def event_ms(fn, reps: int = 1) -> float:
    """Device time in ms a call of ``fn``, from CUDA events around ``reps``
    calls, without the spin: for a call that launches more kernels than
    the launch queue holds, so the host's gaps between them are included."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def add_launches(row: dict, n: int) -> None:
    """Add a phase's main-path launches to a kernel's row."""
    row["launches"] = (row["launches"] or 0) + n


def wall(fn):
    """(result, seconds) of ``fn`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    say(f"device: {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    return name


# -- phase 2 -----------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all(variants=KNOB_BUILDS)
    say(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s "
        f"wall ({build.BUILD_DIR})")
    for lib in libs.values():
        say(f"  {lib.name}: nvcc {lib.seconds:.2f} s -> {lib.path.name}")
        if lib.name in KNOB_BUILDS:
            KNOB_LIBS[lib.name] = lib.path
            continue
        KERNEL_INFO.update(lib.ptxas)
        for kernel, info in lib.ptxas.items():
            say(f"    {kernel}: {info}")
            # the float64 level loops share one row body that fits the 64
            # registers of a 1,024-thread block only just; the lane
            # kernels (the two float64 loops' segment flavour, the dense
            # loop, the walk) must not spill either
            if any(n in kernel for n in ("levels_f64", "dense_levels_f32",
                                         "sparse_backtrace")) \
                    and info.get("spill_stores"):
                fail(f"{kernel} spills {info['spill_stores']} B")


# -- phase 3 -----------------------------------------------------------------

def kernel_inputs(kind: str, M: int, N: int, K: int, seed: int):
    """(A, t, c) on the card.  ``main``: a level as the engine stages it —
    each column (edge) has one 0 (its destination), −1e30 elsewhere."""
    rng = np.random.default_rng(seed)
    neg = np.float32(-1e30)
    if kind == "main":
        A = np.full((M, N), neg)
        A[rng.integers(0, M, N), np.arange(N)] = 0.0
        t = rng.uniform(0.0, 1e4, (N, K))
        c = rng.integers(0, 200, (N, K))
    elif kind == "random":
        A = np.where(rng.random((M, N)) < 0.3, rng.uniform(0, 10, (M, N)), neg)
        t = rng.uniform(0.0, 100.0, (N, K))
        c = rng.integers(0, 6, (N, K))
    elif kind == "ties":
        A = np.where(rng.random((M, N)) < 0.5, rng.integers(0, 3, (M, N)), neg)
        t = rng.integers(0, 4, (N, K))
        c = np.ones((N, K))
    elif kind == "empty":
        A = np.where(rng.random((M, N)) < 0.2, 0.0, neg)
        A[::3] = neg
        t = rng.uniform(0.0, 50.0, (N, K))
        t[rng.random((N, K)) < 0.3] = neg
        t[:, 0] = neg
        c = rng.integers(0, 3, (N, K))
    else:
        raise ValueError(kind)
    return tuple(torch.from_numpy(x.astype(np.float32)).cuda()
                 for x in (A, t, c))


def phase_kernels() -> list:
    from repro_torch.kernels.maxplus import (maxplus_matvec,
                                             maxplus_matvec_argmax,
                                             maxplus_matvec_argmax_ref,
                                             maxplus_matvec_ref)
    cases = [("main", *MAIN_SHAPE), ("random", 333, 200, 37),
             ("ties", *MAIN_SHAPE), ("ties", 100, 77, 13),
             ("empty", *MAIN_SHAPE), ("empty", 100, 77, 13)]
    err = {"maxplus_matvec": 0.0, "maxplus_matvec_argmax": 0.0}
    for i, (kind, M, N, K) in enumerate(cases):
        A, t, c = kernel_inputs(kind, M, N, K, seed=i)
        out = maxplus_matvec(A, t)
        o, idx = maxplus_matvec_argmax(A, t, c)
        torch.cuda.synchronize()
        ref = maxplus_matvec_ref(A, t)
        ro, ri = maxplus_matvec_argmax_ref(A, t, c)
        ok = (torch.equal(out, ref) and torch.equal(o, ro)
              and torch.equal(idx, ri))
        e1 = float((out - ref).abs().max())
        e2 = float((o - ro).abs().max())
        say(f"check {kind:6s} {M}x{N}x{K}: max|out-plain| {e1} / {e2}, "
            f"idx mismatches {int((idx != ri).sum())}")
        if not ok:
            fail(f"kernel differs from its plain version on {kind} "
                 f"{M}x{N}x{K}")
        err["maxplus_matvec"] = max(err["maxplus_matvec"], e1)
        err["maxplus_matvec_argmax"] = max(err["maxplus_matvec_argmax"], e2)

    M, N, K = MAIN_SHAPE
    A, t, c = kernel_inputs("main", M, N, K, seed=99)
    ops = 2.0 * M * N * K                     # one add, one max per candidate
    rows = []
    for name, fn, plain, nbytes in (
            ("maxplus_matvec", lambda: maxplus_matvec(A, t),
             lambda: maxplus_matvec_ref(A, t), 4 * (M * N + N * K + M * K)),
            ("maxplus_matvec_argmax", lambda: maxplus_matvec_argmax(A, t, c),
             lambda: maxplus_matvec_argmax_ref(A, t, c),
             4 * (M * N + 2 * N * K + 2 * M * K))):
        ms = cuda_ms(fn, reps=500, warmup=50)
        plain_ms = cuda_ms(plain, reps=20, warmup=5)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/maxplus.cu",
            "replaces": ("src/repro/kernels/maxplus/kernel.py:45"
                         if name == "maxplus_matvec"
                         else "src/repro/kernels/maxplus/kernel.py:108"),
            "launches": None, "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None})
        say(f"time {name} {M}x{N}x{K}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
            f"({rows[-1]['bound_by']}: {nbytes} B, {ops:.0f} ops), "
            "library none")
    return rows


def phase_batched() -> list:
    """The graph-batched kernels against their plain versions (and each
    graph against the solo kernel on its slice), then their times at the
    packed study's shape."""
    from repro_torch.kernels.maxplus import (maxplus_matvec_argmax,
                                             maxplus_matvec_argmax_batched,
                                             maxplus_matvec_argmax_batched_ref,
                                             maxplus_matvec_batched,
                                             maxplus_matvec_batched_ref)
    G, M, N, K = STUDY_SHAPE
    cases = [("main", G, M, N, K), ("ties", G, M, N, K),
             ("empty", G, M, N, K), ("main", G, M, N, 37),
             ("random", 1, 100, 77, 13), ("ties", 5, 33, 300, 1),
             ("empty", 5, 100, 77, 13), ("random", 2, 1, 1, 1)]
    err = {"maxplus_matvec_batched": 0.0,
           "maxplus_matvec_argmax_batched": 0.0}

    def inputs(kind, g, m, n, k, seed):
        per = [kernel_inputs(kind, m, n, k, seed * 16 + i) for i in range(g)]
        return tuple(torch.stack([x[i] for x in per]) for i in range(3))

    for i, (kind, g, m, n, k) in enumerate(cases):
        A, t, c = inputs(kind, g, m, n, k, seed=200 + i)
        out = maxplus_matvec_batched(A, t)
        o, idx = maxplus_matvec_argmax_batched(A, t, c)
        solo = [maxplus_matvec_argmax(A[j], t[j], c[j]) for j in range(g)]
        torch.cuda.synchronize()
        ref = maxplus_matvec_batched_ref(A, t)
        ro, ri = maxplus_matvec_argmax_batched_ref(A, t, c)
        e1 = float((out - ref).abs().max())
        e2 = float((o - ro).abs().max())
        same_solo = all(torch.equal(o[j], so) and torch.equal(idx[j], si)
                        for j, (so, si) in enumerate(solo))
        say(f"check batched {kind:6s} {g}x{m}x{n}x{k}: max|out-plain| {e1} "
            f"/ {e2}, idx mismatches {int((idx != ri).sum())}, each graph "
            f"equal to the solo kernel: {same_solo}")
        if not (torch.equal(out, ref) and torch.equal(o, ro)
                and torch.equal(idx, ri) and same_solo):
            fail(f"batched kernel differs from its plain version (or the "
                 f"solo kernel) on {kind} {g}x{m}x{n}x{k}")
        err["maxplus_matvec_batched"] = max(err["maxplus_matvec_batched"], e1)
        err["maxplus_matvec_argmax_batched"] = max(
            err["maxplus_matvec_argmax_batched"], e2)

    A, t, c = inputs("main", G, M, N, K, seed=99)
    ops = 2.0 * G * M * N * K                 # one add, one max per candidate
    rows = []
    for name, fn, plain, nbytes, line in (
            ("maxplus_matvec_batched", lambda: maxplus_matvec_batched(A, t),
             lambda: maxplus_matvec_batched_ref(A, t),
             4 * G * (M * N + N * K + M * K), 331),
            ("maxplus_matvec_argmax_batched",
             lambda: maxplus_matvec_argmax_batched(A, t, c),
             lambda: maxplus_matvec_argmax_batched_ref(A, t, c),
             4 * G * (M * N + 2 * N * K + 2 * M * K), 184)):
        ms = cuda_ms(fn, reps=500, warmup=50)
        # G plain calls a rep: 8 reps stay inside the spin window
        plain_ms = cuda_ms(plain, reps=8, warmup=3)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/maxplus.cu",
            "replaces": f"src/repro/kernels/maxplus/kernel.py:{line}",
            "launches": None, "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None})
        say(f"time {name} {G}x{M}x{N}x{K}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
            f"({rows[-1]['bound_by']}: {nbytes} B, {ops:.0f} ops), "
            "library none")
    return rows


def slot_inputs(kind: str, M: int, E: int, K: int, seed: int):
    """(dst [E, 1] int32, cand, c [E, K] f32) on the card.  ``main``: a
    level's window as the sparse forward stages it — destinations sorted,
    the window's last slots pad slots at row M."""
    rng = np.random.default_rng(seed)
    neg = np.float32(-1e30)
    dst = rng.integers(0, M, E)
    cand = rng.uniform(0.0, 1e4, (E, K))
    c = rng.integers(0, 200, (E, K))
    if kind == "main":
        dst = np.sort(dst)
        dst[-E // 16:] = M
    elif kind == "empty":                 # random rows, a quarter empty
        dst = rng.integers(0, (3 * M) // 4, E)
        cand[rng.random((E, K)) < 0.2] = neg
        cand[:, 0] = neg
    elif kind == "pad":                   # pad slots at M and past it
        dst[rng.random(E) < 0.3] = M
        dst[rng.random(E) < 0.1] = M + 5
    elif kind == "ties":                  # full ties across slot tiles
        dst = rng.integers(0, 8, E)
        cand = rng.integers(0, 2, (E, K))
        c = rng.integers(0, 2, (E, K))
        cand[3] = cand[E - 5] = 7.0
        c[3] = c[E - 5] = 3.0
        dst[3] = dst[E - 5] = 1
    else:
        raise ValueError(kind)
    return (torch.from_numpy(dst.astype(np.int32)[:, None]).cuda(),
            *(torch.from_numpy(x.astype(np.float32)).cuda()
              for x in (cand, c)))


def phase_slotlist() -> dict:
    """The slot-list kernel against its plain version, and its times."""
    from repro_torch.kernels.maxplus import (maxplus_slotlist_argmax,
                                             maxplus_slotlist_argmax_ref)
    M, E, K = SLOT_SHAPE
    cases = [("main", M, E, K), ("empty", 500, 300, 64), ("pad", M, E, K),
             ("ties", 16, 200, 64), ("main", M, E, 37), ("pad", 100, 100, 33),
             ("empty", 64, 70, 1)]
    err = 0.0
    for i, (kind, m, e, k) in enumerate(cases):
        dst, cand, c = slot_inputs(kind, m, e, k, seed=100 + i)
        o, idx = maxplus_slotlist_argmax(dst, cand, c, m)
        torch.cuda.synchronize()
        ro, ri = maxplus_slotlist_argmax_ref(dst, cand, c, m)
        e1 = float((o - ro).abs().max())
        say(f"check slotlist {kind:5s} {m}x{e}x{k}: max|out-plain| {e1}, "
            f"idx mismatches {int((idx != ri).sum())}, empty rows "
            f"{int((ri[:, 0] < 0).sum())}")
        if not (torch.equal(o, ro) and torch.equal(idx, ri)):
            fail(f"slot-list kernel differs from its plain version on "
                 f"{kind} {m}x{e}x{k}")
        if kind == "ties" and not bool((idx[1] == e - 5).all()):
            fail("slot-list kernel: the largest ordinal must win a full tie")
        err = max(err, e1)

    dst, cand, c = slot_inputs("main", M, E, K, seed=99)
    ms = cuda_ms(lambda: maxplus_slotlist_argmax(dst, cand, c, M),
                 reps=500, warmup=50)
    plain_ms = cuda_ms(lambda: maxplus_slotlist_argmax_ref(dst, cand, c, M),
                       reps=20, warmup=5)
    dk = torch.where(dst[:, 0] < M, dst[:, 0], M).long()[:, None].expand(E, K)

    def scatter_values():
        out = torch.full((M + 1, K), -1e30, device=cand.device)
        return out.scatter_reduce_(0, dk, cand, "amax")

    scatter_ms = cuda_ms(scatter_values, reps=500, warmup=50)
    nbytes = 4 * (E + 2 * E * K + 2 * M * K)
    ops = 3.0 * E * K                # value, key and ordinal compares
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    row = {
        "name": "maxplus_slotlist_argmax", "route": "cuda",
        "source": "src/repro_torch/kernels/maxplus/csrc/maxplus.cu",
        "replaces": "src/repro/kernels/maxplus/kernel.py:262",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None}
    say(f"time maxplus_slotlist_argmax {M}x{E}x{K}: kernel {ms:.6f} ms, "
        f"plain {plain_ms:.6f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}: {nbytes} B, {ops:.0f} ops), library none")
    say(f"time scatter_reduce_(amax) {M}x{E}x{K}, values (out) only, not "
        f"the argmax: {scatter_ms:.6f} ms")
    return row


def sparse_stencil():
    """The sparse stencil of phase 6 and its plan: (g, p, plan, seconds to
    build the graph)."""
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.sweep import compile_sparse
    p = cluster_params(L_us=3.0, o_us=5.0)
    px, py, iters = SPARSE_STENCIL
    g, t_graph = wall(lambda: synth.stencil2d(px, py, iters, halo_bytes=64e3,
                                              comp_us=500.0, params=p))
    return g, p, compile_sparse(g, p), t_graph


def level_state(nv_p: int, S: int, want_lam: bool,
                key_dtype: torch.dtype = torch.float32):
    """(t, ssum, cho, csrc) of a fresh sparse forward on the card (tie keys
    in ``key_dtype``; the last three None in values mode)."""
    from repro_torch.sweep import engine as eng
    return eng._state((nv_p,), S, want_lam, torch.device("cuda"), key_dtype)


def mismatches(got, want) -> dict:
    """Elements that differ, by array, of (t, ssum, cho, csrc) states."""
    return {n: int((u != v).sum()) for n, u, v in
            zip(("t", "ssum", "cho", "csrc"), got, want) if u is not None}


def walk_steps(vsel, cho, csrc, nlv: int):
    """(steps a scenario, distinct edges walked) of the walks from
    ``vsel`` down ``cho`` / ``csrc`` (numpy, on the host)."""
    cho_np, src_np = cho.cpu().numpy(), csrc.cpu().numpy()
    v = vsel.cpu().numpy()
    cols = np.arange(v.shape[0])
    steps = np.zeros(v.shape[0], dtype=np.int64)
    seen = []
    for _ in range(nlv):
        e = cho_np[v, cols]
        live = e >= 0
        if not live.any():
            break
        steps += live
        seen.append(e[live])
        v = np.where(live, src_np[v, cols], v)
    return steps, int(np.unique(np.concatenate(seen)).size) if seen else 0


def walk_bytes(steps, n_edges: int, S: int, nc: int) -> int:
    """The walk's bytes, each input read once and each output written
    once: cho and csrc once per (vertex, scenario) read, the last read (cho
    < 0) included; elat once per distinct edge walked; vsel in, λ out."""
    return (4 + 4) * (int(steps.sum()) + S) + n_edges * 8 * nc \
        + S * (8 + 8 * nc)


def phase_levels(p, sp):
    """The level-loop kernel against its plain version on the first weight
    chunk of the sparse stencil at S = 256, in both modes, and the walk
    kernel against its plain version after a whole λ forward; their times
    beside their bounds.  Returns their rows."""
    from repro_torch.kernels.maxplus import (sparse_backtrace,
                                             sparse_backtrace_ref,
                                             sparse_levels_f32,
                                             sparse_levels_f32_ref,
                                             sparse_walk_ref)
    from repro_torch.sweep import latency_grid
    from repro_torch.sweep import engine as eng
    S = CURVE_POINTS
    a = eng.stage_sparse(sp, torch.device("cuda"), torch.float32)
    batch = latency_grid(p, np.linspace(0.0, 100.0, S))
    L = torch.from_numpy(batch.L).cuda()
    GS = torch.from_numpy(batch.gscale).cuda()
    nv_p = a.vcost.shape[0]
    chunks = list(eng._chunk_weights(a, L, GS, sp.nlevels))
    lv0, lv1, base, w = chunks[0]
    w = w.contiguous()
    r0, r1 = int(sp.v_ptr[lv0]), int(sp.v_ptr[lv1])

    def run(fn, state):
        fn(*state[:3], w, base, a.esrc, a.row_ptr, a.v_ptr_dev, a.elat_sum,
           a.vcost, lv0, lv1, state[3])
        return state

    err = 0.0
    for want_lam in (False, True):
        plain = run(sparse_levels_f32_ref, level_state(nv_p, S, want_lam))
        got = run(sparse_levels_f32, level_state(nv_p, S, want_lam))
        torch.cuda.synchronize()
        miss = mismatches(got, plain)
        e_t = float((got[0][r0:r1] - plain[0][r0:r1]).abs().max())
        e_s = 0
        if want_lam:
            e_s = float((got[1][r0:r1] - plain[1][r0:r1]).abs().max())
        err = max(err, e_t, e_s)
        say(f"check sparse_levels_f32 {'λ' if want_lam else 'values'}: "
            f"levels {lv0}..{lv1 - 1} of {sp.nlevels} ({len(chunks)} "
            f"chunks), max|t-plain| {e_t}, max|ssum-plain| {e_s}, "
            f"mismatches {miss}")
        if any(miss.values()):
            fail("level-loop kernel differs from its plain version")
    state = plain                 # the chunk is final: reruns are idempotent
    ms = cuda_ms(lambda: run(sparse_levels_f32, state), reps=20, warmup=3)
    plain_ms = event_ms(lambda: run(sparse_levels_f32_ref, state))
    lp = sp.level_ptr
    ne = int(lp[lv1] - lp[lv0])
    nr = r1 - r0
    es = sp.esrc_slot[int(lp[lv0]):int(lp[lv1])]
    n_old = int(np.unique(es[es < r0]).size)     # rows from earlier chunks
    # the bound: each input read once, each output written once (λ): w and
    # the earlier chunks' t/ssum rows per scenario, the rows' t/ssum/cho/
    # csrc, and the topology (esrc, elat_sum an edge; row_ptr, vcost a row;
    # v_ptr a level) once; t[src]/ssum[src] of rows this launch wrote are
    # its intermediates
    nbytes = (8 * ne + (8 + 4) * n_old + (8 + 4 + 4 + 4) * nr) * S \
        + (8 + 4) * ne + (4 + 8) * nr + 4 * (lv1 - lv0 + 1)
    # what this design moves: w, t[src] and ssum[src] an edge, t, ssum, cho
    # and csrc a row, per scenario
    traffic = ((8 + 8 + 4) * ne + (8 + 4 + 4 + 4) * nr) * S
    ops = 5.0 * ne * S               # two adds, three compares an edge
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3

    # the walk, after a whole λ forward through the level-loop kernel
    t, ssum, cho, csrc = level_state(nv_p, S, True)
    for c0, c1, b, wc in chunks:
        sparse_levels_f32(t, ssum, cho, wc.contiguous(), b, a.esrc,
                          a.row_ptr, a.v_ptr_dev, a.elat_sum, a.vcost, c0,
                          c1, csrc)
    del chunks, w
    nv = sp.nv
    T = t[:nv].amax(0)
    sink = t[:nv] >= T
    mx = torch.where(sink, ssum[:nv], -1e30).amax(0)
    vsel = torch.where(sink & (ssum[:nv] >= mx), a.vert_of_slot[:nv, None],
                       torch.iinfo(torch.int32).max).argmin(0)
    ch, cs = cho[:nv], csrc[:nv]
    del t, ssum
    lam = sparse_backtrace(vsel, ch, cs, a.elat, sp.nlevels)
    torch.cuda.synchronize()
    lam_ref = sparse_walk_ref(vsel, ch, cs, a.elat, sp.nlevels)
    # the one-load walk's plain version against the two-load one over esrc
    two_load = torch.equal(lam_ref, sparse_backtrace_ref(
        vsel, ch, a.esrc, a.elat, sp.nlevels))
    walk_err = float((lam - lam_ref).abs().max())
    say(f"check sparse_backtrace S {S}: max|λ-plain| {walk_err}, λ "
        f"bit-equal {torch.equal(lam, lam_ref)} (the plain one-load walk "
        f"equal to the two-load walk over esrc: {two_load}), λ_L(0) "
        f"{float(lam[0, 0])!r}")
    if not (torch.equal(lam, lam_ref) and two_load):
        fail("walk kernel differs from its plain version")
    steps, n_edges = walk_steps(vsel, ch, cs, sp.nlevels)
    walk_ms = cuda_ms(lambda: sparse_backtrace(vsel, ch, cs, a.elat,
                                               sp.nlevels),
                      reps=10, warmup=2)
    walk_plain_ms = event_ms(lambda: sparse_walk_ref(
        vsel, ch, cs, a.elat, sp.nlevels))
    nc = sp.nclass
    steps_max = int(steps.max())
    nbytes_walk = walk_bytes(steps, n_edges, S, nc)
    regs = ptxas_of("sparse_backtrace_kernel")
    say(f"time sparse_levels_f32 λ, one weight chunk ({lv1 - lv0} levels, "
        f"{ne} edges, {nr} rows, {n_old} source rows from earlier chunks) "
        f"at S {S}: kernel {ms:.6f} ms; plain {plain_ms:.6f} ms (CUDA "
        f"events, host gaps included); bound {max(t_bytes, t_ops):.6f} ms "
        f"(bytes: {nbytes} B, {ops:.0f} ops); this design's traffic "
        f"{traffic} B = {traffic / HBM_BYTES_PER_S * 1e3:.6f} ms; "
        f"dependent-load chain {lv1 - lv0} levels x {TRIP_US} us = "
        f"{(lv1 - lv0) * TRIP_US / 1e3:.6f} ms")
    say(f"time sparse_backtrace S {S}: kernel {walk_ms:.6f} ms, plain "
        f"{walk_plain_ms:.6f} ms (CUDA events, host gaps included), bound "
        f"{nbytes_walk / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes: "
        f"{nbytes_walk} B, {n_edges} distinct edges, {int(steps.sum())} "
        f"steps); chain {steps_max} steps on the longest path x 1 dependent "
        f"load x {TRIP_US} us = {steps_max * TRIP_US / 1e3:.6f} ms (the "
        f"two-load walk's: {steps_max} x 2 x {TRIP_US} us = "
        f"{steps_max * 2 * TRIP_US / 1e3:.6f} ms); measured "
        f"{walk_ms * 1e3 / steps_max:.4f} us a step; ptxas {regs}")
    src = "src/repro_torch/kernels/maxplus/csrc/sparse_levels.cu"
    return [
        {"name": "sparse_levels_f32", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/maxplus/kernel.py:262",
         "launches": None, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes > t_ops else "operations",
         "library_ms": None},
        # not a TPU kernel: the reference's backtrace is a lax.scan
        {"name": "sparse_backtrace", "route": "cuda", "source": src,
         "replaces": "src/repro/sweep/engine.py:987",
         "launches": None, "max_abs_err": walk_err, "ms": walk_ms,
         "plain_ms": walk_plain_ms,
         "bound_ms": nbytes_walk / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None}]


def phase_dense_levels(g, p, study) -> dict:
    """The dense level-loop kernel against its plain version at S = 256 on
    phase 4's whole plan and on phase 7's packed plan, values and λ, bit
    for bit on t, ssum, cho and csrc; its times beside its bounds (bytes,
    and the chain of levels × ``TRIP_US``, one dependent load).  Then the packed walk (all four graphs in one launch) against
    its plain version on the packed plan's λ state, and its time."""
    from repro_torch.kernels.maxplus import (dense_levels_f32,
                                             dense_levels_f32_ref,
                                             sparse_backtrace,
                                             sparse_walk_ref)
    from repro_torch.sweep import compile_plan, latency_grid, pack_plans
    from repro_torch.sweep import engine as eng
    cuda = torch.device("cuda")
    S = CURVE_POINTS
    variants, p_study, _ = study
    batch = latency_grid(p, np.linspace(0.0, 100.0, S))
    L = torch.from_numpy(batch.L).cuda()
    GS = torch.from_numpy(batch.gscale).cuda()

    def kernel(state, d, w):
        dense_levels_f32(*state[:3], w, d.A, d.esrc, d.lv_ptr, d.rows,
                         d.row_ptr, d.in_edges, d.elat_sum, d.vcost_lv,
                         state[3])
        return state

    def plain(state, d, w):
        dense_levels_f32_ref(*state[:3], w, d.A, d.esrc, d.elat_sum,
                             d.vcost_lv, state[3])
        return state

    def fresh(lead, want_lam):
        return eng._state(lead, S, want_lam, cuda)

    def check(label, d, w) -> float:
        lead = tuple(d.valid_flat.shape)
        err = 0.0
        for want_lam in (False, True):
            got = kernel(fresh(lead, want_lam), d, w)
            want = plain(fresh(lead, want_lam), d, w)
            torch.cuda.synchronize()
            miss = mismatches(got, want)
            ok = not any(miss.values())
            e_t = float((got[0] - want[0]).abs().max())
            e_s = 0.0
            if want_lam:
                e_s = float((got[1] - want[1]).abs().max())
            say(f"check dense_levels_f32 {label} "
                f"{'λ' if want_lam else 'values'} S {S}: max|t-plain| "
                f"{e_t}, max|ssum-plain| {e_s}, mismatches {miss}, "
                f"bit-equal {ok}")
            if not ok:
                fail(f"dense level-loop kernel differs from its plain "
                     f"version on {label}")
            err = max(err, e_t, e_s)
            del got, want
        return err

    def bound(d, label, nlv=None) -> dict:
        """The least time of one λ launch on ``d``: each input read once,
        each output written once — the real edges' w and the listed rows'
        t/ssum/cho/csrc per scenario (the other rows keep the fresh state), and
        the lists (in_edges and elat_sum an edge; rows, row_ptr and vcost a
        listed row; lv_ptr a level) once; t[src]/ssum[src] are rows the
        launch wrote itself.  Beside it the chain: levels with a listed row
        × ``TRIP_US``."""
        lv_ptr = d.lv_ptr.reshape(-1, d.lv_ptr.shape[-1]).cpu().numpy()
        row_ptr = d.row_ptr.reshape(-1, d.row_ptr.shape[-1]).cpu().numpy()
        nlv = d.vcost_lv.shape[-2] if nlv is None else nlv
        G, Vmax = lv_ptr.shape[0], d.vcost_lv.shape[-1]
        ne = int(sum(int(r[lv[nlv]]) for r, lv in zip(row_ptr, lv_ptr)))
        nr = int(sum(int(lv[nlv]) for lv in lv_ptr))
        levels = int((np.diff(lv_ptr[:, :nlv + 1], axis=1) > 0).any(0).sum())
        nrows = G * nlv * Vmax
        nbytes = (8 * ne + (8 + 4 + 4 + 4) * nr) * S \
            + (8 + 4) * ne + (8 + 8) * nr + 4 * G * (nlv + 1)
        # two float64 adds, three roundings, two float32 adds and three
        # compares an edge; two float64 adds a listed row
        ops = (10.0 * ne + 2.0 * nr) * S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        chain_ms = levels * TRIP_US / 1e3
        say(f"bound dense_levels_f32 λ, {label} ({G} graph(s), {nlv} levels "
            f"walked, {levels} with a listed row, {ne} real edges, {nr} "
            f"listed rows of {nrows}) at S {S}: {max(t_bytes, t_ops):.6f} ms "
            f"(bytes: {nbytes} B, {ops:.0f} ops); dependent-load chain "
            f"{levels} levels x {TRIP_US} us = {chain_ms:.6f} ms")
        return {"bound_ms": max(t_bytes, t_ops), "chain_ms": chain_ms,
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "levels": levels}

    # phase 4's plan, whole
    d = eng.stage(compile_plan(g, p), cuda)
    w = eng.edge_weights(d, L, GS)
    err = check("phase 4's plan", d, w)
    state = kernel(fresh(tuple(d.valid_flat.shape), True), d, w)
    ms = cuda_ms(lambda: kernel(state, d, w), reps=10, warmup=2)
    ms_values = cuda_ms(lambda: kernel((state[0], None, None, None), d, w),
                        reps=10, warmup=2)
    plain_ms = event_ms(lambda: plain(state, d, w))
    solo = bound(d, "phase 4's plan")
    say(f"time dense_levels_f32 λ, phase 4's plan at S {S}: kernel {ms:.6f} "
        f"ms ({ms * 1e3 / solo['levels']:.4f} us a level with a listed row), "
        f"values mode {ms_values:.6f} ms; plain {plain_ms:.6f} ms (CUDA "
        f"events, host gaps included); bound {solo['bound_ms']:.6f} ms, "
        f"chain {solo['chain_ms']:.6f} ms")
    del state, w, d

    # the study's packed plan (G = 4, 5,050 levels walked)
    plans = [compile_plan(v.graph, v.params) for v in variants]
    dm = eng.stage_multi(pack_plans(plans), cuda)
    G = len(plans)
    sb = latency_grid(p_study, np.linspace(0.0, 100.0, S))
    Lm = torch.from_numpy(np.stack([sb.L] * G)).cuda()
    GSm = torch.from_numpy(np.stack([sb.gscale] * G)).cuda()
    wm = eng.multi_weights(dm, Lm, GSm, int(dm.nlevels.max()))
    err = max(err, check(f"the study's packed plan (G {G})", dm, wm))
    state = kernel(fresh(tuple(dm.valid_flat.shape), True), dm, wm)
    ms_packed = cuda_ms(lambda: kernel(state, dm, wm), reps=5, warmup=1)
    plain_packed = event_ms(lambda: plain(state, dm, wm))
    packed = bound(dm, f"the study's packed plan (G {G})", wm.shape[1])
    say(f"time dense_levels_f32 λ, the study's packed plan at S {S}: kernel "
        f"{ms_packed:.6f} ms ({ms_packed * 1e3 / packed['levels']:.4f} us a "
        f"level with a listed row); plain {plain_packed:.6f} ms (CUDA events, "
        f"host gaps included); bound {packed['bound_ms']:.6f} ms, chain "
        f"{packed['chain_ms']:.6f} ms")
    # the packed walk: every graph's sinks, then all G walks in one launch
    t, ssum, cho, csrc = state
    nlv = wm.shape[1]
    vsel = torch.stack([eng._dense_sink(t[g], ssum[g], dm.valid[g],
                                        dm.valid_flat[g],
                                        dm.vert_of_slot[g])[1]
                        for g in range(G)])
    elat = dm.elat.view(G, -1, dm.elat.shape[-1])
    lam = sparse_backtrace(vsel, cho, csrc, elat, nlv)
    torch.cuda.synchronize()
    lam_ref = sparse_walk_ref(vsel, cho, csrc, elat, nlv)
    as_solo = all(torch.equal(lam[g], sparse_walk_ref(
        vsel[g], cho[g], csrc[g], elat[g], nlv)) for g in range(G))
    walk_err = float((lam - lam_ref).abs().max())
    say(f"check sparse_backtrace packed (G {G}) S {S}: max|λ-plain| "
        f"{walk_err}, λ bit-equal {torch.equal(lam, lam_ref)}, each graph "
        f"equal to its solo walk {as_solo}")
    if not (torch.equal(lam, lam_ref) and as_solo):
        fail("the packed walk differs from its plain version")
    walk_packed_ms = cuda_ms(lambda: sparse_backtrace(vsel, cho, csrc, elat,
                                                      nlv), reps=10, warmup=2)
    steps = [walk_steps(vsel[g], cho[g], csrc[g], nlv) for g in range(G)]
    nbytes_walk = sum(walk_bytes(st, ne, S, elat.shape[-1])
                      for st, ne in steps)
    steps_max = max(int(st.max()) for st, _ in steps)
    say(f"time sparse_backtrace packed (G {G}, one launch) S {S}: kernel "
        f"{walk_packed_ms:.6f} ms; bound "
        f"{nbytes_walk / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes: {nbytes_walk} "
        f"B); chain {steps_max} steps x {TRIP_US} us = "
        f"{steps_max * TRIP_US / 1e3:.6f} ms")
    del state, wm, dm, t, ssum, cho, csrc
    torch.cuda.empty_cache()
    return {"name": "dense_levels_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/dense_levels.cu",
            "replaces": "src/repro/kernels/maxplus/kernel.py:108",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": solo["bound_ms"],
            "bound_by": solo["bound_by"], "library_ms": None,
            "packed": {"replaces": "src/repro/kernels/maxplus/kernel.py:184",
                       "ms": ms_packed, "plain_ms": plain_packed,
                       "bound_ms": packed["bound_ms"],
                       "bound_by": packed["bound_by"], "library_ms": None},
            "walk_packed": {"ms": walk_packed_ms, "max_abs_err": walk_err,
                            "bound_ms": nbytes_walk / HBM_BYTES_PER_S * 1e3,
                            "bound_by": "bytes"}}


def tie_graph(p):
    """Phase 3's tie-heavy graph for the float64 level loop: 16 ranks x 6
    rounds of integer-cost compute and 1-byte ring and skip messages, each
    round closed on every rank by a join of its own and six other ranks'
    tails (rows of 7 in-edges, more than the kernel keeps in registers)
    through edges of integer cost, some carrying a class-0 latency, some
    1e-13 off (ties within core.dag's ATOL)."""
    from repro_torch.core.graph import GraphBuilder
    R, rounds = TIE_GRAPH
    rng = np.random.default_rng(7)
    b = GraphBuilder(R, p.nclass)
    for _ in range(rounds):
        for r in range(R):
            b.add_calc(r, 10.0 * float(rng.integers(1, 4)))
        for r in range(R):
            b.add_message(r, (r + 1) % R, 1.0, p)
            b.add_message(r, (r + 3) % R, 1.0, p)
        tails = [b.tail(r) for r in range(R)]
        for r in range(R):
            v = b.add_sync_vertex(r)
            others = rng.choice([q for q in range(R) if q != r], 6,
                                replace=False)
            for q in [r, *others]:
                off = 1e-13 if rng.random() < 0.25 else 0.0
                b.add_edge(tails[q], v,
                           const_us=float(rng.integers(0, 3)) + off,
                           lat=((0, int(rng.integers(0, 2))),))
            b.set_tail(r, v)
    return b.finalize()


def wide_graph(p):
    """Phase 3's wide plan for the float64 level loop (``WIDE_GRAPH``): R
    ranks x rounds of compute and random ring messages, and from round
    ``reach`` on a join on every rank of its own tail and a tail ``reach``
    rounds back (tests/test_torch_walk.py's ``wide_graph``)."""
    from repro_torch.core.graph import GraphBuilder
    R, rounds, reach = WIDE_GRAPH
    rng = np.random.default_rng(11)
    b = GraphBuilder(R, p.nclass)
    hist = []
    for i in range(rounds):
        for r in range(R):
            b.add_calc(r, float(rng.integers(1, 50)))
        for r in range(R):
            if rng.random() < 0.5:
                b.add_message(r, (r + 1 + int(rng.integers(0, 5))) % R,
                              float(rng.integers(1, 4096)), p)
        tails = [b.tail(r) for r in range(R)]
        hist.append(tails)
        if i >= reach:
            for r in range(R):
                v = b.add_sync_vertex(r)
                b.add_edge(hist[i - reach][(7 * r) % R], v,
                           const_us=float(rng.integers(0, 4000)),
                           lat=((0, int(rng.integers(1, 3))),))
                b.add_edge(tails[r], v, const_us=0.0)
                b.set_tail(r, v)
    return b.finalize()


def phase_levels_f64(p, sp) -> dict:
    """The float64 level-loop kernel (its ring and window) against its
    plain version, bit for bit on t, ssum, cho and csrc with the mismatches
    counted, values and λ, at S = 256, 37 and 1 (37 and 1 off the block's 8
    scenarios): on the levels of the first weight chunk of phase 6's
    stencil, on the tie-heavy plan's and on the wide plan's whole forwards
    (``wide_graph``: levels wider than a ring slot, sources past the
    window); its time on phase 6's chunk beside its bounds (bytes, and the
    chain of levels x ``TRIP_US``), its registers and spills."""
    from repro_torch.kernels.maxplus import (sparse_levels_f64,
                                             sparse_levels_f64_ref)
    from repro_torch.sweep import compile_sparse, latency_grid
    from repro_torch.sweep import engine as eng
    cuda = torch.device("cuda")

    def state(a, S, want_lam):
        return level_state(a.vcost.shape[0], S, want_lam, torch.float64)

    def run(fn, st, a, chunks):
        for lv0, lv1, base, w in chunks:
            fn(*st[:3], w, base, a.esrc, a.row_ptr, a.v_ptr_dev, a.elat_sum,
               a.vcost, lv0, lv1, st[3])
        return st

    def check(label, a, chunks, S) -> float:
        err = 0.0
        for want_lam in (False, True):
            got = run(sparse_levels_f64, state(a, S, want_lam), a, chunks)
            want = run(sparse_levels_f64_ref, state(a, S, want_lam), a,
                       chunks)
            torch.cuda.synchronize()
            miss = mismatches(got, want)
            e = max(float((u - v).abs().max()) for u, v in
                    zip(got[:2], want[:2]) if u is not None)
            say(f"check sparse_levels_f64 {label} S {S} "
                f"{'λ' if want_lam else 'values'} ({len(chunks)} chunk(s)): "
                f"max|kernel-plain| {e}, mismatches {miss}")
            if any(miss.values()):
                fail(f"sparse_levels_f64 differs from its plain version on "
                     f"{label} at S {S}")
            err = max(err, e)
        return err

    def grid(params, S, top):
        b = latency_grid(params, np.linspace(0.0, top, S))
        return (torch.from_numpy(b.L).cuda(), torch.from_numpy(b.gscale).cuda())

    def whole(a, params, S):
        """Every weight chunk of a forward at width S."""
        return [(c0, c1, b0, wc.contiguous()) for c0, c1, b0, wc in
                eng._chunk_weights(a, *grid(params, S, 12.0), a.nlevels)]

    # the levels of phase 6's first weight chunk at S = 256, at each width
    a = eng.stage_sparse(sp, cuda, torch.float64)
    lv0, lv1, base, end = eng.weight_chunks(a.level_ptr, a.Emax_lv,
                                            CURVE_POINTS, sp.nlevels)[0]
    sl = slice(base, end)

    def chunk(S):
        return [(lv0, lv1, base, eng._weights(
            a.egclass[sl], a.egap[sl], a.econst[sl], a.elat[sl],
            *grid(p, S, 100.0)).contiguous())]

    label = f"phase 6's chunk (levels {lv0}..{lv1 - 1} of {sp.nlevels})"
    err = 0.0
    for S in (CURVE_POINTS, 37, 1):
        err = max(err, check(label, a, chunk(S), S))
    S = CURVE_POINTS
    first = chunk(S)
    st = run(sparse_levels_f64_ref, state(a, S, True), a, first)
    ms = cuda_ms(lambda: run(sparse_levels_f64, st, a, first), reps=20,
                 warmup=3)
    plain_ms = event_ms(lambda: run(sparse_levels_f64_ref, st, a, first))
    del st, first
    lp = sp.level_ptr
    r0, r1 = int(sp.v_ptr[lv0]), int(sp.v_ptr[lv1])
    ne = int(lp[lv1] - lp[lv0])
    nr = r1 - r0
    es = sp.esrc_slot[int(lp[lv0]):int(lp[lv1])]
    n_old = int(np.unique(es[es < r0]).size)
    # each input read once, each output written once (λ): w and the
    # earlier chunks' t/ssum rows per scenario, the rows' t/ssum/cho/csrc,
    # the topology (esrc, elat_sum an edge; row_ptr, vcost a row; v_ptr a
    # level) once; t[src]/ssum[src] of rows the launch wrote are its own
    # intermediates.  Operations, in float64: two adds and four compares
    # an edge (the candidate and its slope; the max, the hit, the best, the
    # selection), an add and two subtractions a row
    nbytes = (8 * ne + (8 + 8) * n_old + (8 + 8 + 4 + 4) * nr) * S \
        + (8 + 8) * ne + (4 + 8) * nr + 4 * (lv1 - lv0 + 1)
    ops = (6.0 * ne + 3.0 * nr) * S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_VECTOR_OPS_PER_S * 1e3
    chain_ms = (lv1 - lv0) * TRIP_US / 1e3
    say(f"time sparse_levels_f64 λ, phase 6's chunk ({lv1 - lv0} levels, "
        f"{ne} edges, {nr} rows, {n_old} source rows from earlier chunks) "
        f"at S {S}: kernel {ms:.6f} ms ({ms * 1e3 / (lv1 - lv0):.4f} us a "
        f"level); plain {plain_ms:.6f} ms (CUDA events, host gaps "
        f"included); bound {max(t_bytes, t_ops):.6f} ms (bytes: {nbytes} B, "
        f"{ops:.0f} float64 ops); dependent-load chain {lv1 - lv0} levels x "
        f"{TRIP_US} us = {chain_ms:.6f} ms; ptxas "
        f"{ptxas_of('sparse_levels_f64_kernel')}")
    say(f"sparse_levels_f64 on phase 6's chunk: {ms:.6f} ms against "
        f"{F64_CHUNK_MS_BEFORE} ms before the shared row body "
        f"({ms / F64_CHUNK_MS_BEFORE:.4f}x)")
    if ms > F64_CHUNK_SLACK * F64_CHUNK_MS_BEFORE:
        fail(f"sparse_levels_f64 took {ms:.6f} ms on phase 6's chunk, more "
             f"than {F64_CHUNK_SLACK} x {F64_CHUNK_MS_BEFORE} ms")
    del a
    torch.cuda.empty_cache()

    # the tie-heavy plan and the wide plan, every chunk, at S on and off
    # the block's multiple
    for name, gx in (("the tie-heavy plan", tie_graph(p)),
                     ("the wide plan", wide_graph(p))):
        px = compile_sparse(gx, p)
        ax = eng.stage_sparse(px, cuda, torch.float64)
        nl = px.nlevels
        vp, lpx = px.v_ptr[:nl + 1], px.level_ptr[:nl + 1]
        own = slice(int(lpx[0]), int(lpx[nl]))
        dst = px.edst_slot[own].astype(np.int64)
        ends = vp[np.searchsorted(vp, dst, "right")]
        reach = ends - px.esrc_slot[own]
        deg = np.bincount(gx.edst, minlength=gx.num_vertices)
        say(f"{name}: {gx.num_vertices} vertices, {gx.num_edges} edges, "
            f"{nl} levels of up to {np.diff(vp).max()} rows and "
            f"{np.diff(lpx).max()} edges, {int((deg > 4).sum())} rows of "
            f"more than 4 in-edges, sources up to {reach.max()} rows back")
        for S_x in (CURVE_POINTS, 37, 1):
            err = max(err, check(name, ax, whole(ax, p, S_x), S_x))
        del ax
    return {"name": "sparse_levels_f64", "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/sparse_levels.cu",
            "replaces": "src/repro/sweep/engine.py:749",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def phase_segment_levels(g, p, study, p_tie) -> dict:
    """The segment forward's level-loop kernel against its plain version,
    bit for bit on t, ssum, cho and csrc with the mismatches counted: one
    launch over every level (the kernel forms the weights), on phase 4's
    whole plan, on phase 7's packed plan (G 4), on the tie-heavy plan
    (``tie_graph``) and on the wide plan (``wide_graph``: levels wider than
    a ring slot, sources past the window), at S = 256, 37 and 1, values and
    λ, and on phase 4's plan at S 256 with the level range split in two
    launches; its time on phase 4's plan and on the packed plan at S 256
    beside its bounds (bytes, and the chain of levels × ``TRIP_US``) and
    beside its comparable before (its time then, ``SEG_MS_BEFORE``,
    plus the weights' elementwise time, measured here as the forward
    formed them then)."""
    from repro_torch.kernels.maxplus import (segment_levels_f64,
                                             segment_levels_f64_ref)
    from repro_torch.sweep import compile_plan, latency_grid, pack_plans
    from repro_torch.sweep import engine as eng
    cuda = torch.device("cuda")
    variants, p_study, _ = study

    def plain(t, ssum, cho, *rest):
        *rest, lv0, lv1, csrc = rest
        segment_levels_f64_ref(t, ssum, cho, *rest[:10], lv0, lv1, csrc)

    def grids(a, params, S):
        """Lmat, GSmat of a 0-100 us latency grid at width S (one per
        graph when ``a`` is packed)."""
        b = latency_grid(params, np.linspace(0.0, 100.0, S))
        G = a.esrc.shape[0] if a.esrc.dim() == 3 else 0
        return [torch.from_numpy(np.stack([x] * G) if G else x).cuda()
                for x in (b.L, b.gscale)]

    def run(fn, st, a, LG, ranges):
        for lv0, lv1 in ranges:
            fn(*st[:3], *LG, *eng.segment_inputs(a), lv0, lv1, st[3])
        return st

    def fresh(a, S, want_lam):
        return eng._state(tuple(a.valid_flat.shape), S, want_lam, cuda,
                          torch.float64)

    def check(label, a, params, widths=(CURVE_POINTS, 37, 1),
              split=False) -> float:
        err = 0.0
        nlv = int(a.nlevels.max())
        ranges = [(0, nlv // 2), (nlv // 2, nlv)] if split else [(0, nlv)]
        for S in widths:
            LG = grids(a, params, S)
            for want_lam in (False, True):
                n0 = segment_levels_f64.launches
                got = run(segment_levels_f64, fresh(a, S, want_lam), a, LG,
                          ranges)
                want = run(plain, fresh(a, S, want_lam), a, LG, ranges)
                torch.cuda.synchronize()
                miss = mismatches(got, want)
                e = max(float((u - v).abs().max()) for u, v in
                        zip(got[:2], want[:2]) if u is not None)
                n = segment_levels_f64.launches - n0
                say(f"check segment_levels_f64 {label} S {S} "
                    f"{'λ' if want_lam else 'values'} ({n} launch(es), "
                    f"levels {ranges}): max|kernel-plain| {e}, mismatches "
                    f"{miss}")
                if any(miss.values()) or n != len(ranges):
                    fail(f"segment_levels_f64 differs from its plain version "
                         f"on {label} at S {S}, or launched {n} times")
                err = max(err, e)
                del got, want
        return err

    def bound(a, label) -> dict:
        """The least time of one λ level loop at S = 256: each input read
        once, each output written once — per scenario the listed rows'
        t/ssum/cho/csrc (8 + 8 + 4 + 4 B); once the records (in_edges 16
        B and erec 8·(3 + nc) B an edge; rows, row_ptr and rcost a listed
        row; lv_ptr a level) and the scenarios' Lmat and GSmat rows; a
        launch over every level reads no row written before it.
        Operations in float64: the weight (2 + 2·nc an edge), two adds and
        four compares an edge (the candidate and its slope; the max, the
        hit, the best, the selection), an add and two subtractions a row.
        Beside it the chain (levels with a listed row × ``TRIP_US``) and
        the bytes the blocks read: each block reads a level's records."""
        lv_ptr = a.lv_ptr.reshape(-1, a.lv_ptr.shape[-1]).cpu().numpy()
        row_ptr = a.row_ptr.reshape(-1, a.row_ptr.shape[-1]).cpu().numpy()
        nc = a.elat.shape[-1]
        S = CURVE_POINTS
        nlv = int(a.nlevels.max())
        ne = int(sum(rp[lp[nlv]] - rp[lp[0]]
                     for lp, rp in zip(lv_ptr, row_ptr)))
        nr = int(sum(lp[nlv] - lp[0] for lp in lv_ptr))
        G = lv_ptr.shape[0]
        levels = int((np.diff(lv_ptr[:, :nlv + 1], axis=1) > 0).any(0).sum())
        records = (16 + 8 * (3 + nc)) * ne + (4 + 4 + 8) * nr \
            + 4 * G * (nlv + 1)
        nbytes = (8 + 8 + 4 + 4) * nr * S + records + 8 * G * S * 2 * nc
        ops = ((2.0 + 2.0 * nc + 6.0) * ne + 3.0 * nr) * S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP64_VECTOR_OPS_PER_S * 1e3
        chain_ms = levels * TRIP_US / 1e3
        kb = 1
        while kb < 8 and G * -(-S // kb) > torch.cuda.get_device_properties(
                0).multi_processor_count:
            kb *= 2
        blocks = G * -(-S // kb)
        say(f"bound segment_levels_f64 λ, {label} ({G} graph(s), {nlv} "
            f"levels in one launch, {levels} with a listed row, {ne} real "
            f"edges, {nr} listed rows) at S {S}: {max(t_bytes, t_ops):.6f} "
            f"ms (bytes: {nbytes} B, the records {records} B once; "
            f"{ops:.0f} float64 ops); dependent-load chain {levels} levels "
            f"x {TRIP_US} us = {chain_ms:.6f} ms; {blocks // G} blocks a "
            f"graph of {kb} scenarios each read the records: "
            f"{records // G * blocks} B")
        return {"bound_ms": max(t_bytes, t_ops), "chain_ms": chain_ms,
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "levels": levels}

    def weights_ms(a, LG) -> float:
        """The weights as the forward formed them before its level
        loop, in weight chunks (``eng._weights`` of each graph's levels),
        at S 256: device ms from CUDA events (host gaps included)."""
        nlv = int(a.nlevels.max())
        packed = a.esrc.dim() == 3
        G = a.esrc.shape[0] if packed else 1
        cap = max(1, (1 << 26) // (G * a.esrc.shape[-1] * CURVE_POINTS))

        def weights():
            for lv0 in range(0, nlv, cap):
                sl = slice(lv0, min(nlv, lv0 + cap))
                for gi in range(G):
                    ix = (gi, sl) if packed else (sl,)
                    eng._weights(a.egclass[ix], a.egap[ix], a.econst[ix],
                                 a.elat[ix], LG[0][gi] if packed else LG[0],
                                 LG[1][gi] if packed else LG[1])
        return event_ms(weights)

    def timed(label, a, params, reps, before) -> dict:
        LG = grids(a, params, CURVE_POINTS)
        whole = [(0, int(a.nlevels.max()))]
        # the state to time on, filled by the kernel (held bit-equal to
        # the plain version above): a plain run of the packed plan takes
        # seconds
        st = run(segment_levels_f64, fresh(a, CURVE_POINTS, True), a, LG,
                 whole)
        plain_ms = event_ms(lambda: run(plain, st, a, LG, whole))
        ms = cuda_ms(lambda: run(segment_levels_f64, st, a, LG, whole),
                     reps=reps, warmup=2)
        ms_values = cuda_ms(lambda: run(segment_levels_f64,
                                        (st[0], None, None, None), a, LG,
                                        whole), reps=reps, warmup=2)
        w_ms = weights_ms(a, LG)
        b = bound(a, label)
        say(f"time segment_levels_f64 λ, {label} at S {CURVE_POINTS} (1 "
            f"launch, weights formed in it): kernel {ms:.6f} ms "
            f"({ms * 1e3 / b['levels']:.4f} us a level with a listed row), "
            f"values mode {ms_values:.6f} ms; plain {plain_ms:.6f} ms (CUDA "
            f"events, host gaps included); bound {b['bound_ms']:.6f} ms, "
            f"chain {b['chain_ms']:.6f} ms; before the kernel formed the "
            f"weights: its time then "
            f"{before} ms + the weights' elementwise {w_ms:.6f} ms = "
            f"{before + w_ms:.6f} ms ({ms / (before + w_ms):.4f}x); ptxas "
            f"{ptxas_of('segment_levels_f64_kernelILb0')}")
        return dict(b, ms=ms, ms_values=ms_values, plain_ms=plain_ms,
                    weights_ms=w_ms)

    # phase 4's plan; phase 7's packed plan; the tie-heavy and wide plans
    solo = eng.stage_segment(compile_plan(g, p), cuda)
    err = check("phase 4's plan", solo, p)
    err = max(err, check("phase 4's plan, split", solo, p,
                         widths=(CURVE_POINTS,), split=True))
    t4 = timed("phase 4's plan", solo, p, 10, SEG_MS_BEFORE["phase 4"])
    del solo
    packed = eng.stage_segment(pack_plans([compile_plan(v.graph, v.params)
                                           for v in variants]), cuda)
    G = packed.esrc.shape[0]
    err = max(err, check(f"the study's packed plan (G {G})", packed,
                         p_study))
    t7 = timed(f"the study's packed plan (G {G})", packed, p_study, 3,
               SEG_MS_BEFORE["packed"])
    del packed
    for name, gx in (("the tie-heavy plan", tie_graph(p_tie)),
                     ("the wide plan", wide_graph(p_tie))):
        px = compile_plan(gx, p_tie)
        ax = eng.stage_segment(px, cuda)
        lp, rp = ax.lv_ptr.cpu().numpy(), ax.row_ptr.cpu().numpy()
        qs = ax.in_edges[:, 2].cpu().numpy()
        rows = np.diff(rp[:lp[-1] + 1])
        dq = np.repeat(np.arange(rows.shape[0]), rows)
        back = lp[np.searchsorted(lp, dq, "right")] - qs[:dq.shape[0]]
        say(f"{name} (segment): {gx.num_vertices} vertices, "
            f"{gx.num_edges} edges, {px.nlevels} levels of up to "
            f"{np.diff(lp).max()} listed rows and "
            f"{np.diff(rp[lp]).max()} edges, {int((rows > 2).sum())} listed "
            f"rows of more than 2 in-edges (up to {rows.max()}), sources up "
            f"to {back.max()} listed rows back")
        err = max(err, check(name, ax, p_tie))
        del ax
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "segment_levels_f64", "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/sparse_levels.cu",
            "replaces": "src/repro/sweep/engine.py:222",
            "launches": None, "max_abs_err": err, "ms": t4["ms"],
            "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
            "bound_by": t4["bound_by"], "library_ms": None,
            "packed": {"ms": t7["ms"], "plain_ms": t7["plain_ms"],
                       "bound_ms": t7["bound_ms"],
                       "bound_by": t7["bound_by"], "library_ms": None}}


def flash_inputs(B, Tq, Tk, H, Hkv, d, dv, dtype, seed: int):
    """q [B, Tq, H, d], k [B, Tk, Hkv, d], v [B, Tk, Hkv, dv] on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Tq, H, d), (B, Tk, Hkv, d),
                               (B, Tk, Hkv, dv)))


def flat(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, d] → [B·H, T, d]."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]).contiguous()


def flash_route(fn, call):
    """(result, the route that served it) of ``call``, read from the flash
    wrapper's per-route counters around it."""
    before = dict(fn.route_launches)
    out = call()
    moved = [r for r in fn.route_launches if fn.route_launches[r] != before[r]]
    return out, "+".join(moved)


def phase_flash() -> list:
    """The flash-attention kernels (three routes) against their plain
    version, then the prefill and decode kernels' times at the decode and
    prefill shapes of both serve paths.  Returns the decode and prefill
    kernels' rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_flat,
                                                     flash_attention_ref)
    from repro_torch import configs
    # the hybrid path's attention layer (phase 9): its head counts and
    # head_dim at phase 8's decode and prefill lengths
    hyb = configs.get(HYBRID_ARCH)[0]
    heads = (hyb.n_heads, hyb.n_kv_heads, hyb.head_dim, hyb.head_dim)
    cases = ([("decode", *FLASH_DECODE, False, kv) for kv in (1, 97, 192)]
             + [("hybrid decode", *FLASH_DECODE[:3], *heads, False, kv)
                for kv in (1, 97, 192)]
             + [("prefill", *FLASH_PREFILL, True, None),
                ("hybrid prefill", *FLASH_PREFILL[:3], *heads, True, None),
                ("ragged", 2, 77, 77, 4, 2, 64, 64, True, None),
                ("ragged", 2, 100, 130, 4, 1, 64, 32, False, None),
                ("ragged", 1, 5, 300, 6, 6, 192, 128, False, 250),
                ("ragged", 1, 70, 70, 16, 4, 256, 256, True, None),
                ("kv_len=0", 2, 3, 50, 4, 2, 36, 20, False, 0),
                ("kv_len=0", 1, 128, 128, 2, 2, 128, 128, True, 0)]
             # each new route: ragged Tq off the 128-row q-tile, n_rep 1 /
             # 3 / 8, kv_len 0 / 1 / mid / full, Tq up to 16 at decode
             + [("prefill Tq", 2, 77, 77, 6, 2, 128, 128, True, None),
                ("prefill Tq", 1, 130, 300, 8, 1, 128, 128, False, 200),
                ("prefill Tq", 1, 4095, 4095, 8, 8, 128, 128, True, None),
                ("prefill kv", 1, 130, 130, 8, 8, 128, 128, True, 0),
                ("prefill kv", 1, 130, 130, 8, 1, 128, 128, False, 1),
                ("prefill kv", 1, 300, 300, 3, 1, 128, 128, True, 150),
                ("prefill d64", 2, 200, 200, 4, 2, 64, 64, False, None),
                ("decode n_rep", 4, 1, 192, 8, 8, 128, 128, False, 97),
                ("decode kv=0", *FLASH_DECODE, False, 0),
                ("decode kv=0", *FLASH_DECODE[:3], *heads, False, 0),
                ("decode Tq", 2, 16, 1000, 24, 8, 128, 128, False, 700),
                ("decode Tq", 1, 16, 16, 24, 8, 128, 128, True, None),
                ("decode long", 1, 1, 4096, 32, 1, 128, 128, False, 4000)])
    err: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, B, Tq, Tk, H, Hkv, d, dv, causal, kv) in \
                enumerate(cases):
            q, k, v = flash_inputs(B, Tq, Tk, H, Hkv, d, dv, dtype, seed=i)
            out, route = flash_route(flash_attention, lambda: flash_attention(
                q, k, v, causal=causal, kv_len=kv))
            out_flat = flash_attention_flat(flat(q), flat(k), flat(v),
                                            causal=causal, kv_len=kv)
            torch.cuda.synchronize()
            ref = flash_attention_ref(flat(q), flat(k), flat(v),
                                      causal=causal, kv_len=kv)
            ref = ref.reshape(B, H, Tq, dv).transpose(1, 2)
            e = float((out.float() - ref.float()).abs().max())
            same = torch.equal(out_flat.reshape(B, H, Tq, dv).transpose(1, 2),
                               out)
            say(f"check flash {label:14s} {str(dtype)[6:]:8s} B {B} Tq {Tq} "
                f"Tk {Tk} H {H}/{Hkv} d {d}/{dv} causal {causal} kv_len "
                f"{kv}: route {route}, max|out-plain| {e}, kernel layout "
                f"equal {same}")
            if e > FLASH_TOL[dtype] or not same:
                fail(f"flash kernel ({route}) differs from its plain version "
                     f"on {label} {dtype} (tolerance {FLASH_TOL[dtype]})")
            if kv == 0:
                mean = v.float().repeat_interleave(H // Hkv, dim=2) \
                    .mean(dim=1, keepdim=True)
                if float((out.float() - mean).abs().max()) > FLASH_TOL[dtype]:
                    fail("flash kernel: kv_len = 0 must average all values")
            err[route] = max(err.get(route, 0.0), e)
    say(f"flash max|out-plain| by route: {err}")
    if set(err) != {"prefill", "decode", "simple"}:
        fail(f"flash checks reached routes {sorted(err)}, not all three")

    timed = {}
    for label, shape, causal, reps in (
            ("decode", FLASH_DECODE, False, 500),
            ("prefill", FLASH_PREFILL, True, 20),
            ("hybrid decode", (*FLASH_DECODE[:3], *heads), False, 500),
            ("hybrid prefill", (*FLASH_PREFILL[:3], *heads), True, 10)):
        B, Tq, Tk, H, Hkv, d, dv = shape
        q, k, v = flash_inputs(B, Tq, Tk, H, Hkv, d, dv, torch.bfloat16,
                               seed=99)
        qf, kf, vf = flat(q), flat(k), flat(v)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        _, route = flash_route(flash_attention, lambda: flash_attention(
            q, k, v, causal=causal))
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                     reps=reps, warmup=3)
        plain_ms = cuda_ms(lambda: flash_attention_ref(qf, kf, vf,
                                                       causal=causal),
                           reps=min(reps, 20), warmup=3)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=reps,
            warmup=3)
        # every key live at decode (kv_len = Tk); the causal half at prefill
        pairs = B * H * (Tq * (Tq + 1) // 2 if causal else Tq * Tk)
        ops = 2.0 * pairs * (d + dv)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * Tq * H * dv)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_OPS_PER_S * 1e3
        timed[label] = {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes > t_ops
                        else "operations", "library_ms": library_ms}
        say(f"time flash_attention {label} ({route} route) B {B} Tq {Tq} Tk "
            f"{Tk} H {H}/{Hkv} d {d} bf16: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, library (scaled_dot_product_attention) "
            f"{library_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
            f"({timed[label]['bound_by']}: {nbytes} B, {ops:.0f} ops)")
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    return [{"name": f"flash_attention_{kind}", "route": "cuda",
             "source": f"{src}flash_{kind}.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
             "launches": None, "max_abs_err": err[kind], **timed[kind],
             "hybrid": timed[f"hybrid {kind}"]}
            for kind in ("decode", "prefill")]


def scan_inputs(B, T, D, S, dtype, seed: int):
    """a ∈ [0.5, 0.99), b ~ 0.1·N(0, 1), c ~ N(0, 1) in ``dtype`` and h0 ~
    N(0, 1) float32 on the card (``tests/test_kernels.py``'s
    distributions)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.empty((B, T, D, S), device="cuda").uniform_(0.5, 0.99,
                                                          generator=g)
    b = torch.randn((B, T, D, S), generator=g, device="cuda") * 0.1
    c = torch.randn((B, T, S), generator=g, device="cuda")
    h0 = torch.randn((B, D, S), generator=g, device="cuda")
    return a.to(dtype), b.to(dtype), c.to(dtype), h0


def phase_scan() -> dict:
    """The linear-scan kernel against its plain version, then its times at
    the Mamba decode and prefill shapes of the hybrid serve path."""
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
    cases = [("decode", *SCAN_DECODE), ("prefill", *SCAN_PREFILL),
             ("ragged", 2, 77, 100, 8), ("ragged", 1, 5, 64, 4),
             ("ragged", 3, 130, 33, 1), ("ragged", 1, 129, 31, 32)]
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, B, T, D, S) in enumerate(cases):
            a, b, c, h0 = scan_inputs(B, T, D, S, dtype, seed=i)
            y, h = linear_scan(a, b, c, h0)
            torch.cuda.synchronize()
            yr, hr = linear_scan_ref(a, b, c, h0)
            ey = float((y.float() - yr.float()).abs().max())
            eh = float((h - hr).abs().max())
            say(f"check linear_scan {label:7s} {str(dtype)[6:]:8s} B {B} T "
                f"{T} D {D} S {S}: max|y-plain| {ey}, max|h-plain| {eh}, "
                f"y {y.dtype}, h {h.dtype}")
            if (max(ey, eh) > SCAN_TOL[dtype] or y.dtype != dtype
                    or h.dtype != torch.float32):
                fail(f"linear-scan kernel differs from its plain version on "
                     f"{label} {dtype} (tolerance {SCAN_TOL[dtype]})")
            err = max(err, ey, eh)
            del a, b, c, h0, y, h, yr, hr

    timed = {}
    for label, (B, T, D, S), reps in (("decode", SCAN_DECODE, 500),
                                      ("prefill", SCAN_PREFILL, 20)):
        # float32: the dtype of a, b·x and C in the Mamba block
        a, b, c, h0 = scan_inputs(B, T, D, S, torch.float32, seed=99)
        ms = cuda_ms(lambda: linear_scan(a, b, c, h0), reps=reps, warmup=3)
        if T == 1:
            plain_ms = cuda_ms(lambda: linear_scan_ref(a, b, c, h0), reps=20,
                               warmup=3)
        else:   # ~5 launches a step: T of them overflow the launch queue
            plain_ms = event_ms(lambda: linear_scan_ref(a, b, c, h0))
        nbytes = 4 * (2 * a.numel() + c.numel() + 2 * h0.numel() + B * T * D)
        ops = 3.0 * a.numel()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        timed[label] = {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes > t_ops
                        else "operations", "library_ms": None}
        say(f"time linear_scan {label} B {B} T {T} D {D} S {S} float32: "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms"
            f"{' (events, host gaps included)' if T > 1 else ''}, bound "
            f"{max(t_bytes, t_ops):.6f} ms ({timed[label]['bound_by']}: "
            f"{nbytes} B, {ops:.0f} ops), library none (no PyTorch call "
            "computes a linear recurrence)")
        del a, b, c, h0
    return {"name": "linear_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/linear_scan/csrc/"
                      "linear_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:53",
            "launches": None, "max_abs_err": err, **timed["decode"],
            "prefill": timed["prefill"]}


def mamba_inputs(B, T, Di, S, dtype, seed: int):
    """(x, dt, A, Bm, Cm, D, h0) on the card, as the card test makes them:
    Δ = softplus(N(0, 1)), A = −(1..S) on every channel, x, B, C, D, h0 ~
    N(0, 1); x, B and C in ``dtype``, B and C the strided views of one
    [B, T, 2·S + 8] projection, as the Mamba block passes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, T, Di), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, Di), generator=g, device="cuda"))
    A = -torch.arange(1, S + 1, dtype=torch.float32,
                      device="cuda").expand(Di, S).contiguous()
    bc = torch.randn((B, T, 2 * S + 8), generator=g, device="cuda").to(dtype)
    Bm, Cm, _ = bc.split([S, S, 8], dim=-1)
    D = torch.randn(Di, generator=g, device="cuda")
    h0 = torch.randn((B, Di, S), generator=g, device="cuda")
    return x, dt, A, Bm, Cm, D, h0


def mamba_y_err(y: torch.Tensor, yr: torch.Tensor) -> float:
    """The largest |y − y_plain| beyond one bfloat16 step of the value (0
    when every y is within it; float32 as it is)."""
    e = (y.float() - yr.float()).abs()
    if y.dtype == torch.bfloat16:
        mag = torch.maximum(y.float().abs(), yr.float().abs())
        step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2 ** -126)))
                          - 7)
        e = torch.where(e <= step, torch.zeros_like(e), e)
    return float(e.max())


def sass_counts(lib_path) -> dict:
    """Static MUFU.EX2 and instruction counts of each kernel in a built
    library, from ``cuobjdump -sass``, and those of the innermost loop
    that holds a MUFU.EX2 (the smallest span from a backward branch's
    target to the branch): its instructions over its MUFU.EX2 are the
    instructions an element where each element takes one expf."""
    import re
    from repro_torch.kernels import build
    tool = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300).stdout
    code: dict = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            code[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if cur and m:
            code[cur].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for kernel, ins in code.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                n = sum("MUFU.EX2" in t for t in body)
                if n:
                    loops.append((len(body), n))
        out[kernel] = {"MUFU.EX2": sum("MUFU.EX2" in t for _, t in ins),
                       "instructions": len(ins),
                       "loop": min(loops) if loops else None}
    return out


def mamba_bound(B, T, Di, S, dtype) -> dict:
    """The least time the card could take for one call, by its three
    limits: bytes (dt, x, B, C, A, Dskip and h0 read once, y and h written
    once), expf over the special-function unit, float32 operations."""
    e = torch.tensor([], dtype=dtype).element_size()
    N = B * T * Di
    nbytes = (4 * N + e * N + 2 * e * B * T * S + 4 * Di * S + 4 * Di
              + 2 * 4 * B * Di * S + e * N)
    n_exp = N * S
    # per (b, t, d, s): dt·A, (dt·x)·B, a·h, + b·x, h·C and its sum; per
    # (b, t, d): dt·x, x·D and the skip's add
    flops = 6 * N * S + 3 * N
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "expf": n_exp / SFU_OPS_PER_S * 1e3,
             "flops": flops / FP32_OPS_PER_S * 1e3}
    by = max(parts, key=parts.get)
    return {"bound_ms": parts[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_parts_ms": parts, "bound_limit": by,
            "counts": {"bytes": nbytes, "expf": n_exp, "flops": flops}}


def phase_mamba_scan() -> dict:
    """The Mamba-scan kernel: its decay alone against torch.exp, then each
    schedule against the plain version on every case in both types (h bit
    for bit, y within MAMBA_TOL), the peak-memory rise of one prefill call,
    the SASS's MUFU.EX2 counts, both schedules' times over short T, and
    its and the plain version's times at the decode and prefill shapes of
    the hybrid serve path beside the bound."""
    from repro_torch.kernels import build
    from repro_torch.kernels.linear_scan import (mamba_decay, mamba_scan,
                                                 mamba_scan_ref)
    from repro_torch.kernels.linear_scan.ops import DECODE_MAX_T

    # expf against torch.exp on every dt·A the check shapes produce
    n_a = n_diff = max_ulp = 0
    for i, (label, B, T, Di, S) in enumerate(MAMBA_CASES):
        _, dt, A, *_ = mamba_inputs(B, T, Di, S, torch.float32, seed=i)
        for t0 in range(0, T, 256):        # [.., 256, Di, S] at a time
            d = dt[:, t0:t0 + 256].contiguous()
            a, ar = mamba_decay(d, A), torch.exp(d[..., None] * A)
            ulp = (a.view(torch.int32).long()
                   - ar.view(torch.int32).long()).abs()
            n_a += a.numel()
            n_diff += int((ulp != 0).sum())
            max_ulp = max(max_ulp, int(ulp.max()))
            del a, ar, ulp
    say(f"check mamba decay: expf(dt·A) against torch.exp on {n_a} "
        f"elements: {n_diff} differ, by at most {max_ulp} ulp")
    h_bit_equal = n_diff == 0

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, B, T, Di, S) in enumerate(MAMBA_CASES):
            t = mamba_inputs(B, T, Di, S, dtype, seed=i)
            yr, hr = mamba_scan_ref(*t)
            for schedule in ("decode", "prefill"):
                y, h = mamba_scan(*t, schedule=schedule)
                torch.cuda.synchronize()
                ey = mamba_y_err(y, yr)
                raw = float((y.float() - yr.float()).abs().max())
                if h_bit_equal:
                    eh_ok = torch.equal(h, hr)
                    eh = "bit-equal" if eh_ok else float((h - hr).abs().max())
                else:   # the declared expf clause: within 1e-6 relative
                    rel = float(((h - hr).abs() / hr.abs().clamp_min(
                        1e-30)).max())
                    eh_ok, eh = rel <= 1e-6, f"rel {rel}"
                say(f"check mamba_scan {label:7s} {str(dtype)[6:]:8s} "
                    f"{schedule:7s} B {B} T {T} Di {Di} S {S}: h {eh}, "
                    f"max|y-plain| {raw} ({ey} beyond one bf16 step), y "
                    f"{y.dtype}")
                if not eh_ok or ey > MAMBA_TOL[dtype] or y.dtype != dtype \
                        or h.dtype != torch.float32:
                    fail(f"mamba_scan differs from its plain version on "
                         f"{label} {dtype} {schedule}")
                err = max(err, raw)
                del y, h
            del t, yr, hr

    # one prefill call allocates y and h and nothing of size [T, Di, S]
    t = mamba_inputs(*MAMBA_CASES[1][1:], torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y, h = mamba_scan(*t)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    limit = y.numel() * y.element_size() + h.numel() * 4 + 2 ** 20
    say(f"mamba_scan prefill peak-memory rise {rise} B (y + h + 1 MiB = "
        f"{limit} B; a and b·x would be {2 * 4 * y.numel() * h.shape[-1]} B)")
    if rise > limit:
        fail(f"mamba_scan's prefill call allocated {rise} B > {limit} B")
    del t, y, h

    lib = build.build_all(["mamba_scan"])["mamba_scan"]
    for kernel, c in sass_counts(lib.path).items():
        short = next((k for k in ("mamba_scan_prefill", "mamba_scan_decode",
                                  "mamba_decay_kernel") if k in kernel), None)
        if short and ("bfloat16Li4ELb1" in kernel or "decay" in kernel):
            loop = (f"; its innermost expf loop {c['loop'][0]} instructions "
                    f"for {c['loop'][1]} MUFU.EX2, "
                    f"{c['loop'][0] / c['loop'][1]:.2f} an element"
                    if c["loop"] else "")
            say(f"sass {short} (bf16, S 9-16, 16-byte rows where templated): "
                f"{c['MUFU.EX2']} MUFU.EX2 in {c['instructions']} "
                f"instructions{loop}")

    for B in (1, 4):        # the schedules over short T: DECODE_MAX_T
        for T in (1, 2, 4, 8, 16, 32, 64):
            t = mamba_inputs(B, T, 16384, 16, torch.bfloat16, seed=T)
            got = {s: cuda_ms(lambda: mamba_scan(*t, schedule=s), reps=200,
                              warmup=3) for s in ("decode", "prefill")}
            say(f"time mamba_scan schedules B {B} T {T} Di 16384 S 16 bf16: "
                f"decode {got['decode']:.6f} ms, prefill "
                f"{got['prefill']:.6f} ms (auto: "
                f"{'decode' if T <= DECODE_MAX_T else 'prefill'})")
            del t

    timed = {}
    for label, B, T, Di, S in MAMBA_CASES[:2]:
        # bfloat16: x, B, C and y in the model's dtype on the serve path
        t = mamba_inputs(B, T, Di, S, torch.bfloat16, seed=99)
        ms = cuda_ms(lambda: mamba_scan(*t), reps=500 if T == 1 else 20,
                     warmup=3)
        if T == 1:
            plain_ms = cuda_ms(lambda: mamba_scan_ref(*t), reps=20, warmup=3)
        else:   # ~5 launches a step: T of them overflow the launch queue
            plain_ms = event_ms(lambda: mamba_scan_ref(*t))
        bound = mamba_bound(B, T, Di, S, torch.bfloat16)
        parts = bound.pop("bound_parts_ms")
        counts = bound.pop("counts")
        timed[label] = {"ms": ms, "plain_ms": plain_ms, **bound,
                        "library_ms": None}
        say(f"time mamba_scan {label} B {B} T {T} Di {Di} S {S} bf16: "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms"
            f"{' (events, host gaps included)' if T > 1 else ''}, bound "
            f"{bound['bound_ms']:.6f} ms ({bound['bound_limit']}; bytes "
            f"{parts['bytes']:.6f} ms for {counts['bytes']} B, expf "
            f"{parts['expf']:.6f} ms for {counts['expf']}, flops "
            f"{parts['flops']:.6f} ms for {counts['flops']}), "
            f"{100 * bound['bound_ms'] / ms:.1f} % of it; library none (no "
            "PyTorch call computes a linear recurrence)")
        del t
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/linear_scan/csrc/"
                      "mamba_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:53",
            "launches": None, "max_abs_err": err, **timed["decode"],
            "prefill": timed["prefill"]}


# -- phase 4 -----------------------------------------------------------------

def stencil():
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    p = cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(16, 16, 10, halo_bytes=64e3, comp_us=500.0, params=p)
    return g, p


def phase_main(g, p, rows: list, dense_row: dict, walk_row: dict) -> dict:
    """Phase 4 on the dense backend, named: the default is segment (``rows``:
    the dense mat-vecs' rows, whose main-path launches are now 0; the
    level-loop and walk rows gain this phase's)."""
    from repro_torch.core import sensitivity
    from repro_torch.kernels.maxplus import (dense_levels_f32,
                                             maxplus_matvec,
                                             maxplus_matvec_argmax,
                                             sparse_backtrace)
    from repro_torch.sweep import Engine, ExecPolicy, compile_plan, latency_grid
    from repro_torch.sweep.engine import dense_forward

    dense = ExecPolicy("dense")
    plan = compile_plan(g, p)
    say(f"graph: {g.num_vertices} vertices, {g.num_edges} edges, "
        f"{g.nlevels} levels -> nlv_p {plan.nlv_p}, Vmax {plan.Vmax}, "
        f"Emax {plan.Emax}, indicator {plan.nlv_p * plan.Vmax * plan.Emax * 4 >> 20} "
        f"MiB, dense footprint {plan.dense_bytes() >> 20} MiB")
    deltas = np.linspace(0.0, 100.0, CURVE_POINTS)

    counted = (maxplus_matvec, maxplus_matvec_argmax, dense_levels_f32,
               sparse_backtrace)
    for k in counted:
        k.launches = 0
    dense_forward.runs.clear()
    torch.cuda.reset_peak_memory_stats()
    curve, t_curve = wall(lambda: sensitivity.latency_curve(g, p, deltas,
                                                           policy=dense))
    tol, t_tol = wall(lambda: sensitivity.latency_tolerance(
        g, p, (0.01, 0.02, 0.05), policy=dense))
    eng, t_stage = wall(lambda: Engine(g, params=p, policy=dense))
    batch = latency_grid(p, deltas)
    vals, t_vals = wall(lambda: eng.run(batch, compute_lam=False))
    _, t_lam = wall(lambda: eng.run(batch))
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in counted}
    runs = dict(dense_forward.runs)

    say(f"T(dL=0) = {curve.T[0]!r} us, lambda_L = {curve.lam[0]!r}, "
        f"rho_L = {curve.rho[0]!r}")
    say(f"tolerance: {tol}")
    say(f"wall: latency_curve {t_curve:.4f} s ({CURVE_POINTS} points, λ), "
        f"latency_tolerance {t_tol:.4f} s, Engine() {t_stage:.4f} s, "
        f"values-only run {t_vals:.4f} s, λ run {t_lam:.4f} s")
    say(f"peak device memory: {peak} B ({peak / 2**20:.1f} MiB)")
    say(f"forwards: {runs}; launches: {launches}; nlv_p {plan.nlv_p}")
    # the launch structure since the level loop moved into one kernel: one
    # level-loop launch a forward (its float32 maxima, argmax and float64
    # remainder included), one walk a λ forward, no launch of the dense
    # mat-vecs
    want = {"maxplus_matvec": 0, "maxplus_matvec_argmax": 0,
            "dense_levels_f32": runs.get("values", 0) + runs.get("lam", 0),
            "sparse_backtrace": runs.get("lam", 0)}
    if launches != want or min(runs.get("values", 0),
                               runs.get("lam", 0)) <= 0:
        fail(f"launch counts {launches} != one level loop a forward, one "
             f"walk a λ forward, no mat-vec: {want}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    add_launches(dense_row, launches["dense_levels_f32"])
    add_launches(walk_row, launches["sparse_backtrace"])

    T, lam = curve.T, curve.lam
    if T.shape != (CURVE_POINTS,) or lam.shape != (CURVE_POINTS,):
        fail(f"curve shapes {T.shape} {lam.shape}")
    if not (np.isfinite(T).all() and np.isfinite(lam).all()):
        fail("non-finite curve values")
    if not (np.diff(T) > 0).all():
        fail("T(ΔL) does not increase with ΔL")
    if not ((lam >= 1) & (lam == np.round(lam))).all():
        fail("λ_L must count critical-path messages: a positive integer")
    if not np.array_equal(vals.T, T):
        fail("values-only T differs from the λ run's T")
    tv = [tol[k] for k in (0.01, 0.02, 0.05)]
    if not (0 < tv[0] < tv[1] < tv[2] < np.inf):
        fail(f"tolerances not increasing: {tol}")

    for label, lam_run in (("values-only", False), ("λ", True)):
        profile_forward(label, lambda: eng.run(batch, compute_lam=lam_run),
                        focus=("dense_levels", "sparse_backtrace"))
    return {"deltas": deltas, "T": T, "lam": lam, "tol": tol}


def segment_launches(label: str, counters: dict, fwd,
                     walks_a_forward: int, seg_row: dict,
                     walk_row: dict) -> dict:
    """The launch structure of the segment forwards run since the counters
    (``counters``: name → kernel) and ``fwd``'s ``runs`` were cleared: one
    ``segment_levels_f64`` launch a forward (since the kernel forms the
    weights itself; one a weight chunk before), ``walks_a_forward`` walks a
    λ forward, no other level loop; the rows gain the launches."""
    launches = {name: k.launches for name, k in counters.items()}
    runs = dict(fwd.runs)
    want = {name: 0 for name in counters}
    want["segment_levels_f64"] = sum(runs.values())
    want["sparse_backtrace"] = walks_a_forward * runs.get("lam", 0)
    say(f"{label}: forwards {runs}; launches {launches}")
    if launches != want or min(runs.get("values", 0),
                               runs.get("lam", 0)) <= 0:
        fail(f"{label}: launches {launches} != one segment level loop a "
             f"forward and {walks_a_forward} walk(s) a λ forward: {want}")
    add_launches(seg_row, launches["segment_levels_f64"])
    add_launches(walk_row, launches["sparse_backtrace"])
    return launches


def phase_main_segment(g, p, card: dict, seg_row: dict,
                       walk_row: dict) -> None:
    """Phase 4 on the segment backend: the 256-point curve with λ, the
    1/2/5 % tolerances, a values and a λ forward on a staged engine; T, λ
    and ρ bit-equal to the sparse float64 forward at 4 points and T within
    1e-5 of the numpy longest path; one ``segment_levels_f64`` launch a
    forward and one walk a λ forward, no per-level kernels in a profile;
    walls and peak memory."""
    from repro_torch.core import sensitivity
    from repro_torch.kernels import maxplus
    from repro_torch.sweep import Engine, ExecPolicy, latency_grid
    from repro_torch.sweep.engine import segment_forward

    seg = ExecPolicy(backend="segment")
    deltas = card["deltas"]
    counters = {n: getattr(maxplus, n) for n in (
        "segment_levels_f64", "sparse_backtrace", "dense_levels_f32",
        "sparse_levels_f64", "sparse_levels_f32")}
    for k in counters.values():
        k.launches = 0
    segment_forward.runs.clear()
    torch.cuda.reset_peak_memory_stats()
    curve, t_curve = wall(lambda: sensitivity.latency_curve(g, p, deltas,
                                                           policy=seg))
    tol, t_tol = wall(lambda: sensitivity.latency_tolerance(
        g, p, (0.01, 0.02, 0.05), policy=seg))
    eng, t_stage = wall(lambda: Engine(g, params=p, policy=seg))
    batch = latency_grid(p, deltas)
    vals, t_vals = wall(lambda: eng.run(batch, compute_lam=False))
    res, t_lam = wall(lambda: eng.run(batch))
    peak = torch.cuda.max_memory_allocated()
    segment_launches("segment (phase 4)", counters, segment_forward, 1,
                     seg_row, walk_row)
    say(f"segment: T(dL=0) = {res.T[0]!r} us, lambda_L = {res.lam[0, 0]!r}; "
        f"tolerance {tol} (dense float32: {card['tol']})")
    say(f"segment wall: latency_curve {t_curve:.4f} s ({CURVE_POINTS} "
        f"points, λ), latency_tolerance {t_tol:.4f} s, Engine() "
        f"{t_stage:.4f} s, values-only run {t_vals:.4f} s, λ run "
        f"{t_lam:.4f} s; peak device memory {peak} B "
        f"({peak / 2**20:.1f} MiB)")
    if res.backend != "segment" or not (
            np.array_equal(curve.T, res.T) and np.array_equal(vals.T, res.T)
            and np.array_equal(curve.lam, res.lam[:, 0])):
        fail("segment: the curve, the values and the λ runs differ")
    if not (np.isfinite(res.T).all() and (np.diff(res.T) > 0).all()
            and ((res.lam >= 1) & (res.lam == np.round(res.lam))).all()):
        fail("segment: T must rise with ΔL, λ_L count messages")
    tv = [tol[k] for k in (0.01, 0.02, 0.05)]
    if not (0 < tv[0] < tv[1] < tv[2] < np.inf):
        fail(f"segment tolerances not increasing: {tol}")
    rel = np.abs(res.T - card["T"]) / res.T
    say(f"segment vs dense float32 over the curve: max |dT| / T "
        f"{rel.max()!r}, λ equal {np.array_equal(res.lam[:, 0], card['lam'])}")
    if rel.max() > 1e-5:
        fail("dense float32 T is off the segment forward by > 1e-5")

    pick = np.linspace(0, CURVE_POINTS - 1, SPARSE_POINTS).astype(int)
    sub = latency_grid(p, deltas[pick])
    r64 = Engine(g, params=p,
                 policy=ExecPolicy(backend="sparse", dtype="float64")).run(sub)
    ref = numpy_makespan(g, p, deltas[pick])
    e_np = np.abs(res.T[pick] - ref) / ref
    same = [np.array_equal(getattr(res, f)[pick], getattr(r64, f))
            for f in ("T", "lam", "rho")]
    say(f"segment at {SPARSE_POINTS} points vs sparse float64: T / λ / ρ "
        f"bit-equal {same}; vs numpy float64 longest path: max |dT| / T "
        f"{e_np.max()!r}")
    if not all(same):
        fail("segment differs from the sparse float64 forward")
    if e_np.max() > 1e-5:
        fail("segment T is off the numpy longest path by > 1e-5")

    for label, lam_run in (("values-only", False), ("λ", True)):
        prof = {}
        profile_forward(f"segment {label}",
                        lambda: eng.run(batch, compute_lam=lam_run),
                        focus=("segment_levels", "sparse_backtrace"),
                        stats=prof)
        # nothing a level: a forward's kernels do not grow with its levels
        if prof and prof["kernels"] > F64_FORWARD_KERNELS:
            fail(f"a segment {label} forward launched {prof['kernels']} "
                 f"kernels, more than {F64_FORWARD_KERNELS}")


def profile_forward(label: str, fn, focus=(), stats=None):
    """One forward under the profiler: its wall, the device's busy time
    (the sum of the device activities' durations), the kernels that took
    most of it, and the share of the kernels whose name contains each
    string of ``focus``.  Returns the busy time in ns (None when the
    profiler recorded none); ``stats``, a dict, gains the busy time and
    the count of device activities as "busy_ns" and "kernels".  The
    profiler's raw events are summed directly: building
    ``key_averages()`` over the ~10^6 events of a sparse or packed forward
    takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = wall(fn)
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, ns + e.duration_ns())
    dev_ns = sum(ns for _, ns in by_name.values())
    if dev_ns <= 0:
        say(f"profile ({label} forward): no device time recorded "
            "(not measured)")
        return None
    if stats is not None:
        stats.update(busy_ns=dev_ns,
                     kernels=sum(n for n, _ in by_name.values()))
    say(f"profile ({label} forward): wall {secs * 1e3:.3f} ms, device busy "
        f"{dev_ns / 1e6:.3f} ms ({100 * dev_ns / 1e9 / secs:.1f} %), "
        f"{sum(n for n, _ in by_name.values())} kernels")
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    for name, (n, ns) in top[:6]:
        say(f"  {name[:60]:60s} {n:6d} calls {ns / 1e6:.3f} ms")
    for f in focus:
        mine = [v for k, v in by_name.items() if f in k]
        ns = sum(v[1] for v in mine)
        say(f"  {f}: {sum(v[0] for v in mine)} launches, "
            f"{ns / 1e6:.3f} ms, {100 * ns / dev_ns:.1f} % of device busy")
    return dev_ns


# -- phase 5 -----------------------------------------------------------------

def numpy_makespan(g, p, deltas, store=np.float64) -> np.ndarray:
    """Independent float64 longest path per ΔL on class 0: level by level,
    t_start[v] = max over in-edges (t_end[u] + w), t_end = t_start + cost,
    with t_end stored in ``store`` after every level (float32: as the
    reference's float32 sparse flavour stores end times)."""
    L = np.tile(np.asarray(p.L, dtype=np.float64), (len(deltas), 1))
    L[:, 0] += deltas
    w = g.econst[:, None] + g.elat.astype(np.float64) @ L.T      # [ne, S]
    t_end = np.zeros((g.num_vertices, len(deltas)), dtype=store)
    lvl_e = g.level[g.edst]
    eord = np.argsort(lvl_e, kind="stable")
    eptr = np.searchsorted(lvl_e[eord], np.arange(g.nlevels + 1))
    vord = np.argsort(g.level, kind="stable")
    vptr = np.searchsorted(g.level[vord], np.arange(g.nlevels + 1))
    pos = np.empty(g.num_vertices, dtype=np.int64)   # index within its level
    pos[vord] = np.arange(g.num_vertices) - vptr[g.level[vord]]
    for lv in range(g.nlevels):
        e = eord[eptr[lv]:eptr[lv + 1]]
        v = vord[vptr[lv]:vptr[lv + 1]]
        t_start = np.zeros((v.shape[0], len(deltas)))
        np.maximum.at(t_start, pos[g.edst[e]], t_end[g.esrc[e]] + w[e])
        t_end[v] = t_start + g.vcost[v][:, None]
    return t_end.max(axis=0).astype(np.float64)


def phase_cpu(g, p, card: dict) -> None:
    from repro_torch.core import sensitivity
    from repro_torch.sweep import ExecPolicy
    sub = card["deltas"][::CPU_EVERY]
    t0 = time.perf_counter()
    cpu = sensitivity.latency_curve(g, p, sub, device="cpu",
                                    policy=ExecPolicy("dense"))
    t_cpu = time.perf_counter() - t0
    T_card = card["T"][::CPU_EVERY]
    lam_card = card["lam"][::CPU_EVERY]
    rel = np.abs(cpu.T - T_card) / T_card
    say(f"cpu: {len(sub)} points in {t_cpu:.2f} s; max |T_cpu - T_card| / T "
        f"= {rel.max()!r}; lambda equal: {np.array_equal(cpu.lam, lam_card)}")
    if rel.max() > 1e-6 or not np.array_equal(cpu.lam, lam_card):
        fail("the card's curve differs from the plain versions' on the CPU")
    ref = numpy_makespan(g, p, sub)
    rel64 = np.abs(T_card - ref) / ref
    say(f"float64 numpy longest path: max |T_card - T64| / T64 = "
        f"{rel64.max()!r}")
    if rel64.max() > 1e-5:
        fail("the card's T is off the float64 longest path by > 1e-5")


# -- phase 6 -----------------------------------------------------------------

def phase_sparse(g, p, sp, t_graph: float, slot_row: dict,
                 level_rows: list, f64_row: dict) -> None:
    """Phase 6 on the sparse stencil; fills the launches of the slot-list
    row (none: the main path no longer calls it) and of the level-loop
    rows (float32 and float64) and the walk row."""
    import warnings
    from repro_torch.core import sensitivity
    from repro_torch.kernels.maxplus import (maxplus_slotlist_argmax,
                                             sparse_backtrace,
                                             sparse_levels_f32,
                                             sparse_levels_f64)
    from repro_torch.sweep import (Engine, ExecPolicy, estimate_dense_bytes,
                                   latency_grid)
    from repro_torch.sweep.engine import (sparse_forward_f32,
                                          sparse_forward_f64, weight_chunks)

    f32 = ExecPolicy(backend="sparse", dtype="float32")
    px, py, iters = SPARSE_STENCIL
    say(f"sparse graph: {px * py} ranks x {iters} iterations, "
        f"{g.num_vertices} vertices, {g.num_edges} edges, {g.nlevels} "
        f"levels -> nlv_p {sp.nlv_p}, Emax_lv {sp.Emax_lv}, Vmax_lv "
        f"{sp.Vmax_lv}, nv_p {sp.vcost.shape[0]}, ne_p "
        f"{sp.esrc_slot.shape[0]}; dense envelope "
        f"{estimate_dense_bytes(g) >> 20} MiB, slot lists "
        f"{sp.sparse_bytes() >> 20} MiB; built in {t_graph:.2f} s")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng64, t_auto = wall(lambda: Engine(g, params=p))
    auto = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)
            and "auto-switching" in str(w.message)]
    say(f"default Engine(): backend {eng64.policy.backend!r}, dtype "
        f"{eng64.arrays.dtype}, {t_auto:.4f} s; warning: {auto}")
    if not auto or eng64.policy.backend != "sparse" \
            or eng64.arrays.dtype != torch.float64:
        fail("the default Engine did not warn and switch to sparse float64")

    # the main path: the float32 flavour through the user's entry points
    deltas = np.linspace(0.0, 100.0, CURVE_POINTS)
    maxplus_slotlist_argmax.launches = 0
    sparse_levels_f32.launches = 0
    sparse_backtrace.launches = 0
    sparse_forward_f32.runs.clear()
    sparse_forward_f32.widths.clear()
    torch.cuda.reset_peak_memory_stats()
    curve, t_curve = wall(lambda: sensitivity.latency_curve(
        g, p, deltas, policy=f32))
    eng32, t_stage = wall(lambda: Engine(g, params=p, policy=f32))
    batch = latency_grid(p, deltas)
    vals, t_vals = wall(lambda: eng32.run(batch, compute_lam=False))
    _, t_lam = wall(lambda: eng32.run(batch))
    n_curve = sparse_forward_f32.runs["lam"]
    tol, t_tol = wall(lambda: sensitivity.latency_tolerance(
        g, p, (0.01, 0.02, 0.05), policy=f32))
    peak = torch.cuda.max_memory_allocated()
    launches = {"sparse_levels_f32": sparse_levels_f32.launches,
                "sparse_backtrace": sparse_backtrace.launches,
                "maxplus_slotlist_argmax": maxplus_slotlist_argmax.launches}
    runs = dict(sparse_forward_f32.runs)
    widths = dict(sparse_forward_f32.widths)
    n_tol = runs.get("lam", 0) - n_curve
    say(f"sparse T(dL=0) = {curve.T[0]!r} us, lambda_L = {curve.lam[0]!r}")
    say(f"sparse tolerance: {tol} ({n_tol} λ forwards)")
    say(f"sparse wall: latency_curve {t_curve:.4f} s ({CURVE_POINTS} "
        f"points, λ, float32), Engine() {t_stage:.4f} s, values-only run "
        f"{t_vals:.4f} s, λ run {t_lam:.4f} s, latency_tolerance "
        f"{t_tol:.4f} s")
    say(f"sparse peak device memory: {peak} B ({peak / 2**20:.1f} MiB)")
    check_peak("sparse", peak, 4 * sp.vcost.shape[0] * CURVE_POINTS)
    # the launch structure since the level loop moved into one kernel: one
    # level-loop launch per weight chunk of each forward (the chunks depend
    # on the forward's width S), one walk per λ forward, and no launch of
    # the standalone slot-list kernel
    chunks = {S: len(weight_chunks(eng32.arrays.level_ptr, sp.Emax_lv, S,
                                   sp.nlevels)) for S in widths}
    want = {"sparse_levels_f32": sum(n * chunks[S]
                                     for S, n in widths.items()),
            "sparse_backtrace": runs.get("lam", 0),
            "maxplus_slotlist_argmax": 0}
    say(f"sparse forwards: {runs}, by width S {widths}; weight chunks by "
        f"S {chunks}; launches: {launches}; nlevels {sp.nlevels}")
    if launches != want or min(want["sparse_levels_f32"],
                               want["sparse_backtrace"]) <= 0:
        fail(f"sparse launches {launches} != chunks x forwards, one walk a "
             f"λ forward, no slot-list launch: {want}")
    slot_row["launches"] = launches["maxplus_slotlist_argmax"]
    for row in level_rows:
        add_launches(row, launches[row["name"]])

    T, lam = curve.T, curve.lam
    if T.shape != (CURVE_POINTS,) or not np.isfinite(T).all() \
            or not np.isfinite(lam).all():
        fail("sparse curve: wrong shape or non-finite values")
    if not (np.diff(T) > 0).all():
        fail("sparse T(ΔL) does not increase with ΔL")
    if not ((lam >= 1) & (lam == np.round(lam))).all():
        fail("sparse λ_L must count critical-path messages")
    rel_v = np.abs(vals.T - T) / T
    say(f"sparse values-only vs λ run: max |dT| / T = {rel_v.max()!r}")
    tv = [tol[k] for k in (0.01, 0.02, 0.05)]
    if not (0 < tv[0] < tv[1] < tv[2] < np.inf):
        fail(f"sparse tolerances not increasing: {tol}")

    # the float64 flavour, an independent float64 longest path, and the
    # float32 flavour's plain kernel on the CPU, at a few of the points
    pick = np.linspace(0, CURVE_POINTS - 1, SPARSE_POINTS).astype(int)
    sub = deltas[pick]
    sub_batch = latency_grid(p, sub)
    # the default Engine's float64 λ run: one level-loop launch a weight
    # chunk and one walk, nothing a level
    sparse_levels_f64.launches = 0
    sparse_backtrace.launches = 0
    sparse_forward_f64.runs.clear()
    sparse_forward_f64.widths.clear()
    r64, t64 = wall(lambda: eng64.run(sub_batch))
    got64 = {"sparse_levels_f64": sparse_levels_f64.launches,
             "sparse_backtrace": sparse_backtrace.launches}
    widths64 = dict(sparse_forward_f64.widths)
    want64 = {"sparse_levels_f64": sum(
                  n * len(weight_chunks(eng64.arrays.level_ptr, sp.Emax_lv, S,
                                        sp.nlevels))
                  for S, n in widths64.items()),
              "sparse_backtrace": sparse_forward_f64.runs["lam"]}
    say(f"sparse float64 forward (default Engine): forwards "
        f"{dict(sparse_forward_f64.runs)}, by width S {widths64}; launches "
        f"{got64}")
    if got64 != want64 or want64["sparse_backtrace"] != 1:
        fail(f"default Engine float64 launches {got64} != one level loop a "
             f"weight chunk and one walk: {want64}")
    add_launches(f64_row, got64["sparse_levels_f64"])
    add_launches(level_rows[1], got64["sparse_backtrace"])
    prof = {}
    profile_forward("sparse float64 λ (default Engine)",
                    lambda: eng64.run(sub_batch),
                    focus=("sparse_levels_f64", "sparse_backtrace"),
                    stats=prof)
    # nothing a level: the forward's kernels do not grow with the 13,223
    # levels (the per-level PyTorch loop it replaced launched ~25 a level)
    if prof and prof["kernels"] > F64_FORWARD_KERNELS:
        fail(f"a float64 λ forward launched {prof['kernels']} kernels, more "
             f"than {F64_FORWARD_KERNELS}: per-level work is back")
    r32 = eng32.run(sub_batch)
    ref, t_np = wall(lambda: numpy_makespan(g, p, sub))
    ref32 = numpy_makespan(g, p, sub, store=np.float32)
    cpu, t_cpu = wall(lambda: Engine(g, params=p, policy=f32,
                                     device="cpu").run(sub_batch))
    e_64 = np.abs(T[pick] - r64.T) / r64.T
    e_np = np.abs(T[pick] - ref) / ref
    e_64np = np.abs(r64.T - ref) / ref
    e_lam = np.abs(lam[pick] - r64.lam[:, 0]) / r64.lam[:, 0]
    say(f"sparse float64 run at {SPARSE_POINTS} points (default Engine, λ): "
        f"{t64:.4f} s; numpy float64 longest path {t_np:.4f} s; CPU float32 "
        f"run {t_cpu:.2f} s")
    say(f"  T32 vs T64: {e_64.max()!r}; T32 vs numpy: {e_np.max()!r}; "
        f"T64 vs numpy: {e_64np.max()!r}; λ32 vs λ64: {e_lam.max()!r} "
        f"(λ32 {lam[pick].tolist()}, λ64 {r64.lam[:, 0].tolist()})")
    say(f"  float32-stored numpy longest path vs float64: "
        f"{(np.abs(ref32 - ref) / ref).max()!r}")
    say(f"  CPU vs card (float32 flavour): T equal "
        f"{np.array_equal(cpu.T, r32.T)}, λ equal "
        f"{np.array_equal(cpu.lam, r32.lam)}; card S={SPARSE_POINTS} vs "
        f"curve: T equal {np.array_equal(r32.T, T[pick])}")
    if max(e_64.max(), e_np.max()) > 1e-5:
        fail("sparse float32 T is off the float64 longest path by > 1e-5")
    if e_64np.max() > 1e-9:
        fail("sparse float64 T is off the numpy longest path")
    if e_lam.max() > 1e-5:
        fail("sparse float32 λ is off the float64 flavour's by > 1e-5")
    if not (np.array_equal(cpu.T, r32.T) and np.array_equal(cpu.lam, r32.lam)
            and np.array_equal(r32.T, T[pick])):
        fail("the card's float32 sparse results differ from the CPU's")

    for label, lam_run in (("values-only", False), ("λ", True)):
        profile_forward(f"sparse float32 {label}",
                        lambda: eng32.run(batch, compute_lam=lam_run),
                        focus=("sparse_levels", "sparse_backtrace"))


# -- phase 7 -----------------------------------------------------------------

def study_variants():
    """The four allreduce variants of the study: (variants, params, seconds
    to build them)."""
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.sweep import collective_variants
    p = cluster_params(L_us=3.0, o_us=5.0)
    P, steps = STUDY
    variants, t_build = wall(lambda: collective_variants(
        lambda a: synth.allreduce_chain(P, steps, nbytes=4e6, comp_us=5000.0,
                                        params=p, algo=a), STUDY_ALGOS, p))
    return variants, p, t_build


def phase_study(study, rows: list, dense_row: dict, walk_row: dict) -> dict:
    """The allreduce-algorithm study on the graph axis (``rows``: the
    batched mat-vecs' rows, whose main-path launches are now 0; the
    level-loop and walk rows gain this phase's).  Returns the dense packed
    forwards' peak memory, walls and ranking, and each graph's sparse
    float64 results at the checked points."""
    from repro_torch.kernels.maxplus import (dense_levels_f32,
                                             maxplus_matvec_argmax_batched,
                                             maxplus_matvec_batched,
                                             sparse_backtrace)
    from repro_torch.sweep import (Engine, ExecPolicy, compile_plan,
                                   group_plans, latency_grid, pack_plans)
    from repro_torch.sweep.engine import dense_forward_multi

    variants, p, t_build = study
    policy = ExecPolicy("dense", max_dense_bytes=STUDY_MAX_DENSE)
    names = [v.name for v in variants]
    plans = [compile_plan(v.graph, v.params) for v in variants]
    for v, pl in zip(variants, plans):
        say(f"study {v.name}: {v.graph.num_vertices} vertices, "
            f"{v.graph.num_edges} edges, {v.graph.nlevels} levels, envelope "
            f"{pl.envelope}, dense {pl.dense_bytes() / 2**20:.1f} MiB")
    groups = group_plans(plans)
    mp = pack_plans(plans)
    say(f"study: graphs built in {t_build:.2f} s; groups {groups}; packed "
        f"shape key {mp.shape_key}, dense {mp.dense_bytes() / 2**20:.1f} MiB")
    if groups != [list(range(len(plans)))]:
        fail(f"the four variants should pack into one group, got {groups}")

    deltas = np.linspace(0.0, 100.0, CURVE_POINTS)
    batch = latency_grid(p, deltas)
    counted = (maxplus_matvec_batched, maxplus_matvec_argmax_batched,
               dense_levels_f32, sparse_backtrace)
    for k in counted:
        k.launches = 0
    dense_forward_multi.runs.clear()
    torch.cuda.reset_peak_memory_stats()
    eng, t_stage = wall(lambda: Engine(
        [(v.graph, v.params) for v in variants], names=names, policy=policy))
    res, t_lam = wall(lambda: eng.run(batch))
    vals, t_vals = wall(lambda: eng.run(batch, compute_lam=False))
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in counted}
    runs = dict(dense_forward_multi.runs)
    nlv = int(mp.nlevels.max())
    ranking = res.rank()
    say(f"study wall: Engine() (compile, pack, stage) {t_stage:.4f} s, λ "
        f"run {t_lam:.4f} s, values-only run {t_vals:.4f} s "
        f"({CURVE_POINTS} points, G = {eng.G})")
    say(f"study peak device memory: {peak} B ({peak / 2**20:.1f} MiB)")
    one_cho = 4 * int(eng.arrays.valid_flat.numel()) * CURVE_POINTS
    check_peak("study", peak, one_cho)
    say(f"study forwards: {runs}; launches: {launches}; levels walked {nlv} "
        f"(nlv_p {mp.nlv_p})")
    say(f"study ranking (mean T over ΔL 0-100 us): {ranking}")
    for name, T0, lam0 in zip(names, res.T[:, 0], res.lam[:, 0, 0]):
        say(f"  {name}: T(dL=0) {T0!r} us, lambda_L {lam0!r}")
    # the launch structure since the level loop moved into one kernel: one
    # level-loop launch a forward for all G graphs, one walk for all G
    # graphs of a λ forward, no launch of the graph-batched mat-vecs
    want = {"maxplus_matvec_batched": 0, "maxplus_matvec_argmax_batched": 0,
            "dense_levels_f32": runs.get("values", 0) + runs.get("lam", 0),
            "sparse_backtrace": runs.get("lam", 0)}
    if launches != want or min(runs.get("values", 0),
                               runs.get("lam", 0)) <= 0:
        fail(f"study launches {launches} != one level loop a forward, one "
             f"walk a λ forward, no mat-vec: {want}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    add_launches(dense_row, launches["dense_levels_f32"])
    add_launches(walk_row, launches["sparse_backtrace"])

    T, lam = res.T, res.lam[..., 0]
    if res.axes != ("G", "S") or T.shape != (len(names), CURVE_POINTS) \
            or not (np.isfinite(T).all() and np.isfinite(lam).all()):
        fail(f"study result: axes {res.axes}, shape {T.shape}, or "
             "non-finite values")
    # a gap-bound critical path (bidir_ring at ΔL = 0: λ_L = 0) keeps T
    # flat until a latency-bound path overtakes it
    if not ((np.diff(T, axis=1) >= 0).all() and (T[:, -1] > T[:, 0]).all()):
        fail("study T(ΔL) falls with ΔL, or does not rise over the grid")
    if not (((lam >= 0) & (lam == np.round(lam))).all()
            and (lam[:, -1] >= 1).all()):
        fail("study λ_L must count critical-path messages")
    if not np.array_equal(vals.T, T):
        fail("study values-only T differs from the λ run's T")

    # each graph against its solo dense engine (bit for bit) and its
    # sparse float64 forward (T within 1e-5, λ equal) at a few points
    pick = np.linspace(0, CURVE_POINTS - 1, SPARSE_POINTS).astype(int)
    sub = latency_grid(p, deltas[pick])
    f64 = ExecPolicy(backend="sparse", dtype="float64")
    t0 = time.perf_counter()
    f64_runs = []
    for g, v in enumerate(variants):
        solo = Engine(v.graph, params=p, policy=policy).run(batch)
        r64 = Engine(v.graph, params=p, policy=f64).run(sub)
        f64_runs.append(r64)
        e64 = np.abs(T[g, pick] - r64.T) / r64.T
        say(f"  {v.name}: solo dense T equal {np.array_equal(solo.T, T[g])}"
            f", λ equal {np.array_equal(solo.lam, res.lam[g])}; vs sparse "
            f"float64: max |dT| / T {e64.max()!r}, λ equal "
            f"{np.array_equal(r64.lam, res.lam[g, pick])}")
        if not (np.array_equal(solo.T, T[g])
                and np.array_equal(solo.lam, res.lam[g])):
            fail(f"study {v.name}: packed differs from its solo engine")
        if e64.max() > 1e-5 or not np.array_equal(r64.lam, res.lam[g, pick]):
            fail(f"study {v.name}: off the float64 forward")
    t_solo = time.perf_counter() - t0

    cpu_batch = latency_grid(p, deltas[::CPU_EVERY])
    cpu, t_cpu = wall(lambda: Engine(
        [(v.graph, v.params) for v in variants], names=names, policy=policy,
        device="cpu").run(cpu_batch))
    say(f"study checks: solo and sparse float64 engines {t_solo:.2f} s; CPU "
        f"packed run ({cpu_batch.S} points) {t_cpu:.2f} s: T equal "
        f"{np.array_equal(cpu.T, T[:, ::CPU_EVERY])}, λ equal "
        f"{np.array_equal(cpu.lam, res.lam[:, ::CPU_EVERY])}")
    if not (np.array_equal(cpu.T, T[:, ::CPU_EVERY])
            and np.array_equal(cpu.lam, res.lam[:, ::CPU_EVERY])):
        fail("the card's packed study differs from the CPU's")

    for label, lam_run in (("packed values-only", False), ("packed λ", True)):
        profile_forward(label, lambda: eng.run(batch, compute_lam=lam_run),
                        focus=("dense_levels", "sparse_backtrace"))
    return {"peak": peak, "t_lam": t_lam, "t_vals": t_vals,
            "ranking": ranking, "pick": pick, "f64": f64_runs,
            "one_cho": one_cho}


def phase_study_segment(study, dense: dict, seg_row: dict,
                        walk_row: dict) -> dict:
    """Phase 7 on the segment backend: the study packed, one λ and one
    values forward over the 256-point grid; each graph's T and λ bit-equal
    to its solo segment engine and, at 4 points, to its sparse float64
    forward (``dense["f64"]``, phase 7's); one ``segment_levels_f64``
    launch a forward for all four graphs and one walk for all four of the
    λ forward; the ranking, walls, and a peak memory no higher than the
    dense packed forwards' (``dense["peak"]``), printed beside its value
    when the forward built weight chunks.  Returns the λ forward's T and λ
    (phase 12 holds its structure batch of the same plans to them)."""
    from repro_torch.kernels import maxplus
    from repro_torch.sweep import Engine, ExecPolicy, latency_grid
    from repro_torch.sweep.engine import segment_forward_multi

    variants, p, _ = study
    policy = ExecPolicy(backend="segment", max_dense_bytes=STUDY_MAX_DENSE)
    names = [v.name for v in variants]
    batch = latency_grid(p, np.linspace(0.0, 100.0, CURVE_POINTS))
    counters = {n: getattr(maxplus, n) for n in (
        "segment_levels_f64", "sparse_backtrace", "dense_levels_f32",
        "maxplus_matvec_batched", "maxplus_matvec_argmax_batched")}
    for k in counters.values():
        k.launches = 0
    segment_forward_multi.runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng, t_stage = wall(lambda: Engine(
        [(v.graph, v.params) for v in variants], names=names, policy=policy))
    res, t_lam = wall(lambda: eng.run(batch))
    vals, t_vals = wall(lambda: eng.run(batch, compute_lam=False))
    peak = torch.cuda.max_memory_allocated()
    segment_launches("segment study (phase 7)", counters,
                     segment_forward_multi, 1, seg_row, walk_row)
    check_peak("segment study", peak, dense["one_cho"])
    say(f"segment study peak {peak / 2**20:.1f} MiB against "
        f"{SEG_STUDY_PEAK_MIB_BEFORE} MiB with weight chunks")
    ranking = res.rank()
    say(f"segment study wall: Engine() {t_stage:.4f} s, λ run {t_lam:.4f} "
        f"s, values-only run {t_vals:.4f} s (dense packed: {dense['t_lam']:.4f}"
        f" / {dense['t_vals']:.4f} s); peak device memory {peak} B "
        f"({peak / 2**20:.1f} MiB; {base} B allocated before; dense packed "
        f"{dense['peak'] / 2**20:.1f} MiB)")
    say(f"segment study ranking: {ranking} (dense float32: "
        f"{dense['ranking']})")
    if res.backend != "segment" or res.axes != ("G", "S") \
            or not np.array_equal(vals.T, res.T):
        fail("segment study: backend, axes, or values-only T")
    # dense float32's objectives are within 1e-5 of segment's, so only a
    # pair closer than that may rank the other way round
    obj = dict(dense["ranking"])
    order = [n for n, _ in ranking]
    if any(obj[a] > obj[b] * (1 + 1e-5) for i, a in enumerate(order)
           for b in order[i + 1:]):
        fail("segment study ranks the algorithms unlike dense float32")
    if peak > dense["peak"]:
        fail(f"segment study peak {peak} B above the dense packed "
             f"forwards' {dense['peak']} B")
    pick = dense["pick"]
    t0 = time.perf_counter()
    for g, (v, r64) in enumerate(zip(variants, dense["f64"])):
        solo = Engine(v.graph, params=p, policy=policy).run(batch)
        same_solo = (np.array_equal(solo.T, res.T[g])
                     and np.array_equal(solo.lam, res.lam[g]))
        same64 = (np.array_equal(r64.T, res.T[g, pick])
                  and np.array_equal(r64.lam, res.lam[g, pick]))
        say(f"  {v.name}: segment packed vs solo bit-equal {same_solo}; vs "
            f"sparse float64 at {len(pick)} points bit-equal {same64}")
        if not (same_solo and same64):
            fail(f"segment study {v.name}: packed differs from its solo "
                 f"segment engine or from sparse float64")
    say(f"segment study checks: solo engines {time.perf_counter() - t0:.2f} s")
    for label, lam_run in (("segment packed values-only", False),
                           ("segment packed λ", True)):
        prof = {}
        profile_forward(label, lambda: eng.run(batch, compute_lam=lam_run),
                        focus=("segment_levels", "sparse_backtrace"),
                        stats=prof)
        # nothing a level: the kernels grow with the graphs (each one's
        # sink), not with the levels
        limit = F64_FORWARD_KERNELS * len(variants)
        if prof and prof["kernels"] > limit:
            fail(f"a {label} forward launched {prof['kernels']} kernels, "
                 f"more than {limit}")
    return {"T": res.T, "lam": res.lam}


# -- phases 8 and 9 ---------------------------------------------------------

def greedy_steps(model, prompts: torch.Tensor, gen: int):
    """Prefill then greedy decode through the serve step: (tokens [B, gen],
    every step's logits on the CPU in float32)."""
    from repro_torch.runtime import build_serve_step
    step = build_serve_step(model.cfg)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen)
    logits_all, out, tok = [], [], None
    for t in range(P + gen - 1):
        x = prompts[:, t:t + 1] if t < P else tok
        logits, cache = step(model, {"tokens": x}, cache, t)
        logits_all.append(logits.float().cpu())
        if t >= P - 1:
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1).cpu(), torch.stack(logits_all)


def serve_on_card(cfg, label: str, kernels: dict):
    """Draw ``cfg`` on the card in its dtype from seed 0 and drive the
    serving path: the serve loop (batch 4, prompt 128 prefilled a token a
    step, 64 generated tokens), then one 4096-token prefill step, with the
    launch count of each wrapper of ``kernels`` (name → wrapper) set to 0
    just before and read just after.  Prints the walls, tokens/s and peak
    memory, checks the tokens and logits; returns (model, {name:
    launches, and "name/route": launches for a wrapper that counts its
    routes}, prompts, the long prompt, the prefill step)."""
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.runtime import build_prefill_step

    torch.cuda.reset_peak_memory_stats()
    model, t_init = wall(lambda: init_params(cfg, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"{label} model: {n_params} parameters (param_count() "
        f"{cfg.param_count():.0f}), {n_bytes} B in {model.dtype}; drawn on "
        f"the card in {t_init:.2f} s")
    B, P, G = SERVE
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), device="cuda", generator=g)
    long = torch.randint(0, cfg.vocab, (1, PREFILL_T), device="cuda",
                         generator=g)
    prefill = build_prefill_step(cfg)
    serve.generate(model, prompts[:, :2], 2)             # warm-up
    prefill(model, {"tokens": long[:, :64]})

    # the main path: the serve loop, then one long prefill step
    for fn in kernels.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0
    res = serve.generate(model, prompts, G)
    peak_serve = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, t_prefill = wall(lambda: prefill(model, {"tokens": long}))
    peak_prefill = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, fn in kernels.items():
        for route, n in getattr(fn, "route_launches", {}).items():
            launches[f"{name}/{route}"] = n
    peak = max(peak_serve, peak_prefill)
    say(f"{label}: prefill {P} tok x {B} seqs (token by token) "
        f"{res.prefill_s:.4f} s ({res.prefill_s / P * 1e3:.3f} ms a step); "
        f"decode {G} tok in {res.decode_s:.4f} s "
        f"({res.decode_s / (G - 1) * 1e3:.3f} ms a step, "
        f"{B * G / res.decode_s:.1f} tok/s)")
    say(f"{label}: prefill step [1, {PREFILL_T}] {t_prefill:.4f} s "
        f"({PREFILL_T / t_prefill:.1f} tok/s), peak device memory "
        f"{peak_prefill} B ({peak_prefill / 2**20:.1f} MiB)")
    say(f"{label} peak device memory: {peak} B ({peak / 2**20:.1f} MiB)")
    say(f"{label} sample: {res.tokens[0, :16].tolist()}")
    if res.tokens.shape != (B, G) or int(res.tokens.min()) < 0 \
            or int(res.tokens.max()) >= cfg.vocab:
        fail(f"{label} tokens: shape {tuple(res.tokens.shape)} or out of "
             "range")
    if logits.shape != (1, PREFILL_T, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"{label} prefill logits: wrong shape or non-finite values")
    return model, launches, prompts, long, prefill


def profile_decode_step(model, prompts, label: str, focus):
    """One serve step at position 128 under the profiler; its busy ns."""
    from repro_torch.runtime import build_serve_step
    B, P, G = SERVE
    step = build_serve_step(model.cfg)
    cache = model.init_cache(B, P + G)
    tok = prompts[:, :1]
    step(model, {"tokens": tok}, cache, P)
    return profile_forward(f"{label} decode-step", lambda: step(
        model, {"tokens": tok}, cache, P), focus=focus)


def card_vs_cpu(small, label: str, prompt: int, gen: int) -> None:
    """``small`` (float32) drawn on the card and copied to the CPU (plain
    versions): greedy tokens equal and logits within XCHECK_TOL at every
    step of ``prompt`` + ``gen``."""
    from repro_torch.models import Model, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False       # the Mamba conv1d
    card = init_params(small, seed=0)
    cpu = Model(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator(device="cuda").manual_seed(2)
    xp = torch.randint(0, small.vocab, (SERVE[0], prompt), device="cuda",
                       generator=g)
    (tok_card, lg_card), t_card = wall(lambda: greedy_steps(card, xp, gen))
    t0 = time.perf_counter()
    tok_cpu, lg_cpu = greedy_steps(cpu, xp.cpu(), gen)
    t_cpu = time.perf_counter() - t0
    e = float((lg_card - lg_cpu).abs().max())
    same = torch.equal(tok_card, tok_cpu)
    say(f"{label} card vs CPU ({small.n_layers} layer(s) "
        f"{[small.layer_spec(i) for i in range(small.n_layers)]}, float32, "
        f"{prompt} + {gen} steps): greedy tokens equal {same}, max "
        f"|logits_card - logits_cpu| {e} over {lg_card.shape[0]} steps "
        f"(logits up to {float(lg_cpu.abs().max()):.3f}); card "
        f"{t_card:.2f} s, CPU {t_cpu:.2f} s")
    if not same or e > XCHECK_TOL:
        fail(f"the card's {label} serve run differs from the CPU's "
             f"(tolerance {XCHECK_TOL})")


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def check_flash_routes(label: str, launches: dict, n_attn: int) -> None:
    """Every bf16 flash launch of a serve run (``n_attn`` attention layers,
    prompt + gen − 1 decode steps and one long prefill) went through the
    decode or the prefill kernel, none through the simple one."""
    B, P, G = SERVE
    want = {"decode": n_attn * (P + G - 1), "prefill": n_attn, "simple": 0}
    got = {r: launches[f"flash_attention/{r}"] for r in want}
    say(f"{label} flash launches by route: {got} (want {want})")
    if got != want:
        fail(f"{label} flash routes {got} != {want}")


def phase_serve(rows: dict) -> None:
    """llama3.2-3b served on the card; ``rows``: the flash kernels' by
    route, whose launches this phase fills."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention

    cfg = configs.get(SERVE_ARCH)[0]
    say(f"serve model: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    model, launches, prompts, long, prefill = serve_on_card(
        cfg, "serve", {"flash_attention": flash_attention})
    B, P, G = SERVE
    want = cfg.n_layers * (P + G - 1) + cfg.n_layers
    say(f"serve flash launches: {launches['flash_attention']} (want "
        f"{cfg.n_layers} x ({P} + {G} - 1) + {cfg.n_layers} = {want})")
    if launches["flash_attention"] != want:
        fail(f"flash launches {launches['flash_attention']} != {want}")
    check_flash_routes("serve", launches, cfg.n_layers)
    for route, row in rows.items():
        row["launches"] = launches[f"flash_attention/{route}"]
    profile_forward(f"serve prefill-step [1, {PREFILL_T}]",
                    lambda: prefill(model, {"tokens": long}),
                    focus=("flash_prefill", "nvjet"))
    profile_decode_step(model, prompts, "serve", focus=("flash_decode",))
    del model
    free_card()

    layers, P2, G2 = XCHECK
    card_vs_cpu(dataclasses.replace(cfg, n_layers=layers, dtype="float32",
                                    scan_period_multiplier=1),
                "serve", P2, G2)
    free_card()


def phase_hybrid(flash_rows: dict, scan_row: dict, mamba_row: dict) -> None:
    """jamba-1.5-large-398b, cut to its first layers, served on the card;
    the flash rows gain this phase's launches, the scan rows get them."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import linear_scan, mamba_scan

    full = configs.get(HYBRID_ARCH)[0]
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    specs = [cfg.layer_spec(i) for i in range(cfg.n_layers)]
    n_attn = sum(m == "attn" for m, _ in specs)
    n_mamba = sum(m == "mamba" for m, _ in specs)
    gb = [dataclasses.replace(full, n_layers=n).param_count() * 2 / 1e9
          for n in (8, 6, HYBRID_LAYERS)]
    say(f"hybrid cut: {full.name} ({full.n_layers} layers) at full width, "
        f"layers 0-{HYBRID_LAYERS - 1} {specs}: one 8-layer period is "
        f"{gb[0]:.1f} GB in bf16, more than the card; 6 layers {gb[1]:.1f} "
        f"GB; {HYBRID_LAYERS} layers {gb[2]:.1f} GB")
    say(f"hybrid model: {cfg.name}, d_model {cfg.d_model}, Mamba Di "
        f"{cfg.ssm_expand * cfg.d_model} S {cfg.ssm_state_dim}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, {cfg.n_experts} experts "
        f"top-{cfg.top_k} of d_ff {cfg.moe_d_ff}, vocab {cfg.vocab}")
    model, launches, prompts, long, prefill = serve_on_card(
        cfg, "hybrid", {"mamba_scan": mamba_scan, "linear_scan": linear_scan,
                        "flash_attention": flash_attention})
    B, P, G = SERVE
    # since the fused Mamba scan, each Mamba call is one mamba_scan launch
    # (the decode schedule for the 191 one-token steps, the prefill schedule
    # for the long prefill) and the standalone linear scan has none
    want = {"mamba_scan": n_mamba * (P + G - 1) + n_mamba,
            "mamba_scan/decode": n_mamba * (P + G - 1),
            "mamba_scan/prefill": n_mamba, "linear_scan": 0,
            "flash_attention": n_attn * (P + G - 1) + n_attn}
    say(f"hybrid launches: {launches} (want mamba_scan {n_mamba} x ({P} + "
        f"{G} - 1) + {n_mamba}, linear_scan 0, flash_attention {n_attn} x "
        f"({P} + {G} - 1) + {n_attn}: {want})")
    if {name: launches[name] for name in want} != want:
        fail(f"hybrid launches {launches} != {want}")
    check_flash_routes("hybrid", launches, n_attn)
    scan_row["launches"] = launches["linear_scan"]
    mamba_row["launches"] = launches["mamba_scan"]
    for route, row in flash_rows.items():
        row["launches"] += launches[f"flash_attention/{route}"]

    focus = ("mamba_scan", "linear_scan", "flash_prefill", "flash_decode",
             "nvjet", "elementwise")
    profile_forward(f"hybrid prefill-step [1, {PREFILL_T}]",
                    lambda: prefill(model, {"tokens": long}), focus=focus)
    step_ns = profile_decode_step(model, prompts, "hybrid", focus)
    moe = next(blk.ffn for blk in model.blocks if blk.spec[1] == "moe")
    n_moe = sum(f == "moe" for _, f in specs)
    h = torch.randn((B, 1, cfg.d_model), device="cuda").to(model.dtype)
    moe_ns = profile_forward("one MoE FFN at decode", lambda: moe(h))
    moe_bytes = sum(p.numel() * p.element_size() for p in moe.parameters())
    if step_ns and moe_ns:
        # the MoE FFN is profiled alone, on a random input of the decode
        # step's shape: its kernels are not told apart inside the step
        say(f"hybrid decode step: {n_moe} x one MoE FFN profiled alone "
            f"{n_moe * moe_ns / 1e6:.3f} ms against the step's "
            f"{step_ns / 1e6:.3f} ms device busy "
            f"({100 * n_moe * moe_ns / step_ns:.1f} %); each "
            f"reads all {cfg.n_experts} experts, {moe_bytes} B, bound "
            f"{moe_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    del model, moe
    free_card()

    layers, P2, G2 = HYBRID_XCHECK
    card_vs_cpu(dataclasses.replace(full, n_layers=layers, dtype="float32"),
                "hybrid", P2, G2)
    free_card()


# -- phase 10 ----------------------------------------------------------------

def counted(run):
    """``run()`` with every (max,+) kernel's launch counter and the
    forwards' run counters at 0: (result, seconds, launches by kernel,
    forwards by flavour and kind, chunked forwards by flavour ("f32",
    "f64") and width S)."""
    from repro_torch.kernels import maxplus
    from repro_torch.sweep.engine import (dense_forward, segment_forward,
                                          sparse_forward_f32,
                                          sparse_forward_f64)
    kernels = [getattr(maxplus, n) for n in SOLVER_KERNELS]
    fwds = (dense_forward, segment_forward, sparse_forward_f64,
            sparse_forward_f32)
    sparse = {"f32": sparse_forward_f32, "f64": sparse_forward_f64}
    for k in kernels:
        k.launches = 0
    for f in fwds:
        f.runs.clear()
    for f in sparse.values():
        f.widths.clear()
    out, secs = wall(run)
    return (out, secs, {k.__name__: k.launches for k in kernels},
            {f.__name__: dict(f.runs) for f in fwds},
            {k: dict(f.widths) for k, f in sparse.items()})


def check_solver_launches(label: str, launches: dict, runs: dict,
                          widths: dict, plans: dict, rows: dict) -> None:
    """The launch structure of phases 4 and 6 on a phase-10 or phase-11
    call: one dense level-loop launch a dense forward, one segment
    level-loop launch a segment forward, one level-loop launch a weight
    chunk of each sparse forward of either flavour (``widths`` by flavour
    and S, ``plans`` the SparsePlan of each sparse flavour that ran), one
    walk a λ forward, no standalone (max,+) kernel; the rows gain the
    launches."""
    from repro_torch.sweep.engine import weight_chunks
    n = lambda f, k=None: (sum(runs[f].values()) if k is None  # noqa: E731
                           else runs[f].get(k, 0))
    want = {name: 0 for name in SOLVER_KERNELS}
    want["dense_levels_f32"] = n("dense_forward")
    want["segment_levels_f64"] = n("segment_forward")
    for flavour, by_S in widths.items():
        pl = plans.get(flavour)
        if not by_S:
            continue
        want[f"sparse_levels_{flavour}"] = sum(
            c * len(weight_chunks(pl.level_ptr, pl.Emax_lv, S, pl.nlevels))
            for S, c in by_S.items())
    want["sparse_backtrace"] = sum(n(f, "lam") for f in runs)
    say(f"  {label}: forwards {runs}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want or sum(launches.values()) <= 0:
        fail(f"{label}: launches {launches} != one level loop a dense "
             f"forward, one a weight chunk of a sparse forward, one walk a "
             f"λ forward: {want}")
    for name, row in rows.items():
        add_launches(row, launches[name])


def held(label: str, run, launches: dict, rows: dict) -> None:
    """``run()`` once more, after its counted main-path run, with every
    kernel the engine launches shadowed: each launch also runs the kernel's
    plain version on copies of the same inputs, at the same width, and t,
    ssum, cho and csrc of the level loops and λ of the walk must be
    bit-equal.
    The rerun must launch what the main path did.  Its launches are not the
    main path's: ``counted`` sets the counters to 0 before each main-path
    run.  The rows' ``max_abs_err`` take the largest difference."""
    from repro_torch.kernels import maxplus
    from repro_torch.sweep import engine as eng
    stats = {name: {"launches": 0, "widths": set(), "mismatches": 0,
                    "max_abs_err": 0.0} for name in rows}

    def check(name, S, got, want):
        st = stats[name]
        st["launches"] += 1
        st["widths"].add(S)
        for u, v in zip(got, want):
            if u is None:
                continue
            st["mismatches"] += int((u != v).sum())
            if u.is_floating_point():
                st["max_abs_err"] = max(st["max_abs_err"],
                                        float((u - v).abs().max()))

    def level_loop(name, plain_args):
        kernel = getattr(maxplus, name)
        plain = getattr(maxplus, name + "_ref")

        def shadow(t, ssum, cho, *rest):
            *rest, csrc = rest        # the engine passes csrc last
            state = (t, ssum, cho, csrc)
            copy = [None if x is None else x.clone() for x in state]
            kernel(t, ssum, cho, *rest, csrc)
            plain(*copy[:3], *plain_args(rest), copy[3])
            check(name, t.shape[-1], state, copy)
        return shadow

    def walk(vsel, cho, csrc, elat, nlv):
        lam = maxplus.sparse_backtrace(vsel, cho, csrc, elat, nlv)
        check("sparse_backtrace", lam.shape[-2], (lam,),
              (maxplus.sparse_walk_ref(vsel, cho, csrc, elat, nlv),))
        return lam

    # the dense plain version takes w, A, esrc, elat_sum, vcost of the
    # kernel's w, A, esrc, lv_ptr, rows, row_ptr, in_edges, elat_sum,
    # vcost; the segment one Lmat, GSmat and the per-edge view (edst ..
    # vcost), lv0, lv1 of the kernel's Lmat, GSmat, the per-edge view, the
    # six lists, lv0, lv1
    shadows = {"dense_levels_f32": level_loop(
                   "dense_levels_f32", lambda r: (*r[:3], *r[7:])),
               "segment_levels_f64": level_loop(
                   "segment_levels_f64", lambda r: (*r[:10], *r[16:])),
               "sparse_levels_f32": level_loop("sparse_levels_f32",
                                               lambda r: r),
               "sparse_levels_f64": level_loop("sparse_levels_f64",
                                               lambda r: r),
               "sparse_backtrace": walk}
    shadows = {n: f for n, f in shadows.items() if n in rows}
    saved = {name: getattr(eng, name) for name in shadows}
    try:
        for name, fn in shadows.items():
            setattr(eng, name, fn)
        run()
    finally:
        for name, fn in saved.items():
            setattr(eng, name, fn)
    say(f"  {label}: each launch held against its plain version, bit for "
        f"bit: " + "; ".join(
            f"{n} {st['launches']} launches at S {sorted(st['widths'])}, "
            f"{st['mismatches']} mismatches, max|kernel-plain| "
            f"{st['max_abs_err']}" for n, st in stats.items()
            if st["launches"]))
    for name, st in stats.items():
        if st["mismatches"]:
            fail(f"{label}: {name} differs from its plain version in "
                 f"{st['mismatches']} elements")
        if st["launches"] != launches[name]:
            fail(f"{label}: the held rerun launched {name} "
                 f"{st['launches']} times, the main path {launches[name]}")
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        st["max_abs_err"])


def phase_solvers(g, p, rows: dict) -> dict:
    """Phase 10: LLAMP's own solvers — the LP (Algorithm 1) on the card's
    IPM, HiGHS, the float64 forward and ``core.dag`` on phase 4's stencil;
    the IPM card against CPU; ``tolerance_lp`` against the (max,+)
    tolerance; Algorithm 2 under two policies on two graphs; ``analyze``;
    the quickstart flow against the event simulator.  ``rows``: the dense
    and sparse level-loop and walk rows, which gain this phase's launches.
    Returns the dense route's answer on phase 4's LP, its wall, HiGHS's
    and ``core.dag``'s answers."""
    from repro_torch.core import dag, ipm, lp, sensitivity, simulator, synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.device import resolve_device
    from repro_torch.sweep import (Engine, ExecPolicy, base_batch,
                                   breakpoints_batched, compile_sparse)
    dev = resolve_device(None)
    f64 = ExecPolicy(backend="sparse", dtype="float64")
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731

    # the LP of phase 4's stencil: the card's IPM, HiGHS, the sparse
    # float64 forward and the scalar engine
    prob = lp.build_lp(g, p)
    A, _, _ = ipm._fold_bounds(prob)
    n = prob.nvars
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    sol, t_ipm = wall(lambda: lp.predict_runtime(g, p))
    peak = torch.cuda.max_memory_allocated()
    highs, t_highs = wall(lambda: lp.predict_runtime(g, p, solver="highs"))
    f64_run = lambda: Engine(g, params=p, policy=f64).run(  # noqa: E731
        base_batch(p))
    res, t_f64, launches, runs, widths = counted(f64_run)
    check_solver_launches("float64 forward", launches, runs, widths,
                          {"f64": compile_sparse(g, p)}, rows)
    held("float64 forward", f64_run, launches, rows)
    sched, t_dag = wall(lambda: dag.evaluate(g, p))
    say(f"LP of phase 4's stencil: {A.shape[0]} rows x {n} columns "
        f"(bounds folded), {A.nnz} nonzeros; IPM on {sol.device}: "
        f"{sol.iterations} iterations, {t_ipm:.4f} s, T = {sol.T!r} us, "
        f"lambda = {sol.lam.tolist()}; HiGHS {t_highs:.4f} s, T = "
        f"{highs.T!r}, lambda = {highs.lam.tolist()}; sparse float64 "
        f"forward {t_f64:.4f} s, T = {float(res.T[0])!r}; core.dag {t_dag:.4f} s, "
        f"T = {sched.T!r}")
    errs = {"HiGHS": rel(sol.T, highs.T),
            "float64 forward": rel(sol.T, float(res.T[0])),
            "core.dag": rel(sol.T, sched.T)}
    lam_err = float(np.max(np.abs(sol.lam - highs.lam) / np.abs(highs.lam)))
    say(f"  IPM T against {errs}; lambda against HiGHS's {lam_err!r}")
    if sol.status != "optimal" or max(errs.values()) > 1e-5:
        fail(f"the card's IPM T is off by more than 1e-5: {errs}")
    if lam_err > 1e-3:
        fail(f"the card's IPM lambda is off HiGHS's by {lam_err}")
    dense_lp = {"sol": sol, "seconds": t_ipm, "highs": highs, "dag": sched}

    # one factorization of the Newton matrix, alone, beside its bound
    ns = ipm.NewtonSystem(A, dev)
    d = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    form_ms = event_ms(lambda: ns.form(d), reps=5)
    chol_ms = event_ms(lambda: torch.linalg.cholesky_ex(
        ns.M, out=(ns.L, ns.info)), reps=5)
    ns.factor()
    rhs = torch.ones(n, dtype=torch.float64, device=dev)
    solve_ms = event_ms(lambda: ns.solve(rhs), reps=5)
    flops = n ** 3 / 3
    bound_ms = flops / FP64_OPS_PER_S * 1e3
    say(f"  Newton matrix: n {n}, {ns.nbytes} B ({ns.nbytes / 2**30:.3f} "
        f"GiB); form (zero + index_add_ of {ns.flat.numel()} terms) "
        f"{form_ms:.4f} ms; cholesky_ex {chol_ms:.4f} ms against its bound "
        f"{bound_ms:.4f} ms ({flops:.4g} flops over {FP64_OPS_PER_S:.3g} "
        f"FP64/s: {100 * bound_ms / chol_ms:.1f} %); one solve (two "
        f"triangular solves) "
        f"{solve_ms:.4f} ms; IPM peak memory {peak} B ({peak / 2**30:.3f} "
        f"GiB, {(peak - mem0) / 2**30:.3f} GiB above its start)")
    del ns, d, rhs
    free_card()

    # the IPM, card against CPU, on a 64-rank stencil
    px, py, it = LP_SMALL
    g2 = synth.stencil2d(px, py, it, halo_bytes=64e3, comp_us=500.0,
                         params=p)
    card, t_card = wall(lambda: lp.predict_runtime(g2, p))
    host, t_host = wall(lambda: lp.predict_runtime(g2, p, device="cpu"))
    e = rel(card.T, host.T)
    say(f"IPM on stencil2d{LP_SMALL} ({g2.nclass + g2.num_vertices + 1} "
        f"columns): card "
        f"{card.iterations} iterations {t_card:.4f} s, CPU "
        f"{host.iterations} iterations {t_host:.4f} s; |dT| / T = {e!r}")
    if e > 1e-6:
        fail(f"the card's IPM differs from the CPU's by {e} > 1e-6")

    # the maximize-ℓ LP against the (max,+) tolerance on the card (the
    # default policy: segment)
    degr = (0.01, 0.05)
    tol_run = lambda: sensitivity.latency_tolerance(g, p, degr)  # noqa: E731
    tol_mp, t_mp, launches, runs, widths = counted(tol_run)
    check_solver_launches("latency_tolerance", launches, runs, widths, {},
                          rows)
    held("latency_tolerance", tol_run, launches, rows)
    for deg in degr:
        t_lp, secs = wall(lambda: lp.tolerance_lp(g, p, deg))
        e = rel(t_lp, tol_mp[deg])
        say(f"tolerance {deg:.0%}: tolerance_lp (card IPM, two LPs) {t_lp!r} "
            f"us in {secs:.4f} s; latency_tolerance {tol_mp[deg]!r} us "
            f"({t_mp:.4f} s for both); relative {e!r}")
        if not e <= 1e-5:
            fail(f"tolerance_lp at {deg} is off latency_tolerance by {e}")

    # Algorithm 2 on the card: float64 (equal to the scalar search) and
    # float32 (the same count, within 1e-6)
    lo, hi = BP_RANGE
    for label, gb, pol32 in bp_graphs(p):
        want, t_host = wall(lambda: dag.breakpoints(gb, p, lo, hi))
        sp = compile_sparse(gb, p)
        for pol, tag in ((f64, "float64 sparse"), (pol32, "float32 "
                                                    + pol32.backend)):
            def search():
                return sensitivity.critical_latencies(gb, p, lo, hi,
                                                      policy=pol)
            breakpoints_batched.stats.clear()
            got, secs, launches, runs, widths = counted(search)
            st = dict(breakpoints_batched.stats)
            say(f"critical_latencies {label}, {tag}: {len(got)} kinks "
                f"{[round(x, 6) for x in got]}, {st['rounds']} rounds, "
                f"{st['probes']} probes, {secs:.4f} s (core.dag.breakpoints "
                f"on the host: {len(want)} kinks, {t_host:.4f} s)")
            check_solver_launches(f"critical_latencies {label} {tag}",
                                  launches, runs, widths,
                                  {"f32": sp, "f64": sp}, rows)
            held(f"critical_latencies {label} {tag}", search, launches, rows)
            if pol is f64 and got != want:
                fail(f"{label}: the float64 kinks {got} != core.dag's {want}")
            if len(got) != len(want) or (got and float(np.max(
                    np.abs(np.subtract(got, want)) / np.abs(want))) > 1e-6):
                fail(f"{label}: the {tag} kinks {got} are not core.dag's "
                     f"{want} within 1e-6")
        if len(want) < 1:
            fail(f"{label}: no kink in [{lo}, {hi}] to find")

    # analyze on the card against the scalar engine
    an_run = lambda: sensitivity.analyze(g, p)  # noqa: E731
    rep, t_an, launches, runs, widths = counted(an_run)
    check_solver_launches("analyze", launches, runs, widths, {}, rows)
    held("analyze", an_run, launches, rows)
    e = rel(rep.T, sched.T)
    say(f"analyze: T = {rep.T!r} us, lambda {rep.lam.tolist()}, rho "
        f"{rep.rho.tolist()}, {t_an:.4f} s; against core.dag: {e!r}")
    if rep.T != sched.T or not np.array_equal(rep.lam, sched.lam):
        fail("analyze on the card (segment) is off core.dag's T or lambda")

    # the quickstart flow on the port, its DES cross-check
    qp = cluster_params(L_us=3.0, o_us=5.0)
    qg = synth.stencil2d(*QUICKSTART, halo_bytes=64e3, comp_us=500.0,
                         params=qp)
    deltas = np.linspace(0.0, 50.0, 6)

    def quickstart():
        return (sensitivity.analyze(qg, qp), lp.predict_runtime(qg, qp),
                sensitivity.latency_tolerance(qg, qp),
                sensitivity.critical_latencies(qg, qp, lo, hi),
                sensitivity.latency_curve(qg, qp, deltas))
    (qr, qs, qt, qc, curve), t_q, launches, runs, widths = counted(
        quickstart)
    check_solver_launches("quickstart", launches, runs, widths, {}, rows)
    held("quickstart", quickstart, launches, rows)
    measured, t_des = wall(lambda: simulator.runtime_sweep(qg, qp, deltas))
    rrmse = curve.rrmse_vs(measured)
    say(f"quickstart stencil2d{QUICKSTART}: T {qr.T!r}, LP {qs.T!r} "
        f"({qs.iterations} iterations), tolerance {qt}, critical latencies "
        f"{qc}, {t_q:.4f} s; DES {t_des:.4f} s; RRMSE {rrmse!r}")
    if not (rrmse <= 1e-9 and rel(qs.T, qr.T) <= 1e-5):
        fail(f"quickstart: RRMSE {rrmse} > 1e-9 or the LP's T {qs.T} is "
             f"off analyze's {qr.T}")
    return dense_lp


# -- phase 16 ----------------------------------------------------------------

def ipm_counted(run):
    """``run()`` with the tree kernels' counters at 0 and the peak memory
    statistics reset: (result, seconds, launches by kernel, peak bytes,
    peak bytes above the start)."""
    from repro_torch.kernels import ipm as kipm
    for name in IPM_KERNELS:
        getattr(kipm, name).launches = 0
    free_card()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    out, secs = wall(run)
    peak = torch.cuda.max_memory_allocated()
    return (out, secs, {n: getattr(kipm, n).launches for n in IPM_KERNELS},
            peak, peak - mem0)


def check_ipm_launches(label: str, sol, launches: dict) -> None:
    """One ``tree_factor`` an IPM iteration that formed a Newton system
    (all but the last), one ``tree_solve`` a PCG step and one to start each
    PCG; the PCG steps a Newton solve printed."""
    steps = sol.pcg_steps
    want = {"tree_factor": sol.iterations - 1,
            "tree_solve": sum(steps) + len(steps)}
    say(f"  {label}: {sol.status}, {sol.iterations} iterations; PCG steps "
        f"a Newton solve min / median / max {min(steps)} / "
        f"{float(np.median(steps))} / {max(steps)}, {sum(steps)} in all "
        f"over {len(steps)} solves; launches {launches} (expected {want})")
    if launches != want:
        fail(f"{label}: tree kernels launched {launches}, not {want}")


def tree_bounds(f, R: int) -> dict:
    """Bytes and operations of one ``tree_solve`` over R lanes and of one
    ``tree_factor`` on forest ``f`` (each input read once, each output
    written once), and the chain of levels × ``TRIP_US``."""
    nv, nch, nlv = f.nv, int(f.ch.numel()), f.nlv
    solve_b = nv * (4 + 8 + 8 + 8 + 4) + 4 * nch + 4 * (nlv + 1) \
        + 2 * 8 * R * nv                       # parent w piv g ch_ptr; r, x
    solve_ops = R * (2 * nch + 3 * nv)
    factor_b = nv * (8 + 8 + 4 + 8 + 8) + 4 * nch + 4 * (nlv + 1)
    factor_ops = 3 * nch + nv
    ms = lambda b, o: max(b / HBM_BYTES_PER_S, o / FP64_VECTOR_OPS_PER_S) \
        * 1e3  # noqa: E731
    by = lambda b, o: "bytes" if b / HBM_BYTES_PER_S \
        >= o / FP64_VECTOR_OPS_PER_S else "operations"  # noqa: E731
    return {"solve": (ms(solve_b, solve_ops), by(solve_b, solve_ops),
                      solve_b, solve_ops, 2 * nlv * TRIP_US / 1e3),
            "factor": (ms(factor_b, factor_ops), by(factor_b, factor_ops),
                       factor_b, factor_ops, nlv * TRIP_US / 1e3)}


def phase_sparse_ipm(g4, p4, dense_lp: dict) -> list:
    """Phase 16: the IPM's sparse Newton route on the card.  (a) phase 4's
    LP through the private seam against ``core.dag``, the dense route
    (phase 10) and HiGHS; (b) ``predict_runtime`` past the dense cap
    (the default route) against ``core.dag`` and HiGHS; (c) ``tolerance_lp``
    past the cap against ``latency_tolerance``; (d) ``tree_factor`` and
    ``tree_solve`` on (b)'s last IPM iteration's forest against their plain
    versions, bit for bit, with their times and bounds.  Returns the two
    kernels' rows; their launches are (b)'s and (c)'s."""
    from repro_torch.core import dag, ipm, lp, sensitivity, synth
    from repro_torch.kernels import ipm as kipm
    dev = torch.device("cuda")
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    lam_rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))  # noqa: E731

    # (a) phase 4's LP on the sparse route, through the private seam
    prob = lp.build_lp(g4, p4)
    sol, secs, launches, peak, rise = ipm_counted(
        lambda: ipm._solve(prob, dev, newton=ipm.SparseNewton))
    dense, ref, highs = dense_lp["sol"], dense_lp["dag"], dense_lp["highs"]
    errs = {"core.dag": rel(sol.T, ref.T), "dense route": rel(sol.T, dense.T)}
    lerr = lam_rel(sol.lam, highs.lam)
    say(f"(a) phase 4's LP ({prob.nvars} columns) on the sparse route: "
        f"{secs:.4f} s (the dense route in phase 10: {dense_lp['seconds']:.4f}"
        f" s, {dense.iterations} iterations); T = {sol.T!r}, lambda "
        f"{sol.lam.tolist()}; T against {errs}, lambda against HiGHS's "
        f"{lerr!r}; peak {peak} B ({rise} B above its start)")
    check_ipm_launches("(a)", sol, launches)
    if sol.status != "optimal" or max(errs.values()) > 1e-5 or lerr > 1e-3:
        fail(f"(a): the sparse route is off: T {errs}, lambda {lerr}")

    # (b) predict_runtime past the cap: the default route is the sparse one
    px, py, it = LP_SPARSE
    gb = synth.stencil2d(px, py, it, halo_bytes=64e3, comp_us=500.0,
                         params=p4)
    prob_b = lp.build_lp(gb, p4)
    n_b = prob_b.nvars
    last = {}

    class Keep(ipm.SparseNewton):
        """The sparse route, keeping its last iteration's forest for (d)."""

        def factor(self):
            super().factor()
            last.update(forest=self.forest, diag=self.diag,
                        iteration=self.iteration)

    sparse_cls, ipm.SparseNewton = ipm.SparseNewton, Keep
    try:
        sol, secs, launches, peak, rise = ipm_counted(
            lambda: lp.predict_runtime(gb, p4))
    finally:
        ipm.SparseNewton = sparse_cls
    rows_launches = dict(launches)
    ref, t_dag = wall(lambda: dag.evaluate(gb, p4))
    highs, t_highs = wall(lambda: lp.predict_runtime(gb, p4, solver="highs"))
    errs = {"core.dag": rel(sol.T, ref.T), "HiGHS": rel(sol.T, highs.T)}
    lerr = {"core.dag": lam_rel(sol.lam, ref.lam),
            "HiGHS": lam_rel(sol.lam, highs.lam)}
    say(f"(b) predict_runtime on stencil2d{LP_SPARSE}: {prob_b.A.shape[0]} "
        f"rows x {n_b} columns (a dense M would take "
        f"{ipm.newton_bytes(n_b) / 2**30:.2f} GiB, the cap "
        f"{ipm.MAX_NEWTON_BYTES / 2**30:.0f} GiB); {gb.nlevels} levels; {secs:.4f} s on {sol.device} "
        f"({secs * 1e3 / max(sum(sol.pcg_steps or [0]), 1):.4f} ms a PCG "
        f"step, host included); T = {sol.T!r}, lambda "
        f"{sol.lam.tolist()}; core.dag {t_dag:.4f} s T = {ref.T!r} lambda "
        f"{ref.lam.tolist()}; HiGHS {t_highs:.4f} s T = {highs.T!r} lambda "
        f"{highs.lam.tolist()}; T against {errs}, lambda against {lerr}; "
        f"peak {peak} B ({peak / 2**30:.3f} GiB, {rise} B above its start)")
    check_ipm_launches("(b)", sol, launches)
    if sol.pcg_steps is None or sol.status != "optimal" \
            or max(errs.values()) > 1e-5 or max(lerr.values()) > 1e-3:
        fail(f"(b): predict_runtime past the cap is off: T {errs}, lambda "
             f"{lerr}, route {'sparse' if sol.pcg_steps else 'dense'}")
    if rise > ipm.newton_bytes(n_b) // 64:
        fail(f"(b): the sparse route's peak rose {rise} B, more than 1/64 "
             f"of a dense M ({ipm.newton_bytes(n_b)} B)")
    del prob_b

    # (c) tolerance_lp past the cap against the (max,+) tolerance
    px, py, it = LP_TOL
    gc_ = synth.stencil2d(px, py, it, halo_bytes=64e3, comp_us=500.0,
                          params=p4)
    tol, secs, launches, peak, rise = ipm_counted(
        lambda: lp.tolerance_lp(gc_, p4, LP_TOL_DEGR))
    for k, v in launches.items():
        rows_launches[k] += v
    want, t_mp = wall(lambda: sensitivity.latency_tolerance(
        gc_, p4, (LP_TOL_DEGR,))[LP_TOL_DEGR])
    e = rel(tol, want)
    say(f"(c) tolerance_lp at {LP_TOL_DEGR:.0%} on stencil2d{LP_TOL} "
        f"({gc_.nclass + gc_.num_vertices + 1} columns, two LPs on the sparse "
        f"route): {tol!r} us in {secs:.4f} s, launches {launches}, peak "
        f"{peak} B; latency_tolerance {want!r} us in {t_mp:.4f} s; "
        f"relative {e!r}")
    if not e <= 1e-5 or min(launches.values()) < 1:
        fail(f"(c): tolerance_lp is off latency_tolerance by {e}, or no "
             f"tree kernel ran: {launches}")

    # (d) the kernels on (b)'s last iteration's forest
    from repro_torch.kernels.ipm import ops, stage
    f, diag = last["forest"], last["diag"]
    piv, gg = kipm.tree_factor(f, diag)
    piv_r, g_r = kipm.tree_factor_ref(f, diag)
    bad = {"tree_factor": int((piv != piv_r).sum() + (gg != g_r).sum())}
    err = {"tree_factor": float(torch.maximum((piv - piv_r).abs().max(),
                                              (gg - g_r).abs().max()))}
    gen = torch.Generator(device="cuda").manual_seed(16)
    bad["tree_solve"] = 0
    err["tree_solve"] = 0.0
    timing, rs = {}, {}
    chain = ops.bind(ctypes.CDLL(str(KNOB_LIBS["tree_precond chain"])))
    for R in (2, 1):                 # the predictor's lanes, the corrector's
        r = rs[R] = torch.randn(f.nv, R, dtype=torch.float64, device=dev,
                                generator=gen)
        x = kipm.tree_solve(f, piv, gg, r)
        xr = kipm.tree_solve_ref(f, piv, gg, r)
        bad["tree_solve"] += int((x != xr).sum())
        err["tree_solve"] = max(err["tree_solve"],
                                float((x - xr).abs().max()))
        timing[R] = (cuda_ms(lambda: kipm.tree_solve(f, piv, gg, r), 50,
                             warmup=3),
                     event_ms(lambda: kipm.tree_solve_ref(f, piv, gg, r)))
    fac_ms = cuda_ms(lambda: kipm.tree_factor(f, diag), 50, warmup=3)
    fac_plain = event_ms(lambda: kipm.tree_factor_ref(f, diag))
    # the on-chip chain: the chain-only build on the same forest and lanes
    # (its results are not the function's)
    def launched(err):
        if err:
            fail(f"(d): the chain-only build's launch failed: cudaError {err}")

    scratch = [torch.empty_like(rs[2]), torch.empty_like(diag),
               torch.empty_like(diag)]
    on_solve = cuda_ms(lambda: launched(ops.launch_solve(
        chain, f, piv, gg, rs[2], scratch[0])), 50, warmup=3)
    on_fac = cuda_ms(lambda: launched(ops.launch_factor(
        chain, f, diag, *scratch[1:])), 50, warmup=3)
    W, (C, P, ck) = ops.window_positions(), ops.block_shape(f)
    misses = stage.window_misses(f, W)

    def layout():
        f._stage = f._gk = None
        stage.factor_layout(f)
        stage.solve_layout(f, gg)

    lay_ms = event_ms(layout, 10)
    sb, fb = tree_bounds(f, 2)["solve"], tree_bounds(f, 2)["factor"]
    sb1 = tree_bounds(f, 1)["solve"]
    per = lambda ms: ms * 1e3 / (2 * f.nlv)  # noqa: E731  µs a level a sweep
    say(f"(d) the tree kernels on (b)'s iteration-{last['iteration']} "
        f"forest ({f.nv} positions, {f.nlv} levels, the widest "
        f"{stage.widest_level(f)}, {int(f.ch.numel())} tree arcs): "
        f"mismatches against the plain versions {bad}; blocks of {C} "
        f"consumer and {P} producer warps, {ck} levels a ring slot, a window "
        f"of {W} positions, reads that miss it {misses}; "
        f"tree_solve R 2 {timing[2][0]:.6f} ms ({per(timing[2][0]):.4f} us "
        f"a level a sweep), R 1 {timing[1][0]:.6f} ms (plain "
        f"{timing[2][1]:.4f} / {timing[1][1]:.4f} ms, CUDA events, host gaps "
        f"included); bound R 2 {sb[0]:.6f} ms ({sb[1]}: {sb[2]} B, {sb[3]} "
        f"ops), R 1 {sb1[0]:.6f} ms; chains R 2: device memory 2 sweeps x "
        f"{f.nlv} levels x {TRIP_US} us = {sb[4]:.6f} ms, on chip (the "
        f"chain-only build) {on_solve:.6f} ms ({per(on_solve):.4f} us a "
        f"level a sweep; the kernel at {timing[2][0] / on_solve:.2f}x it); "
        f"tree_factor {fac_ms:.6f} ms (plain {fac_plain:.4f} ms), bound "
        f"{fb[0]:.6f} ms ({fb[1]}: {fb[2]} B, {fb[3]} ops), chains: device "
        f"memory {f.nlv} x {TRIP_US} us = {fb[4]:.6f} ms, on chip "
        f"{on_fac:.6f} ms (the kernel at {fac_ms / on_fac:.2f}x it); the "
        f"staged layout {lay_ms:.6f} ms an iteration (CUDA events, host "
        f"included); ptxas by consumer warps (this forest's {C}) tree_solve "
        f"{ {c: ptxas_of(f'tree_solve_kernelILi{c}E') for c in (1, 2, 4, 8)} }"
        f", tree_factor "
        f"{ {c: ptxas_of(f'tree_factor_kernelILi{c}E') for c in (1, 2, 4, 8)} }")
    if any(bad.values()):
        fail(f"(d): the tree kernels differ from their plain versions: {bad}")
    say(f"tree kernels' main-path launches ((b) and (c)): {rows_launches}")
    src = "src/repro_torch/kernels/ipm/csrc/tree_precond.cu"
    # no TPU kernel: the reference factors its Newton matrix with splu
    return [{"name": "tree_solve", "route": "cuda", "source": src,
             "replaces": "src/repro/core/ipm.py:89",
             "launches": rows_launches["tree_solve"],
             "max_abs_err": err["tree_solve"], "ms": timing[2][0],
             "plain_ms": timing[2][1], "bound_ms": sb[0], "bound_by": sb[1],
             "library_ms": None, "onchip_chain_ms": on_solve},
            {"name": "tree_factor", "route": "cuda", "source": src,
             "replaces": "src/repro/core/ipm.py:89",
             "launches": rows_launches["tree_factor"],
             "max_abs_err": err["tree_factor"], "ms": fac_ms,
             "plain_ms": fac_plain, "bound_ms": fb[0], "bound_by": fb[1],
             "library_ms": None, "onchip_chain_ms": on_fac}]


def bp_graphs(p):
    """Phase 10's breakpoint graphs: (label, graph, float32 policy)."""
    from repro_torch.core import synth
    from repro_torch.sweep import ExecPolicy
    px, py, it = BP_CG
    ranks, ops = BP_RANDOM
    return [(f"cg_like{BP_CG}", synth.cg_like(px, py, it, params=p),
             ExecPolicy(backend="sparse", dtype="float32")),
            (f"random_dag(rng 0, {ranks} ranks, {ops} ops)",
             synth.random_dag(np.random.default_rng(0), nranks=ranks,
                              nops=ops, params=p), ExecPolicy("dense"))]


# -- phase 11 ----------------------------------------------------------------

def topo_workload(topo, params):
    """``examples/topology_study.py``'s workload on the port: TOPO_STUDY's
    ranks x iterations of compute, then recursive-doubling exchanges, each
    message stamped with the topology's wire classes."""
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.core.topology import TopologyStamper
    nranks, iters, nbytes, comp_us = TOPO_STUDY
    stamp = TopologyStamper(topo, params)
    b = GraphBuilder(nranks, topo.nclasses)
    for _ in range(iters):
        for r in range(nranks):
            b.add_calc(r, comp_us)
        for k in range(8):
            for r in range(nranks):
                peer = r ^ (1 << k)
                if r < peer < nranks:
                    stamp.message(b, r, peer, nbytes)
                    stamp.message(b, peer, r, nbytes)
    return b.finalize()


def phase_traced(rows: dict) -> None:
    """Phase 11: the traced steps of the model stack and the topology study
    on the card.  ``rows``: the level-loop and walk rows, which gain this
    phase's launches."""
    import warnings
    from repro_torch import configs
    from repro_torch.core import dag, sensitivity, topology
    from repro_torch.core.tracer import TraceSpec, trace_step
    from repro_torch.models.config import TRAIN_4K
    from repro_torch.sweep import (Engine, estimate_dense_bytes,
                                   latency_grid, topology_variants)
    degr = (0.01, 0.02, 0.05)

    def rel(a, b):
        return 0.0 if a == b else float(abs(a - b) / abs(b))  # inf: 0

    # (a) the latency tolerance of the models' training steps
    pods, data, model, mfu = TRACE_SPEC
    ts = TraceSpec(pods=pods, data=data, model=model, mfu=mfu)
    p = ts.params()
    say(f"traced: TraceSpec(pods {pods}, data {data}, model {model}, mfu "
        f"{mfu}), {TRAIN_4K.name}; L {p.L} us ({p.class_names})")
    held_routes = set()
    for arch in TRACE_ARCHS:
        cfg, _ = configs.get(arch)
        g, t_trace = wall(lambda: trace_step(cfg, TRAIN_4K, ts))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng, t_eng = wall(lambda: Engine(g, params=p))
        auto = [w for w in caught if issubclass(w.category, RuntimeWarning)
                and "auto-switching" in str(w.message)]
        # past the dense-size guard the default Engine must warn and switch
        # to sparse float64; under it, it stays on segment float64
        est = estimate_dense_bytes(g)
        over = est > eng.MAX_DENSE_BYTES
        sparse = eng.sparse is not None
        route = "sparse float64" if sparse else "segment float64"
        if bool(auto) != over or sparse != over or (
                sparse and eng.arrays.dtype != torch.float64) or (
                not sparse and eng.policy.backend != "segment"):
            fail(f"{arch}: dense envelope {est >> 20} MiB, guard "
                 f"{eng.MAX_DENSE_BYTES >> 20} MiB, but the default Engine "
                 f"took {route} (warned: {bool(auto)})")
        plans = {"f64": eng.sparse} if sparse else {}
        loop = "sparse_levels_f64" if sparse else "segment_levels_f64"
        del eng
        an_run = lambda: sensitivity.analyze(g, p)  # noqa: E731
        rep, t_an, an_launches, runs, widths = counted(an_run)
        check_solver_launches(f"{arch} analyze", an_launches, runs, widths,
                              plans, rows)
        tol_run = lambda: sensitivity.latency_tolerance(  # noqa: E731
            g, p, degr, cls=1)
        tol, t_tol, launches, runs, widths = counted(tol_run)
        check_solver_launches(f"{arch} latency_tolerance", launches, runs,
                              widths, plans, rows)
        nfwd = sum(sum(r.values()) for r in runs.values())
        say(f"{arch}: {g.num_vertices} vertices, {g.num_edges} edges, "
            f"{g.nlevels} levels, dense envelope {est >> 20} MiB; route "
            f"{route}; trace {t_trace:.4f} s, Engine() {t_eng:.4f} s, "
            f"analyze {t_an:.4f} s, latency_tolerance {t_tol:.4f} s ({nfwd} "
            f"forwards, {launches[loop] / nfwd:g} level-loop launches and "
            f"{launches['sparse_backtrace'] / nfwd:g} walks a forward); "
            f"T {rep.T!r} us, lambda_ici {float(rep.lam[0])!r}, lambda_dcn "
            f"{float(rep.lam[1])!r}; dcn tolerance {tol}")
        if not (np.isfinite(rep.T) and rep.T > 0
                and 0 < tol[0.01] <= tol[0.02] <= tol[0.05]):
            fail(f"{arch}: T {rep.T} or tolerances {tol} out of order")
        if arch in TRACE_HELD:
            plan = dag.LevelPlan(g)
            s, t_dag = wall(lambda: plan.forward(p))
            want, t_dtol = wall(lambda: {d: dag.tolerance(
                g, p, d, cls=1, plan=plan) for d in degr})
            e_tol = max(rel(tol[d], want[d]) for d in degr)
            say(f"  {arch} against core.dag: T {s.T!r} ({t_dag:.4f} s a "
                f"forward), lambda {s.lam.tolist()}, bit-identical "
                f"{rep.T == s.T and np.array_equal(rep.lam, s.lam)}; "
                f"tolerance {want} ({t_dtol:.4f} s), relative {e_tol!r}")
            if rep.T != s.T or not np.array_equal(rep.lam, s.lam):
                fail(f"{arch}: T/lambda on the card differ from core.dag's")
            if not e_tol <= 1e-5:
                fail(f"{arch}: tolerances off core.dag's by {e_tol}")
        # the first step on each route held against the plain versions
        if arch == TRACE_HELD[0] or (not sparse and route not in held_routes):
            held(f"{arch} analyze", an_run, an_launches, rows)
            held_routes.add(route)
        del g

    # (b) the Fig 11 topology study
    topos = [topology.fat_tree(16), topology.dragonfly(8, 4, 8),
             topology.torus((16, 16))]
    variants, t_v = wall(lambda: topology_variants(topo_workload, topos))
    nranks, iters, nbytes, comp_us = TOPO_STUDY
    say(f"topology study: {nranks} ranks x {iters} iterations, "
        f"recursive-doubling exchanges of {nbytes:g} B, {comp_us:g} us of "
        f"compute; graphs built in {t_v:.4f} s")
    deltas = np.linspace(0.0, TOPO_RANK_DL, TOPO_RANK_POINTS)
    ranking = []
    for v in variants:
        g, pv = v.graph, v.params
        eng = Engine(g, params=pv)
        exact = not eng.policy.float32   # segment, sparse f64: bit-identical
        route = f"{eng.policy.backend} {'float64' if exact else 'float32'}"
        plans = {"f64": eng.sparse} if eng.sparse is not None else {}
        del eng

        def study():
            return (sensitivity.latency_curve(g, pv, [0.0]),
                    sensitivity.latency_tolerance(g, pv, (0.01,)),
                    Engine(g, params=pv).run(latency_grid(pv, deltas),
                                             compute_lam=False))
        (curve, tol, sweep), secs, launches, runs, widths = counted(study)
        check_solver_launches(f"{v.name} study", launches, runs, widths,
                              plans, rows)
        s = dag.LevelPlan(g).forward(pv)
        s_hi = dag.LevelPlan(g).forward(pv.with_delta(TOPO_RANK_DL, 0))
        want = dag.tolerance(g, pv, 0.01, cls=0)
        e_T, e_lam = rel(curve.T[0], s.T), rel(curve.lam[0], s.lam[0])
        e_tol, e_hi = rel(tol[0.01], want), rel(sweep.T[-1], s_hi.T)
        say(f"{v.name}: {g.num_vertices} vertices, {g.nclass} wire "
            f"class(es); route {route}, {secs:.4f} s; T {float(curve.T[0])!r} "
            f"us, lambda_wire0 {float(curve.lam[0])!r}, 1 % tolerance "
            f"{tol[0.01]!r} us; core.dag T {s.T!r}, lambda "
            f"{float(s.lam[0])!r}, "
            f"tolerance {want!r}; relative T {e_T!r}, lambda {e_lam!r}, "
            f"tolerance {e_tol!r}, T at +{TOPO_RANK_DL} us {e_hi!r}")
        lim = 0.0 if exact else 1e-5
        if max(e_T, e_lam, e_hi) > lim or not e_tol <= 1e-5:
            fail(f"{v.name}: off core.dag beyond the {route} contract")
        ranking.append((v.name, float(sweep.T[-1])))
    ranking.sort(key=lambda kv: kv[1])
    say(f"fastest fabric at +{TOPO_RANK_DL} us a wire ({TOPO_RANK_POINTS} "
        f"points): {ranking}")


# -- phase 12 ----------------------------------------------------------------

def lane_extras(g, K: int, seed: int) -> np.ndarray:
    """[K, ne] nonnegative extra edge costs (µs) on ``g``'s message edges
    (those that carry a latency), 0 elsewhere, from a numpy seed: stand-ins
    for a placement step's K swap candidates (``mapping_edge_cost``)."""
    msg = g.elat.sum(1) > 0
    return np.random.default_rng(seed).uniform(
        0.0, 10.0, (K, g.num_edges)) * msg


def rebuilt(g, keep: np.ndarray, extra: np.ndarray):
    """``g`` rebuilt from the ground up: only the kept edges, ``extra``
    added to their constants, the levels recomputed (a tighter schedule
    than the envelope a structure patch keeps)."""
    from repro_torch.core.graph import _topo_levels
    esrc, edst = g.esrc[keep], g.edst[keep]
    nv = g.num_vertices
    level = _topo_levels(nv, esrc, edst)
    in_ptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(edst, minlength=nv), out=in_ptr[1:])

    def cut(a):
        return None if a is None else a[keep]

    return dataclasses.replace(
        g, esrc=esrc, edst=edst, econst=(g.econst + extra)[keep],
        ebytes=g.ebytes[keep], elat=g.elat[keep], egap=cut(g.egap),
        egclass=cut(g.egclass), elink=cut(g.elink), in_ptr=in_ptr,
        in_edge=np.argsort(edst, kind="stable").astype(np.int32),
        level=level, nlevels=int(level.max(initial=0)) + 1)


def lane_query(label: str, eng, query, structures: int,
               rows: dict) -> tuple:
    """One values and one λ run of ``query`` on ``eng`` with the lane
    kernels' counters and the packed forwards' runs at 0: one level-loop
    launch a forward and one walk for the λ forward, whatever the lanes
    (``rows`` gain them); walls, peak memory; a profile of each kind,
    whose kernels must stay under ``F64_FORWARD_KERNELS`` a structure (a
    bound that does not grow with K); then both runs again with every
    launch held against its plain version (``held``).  Returns (the λ
    result, a dict of the numbers)."""
    from repro_torch.kernels import maxplus
    from repro_torch.sweep.engine import (dense_forward_multi,
                                          segment_forward_multi)
    segment = eng.policy.backend == "segment"
    loop = "segment_levels_f64" if segment else "dense_levels_f32"
    fwd = segment_forward_multi if segment else dense_forward_multi
    counters = {n: getattr(maxplus, n) for n in LANE_KERNELS}
    for k in counters.values():
        k.launches = 0
    fwd.runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vals, t_vals = wall(lambda: eng.run(query, compute_lam=False))
    res, t_lam = wall(lambda: eng.run(query))
    peak = torch.cuda.max_memory_allocated()
    launches = {n: k.launches for n, k in counters.items()}
    runs = dict(fwd.runs)
    want = dict.fromkeys(LANE_KERNELS, 0)
    want[loop], want["sparse_backtrace"] = 2, 1
    lanes = int(np.prod(res.T.shape[:-1]))
    say(f"{label}: axes {res.axes} {res.T.shape} ({lanes} lanes); forwards "
        f"{runs}; launches {launches} (a forward: level loop "
        f"{launches[loop] / 2:g}, walk {launches['sparse_backtrace']:g} a λ "
        f"forward); wall λ {t_lam:.4f} s, values {t_vals:.4f} s (the first "
        f"run, which stages the lanes and any structure batch); peak "
        f"device memory {peak} B ({peak / 2**20:.1f} MiB; {base} B "
        f"allocated before)")
    if launches != want or runs != {"values": 1, "lam": 1}:
        fail(f"{label}: launches {launches} and forwards {runs} != one "
             f"level loop a forward and one walk a λ forward: {want}")
    for n in LANE_KERNELS:
        add_launches(rows[n], launches[n])
    if not (np.array_equal(vals.T, res.T) and vals.lam is None
            and np.isfinite(res.T).all() and np.isfinite(res.lam).all()):
        fail(f"{label}: the values run differs, or non-finite values")
    out = {"t_lam": t_lam, "t_vals": t_vals, "peak": peak, "lanes": lanes}
    for kind, lam_run in (("values", False), ("λ", True)):
        prof = {}
        profile_forward(f"{label} {kind}",
                        lambda: eng.run(query, compute_lam=lam_run),
                        focus=(loop, "sparse_backtrace"), stats=prof)
        limit = F64_FORWARD_KERNELS * structures
        if prof and prof["kernels"] > limit:
            fail(f"{label}: a {kind} forward launched {prof['kernels']} "
                 f"kernels, more than {limit} (the bound does not grow "
                 f"with K)")
        out[kind] = prof
    held(label, lambda: (eng.run(query, compute_lam=False), eng.run(query)),
         launches, {n: rows[n] for n in (loop, "sparse_backtrace")})
    return res, out


def phase_lanes(g, p, study, study_res, rows: dict) -> None:
    """Phase 12: the candidate-cost (K) and structure-variant (B) axes of
    ``Engine.run(Query(...))`` at full width.  1, placement's shape: K 64
    cost blocks of extras on phase 4's message edges at S 4, values and
    λ, on segment and dense, each lane against a solo forward of
    ``compile_plan(g, p, extra_edge_cost=extras[k])``; 2, phase 7's four
    allreduce plans with K 4 blocks a graph (G×K), S 16, λ, on segment,
    each lane against its solo rebuild; 3, ``StructureBatch.from_plans``
    over the same four plans (B 4, S 256) against phase 7's packed G
    results (``study_res``), and ``patch_structure`` on phase 4's stencil
    (B 4 variants, each dropping 1 % of the message edges, × K 4, S 16)
    against ``core.dag`` on each rebuilt graph.  Every run: one level-loop
    launch and one walk a forward, its kernels under a bound that does not
    grow with K, every launch held against its plain version; walls,
    profiled busy shares, peak memory.  ``rows``: the lane kernels' rows,
    which gain the launches."""
    from repro_torch.core import dag
    from repro_torch.sweep import (Engine, ExecPolicy, Query, StructureBatch,
                                   compile_plan, latency_grid)
    seg = ExecPolicy("segment")
    K, S = PLACEMENT
    ex = lane_extras(g, K, 12)
    batch = latency_grid(p, np.linspace(0.0, 100.0, S))
    say(f"phase 12, placement's shape: phase 4's stencil, K {K} cost blocks "
        f"on its {int((g.elat.sum(1) > 0).sum())} message edges, S {S}")
    for pol in (seg, ExecPolicy("dense")):
        be = pol.backend
        eng = Engine(g, params=p, policy=pol)
        res, nums = lane_query(f"placement ({be})", eng,
                               Query(batch, costs=ex), 1, rows)
        t0 = time.perf_counter()
        worst, equal = 0.0, 0
        for k in range(K):
            solo = Engine(compile_plan(g, p, extra_edge_cost=ex[k]),
                          policy=pol).run(batch)
            same = all(np.array_equal(getattr(res, f)[k], getattr(solo, f))
                       for f in ("T", "lam", "rho"))
            equal += same
            rel = float((np.abs(res.T[k] - solo.T) / solo.T).max())
            worst = max(worst, rel)
            if be == "segment" and not same:
                fail(f"placement (segment): lane {k} differs from its solo "
                     "rebuild")
            if rel > 1e-5 or not np.array_equal(res.lam[k], solo.lam):
                fail(f"placement ({be}): lane {k} off its solo rebuild")
        t_solo = time.perf_counter() - t0
        best = res.argbest()
        say(f"placement ({be}): {equal} of {K} lanes bit-equal to their solo "
            f"rebuilds (T, λ, ρ), max |dT| / T {worst!r}; {K} solo rebuilds "
            f"(compile, stage, run) {t_solo:.2f} s against one λ lane "
            f"forward {nums['t_lam']:.4f} s; best candidate {best}: mean T "
            f"{res.T[best].mean()!r} us (candidate 0 {res.T[0].mean()!r})")
        del eng, res

    KG, SG = STUDY_GK
    variants, p7, _ = study
    policy = ExecPolicy("segment", max_dense_bytes=STUDY_MAX_DENSE)
    names = [v.name for v in variants]
    exs = [lane_extras(v.graph, KG, 20 + i) for i, v in enumerate(variants)]
    b16 = latency_grid(p7, np.linspace(0.0, 100.0, SG))
    eng = Engine([(v.graph, v.params) for v in variants], names=names,
                 policy=policy)
    res, _ = lane_query("study G x K (segment)", eng, Query(b16, costs=exs),
                        len(variants), rows)
    for gi, v in enumerate(variants):
        for k in range(KG):
            solo = Engine(compile_plan(v.graph, v.params,
                                       extra_edge_cost=exs[gi][k]),
                          policy=policy).run(b16)
            if not all(np.array_equal(getattr(res, f)[gi, k],
                                      getattr(solo, f))
                       for f in ("T", "lam", "rho")):
                fail(f"study G x K: lane ({v.name}, {k}) differs from its "
                     "solo rebuild")
    say(f"study G x K: every one of {len(variants)} x {KG} lanes bit-equal "
        "to its solo rebuild (T, λ, ρ)")
    del eng, res

    sb = StructureBatch.from_plans(
        [compile_plan(v.graph, v.params) for v in variants], names=names)
    eng = Engine(sb, policy=policy)
    b256 = latency_grid(p7, np.linspace(0.0, 100.0, CURVE_POINTS))
    res, _ = lane_query("from_plans B (segment)", eng, Query(b256),
                        len(variants), rows)
    if res.axes != ("B", "S") or res.names != tuple(names) or not (
            np.array_equal(res.T, study_res["T"])
            and np.array_equal(res.lam, study_res["lam"])):
        fail("from_plans B: differs from phase 7's packed G results")
    say("from_plans B: T and λ bit-equal to phase 7's packed segment study")
    del eng, res, sb

    B, KB, SB, share = STRUCT_PATCH
    rng = np.random.default_rng(31)
    msg = np.flatnonzero(g.elat.sum(1) > 0)
    keep = np.ones((B, g.num_edges), dtype=bool)
    for b in range(B):
        keep[b, rng.choice(msg, size=round(share * msg.size),
                           replace=False)] = False
    exb = lane_extras(g, KB, 32)
    plan = compile_plan(g, p)
    b16 = latency_grid(p, np.linspace(0.0, 100.0, SB))
    eng = Engine(plan, policy=seg)
    res, _ = lane_query("patch_structure B x K (segment)", eng,
                        Query(b16, structure=plan.patch_structure(keep=keep),
                              costs=exb), B, rows)
    t0 = time.perf_counter()
    for b in range(B):
        for k in range(KB):
            gb = rebuilt(g, keep[b], exb[k])
            lp = dag.LevelPlan(gb)
            out = [lp.forward(p.replace(L=tuple(b16.L[i])))
                   for i in range(SB)]
            want = (np.array([o.T for o in out]),
                    np.stack([o.lam for o in out]),
                    np.stack([o.rho() for o in out]))
            if not all(np.array_equal(getattr(res, f)[b, k], w)
                       for f, w in zip(("T", "lam", "rho"), want)):
                fail(f"patch_structure B x K: lane ({b}, {k}) differs from "
                     "core.dag on its rebuilt graph")
    dropped = int((~keep[0]).sum())
    say(f"patch_structure B x K: {B} variants (each {dropped} message edges "
        f"dropped, {plan.nlevels} envelope levels; the last rebuilt "
        f"{gb.nlevels}) x {KB} cost blocks, every lane bit-equal to "
        f"core.dag on its rebuilt graph (T, λ, ρ; "
        f"{time.perf_counter() - t0:.2f} s)")
    del eng, res
    owned_lanes(rows)


def owned_lanes(rows: dict) -> None:
    """Phase 12's K lanes that own their gap shares, gap classes and
    latency rows: phase 4's stencil built under K two-class pod models
    whose rank-to-class maps differ (``OWNED_PODS``), its K plans' fields
    stacked as one hand-assembled CostBatch, S 4 with unequal gap scales a
    class, values and λ on segment and dense: each lane against the solo
    forward of its own plan (segment bit for bit, dense within 1e-5 and
    λ equal), one level-loop launch a forward and one walk a λ forward,
    every launch held against its plain version."""
    from repro_torch.core import synth
    from repro_torch.core.loggps import pod_model
    from repro_torch.sweep import (CostBatch, Engine, ExecPolicy, Query,
                                   compile_plan, latency_grid)
    S = PLACEMENT[1]
    models = [pod_model(pod_size=s).params() for s in OWNED_PODS]
    (plans, t_build) = wall(lambda: [compile_plan(synth.stencil2d(
        16, 16, 10, halo_bytes=64e3, comp_us=500.0, params=m), m)
        for m in models])
    cb = CostBatch(**{f: np.stack([getattr(pl, f) for pl in plans])
                      for f in ("econst", "egap", "egclass", "elat")},
                   plan_hash=None)
    batch = latency_grid(models[0], np.linspace(0.0, 100.0, S))
    batch = dataclasses.replace(batch, gscale=batch.gscale
                                * np.asarray(OWNED_GSCALE))
    differ = [f for f in ("egap", "egclass", "elat")
              if (getattr(cb, f) != getattr(cb, f)[:1]).any()]
    say(f"phase 12, owned lanes: phase 4's stencil under {len(plans)} "
        f"two-class pod models (pods of {OWNED_PODS} ranks), built and "
        f"compiled in {t_build:.2f} s; the blocks' {differ} differ; S {S}, "
        f"gap scales {OWNED_GSCALE}")
    if differ != ["egap", "egclass", "elat"]:
        fail(f"owned lanes: only {differ} differ across the pod models")
    for pol in (ExecPolicy("segment"), ExecPolicy("dense")):
        be = pol.backend
        eng = Engine(plans[0], policy=pol)
        res, nums = lane_query(f"owned lanes ({be})", eng,
                               Query(batch, costs=cb), 1, rows)
        worst = 0.0
        for k, pl in enumerate(plans):
            solo = Engine(pl, policy=pol).run(batch)
            same = all(np.array_equal(getattr(res, f)[k], getattr(solo, f))
                       for f in ("T", "lam", "rho"))
            rel = float((np.abs(res.T[k] - solo.T) / solo.T).max())
            worst = max(worst, rel)
            if (be == "segment" and not same) or rel > 1e-5 \
                    or not np.array_equal(res.lam[k], solo.lam):
                fail(f"owned lanes ({be}): lane {k} (pods of "
                     f"{OWNED_PODS[k]}) differs from its own plan's solo "
                     "forward")
        say(f"owned lanes ({be}): all {len(plans)} lanes against their own "
            f"plans' solo forwards, max |dT| / T {worst!r}; T at the last "
            f"scenario {[float(t) for t in res.T[:, -1]]}; one λ lane "
            f"forward {nums['t_lam']:.4f} s")
        del eng, res


def phase_congestion(g4, p4, rows: dict) -> None:
    """Phase 13 (the module docstring says what it checks).  ``g4``,
    ``p4``: phase 4's stencil and params, whose segment λ query the result
    cache repeats; ``rows``: the level-loop and walk rows, which gain the
    link-factor kernel's numbers and the phase's launches."""
    from repro_torch.core import simulator, synth
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.core.loggps import pod_model
    from repro_torch.kernels import maxplus
    from repro_torch.kernels.maxplus import segment_levels_f64_ref
    from repro_torch.sweep import (Engine, ExecPolicy, Query, ScenarioBatch,
                                   SweepCache, base_batch, compile_plan,
                                   detached_engine_stats, latency_grid, run)
    from repro_torch.sweep import engine as eng
    cuda = torch.device("cuda")
    seg_row, walk_row = rows["segment_levels_f64"], rows["sparse_backtrace"]
    counters = (maxplus.segment_levels_f64, maxplus.sparse_backtrace)
    pc = pod_model(pod_size=64, ranks_per_host=4, alpha=CONG_ALPHA).params()
    p0 = pod_model(pod_size=64, ranks_per_host=4).params()
    g = synth.stencil2d(16, 16, 10, halo_bytes=64e3, comp_us=500.0,
                        params=pc)
    plan = compile_plan(g, pc)
    S = CURVE_POINTS
    nc = pc.nclass
    batch = latency_grid(pc, np.linspace(0.0, 100.0, S))
    say(f"phase 13: phase 4's stencil under pod_model(64, 4, alpha="
        f"{CONG_ALPHA}): {g.num_vertices} vertices, {plan.nlevels} levels, "
        f"{plan.nlinks} links, {nc} classes, S {S}")

    # -- the link factor in the level loop, against its plain version ------
    a = eng.stage_segment(plan, cuda)
    a.links = eng.stage_links(plan, a)
    LG = [torch.from_numpy(x).cuda() for x in (batch.L, batch.gscale)]
    ls = torch.from_numpy(np.random.default_rng(13).uniform(
        1.0, 3.0, (plan.nlinks + 1, S))).cuda()
    ls[-1] = 1.0
    nlv = plan.nlevels
    args = eng.segment_inputs(a)

    def link_kw(factor: bool) -> dict:
        return (dict(ls=ls, elink=a.links.elink, in_link=a.links.in_link)
                if factor else {})

    def fresh(want_lam: bool):
        return eng._state(tuple(a.valid_flat.shape), S, want_lam, cuda,
                          torch.float64)

    err = 0.0
    for want_lam in (False, True):
        got, want = fresh(want_lam), fresh(want_lam)
        maxplus.segment_levels_f64(*got[:3], *LG, *args, 0, nlv, got[3],
                                   **link_kw(True))
        segment_levels_f64_ref(*want[:3], *LG, *args[:8], 0, nlv, want[3],
                               ls, a.links.elink)
        torch.cuda.synchronize()
        miss = mismatches(got, want)
        e = float((got[0] - want[0]).abs().max())
        say(f"check segment_levels_f64 with the link factor, phase 13's "
            f"plan S {S} {'λ' if want_lam else 'values'}: max|kernel-plain| "
            f"{e}, mismatches {miss}")
        if any(miss.values()) or e != 0.0:
            fail("segment_levels_f64 with the link factor differs from its "
                 "plain version")
        err = max(err, e)
        del got, want
    times = {}
    for factor in (False, True):
        for want_lam in (False, True):
            st = fresh(want_lam)
            kw = link_kw(factor)
            times[(factor, want_lam)] = cuda_ms(
                lambda: maxplus.segment_levels_f64(
                    *st[:3], *LG, *args, 0, nlv, st[3], **kw),
                reps=10, warmup=2)
            del st
    lp = a.lv_ptr.cpu().numpy()
    rp = a.row_ptr.cpu().numpy()
    ne, nr = int(rp[lp[nlv]] - rp[lp[0]]), int(lp[nlv] - lp[0])
    # phase 3's bound() count, and with the factor the scales [nl1, S] and
    # each edge's link id, each read once; the kernel reads a scale once an
    # edge and a scenario (from L2: the table is small), printed beside
    nl1 = plan.nlinks + 1
    base_bytes = ((8 + 8 + 4 + 4) * nr * S + (16 + 8 * (3 + nc)) * ne
                  + (4 + 4 + 8) * nr + 4 * (nlv + 1) + 8 * S * 2 * nc)
    link_bytes = base_bytes + 8 * nl1 * S + 4 * ne
    b_ms = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in
            (("plain", base_bytes), ("factor", link_bytes))}
    say(f"time segment_levels_f64 on phase 13's plan at S {S} (1 launch, "
        f"{ne} edges, {nr} listed rows, {nl1} link bins): without the "
        f"factor λ {times[(False, True)]:.6f} ms, values "
        f"{times[(False, False)]:.6f} ms; with the factor λ "
        f"{times[(True, True)]:.6f} ms, values {times[(True, False)]:.6f} "
        f"ms; bytes bound {b_ms['plain']:.6f} ms without, "
        f"{b_ms['factor']:.6f} ms with ({link_bytes} B: the scales and "
        f"link ids once); the scales' re-reads, one an edge and a scenario, "
        f"{8 * ne * S} B (from L2); ptxas with the factor "
        f"{ptxas_of('segment_levels_f64_kernelILb1')}, without "
        f"{ptxas_of('segment_levels_f64_kernelILb0')}")
    seg_row["congestion"] = {
        "ms": times[(True, True)], "ms_values": times[(True, False)],
        "ms_without": times[(False, True)],
        "ms_values_without": times[(False, False)],
        "bound_ms": b_ms["factor"], "bound_by": "bytes",
        "max_abs_err": err}
    plain4 = seg_row["ms"]
    say(f"segment_levels_f64 without congestion on phase 4's plan: phase 3 "
        f"{plain4:.6f} ms against {SEG_MS_NO_LINKS} ms before the factor "
        f"({plain4 / SEG_MS_NO_LINKS:.4f}x; limit {SEG_SLACK}x)")
    if plain4 > SEG_SLACK * SEG_MS_NO_LINKS:
        fail(f"segment_levels_f64 without congestion took {plain4:.6f} ms, "
             f"over {SEG_SLACK} x its {SEG_MS_NO_LINKS} ms before the "
             "factor")
    del a, ls, LG
    gc.collect()
    torch.cuda.empty_cache()

    # -- α = 0: the plain forward --------------------------------------------
    plan0 = compile_plan(g, p0)
    r_plain0 = Engine(plan0, params=p0).run(batch)
    r_zero = Engine(plan0, params=p0,
                    policy=ExecPolicy(congestion="fixed_point")).run(batch)
    same0 = all(np.array_equal(getattr(r_zero, f), getattr(r_plain0, f))
                for f in ("T", "lam", "rho"))
    say(f"alpha = 0: T, λ, ρ bit-equal to the plain forward: {same0}; "
        f"iterations {sorted(set(r_zero.congestion_iters.tolist()))}")
    if not same0 or (r_zero.congestion_iters != 1).any():
        fail("congestion with alpha = 0 differs from the plain forward")

    # -- the congested fixed point at S 256 -----------------------------------
    mi, tol = CONG_ITERS
    pol = ExecPolicy(congestion="fixed_point", max_iters=mi, tol=tol)
    e = Engine(plan, params=pc, policy=pol)
    plain_eng = Engine(plan, params=pc)
    plain, t_plain = wall(lambda: plain_eng.run(batch))
    e.run(batch)                              # stages the links
    for k in counters:
        k.launches = 0
    eng.congestion_forward.runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    res, t_cong = wall(lambda: e.run(batch))
    peak = torch.cuda.max_memory_allocated()
    launches = [k.launches for k in counters]
    runs = dict(eng.congestion_forward.runs)
    its = res.congestion_iters
    n_it = max(runs.get("iterations", 0), 1)
    ratio = res.T / plain.T
    say(f"congested S {S}: iterations min {its.min()} max {its.max()} "
        f"(limit {mi}, tol {tol}); launches: level loop {launches[0]}, walk "
        f"{launches[1]}; runs {runs}: {launches[0] / n_it:.4f} level-loop "
        f"launches and {runs.get('syncs', 0) / n_it:.4f} host syncs an "
        f"iteration; wall {t_cong:.4f} s (the plain λ forward "
        f"{t_plain:.4f} s); peak {peak} B ({peak / 2**20:.1f} MiB; "
        f"{base_mem} B allocated before); T / plain T {ratio.min()!r} .. "
        f"{ratio.max()!r}")
    if its.max() >= mi or (res.T < plain.T).any() or \
            launches != [runs.get("iterations", 0) + 1, 1] or \
            runs.get("syncs") != runs.get("iterations"):
        fail("congested run: not converged, T below the plain T, or the "
             "launches are not one level loop an iteration and one more")
    add_launches(seg_row, launches[0])
    add_launches(walk_row, launches[1])
    prof = {}
    profile_forward("phase 13 congested λ", lambda: e.run(batch),
                    focus=("segment_levels_f64", "sparse_backtrace"),
                    stats=prof)
    rows_cpu = list(CONG_CPU_ROWS)
    sub = ScenarioBatch(L=batch.L[rows_cpu], gscale=batch.gscale[rows_cpu])
    host, t_cpu = wall(lambda: Engine(plan, params=pc, policy=pol,
                                      device="cpu").run(sub))
    same = (np.array_equal(res.T[rows_cpu], host.T)
            and np.array_equal(res.lam[rows_cpu], host.lam)
            and np.array_equal(its[rows_cpu], host.congestion_iters))
    say(f"congested: scenarios {rows_cpu} bit-equal (T, λ, iterations) to "
        f"the CPU's fixed point: {same} (CPU {t_cpu:.2f} s)")
    if not same:
        fail("the card's fixed point differs from the CPU's")
    del e, res, host, plain_eng
    gc.collect()
    torch.cuda.empty_cache()

    # -- K under congestion ------------------------------------------------
    K, SK, held_lanes = CONG_LANES
    ex = lane_extras(g, K, 13)
    bk = latency_grid(pc, np.linspace(0.0, 100.0, SK))
    ek = Engine(plan, params=pc, policy=pol)
    for k in counters:
        k.launches = 0
    rk, t_k = wall(lambda: ek.run(Query(bk, costs=ex)))
    add_launches(seg_row, counters[0].launches)
    add_launches(walk_row, counters[1].launches)
    for k in held_lanes:
        solo = Engine(plan.with_extra_cost(ex[k]), params=pc,
                      policy=pol).run(bk)
        if not (np.array_equal(rk.T[k], solo.T)
                and np.array_equal(rk.lam[k], solo.lam)
                and np.array_equal(rk.congestion_iters[k],
                                   solo.congestion_iters)):
            fail(f"congested K lane {k} differs from its solo rebuild")
    say(f"congested K {K} x S {SK}: lanes {held_lanes} bit-equal (T, λ, "
        f"iterations) to solo congested runs of their rebuilt plans; "
        f"iterations {rk.congestion_iters.min()}..{rk.congestion_iters.max()}"
        f"; wall {t_k:.4f} s")
    del ek, rk

    # -- the incast against the DES contention injector -------------------
    pi = pod_model(pod_size=1, alpha={"dcn": 1.0}).params()
    bld = GraphBuilder(nclass=pi.nclass, nranks=2)
    for _ in range(6):
        bld.add_message(0, 1, nbytes=1e6, params=pi)
    gi = bld.finalize()
    bi = base_batch(pi)
    base_T = float(Engine(gi, params=pi).run(bi).T[0])
    cong_T = float(Engine(gi, params=pi, policy=pol).run(bi).T[0])
    sim_T = simulator.simulate(gi, pi, injector="contention").T
    say(f"incast: plain T {base_T!r} us, congested T {cong_T!r} us, DES "
        f"contention T {sim_T!r} us")
    if not abs(cong_T - sim_T) < abs(base_T - sim_T):
        fail("the congested incast is not closer to the DES than the plain")

    # -- fd λ at S 256 on segment and dense --------------------------------
    h = ExecPolicy().fd_eps
    for backend in ("segment", "dense"):
        e_x = Engine(plan, params=pc, policy=ExecPolicy(backend))
        exact = e_x.run(batch)
        e_fd = Engine(plan, params=pc, policy=ExecPolicy(backend, lam="fd"))
        fd, t_fd = wall(lambda: e_fd.run(batch))
        gap = np.abs(fd.lam - exact.lam)
        if not np.array_equal(fd.T, exact.T):
            fail(f"fd λ ({backend}): T differs from the exact run's")
        if backend == "dense":
            say(f"fd λ (dense, S {S}, {S * (nc + 1)} expanded scenarios): T "
                f"bit-equal to exact; largest |λ_fd - λ_exact| {gap.max()!r};"
                f" wall {t_fd:.4f} s")
            continue
        away = np.ones(S, dtype=bool)
        for c in range(nc):
            Lc = batch.L.copy()
            Lc[:, c] += h
            probe = e_x.run(ScenarioBatch(L=Lc, gscale=batch.gscale))
            away &= (probe.lam == exact.lam).all(1)
        worst = float(gap[away].max()) if away.any() else 0.0
        say(f"fd λ (segment, S {S}, {S * (nc + 1)} expanded scenarios): T "
            f"bit-equal to exact; {int(away.sum())} of {S} scenarios with no "
            f"kink within the fd step: largest |λ_fd - λ_exact| there "
            f"{worst!r} (all scenarios {gap.max()!r}); wall {t_fd:.4f} s")
        if worst > 1e-6 or not away.any():
            fail("fd λ on segment is off exact λ away from a breakpoint")
        del e_x, e_fd

    # -- the result cache and the detached engine -------------------------
    b4 = latency_grid(p4, np.linspace(0.0, 100.0, S))
    cache = SweepCache()
    e4 = Engine(g4, params=p4, policy=ExecPolicy(cache=cache))
    first = e4.run(b4)
    for k in counters:
        k.launches = 0
    hit, t_hit = wall(lambda: e4.run(b4))
    n_hit = [k.launches for k in counters]
    same = hit.from_cache and all(
        np.array_equal(getattr(hit, f), getattr(first, f))
        for f in ("T", "lam", "rho"))
    say(f"cache: a repeat of phase 4's segment λ query from_cache "
        f"{hit.from_cache}, bit-equal {same}, launches {n_hit}, wall "
        f"{t_hit * 1e3:.3f} ms; stats {cache.stats.snapshot()}")
    if not same or any(n_hit):
        fail("the cached repeat differs or launched a kernel")
    before = detached_engine_stats()
    r1 = run(Query(b4, graphs=g4, params=p4))
    r2 = run(Query(b4, graphs=g4, params=p4))
    after = detached_engine_stats()
    say(f"detached run twice: stats {before} -> {after}")
    if after["hits"] - before["hits"] != 1 or \
            after["misses"] - before["misses"] != 1 or \
            not np.array_equal(r1.T, r2.T) or \
            not np.array_equal(r1.T, first.T):
        fail("the detached engine was not built once and reused")
    del e4
    gc.collect()
    torch.cuda.empty_cache()


def faulted_graph(g, p, ax, cell):
    """The graph and params of one ``fault_axes`` cell rebuilt for
    ``core.dag``: the cell's extras (and γ − 1 times the edges' gap shares)
    added to the edge constants, the failed rank's message edges dropped
    (a structure variant's mask), the scenario's L."""
    from repro_torch.core.graph import edge_gap_shares
    b, k, s = cell
    econst = g.econst.copy()
    if ax.extras is not None and k:
        econst = econst + ax.extras[k]
    gs = ax.scenarios.gscale[s]
    if (gs != 1.0).any():
        egap, egclass = edge_gap_shares(g, p)
        econst = egap * (gs[egclass] - 1.0) + econst
    keep = np.ones(g.num_edges, bool)
    if b:
        base = ax.structure.base
        keep = ax.structure.emask[b][base.epos_lvl, base.epos_e]
    return (rebuilt(dataclasses.replace(g, econst=econst), keep, 0.0),
            p.replace(L=tuple(ax.scenarios.L[s])))


def dag_T(g, extra, points) -> np.ndarray:
    """``core.dag``'s T of ``g`` with ``extra`` in its edge constants at
    each LogGPS point."""
    from repro_torch.core import dag
    lp = dag.LevelPlan(with_extra(g, extra))
    return np.array([lp.forward(pt).T for pt in points])


def with_extra(g, extra):
    """``g`` with ``extra`` added to its edge constants (the add the
    engine's cost lanes make before the latency term)."""
    return g if extra is None else dataclasses.replace(
        g, econst=g.econst + extra)


class QueryLog:
    """``Engine.run`` wrapped for one phase: each call's wall, its query,
    its result and the level-loop and walk launches it made."""

    def __init__(self):
        from repro_torch.kernels import maxplus
        from repro_torch.sweep import api
        self.api, self.maxplus = api, maxplus
        self.calls: list = []
        self._run = api.Engine.run

    def __enter__(self):
        log, run = self, self._run
        loops = [getattr(self.maxplus, n) for n in LANE_KERNELS]

        def logged(eng, query=None, **kw):
            n0 = [k.launches for k in loops]
            res, secs = wall(lambda: run(eng, query, **kw))
            log.calls.append({
                "engine": eng, "query": query, "kw": kw, "res": res,
                "secs": secs, "launches": {
                    k.__name__: k.launches - n for k, n in zip(loops, n0)}})
            return res
        self.api.Engine.run = logged
        return self

    def __exit__(self, *exc):
        self.api.Engine.run = self._run
        return False

    def launches(self, name: str) -> list:
        return [c["launches"][name] for c in self.calls]


def phase_consumers(g4, p4, rows: dict) -> dict:
    """Phase 14 (the module docstring says what it checks): the Engine's
    consumers at full width under ``obs.collect()``.  ``g4``, ``p4``: phase
    4's stencil and params; ``rows``: the level-loop and walk rows, which
    gain the phase's launches.  Returns the placement search's inputs and
    history and the fault distribution with its answers, which phase 15
    asks the analysis service for."""
    from repro_torch import explore, obs
    from repro_torch.core import dag, placement, sensitivity, synth
    from repro_torch.core.graph import CALC
    from repro_torch.core.loggps import LogGPS
    from repro_torch.kernels import maxplus
    from repro_torch.sweep import (DeviceFault, ExecPolicy, LinkFault,
                                   StragglerFault, SweepCache, fault_axes,
                                   latency_grid, recovery_cost_us)
    loops = {n: getattr(maxplus, n) for n in LANE_KERNELS}
    seg, walk = "segment_levels_f64", "sparse_backtrace"

    def zero_counts():
        for k in loops.values():
            k.launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def main_path_launches(label: str) -> dict:
        n = {name: k.launches for name, k in loops.items()}
        for name in LANE_KERNELS:
            add_launches(rows[name], n[name])
        say(f"  {label}: main-path launches {n}")
        return n

    with obs.collect() as spans:
        # -- placement: Algorithm 3 in the shape of phase 12's lanes --------
        P, pod, deltas, topk, iters = PLACE_SEARCH
        zero = p4.replace(L=(0.0,), G=(0.0,))
        gz = synth.stencil2d(*PLACE_GRAPH, halo_bytes=64e3, comp_us=500.0,
                             params=zero)
        phi = placement.ArchTopology.two_tier(P, pod=pod)
        pts = placement.latency_points(zero, deltas)
        pi0 = placement.random_mapping(P, PLACE_SEED)
        say(f"placement: stencil2d{PLACE_GRAPH} under zero link costs, "
            f"{gz.num_vertices} vertices, {int((gz.ebytes > 0).sum())} "
            f"message edges; two_tier({P}, pod={pod}), ΔL {deltas} (S "
            f"{len(pts)}), topk {topk} (K {topk}), max_iters {iters}, a "
            f"random start (seed {PLACE_SEED})")
        zero_counts()
        st = {}
        with QueryLog() as ql:
            (pi, hist), secs = wall(lambda: placement.place(
                gz, phi, params=zero, pi0=pi0.copy(), scenarios=pts,
                topk=topk, max_iters=iters, stats=st))
        peak = torch.cuda.max_memory_allocated()
        n = main_path_launches("placement")
        q = [c["secs"] for c in ql.calls]
        calls = len(ql.calls)
        say(f"  stats {st}; T {hist[0]:.6f} → {hist[-1]:.6f} µs over "
            f"{st['steps']} steps ({calls} engine calls); wall {secs:.4f} "
            f"s: {secs / max(calls, 1):.4f} s a step, of which the query "
            f"{np.mean(q):.4f} s (min {min(q):.4f}, max {max(q):.4f}) and "
            f"the host (core.dag forwards, pairwise_counts, the gain "
            f"matrix) {(secs - sum(q)) / max(calls, 1):.4f} s; peak device "
            f"memory {peak} B ({peak / 2**20:.1f} MiB)")
        if st["plan_compiles"] != 1 or st["scalar_fallbacks"] != 0 \
                or st["engine_calls"] != calls or calls < 2:
            fail(f"placement: stats {st}, {calls} engine calls: one plan "
                 "compile, no fallback and at least two steps expected")
        if ql.launches(seg) != [1] * calls or ql.launches(walk) != [0] * calls \
                or n != {seg: calls, walk: 0, "dense_levels_f32": 0}:
            fail(f"placement: level-loop launches {ql.launches(seg)}, walks "
                 f"{ql.launches(walk)} a step: one level loop and no walk "
                 "a step expected")
        first = ql.calls[0]
        extras = np.asarray(first["query"].costs)
        want = np.array([dag_T(gz, ex, pts) for ex in extras])
        bad = int((want != first["res"].T).sum())
        accepted = []
        for c, f in zip(ql.calls, hist[1:]):
            ex = np.asarray(c["query"].costs)[
                int(np.argmin(c["res"].T.mean(axis=1)))]
            accepted.append(float(np.mean(dag_T(gz, ex, pts))) == f)
        say(f"  held against core.dag on the host: step 1's {extras.shape[0]}"
            f" × {len(pts)} objectives, {bad} mismatches; the accepted "
            f"candidate of each of {len(accepted)} steps, "
            f"{accepted.count(False)} mismatches")
        if bad or not all(accepted) or extras.shape[0] != topk:
            fail("placement: the engine's objectives differ from core.dag")
        prof = {}
        eng_z, query_z = first["engine"], first["query"]
        with QueryLog() as ql2:
            profile_forward("placement step query", lambda: eng_z.run(
                query_z), focus=(seg,), stats=prof)
        if prof:
            say(f"  one profiled step: busy {prof['busy_ns'] / 1e6:.3f} ms "
                f"of a {ql2.calls[0]['secs'] * 1e3:.3f} ms query, "
                f"{prof['kernels']} kernels")
        held("placement step query", lambda: eng_z.run(query_z),
             {seg: 1, walk: 0}, {seg: rows[seg], walk: rows[walk]})
        w = obs.CompileWatcher()
        with w.watch("warm placement query") as rec:
            again = eng_z.run(query_z)
        say(f"  CompileWatcher on a warm rerun of one placement query: "
            f"{rec.new_programs} new programs ({w.programs()} kernel "
            f"libraries loaded), {rec.wall_s:.4f} s")
        if rec.new_programs != 0 or not np.array_equal(again.T,
                                                       first["res"].T):
            fail("placement: the warm rerun built a program or differs")

        # -- resilience: 32 faults, one B × K × S query --------------------
        seed, n_str, (s_lo, s_hi), n_link, n_dev, restore, ckpt = FAULTS
        rng = np.random.default_rng(seed)
        indeg = np.bincount(g4.edst, minlength=g4.num_vertices)
        calc = np.nonzero((g4.kind == CALC) & (indeg > 0)
                          & (g4.vcost > 0))[0]
        T0 = dag.evaluate(g4, p4).T
        rec_us = recovery_cost_us(step_us=T0 / 10, restore_us=restore,
                                  ckpt_every=ckpt)
        faults = (
            [StragglerFault([int(v)], float(s))
             for v, s in zip(rng.choice(calc, n_str, replace=False),
                             rng.uniform(s_lo, s_hi, n_str))]
            + [LinkFault(0, extra_L_us=float(rng.uniform(1.0, 20.0)),
                         gscale=float(rng.uniform(1.0, 2.0)),
                         duty=float(rng.uniform(0.25, 1.0)))
               for _ in range(n_link)]
            + [DeviceFault(rank=int(r), recovery_us=rec_us)
               for r in range(0, P, P // n_dev)])
        zero_counts()
        with QueryLog() as ql:
            rep, secs = wall(lambda: sensitivity.resilience_curve(
                g4, p4, faults))
        peak = torch.cuda.max_memory_allocated()
        n = main_path_launches("resilience")
        res = rep.result
        say(f"resilience: {len(faults)} faults on phase 4's stencil (T0 "
            f"{T0:.6f} µs, recovery {rec_us:.3f} µs); axes {res.axes} "
            f"{res.T.shape} ({int(np.prod(res.T.shape[:-1]))} lanes × S "
            f"{res.S}); {len(ql.calls)} query, wall {secs:.4f} s (the "
            f"query {ql.calls[0]['secs']:.4f} s); E[slowdown] "
            f"{rep.expected_slowdown:.6f}, {rep.quantiles}; peak device "
            f"memory {peak} B ({peak / 2**20:.1f} MiB)")
        if len(ql.calls) != 1 or n != {seg: 1, walk: 0,
                                       "dense_levels_f32": 0}:
            fail(f"resilience: {len(ql.calls)} queries, launches {n}: one "
                 "query, one level-loop launch and no walk expected")
        ax = fault_axes(g4, p4, faults, plan=ql.calls[0]["engine"].plan)
        bad = [c for c, T in zip(ax.cells, rep.T_fault)
               if T != dag.evaluate(*faulted_graph(g4, p4, ax, c)).T]
        say(f"  held against core.dag on each fault's inputs (extras, L and "
            f"gscale rows, the device's message edges dropped): "
            f"{len(ax.cells)} cells, {len(bad)} mismatches; T0 "
            f"{'equal' if rep.T0 == T0 else 'differs'}")
        if bad or rep.T0 != T0:
            fail(f"resilience: cells {bad[:4]} differ from core.dag")
        eng_r, query_r = ql.calls[0]["engine"], ql.calls[0]["query"]
        prof = {}
        profile_forward("resilience query", lambda: eng_r.run(query_r),
                        focus=(seg,), stats=prof)
        held("resilience query", lambda: eng_r.run(query_r),
             {seg: 1, walk: 0}, {seg: rows[seg], walk: rows[walk]})
        held_for_service = {
            "placement": {"graph": gz, "params": zero, "P": P, "pod": pod,
                          "deltas": deltas, "topk": topk, "pi0": pi0,
                          "history": hist},
            "resilience": {"faults": faults, "T0": rep.T0,
                           "T_fault": rep.T_fault,
                           "expected_slowdown": rep.expected_slowdown}}
        del eng_r, query_r, ql, rep, res

        # -- explore: a co-design search -------------------------------------
        Pe, e_iters, gens, pop, npts, dmax = EXPLORE
        space, lower = explore.preset("codesign", P=Pe, iters=e_iters)
        scen = latency_grid(LogGPS(), np.linspace(0.0, dmax, npts))
        obj = explore.robust_makespan(0.95)
        pol = ExecPolicy(max_dense_bytes=EXPLORE_DENSE_BYTES)
        stamper = explore.Stamper(pol, cache=SweepCache(capacity=1024))
        searcher = explore.RandomSearch(space, seed=0)
        batches = []
        evaluate = stamper.evaluate

        def logged_evaluate(lowered, scenarios, **kw):
            lowered = list(lowered)
            n0 = {name: k.launches for name, k in loops.items()}
            h0 = stamper.cache.stats.hits
            with QueryLog() as qlog:
                b, s_ = wall(lambda: evaluate(lowered, scenarios, **kw))
            batches.append({"lowered": lowered, "batch": b, "secs": s_,
                            "calls": len(qlog.calls),
                            "hits": stamper.cache.stats.hits - h0,
                            "launches": {
                                name: k.launches - n0[name]
                                for name, k in loops.items()}})
            return b
        stamper.evaluate = logged_evaluate
        zero_counts()
        out, secs = wall(lambda: explore.run_search(
            searcher, lower, scen, generations=gens, population=pop,
            objective=obj, stamper=stamper))
        stamper.evaluate = evaluate
        peak = torch.cuda.max_memory_allocated()
        n = main_path_launches("explore")
        say(f"explore: preset('codesign', P={Pe}, iters={e_iters}), "
            f"RandomSearch(seed=0), {gens} generations × {pop} over "
            f"{npts} ΔL points 0–{dmax} µs, robust_makespan(0.95), "
            f"ExecPolicy(max_dense_bytes={EXPLORE_DENSE_BYTES >> 30} GiB); "
            f"wall {secs:.3f} s; best {out.best} at "
            f"{out.best_objective:.6f} µs; peak device memory {peak} B "
            f"({peak / 2**20:.1f} MiB)")
        for i, (h, b) in enumerate(zip(out.history, batches)):
            say(f"  generation {i}: {h['stamp']}, {b['calls']} Engine.run "
                f"calls ({b['hits']} served by the stamper's cache), "
                f"level-loop launches {b['launches'][seg]}, walks "
                f"{b['launches'][walk]}, wall {b['secs']:.3f} s")
            if b["launches"][seg] != b["calls"] - b["hits"] \
                    or b["launches"][walk] \
                    or b["calls"] != h["stamp"]["dispatches"]:
                fail(f"explore: generation {i} launched {b['launches']} "
                     f"over {b['calls']} queries and {b['hits']} cache "
                     "hits: one level loop a query the cache misses")
        bad = []
        for i, (h, b) in enumerate(zip(out.history, batches)):
            k = int(np.argmin(h["objectives"]))
            low = b["lowered"][k]
            solo = explore.solo_objective(low, scen, obj, policy=pol)
            Ts = dag_T(low.graph, low.extra_edge_cost,
                       [low.params.replace(L=tuple(L)) for L in scen.L])
            if not (solo == h["objectives"][k]
                    and np.array_equal(Ts, b["batch"].T[k])
                    and float(obj(Ts[None])[0]) == h["objectives"][k]):
                bad.append(i)
        say(f"  each generation's best held against solo_objective on the "
            f"card and core.dag at all {npts} scenarios: {len(bad)} "
            f"mismatches")
        if bad:
            fail(f"explore: generations {bad}' best differ")
        hits0 = stamper.cache.stats.hits
        for k in loops.values():
            k.launches = 0
        with QueryLog() as qlog:
            rerun, secs = wall(lambda: stamper.evaluate(
                batches[0]["lowered"], scen))
        launched = {name: k.launches for name, k in loops.items()}
        say(f"  rerun of generation 1: {stamper.cache.stats.hits - hits0} "
            f"cache hits of {len(qlog.calls)} queries, launches {launched}, "
            f"wall {secs:.4f} s")
        if any(launched.values()) or not np.array_equal(
                rerun.T, batches[0]["batch"].T):
            fail("explore: the cached rerun launched or differs")

    # -- obs ----------------------------------------------------------------
    summary = obs.trace.summarize(spans)
    say("obs: spans " + ", ".join(f"{k} {v['n']} ({v['ms']} ms)"
                                  for k, v in sorted(summary.items())))
    snap = obs.metrics.snapshot()
    for name in ("sweep_queries_total", "sweep_cache_hits_total",
                 "sweep_cache_misses_total", "sweep_cache_evictions_total",
                 "sweep_compiles_total", "sweep_envelope_occupancy",
                 "sweep_dense_bytes", "explore_candidates_total",
                 "explore_generations_total", "explore_best_objective"):
        say(f"  {name}: " + "; ".join(
            f"{s['labels']} {s.get('value', s.get('count'))}"
            for s in snap[name]["series"]))
    need = {"sweep.canonicalize", "sweep.cost_patch", "sweep.cache_lookup",
            "sweep.stage", "sweep.execute", "explore.generation"}
    if need - set(summary):
        fail(f"obs: spans {sorted(need - set(summary))} were not collected")
    return held_for_service


# -- phase 15 ----------------------------------------------------------------

def loopback_trial() -> None:
    """A TCP socket bound on the loopback, connected to and echoed through:
    phase 15 serves the analysis protocol there, so a machine that cannot
    bind one fails here, early, and not after the other phases."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        addr = srv.getsockname()
        with socket.create_connection(addr, timeout=10) as c:
            peer, _ = srv.accept()
            with peer:
                c.sendall(b"ping\n")
                got = peer.recv(16)
    if got != b"ping\n":
        fail(f"loopback: echoed {got!r} through {addr}")
    say(f"loopback: bound and echoed through {addr[0]}:{addr[1]}")


def fault_wire(f) -> dict:
    """A fault dataclass as the service's wire spec."""
    kind = {"StragglerFault": "straggler", "LinkFault": "link",
            "DeviceFault": "device"}[type(f).__name__]
    return {"type": kind, **dataclasses.asdict(f)}


def phase_service(g4, p4, study, seg_study, consumers: dict,
                  rows: dict) -> None:
    """Phase 15 (the module docstring says what it checks): the analysis
    service on the card.  ``g4``, ``p4``: phase 4's stencil; ``study``:
    phase 7's variants, ``seg_study`` its packed segment λ forward;
    ``consumers``: phase 14's placement and fault distribution with their
    answers; ``rows``: the level-loop and walk rows, which gain the phase's
    launches."""
    from repro_torch import configs
    from repro_torch.core import placement
    from repro_torch.examples import collective_study, topology_study
    from repro_torch.kernels import maxplus
    from repro_torch.launch import analysis
    from repro_torch.launch.analysis import AnalysisRequest, AnalysisService
    from repro_torch.sweep import (Engine, ExecPolicy, Query, bandwidth_grid,
                                   latency_grid, tolerance_batched)
    from repro_torch.sweep import engine as eng
    kernels = {n: getattr(maxplus, n) for n in rows}
    seg, walk, dense = ("segment_levels_f64", "sparse_backtrace",
                        "dense_levels_f32")
    t_phase = time.perf_counter()

    def part(label, fn):
        """``fn()`` with the counts at 0 and the peak reset; prints its
        wall, launches and peak, adds the launches to the rows."""
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out, secs = wall(fn)
        n = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        for name, c in n.items():
            add_launches(rows[name], c)
        say(f"  {label}: wall {secs:.4f} s, launches "
            f"{ {k: v for k, v in n.items() if v} }, peak {peak} B "
            f"({peak / 2**20:.1f} MiB)")
        return out, n

    def ok(resp):
        if not resp.ok:
            fail(f"service: {resp.kind}: {resp.error}")
        return resp.payload

    def same(label, got: dict, want, fields=("T", "lam", "rho"), cls=0):
        """The payload's fields bit-equal to a direct Result's."""
        for f in fields:
            w = getattr(want, f)
            w = w[:, cls] if f != "T" else w
            if not np.array_equal(np.asarray(got[f]), w):
                fail(f"service: {label}: {f} differs from the direct call")

    # -- (a) the Fig 10 study through the service -----------------------------
    variants, p, _ = study
    pol = ExecPolicy(max_dense_bytes=STUDY_MAX_DENSE)
    svc = AnalysisService(device="cuda", policy=pol)
    for v in variants:
        svc.register(v)
    say(f"service: phase 7's {len(variants)} allreduce variants ({STUDY[0]} "
        f"ranks × {STUDY[1]} steps) on AnalysisService(device='cuda', "
        f"max_dense_bytes {STUDY_MAX_DENSE >> 20} MiB)")
    info, n = part("warm (each variant's λ probe, the bucket's λ and values "
                   "probes)", svc.warm)
    nb = info["buckets"]
    if n[seg] != len(variants) + 2 * nb or n[walk] != len(variants) + nb:
        fail(f"service warm: launches {n} for {len(variants)} variants in "
             f"{nb} bucket(s)")
    deltas = np.linspace(0.0, 100.0, SERVICE_POINTS)
    rank, n = part(f"rank over {SERVICE_POINTS} ΔL points", lambda: ok(
        svc.handle(AnalysisRequest(kind="rank", deltas=deltas.tolist()))))
    obj = seg_study["T"].mean(axis=1)
    want = [(variants[i].name, float(obj[i]))
            for i in np.argsort(obj, kind="stable")]
    say(f"  ranking {rank['ranking']}, {rank['compiled_calls']} call(s) for "
        f"{nb} bucket(s); phase 7's {want}")
    if n[seg] != nb or rank["compiled_calls"] != nb or n[walk] \
            or [tuple(r) for r in rank["ranking"]] != want:
        fail("service rank: one level-loop launch a bucket and phase 7's "
             "ranking expected")
    v = variants[0]
    direct = Engine(v.graph, params=v.params, policy=pol)
    batch = latency_grid(v.params, deltas)
    curve_req = AnalysisRequest(kind="curve", variant=v.name,
                                deltas=deltas.tolist())
    c, n = part(f"curve ({v.name}, {SERVICE_POINTS} points, λ)",
                lambda: ok(svc.handle(curve_req)))
    same("curve", c, direct.run(batch))
    if n[seg] != 1 or n[walk] != 1 or c["from_cache"]:
        fail(f"service curve: launches {n}")
    gs = [1.0, 2.0, 4.0]
    b, n = part("bandwidth (γ 1, 2, 4)", lambda: ok(svc.handle(
        AnalysisRequest(kind="bandwidth", variant=v.name, gscales=gs))))
    same("bandwidth", b, direct.run(bandwidth_grid(v.params, gs),
                                    compute_lam=False), ("T",))
    if n[seg] != 1 or n[walk]:
        fail(f"service bandwidth: launches {n}")
    degr = (0.01, 0.02, 0.05)
    t, n = part("tolerance (1/2/5 %)", lambda: ok(svc.handle(
        AnalysisRequest(kind="tolerance", variant=v.name,
                        degradations=list(degr)))))
    if t["tolerance"] != tolerance_batched(direct, v.params, degr) \
            or n[seg] != n[walk] or not n[seg]:
        fail(f"service tolerance {t['tolerance']} or launches {n}")
    say(f"  tolerance {t['tolerance']}: {n[seg]} probe forwards")
    again, n = part("the curve again", lambda: ok(svc.handle(curve_req)))
    if not again["from_cache"] or any(n.values()) \
            or not np.array_equal(again["T"], c["T"]):
        fail("service: the repeated curve launched or differs")
    dc, n = part("curve on dense (a policy block)", lambda: ok(svc.handle(
        AnalysisRequest(kind="curve", variant=v.name, deltas=deltas.tolist(),
                        policy={"backend": "dense"}))))
    same("dense curve", dc, direct.run(batch, backend="dense"))
    if n[dense] != 1 or n[walk] != 1:
        fail(f"service dense curve: launches {n}")
    dr, n = part("rank on dense", lambda: ok(svc.handle(AnalysisRequest(
        kind="rank", deltas=deltas.tolist(), backend="dense"))))
    d_obj = dict(dr["ranking"])
    order = [nm for nm, _ in dr["ranking"]]
    if n[dense] != nb or n[walk] or any(
            abs(d_obj[nm] - o) > 1e-5 * o for nm, o in want) or any(
            d_obj[a] > d_obj[b_] * (1 + 1e-5) for i, a in enumerate(order)
            for b_ in order[i + 1:]):
        fail(f"service dense rank: launches {n}, ranking {dr['ranking']}")
    s32 = {"backend": "sparse", "dtype": "float32"}
    sc, n = part("curve on sparse float32", lambda: ok(svc.handle(
        AnalysisRequest(kind="curve", variant=v.name, deltas=deltas.tolist(),
                        policy=s32))))
    same("sparse float32 curve", sc,
         direct.run(batch, policy=pol.replace(**s32)))
    if not n["sparse_levels_f32"] or n[walk] != 1:
        fail(f"service sparse float32 curve: launches {n}")

    # -- (b) phase 14's resilience and placement through the service --------
    res14 = consumers["resilience"]
    svc_r = AnalysisService(device="cuda")
    svc_r.register_graph("stencil", g4, p4)
    r, n = part(f"resilience ({len(res14['faults'])} faults)", lambda: ok(
        svc_r.handle(AnalysisRequest(
            kind="resilience",
            faults=[fault_wire(f) for f in res14["faults"]]))))
    if not (np.array_equal(r["T_fault"], res14["T_fault"])
            and r["T0"] == res14["T0"]
            and r["expected_slowdown"] == res14["expected_slowdown"]) \
            or n[seg] != 1 or n[walk]:
        fail(f"service resilience differs from phase 14's or launched {n}")
    pl14 = consumers["placement"]
    svc_p = AnalysisService(device="cuda")
    svc_p.register_graph("stencil", pl14["graph"], pl14["params"])
    place = placement.place

    def from_phase_14(*a, **kw):
        # the request has no start mapping and no step cap: phase 14's
        return place(*a, **{**kw, "pi0": pl14["pi0"].copy(),
                            "max_iters": SERVICE_PLACE_STEPS})
    placement.place = from_phase_14
    try:
        pr, n = part(f"placement (K {pl14['topk']} × S "
                     f"{len(pl14['deltas'])}, {SERVICE_PLACE_STEPS} steps "
                     "from phase 14's start)", lambda: ok(svc_p.handle(
                         AnalysisRequest(kind="placement",
                                         topo={"P": pl14["P"],
                                               "pod": pl14["pod"]},
                                         deltas=list(pl14["deltas"]),
                                         topk=pl14["topk"]))))
    finally:
        placement.place = place
    steps = pr["stats"]["steps"]
    if pr["history"] != pl14["history"][:len(pr["history"])] \
            or pr["stats"]["engine_calls"] != n[seg] or n[walk] or not steps:
        fail(f"service placement: history {pr['history']} against phase "
             f"14's {pl14['history']}, launches {n}")
    say(f"  placement: history {pr['history']} (phase 14's first "
        f"{len(pr['history'])}: equal), stats {pr['stats']}")

    # -- (c) the collective study (Fig 10) on jamba, through the service -----
    arch, mesh, npts = COLL_STUDY
    cfg = configs.get(arch)[0]
    coll, n = part(f"collective study ({arch}, TraceSpec{mesh}, "
                   f"{len(collective_study.ALGOS)} algorithms: trace, curve, "
                   "5 % tolerance, rank)", lambda: collective_study.flow(
                       cfg, mesh=mesh, deltas=np.linspace(0.0, 50.0, npts),
                       device="cuda"))
    check_study("collective", coll, 0.05, 50.0)
    del coll

    # -- (d) the topology study (Fig 11), through the service ----------------
    topo, n = part(f"topology study ({TOPO_STUDY[0]} ranks, three fabrics: "
                   "curve, 1 % tolerance, rank)", lambda: topology_study.flow(
                       nranks=TOPO_STUDY[0], iters=TOPO_STUDY[1],
                       deltas=np.linspace(0.0, TOPO_RANK_DL,
                                          TOPO_RANK_POINTS), device="cuda"))
    check_study("topology", topo, 0.01, TOPO_RANK_DL)
    del topo

    # -- (e) the JSON-lines protocol over a loopback socket ------------------
    socket_round_trip(svc, variants, analysis)

    # -- (f) sharding ---------------------------------------------------------
    split_checks(g4, p4, svc, variants, deltas, part, eng, Engine, Query,
                 latency_grid)
    say(f"service phase: {time.perf_counter() - t_phase:.2f} s")


def check_study(label: str, out: dict, degr: float, dl: float) -> None:
    """An example flow's service answers held against ``core.dag``: each
    variant's T and λ at ΔL 0 (bit for bit on the float64 routes, 1e-5 on
    float32), its tolerance (T at L + tolerance within 1e-5 of the
    budget), its rank objective (T at ``dl``)."""
    from repro_torch.core import dag
    svc = out["service"]
    rank = dict(out["rank"]["ranking"])
    for name, (curve, tol) in out["rows"].items():
        v, e = svc._variants[name], svc.engine(name)
        exact = curve["backend"] in ("segment", "sparse")
        route = "sparse float64" if e.plan is None else curve["backend"]
        plan = dag.LevelPlan(v.graph)
        s = plan.forward(v.params)
        budget = (1.0 + degr) * s.T
        t_tol = plan.forward(v.params.with_delta(tol, 0)).T
        t_dl = plan.forward(v.params.with_delta(dl, 0)).T
        errs = (abs(curve["T"][0] - s.T) / s.T,
                abs(curve["lam"][0] - s.lam[0]) / max(s.lam[0], 1.0),
                abs(rank[name] - t_dl) / t_dl)
        e_tol = abs(t_tol - budget) / budget
        say(f"  {label} {name}: {v.graph.num_vertices} vertices, route "
            f"{route}; T {float(curve['T'][0])!r} µs, λ "
            f"{float(curve['lam'][0])!r}, {100 * degr:g} % tolerance "
            f"{tol!r} µs; core.dag T {float(s.T)!r}, λ {float(s.lam[0])!r}; "
            f"relative T / λ / T at +{dl} µs "
            f"{tuple(float(x) for x in errs)}, T at the tolerance off its "
            f"budget by {float(e_tol)!r}")
        if max(errs) > (0.0 if exact else 1e-5) or not e_tol <= 1e-5:
            fail(f"{label} {name}: off core.dag beyond the {route} contract")
    say(f"  {label} ranking {out['rank']['ranking']} "
        f"({out['rank']['compiled_calls']} forwards)")


def socket_round_trip(svc, variants, analysis) -> None:
    """Two client threads query ``svc`` over a loopback TCP socket while
    ``/metrics`` is served beside it; their responses equal ``handle_json``
    in the process (the payload but what the result cache changes: its
    flag and a rank's forward count), and the scrape counts their
    requests."""
    import socket
    import threading
    import urllib.request
    from repro_torch.obs import metrics
    box, ready = {}, threading.Event()

    def on_ready(srv):
        box["srv"] = srv
        ready.set()
    server = threading.Thread(
        target=analysis.serve_socket, args=(svc, "127.0.0.1:0"),
        kwargs={"ready": on_ready, "poll_s": 0.05}, daemon=True)
    server.start()
    if not ready.wait(60):
        fail("socket: the server never bound")
    msrv = analysis.serve_metrics("127.0.0.1:0")
    addr = box["srv"].server_address[:2]
    url = "http://%s:%d/metrics" % msrv.server_address[:2]

    def requests(i):
        return [{"kind": "curve", "variant": variants[i].name,
                 "deltas": [0.0, 7.0 + i, 40.0], "trace": f"c{i}-0"},
                {"kind": "rank", "deltas": [0.0, 11.0 + i, 90.0],
                 "reduce": "final", "trace": f"c{i}-1"},
                {"kind": "bandwidth", "variant": variants[i].name,
                 "gscales": [1.0, 1.5 + i], "trace": f"c{i}-2"},
                {"kind": "explode", "trace": f"c{i}-3"}]

    def series():
        return {tuple(sorted(s["labels"].items())): s["value"]
                for s in metrics.snapshot()["analysis_requests_total"][
                    "series"]}

    before = series()
    answers = {}

    def client(i):
        with socket.create_connection(addr, timeout=600) as s:
            f = s.makefile("rw", encoding="utf-8")
            out = []
            for q in requests(i):
                f.write(json.dumps(q) + "\n")
                f.flush()
                out.append(f.readline())
            answers[i] = out
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,))
               for i in range(SOCKET_CLIENTS)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    secs = time.perf_counter() - t0
    if any(c.is_alive() for c in clients) or len(answers) != SOCKET_CLIENTS:
        fail("socket: a client did not finish")
    text = urllib.request.urlopen(url, timeout=60).read().decode()
    want = {}
    for i in range(SOCKET_CLIENTS):
        for q in requests(i):
            k = (("kind", q["kind"] if q["kind"] != "explode" else "?"),
                 ("ok", "true" if q["kind"] != "explode" else "false"))
            want[k] = want.get(k, 0) + 1
    bad = []
    for k, n in want.items():
        lab = dict(k)
        m = re.search(r'analysis_requests_total\{kind="%s",ok="%s"\} (\S+)'
                      % (re.escape(lab["kind"]), lab["ok"]), text)
        got = float(m.group(1)) if m else -1.0
        if got - before.get(k, 0.0) != n:
            bad.append((lab, got, before.get(k, 0.0), n))
    box["srv"].shutdown()
    server.join(30)
    msrv.shutdown()
    msrv.server_close()
    differ = 0
    for i in range(SOCKET_CLIENTS):
        for q, line in zip(requests(i), answers[i]):
            a, b = json.loads(line), json.loads(svc.handle_json(
                json.dumps(q)))
            for r in (a, b):
                # what the result cache changes: the flag, and the
                # forwards a rank ran
                r["payload"].pop("from_cache", None)
                r["payload"].pop("compiled_calls", None)
            differ += any(a[k] != b[k] for k in ("kind", "ok", "payload",
                                                  "error", "trace"))
    n_req = sum(want.values())
    say(f"socket: {SOCKET_CLIENTS} clients × {n_req // SOCKET_CLIENTS} "
        f"requests over {addr[0]}:{addr[1]} in {secs:.4f} s; responses "
        f"differing from handle_json in the process: {differ}; /metrics "
        f"scraped ({len(text)} bytes), analysis_requests_total moved by "
        f"{ {dict(k)['kind'] + '/' + dict(k)['ok']: n for k, n in want.items()} }"
        f"{'' if not bad else ', mismatches ' + str(bad)}; server thread "
        f"{'stopped' if not server.is_alive() else 'still running'}")
    if differ or bad or server.is_alive():
        fail("socket: responses differ, the scrape miscounts, or the server "
             "did not stop")


def split_checks(g4, p4, svc, variants, deltas, part, eng, Engine, Query,
                 latency_grid) -> None:
    """Sharding on one card: ``shard=True`` resolves to the card alone and
    gives the unsharded bits; then each axis split over the card listed
    twice, bit-equal to the unsplit forward (T, λ, ρ), one level-loop
    launch a chunk and one walk a chunk of a λ forward."""
    dev = torch.device("cuda")
    e4 = Engine(g4, params=p4)
    b4 = latency_grid(p4, deltas)
    Sp = 256
    say(f"sharding: torch.cuda.device_count() {torch.cuda.device_count()}; "
        f"shard=True resolves to "
        f"{eng._resolve_shard(True, Sp, eng.local_devices(dev))} (None: "
        f"unsharded) on phase 4's curve (S {Sp}); splits over "
        f"{list(SPLIT_DEVICES)}")
    whole, _ = part("phase 4's curve, whole", lambda: e4.run(b4))
    seg, walk = "segment_levels_f64", "sparse_backtrace"

    def check(label, got, want, n, chunks, lam):
        same = all(np.array_equal(getattr(got, f), getattr(want, f))
                   for f in ("T", "lam", "rho") if getattr(want, f)
                   is not None)
        say(f"    {label}: bit-equal {same}")
        if not same or n[seg] != chunks or n[walk] != (chunks if lam else 0):
            fail(f"sharding {label}: differs or launched {n} for {chunks} "
                 "chunk(s)")
    sh, n = part("shard=True", lambda: e4.run(b4, shard=True))
    check("shard=True", sh, whole, n, 1, True)
    c0 = eng.split_forward.chunks
    sp, n = part("S split (256 → 2 × 128)", lambda: e4.run(
        b4, shard_axis="S", shard_devices=SPLIT_DEVICES))
    check("S", sp, whole, n, 2, True)
    meng = svc._multi[0]
    batches = [latency_grid(v.params, deltas) for v in variants]
    whole_g, _ = part("phase 7's packed study, whole", lambda: meng.run(
        batches, use_cache=False))
    gp, n = part("G split (4 → 2 + 2)", lambda: meng.run(
        batches, use_cache=False, shard_axis="G",
        shard_devices=SPLIT_DEVICES))
    check("G", gp, whole_g, n, 2, True)
    K, S = PLACEMENT
    q = Query(latency_grid(p4, np.linspace(0.0, 10.0, S)),
              costs=lane_extras(g4, K, 15))
    for lam in (False, True):
        whole_k, _ = part(f"placement's shape K {K} × S {S}, whole "
                          f"({'λ' if lam else 'values'})",
                          lambda: e4.run(q, compute_lam=lam))
        kp, n = part(f"K split ({K} → 2 × {K // 2}, "
                     f"{'λ' if lam else 'values'})", lambda: e4.run(
                         q, compute_lam=lam, shard_axis="K",
                         shard_devices=SPLIT_DEVICES))
        check(f"K ({'λ' if lam else 'values'})", kp, whole_k, n, 2, lam)
    if eng.split_forward.chunks - c0 != 8:
        fail(f"sharding: {eng.split_forward.chunks - c0} chunks run, 8 "
             "expected")


# -- phase 17 ----------------------------------------------------------------

def wkv6_inputs(B, T, H, hd, seed: int, state: bool):
    """r, k, v [B, T, H, hd] ~ 0.5·N(0, 1), w ~ U(0.5, 1), u [H, hd] ~
    0.1·N(0, 1) and, with ``state``, S0 [B, H, hd, hd] ~ 0.1·N(0, 1):
    float32 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=g, device="cuda")

    r, k, v = (rnd((B, T, H, hd), 0.5) for _ in range(3))
    w = 0.5 + 0.5 * torch.rand((B, T, H, hd), generator=g, device="cuda")
    return (r, k, v, w, rnd((H, hd), 0.1),
            rnd((B, H, hd, hd), 0.1) if state else None)


def wkv6_bound(B, T, H, hd, state: bool) -> dict:
    """The least time of one wkv6 call: r, k, v, w read and y written once
    (4 B each), u, S0 and S once; 7 float32 operations a (step, i, j) over
    the CUDA cores' peak; and, beside them, the exact form's instruction
    floor (WKV_INSTR a (step, i, j) over the card's SMs × 128 lanes at
    SM_CLOCK_HZ: S's multiplies and add cannot fuse) and the chain of T
    dependent steps (a multiply and an add each)."""
    n = B * T * H * hd
    nbytes = 4 * (5 * n + H * hd + B * H * hd * hd * (2 if state else 1))
    ops = 7.0 * n * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "sms": sms,
            "floor_ms": WKV_INSTR * n * hd / (sms * 128 * SM_CLOCK_HZ) * 1e3,
            "chain_ms": T * 2 * FP32_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3}


def phase_wkv6() -> dict:
    """The wkv6 kernel against its plain version on the card: rwkv6-7b's
    decode (B 4, T 1) and 4096-token prefill (B 1) shapes (H 64, hd 64)
    and ragged ones (hd 32, T off the staging chunk, 2 heads: fewer blocks
    than SMs), from a zero and a given state: S bit for bit, y within
    WKV_RTOL of the largest |y|; then its and the plain version's times at
    decode and prefill beside the bound and the instruction floor.  Returns its row (launches filled by phase 17's main path)."""
    from repro_torch import configs
    from repro_torch.kernels.rwkv import wkv6, wkv6_plan, wkv6_ref
    cfg = configs.get(RWKV_ARCH)[0]
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    cases = [("decode", 4, 1, H, hd), ("prefill", 1, PREFILL_T, H, hd),
             ("ragged", 2, 37, 3, 32), ("hd 32", 1, 1000, 8, 32),
             ("few heads", 1, 1001, 2, hd)]
    err = 0.0
    for i, (label, B, T, Hh, d) in enumerate(cases):
        for state in (False, True):
            args = wkv6_inputs(B, T, Hh, d, seed=i, state=state)
            y, S = wkv6(*args)
            torch.cuda.synchronize()
            yr, Sr = wkv6_ref(*args)
            s_diff = int((S != Sr).sum())
            e = float((y - yr).abs().max())
            rel = e / float(yr.abs().max())
            err = max(err, e)
            say(f"check wkv6 {label:8s} B {B} T {T} H {Hh} hd {d} state "
                f"{state}: S differs at {s_diff} of {S.numel()}, max|y - "
                f"plain| {e} (|y| up to {float(yr.abs().max()):.3f}; "
                f"relative {rel:.3e}, tolerance {WKV_RTOL})")
            if s_diff or rel > WKV_RTOL:
                fail(f"wkv6 differs from its plain version on {label}")
    timed = {}
    for label, B, T, reps in (("decode", 4, 1, 200),
                              ("prefill", 1, PREFILL_T, 10)):
        args = wkv6_inputs(B, T, H, hd, seed=50, state=True)
        ms = cuda_ms(lambda: wkv6(*args), reps=reps, warmup=3)
        plain_ms = event_ms(lambda: wkv6_ref(*args))
        b = wkv6_bound(B, T, H, hd, True)
        timed[label] = {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                        "library_ms": None}
        say(f"time wkv6 {label} B {B} T {T} H {H} hd {hd} (from a state): "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}: {b['bytes']} B, "
            f"{b['ops']:.0f} ops), chain of {T} dependent steps "
            f"{b['chain_ms']:.6f} ms ({FP32_LATENCY_CYCLES}-cycle multiply "
            f"and add at {SM_CLOCK_HZ / 1e9:.2f} GHz), library: none")
        say(f"  wkv6 {label}: the exact form's instruction floor "
            f"{b['floor_ms']:.6f} ms ({WKV_INSTR} instructions a (step, i, "
            f"j): {WKV_INSTR * B * T * H * hd * hd:.3e} over {b['sms']} SMs "
            f"x 128 lanes at {SM_CLOCK_HZ / 1e9:.2f} GHz), kernel at "
            f"{ms / b['floor_ms']:.2f}x it and {ms / b['bound_ms']:.2f}x the "
            f"bound; plan (JB, blocks, threads) {wkv6_plan(B, H, hd, b['sms'])}")
    for key, info in KERNEL_INFO.items():
        if "wkv6_kernel" in key:
            say(f"wkv6 ptxas {key}: {info}")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv/csrc/wkv6.cu",
            "replaces": "none: src/repro/models/ssm.py:246 (rwkv6_apply's "
                        "lax.scan; no TPU kernel)",
            "launches": None, "max_abs_err": err, **timed["prefill"],
            "decode": timed["decode"]}


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts 2 bytes past a 16-byte
    boundary: the flash wrappers send such a call to the simple route."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def planted_faults(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> dict:
    """Inputs on which a correct kernel gives what a faulty one would on
    the true inputs: the scale 1/sqrt(128) (the padded width at d 80, dv
    at d 192) in place of 1/sqrt(d); q·k without the last 64-column
    atom's columns (64..79 at d 80, 128..191 at d 192); the output's last
    16 columns left zero."""
    d = q.shape[-1]
    c0 = (d - 1) // 64 * 64
    q_cut = q.clone()
    q_cut[..., c0:] = 0
    v_cut = v.clone()
    v_cut[..., -16:] = 0
    return {"scale 1/sqrt(128)":
                ((q.float() * math.sqrt(d / 128)).to(q.dtype), k, v),
            f"q.k without columns {c0}..{d - 1}": (q_cut, k, v),
            "the last 16 output columns zero": (q, k, v_cut)}


def phase_flash_families() -> tuple:
    """The flash kernels at the new families' shapes on the routes they
    take: MLA's decode (B 4, one token against 192 keys, H 16, d
    192, dv 128) on the decode kernel, MLA's 4096-token causal prefill and
    hubert's 4096-frame non-causal encoder (H 16, d 80) on the prefill
    kernel, in bfloat16 against the plain version, the two layouts
    bit-equal; the kernel's, the plain version's and
    ``scaled_dot_product_attention``'s times beside the bound (the exact
    work: 2·(d + dv) operations a live pair, though d 80 runs at width
    128).  Each is held within FLASH_TOL and FAMILY_REL of the plain
    version's largest |out|, and the same route on inputs that plant a
    fault (:func:`planted_faults`) must break that limit.  Then the simple
    kernel, which no main path launches, at the same shapes through
    unaligned copies of the same inputs (its route for such calls),
    checked and timed beside them.  Returns (the simple kernel's row, its
    numbers those of MLA's prefill; the new routes' numbers and errors by
    shape, for the decode and prefill rows)."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_flat,
                                                     flash_attention_ref)
    mla = configs.get(MLA_ARCH)[0]
    enc = configs.get(ENCODER_ARCH)[0]
    dq = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    B, P, G = SERVE
    shapes = {
        "mla decode": ((B, 1, P + G, mla.n_heads, mla.n_heads, dq,
                        mla.v_head_dim), False, "decode", 500),
        "mla prefill": ((1, PREFILL_T, PREFILL_T, mla.n_heads, mla.n_heads,
                         dq, mla.v_head_dim), True, "prefill", 20),
        "hubert prefill": ((1, PREFILL_T, PREFILL_T, enc.n_heads,
                            enc.n_kv_heads, enc.head_dim, enc.head_dim),
                           False, "prefill", 20)}
    simple_err, timed, simple = 0.0, {}, {}
    for i, (label, (shape, causal, want, reps)) in enumerate(shapes.items()):
        Bq, Tq, Tk, H, Hkv, d, dv = shape
        q, k, v = flash_inputs(Bq, Tq, Tk, H, Hkv, d, dv, torch.bfloat16,
                               seed=70 + i)
        qf, kf, vf = flat(q), flat(k), flat(v)
        out, route = flash_route(flash_attention, lambda: flash_attention(
            q, k, v, causal=causal))
        out_flat = flash_attention_flat(qf, kf, vf, causal=causal)
        qu, ku, vu = unaligned(q), unaligned(k), unaligned(v)
        out_simple, route_simple = flash_route(
            flash_attention, lambda: flash_attention(qu, ku, vu,
                                                     causal=causal))
        torch.cuda.synchronize()
        ref = flash_attention_ref(qf, kf, vf, causal=causal).reshape(
            Bq, H, Tq, dv).transpose(1, 2)
        e = float((out.float() - ref.float()).abs().max())
        es = float((out_simple.float() - ref.float()).abs().max())
        same = torch.equal(out_flat.reshape(Bq, H, Tq, dv).transpose(1, 2),
                           out)
        top = float(ref.float().abs().max())
        limit = min(FLASH_TOL[torch.bfloat16], FAMILY_REL * top)
        simple_err = max(simple_err, es)
        say(f"check flash {label}: route {route}, max|out-plain| {e} "
            f"(limit {limit:.4g} = min({FLASH_TOL[torch.bfloat16]}, "
            f"{FAMILY_REL} x max|plain| {top:.4g})), kernel layout equal "
            f"{same}; unaligned copies: route {route_simple}, max|out-plain| "
            f"{es}")
        if route != want or e > limit or not same:
            fail(f"flash {label}: route {route} (want {want}), max|out-plain| "
                 f"{e} (limit {limit}), layouts equal {same}")
        if route_simple != "simple" or es > limit:
            fail(f"flash {label} unaligned: route {route_simple}, "
                 f"max|out-plain| {es} (limit {limit})")
        for fault, (qx, kx, vx) in planted_faults(q, k, v).items():
            out_x, route_x = flash_route(flash_attention, lambda: (
                flash_attention(qx, kx, vx, causal=causal)))
            ex = float((out_x.float() - ref.float()).abs().max())
            say(f"  planted fault at {label}, {fault}: route {route_x}, "
                f"max|out-plain| {ex} ({ex / limit:.1f} x the limit)")
            if route_x != want or ex <= limit:
                fail(f"flash {label}: the check does not catch {fault} "
                     f"(max|out-plain| {ex}, limit {limit})")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                     reps=reps, warmup=3)
        simple_ms = cuda_ms(lambda: flash_attention(qu, ku, vu, causal=causal),
                            reps=min(reps, 5), warmup=2)
        plain_ms = cuda_ms(lambda: flash_attention_ref(qf, kf, vf,
                                                       causal=causal),
                           reps=min(reps, 5), warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps=reps, warmup=3)
        except RuntimeError as exc:
            say(f"  scaled_dot_product_attention at {label}: {exc}")
            library_ms = None
        pairs = Bq * H * (Tq * (Tq + 1) // 2 if causal else Tq * Tk)
        ops = 2.0 * pairs * (d + dv)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + Bq * Tq * H * dv)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_OPS_PER_S * 1e3
        bound = {"bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes > t_ops else "operations",
                 "library_ms": library_ms}
        timed[label] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": e,
                        **bound}
        simple[label] = {"ms": simple_ms, "plain_ms": plain_ms, **bound}
        lib = "none" if library_ms is None else f"{library_ms:.6f} ms"
        say(f"time flash_attention {label} ({route} route) B {Bq} Tq {Tq} Tk "
            f"{Tk} H {H}/{Hkv} d {d}/{dv} bf16 causal {causal}: kernel "
            f"{ms:.6f} ms, simple kernel (unaligned copies) {simple_ms:.6f} "
            f"ms, plain {plain_ms:.6f} ms, library "
            f"(scaled_dot_product_attention) {lib}, bound "
            f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {nbytes} B, "
            f"{ops:.0f} ops); max|out-plain| {e}")
    say(f"flash_decode ptxas (d 192 / dv 128): "
        f"{ptxas_of('flash_decode_kernelI13__nv_bfloat16Li8ELi3ELi2E')}; "
        f"flash_prefill ptxas (192, 128): "
        f"{ptxas_of('flash_prefill_kernelILi192E')}, (128, 128, 80): "
        f"{ptxas_of('flash_prefill_kernelILi128ELi128ELi80E')}")
    row = {"name": "flash_attention_simple", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
           "launches": 0, "max_abs_err": simple_err,
           **simple["mla prefill"], "mla_decode": simple["mla decode"],
           "hubert_prefill": simple["hubert prefill"]}
    return row, timed


def encoder_card_vs_cpu(small) -> None:
    """The encoder's SMOKE (float32) drawn on the card and copied to the
    CPU (plain versions): the prefill step over the same frame embeddings,
    logits within XCHECK_TOL."""
    from repro_torch.models import Model, init_params
    from repro_torch.runtime import build_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    card = init_params(small, seed=0)
    cpu = Model(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    B, T = ENCODER_XCHECK
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, T, small.d_model), generator=g, device="cuda")
    step = build_prefill_step(small)
    got = step(card, {"embeds": x}).float().cpu()
    want = step(cpu, {"embeds": x.cpu()})
    e = float((got - want).abs().max())
    say(f"encoder card vs CPU ({small.name}, {small.n_layers} layers, "
        f"float32, [{B}, {T}, {small.d_model}] frames): max |logits_card - "
        f"logits_cpu| {e} (logits up to {float(want.abs().max()):.3f})")
    if e > XCHECK_TOL:
        fail(f"the card's encoder differs from the CPU's (tolerance "
             f"{XCHECK_TOL})")


def phase_families(flash_rows: dict, simple_row: dict,
                   wkv_row: dict) -> None:
    """Phase 17: deepseek-v2-lite-16b (MLA, MoE with shared experts) and
    rwkv6-7b (RWKV-6 on the wkv6 kernel) at full depth and width in
    bfloat16 from seeded random weights, each served like phase 8 (the
    serve loop at SERVE, then one PREFILL_T-token prefill step), and
    hubert-xlarge (LayerNorm, GELU MLP, non-causal) at full depth: one
    [1, PREFILL_T, 1280] frame-embedding forward.  The launches of the
    flash routes, wkv6 and the Mamba scan are set to 0 before each main
    path and read after: one wkv6 launch an RWKV layer a forward, and
    every flash launch through the decode kernel (MLA's decode steps, d
    192 / dv 128) or the prefill kernel (MLA's prefill and hubert's d 80
    encoder), none through the simple one; walls, tokens/s, peak memory, profiles; then each model's
    SMOKE in float32 on the card against the CPU.  The card is freed
    between models.  ``flash_rows`` (by route), ``simple_row`` and
    ``wkv_row`` gain the launches."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import mamba_scan
    from repro_torch.kernels.rwkv import wkv6
    from repro_torch.models import init_params
    from repro_torch.runtime import build_prefill_step
    kernels = {"flash_attention": flash_attention, "wkv6": wkv6,
               "mamba_scan": mamba_scan}
    B, P, G = SERVE
    steps = P + G - 1
    for arch in (MLA_ARCH, RWKV_ARCH):
        cfg = configs.get(arch)[0]
        specs = [cfg.layer_spec(i) for i in range(cfg.n_layers)]
        n_attn = sum(m == "attn" for m, _ in specs)
        n_rwkv = sum(m == "rwkv" for m, _ in specs)
        say(f"{arch}: {cfg.n_layers} layers {sorted(set(specs))}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}; "
            f"{cfg.param_count() * 2 / 1e9:.1f} GB of bf16 weights")
        model, launches, prompts, long, prefill = serve_on_card(
            cfg, arch, kernels)
        want = {"flash_attention": n_attn * steps + n_attn,
                "flash_attention/decode": n_attn * steps,
                "flash_attention/prefill": n_attn,
                "flash_attention/simple": 0,
                "wkv6": n_rwkv * steps + n_rwkv, "mamba_scan": 0}
        got = {n: launches[n] for n in want}
        say(f"{arch} launches: {got} (want flash {n_attn} x ({P} + {G} - 1) "
            f"on decode + {n_attn} on prefill, none on simple; wkv6 {n_rwkv} "
            f"x ({P} + {G} - 1) + {n_rwkv}: {want})")
        if got != want:
            fail(f"{arch} launches {got} != {want}")
        for route, row in flash_rows.items():
            add_launches(row, launches[f"flash_attention/{route}"])
        add_launches(simple_row, launches["flash_attention/simple"])
        add_launches(wkv_row, launches["wkv6"])
        focus = ("flash_prefill", "flash_decode", "flash_attention", "wkv6",
                 "nvjet", "gemm", "elementwise")
        profile_forward(f"{arch} prefill-step [1, {PREFILL_T}]",
                        lambda: prefill(model, {"tokens": long}), focus=focus)
        profile_decode_step(model, prompts, arch, focus)
        moe = next((blk.ffn for blk in model.blocks if blk.spec[1] == "moe"),
                   None)
        if moe is not None:
            h = torch.randn((B, 1, cfg.d_model), device="cuda").to(model.dtype)
            moe_ns = profile_forward("one MoE FFN at decode", lambda: moe(h))
            nb = sum(p.numel() * p.element_size() for p in moe.parameters())
            say(f"{arch}: one MoE FFN at decode reads all {cfg.n_experts} "
                f"experts, {nb} B, bound {nb / HBM_BYTES_PER_S * 1e3:.3f} ms"
                + ("" if moe_ns is None else
                   f"; profiled alone {moe_ns / 1e6:.3f} ms device busy"))
        del model, moe, prompts, long
        free_card()
        small = configs.get(arch)[1]
        card_vs_cpu(small, f"{arch} SMOKE", *FAMILY_XCHECK)
        free_card()

    cfg = configs.get(ENCODER_ARCH)[0]
    n_attn = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model, t_init = wall(lambda: init_params(cfg, seed=0))
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"{ENCODER_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.norm_type} norm, {cfg.ffn_type} MLP, causal {cfg.causal}; "
        f"{n_bytes} B in {model.dtype}, drawn in {t_init:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, PREFILL_T, cfg.d_model), generator=g,
                    device="cuda").to(model.dtype)
    step = build_prefill_step(cfg)
    step(model, {"embeds": x[:, :64]})                   # warm-up
    for fn in kernels.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0
    torch.cuda.reset_peak_memory_stats()
    logits, t_fwd = wall(lambda: step(model, {"embeds": x}))
    peak = torch.cuda.max_memory_allocated()
    got = {"flash_attention": flash_attention.launches,
           **{f"flash_attention/{r}": flash_attention.route_launches[r]
              for r in ("prefill", "simple")},
           "wkv6": wkv6.launches, "mamba_scan": mamba_scan.launches}
    want = {"flash_attention": n_attn, "flash_attention/prefill": n_attn,
            "flash_attention/simple": 0, "wkv6": 0, "mamba_scan": 0}
    say(f"{ENCODER_ARCH}: encoder forward [1, {PREFILL_T}, {cfg.d_model}] "
        f"{t_fwd:.4f} s ({PREFILL_T / t_fwd:.1f} frames/s), peak device "
        f"memory {peak} B ({peak / 2**20:.1f} MiB); launches {got} (want "
        f"{want})")
    if got != want:
        fail(f"{ENCODER_ARCH} launches {got} != {want}")
    if logits.shape != (1, PREFILL_T, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"{ENCODER_ARCH} logits: wrong shape or non-finite values")
    add_launches(flash_rows["prefill"], n_attn)
    add_launches(simple_row, 0)
    profile_forward(f"{ENCODER_ARCH} encoder [1, {PREFILL_T}]",
                    lambda: step(model, {"embeds": x}),
                    focus=("flash_prefill", "flash_attention", "nvjet", "gemm",
                           "elementwise"))
    del model, logits, x
    free_card()
    encoder_card_vs_cpu(configs.get(ENCODER_ARCH)[1])
    free_card()


def timed_phase(label: str, fn, *args):
    """``fn(*args)`` with its wall printed as the phase's."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"[phase wall] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    T = timed_phase
    name = T("1 device", phase_device)
    T("1 loopback", loopback_trial)
    T("2 build", phase_build)
    rows = T("3 kernels", phase_kernels)
    rows.append(T("3 slot list", phase_slotlist))
    rows += T("3 batched", phase_batched)
    flash_rows = dict(zip(("decode", "prefill"), T("3 flash", phase_flash)))
    simple_row, fam = T("3 flash families", phase_flash_families)
    for kind, row in flash_rows.items():   # the new shapes on their routes
        for label, t in fam.items():
            if label.endswith(kind):
                row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
                row[label.split()[0]] = t
    scan_row = T("3 linear scan", phase_scan)
    mamba_row = T("3 mamba scan", phase_mamba_scan)
    wkv_row = T("3 wkv6", phase_wkv6)
    g_sp, p_sp, sp, t_graph = T("3 sparse stencil", sparse_stencil)
    level_rows = T("3 levels", phase_levels, p_sp, sp)
    f64_row = T("3 levels f64", phase_levels_f64, p_sp, sp)
    g, p = stencil()
    study = T("3 study variants", study_variants)
    dense_row = T("3 dense levels", phase_dense_levels, g, p, study)
    seg_row = T("3 segment levels", phase_segment_levels, g, p, study, p_sp)
    walk_row = level_rows[1]
    walk_row["packed"] = dense_row.pop("walk_packed")
    card = T("4 main", phase_main, g, p, rows[:2], dense_row, walk_row)
    T("4 main segment", phase_main_segment, g, p, card, seg_row, walk_row)
    T("5 cpu", phase_cpu, g, p, card)
    T("6 sparse", phase_sparse, g_sp, p_sp, sp, t_graph, rows[2], level_rows,
      f64_row)
    del g_sp, sp
    dense_study = T("7 study", phase_study, study, rows[3:], dense_row,
                    walk_row)
    seg_study = T("7 study segment", phase_study_segment, study, dense_study,
                  seg_row, walk_row)
    del dense_study
    T("8 serve", phase_serve, flash_rows)
    T("9 hybrid", phase_hybrid, flash_rows, scan_row, mamba_row)
    level_loops = {"dense_levels_f32": dense_row,
                   "sparse_levels_f32": level_rows[0],
                   "sparse_levels_f64": f64_row,
                   "segment_levels_f64": seg_row,
                   "sparse_backtrace": walk_row}
    dense_lp = T("10 solvers", phase_solvers, g, p, level_loops)
    T("11 traced", phase_traced, level_loops)
    T("12 lanes", phase_lanes, g, p, study, seg_study, level_loops)
    T("13 congestion", phase_congestion, g, p, level_loops)
    consumers = T("14 consumers", phase_consumers, g, p, level_loops)
    T("15 service", phase_service, g, p, study, seg_study, consumers,
      level_loops)
    del consumers
    rows += T("16 sparse LP", phase_sparse_ipm, g, p, dense_lp)
    del study, seg_study, dense_lp
    free_card()
    T("17 families", phase_families, flash_rows, simple_row, wkv_row)
    rows += [dense_row, *level_rows, f64_row, seg_row, *flash_rows.values(),
             simple_row, scan_row, mamba_row, wkv_row]
    say(f"[phase wall] all: {time.perf_counter() - t_start:.2f} s")
    say("kernels held against their plain versions: "
        + ", ".join(r["name"] for r in rows))
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
