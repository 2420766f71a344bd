#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches its own):

1. Environment: torch/CUDA versions, the card's name and power limit, and
   the build of the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` a source, all started together), with each kernel's
   registers and spills; the Hopper flash kernel, the nine tile kernels
   (``tile_lu_sm90``) and the matmul's routes (``matmul``) must not spill,
   and ptxas must take every ``setmaxnreg``.
2. Kernels: each of the nine tile kernels — Cholesky's POTRF, TRSM, SYRK,
   GEMM and LU's GETRF, TRSML, TRSMU, TRSMUL, GEMMNN — is held against its
   plain PyTorch version on the card at b = 8 ... 128 (right-hand-side
   widths bc = 1, 8 and b where a kernel takes a non-square operand; all
   nine also at the ragged b = 96 and 120, TRSML, TRSMU, TRSMUL and GEMMNN
   with bc = 1, 3, 40 and b, SYRK and GEMM at b = 7 and 33, and GEMMNN at
   m != k), under each launch shape its wrapper may choose (TRSMU's and
   TRSM's rows and TRSML's and TRSMUL's columns a CTA, the output tile of
   SYRK, GEMM and GEMMNN), in the fused-grid form (random distinct write
   blocks on random non-square grids, arguments of one tile shape in one
   grid, whole grids compared) and in the batched form (2a), where the
   tensor-core kernels' (SYRK's, GEMM's, GEMMNN's) 128^3 tile error against
   float64 must also stay within twice ``torch.matmul``'s in fp32 on the same tiles; then in
   the stacked grid form on (B, nr, nc, br, bc) grids, B = 3 and 4, all
   lanes sharing the indices
   and the last lane a copy of the one before it (2c).  Each is timed at
   the main path's shapes (the largest group of that kernel in the
   n = 4096, 32 x 32 plan of Cholesky, of LU, or for TRSMUL of the
   matrix-RHS LU solve, on the resident grids; GEMMNN also at a 4-task
   group of the matrix-RHS solve and the largest q = 1 group of the vector
   solve, TRSML and TRSMUL at the vector solve's one-task bc = 1 groups,
   TRSM at the Cholesky plan's one-task group) beside its plain version,
   one PyTorch library call computing the same group, and the least time
   the card could take (its bound, at the peak rate of the kernel's
   arithmetic route: fp32 FMAs, or 3xTF32 on the tensor cores) (2b); and
   in stacked form at the serving shapes (the largest group in the
   n = 1024, 8 x 8 template plan
   over 64 lanes) beside the same group as 64 unstacked launches, the
   plain stacked version, a library call on the flattened stack and the
   bound, each result held against the plain version on those grids and
   on random ones (2d).  Each stacked check also asserts that the written
   grid left as it was would fail it.  After each 2b/2d timing one more
   call runs under the profiler, and its trace gives what was launched:
   CTAs, threads, registers and shared memory a CTA (``launch`` lines).
   B5, groups of several segments (each argument a segment table, the
   group one in-place launch): in 2b the matrix-RHS solve plan's widest
   GEMMNN group of two segments (961 + 124 tasks, A's grid and b's) and its
   widest TRSML group, in 2d the stacked matrix-b solve's at the serving
   shape (b (1024, 128) in 8 x 1, 64 lanes); each held bit for bit against
   its gather form (gathered segment by segment from the plan's indices,
   joined, run through ``batched_*``, scattered back) and within tolerance
   of the plain version, on random grids (where the written grids left as
   they were must fail) and on the main path's, and timed beside its gather
   form, its plain version and its bound.
3. Cholesky main path: blocked Cholesky of a 4096 x 4096 fp32 SPD matrix on
   graph g2p with 32 x 32 partitions (128 x 128 tiles), drained three
   times: the first drain (which captures the launch list into a CUDA
   graph), a drain-memo replay on another seed's matrix (a replay that
   skipped copying its inputs in would fail its error check) and one on the
   first drain's matrix, each checked against float64
   ``torch.linalg.cholesky`` (the seed-0 drains within ACCURACY's limit,
   printed beside earlier measurements) and the structural counters, each
   required to have run a captured graph, whose result is held bit for bit
   against the same launch list run eagerly on the same inputs; kernel
   launch counters are zeroed right before each drain and read right after.
   Each drain prints its host dispatch and wall, and the device's idle
   share of a traced replay.  Then the same three drains on g2 (library
   leaves, also captured; held against the eager list within the drain's
   tolerance), a profiled replay with its host functions (cProfile), and g1
   at n = 256 through ``run_cholesky``.
4. LU main paths, on a 4096 x 4096 column-diagonally-dominant matrix with
   32 x 32 partitions, each drain as in phase 3: ``run_lu``'s g2p drain
   three times (packed factor against a float64 pivot-free LU),
   ``run_lu_solve``'s with b (4096, 512) in 32 x 4 blocks three times and
   with a vector b once (solution against float64 ``torch.linalg.solve``;
   each seed-0 error within its ACCURACY limit, printed beside earlier
   values), the matrix solve twice on g2, a profiled replay of the
   matrix-RHS drain.  B5: the matrix-RHS solve's launch list built in the
   gather form (the reference's rule, the port's before this change) and
   in place, both captured on the same inputs: equal to each other and to
   ``run_lu_solve``'s result bit for bit, with each replay's device time,
   busy time, idle share, device ops (graph nodes; the in-place list's must
   all be tile kernels), gather ops and pool bytes; the same for
   ``run_inv`` at n = 4096 on g2p (timed, inv @ a against I).  Every g2p
   matrix solve drain must launch 31 GEMMNN and 31 TRSML over two segments.
   4c: ``run_lu_solve_batched`` of 64 matrix-b systems (n = 1024 in 8 x 8,
   b (1024, 128)) in one stacked drain, twice: stacked launches only, 7
   GEMMNN and 7 TRSML over two segments, solutions against float64.  Then
   ``run_inv`` on g1 at n = 256.
4b. Distributed graphs, on a world-size-1 NCCL ``DeviceMesh`` of shape
   (1, 1) with axes ("data", "model"): g4 (two levels, the hand-written
   tile kernels) Cholesky and LU solve with b (4096, 512) at (4, 4) then
   (8, 8) partitions (phase 3's 128 x 128 leaves; b in (4, 4) then
   (8, 1)), each drained as phase 3 drains (first, memo replays on seeds 1
   and 0), then g4 ``run_lu``'s drain, g3 (library leaves) Cholesky and
   g3flat Cholesky at 32 x 32 once each.  Each drain is held against
   float64 (g4's seed-0 drains within ACCURACY's limits) and against the
   same drain on g2p within its tolerance, must run a captured graph for
   every launch list, show the counters and tile-kernel launches that
   ``DIST_PLANS`` and ``DIST_LAUNCHES`` pin (all nine kernels across the g4
   drains; the g4 solve's over two segments ``DIST_SEGMENTED``), and prints
   its wall, host dispatch and launch lists beside
   g2p's.  ``run_cholesky``, ``run_lu`` and ``run_lu_solve`` with
   ``mesh=`` must return, on the mesh's device, their g4 drains' results
   bit for bit.
5. Serving: ``BatchServer(graph="g2p", max_batch=64)``; each tick queues 64
   ``lu_solve`` (vector b), 16 ``lu`` and 16 ``cholesky`` requests of
   n = 1024 in 8 x 8 partitions, three signature buckets of one stacked
   launch list each.  Tick 1 captures; ticks 2-4 (fresh inputs, stacked
   launch counts zeroed before and read after each) must show 0 builds,
   3 launches, 3 stacked drains, 96 resolved, no host wait, a stacked
   launch of all nine kernels, each bucket's template counters,
   results within 2e-4 (factors) and 1e-3 (solutions) of float64, and
   factors whose componentwise backward error stays within fp32's bound
   for blocked LU and Cholesky, |LU - A| <= gamma_n |L||U| (the LU factors'
   also within ACCURACY's limit); every tick's drains must each run a
   captured graph, none bisected.  Then a
   profiled repeat tick and one under cProfile, the same tick on g2, the
   64 solves as sequential ``run_lu_solve`` replays and as one batched
   library call, and two fault rounds (``check_finite=True``, no
   retries): a NaN request fails alone with ``NumericalError``; an
   in-flight fault on one request bisects and fails it alone with
   ``InflightError``.  Last, a probe: a g2 leaf that synchronizes the host
   must make its capture raise ``CaptureError`` naming the operation.

6. LM inference (after freeing the earlier phases' memory): flash
   attention against its plain version, float32 and bfloat16, at
   tests/test_kernels.py's shapes (windows 0 and 16), GQA groups of 3 and
   9, head dims 8 to 256, ragged S and the model's transposed layout, each
   on the route ``flash_route`` names (bf16 with D a multiple of 16 in
   64..256: the Hopper kernel; the rest: the simple kernel), and on the
   Hopper route without a causal mask, with a caller's scale, at S = 1, a
   ragged S = 300 with GQA 9, D = 192 and 80, and a misaligned view; the
   matmul at tests/test_kernels.py's shapes, 4096^3 and ragged edges, float32
   and bfloat16, each on the route ``matmul_route`` names (bf16 that TMA can
   read: wgmma; float32: 3xTF32; other bf16, a misaligned view among them:
   the simple kernel), every route taken; each check asserting that an
   all-zero output would fail it (6a); the Hopper kernel timed at
   starcoder2-7b's and gemma3-12b's prefill shapes beside the simple kernel,
   its plain version, a library call and its bound, the simple kernel at the
   float32 forward's shape, and the matmul at 4096^3 on each route (float32
   on 3xTF32, its error against float64 held to TC_RATIO times
   torch.matmul's; bfloat16 on wgmma beside the simple kernel) (6b);
   starcoder2-7b at its published widths, all 32 layers, bf16, seeded
   random weights: the no-cache forward at S = 4096 through the Hopper
   kernel (exactly one launch a layer, every one on that route) and
   through the plain attention, both timed and profiled, checked layer by
   layer on the same inputs (teacher-forced: end to end, this random
   network is chaotic), a check shown to fail for a kernel that drops the
   last KV tile; then the same widths in float32, two layers, S = 1024,
   through the simple kernel, checked the same way (6c); ``ServeEngine`` at full
   width, 4 slots, its decode and scatter programs captured into CUDA
   graphs and its prefill eager, 8 greedy requests of 32 tokens in 62
   decode steps: decode compiles 1 then 61 graph replays and scatter one
   per slot used, as the JAX engine jits them, and one eager prefill a
   request; TTFT, decode ms a step, tokens/s, each prefill's ms, the
   graphs' pool bytes; an eager reference run of the plain programs whose
   tokens and logits the captured engine's must equal bit for bit, and in
   which request 0's prefill and first two decode steps are checked,
   teacher-forced, against a no-cache forward; a profiled decode replay;
   and a temperature / top-k run, captured, every token inside its top-k
   and two replays from the same inputs drawing anew (6d); the
   ``ops.matmul`` entry point at 4096^3, float32 and bfloat16 (6e).
7. The non-dense LM families (``NONDENSE``), each at its published widths,
   bf16, seeded random weights, built after the one before is freed, with
   its parameters and bytes: granite-moe-1b-a400m (24 layers, 7a),
   zamba2-2.7b (54 layers, 7b), rwkv6-3b (32 layers, 7c),
   llama4-maverick-400b-a17b cut to one group (a dense-MLP and a routed
   layer of 128 experts: the whole model does not fit, 7d), musicgen-large
   (48 layers, on ``synth_embeddings``) and pixtral-12b (40 layers, 7e).
   Each takes the no-cache forward at B = 1, S = 4096 (llama4 2048) between
   zeroed and read flash launch counts (24, 9, 0, 2, 48, 40, all on the
   Hopper kernel), timed with the flash kernel and the plain attention,
   checked teacher-forced layer by layer where it attends (MoE layers: the
   tokens whose top-k set or kept experts differ between the paths
   counted and left out of the per-position maximum, the whole layer's
   error held too; the share dropped at capacity printed; MoE routers
   asserted fp32 on the card), and profiled with the device time grouped
   by expert GEMMs, dispatch, router, the SSD and WKV chunk loops, flash,
   dense GEMMs and elementwise work.  ``ServeEngine`` as in 6d, captured,
   runs granite (at its capacity factor, then at n_experts / top_k, where
   no token drops, for the teacher-forced check), zamba2, rwkv6 and
   musicgen (prompts of frame embeddings, decoding through the stub
   table), each eager reference run cut to the first wave's prefills and
   the first three engine steps.
8. Training, in a process of its own (``chip_smoke.py --phase 8``, which
   ``main`` starts before phase 1 touches the card: its 50 GB peak needs
   the whole card), with
   no hand-written kernel on this path (``use_pallas`` is off, as in the
   reference's training, whose ``pallas_call`` has no VJP):
   starcoder2-7b at its published widths, 8 of its 32 layers, bf16
   compute with fp32 masters and moments, S = 4096, batch 4, remat
   ``full``.  8a: a ``Trainer`` for 20 steps from a seeded init on
   ``warmup_cosine(3e-4, 2, 20)`` with checkpoints every 10 steps into a
   temporary directory, its step captured into one CUDA graph on the first
   step and replayed after (compiles 1 then 0, replays 19); the first step's
   and the median replay's ms, tokens/s, ``model_flops``, MFU, peak memory,
   the grad norm of every step, the loss falling (the last 5 steps' mean
   below the first 5's), and one profiled replay (busy, idle share, device
   time by bf16 GEMMs, the plain attention's fp32 products and softmax,
   elementwise work and the optimizer).  8b: one step from the seeded
   state eager, then captured and replayed from the same state: every
   parameter leaf within 1e-3 relative L2, the loss and grad norm too.
   8c: ``UTPTrainStep`` fused with two microbatches from that state
   (compiles 1 then 0), within 1e-3 of 8b's eager step, captured and
   replayed.  8d: a reduced float32 configuration, the captured step on the
   card against the same step on the CPU for two steps (rtol 2e-4, atol
   2e-5).
9. The launch layer's plans over a world-size-1 NCCL ``DeviceMesh``, in
   this process after phase 7 and ``release_captured()`` (C5: reserved at
   most 2 GiB over allocated, printed): 9a starcoder2-7b's prefill plan
   (published widths, 32 layers, bf16, B = 1, S = 4096, ``use_pallas``
   on; the cache path launches no flash kernel, as the reference's) equal
   to ``Model.prefill`` bit for bit, timed; 9b its decode plan at 6d's
   engine shape captured into one CUDA graph (compiles 1 then 0, 62
   replays), every greedy step's tokens, logits and cache equal to the
   eager steps, ms a step captured and eager and a profiled replay; 9c a
   2-layer train step (B = 4, S = 4096) over the mesh against the
   mesh-less plan, both captured: equal but for the embedding leaf's
   atomics; 9d granite's prefill plan through expert parallelism against
   ``Model.prefill``'s local dispatch, routers fp32.
10. The dry run (``launch/dryrun.py``): its traces run on the host's CPU,
   in a process of its own (``chip_smoke.py --phase 10-dry``) that ``main``
   starts at the outset, beside phase 8: 9c's 2-layer train plan on a
   faked (1, 1) job (fake tensors, no card), phase 8's configuration
   (8 layers, B = 4, S = 4096) on (1, 1) and the whole 32-layer model on a
   faked (4, 1) job, as ``examples/torch_train_sharded.py --cuda`` trains
   it on four cards.  Then, on the card, one eager call of the same
   2-layer plan over a world-size-1 NCCL mesh under ``FlopCounterMode``,
   after ``reset_peak_memory_stats``: its FLOPs must equal the dry run's
   exactly, and the dry run's predicted peak must lie within ``DRY_TOL``
   of the measured one (``max_memory_allocated`` less what was allocated
   before the step's state).  The other two peaks are printed beside
   PERF.md's measured 48.67 and 33.65 GB.
11. Over several cards, where the machine has two or more (on one card the
   phase prints that it did not run): each rank's programs captured into
   CUDA graphs with their NCCL collectives inside (``multi_card_path``):
   the distributed g4 Cholesky over min(4, cards) ranks, every list of
   every drain a graph replay and the result one card's bit for bit, the
   (1, W) captured prefill and decode plans' check against one device, and
   the train step at phase 8's shape on (W, 1) and (1, W), captured with
   its forward, remat backward, gradient reductions and AdamW on every
   rank: a replay against the eager step from the same state, the recorded
   collectives against the eager step's, the loss falling.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails before printing it.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, P = 4096, 32  # main paths: n x n fp32, P x P partitions -> 128 x 128 tiles
RHS, RHS_P = 512, 4  # matrix right-hand side of the LU solve: (N, 512) in P x 4 blocks
TILES = (8, 16, 32, 64, 128)
# edges that are no power of two, for the redesigned kernels (POTRF's and
# GETRF's register tiles, the triangular solves' row and column splits and
# 16-row blocks, the output tiles of SYRK, GEMM and GEMMNN): b, with
# right-hand-side widths bc where a kernel takes one
RAGGED, RAGGED_WIDTHS = (96, 120), (1, 3, 40)
RAGGED_KERNELS = ("potrf", "getrf", "trsml", "trsmu", "trsmul", "trsm", "syrk", "gemm", "gemmnn")
# SYRK and GEMM at edges that are no multiple of 4: the 4-byte staging of
# their B^T from B's rows (GEMMNN_SHAPES take GEMMNN's)
BT_EDGES = (7, 33)
# GEMMNN ((m, k), (k, q)) with m != k, ragged in every dimension
GEMMNN_SHAPES = (((96, 120), (120, 40)), ((120, 40), (40, 96)), ((33, 128), (128, 1)), ((1, 7), (7, 9)),
                 ((128, 5), (5, 128)))
# every launch shape each wrapper may choose (tile_linalg.launch_shape), each
# checked in turn; GEMMNN's 0 (the matrix-vector mapping) only for q < 8
SHAPES = {"trsml": (16, 32), "trsmu": (16, 32), "trsm": (16, 32), "trsmul": (16, 32), "syrk": (32, 64),
          "gemm": (32, 64), "gemmnn": (0, 32, 64)}
# 3xTF32 on the tensor cores (but GEMMNN's matrix-vector mapping)
TENSOR_CORE = ("syrk", "gemm", "gemmnn")
CHOLESKY = ("potrf", "trsm", "syrk", "gemm")
LU = ("getrf", "trsml", "trsmu", "trsmul", "gemmnn")
KERNELS = CHOLESKY + LU
WIDE = ("trsml", "trsmu", "trsmul", "gemmnn")  # take an operand of width bc
# the reference tests' tolerances (tests/test_kernels.py), atol = rtol
TOL = {"potrf": 2e-4, "trsm": 2e-3, "syrk": 1e-4, "gemm": 1e-4,
       "getrf": 2e-4, "trsml": 2e-3, "trsmu": 2e-3, "trsmul": 2e-3, "gemmnn": 1e-4}
_TL = "src/repro/kernels/tile_linalg.py"
REPLACES = {
    "potrf": f"{_TL}:181 batched_potrf; :367 make_grid_fused (grid_potrf :444)",
    "trsm": f"{_TL}:201 batched_trsm; :367 make_grid_fused (grid_trsm :445)",
    "syrk": f"{_TL}:223 batched_syrk; :367 make_grid_fused (grid_syrk :446)",
    "gemm": f"{_TL}:242 batched_gemm; :367 make_grid_fused (grid_gemm :447)",
    "getrf": f"{_TL}:265 batched_getrf; :367 make_grid_fused (grid_getrf :448)",
    "trsml": f"{_TL}:282 batched_trsml; :367 make_grid_fused (grid_trsml :449)",
    "trsmu": f"{_TL}:302 batched_trsmu; :367 make_grid_fused (grid_trsmu :450)",
    "trsmul": f"{_TL}:321 batched_trsmul; :367 make_grid_fused (grid_trsmul :451)",
    "gemmnn": f"{_TL}:340 batched_gemmnn; :367 make_grid_fused (grid_gemmnn :452)",
}
CSRC = "src/repro_torch/kernels/csrc"
# FLOPs of one task from its arguments' tile shapes [(rows, cols), ...]
FLOPS = {
    "potrf": lambda s: s[0][0] ** 3 / 3,
    "trsm": lambda s: s[1][0] * s[0][0] ** 2,
    "syrk": lambda s: 2 * s[0][0] ** 3,
    "gemm": lambda s: 2 * s[0][0] ** 3,
    "getrf": lambda s: 2 * s[0][0] ** 3 / 3,
    "trsml": lambda s: s[0][0] ** 2 * s[1][1],
    "trsmul": lambda s: s[0][0] ** 2 * s[1][1],
    "trsmu": lambda s: s[1][0] * s[0][0] ** 2,
    "gemmnn": lambda s: 2 * s[0][0] * s[0][1] * s[1][1],
}
# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores, TF32
# on the tensor cores (dense), HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
EXPECTED_LAUNCHES = {"potrf": 32, "trsm": 31, "syrk": 31, "gemm": 30}  # per drain at P = 32
# 2b's timings of a kernel at other groups of the plans (the solves', and
# TRSM's one-task Cholesky group), beside its main-path one
SOLVE_GROUPS = {"gemmnn": ("gemmnn_solve4", "gemmnn_vector"), "trsml": ("trsml_vector",),
                "trsmul": ("trsmul_vector",), "trsm": ("trsm_1task",)}
# the serving path: BatchServer(graph="g2p", max_batch=64) on n = 1024 requests
# in 8 x 8 partitions (128 x 128 tiles, as on the main paths)
SN, SP, LANES = 1024, 8, 64
SERVED = {"lu_solve": 64, "lu": 16, "cholesky": 16}  # requests of each kind per tick
# each bucket's template plan (leaves, groups, prefusion groups, slots): the
# same at any tile size, so the same as the CPU tests' n = 64
TEMPLATES = {"lu_solve": (276, 80, 80, 59), "lu": (204, 29, 29, 22), "cholesky": (120, 28, 28, 22)}
STACKED_REPLACES = f"{_TL}:388 make_grid_fused kernel_stacked (_imap_stacked :401, pallas_call :433)"
# a tensor-core kernel's 128^3 tile error against float64, at most this many
# times torch.matmul's in fp32 (TF32 off) on the same tiles (phase 2a)
TC_RATIO = 2.0
# errors against float64 (fp32 backward error in units of u for the served LU
# factors) held to a limit, each printed beside two H100 measurements of the
# same run with GEMMNN (B11) in fp32 FMAs and in 3xTF32 with one tensor-core
# accumulator started from -C (PERF.md section 6): (limit, fp32 FMAs, 3xTF32
# from -C).  The limits are twice the fp32 FMA kernel's.
ACCURACY = {
    "cholesky": (7.2e-7, 3.6e-7, 3.6e-7),
    "run_lu": (1.7e-6, 8.3e-7, 2.3e-5),
    "lu_solve": (5.4e-6, 2.7e-6, 9.8e-5),
    "lu_solve_vector": (2.8e-6, 1.4e-6, 5.8e-5),
    "served_lu_backward_u": (40.0, 19.9, 260.0),
}


# the same errors as the H100 measured them in the tree before the register
# POTRF (PERF.md section 6; the served LU's largest of its runs)
BEFORE = {"cholesky": 3.605e-7, "run_lu": 8.337e-7, "lu_solve": 2.684e-6, "lu_solve_vector": 1.401e-6,
          "served_lu_backward_u": 25.9}


def accuracy_held(kind: str, err: float) -> None:
    """Print ``err`` beside ACCURACY's two earlier values and BEFORE's; raise
    above its limit."""
    limit, fma, from_c = ACCURACY[kind]
    print(f"accuracy {kind}: {err:.3e} (limit {limit:.2e}; with GEMMNN in fp32 FMAs {fma:.2e}, "
          f"in 3xTF32 from -C {from_c:.2e}; before the register POTRF {BEFORE[kind]:.3e})")
    if not err <= limit:
        raise AssertionError(f"{kind} error {err:.3e} above its limit {limit:.2e}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_fresh(fn, restore, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` alone, each call on inputs that ``restore``
    has just put back (``fn`` writes in place).  A device-side sleep ahead
    of each call lets the host queue the restore and the timed call, so the
    events time the card, not the host's launch path."""
    import torch

    for _ in range(warmup):
        restore()
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)  # cycles, about 0.5 ms
        restore()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def close(got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want| everywhere."""
    import torch

    diff = (got.double() - want.double()).abs()
    if not torch.isfinite(got).all() or (diff > tol + tol * want.double().abs()).any():
        raise AssertionError(f"max abs err {diff.max().item():.3e} exceeds tolerance {tol}")
    return diff.max().item()


# --------------------------------------------------------------------------
# Phase 2a inputs: numpy tile stacks
# --------------------------------------------------------------------------
def spd_tiles(rng, n: int, b: int):
    import numpy as np

    m = rng.standard_normal((n, b, b)).astype(np.float32) / np.float32(np.sqrt(b))
    return m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b, dtype=np.float32)


def lower_with_junk(rng, n: int, b: int):
    """Cholesky factors with finite junk above the diagonal (the kernels must
    ignore it, as the JAX tile bodies do)."""
    import numpy as np

    low = np.linalg.cholesky(spd_tiles(rng, n, b).astype(np.float64)).astype(np.float32)
    junk = np.triu(rng.standard_normal((n, b, b)).astype(np.float32), 1) * 0.3
    return low + junk


def dd_tiles(rng, n: int, b: int):
    """Column-diagonally-dominant tiles (``dd_matrix``'s recipe per tile)."""
    import numpy as np

    a = rng.standard_normal((n, b, b)).astype(np.float32)
    a /= np.abs(a).sum(axis=1, keepdims=True) * 1.5
    a[:, np.arange(b), np.arange(b)] = 1.0 + rng.uniform(0.0, 1.0, (n, b)).astype(np.float32)
    return a


def packed_lu_tiles(rng, n: int, b: int):
    """Packed L\\U of dd tiles from a float64 pivot-free LU, so the triangle a
    solve kernel must not read carries real junk."""
    m = dd_tiles(rng, n, b).astype("float64")
    for k in range(b):
        m[:, k + 1 :, k] /= m[:, k, k, None]
        m[:, k + 1 :, k + 1 :] -= m[:, k + 1 :, k, None] * m[:, k, None, k + 1 :]
    return m.astype("float32")


def special_tiles(name: str, rng, n: int, b: int):
    """The structured stack of a kernel's factor argument (argument 0), or None."""
    make = {"potrf": spd_tiles, "getrf": dd_tiles, "trsm": lower_with_junk, "trsml": packed_lu_tiles,
            "trsmu": packed_lu_tiles, "trsmul": packed_lu_tiles}.get(name)
    return None if make is None else make(rng, n, b)


def grid_case(tl, name: str, rng, shapes, nr: int = 6, nc: int = 7, n: int = 12, lanes=None):
    """Random non-square grids, one per distinct tile shape of ``shapes`` (the
    arguments' tiles; arguments of one shape address one grid, as in a
    single-root drain); distinct write blocks, the written grid's read
    blocks drawn from the rest.  With ``lanes`` the grids are stacked
    ``(lanes, nr, nc, br, bc)``, every lane with its own values and factor
    tiles, all lanes sharing the indices; the last lane copies the one
    before it, as a pow2 padding lane does."""
    import numpy as np

    lead = () if lanes is None else (lanes,)
    b = shapes[0][0]
    w = tl.GRID_FUSED[name][1]
    grid_of, grids = {}, []
    for s in shapes:
        if s not in grid_of:
            grid_of[s] = len(grids)
            grids.append(rng.standard_normal(lead + (nr, nc) + s).astype(np.float32) * 0.3)
    blocks = rng.permutation(nr * nc)
    writes, rest = blocks[:n], blocks[n:]
    flat = []
    for a, s in enumerate(shapes):
        same = grid_of[s] == grid_of[shapes[w]]
        flat.append(writes if a == w else rng.choice(rest if same else np.arange(nr * nc), n))
    blk = np.unique(flat[0])
    g = grids[grid_of[shapes[0]]]
    for lane in range(1 if lanes is None else lanes):
        tiles = special_tiles(name, rng, len(blk), b)
        if tiles is not None:
            (g if lanes is None else g[lane]).reshape(-1, b, b)[blk] = tiles
    if lanes is not None:
        for g in grids:
            g[-1] = g[-2]
    idxs = [np.stack([f // nc, f % nc], 1).astype(np.int32) for f in flat]
    return grids, [grid_of[s] for s in shapes], idxs


def check_cases(tl):
    """(name, label, tile shapes) of every 2a/2c case: each kernel at
    b = TILES (right-hand-side widths 1, 8 and b where it takes one), the
    RAGGED_KERNELS also at the ragged RAGGED (x RAGGED_WIDTHS), SYRK and GEMM
    at BT_EDGES, and GEMMNN at GEMMNN_SHAPES."""
    for b in TILES:
        for name in KERNELS:
            for bc in sorted({1, 8, b}) if name in WIDE else [b]:
                yield name, f"b={b:3d}" + (f" bc={bc:3d}" if name in WIDE else ""), tl.tile_shapes(name, b, bc)
    for b in RAGGED:
        for name in RAGGED_KERNELS:
            for bc in sorted({*RAGGED_WIDTHS, b}) if name in WIDE else [b]:
                yield name, f"b={b:3d}" + (f" bc={bc:3d}" if name in WIDE else ""), tl.tile_shapes(name, b, bc)
    for b in BT_EDGES:
        for name in ("syrk", "gemm"):
            yield name, f"b={b:3d}", tl.tile_shapes(name, b, b)
    for (m, k), (_, q) in GEMMNN_SHAPES:
        yield "gemmnn", f"m={m} k={k} q={q}", [(m, k), (k, q), (m, q)]


def launch_shapes(name: str, shapes):
    """The launch shapes to check ``name`` under: each one its wrapper may
    choose for these tiles (None: the kernel has a single launch shape)."""
    if name not in SHAPES:
        return [None]
    q = shapes[-1][1]
    return [s for s in SHAPES[name] if name != "gemmnn" or s != 0 or q < 8]


class forced_shape:
    """Within the block, ``tl.launch_shape`` returns ``shape`` for the kernels
    that take one: each of a kernel's launch shapes gets checked whatever
    size the check's group has."""

    def __init__(self, tl, shape):
        self.tl, self.shape, self.orig = tl, shape, tl.launch_shape

    def __enter__(self):
        if self.shape is not None:
            self.tl.launch_shape = lambda name, shapes, n, batch, sms: (self.shape,)

    def __exit__(self, *exc):
        self.tl.launch_shape = self.orig


def kernel_checks(torch, tl, rng) -> dict:
    """Phase 2a: every kernel against its plain version, grid and batched
    forms, under each of its launch shapes."""
    import numpy as np

    err = {k: 0.0 for k in KERNELS}
    n = 12
    for name, label, shapes in check_cases(tl):
        w = tl.GRID_FUSED[name][1]
        for shape in launch_shapes(name, shapes):
            grids, which, idxs = grid_case(tl, name, rng, shapes, n=n)
            ix = [torch.from_numpy(i).cuda() for i in idxs]
            g0 = [torch.from_numpy(g).cuda() for g in grids]
            gk, gp = [g.clone() for g in g0], [g.clone() for g in g0]
            with forced_shape(tl, shape):
                getattr(tl, f"grid_{name}")(ix, [gk[k] for k in which])
            getattr(tl, f"grid_{name}_plain")(ix, [gp[k] for k in which])
            torch.cuda.synchronize()
            e_grid = max(close(x, y, TOL[name]) for x, y in zip(gk, gp))
            for k in range(len(g0)):
                if k != which[w] and not torch.equal(gk[k], g0[k]):
                    raise AssertionError(f"grid_{name} wrote a grid it only reads")
            # batched form on (n, br, bc) stacks
            stacks = [rng.standard_normal((n,) + s).astype(np.float32) * 0.3 for s in shapes]
            tiles = special_tiles(name, rng, n, shapes[0][0])
            if tiles is not None:
                stacks[0] = tiles
            st = [torch.from_numpy(s).cuda() for s in stacks]
            before = [s.clone() for s in st]
            with forced_shape(tl, shape):
                out_k = getattr(tl, f"batched_{name}")(*st)
            out_p = getattr(tl, f"{name}_plain")(*st)
            torch.cuda.synchronize()
            e_bat = close(out_k, out_p, TOL[name])
            for s, s0 in zip(st, before):
                if not torch.equal(s, s0):
                    raise AssertionError(f"batched_{name} modified its input stack")
            err[name] = max(err[name], e_grid, e_bat)
            how = "" if shape is None else f" shape={shape:3d}"
            print(f"check {name:6s} {label}{how}: grid max_abs_err={e_grid:.3e} "
                  f"batched max_abs_err={e_bat:.3e} (tol {TOL[name]})")
    return err


def tensor_core_accuracy(torch, tl, rng) -> None:
    """Phase 2a: each tensor-core kernel's 128^3 tile error against float64,
    under each of its tensor-core launch shapes, held to at most TC_RATIO
    times that of ``torch.matmul`` in fp32 (TF32 off) on the same tiles: dd
    tiles (the LU's) and 0.3-scale Gaussian ones."""
    import numpy as np

    from repro_torch.kernels.ref import fp32_matmul

    n, b = 16, 128
    for kind in ("dd", "randn"):
        a, bm, c = (torch.from_numpy(dd_tiles(rng, n, b) if kind == "dd"
                                     else rng.standard_normal((n, b, b)).astype(np.float32) * 0.3).cuda()
                    for _ in range(3))
        for name in TENSOR_CORE:
            args, rhs = {"syrk": ((a, c), a.mT), "gemm": ((a, bm, c), bm.mT), "gemmnn": ((a, bm, c), bm)}[name]
            want = c.double() - a.double() @ rhs.double()
            with fp32_matmul():
                lib_err = (c - torch.matmul(a, rhs) - want).abs().max().item()
            for shape in SHAPES[name]:
                if shape == 0:
                    continue
                with forced_shape(tl, shape):
                    got = getattr(tl, f"batched_{name}")(*args)
                err = (got.double() - want).abs().max().item()
                ratio = err / lib_err
                print(f"accuracy {name:6s} 128^3 {kind:5s} tiles shape={shape:3d}: max_abs_err_vs_f64={err:.3e} "
                      f"torch.matmul_fp32_max_abs_err_vs_f64={lib_err:.3e} ratio={ratio:.2f} (limit {TC_RATIO})")
                if not ratio <= TC_RATIO:
                    raise AssertionError(f"{name} tile error {err:.3e} > {TC_RATIO} x torch.matmul's {lib_err:.3e}")


def stacked_checks(torch, tl, rng) -> dict:
    """Phase 2c: the stacked grid form of every kernel (``make_grid_fused``'s
    ``kernel_stacked``) against its plain stacked version, B = 3 and 4,
    under each launch shape, whole stacked grids compared: unwritten blocks
    and lanes keep their bytes, and the padding lane's result equals the
    lane it copies."""
    err = {k: 0.0 for k in KERNELS}
    for name, label, shapes in check_cases(tl):
        w = tl.GRID_FUSED[name][1]
        for shape in launch_shapes(name, shapes):
            e_case = 0.0
            for lanes in (3, 4):
                grids, which, idxs = grid_case(tl, name, rng, shapes, lanes=lanes)
                ix = [torch.from_numpy(i).cuda() for i in idxs]
                g0 = [torch.from_numpy(g).cuda() for g in grids]
                gk, gp = [g.clone() for g in g0], [g.clone() for g in g0]
                before = tl.STACKED_LAUNCHES[name]
                with forced_shape(tl, shape):
                    getattr(tl, f"grid_{name}")(ix, [gk[k] for k in which])
                getattr(tl, f"grid_{name}_plain")(ix, [gp[k] for k in which])
                torch.cuda.synchronize()
                if tl.STACKED_LAUNCHES[name] != before + 1:
                    raise AssertionError(f"grid_{name} on stacked grids did not count a stacked launch")
                e = max(close(x, y, TOL[name]) for x, y in zip(gk, gp))
                unchanged_fails(name, g0[which[w]], gp[which[w]])
                out = gk[which[w]]
                if not torch.equal(out[-1], out[-2]):
                    raise AssertionError(f"stacked {name}: the padding lane differs from the lane it copies")
                for k in range(len(g0)):
                    if k != which[w] and not torch.equal(gk[k], g0[k]):
                        raise AssertionError(f"stacked {name} wrote a grid it only reads")
                e_case = max(e_case, e)
            err[name] = max(err[name], e_case)
            how = "" if shape is None else f" shape={shape:3d}"
            print(f"check {name:6s}_stacked {label}{how} B=3,4: max_abs_err={e_case:.3e} (tol {TOL[name]})")
    return err


# --------------------------------------------------------------------------
# Phase 2b: kernel timings at the main paths' shapes
# --------------------------------------------------------------------------
def leaf_plan(op, specs):
    """The leaf plan (``SchedulePlan``) of one root ``op`` over data of
    ``specs`` = [(shape, partitions), ...], planned without executing."""
    from repro_torch.core import DepTracker, GData, GTask
    from repro_torch.core.executors import plan_schedule

    datas = []
    for shape, parts in specs:
        d = GData(shape, partitions=parts, value=None, device="cuda")
        d.materialize()
        datas.append(d)
    root = GTask(op, None, [d.root_view() for d in datas])
    children = []
    op.split(root, children.append)
    tracker = DepTracker()
    for t in children:
        tracker.add(t)
    return plan_schedule(tracker.waves(), tracker.dag())


def plan_groups(op, specs):
    """The groups of ``leaf_plan(op, specs)``, in launch order."""
    return list(leaf_plan(op, specs).groups())


def arith_route(tl, name: str, tiles, n: int, lanes: int = 1) -> str:
    """The arithmetic route of one launch of ``n`` tasks of tile shapes
    ``tiles``: "3xtf32" where SYRK, GEMM or GEMMNN runs on the tensor cores
    (every output tile but GEMMNN's matrix-vector mapping's), else "fp32"
    (FMAs on the CUDA cores)."""
    import torch

    if name in TENSOR_CORE and tl.launch_shape(name, tiles, n, lanes, tl.sm_count(torch.device("cuda")))[0] != 0:
        return "3xtf32"
    return "fp32"


def bound(tl, name: str, w: int, g, grids, lanes: int = 1):
    """Least time (ms) for one group on ``lanes`` lanes: distinct input
    blocks (of every segment's grids) read once, the written blocks written
    once, against the
    operations at the peak rate of the kernel's arithmetic route: FLOPs at
    the fp32 peak, or for 3xTF32 three TF32 products a FLOP at the TF32
    peak.  Returns (ms, what bounds it, route)."""
    reads, off = set(), 0
    for slots, size in g.segments:
        for s, ix in zip(slots, g.idxs):
            reads |= {(s, int(r), int(c)) for r, c in ix[off : off + size]}
        off += size
    tile = [tuple(grids[s].shape[-2:]) for s in g.segments[0][0]]
    nbytes = (sum(grids[s].shape[-2] * grids[s].shape[-1] for s, _, _ in reads)
              + g.size * tile[w][0] * tile[w][1]) * 4 * lanes
    flops = g.size * FLOPS[name](tile) * lanes
    route = arith_route(tl, name, tile, g.size, lanes)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3 if route == "3xtf32" else flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), route


def library_call(torch, name: str, stacks):
    """One PyTorch call computing a group's function on its gathered tiles:
    the yardstick, timed here and never called by the port."""
    sl = torch.linalg.solve_triangular
    if name == "potrf":
        return lambda: torch.linalg.cholesky(stacks[0])
    if name == "trsm":
        lstack = torch.linalg.cholesky(stacks[0])
        return lambda: sl(lstack.mT, stacks[1], upper=True, left=False)
    if name == "syrk":
        return lambda: torch.baddbmm(stacks[1], stacks[0], stacks[0].mT, alpha=-1)
    if name == "gemm":
        return lambda: torch.baddbmm(stacks[2], stacks[0], stacks[1].mT, alpha=-1)
    if name == "getrf":
        return lambda: torch.linalg.lu_factor_ex(stacks[0], pivot=False)
    if name == "trsml":
        return lambda: sl(stacks[0], stacks[1], upper=False, left=True, unitriangular=True)
    if name == "trsmu":
        return lambda: sl(stacks[0], stacks[1], upper=True, left=False)
    if name == "trsmul":
        return lambda: sl(stacks[0], stacks[1], upper=True, left=True)
    return lambda: torch.baddbmm(stacks[2], stacks[0], stacks[1], alpha=-1)


def kernel_timing(torch, tl, name: str, groups, grids, pick=None, label: str = "") -> dict:
    """One kernel at the main path's shapes (its largest single-segment
    group, or the first that ``pick`` accepts), every timed call on the same
    fresh grids: the written blocks are put back before each call, untimed."""
    from repro_torch.kernels.ref import fp32_matmul

    mine = [g for g in groups if g.op.name == name and len(g.segments) == 1]
    g = next(g for g in mine if pick(g)) if pick else max(mine, key=lambda g: g.size)
    slots = g.segments[0][0]
    wa = tl.GRID_FUSED[name][1]
    w = slots[wa]
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    wr, wc = idxs[wa].long().unbind(1)
    fresh = grids[w][wr, wc]
    gk, gp = [x.clone() for x in grids], [x.clone() for x in grids]
    kern = lambda: getattr(tl, f"grid_{name}")(idxs, [gk[s] for s in slots])
    plain = lambda: getattr(tl, f"grid_{name}_plain")(idxs, [gp[s] for s in slots])
    kern()
    plain()
    torch.cuda.synchronize()
    err = close(gk[w], gp[w], TOL[name])
    lib = library_call(torch, name, [grids[s][ix[:, 0], ix[:, 1]] for s, ix in zip(slots, idxs)])
    ms = cuda_ms_fresh(kern, lambda: gk[w].index_put_((wr, wc), fresh), 20)
    plain_ms = cuda_ms_fresh(plain, lambda: gp[w].index_put_((wr, wc), fresh), 3)
    with fp32_matmul():
        lib_ms = cuda_ms(lib, 20)  # out of place: its inputs stay fresh
    bound_ms, bound_by, route = bound(tl, name, wa, g, grids)
    tiles = [tuple(grids[s].shape[-2:]) for s in slots]
    shapes = "x".join(f"{r}:{c}" for r, c in tiles)
    print(f"time  {name:6s}{label} tiles={shapes} tasks={g.size:4d}: kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, {route}) "
          f"max_abs_err={err:.3e}")
    return dict(tasks=g.size, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, arith=route, launch=(name, f"{name}{label} tasks={g.size}", kern))


def kernel_timings(torch, tl) -> dict:
    """Phase 2b: the Cholesky four at the Cholesky plan's largest groups,
    GETRF/TRSML/TRSMU/GEMMNN at the LU plan's, TRSMUL at the matrix-RHS
    LU solve plan's; then GEMMNN at the groups where the solves spend its
    launches: a 4-task group of the matrix-RHS solve plan and the largest
    q = 1 group of the vector solve plan (``gemmnn_solve4``,
    ``gemmnn_vector``), TRSML and TRSMUL at the vector solve plan's one-task
    bc = 1 groups (``trsml_vector``, ``trsmul_vector``: 32 launches each, on
    the critical path), and TRSM at the Cholesky plan's one-task group
    (``trsm_1task``: most of its 31 launches are small groups)."""
    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.linalg import GETRF, LUSOLVE, POTRF

    b = N // P
    a_spec, b_spec = ((N, N), ((P, P),)), ((N, RHS), ((P, RHS_P),))
    chol = plan_groups(POTRF, [a_spec])
    lu = plan_groups(GETRF, [a_spec])
    solve = plan_groups(LUSOLVE, [a_spec, b_spec])
    spd = [to_grid(spd_matrix(N, seed=1), b, b)]
    dd = [to_grid(dd_matrix(N, seed=1), b, b)]
    rhs = to_grid(0.3 * torch.randn(N, RHS, generator=torch.Generator().manual_seed(1)).cuda(), b, RHS // RHS_P)
    out = {}
    for name in CHOLESKY:
        out[name] = kernel_timing(torch, tl, name, chol, spd)
    for name in ("getrf", "trsml", "trsmu", "gemmnn"):  # TRSMUL is not in run_lu
        out[name] = kernel_timing(torch, tl, name, lu, dd)
    out["trsmul"] = kernel_timing(torch, tl, "trsmul", solve, dd + [rhs])
    def on_rhs(g):  # slot 1 is the right-hand side: GEMMNN updating it, not the factor
        return g.segments[0][0][2] == 1

    out["gemmnn_solve4"] = kernel_timing(torch, tl, "gemmnn", solve, dd + [rhs], label=" (solve, 4 tasks)",
                                         pick=lambda g: on_rhs(g) and g.size == 4)
    vec = plan_groups(LUSOLVE, [a_spec, ((N, 1), ((P, 1),))])
    vrhs = to_grid(0.3 * torch.randn(N, 1, generator=torch.Generator().manual_seed(3)).cuda(), b, 1)
    widest = max(g.size for g in vec if g.op.name == "gemmnn" and len(g.segments) == 1 and on_rhs(g))
    out["gemmnn_vector"] = kernel_timing(torch, tl, "gemmnn", vec, dd + [vrhs], label=" (vector solve)",
                                         pick=lambda g: on_rhs(g) and g.size == widest)
    out["trsml_vector"] = kernel_timing(torch, tl, "trsml", vec, dd + [vrhs], label=" (vector solve)",
                                        pick=lambda g: g.segments[0][0][1] == 1 and g.size == 1)
    out["trsmul_vector"] = kernel_timing(torch, tl, "trsmul", vec, dd + [vrhs], label=" (vector solve)",
                                         pick=lambda g: g.size == 1)
    out["trsm_1task"] = kernel_timing(torch, tl, "trsm", chol, spd, label=" (1 task)", pick=lambda g: g.size == 1)
    traced_launches(torch, out, "2b")
    return out


def lane_grids(torch, make, n: int, b: int, lanes: int):
    """(lanes, n/b, n/b, b, b) stacked grids of ``make(n, seed=lane)``."""
    from repro_torch.core.data import to_grid

    return torch.stack([to_grid(make(n, seed=lane), b, b) for lane in range(lanes)])


def unchanged_fails(name: str, before, want) -> None:
    """Raises unless the written grid as it was before the call fails the
    check against the plain version's result: a kernel that did nothing
    must not pass."""
    try:
        close(before, want, TOL[name])
    except AssertionError:
        return
    raise AssertionError(f"stacked {name}: the written blocks left as they were pass the check; it cannot see "
                         "the kernel")


def stacked_random_check(torch, tl, rng, name: str, g, grids) -> float:
    """Phase 2d's check at the serving shapes: the group's stacked launch, its
    LANES unstacked launches and its plain stacked version on random
    0.3-scale grids of the timed grids' shapes, argument 0's factor tiles
    made per lane as in 2a; the group's own indices; whole grids compared.
    On the timed dd/spd grids some kernels change their blocks by less than
    the tolerance, so this check, not that one, is the one that must fail a
    kernel that did nothing; the script asserts that it would."""
    import numpy as np

    slots = g.segments[0][0]
    w = slots[tl.GRID_FUSED[name][1]]
    torch.manual_seed(int(rng.integers(2**31)))
    g0 = [0.3 * torch.randn(x.shape, device=x.device) for x in grids]
    blk = np.unique(g.idxs[0], axis=0)
    b = grids[slots[0]].shape[-1]
    tiles = special_tiles(name, rng, LANES * len(blk), b)
    if tiles is not None:
        r, c = torch.from_numpy(blk).long().cuda().unbind(1)
        g0[slots[0]][:, r, c] = torch.from_numpy(tiles).cuda().view(LANES, len(blk), b, b)
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    gk, gu, gp = ([x.clone() for x in g0] for _ in range(3))
    fused = getattr(tl, f"grid_{name}")
    fused(idxs, [gk[s] for s in slots])
    for i in range(LANES):
        fused(idxs, [gu[s][i] for s in slots])
    getattr(tl, f"grid_{name}_plain")(idxs, [gp[s] for s in slots])
    torch.cuda.synchronize()
    err = max(close(x, y, TOL[name]) for x, y in zip(gk + gu, gp + gp))
    unchanged_fails(name, g0[w], gp[w])
    for k in range(len(g0)):
        if k != w and not (torch.equal(gk[k], g0[k]) and torch.equal(gu[k], g0[k])):
            raise AssertionError(f"stacked {name} wrote a grid it only reads")
    return err


def stacked_timing(torch, tl, rng, name: str, groups, grids) -> dict:
    """One kernel's stacked form at the serving shapes: its largest
    single-segment group in the template plan, on (LANES, ...) stacked
    grids; beside it the same group as LANES unstacked launches (one per
    lane), the plain stacked version, one library call on the flattened
    LANES * size stack, and the bound (LANES times one lane's).  The
    results are held against the plain version on these grids and on
    random ones (``stacked_random_check``)."""
    from repro_torch.kernels.ref import fp32_matmul

    g = max((g for g in groups if g.op.name == name and len(g.segments) == 1), key=lambda g: g.size)
    err_random = stacked_random_check(torch, tl, rng, name, g, grids)
    slots = g.segments[0][0]
    wa = tl.GRID_FUSED[name][1]
    w = slots[wa]
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    wr, wc = idxs[wa].long().unbind(1)
    fresh = grids[w][:, wr, wc]
    gk, gu, gp = ([x.clone() for x in grids] for _ in range(3))
    fused = getattr(tl, f"grid_{name}")
    kern = lambda: fused(idxs, [gk[s] for s in slots])
    lanes = lambda: [fused(idxs, [gu[s][i] for s in slots]) for i in range(LANES)]
    plain = lambda: getattr(tl, f"grid_{name}_plain")(idxs, [gp[s] for s in slots])
    kern()
    lanes()
    plain()
    torch.cuda.synchronize()
    err = max(close(gk[w], gp[w], TOL[name]), close(gu[w], gp[w], TOL[name]))

    def restore(x):
        def put():
            x[w][:, wr, wc] = fresh

        return put

    lib = library_call(torch, name, [grids[s][:, ix[:, 0].long(), ix[:, 1].long()].flatten(0, 1)
                                     for s, ix in zip(slots, idxs)])
    ms = cuda_ms_fresh(kern, restore(gk), 20)
    lanes_ms = cuda_ms_fresh(lanes, restore(gu), 5)
    plain_ms = cuda_ms_fresh(plain, restore(gp), 3)
    with fp32_matmul():
        lib_ms = cuda_ms(lib, 20)
    bound_ms, bound_by, route = bound(tl, name, wa, g, [x[0] for x in grids], LANES)
    tiles = [tuple(grids[s].shape[-2:]) for s in slots]
    shapes = "x".join(f"{r}:{c}" for r, c in tiles)
    print(f"time  {name:6s}_stacked B={LANES} tiles={shapes} tasks={g.size:3d}: kernel_ms={ms:.4f} "
          f"{LANES}_unstacked_launches_ms={lanes_ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}, {route}) max_abs_err={err:.3e} "
          f"random_grids_max_abs_err={err_random:.3e}")
    return dict(tasks=g.size, err=max(err, err_random), ms=ms, unstacked_ms=lanes_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, arith=route,
                launch=(name, f"{name}_stacked B={LANES} tasks={g.size}", kern))


def stacked_timings(torch, tl, rng) -> dict:
    """Phase 2d: each kernel's stacked form at its largest group of the
    served templates (n = 1024, 8 x 8; the Cholesky four in the Cholesky
    plan, GETRF/TRSML/TRSMU/GEMMNN in the LU plan, TRSMUL in the vector-b
    LU-solve plan) over LANES lanes."""
    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.linalg import GETRF, LUSOLVE, POTRF

    b = SN // SP
    a_spec = ((SN, SN), ((SP, SP),))
    chol = plan_groups(POTRF, [a_spec])
    lu = plan_groups(GETRF, [a_spec])
    solve = plan_groups(LUSOLVE, [a_spec, ((SN, 1), ((SP, 1),))])
    spd = [lane_grids(torch, spd_matrix, SN, b, LANES)]
    dd = [lane_grids(torch, dd_matrix, SN, b, LANES)]
    gen = torch.Generator().manual_seed(2)
    rhs = torch.randn(LANES, SP, 1, b, 1, generator=gen).cuda()
    out = {}
    for name in CHOLESKY:
        out[name] = stacked_timing(torch, tl, rng, name, chol, spd)
    for name in ("getrf", "trsml", "trsmu", "gemmnn"):
        out[name] = stacked_timing(torch, tl, rng, name, lu, dd)
    out["trsmul"] = stacked_timing(torch, tl, rng, "trsmul", solve, dd + [rhs])
    traced_launches(torch, out, "2d")
    return out


# --------------------------------------------------------------------------
# Phases 2b and 2d: groups of several segments (B5)
# --------------------------------------------------------------------------
_WP = "src/repro/core/executors/wave_program.py"
MULTISEG_REPLACES = (f"{_TL}:367 make_grid_fused (kernel :382, kernel_stacked :388, pallas_call :433) for a group "
                     f"of several segments, which the reference gathers ({_WP}:421-427 build_program)")
# the matrix-RHS solve's groups of two segments, per drain: 31 GEMMNN (A's
# trailing update and the forward solve's update of b) and 31 TRSML
SOLVE_SEGMENTED = {"gemmnn": 31, "trsml": 31}
# 2d's and 4c's stacked matrix-b solves: b (SN, SB) in SP x 1 blocks (the
# serving shape's 128 x 128 tiles), LANES systems
SB = 128
STACKED_SOLVE_SEGMENTED = {"gemmnn": 7, "trsml": 7}  # per stacked drain: the template plan's groups of two
# the multi-segment forms in the kernels line: entry -> (kernel, stacked)
MULTISEG = {"gemmnn_multiseg": ("gemmnn", False), "trsml_multiseg": ("trsml", False),
            "gemmnn_multiseg_stacked": ("gemmnn", True), "trsml_multiseg_stacked": ("trsml", True)}


def segments_of(g, grids):
    """A group's segments over ``grids`` (one per root slot): (its grids, its
    task count) each, as the launch list passes them to the fused call."""
    return [(tuple(grids[s] for s in slots), size) for slots, size in g.segments]


def gather_form(torch, tl, name: str, idxs, segments) -> None:
    """The gather path of one group (the reference's rule for a group of
    several segments, and the port's before B5's redesign): each argument's
    blocks gathered segment by segment from its grids and joined, the batched
    entry point ``batched_<name>`` on the joined stack (one launch), the
    result scattered back into each segment's written grid.  Stacked grids
    gather (B, size) blocks and flatten the two batch axes."""
    w = tl.GRID_FUSED[name][1]
    stacked = segments[0][0][0].dim() == 5
    stacks = []
    for a, ix in enumerate(idxs):
        parts, off = [], 0
        for grids, size in segments:
            r, c = ix[off : off + size].long().unbind(1)
            parts.append(grids[a][:, r, c] if stacked else grids[a][r, c])
            off += size
        stack = torch.cat(parts, dim=1 if stacked else 0)
        stacks.append(stack.flatten(0, 1) if stacked else stack)
    out = getattr(tl, f"batched_{name}")(*stacks)
    if stacked:
        out = out.reshape(segments[0][0][0].shape[0], idxs[0].shape[0], *out.shape[1:])
    off = 0
    for grids, size in segments:
        r, c = idxs[w][off : off + size].long().unbind(1)
        if stacked:
            grids[w][:, r, c] = out[:, off : off + size]
        else:
            grids[w][r, c] = out[off : off + size]
        off += size


def gather_form_program(torch, tl, plan):
    """``plan``'s launch list as the port built it before B5's redesign (and
    the reference builds it): a group of one segment on its fused grid
    kernel, a group of several on ``gather_form``; a fn (grids, flat
    indices) like ``build_program``'s."""
    steps, base = [], 0
    for g in plan.groups():
        steps.append((g.op.name, tuple(g.segments), len(g.arg_slots), g.size, base))
        base += len(g.arg_slots) * g.size

    def program(grids, idxs):
        for name, segs, n_args, size, b0 in steps:
            gidx = [idxs[b0 + a * size : b0 + (a + 1) * size] for a in range(n_args)]
            segments = [(tuple(grids[s] for s in slots), n) for slots, n in segs]
            if len(segments) == 1:
                tl.GRID_FUSED[name][0](gidx, segments[0][0])
            else:
                gather_form(torch, tl, name, gidx, segments)

    return program


def multiseg_grids(torch, rng, name: str, g, grids):
    """Random 0.3-scale grids of ``grids``' shapes, the factor argument's
    blocks of every segment made as 2a makes them (per lane where stacked)."""
    import numpy as np

    torch.manual_seed(int(rng.integers(2**31)))
    g0 = [0.3 * torch.randn(x.shape, device=x.device) for x in grids]
    off = 0
    for slots, size in g.segments:
        x = g0[slots[0]]
        blk = np.unique(g.idxs[0][off : off + size], axis=0)
        off += size
        lanes, b = (x.shape[0] if x.dim() == 5 else 1), x.shape[-1]
        tiles = special_tiles(name, rng, lanes * len(blk), b)
        if tiles is None:
            continue
        r, c = torch.from_numpy(blk).long().cuda().unbind(1)
        t = torch.from_numpy(tiles).cuda()
        if x.dim() == 5:
            x[:, r, c] = t.view(lanes, len(blk), b, b)
        else:
            x[r, c] = t
    return g0


def written_slots(tl, name: str, g):
    """The root slots a group writes, one per segment (two segments may
    write one grid)."""
    wa = tl.GRID_FUSED[name][1]
    return sorted({slots[wa] for slots, _ in g.segments})


def multiseg_check(torch, tl, rng, name: str, g, grids) -> float:
    """One group of several segments on random grids (``multiseg_grids``):
    the fused call must be exactly one launch, counted as a segmented one,
    equal the gather form bit for bit and the plain version within TOL; the
    written grids left as they were must fail that check, and no grid it
    only reads may change.  Returns the error against the plain version."""
    g0 = multiseg_grids(torch, rng, name, g, grids)
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    gk, gg, gp = ([x.clone() for x in g0] for _ in range(3))
    counter = tl.STACKED_LAUNCHES if g0[0].dim() == 5 else tl.LAUNCHES
    before = (counter[name], tl.SEGMENTED_LAUNCHES[name])
    getattr(tl, f"grid_{name}")(idxs, segments_of(g, gk))
    launched = (counter[name] - before[0], tl.SEGMENTED_LAUNCHES[name] - before[1])
    gather_form(torch, tl, name, idxs, segments_of(g, gg))
    getattr(tl, f"grid_{name}_plain")(idxs, segments_of(g, gp))
    torch.cuda.synchronize()
    if launched != (1, 1):
        raise AssertionError(f"{name} over {len(g.segments)} segments: (launches, segmented) {launched} != (1, 1)")
    if not all(torch.equal(x, y) for x, y in zip(gk, gg)):
        diff = max((x - y).abs().max().item() for x, y in zip(gk, gg))
        raise AssertionError(f"{name} over {len(g.segments)} segments differs from its gather form by {diff:.3e}")
    err = max(close(x, y, TOL[name]) for x, y in zip(gk, gp))
    written = written_slots(tl, name, g)
    for w in written:
        unchanged_fails(name, g0[w], gp[w])
    for k in range(len(g0)):
        if k not in written and not torch.equal(gk[k], g0[k]):
            raise AssertionError(f"{name} over {len(g.segments)} segments wrote a grid it only reads")
    return err


def multiseg_timing(torch, tl, rng, name: str, g, grids, label: str) -> dict:
    """A group of several segments (B5): checked on random grids
    (``multiseg_check``), then on ``grids`` (the main path's values) the
    fused call, one in-place launch, against the gather form built from the
    plan's indices and the batched entry point (bit for bit) and the plain
    version (TOL); each timed on the same fresh grids (the written blocks put
    back before each call, untimed) beside the bound.  The gather form's time
    stands in the library column: no single PyTorch call gathers, computes
    and scatters over grids."""
    err_random = multiseg_check(torch, tl, rng, name, g, grids)
    stacked = grids[0].dim() == 5
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    wa = tl.GRID_FUSED[name][1]
    fresh, off = [], 0
    for slots, size in g.segments:
        r, c = idxs[wa][off : off + size].long().unbind(1)
        fresh.append((slots[wa], r, c, (grids[slots[wa]][:, r, c] if stacked else grids[slots[wa]][r, c]).clone()))
        off += size
    gk, gg, gp = ([x.clone() for x in grids] for _ in range(3))
    kern = lambda: getattr(tl, f"grid_{name}")(idxs, segments_of(g, gk))
    gath = lambda: gather_form(torch, tl, name, idxs, segments_of(g, gg))
    plain = lambda: getattr(tl, f"grid_{name}_plain")(idxs, segments_of(g, gp))
    kern()
    gath()
    plain()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(gk, gg)):
        raise AssertionError(f"{name}{label} differs from its gather form on the main path's grids")
    err = max(close(gk[w], gp[w], TOL[name]) for w in written_slots(tl, name, g))

    def restore(x):
        def put():
            for w, r, c, f in fresh:
                if stacked:
                    x[w][:, r, c] = f
                else:
                    x[w][r, c] = f

        return put

    lanes = grids[0].shape[0] if stacked else 1
    ms = cuda_ms_fresh(kern, restore(gk), 20)
    gather_ms = cuda_ms_fresh(gath, restore(gg), 10)
    plain_ms = cuda_ms_fresh(plain, restore(gp), 3)
    bound_ms, bound_by, route = bound(tl, name, wa, g, [x[0] for x in grids] if stacked else grids, lanes)
    sizes = "+".join(str(n) for _, n in g.segments)
    tiles = "x".join(f"{r}:{c}" for r, c in (tuple(grids[s].shape[-2:]) for s in g.segments[0][0]))
    print(f"time  {name:6s}{label} tiles={tiles} tasks={g.size} ({sizes}) lanes={lanes}: kernel_ms={ms:.4f} "
          f"gather_form_ms={gather_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, {route}) "
          f"max_abs_err={err:.3e} random_grids_max_abs_err={err_random:.3e} equal_to_gather_form=bit_for_bit")
    return dict(tasks=g.size, segments=[n for _, n in g.segments], err=max(err, err_random), ms=ms,
                plain_ms=plain_ms, library_ms=gather_ms, gather_ms=gather_ms, bound_ms=bound_ms, bound_by=bound_by,
                arith=route, lanes=lanes, launch=(name, f"{name}{label} tasks={g.size}", kern))


def multiseg_group(groups, name: str):
    """The widest group of ``name`` over several segments."""
    return max((g for g in groups if g.op.name == name and len(g.segments) > 1), key=lambda g: g.size)


def multiseg_timings(torch, tl, rng) -> dict:
    """Phase 2b, B5: the matrix-RHS solve plan's widest GEMMNN group of two
    segments (961 + 124 tasks: A's trailing update and the forward solve's
    update of b) and its widest TRSML group of two, on the n = N solve's
    grids (A dd, b (N, RHS) in P x RHS_P blocks)."""
    from repro_torch.core import dd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.linalg import LUSOLVE

    b = N // P
    solve = plan_groups(LUSOLVE, [((N, N), ((P, P),)), ((N, RHS), ((P, RHS_P),))])
    grids = [to_grid(dd_matrix(N, seed=1), b, b),
             to_grid(0.3 * torch.randn(N, RHS, generator=torch.Generator().manual_seed(1)).cuda(), b, RHS // RHS_P)]
    out = {}
    for name in ("gemmnn", "trsml"):
        out[f"{name}_multiseg"] = multiseg_timing(torch, tl, rng, name, multiseg_group(solve, name), grids,
                                                  " (solve, segments)")
    traced_launches(torch, out, "2b_multiseg")
    return out


def stacked_multiseg_timings(torch, tl, rng) -> dict:
    """Phase 2d, B5: the widest GEMMNN and TRSML groups of two segments of
    the stacked matrix-b solve at the serving shape (n = SN in SP x SP, b
    (SN, SB) in SP x 1, LANES lanes)."""
    from repro_torch.core import dd_matrix
    from repro_torch.linalg import LUSOLVE

    b = SN // SP
    solve = plan_groups(LUSOLVE, [((SN, SN), ((SP, SP),)), ((SN, SB), ((SP, 1),))])
    grids = [lane_grids(torch, dd_matrix, SN, b, LANES),
             torch.randn(LANES, SP, 1, b, SB, generator=torch.Generator().manual_seed(4)).cuda()]
    out = {}
    for name in ("gemmnn", "trsml"):
        out[f"{name}_multiseg_stacked"] = multiseg_timing(torch, tl, rng, name, multiseg_group(solve, name), grids,
                                                          f"_stacked B={LANES} (matrix-b solve, segments)")
    traced_launches(torch, out, "2d_multiseg")
    return out


# --------------------------------------------------------------------------
# Phases 3 and 4: the main paths
# --------------------------------------------------------------------------
TASK_BINS = (1, 4, 16, 64, 256, 1024, 4096)  # upper edges of the CTAs-per-launch bins
# profiler sessions to try before a trace that lost device events stands
TRACE_ATTEMPTS = 3
# the kernel torch.cuda._sleep launches: each profiler session starts with one,
# left out of every count (a session's first device events can go missing)
WARMUP_KERNEL = "spin_kernel"


def warm_up(torch) -> None:
    """Inside a fresh profiler session: one short device sleep, finished."""
    torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def kernel_events(prof, path: Path):
    """The tile kernels' device events of a profiler run, read from its
    trace written to ``path``: (kernel name, trace event) pairs."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    for ev in trace.get("traceEvents", []) if isinstance(trace, dict) else trace:
        m = re.search(r"(\w+)_kernel\b", ev.get("name", ""))
        if ev.get("cat") == "kernel" and m and m.group(1) in KERNELS:
            yield m.group(1), ev


def traced_launches(torch, timings: dict, phase: str) -> None:
    """What the timed calls of a phase launched, as the profiler recorded
    it: each entry's ``launch`` (kernel name, label, one call) runs once,
    all in one profiler session, each call one kernel launch.  Prints a
    ``launch`` line for each (CTAs of all lanes, threads, registers a thread
    and shared memory a CTA, static and dynamic) and sets the entry's
    ``ctas``, None where the trace does not hold it (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    calls = [t.pop("launch") for t in timings.values()]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_up(torch)
            for _, _, run in calls:
                run()
                torch.cuda.synchronize()
        events = sorted(kernel_events(prof, ROOT / "build" / "traces" / f"launches_{phase}.json"),
                        key=lambda e: e[1].get("ts", 0))
        matched = [k for k, _ in events] == [name for name, _, _ in calls]
        if matched:
            break
        print(f"launch {phase}: the trace holds tile kernels {[k for k, _ in events]}, not one for each of the "
              f"{len(calls)} timed calls (attempt {attempt} of {TRACE_ATTEMPTS})"
              + ("" if attempt < TRACE_ATTEMPTS else "; CTAs not measured"))
    found = [ev.get("args", {}) for _, ev in events] if matched else [{}] * len(calls)
    for t, (_, label, _), args in zip(timings.values(), calls, found):
        t["ctas"] = math.prod(args["grid"]) if "grid" in args else None
        if t["ctas"] is not None:
            print(f"launch {label}: ctas={t['ctas']} grid={args['grid']} threads={math.prod(args.get('block', [0]))} "
                  f"registers={args.get('registers per thread')} smem_bytes={args.get('shared memory')}")


def by_launch_size(prof, path: Path) -> str:
    """Device time of each kernel split by its launches' CTA counts (all
    lanes' CTAs of a launch, binned), read from the profiler's trace
    written to ``path``."""
    bins = {}
    for name, ev in kernel_events(prof, path):
        grid = ev.get("args", {}).get("grid")
        if grid is None:
            continue
        tasks = grid[0] * (grid[1] if len(grid) > 1 else 1)
        hi = next((e for e in TASK_BINS if tasks <= e), tasks)
        lo = max((e + 1 for e in TASK_BINS if e < hi), default=1)
        key = (name, lo, hi)
        n, us = bins.get(key, (0, 0.0))
        bins[key] = (n + 1, us + ev["dur"])
    if not bins:
        return "no kernel launch sizes in the trace (not measured)"
    return " ".join(f"{k}[{lo}-{hi}]={us / 1e3:.3f}ms/{n}" for (k, lo, hi), (n, us) in sorted(bins.items()))


def tile_kernel(name: str) -> str:
    """The tile kernel a device event belongs to, or "other"."""
    m = re.search(r"(\w+)_kernel\b", name)
    return m.group(1) if m and m.group(1) in KERNELS else "other"


def device_busy(prof, classify=tile_kernel):
    """(busy us, span us, {group: (events, us)}) of a profiler session's
    device events, the warm-up kernel left out: busy is the union of the
    events' intervals, span the first start to the last end."""
    from torch.autograd import DeviceType

    spans, by = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or WARMUP_KERNEL in ev.name:
            continue
        tr = ev.time_range
        spans.append((tr.start, tr.end))
        name = classify(ev.name)
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + tr.elapsed_us())
    if not spans:
        return 0.0, 0.0, by
    spans.sort()
    busy, (cs, ce) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > ce:
            busy, cs, ce = busy + (ce - cs), s0, e0
        else:
            ce = max(ce, e0)
    busy += ce - cs
    return busy, max(e for _, e in spans) - spans[0][0], by


def profiled(torch, label: str, run, classify=tile_kernel, expect=None) -> bool:
    """Where one run's time goes: device time by kernel from torch.profiler
    (grouped by ``classify`` of the kernel's name), the union of
    device-busy intervals, the idle share of the device span (first kernel
    start to last kernel end), and the host's dispatch time (``run()``
    returning) beside the wall time (the card done).  ``run`` returns a
    string of its own counters to print.  With ``expect`` (kernel -> the
    launches the run makes), returns False, after printing nothing but that,
    when the trace holds other counts: the profiler lost device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm_up(torch)
        t0 = time.perf_counter()
        info = run()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, span, by = device_busy(prof, classify)
    if not by:
        print(f"{label} profile: no device events recorded (wall_ms={wall_ms:.3f}); device time not measured")
        return False
    got = {k: by.get(k, (0, 0.0))[0] for k in expect or {}}
    if got != (expect or {}):
        print(f"{label} profile: the trace holds launches {got}, not {expect}: device events lost")
        return False
    parts = " ".join(f"{k}={v[1] / 1e3:.3f}ms/{v[0]}" for k, v in sorted(by.items()))
    print(f"{label} profile (profiler on): {info} wall_ms={wall_ms:.3f} host_dispatch_ms={host_ms:.3f} "
          f"device_span_ms={span / 1e3:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"idle_share_of_span={1 - busy / span:.3f} by_kernel: {parts}")
    if classify is tile_kernel:
        trace = ROOT / "build" / "traces" / f"{re.sub(r'[^0-9A-Za-z]+', '_', label).strip('_')}.json"
        print(f"{label} device time by CTAs per launch: {by_launch_size(prof, trace)}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"{label} host ops by self time (profiler on): "
          + " ".join(f"{e.key}={e.self_cpu_time_total / 1e3:.3f}ms/{e.count}" for e in host))
    return True


def host_functions(label: str, run, top: int = 10) -> None:
    """Where one run's host time goes by Python function: cProfile's own
    time of the ``top`` functions (the profiler inflates it; the shares are
    what is read)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    run()
    total = time.perf_counter() - t0
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"{label} host functions by own time (cProfile on, run {total * 1e3:.3f} ms): "
          + " ".join(f"{Path(f).name}:{line}({fn})={tt * 1e3:.3f}ms/{nc}"
                     for (f, line, fn), (_, nc, tt, _, _) in rows))


def replay_breakdown(torch, label: str, submit, expect: dict) -> None:
    """``profiled`` over one replay drain: ``submit`` puts a structurally
    repeated drain's roots on a fresh dispatcher, whose drain launches the
    kernels ``expect`` counts; a trace that lost some of them is taken
    again, up to TRACE_ATTEMPTS times in all (device time not measured if
    every one did)."""
    from repro_torch.core import Dispatcher

    for attempt in range(TRACE_ATTEMPTS):
        d = Dispatcher(graph="g2p")
        submit(d)

        def run():
            d.run()
            return f"memo_hits={d.stats['memo_hits']}"

        if profiled(torch, f"{label} replay", run, expect=expect):
            d = Dispatcher(graph="g2p")
            submit(d)
            host_functions(f"{label} replay", d.run)
            d.executor.sync()
            return
    print(f"{label} replay: {TRACE_ATTEMPTS} profiler traces all lost device events; device time not measured")


def captured_vs_eager(torch, tl, d, inputs, exact: bool, tol: float) -> float:
    """The dispatcher's last launch list run eagerly (no graph) on ``inputs``
    (its roots, in slot order) in grid form, held against the captured run's
    result grids: bit for bit where ``exact`` (the hand-written kernels fix
    their reduction order), else within ``tol``.  Returns the largest
    difference; the eager run's launches are left out of the counters."""
    from repro_torch.core.data import to_grid

    prog = d.executor.last_program
    if prog is None or not prog.captured:
        raise AssertionError("the drain did not run a captured graph")
    grids = [to_grid(x, *g.shape[-2:]) for x, g in zip(inputs, prog.grids)]
    counts = [dict(c) for c in tl.COUNTERS]
    prog.fn(grids, prog.idxs)
    for c, saved in zip(tl.COUNTERS, counts):
        c.update(saved)
    diff = max((e.double() - g.double()).abs().max().item() for e, g in zip(grids, prog.grids))
    if (exact and not all(torch.equal(e, g) for e, g in zip(grids, prog.grids))) or not diff <= tol:
        raise AssertionError(f"captured result differs from the eager launch list by {diff:.3e} "
                             f"({'bit for bit' if exact else f'tolerance {tol}'})")
    return diff


def replay_idle(torch, graph: str, submit, mesh=None) -> tuple:
    """(device busy ms, device span ms) of one more drain of ``submit``'s
    program on a fresh dispatcher (a memo replay), in a profiler session
    that traces the card only: the idle share of a drain's device span,
    read apart from its host timing (the tracer slows a graph launch)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Dispatcher

    d = Dispatcher(graph=graph, mesh=mesh)
    submit(d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm_up(torch)
        d.run()
        d.executor.sync()
    busy, span, _ = device_busy(prof)
    return busy / 1e3, span / 1e3


def drain_checked(torch, tl, label: str, graph: str, submit, inputs, want: tuple, want_launches: dict, error,
                  tol: float, flops: float, mesh=None, want_segmented=None):
    """Drain one program on ``graph`` (over ``mesh`` for a distributed graph)
    between zeroed and read kernel counters; check its structural counters,
    that every launch list ran a captured graph, its kernel launches (and
    those of them over several segments: ``want_segmented``, none by
    default) and its error, and hold its captured result against the eager
    launch list on the same ``inputs`` (a one-list drain; None skips it).
    Prints whether it ran captured graphs, its host dispatch and wall, and
    the device's idle share of a replay's span (``replay_idle``); keeps them
    in DRAIN_TIMES and the segmented launches in SEGMENTED_BY_GRAPH.
    Returns the launch counts and the error."""
    from repro_torch.core import Dispatcher

    d = Dispatcher(graph=graph, mesh=mesh)
    datas = submit(d)
    torch.cuda.synchronize()
    tl.reset_launches()
    t0 = time.perf_counter()
    leaves = d.run()
    t_host = time.perf_counter() - t0
    d.executor.sync()  # the drain's launch list, still in flight
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in tl.LAUNCHES.items() if v}
    segmented = {k: v for k, v in tl.SEGMENTED_LAUNCHES.items() if v}
    err = error(*datas)
    diff = None if inputs is None else captured_vs_eager(torch, tl, d, inputs, graph == "g2p", tol)
    busy, span = replay_idle(torch, graph, submit, mesh)
    st = d.executor.stats
    DRAIN_TIMES[label] = (wall, t_host, st["launches"])
    diff_s = "not_run" if diff is None else f"{diff:.3e}"
    print(f"{label} drain: leaves={leaves} groups={st['groups']} prefusion={st['groups_prefusion']} "
          f"slots={st['slots']} compiles={st.get('compiles', 0)} launches={st['launches']} "
          f"memo_hits={d.stats['memo_hits']} graph={'captured' if st.get('graph_replays') else 'eager'} "
          f"graph_replays={st.get('graph_replays', 0)} "
          f"kernel_launches={counts} of_several_segments={segmented} wall_ms={wall * 1e3:.3f} "
          f"host_dispatch_ms={t_host * 1e3:.3f} "
          f"gflops={flops / wall / 1e9:.1f} max_abs_err_vs_f64={err:.3e} captured_vs_eager_max_diff={diff_s}; "
          f"a replay traced: device_busy_ms={busy:.3f} device_span_ms={span:.3f} "
          f"idle_share_of_span={1 - busy / span if span else float('nan'):.3f}")
    if err > tol:
        raise AssertionError(f"{label} drain error {err:.3e} > {tol}")
    got = (leaves, st["groups"], st["groups_prefusion"], st["slots"], st.get("compiles", 0),
           st["launches"], d.stats["memo_hits"], st.get("graph_replays", 0))
    if got != want + (want[5],):  # every launch list a graph replay
        raise AssertionError(f"{label} counters (with graph replays) {got} != {want + (want[5],)}")
    if counts != want_launches:
        raise AssertionError(f"{label} kernel launches {counts} != {want_launches}")
    if segmented != (want_segmented or {}):
        raise AssertionError(f"{label} launches over several segments {segmented} != {want_segmented or {}}")
    by_graph = SEGMENTED_BY_GRAPH.setdefault(graph, {})
    for k, v in segmented.items():
        by_graph[k] = by_graph.get(k, 0) + v
    return counts, err


# label -> (wall s, host dispatch s, launch lists) of each checked drain
DRAIN_TIMES = {}
# graph -> kernel -> launches over several segments, summed over checked drains
SEGMENTED_BY_GRAPH = {}

# each path's first drain (seed 0), a replay on fresh inputs (seed 1: a
# replay that skipped its copy-in fails its error check) and a replay on the
# first drain's inputs (its error is the one ACCURACY holds)
DRAINS = (("first ", 0), ("replay", 1), ("replay", 0))


def main_path(torch, tl) -> dict:
    """Phase 3: the Cholesky drains on g2p then g2 (DRAINS), then g1."""
    from repro_torch.core import GData, spd_matrix
    from repro_torch.core.data import from_grid
    from repro_torch.core.executors import clear_compile_cache, drain_memo_stats
    from repro_torch.linalg import run_cholesky, utp_cholesky

    mats = {seed: spd_matrix(N, seed=seed) for seed in (0, 1)}
    refs = {seed: torch.linalg.cholesky(a.double()) for seed, a in mats.items()}
    a = mats[0]
    clear_compile_cache()
    launches = {k: 0 for k in tl.LAUNCHES}

    def submitter(seed):
        def submit(d):
            A = GData(a.shape, partitions=((P, P),), value=mats[seed])
            utp_cholesky(d, A)
            return (A,)

        return submit

    def error(seed):
        return lambda A: (torch.tril(from_grid(A.grid)).double() - refs[seed]).abs().max().item()

    for graph, want_launches in (("g2p", EXPECTED_LAUNCHES), ("g2", {})):
        for drain, seed in DRAINS:
            first = drain == "first "
            want = (5984, 124, 124, 94, int(first), 1, int(not first))
            counts, err = drain_checked(torch, tl, f"{graph:3s} cholesky {drain} seed={seed}", graph,
                                        submitter(seed), [mats[seed]], want, want_launches, error(seed), 2e-4,
                                        N**3 / 3)
            if graph == "g2p" and seed == 0:
                accuracy_held("cholesky", err)
            for k, v in counts.items():
                launches[k] += v
    print(f"drain memo: {drain_memo_stats()}")
    replay_breakdown(torch, "cholesky", submitter(0), EXPECTED_LAUNCHES)
    replay_ms = cuda_ms(lambda: run_cholesky(a, graph="g2p", partitions=((P, P),)), 3, warmup=1)
    g2_ms = cuda_ms(lambda: run_cholesky(a, graph="g2", partitions=((P, P),)), 3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(a), 10)
    print(f"run_cholesky (memo replay, incl. ingest and de-grid) g2p ms={replay_ms:.3f} g2 ms={g2_ms:.3f}; "
          f"library torch.linalg.cholesky ms={lib_ms:.3f}")
    a1 = spd_matrix(256, seed=256)
    L1 = run_cholesky(a1, graph="g1", partitions=((4, 4),))
    e1 = (L1.double() - torch.linalg.cholesky(a1.double())).abs().max().item()
    print(f"g1  n=256: max_abs_err_vs_f64={e1:.3e}")
    if e1 > 2e-4:
        raise AssertionError(f"g1 error {e1:.3e} > 2e-4")
    return launches


def pool_bytes(torch, graph) -> tuple:
    """(reserved, allocated) bytes of a captured graph's private memory pool:
    its segments in the allocator's snapshot."""
    pool = tuple(graph.pool())
    segs = [x for x in torch.cuda.memory._snapshot()["segments"] if tuple(x.get("segment_pool_id") or ()) == pool]
    return (sum(x["total_size"] for x in segs),
            sum(b["size"] for x in segs for b in x["blocks"] if b["state"] == "active_allocated"))


def lists_compared(torch, tl, label: str, specs, inputs, result) -> None:
    """B5 on the main path: one LUSOLVE root's launch list over ``specs``
    (A and b), built in the gather form (``gather_form_program``: the port's
    list before B5's redesign, the reference's rule) and in place
    (``build_program``), each captured into a CUDA graph over static grids
    holding ``inputs``.  Their results must equal each other and the
    entry point's ``result`` bit for bit.  Prints, for each, a replay's
    device time (CUDA events, inputs put back before each), and from a
    traced replay the device busy time, span, idle share, the device ops (the
    graph's kernel and copy nodes) with the tile kernels' and the rest's (the
    gathers, joins and scatters) apart, and its pool's bytes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.data import from_grid, to_grid
    from repro_torch.core.executors import build_program
    from repro_torch.core.executors.captured import CapturedProgram
    from repro_torch.linalg import LUSOLVE

    plan = leaf_plan(LUSOLVE, specs)
    grid_specs = [((d.shape[0] // br, d.shape[1] // bc, br, bc), d.dtype)
                  for d, (br, bc) in zip((plan.datas[k] for k in plan.roots_order), plan.blocks)]
    outs, numbers = {}, {}
    for kind, fn in (("gather_form", gather_form_program(torch, tl, plan)), ("in_place", build_program(plan, "cuda"))):
        counts = [dict(c) for c in tl.COUNTERS]
        prog = CapturedProgram(fn, grid_specs, plan.flat_idxs)

        def restore(prog=prog):
            for g, x, (br, bc) in zip(prog.grids, inputs, plan.blocks):
                to_grid(x, br, bc, out=g)

        restore()
        prog.graph.replay()
        torch.cuda.synchronize()
        outs[kind] = [g.clone() for g in prog.grids]
        ms = cuda_ms_fresh(prog.graph.replay, restore, 10)
        restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            warm_up(torch)
            prog.graph.replay()
            torch.cuda.synchronize()
        busy, span, by = device_busy(prof)
        tiles = sum(n for k, (n, _) in by.items() if k != "other")
        other_n, other_us = by.get("other", (0, 0.0))
        if kind == "in_place" and other_n:
            raise AssertionError(f"{label}: the in-place list's replay ran {other_n} ops besides the tile kernels")
        reserved, allocated = pool_bytes(torch, prog.graph)
        numbers[kind] = (ms, busy)
        print(f"phase 4 {label} {kind} list, captured: replay_ms={ms:.4f} device_busy_ms={busy / 1e3:.3f} "
              f"device_span_ms={span / 1e3:.3f} idle_share_of_span={1 - busy / span if span else float('nan'):.3f} "
              f"device_ops={tiles + other_n} (tile_kernels={tiles}, other={other_n} in {other_us / 1e3:.3f} ms) "
              f"pool_reserved_bytes={reserved} pool_allocated_bytes={allocated}")
        for c, saved in zip(tl.COUNTERS, counts):  # these runs are no drain's
            c.clear()
            c.update(saved)
        del prog
    for g, h in zip(outs["gather_form"], outs["in_place"]):
        if not torch.equal(g, h):
            raise AssertionError(f"{label}: the in-place list differs from the gather form by "
                                 f"{(g - h).abs().max().item():.3e}")
    if not torch.equal(from_grid(outs["in_place"][1]), result):
        raise AssertionError(f"{label}: the entry point's result differs from the captured lists'")
    (g_ms, g_busy), (p_ms, p_busy) = numbers["gather_form"], numbers["in_place"]
    print(f"phase 4 {label}: in place = gather form = the entry point's result, bit for bit; replay_ms "
          f"{g_ms:.4f} -> {p_ms:.4f} (x{p_ms / g_ms:.3f}), device_busy_ms {g_busy / 1e3:.3f} -> {p_busy / 1e3:.3f}")


def stacked_solve_path(torch, tl) -> None:
    """Phase 4c: LANES matrix-b systems (n = SN in SP x SP, b (SN, SB) in
    SP x 1) in one stacked drain through ``run_lu_solve_batched``, the first
    drain (capture) and a memo replay, each between zeroed and read launch
    counts: every launch stacked, STACKED_SOLVE_SEGMENTED of them over two
    segments, the solutions within 1e-3 of float64."""
    import numpy as np

    from repro_torch.core import dd_matrix
    from repro_torch.linalg import run_lu_solve_batched

    mats = [dd_matrix(SN, seed=100 + i) for i in range(LANES)]
    rhss = [torch.from_numpy(np.random.default_rng(100 + i).standard_normal((SN, SB)).astype(np.float32)).cuda()
            for i in range(LANES)]
    want = torch.linalg.solve(torch.stack(mats).double(), torch.stack(rhss).double())
    for drain in ("first ", "replay"):
        torch.cuda.synchronize()
        tl.reset_launches()
        t0 = time.perf_counter()
        xs = run_lu_solve_batched(mats, rhss, graph="g2p", partitions=((SP, SP),), b_partitions=((SP, 1),))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stacked = {k: v for k, v in tl.STACKED_LAUNCHES.items() if v}
        segmented = {k: v for k, v in tl.SEGMENTED_LAUNCHES.items() if v}
        err = (torch.stack(xs).double() - want).abs().max().item()
        print(f"phase 4c run_lu_solve_batched {LANES} x n={SN} b=({SN},{SB}) {drain}: wall_ms={wall * 1e3:.3f} "
              f"stacked_launches={stacked} of_several_segments={segmented} unstacked={sum(tl.LAUNCHES.values())} "
              f"max_abs_err_vs_f64={err:.3e}")
        if segmented != STACKED_SOLVE_SEGMENTED or any(tl.LAUNCHES.values()) or not err <= 1e-3:
            raise AssertionError(f"phase 4c {drain}: segmented {segmented}, unstacked {dict(tl.LAUNCHES)}, "
                                 f"error {err:.3e}")
        by = SEGMENTED_BY_GRAPH.setdefault("g2p stacked", {})
        for k, v in segmented.items():
            by[k] = by.get(k, 0) + v


def lu_main_path(torch, tl) -> dict:
    """Phase 4: run_lu's and run_lu_solve's g2p drains (DRAINS; the vector
    RHS first drain only), a profiled replay, the matrix solve's drains on
    g2, and g1."""
    import numpy as np

    from repro_torch.core import GData, dd_matrix
    from repro_torch.core.data import from_grid
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.linalg import run_inv, run_lu, run_lu_solve, utp_getrf, utp_lu_solve

    mats = {seed: dd_matrix(N, seed=seed) for seed in (0, 1)}
    rhs = {seed: torch.from_numpy(np.random.default_rng(seed).standard_normal((N, RHS)).astype(np.float32)).cuda()
           for seed in (0, 1)}
    a, bm = mats[0], rhs[0]
    bv = bm[:, 0].contiguous()
    ref_lu = {seed: torch.linalg.lu_factor_ex(m.double(), pivot=False).LU for seed, m in mats.items()}  # float64
    ref_xm = {seed: torch.linalg.solve(m.double(), rhs[seed].double()) for seed, m in mats.items()}
    ref_xv = torch.linalg.solve(a.double(), bv.double()[:, None])
    launches = {k: 0 for k in tl.LAUNCHES}

    def lu_submit(seed):
        def submit(d):
            A = GData(a.shape, partitions=((P, P),), value=mats[seed])
            utp_getrf(d, A)
            return (A,)

        return submit

    def solve_submit(seed, b, parts):
        def submit(d):
            A = GData(a.shape, partitions=((P, P),), value=mats[seed])
            B = GData(tuple(b.shape), partitions=parts, value=b)
            utp_lu_solve(d, A, B)
            return (B,)

        return submit

    def grid_error(ref):
        return lambda X: (from_grid(X.grid).double() - ref).abs().max().item()

    lu_launches = {"getrf": 32, "trsml": 31, "trsmu": 31, "gemmnn": 31}
    solve_launches = {"getrf": 32, "trsml": 32, "trsmu": 31, "trsmul": 32, "gemmnn": 527}
    vec_launches = {"getrf": 32, "trsml": 63, "trsmu": 31, "trsmul": 32, "gemmnn": 558}
    matrix = solve_submit(0, bm, ((P, RHS_P),))
    solve_flops = 2 * N**3 / 3 + 2 * N * N * RHS
    runs = []
    for drain, seed in DRAINS:
        first = drain == "first "
        runs.append(("run_lu", f"g2p run_lu {drain} seed={seed}", "g2p", lu_submit(seed), [mats[seed]],
                     (11440, 125, 125, 94, int(first), 1, int(not first)), lu_launches, grid_error(ref_lu[seed]),
                     2e-4, 2 * N**3 / 3, seed))
    for graph, want_launches in (("g2p", solve_launches), ("g2", {})):
        for drain, seed in DRAINS[: 3 if graph == "g2p" else 2]:
            first = drain == "first "
            runs.append(("lu_solve", f"{graph:3s} lu_solve b=({N},{RHS}) {drain} seed={seed}", graph,
                         solve_submit(seed, rhs[seed], ((P, RHS_P),)), [mats[seed], rhs[seed]],
                         (15664, 654, 716, 623, int(first), 1, int(not first)), want_launches,
                         grid_error(ref_xm[seed]), 1e-3, solve_flops, seed))
        if graph == "g2p":
            runs.append(("lu_solve_vector", f"g2p lu_solve b=({N},) first  seed=0", "g2p",
                         solve_submit(0, bv[:, None], ((P, 1),)), [a, bv[:, None]], (12496, 716, 716, 623, 1, 1, 0),
                         vec_launches, grid_error(ref_xv), 1e-3, 2 * N**3 / 3 + 2 * N * N, 0))
    for kind, label, graph, submit, inputs, want, want_launches, error, tol, flops, seed in runs:
        segmented = SOLVE_SEGMENTED if kind == "lu_solve" and graph == "g2p" else None
        counts, err = drain_checked(torch, tl, label, graph, submit, inputs, want, want_launches, error, tol, flops,
                                    want_segmented=segmented)
        if graph == "g2p" and seed == 0:
            accuracy_held(kind, err)
        for k, v in counts.items():
            launches[k] += v
    replay_breakdown(torch, f"lu_solve b=({N},{RHS})", matrix, solve_launches)

    lu_ms = cuda_ms(lambda: run_lu(a, graph="g2p", partitions=((P, P),)), 3, warmup=1)
    solve_ms = cuda_ms(lambda: run_lu_solve(a, bm, graph="g2p", partitions=((P, P),),
                                            b_partitions=((P, RHS_P),)), 3, warmup=1)
    # B5: the matrix-RHS solve's and the inverse's launch lists in place and
    # in the gather form, each captured, on the same inputs
    x = run_lu_solve(a, bm, graph="g2p", partitions=((P, P),), b_partitions=((P, RHS_P),))
    lists_compared(torch, tl, f"lu_solve b=({N},{RHS})", [((N, N), ((P, P),)), ((N, RHS), ((P, RHS_P),))],
                   [a, bm], x)
    eye = torch.eye(N, device=a.device)
    inv_ms = cuda_ms(lambda: run_inv(a, graph="g2p", partitions=((P, P),)), 3, warmup=1)
    inv = run_inv(a, graph="g2p", partitions=((P, P),))
    e_inv = (inv.double() @ a.double() - eye.double()).abs().max().item()
    print(f"g2p run_inv n={N} (memo replay, incl. ingest and de-grid) ms={inv_ms:.3f}: max_abs_err of inv @ a vs "
          f"I={e_inv:.3e}")
    if not e_inv <= 1e-4:
        raise AssertionError(f"g2p run_inv error {e_inv:.3e} > 1e-4")
    lists_compared(torch, tl, f"run_inv n={N}", [((N, N), ((P, P),)), ((N, N), ((P, P),))], [a, eye], inv)
    del inv, eye
    sl = torch.linalg.solve_triangular

    def library_solve():
        lu = torch.linalg.lu_factor_ex(a, pivot=False).LU
        return sl(lu, sl(lu, bm, upper=False, left=True, unitriangular=True), upper=True, left=True)

    with fp32_matmul():
        lib_lu_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(a, pivot=False), 10)
        lib_solve_ms = cuda_ms(library_solve, 10)
        e_lib = (library_solve().double() - ref_xm[0]).abs().max().item()
    print(f"g2p run_lu (memo replay, incl. ingest and unpack) ms={lu_ms:.3f}; library lu_factor_ex(pivot=False) "
          f"ms={lib_lu_ms:.3f}")
    print(f"g2p run_lu_solve b=({N},{RHS}) (memo replay, incl. ingest and de-grid) ms={solve_ms:.3f}; library "
          f"lu_factor_ex(pivot=False) + 2 solve_triangular ms={lib_solve_ms:.3f} (its max_abs_err_vs_f64={e_lib:.3e})")

    stacked_solve_path(torch, tl)

    a1 = dd_matrix(256, seed=256)
    inv = run_inv(a1, graph="g1", partitions=((4, 4),))
    e1 = (inv.double() @ a1.double() - torch.eye(256, dtype=torch.float64, device=a1.device)).abs().max().item()
    print(f"g1  run_inv n=256: max_abs_err of inv @ a vs I={e1:.3e}")
    if e1 > 1e-4:
        raise AssertionError(f"g1 run_inv error {e1:.3e} > 1e-4")
    return launches


# --------------------------------------------------------------------------
# Phase 4b: the distributed graphs on a world-size-1 mesh
# --------------------------------------------------------------------------
# two levels: 4 x 4 blocks of 1024, each split 8 x 8 into phase 3's 128 x 128
# tiles; the LU solve's b (N, RHS) in 4 x 4 then 8 x 1 (leaves 128 x 128)
DIST_P, DIST_B_P = ((4, 4), (8, 8)), ((4, 4), (8, 1))
# (leaves, groups, prefusion groups, slots, compiles of a first drain, launch
# lists) of each plan, the same at any tile size, and the tile-kernel
# launches of one g4 drain: tests/test_torch_distributed.py
# (test_chip_smoke_distributed_plans) works them out at n = 64
DIST_PLANS = {
    "cholesky": (7328, 205, 205, 157, 7, 10),
    "run_lu": (11440, 209, 209, 157, 7, 10),
    "lu_solve": (15664, 416, 485, 364, 10, 21),
    "cholesky_flat": (5984, 124, 124, 94, 1, 1),
}
DIST_LAUNCHES = {
    "cholesky": {"potrf": 32, "trsm": 52, "syrk": 52, "gemm": 69},
    "run_lu": {"getrf": 32, "trsml": 52, "trsmu": 52, "gemmnn": 73},
    "lu_solve": {"getrf": 32, "trsml": 60, "trsmu": 52, "trsmul": 32, "gemmnn": 240},
}
# of those, the g4 LU solve's launches over two segments (B5)
DIST_SEGMENTED = {"lu_solve": {"gemmnn": 45, "trsml": 24}}


def distributed_path(torch, tl) -> dict:
    """Phase 4b: on a world-size-1 NCCL ``DeviceMesh`` of shape (1, 1), g4
    Cholesky and the g4 LU solve with b (N, RHS) drained as phase 3 drains
    (DRAINS), then g4 ``run_lu``, g3 Cholesky and g3flat Cholesky at P x P
    once each.  Every drain is held against float64 (the g4 seed-0 drains
    within ACCURACY's limits) and against the same drain on g2p within its
    tolerance, must run a captured graph for every launch list and show
    DIST_PLANS' counters and DIST_LAUNCHES' kernel launches; each g4 drain
    prints its wall, host dispatch and launch lists beside g2p's, and each
    g4 path's entry point with ``mesh=`` must equal its drain.  Returns the
    g4 drains' kernel launches."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import Dispatcher, GData, dd_matrix, spd_matrix
    from repro_torch.core.data import from_grid
    from repro_torch.core.executors import clear_compile_cache
    from repro_torch.core.executors.sharded import mesh_device
    from repro_torch.linalg import run_cholesky, run_lu, run_lu_solve, utp_cholesky, utp_getrf, utp_lu_solve

    spd = {seed: spd_matrix(N, seed=seed) for seed in (0, 1)}
    dd = {seed: dd_matrix(N, seed=seed) for seed in (0, 1)}
    rhs = {seed: torch.from_numpy(np.random.default_rng(seed).standard_normal((N, RHS)).astype(np.float32)).cuda()
           for seed in (0, 1)}
    ref = {("cholesky", s): torch.linalg.cholesky(a.double()) for s, a in spd.items()}
    ref.update({("run_lu", s): torch.linalg.lu_factor_ex(a.double(), pivot=False).LU for s, a in dd.items()})
    ref.update({("lu_solve", s): torch.linalg.solve(a.double(), rhs[s].double()) for s, a in dd.items()})

    def submitter(kind, seed, parts, b_parts):
        def submit(d):
            if kind == "cholesky":
                A = GData((N, N), partitions=parts, value=spd[seed])
                utp_cholesky(d, A)
                return (A,)
            A = GData((N, N), partitions=parts, value=dd[seed])
            if kind == "run_lu":
                utp_getrf(d, A)
                return (A,)
            B = GData((N, RHS), partitions=b_parts, value=rhs[seed])
            utp_lu_solve(d, A, B)
            return (B,)

        return submit

    def result(kind, X):
        out = from_grid(X.grid)
        return torch.tril(out) if kind == "cholesky" else out

    flat = {}  # (kind, seed) -> the same drain's result on g2p (a memo replay of phases 3-4)
    for kind in ("cholesky", "run_lu", "lu_solve"):
        for seed in (0, 1):
            d = Dispatcher(graph="g2p")
            (X,) = submitter(kind, seed, ((P, P),), ((P, RHS_P),))(d)
            d.run()
            flat[(kind, seed)] = result(kind, X)

    drained = {}  # (graph, kind, seed) -> the last such drain's result

    def error(kind, seed, label, tol):
        def err(X):
            got = drained[(label[:3].strip(), kind, seed)] = result(kind, X)
            e = (got.double() - ref[(kind, seed)]).abs().max().item()
            vs = (got - flat[(kind, seed)]).abs().max().item()
            print(f"{label}: max_abs_diff_vs_g2p={vs:.3e} (tolerance {tol})")
            if not vs <= tol:
                raise AssertionError(f"{label} differs from g2p by {vs:.3e} > {tol}")
            return e

        return err

    tols = {"cholesky": 2e-4, "run_lu": 2e-4, "lu_solve": 1e-3}
    flops = {"cholesky": N**3 / 3, "run_lu": 2 * N**3 / 3, "lu_solve": 2 * N**3 / 3 + 2 * N * N * RHS}
    names = {"cholesky": "cholesky", "run_lu": "run_lu", "lu_solve": f"lu_solve b=({N},{RHS})"}
    runs = []  # (kind, graph, drain, seed, partitions)
    for kind in ("cholesky", "lu_solve"):
        runs += [(kind, "g4", drain, seed, DIST_P) for drain, seed in DRAINS]
    runs += [("run_lu", "g4", "first ", 0, DIST_P), ("cholesky", "g3", "first ", 0, DIST_P),
             ("cholesky", "g3flat", "first ", 0, ((P, P),))]
    def entry_point(kind, mesh, want):
        """The public entry point with ``mesh=`` on seed 0 (a memo replay of
        the drains above): on the mesh's device (``cuda:0``), equal to the
        drain bit for bit."""
        if kind == "cholesky":
            got = run_cholesky(spd[0], graph="g4", partitions=DIST_P, mesh=mesh)
        elif kind == "run_lu":
            L, U = run_lu(dd[0], graph="g4", partitions=DIST_P, mesh=mesh)
            got = torch.tril(L, -1) + U
        else:
            got = run_lu_solve(dd[0], rhs[0], graph="g4", partitions=DIST_P, b_partitions=DIST_B_P, mesh=mesh)
        if got.device != mesh_device(mesh) or not torch.equal(got, want):
            raise AssertionError(f"g4 {kind} through its entry point on the mesh: {got.device}, "
                                 f"max diff {(got - want).abs().max().item():.3e} from the drain")
        print(f"g4 {kind} entry point with mesh=: on {got.device}, equal to the drain bit for bit")

    launches = {k: 0 for k in tl.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            for kind, graph, drain, seed, parts in runs:
                first = drain == "first "
                if first:  # each path builds its lists from nothing, as DIST_PLANS counts them
                    clear_compile_cache()
                plan = DIST_PLANS["cholesky_flat" if graph == "g3flat" else kind]
                want = plan[:4] + (plan[4] if first else 0, plan[5], int(not first))
                label = f"{graph:3s} {names[kind]} {drain} seed={seed}"
                # one launch list (g3flat) is also held against the same list run eagerly
                inputs = [spd[seed]] if graph == "g3flat" else None
                counts, err = drain_checked(
                    torch, tl, label, graph, submitter(kind, seed, parts, DIST_B_P), inputs, want,
                    DIST_LAUNCHES[kind] if graph == "g4" else {}, error(kind, seed, label, tols[kind]),
                    tols[kind], flops[kind], mesh=mesh,
                    want_segmented=DIST_SEGMENTED.get(kind) if graph == "g4" else None)
                if graph == "g4" and seed == 0:
                    accuracy_held(kind, err)
                    if drain == DRAINS[-1][0] or kind == "run_lu":  # the last of its kind's drains
                        entry_point(kind, mesh, drained[("g4", kind, 0)])
                if graph == "g4":
                    for k, v in counts.items():
                        launches[k] += v
                    wall, host, lists = DRAIN_TIMES[label]
                    wall2, host2, lists2 = DRAIN_TIMES["g2p" + label[3:]]
                    print(f"{label} beside g2p: wall_ms={wall * 1e3:.3f} vs {wall2 * 1e3:.3f} "
                          f"host_dispatch_ms={host * 1e3:.3f} vs {host2 * 1e3:.3f} "
                          f"launch_lists={lists} vs {lists2} (g4 over g2p: wall x{wall / wall2:.2f})")
        finally:
            dist.destroy_process_group()
    return launches


# --------------------------------------------------------------------------
# Phase 5: serving
# --------------------------------------------------------------------------
def serving_path(torch, tl) -> dict:
    """Phase 5: ``BatchServer(graph="g2p", max_batch=64)`` answers SERVED
    requests a tick (three signature buckets, one stacked launch list
    each): tick 1 captures, ticks 2-4 (fresh inputs) replay with every
    stacked-launch count zeroed before the tick and read after; then a
    profiled repeat tick, the same tick on g2, the same solves as
    sequential ``run_lu_solve`` replays and as one batched library call,
    and the fault rounds.  Returns the stacked launches of ticks 2-4."""
    import numpy as np

    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.errors import InflightError, NumericalError
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.linalg import run_lu_solve
    from repro_torch.serve import BatchServer
    from repro_torch.testing import faults

    kind_of = {"lu_solve": "lu_solve", "getrf": "lu", "potrf": "cholesky"}
    parts = ((SP, SP),)

    class Observed(BatchServer):
        """A BatchServer that keeps each chunk drain's template counters and
        whether it ran a captured graph."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.drained = []
            self.graphs = []

        def _drain_chunk(self, chunk):
            d, h = super()._drain_chunk(chunk)
            st = d.executor.stats
            self.drained.append((kind_of[chunk[0].op.name], len(chunk),
                                 (h.leaves, st["groups"], st["groups_prefusion"], st["slots"])))
            self.graphs.append(st.get("graph_replays", 0))
            return d, h

    rng = np.random.default_rng(5)

    def requests(tick: int):
        """One tick's requests as host tensors, as callers send them."""
        base = 1000 * tick
        return {
            "lu_solve": [(dd_matrix(SN, seed=base + i, device="cpu"),
                          torch.from_numpy(rng.standard_normal(SN).astype(np.float32)))
                         for i in range(SERVED["lu_solve"])],
            "lu": [dd_matrix(SN, seed=base + 100 + i, device="cpu") for i in range(SERVED["lu"])],
            "cholesky": [spd_matrix(SN, seed=base + 200 + i, device="cpu") for i in range(SERVED["cholesky"])],
        }

    def submit(srv, reqs):
        return {
            "lu_solve": [srv.lu_solve(a, b, partitions=parts) for a, b in reqs.get("lu_solve", ())],
            "lu": [srv.lu(a, partitions=parts) for a in reqs.get("lu", ())],
            "cholesky": [srv.cholesky(a, partitions=parts) for a in reqs.get("cholesky", ())],
        }

    def backward(residual, scale, n: int) -> float:
        """Largest componentwise backward error |residual| / scale in units
        of fp32's unit roundoff u; raises above n / (1 - n u), the bound of a
        blocked LU or Cholesky in fp32 with conventional products
        (|LU - A| <= gamma_n |L||U|, Higham, Accuracy and Stability of
        Numerical Algorithms, Thms 9.3 and 10.3).  On these near-diagonal
        inputs the absolute bounds alone would pass a factor that skipped
        a trailing update; this one would not."""
        u = 2.0**-24
        ratio = (residual.abs() / scale.clamp_min(1e-300)).max().item() / u
        if not ratio <= n / (1 - n * u):
            raise AssertionError(f"componentwise backward error {ratio:.1f} u exceeds gamma_{n} = {n} u")
        return ratio

    def errors(reqs, futs, skip=()):
        """Max abs error of each kind's results against float64 references
        (pivot-free LU factor, Cholesky factor, solution), and for the
        factors their componentwise backward error (``backward``)."""
        out = {}
        if reqs.get("lu_solve"):
            keep = [i for i in range(len(reqs["lu_solve"])) if i not in skip]
            a = torch.stack([reqs["lu_solve"][i][0] for i in keep]).cuda().double()
            b = torch.stack([reqs["lu_solve"][i][1] for i in keep]).cuda().double()
            ref = torch.linalg.solve(a, b[..., None])[..., 0]
            x = torch.stack([futs["lu_solve"][i].result() for i in keep]).double()
            out["lu_solve"] = (x - ref).abs().max().item()
        if reqs.get("lu"):
            a = torch.stack(reqs["lu"]).cuda().double()
            ref = torch.linalg.lu_factor_ex(a, pivot=False).LU
            lo, up = (torch.stack(f).double() for f in zip(*(f.result() for f in futs["lu"])))
            out["lu"] = (torch.tril(lo, -1) + up - ref).abs().max().item()
            out["lu_backward_u"] = backward(lo @ up - a, lo.abs() @ up.abs(), SN)
        if reqs.get("cholesky"):
            a = torch.stack(reqs["cholesky"]).cuda().double()
            ref = torch.linalg.cholesky(a)
            lo = torch.stack([f.result() for f in futs["cholesky"]]).double()
            out["cholesky"] = (lo - ref).abs().max().item()
            out["cholesky_backward_u"] = backward(lo @ lo.mT - a, lo.abs() @ lo.abs().mT, SN + 1)
        for kind, e in out.items():
            if kind.endswith("_backward_u"):
                continue
            if e > (1e-3 if kind == "lu_solve" else 2e-4):
                raise AssertionError(f"served {kind} error {e:.3e} exceeds its bound")
        return out

    def tick(srv, label: str, reqs):
        """Submit (ingest through pinned memory), wait for the copies, then
        one tick between zeroed and read launch counts: the tick's host
        wall time, the card done, the event span on the stream."""
        t0 = time.perf_counter()
        futs = submit(srv, reqs)
        submit_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        tl.reset_launches()
        srv.drained.clear()
        srv.graphs.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        rep = srv.tick()
        tick_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        done_ms = (time.perf_counter() - t0) * 1e3
        stacked = dict(tl.STACKED_LAUNCHES)
        unstacked = {k: v for k, v in tl.LAUNCHES.items() if v}
        print(f"{label}: requests={rep.requests} resolved={rep.resolved} failed={rep.failed} buckets={rep.buckets} "
              f"launches={rep.launches} compiles={rep.compiles} stacked_drains={rep.stacked_drains} "
              f"memo_hits={rep.memo_hits} bisected={rep.bisected} host_idle_us={rep.host_idle_us:.1f} "
              f"submit_ms={submit_ms:.3f} tick_wall_ms={tick_ms:.3f} card_done_ms={done_ms:.3f} "
              f"event_span_ms={start.elapsed_time(end):.3f} stacked_launches={stacked} "
              f"unstacked_launches={unstacked} captured_graph_drains={sum(srv.graphs)}/{len(srv.graphs)}")
        if not all(srv.graphs) or rep.bisected:
            raise AssertionError(f"{label}: a drain failed or ran no captured graph ({srv.graphs}, "
                                 f"bisected={rep.bisected})")
        return rep, futs, stacked

    srv = Observed(graph="g2p", max_batch=LANES)
    reqs = requests(1)
    rep, futs, _ = tick(srv, "serve g2p tick 1 (capture)", reqs)
    if (rep.compiles, rep.launches, rep.stacked_drains, rep.resolved) != (3, 3, 3, sum(SERVED.values())):
        raise AssertionError(f"capture tick counters {rep}")
    launches = {k: 0 for k in KERNELS}
    for t in (2, 3, 4):
        reqs = requests(t)
        rep, futs, stacked = tick(srv, f"serve g2p tick {t} (replay)", reqs)
        got = (rep.compiles, rep.launches, rep.stacked_drains, rep.resolved, rep.failed, rep.host_idle_us)
        if got != (0, 3, 3, sum(SERVED.values()), 0, 0):
            raise AssertionError(f"tick {t}: (compiles, launches, stacked_drains, resolved, failed, "
                                 f"host_idle_us) = {got}")
        missing = [k for k in KERNELS if not stacked[k]]
        if missing:
            raise AssertionError(f"tick {t}: no stacked launch of {missing}")
        for k in KERNELS:
            launches[k] += stacked[k]
        counters = {kind: c for kind, _, c in srv.drained}
        if counters != TEMPLATES or sorted(n for _, n, _ in srv.drained) != sorted(SERVED.values()):
            raise AssertionError(f"tick {t}: bucket templates {srv.drained} != {TEMPLATES}")
        errs = errors(reqs, futs)
        print(f"serve g2p tick {t}: templates (leaves, groups, prefusion, slots) {counters}; "
              f"max_abs_err_vs_f64 and backward error in units of fp32 roundoff (_backward_u) "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        accuracy_held("served_lu_backward_u", errs["lu_backward_u"])

    reqs = requests(5)
    futs = submit(srv, reqs)

    def profiled_tick():
        rep = srv.tick()
        return (f"launches={rep.launches} compiles={rep.compiles} stacked_drains={rep.stacked_drains} "
                f"resolved={rep.resolved}")

    profiled(torch, "serve g2p repeat tick", profiled_tick)
    errors(reqs, futs)
    reqs = requests(11)
    futs = submit(srv, reqs)
    host_functions("serve g2p repeat tick", srv.tick, top=16)
    errors(reqs, futs)

    g2 = Observed(graph="g2", max_batch=LANES)
    tick(g2, "serve g2 tick 1 (capture)", requests(6))
    reqs = requests(7)
    rep, futs, _ = tick(g2, "serve g2 tick 2 (replay, library leaves)", reqs)
    errors(reqs, futs)

    solve = [(a.cuda(), b.cuda()) for a, b in requests(8)["lu_solve"]]
    run_lu_solve(*solve[0], graph="g2p", partitions=parts)  # capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in solve:
        run_lu_solve(a, b, graph="g2p", partitions=parts)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    A = torch.stack([a for a, _ in solve])
    Bm = torch.stack([b for _, b in solve])[..., None]
    sl = torch.linalg.solve_triangular

    def library():
        lu = torch.linalg.lu_factor_ex(A, pivot=False).LU
        return sl(lu, sl(lu, Bm, upper=False, left=True, unitriangular=True), upper=True, left=True)

    with fp32_matmul():
        lib_ms = cuda_ms(library, 5)
    print(f"{LANES} sequential g2p run_lu_solve memo replays (device inputs) ms={seq_ms:.3f}; library "
          f"lu_factor_ex(pivot=False) + 2 solve_triangular on ({LANES}, {SN}, {SN}) ms={lib_ms:.3f}")

    # fault rounds: check_finite on, no retries; an expected error on a
    # future is a result, and is asserted
    fsrv = Observed(graph="g2p", max_batch=LANES, check_finite=True, max_retries=0)
    reqs = {"lu_solve": requests(9)["lu_solve"]}
    a_bad = reqs["lu_solve"][3][0].clone()
    a_bad[0, 0] = float("nan")
    reqs["lu_solve"][3] = (a_bad, reqs["lu_solve"][3][1])
    rep, futs, _ = tick(fsrv, "serve fault round 1 (NaN in request 3)", reqs)
    if not isinstance(futs["lu_solve"][3].exception(), NumericalError) or (rep.resolved, rep.failed) != (63, 1):
        raise AssertionError(f"NaN round: {futs['lu_solve'][3].exception()!r} resolved={rep.resolved}")
    e1 = errors(reqs, futs, skip={3})
    reqs = {"lu_solve": requests(10)["lu_solve"]}
    futs = submit(fsrv, reqs)
    target = futs["lu_solve"][5].rid
    with faults.inject("drain.inflight", RuntimeError("injected in-flight failure"),
                       when=lambda ctx: target in ctx.get("rids", ()), times=None):
        reps = [fsrv.tick()]
        while fsrv.pending() and len(reps) < 4:
            reps.append(fsrv.tick())
    bisected = sum(r.bisected for r in reps)
    err = futs["lu_solve"][5].exception()
    if not isinstance(err, InflightError) or bisected == 0 or fsrv.pending():
        raise AssertionError(f"in-flight round: {err!r} bisected={bisected} pending={fsrv.pending()}")
    e2 = errors(reqs, futs, skip={5})
    print(f"serve fault round 1: request 3 failed with NumericalError, 63 resolved, max_abs_err={e1['lu_solve']:.3e}; "
          f"round 2: drain.inflight on request 5 -> {type(err).__name__}, bisected={bisected}, ticks={len(reps)}, "
          f"resolved={sum(r.resolved for r in reps)} max_abs_err={e2['lu_solve']:.3e}")
    return launches


def capture_probe(torch) -> None:
    """Phase 5, last: a leaf that synchronizes the host cannot be captured.
    The g2 POTRF leaf is swapped for one that calls
    ``torch.cuda.synchronize()`` (legal in the warm-up run, illegal while
    the stream captures); the drain must raise ``CaptureError`` naming the
    operation, and a drain after it must run.  The failed capture must not
    leave the allocator counting a capture underway (C5: it then released
    no cached segment again): a 1 GiB block freed after it goes back to the
    device on ``empty_cache``."""
    from repro_torch.core import spd_matrix
    from repro_torch.core.executors import clear_compile_cache
    from repro_torch.core.executors.captured import CaptureError
    from repro_torch.kernels import ref as kref
    from repro_torch.linalg import run_cholesky

    real = kref.potrf

    def syncing_potrf(a):
        torch.cuda.synchronize()
        return real(a)

    a = spd_matrix(256, seed=3)
    clear_compile_cache()
    kref.potrf = syncing_potrf
    try:
        run_cholesky(a, graph="g2", partitions=((4, 4),))
    except CaptureError as e:
        raised = e
    else:
        raised = None
    finally:
        kref.potrf = real
        clear_compile_cache()
    if raised is None or "potrf" not in str(raised):
        raise AssertionError(f"a synchronizing leaf did not make capture raise CaptureError naming it: {raised!r}")
    L = run_cholesky(a, graph="g2", partitions=((4, 4),))
    err = (L.double() - torch.linalg.cholesky(a.double())).abs().max().item()
    print(f"capture probe: a leaf calling torch.cuda.synchronize() -> {type(raised).__name__}: "
          f"{str(raised).splitlines()[0][:160]}; the next g2 drain's max_abs_err_vs_f64={err:.3e}")
    if err > 2e-4:
        raise AssertionError(f"the drain after the capture probe is off by {err:.3e}")
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    block = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    del block
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    print(f"capture probe: after the failed capture a freed 1 GiB block is released: reserved {before / 2**30:.3f} "
          f"-> {after / 2**30:.3f} GiB")
    if after > before:
        raise AssertionError(f"after the failed capture empty_cache kept {(after - before) / 2**30:.3f} GiB reserved")

# --------------------------------------------------------------------------
# Phase 6: the LM inference path
# --------------------------------------------------------------------------
LM = "starcoder2-7b"  # published widths, all 32 layers, bf16, seeded random weights
LM_S = 4096  # no-cache forward length
LM_TILE = 128  # the JAX kernel's KV tile: the drop-the-last-tile probe removes this many keys
# teacher-forced checks (each layer on the same input both ways; see lm_forward):
# the largest relative L2 error of one position's bf16 activations, over every
# position; 1e-2 = a few bf16 ulps (2^-8 relative) spread over a vector
LM_TOL = 1e-2
# lm_logits against the upcast fp32 product: both sum exact bf16 products in
# float32, in other orders (relative L2 ~1e-6 over a vector of 49152)
HEAD_TOL = 1e-4
ENGINE = {"slots": 4, "max_seq": 2048}
ENGINE_REQUESTS, ENGINE_NEW, ENGINE_PROMPTS = 8, 32, (64, 1024)
ENGINE_PROBE = 510  # request 0's prompt; with its first two tokens, a 512-long forward
ENGINE_DECODE_STEPS = 62  # two waves of four slots, 31 decode steps each
ENGINE_SAMPLED = {"temperature": 1.0, "top_k": 50}  # 6d's sampled run
ENGINE_EAGER_STEPS = 3  # phase 7's eager reference runs: the first wave's prefills and decode steps 1-2
# tests/test_kernels.py::test_flash_attention; flash outputs are also held to it row
# by row, as each row's relative L2 error (see flash_close)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# tests/test_kernels.py::test_matmul_tiled's 1e-4; bf16: one bf16 ulp of the result
# (2^-7 relative at worst), as both round a float32 sum
MATMUL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_SM90_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
MATMUL_SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:97 flash_attention (_flash_kernel :28, pallas_call :128)"
MATMUL_REPLACES = f"{_TL}:487 matmul (_matmul_kernel :473, pallas_call :504)"
# (B, Hq, Hkv, S, D), window, block: tests/test_kernels.py:184-188's grid with its
# 16-blocks, GQA groups of 3 and of 9 (36 / 4, starcoder2-7b), head dims 8 ... 256
# (gemma3-12b's 256, nemotron-4-340b's 192), and ragged S (the kernel's tile is 64)
FLASH_CASES = (
    *[(shape, w, 16) for shape in ((1, 2, 2, 32, 8), (2, 4, 2, 64, 16), (1, 8, 1, 32, 32)) for w in (0, 16)],
    ((1, 6, 2, 256, 64), 0, 128), ((1, 6, 2, 256, 64), 100, 128),
    ((1, 36, 4, 256, 128), 0, 128), ((1, 36, 4, 256, 128), 100, 128),
    *[((1, 4, 2, 256, d), w, 128) for d in (8, 128, 192, 256) for w in (0, 100)],
    ((2, 4, 2, 12, 16), 0, 128), ((1, 4, 1, 100, 64), 16, 128), ((1, 2, 1, 1, 32), 0, 128),
)
# (B, Hq, Hkv, S, D), window, causal, scale, block: bf16 cases of the Hopper route
# beyond FLASH_CASES (blocks 512 keep the JAX contract's divisibility at S = 300)
FLASH_SM90_CASES = (
    ((2, 4, 2, 256, 128), 0, False, None, 128),  # no causal mask
    ((1, 4, 2, 256, 128), 0, True, 0.3, 128),  # a caller's scale
    ((1, 4, 2, 1, 128), 0, True, None, 128),  # S = 1
    ((1, 36, 4, 300, 128), 0, True, None, 512),  # ragged S, GQA 9
    ((1, 4, 2, 300, 192), 100, True, None, 512),  # D = 192 (64-key tiles), ragged, windowed
    ((1, 4, 2, 256, 80), 0, True, None, 128),  # D padded to 128 in shared memory
)
LM_F32 = {"n_layers": 2, "S": 1024}  # the float32 forward: the simple kernel's path
# (m, k, n, bm, bk, bn): tests/test_kernels.py::test_matmul_tiled's shapes, and 4096^3
MM_N = 4096  # the matmul's timed and entry-point size, m = k = n
MATMUL_CASES = ((32, 32, 32, 16, 16, 16), (64, 128, 32, 32, 64, 16), (128, 64, 128, 128, 64, 128),
                (MM_N, MM_N, MM_N, 128, 128, 128))
# (m, k, n) that the wrapper takes (blocks clipped to the dimensions), for the
# routes' edges: TMA's zero fill and a 64-column block of B wholly past n
# (100, 40, 24; 384, 128, 384), and in bf16 the simple route's k or n that is
# no multiple of 8 (7, 5, 3; 100, 36, 20; 128, 128, 6)
MATMUL_EDGES = ((100, 40, 24), (384, 128, 384), (7, 5, 3), (100, 36, 20), (128, 128, 6))


def zero_fails(label: str, want, tol: float) -> None:
    """Raises unless an all-zero output (an output the kernel never wrote)
    fails the check against ``want``: the check must be able to see it."""
    import torch

    try:
        close(torch.zeros_like(want), want, tol)
    except AssertionError:
        return
    raise AssertionError(f"{label}: an all-zero output passes the check; it cannot see the kernel")


def rows_rel_l2(got, want):
    """Relative L2 error of each row (vector along the last axis), flat."""
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).flatten()


def flash_close(got, want, tol: float) -> tuple:
    """(max abs error, largest row's relative L2 error); raises unless
    both the elementwise check (``close``) and every row's relative L2
    error pass ``tol``.  At a long sequence an output row is small
    (about 0.3 / sqrt(keys) an element at these inputs), below the
    elementwise tolerance; the row check holds each row to its own size."""
    e = close(got, want, tol)
    r = rows_rel_l2(got, want).max().item()
    if r > tol:
        raise AssertionError(f"a row's relative L2 error {r:.3e} exceeds tolerance {tol}")
    return e, r


def must_fail(label: str, check) -> None:
    """Raises unless ``check()`` raises AssertionError: a wrong output
    must fail the check."""
    try:
        check()
    except AssertionError:
        return
    raise AssertionError(f"{label} passes the check; it cannot see that fault")


def randn(torch, rng, shape, dtype, scale: float = 0.3):
    """A seeded normal tensor on the card (drawn on the host by numpy)."""
    import numpy as np

    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).cuda()).to(dtype)


def routed(fa, q, call):
    """``call()``'s output and the route it launched on, checked against
    ``fa.flash_route``: exactly one launch, on the Hopper kernel exactly
    when the route says so."""
    before = dict(fa.LAUNCHES)
    got = call()
    route = fa.flash_route(q.dtype, q.shape[-1])
    total = fa.LAUNCHES["flash_attention"] - before["flash_attention"]
    sm90 = fa.LAUNCHES["flash_attention_sm90"] - before["flash_attention_sm90"]
    if (total, sm90) != (1, int(route == fa.SM90)):
        raise AssertionError(f"route {route}: {total} launches, {sm90} on the Hopper kernel")
    return got, route


def flash_checks(torch, fa, rng) -> dict:
    """Phase 6a: flash attention against its plain version, float32 and
    bfloat16, at every FLASH_CASES entry and on the model's transposed
    (B, S, H, D) layout, each on its route; then FLASH_SM90_CASES and a
    misaligned view on the Hopper route.  Returns the largest error of
    each route."""
    err = {fa.SIMPLE: 0.0, fa.SM90: 0.0}

    def check(label, q, k, v, tol, causal=True, window=0, scale=None, blk=128):
        got, route = routed(fa, q, lambda: fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                                              block_q=blk, block_k=blk))
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
        torch.cuda.synchronize()
        e, r = flash_close(got, want, tol)
        zero_fails("flash_attention", want.float(), tol)
        err[route] = max(err[route], e)
        print(f"check flash_attention {str(q.dtype)[6:]:8s} {label} route={route}: max_abs_err={e:.3e} "
              f"max_row_rel_l2={r:.3e} (tol {tol})")
        return got

    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        for (B, Hq, Hkv, S, D), window, blk in FLASH_CASES:
            q, k, v = (randn(torch, rng, (B, h, S, D), dtype) for h in (Hq, Hkv, Hkv))
            check(f"B,Hq,Hkv,S,D={B},{Hq},{Hkv},{S},{D} window={window}", q, k, v, tol, window=window, blk=blk)
        # the model's layout: (B, S, H, D) activations passed as transposed views
        q, k, v = (randn(torch, rng, (1, 256, h, 128), dtype).transpose(1, 2) for h in (36, 4, 4))
        got = check("transposed (B, S, H, D) views S=256 GQA 36/4", q, k, v, tol)
        if got.transpose(1, 2).stride() != got.transpose(1, 2).contiguous().stride():
            raise AssertionError("flash_attention's output does not keep the (B, S, H, D) layout of its input")
    tol = FLASH_TOL["bfloat16"]
    for (B, Hq, Hkv, S, D), window, causal, scale, blk in FLASH_SM90_CASES:
        q, k, v = (randn(torch, rng, (B, h, S, D), torch.bfloat16) for h in (Hq, Hkv, Hkv))
        check(f"B,Hq,Hkv,S,D={B},{Hq},{Hkv},{S},{D} window={window} causal={causal} scale={scale}", q, k, v, tol,
              causal=causal, window=window, scale=scale, blk=blk)
    # a view one element into its storage: a 2-byte aligned base, copied for TMA
    q, k, v = (randn(torch, rng, (h * 256 * 128 + 1,), torch.bfloat16)[1:].view(1, h, 256, 128) for h in (4, 2, 2))
    check("misaligned view (1, 4, 2, 256, 128)", q, k, v, tol)
    return err


def matmul_routed(tl, a, b, **blocks):
    """``tl.matmul(a, b)`` and the route it launched on, checked against
    ``tl.matmul_route``: exactly one launch, on that route."""
    before = dict(tl.MATMUL_LAUNCHES)
    got = tl.matmul(a, b, **blocks)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    route = tl.matmul_route(a.dtype, a.shape[0], a.shape[1], b.shape[1], aligned)
    took = {r: n - before[r] for r, n in tl.MATMUL_LAUNCHES.items() if n != before[r]}
    if took != {route: 1}:
        raise AssertionError(f"matmul: route {route}, launches {took}")
    return got, route


def matmul_checks(torch, tl, rng) -> dict:
    """Phase 6a: the matmul against its plain version, float32 and bfloat16,
    at MATMUL_CASES and MATMUL_EDGES and on a misaligned bf16 view, each on
    the route ``matmul_route`` names (every route taken), each check shown
    to fail an all-zero output.  Returns the largest error of each route."""
    err = {r: 0.0 for r in tl.MATMUL_LAUNCHES}
    taken = set()

    def check(label, a, b, blocks):
        got, route = matmul_routed(tl, a, b, **blocks)
        taken.add(route)
        want = tl.matmul_plain(a, b)
        torch.cuda.synchronize()
        tol = MATMUL_TOL[str(a.dtype).split(".")[-1]]
        e = close(got.float(), want.float(), tol)
        zero_fails("matmul", want.float(), tol)
        err[route] = max(err[route], e)
        print(f"check matmul {str(a.dtype)[6:]:8s} {label} route={route}: max_abs_err={e:.3e} (tol {tol})")

    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n, bm, bk, bn in MATMUL_CASES:
            a, b = randn(torch, rng, (m, k), dtype), randn(torch, rng, (k, n), dtype)
            check(f"m,k,n={m},{k},{n} blocks={bm},{bk},{bn}", a, b, dict(bm=bm, bn=bn, bk=bk))
        for m, k, n in MATMUL_EDGES:
            a, b = randn(torch, rng, (m, k), dtype), randn(torch, rng, (k, n), dtype)
            check(f"m,k,n={m},{k},{n}", a, b, dict(bm=min(m, 128), bn=min(n, 128), bk=min(k, 128)))
    # a view one element into its storage: a 2-byte aligned base, which TMA cannot read
    a = randn(torch, rng, (256 * 128 + 1,), torch.bfloat16)[1:].view(256, 128)
    check("misaligned view m,k,n=256,128,128", a, randn(torch, rng, (128, 128), torch.bfloat16), {})
    if taken != set(err):
        raise AssertionError(f"6a checked the matmul routes {sorted(taken)}, not all of {sorted(err)}")
    return err


def attention_pairs(S: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention over S positions."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_timing(torch, fa, rng, label: str, B: int, Hq: int, Hkv: int, S: int, D: int, window: int,
                 dt=None) -> dict:
    """Phase 6b: flash attention at a model's shape (bf16 unless ``dt``) on
    its route, beside the plain version, one library call (scaled_dot_
    product_attention, timed here and never called by the port) and its
    bound: bytes of q, k, v and o once at the HBM rate, against the causal
    (windowed) FLOPs at the peak for the type (bf16 tensor cores, or fp32
    without them); on the Hopper route also beside the simple kernel on the
    same inputs.  The output is checked at this shape row by row
    (``flash_close``), and the check must fail for an output whose last
    quarter of rows is zero and for a kernel that drops the last KV tile."""
    import torch.nn.functional as F

    dt = torch.bfloat16 if dt is None else dt
    tol = FLASH_TOL[str(dt).split(".")[-1]]
    q, k, v = (randn(torch, rng, (B, h, S, D), dt) for h in (Hq, Hkv, Hkv))
    kern = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window)
    want = plain().float()
    got, route = routed(fa, q, kern)
    err, row_err = flash_close(got, want, tol)
    zeroed = got.clone()
    zeroed[:, :, S - S // 4:] = 0
    dropped = drop_last_kv_tile(fa.flash_attention)(q, k, v, causal=True, window=window)
    must_fail("an output with its last quarter of rows zero", lambda: flash_close(zeroed, want, tol))
    must_fail("a kernel that drops the last KV tile", lambda: flash_close(dropped, want, tol))
    probes = (rows_rel_l2(zeroed, want).max().item(), rows_rel_l2(dropped, want).max().item())
    del zeroed, dropped
    if window:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    lib_err = (lib().float() - want).abs().max().item()
    ms = cuda_ms(kern, 10)
    simple = lambda: fa._launch(fa.SIMPLE, q, k, v, causal=True, window=window, scale=None)
    simple_ms = cuda_ms(simple, 3, warmup=1) if route == fa.SM90 else ms
    plain_ms = cuda_ms(plain, 3, warmup=1)
    lib_ms = cuda_ms(lib, 10)
    flops = 4 * B * Hq * D * attention_pairs(S, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    versus = (f" simple_kernel_ms={simple_ms:.4f} (simple / this kernel {simple_ms / ms:.1f}x)"
              if route == fa.SM90 else "")
    print(f"time  flash_attention {label} (B,Hq,Hkv,S,D)=({B},{Hq},{Hkv},{S},{D}) window={window} {str(dt)[6:]} "
          f"route={route}: kernel_ms={ms:.4f}{versus} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (sdpa, "
          f"max_abs_err vs plain {lib_err:.3e}; kernel / sdpa {ms / lib_ms:.2f}x) bound_ms={bound_ms:.4f} "
          f"({bound_by}; kernel / bound {ms / bound_ms:.2f}x) kernel_tflops={flops / ms / 1e9:.2f} "
          f"max_abs_err={err:.3e} max_row_rel_l2={row_err:.3e} (tol {tol}; the same with the last quarter of rows "
          f"zeroed {probes[0]:.3e}, with the last KV tile dropped {probes[1]:.3e}: both fail)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                simple_ms=simple_ms)


def matmul_timing(torch, tl, rng) -> dict:
    """Phase 6b: the matmul at 4096^3 on each route, beside its plain
    version, one library call (``torch.matmul``; in float32 with TF32 off)
    and its bound, each result checked against the plain version.  float32
    (tf32x3): its error against float64 held to TC_RATIO times
    ``torch.matmul``'s on the same inputs; bound 3 x the FLOPs at the TF32
    peak (the fp32-FMA bound printed beside it).  bfloat16 (wgmma): bound
    the FLOPs at the bf16 peak; the simple route timed on the same inputs.
    Returns each route's numbers."""
    from repro_torch.kernels.ref import fp32_matmul

    n = MM_N
    flops, out = 2 * n**3, {}
    a, b = randn(torch, rng, (n, n), torch.float32), randn(torch, rng, (n, n), torch.float32)
    want64 = a.double() @ b.double()
    with fp32_matmul():
        got, route = matmul_routed(tl, a, b)
        err = close(got, tl.matmul_plain(a, b), MATMUL_TOL["float32"])
        e64 = (got.double() - want64).abs().max().item()
        lib_e64 = (torch.matmul(a, b).double() - want64).abs().max().item()
        ms = cuda_ms(lambda: tl.matmul(a, b), 10)
        plain_ms = cuda_ms(lambda: tl.matmul_plain(a, b), 10)
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), 10)
    if route != tl.TF32X3 or not e64 <= TC_RATIO * lib_e64:
        raise AssertionError(f"fp32 matmul: route {route}, error vs float64 {e64:.3e} > {TC_RATIO} x torch.matmul's "
                             f"{lib_e64:.3e}")
    t_bytes, t_ops = 3 * n * n * 4 / PEAK_BYTES * 1e3, 3 * flops / PEAK_TF32_FLOPS * 1e3
    out[tl.TF32X3] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations", err_vs_f64=e64,
                          library_err_vs_f64=lib_e64, shape=f"{n}^3 fp32")
    print(f"time  matmul m=k=n={n} fp32 (no TF32) route=tf32x3: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} (torch.matmul; kernel / library {ms / lib_ms:.2f}x) "
          f"bound_ms={out[tl.TF32X3]['bound_ms']:.4f} ({out[tl.TF32X3]['bound_by']}, 3xtf32; fp32 FMAs "
          f"{flops / PEAK_FP32_FLOPS * 1e3:.4f}) kernel_tflops={flops / ms / 1e9:.2f} max_abs_err={err:.3e} "
          f"max_abs_err_vs_f64={e64:.3e} (torch.matmul {lib_e64:.3e}; ratio {e64 / lib_e64:.2f}, limit {TC_RATIO})")
    del a, b, want64
    a, b = randn(torch, rng, (n, n), torch.bfloat16), randn(torch, rng, (n, n), torch.bfloat16)
    got, route = matmul_routed(tl, a, b)
    want = tl.matmul_plain(a, b)
    err = close(got.float(), want.float(), MATMUL_TOL["bfloat16"])
    simple = tl._matmul_launch(tl.SIMPLE, a, b)
    simple_err = close(simple.float(), want.float(), MATMUL_TOL["bfloat16"])
    if route != tl.WGMMA:
        raise AssertionError(f"bf16 matmul at {n}^3 took route {route}")
    ms = cuda_ms(lambda: tl.matmul(a, b), 20)
    simple_ms = cuda_ms(lambda: tl._matmul_launch(tl.SIMPLE, a, b), 3, warmup=1)
    plain_ms = cuda_ms(lambda: tl.matmul_plain(a, b), 10)
    lib_ms = cuda_ms(lambda: torch.matmul(a, b), 20)
    t_bytes, t_ops = 3 * n * n * 2 / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    out[tl.WGMMA] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                         shape=f"{n}^3 bf16")
    out[tl.SIMPLE] = dict(err=simple_err, ms=simple_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by, shape=f"{n}^3 bf16 (forced; the route takes what wgmma refuses)")
    print(f"time  matmul m=k=n={n} bf16 route=wgmma: kernel_ms={ms:.4f} simple_kernel_ms={simple_ms:.4f} "
          f"(simple / this kernel {simple_ms / ms:.1f}x) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"(torch.matmul; kernel / library {ms / lib_ms:.2f}x) bound_ms={bound_ms:.4f} ({bound_by}; kernel / bound "
          f"{ms / bound_ms:.2f}x) kernel_tflops={flops / ms / 1e9:.2f} max_abs_err={err:.3e} "
          f"simple_max_abs_err={simple_err:.3e} (tol {MATMUL_TOL['bfloat16']})")
    return out


def lm_kernel(name: str) -> str:
    """The group of a device event of the LM forward: the flash kernel,
    cuBLAS products, or PyTorch's elementwise/reduction/copy kernels."""
    if "flash_kernel" in name:  # flash_kernel (simple) and flash_kernel_sm90
        return "flash_attention"
    low = name.lower()
    for key, group in (("gemm", "gemm"), ("nvjet", "gemm"), ("xmma", "gemm"), ("cutlass", "gemm"),
                       ("softmax", "softmax"), ("reduce", "reduce"), ("elementwise", "elementwise"),
                       ("copy", "copy"), ("cat", "cat")):
        if key in low:
            return group
    return "other"


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def drop_last_kv_tile(flash):
    """A flash attention that is wrong as a kernel that skips the last KV
    tile would be: the last LM_TILE queries attend without the last LM_TILE
    keys (all earlier keys precede them, so only a window's mask is left)."""
    import torch

    def call(q, k, v, *, causal=True, window=0):
        o = flash(q, k, v, causal=causal, window=window)
        B, Hq, S, D = q.shape
        Hkv, T = k.shape[1], LM_TILE
        qt = q[:, :, S - T:].float().reshape(B, Hkv, Hq // Hkv, T, D) * D ** -0.5
        s = torch.einsum("bhgqd,bhkd->bhgqk", qt, k[:, :, : S - T].float())
        if window:
            qpos = torch.arange(S - T, S, device=q.device)[:, None]
            s = s.masked_fill(torch.arange(S - T, device=q.device)[None] <= qpos - window, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o[:, :, S - T:] = torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, : S - T].float()).reshape(B, Hq, T, D)
        return o

    return call


def model_layers(model):
    """(layer description, layer parameters) of every layer, in the order
    the forward runs them: each group's layers, then the shared block
    where the family has one (zamba2)."""
    from repro_torch.models.transformer import SHARED, group_layout, has_shared_block

    layout = group_layout(model.cfg)
    shared = model.params["stack"]["shared"] if has_shared_block(model.cfg) else None
    out = []
    for g in model.params["stack"]["groups"]:
        out += zip(layout, g["layers"])
        if shared is not None:
            out.append((SHARED, shared))
    return out


def kept_experts(torch, cfg, p, x, pos, desc):
    """The MoE layer's routing of the tokens of ``x`` (its input) under
    ``cfg``: (top-k expert set (T, k) sorted, the same with dropped
    assignments set to -1, dropped assignments)."""
    from repro_torch.models import moe
    from repro_torch.models.attention import attention_apply
    from repro_torch.models.layers import norm_apply

    h, _ = attention_apply(cfg, p["attn"], norm_apply(cfg, p["ln1"], x), pos, window=desc.window)
    xf = norm_apply(cfg, p["ln2"], x + h).reshape(-1, cfg.d_model)
    _, idx, _ = moe._router(cfg, p["mlp"]["router"], xf)
    C = moe._capacity(cfg, xf.shape[0])
    dropped = (moe._slots(cfg, idx, C) == cfg.n_experts * C).reshape(idx.shape)
    return idx.sort(-1).values, torch.where(dropped, -1, idx).sort(-1).values, int(dropped.sum())


def teacher_forced(torch, model, batch, other_cfg) -> dict:
    """The stack layer by layer under ``model.cfg``, each layer also run
    under ``other_cfg`` on the SAME input.  Every error is the largest
    relative L2 error of one position, over all S positions: per layer,
    then of the final hidden states and of the logits of the last layer's
    two outputs.  (Free-running, two correct attentions do not stay
    comparable on this random network; see lm_forward.)

    An MoE layer routes each token by its own logits, and the two paths'
    attentions round differently, so a token whose logits nearly tie may
    take another expert set (or lose another assignment at the capacity
    cut) under ``other_cfg``: such tokens are counted (``topk_differ``:
    another top-k set; ``rerouted``: another set of kept experts) and left
    out of that layer's per-position maximum, and the whole layer's
    relative L2 error (``layer_rel_max``, every token in it) is held to the
    same tolerance.  ``dropped`` is the share of (token, k) assignments
    ``model.cfg`` drops at the capacity cut, over all MoE layers."""
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.transformer import _layer_apply

    cfg = model.cfg
    x0 = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, S = x0.shape[:2]
    pos = torch.arange(S, device=x0.device)[None].expand(B, S)
    x = model.embed_batch(batch, pos)
    errs, whole, over, topk_differ, rerouted, dropped, assigned = [], [], 0, [], [], 0, 0
    for desc, p in model_layers(model):
        y = _layer_apply(cfg, desc, p, x, pos, None, None)
        y_o = _layer_apply(other_cfg, desc, p, x, pos, None, None)
        e = rows_rel_l2(y, y_o)
        if desc.moe:
            tk, kept, n_drop = kept_experts(torch, cfg, p, x, pos, desc)
            tk_o, kept_o, _ = kept_experts(torch, other_cfg, p, x, pos, desc)
            same = (kept == kept_o).all(-1)
            topk_differ.append(int((tk != tk_o).any(-1).sum()))
            rerouted.append(int((~same).sum()))
            dropped, assigned = dropped + n_drop, assigned + tk.numel()
            e = e[same]
        errs.append(e.max().item())
        whole.append(rel_l2(y, y_o))
        over += int((e > LM_TOL).sum())
        x = y
    h, h_o = (norm_apply(cfg, model.params["final_norm"], t) for t in (y, y_o))
    lg, lg_o = model.lm_logits(h), model.lm_logits(h_o)
    return dict(layer_max=max(errs), layer_worst=errs.index(max(errs)), over=over, layer_rel_max=max(whole),
                hidden=rows_rel_l2(h, h_o).max().item(), logits=rows_rel_l2(lg, lg_o).max().item(),
                top1=(lg.argmax(-1) == lg_o.argmax(-1)).float().mean().item(), per_layer=errs,
                per_layer_rel=whole, topk_differ=topk_differ, rerouted=rerouted,
                dropped=dropped / assigned if assigned else None)


def lm_forward(torch, fa):
    """Phase 6c: starcoder2-7b at its published widths, all layers, bf16,
    seeded random weights made on the card; B = 1, S = LM_S.  The no-cache
    forward with ``use_pallas=True`` (flash launches counted: exactly one a
    layer) and with ``use_pallas=False`` (the portable chunked attention)
    on the same weights and tokens, both timed and profiled.

    The two forwards are compared end to end (printed: relative errors and
    top-1 agreement), but that comparison cannot be a check: at the JAX
    init scales the attention scores have a standard deviation near 400, so
    softmax is an argmax, and the rounding difference between any two
    correct attentions flips near-tied rows, which the later layers spread
    to every position (a free-running pair diverges by layer 7, in float32
    as in bf16).  The check is teacher-forced: every layer is run both
    ways on the same input, and the per-layer outputs, the final hidden
    states and the logits must agree within LM_TOL at every position; the
    same check must fail for a kernel that drops the last KV tile.
    Returns (model, flash launches)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(LM), use_pallas=True)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm {cfg.name}: layers={cfg.n_layers} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv} hd={cfg.hd} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} (template {model.param_counts()['total']}) "
          f"weights_GB={torch.cuda.memory_allocated() / 1e9:.2f} init_s={time.perf_counter() - t0:.2f}")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, LM_S))).cuda()
    batch = {"tokens": toks}

    fa.reset_launches()
    t0 = time.perf_counter()
    h_k, _ = model(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, sm90 = fa.LAUNCHES["flash_attention"], fa.LAUNCHES["flash_attention_sm90"]
    if launches != cfg.n_layers or sm90 != launches:
        raise AssertionError(f"the forward launched flash_attention {launches} times ({sm90} on the Hopper "
                             f"kernel), not once per layer on it ({cfg.n_layers})")
    kern_ms = cuda_ms(lambda: model(batch), 3)
    model.cfg = plain_cfg
    h_p, _ = model(batch)
    plain_ms = cuda_ms(lambda: model(batch), 2, warmup=1)
    model.cfg = cfg
    if not (torch.isfinite(h_k).all() and torch.isfinite(h_p).all()) or h_k.shape != (1, LM_S, cfg.d_model):
        raise AssertionError(f"forward hidden states not finite or of shape {tuple(h_k.shape)}")
    lg, lg_p = model.lm_logits(h_k[:, -1]), model.lm_logits(h_p[:, -1])
    # lm_logits multiplies the bf16 head with an fp32 accumulator and fp32
    # output: held against the upcast fp32 product (a bf16 output would be
    # off by its rounding, ~2e-3)
    h4, w = h_k[0, -4:], model._head_weight()
    with fp32_matmul():
        want = h4.float() @ w.float()
    head_err, bf16_err = rows_rel_l2(model.lm_logits(h4), want).max().item(), rows_rel_l2(h4 @ w, want).max().item()
    print(f"lm_logits vs the upcast fp32 product, 4 positions: max rel_l2={head_err:.3e} (tol {HEAD_TOL}; a bf16 "
          f"output: {bf16_err:.3e})")
    if head_err > HEAD_TOL or bf16_err <= HEAD_TOL:
        raise AssertionError(f"lm_logits: rel_l2 {head_err:.3e}, a bf16 output's {bf16_err:.3e}, tol {HEAD_TOL}")
    del want
    print(f"lm forward S={LM_S}: flash launches={launches} (one a layer; {sm90} on the Hopper kernel) "
          f"first_s={first_s:.3f} "
          f"forward_ms use_pallas=True {kern_ms:.3f}, use_pallas=False (plain _sdpa_chunked) {plain_ms:.3f}; "
          f"free-running flash vs plain (not a check: chaotic at these init scales): last {LM_TILE} positions' "
          f"hidden rel_l2={rel_l2(h_k[:, -LM_TILE:], h_p[:, -LM_TILE:]):.3e}, last logits rel_l2="
          f"{rel_l2(lg, lg_p):.3e} top1_agree={bool(lg.argmax() == lg_p.argmax())}")
    del h_k, h_p
    got = teacher_forced(torch, model, batch, plain_cfg)
    print(f"lm forward teacher-forced, each layer flash vs plain on the same input, largest per-position rel_l2 "
          f"over all {LM_S} positions: layers {got['layer_max']:.3e} (layer {got['layer_worst']}; "
          f"{got['over']} layer positions above tol), final hidden {got['hidden']:.3e}, logits {got['logits']:.3e}, "
          f"top1 agreement {got['top1']:.4f} of positions (tol {LM_TOL})")
    if max(got["layer_max"], got["hidden"], got["logits"]) > LM_TOL:
        raise AssertionError(f"the flash forward disagrees with the plain one: {got}")
    flash = attn.flash_attention
    attn.flash_attention = drop_last_kv_tile(flash)
    try:
        dropped = teacher_forced(torch, model, batch, plain_cfg)
    finally:
        attn.flash_attention = flash
    print(f"lm forward teacher-forced with the last KV tile dropped: largest per-position rel_l2 layers "
          f"{dropped['layer_max']:.3e} ({dropped['over']} layer positions above tol), final hidden "
          f"{dropped['hidden']:.3e}, logits {dropped['logits']:.3e}")
    if max(dropped["layer_max"], dropped["hidden"], dropped["logits"]) <= LM_TOL:
        raise AssertionError("a flash kernel that drops the last KV tile passes the forward check")

    def run():
        model(batch)
        return f"use_pallas={model.cfg.use_pallas}"

    profiled(torch, f"lm forward S={LM_S} flash", run, classify=lm_kernel)
    model.cfg = plain_cfg
    profiled(torch, f"lm forward S={LM_S} plain", run, classify=lm_kernel)
    model.cfg = cfg
    print(f"lm peak device memory GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return model, launches


def lm_forward_f32(torch, fa) -> int:
    """Phase 6c, float32: the simple kernel's path.  starcoder2-7b's widths
    in float32 (cut to LM_F32's layers and length), the no-cache forward
    with ``use_pallas=True`` between zeroed and read launch counts (one
    launch a layer, none on the Hopper kernel), checked teacher-forced
    against the plain attention at every position.  Returns the launches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    S = LM_F32["S"]
    cfg = dataclasses.replace(get_arch(LM), use_pallas=True, n_layers=LM_F32["n_layers"],
                              compute_dtype=torch.float32)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    model = build_model(cfg, seed=0)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, S))).cuda()}
    fa.reset_launches()
    h, _ = model(batch)
    torch.cuda.synchronize()
    launches, sm90 = fa.LAUNCHES["flash_attention"], fa.LAUNCHES["flash_attention_sm90"]
    if launches != cfg.n_layers or sm90 != 0 or h.dtype != torch.float32 or not torch.isfinite(h).all():
        raise AssertionError(f"float32 forward: {launches} flash launches ({sm90} on the Hopper kernel), "
                             f"hidden {h.dtype}, finite {bool(torch.isfinite(h).all())}")
    ms = cuda_ms(lambda: model(batch), 2, warmup=1)
    got = teacher_forced(torch, model, batch, plain_cfg)
    print(f"lm forward float32 {cfg.name} widths, {cfg.n_layers} layers, S={S}: flash launches={launches} (all on "
          f"the simple kernel) forward_ms={ms:.3f}; teacher-forced vs plain, largest per-position rel_l2: layers "
          f"{got['layer_max']:.3e}, final hidden {got['hidden']:.3e}, logits {got['logits']:.3e} (tol {LM_TOL})")
    if max(got["layer_max"], got["hidden"], got["logits"]) > LM_TOL:
        raise AssertionError(f"the float32 flash forward disagrees with the plain one: {got}")
    del model, h
    torch.cuda.empty_cache()
    return launches


def engine_prompts(cfg):
    """ENGINE_REQUESTS prompts of ENGINE_PROMPTS tokens from
    ``np.random.default_rng(0)`` (request 0's ENGINE_PROBE long), or frame
    embeddings (standard normal / sqrt(d_model)) for a stub frontend."""
    import numpy as np

    from repro_torch.models.frontend import uses_stub_frontend

    rng = np.random.default_rng(0)
    lengths = rng.integers(ENGINE_PROMPTS[0], ENGINE_PROMPTS[1] + 1, ENGINE_REQUESTS)
    lengths[0] = ENGINE_PROBE
    if uses_stub_frontend(cfg):
        return [(rng.standard_normal((int(n), cfg.d_model)) / math.sqrt(cfg.d_model)).astype(np.float32)
                for n in lengths]
    return [rng.integers(0, cfg.vocab, int(n)) for n in lengths]


def engine_recorded(torch, eng) -> dict:
    """Record the engine's program calls, at the host, around them: each
    decode's (next tokens, logits) and each prefill's logits with its
    prompt length and synchronized ms.  ``engine_unrecorded`` undoes it."""
    rec = {"decode": [], "prefill": [], "prefill_ms": [], "decode_call": eng._decode}
    prefill = eng._prefill_fn

    class RecordedDecode:  # the decode program, its counts read through
        def __call__(self, *args):
            out = rec["decode_call"](*args)
            rec["decode"].append(out)
            return out

        def __getattr__(self, name):
            return getattr(rec["decode_call"], name)

    def recorded_prefill(one, prompt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(one, prompt)
        torch.cuda.synchronize()
        rec["prefill_ms"].append((prompt.shape[1], (time.perf_counter() - t0) * 1e3))
        rec["prefill"].append(logits)
        return logits

    eng._decode, eng._prefill_fn = RecordedDecode(), recorded_prefill
    return rec


def engine_unrecorded(eng, rec) -> None:
    eng._decode = rec["decode_call"]
    del eng._prefill_fn


def engine_pass(torch, eng, prompts, max_steps: int = 10_000) -> dict:
    """Submit one request of ENGINE_NEW new tokens a prompt and step the
    engine until it drains (or ``max_steps`` steps): the requests, the wall
    s, and the ms of each step without admissions and of each with."""
    from repro_torch.serving import Request

    reqs = [Request(rid=i, prompt=pr, max_new_tokens=ENGINE_NEW) for i, pr in enumerate(prompts)]
    steps0 = eng.decode_steps
    t_start = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    decode_ms, admit_ms = [], []
    while (eng.queue or any(r is not None for r in eng.slot_req)) and len(decode_ms) + len(admit_ms) < max_steps:
        queued = len(eng.queue)
        t0 = time.perf_counter()
        eng.step()
        (admit_ms if len(eng.queue) < queued else decode_ms).append((time.perf_counter() - t0) * 1e3)
    return dict(reqs=reqs, wall_s=time.perf_counter() - t_start, decode_ms=decode_ms, admit_ms=admit_ms,
                decode_steps=eng.decode_steps - steps0)


def engine_eager(torch):
    """``ServeEngine`` whose programs are its plain ``_scatter_fn`` and
    ``_decode_fn``, called eagerly as its prefill is: the reference run
    that the captured engine is held against, and the only one the
    instrumented teacher-forced check can see into."""
    from repro_torch.serving import ServeEngine

    class EagerEngine(ServeEngine):
        def _compiled(self, fn, name, donate, generators=()):
            return fn

    return EagerEngine


def engine_counts(stats: dict) -> str:
    return ", ".join(f"{k} compiles={v['compiles']} graph_replays={v['graph_replays']} pool_bytes={v['pool_bytes']}"
                     for k, v in stats.items()) + f", prefill eager_calls={stats['prefill']['eager_calls']}"


def lm_engine(torch, model, check: bool = True, profile: bool = True, eager_steps=None,
              sampled: bool = False) -> dict:
    """Phase 6d (and 7's engines): ``ServeEngine`` at full width, greedy,
    ENGINE slots, its decode and scatter programs each captured into a CUDA
    graph, its prefill eager: ENGINE_REQUESTS requests of ENGINE_NEW new
    tokens on ``engine_prompts``.  Checks the requests, tokens and decode
    steps, and the compile counts of the reference's jitted decode and
    scatter: decode 1 then a replay a step, scatter one per slot used; and
    one eager prefill a request.  Prints each admission's prefill ms, the
    TTFT and the graphs' pool bytes.

    Then an eager reference run (``engine_eager``: the plain programs) of
    the first pass's schedule, or of its first ``eager_steps`` steps: its
    tokens, every decode step's logits and every prefill's logits must
    equal the captured engine's bit for bit.  That run is instrumented:
    request 0's prefill and first two decode steps are held against a
    no-cache forward over its prompt and those two tokens (ENGINE_PROBE + 2
    long, a multiple of the flash kernel's 128), teacher-forced as in
    lm_forward: every layer of the forward takes the inputs the engine's
    layers saw (the prefill's, then slot 0's of each decode step), and its
    outputs and logits at the last three positions must agree with the
    engine's.  That holds only if the prefill's cache scatter, the
    per-slot positions and the cache reads (KV rows and recurrent states)
    are right.  A stub-frontend model decodes through the engine's stub
    table.  ``check=False`` skips the teacher-forced check (an MoE model at
    a capacity that drops tokens: its routing depends on the other slots'
    tokens, which no single sequence's forward sees); ``profile=False`` the
    profiled decode replay; ``sampled`` adds ``engine_sampled``.  Returns
    the engine's numbers."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import norm_apply
    from repro_torch.serving import EngineConfig, ServeEngine

    cfg = model.cfg
    torch.cuda.empty_cache()
    prompts = engine_prompts(cfg)
    lengths = [len(p) for p in prompts]
    fa.reset_launches()
    eng = ServeEngine(cfg, model, EngineConfig(**ENGINE))
    rec = engine_recorded(torch, eng)
    first = engine_pass(torch, eng, prompts)
    stats = eng.stats
    reqs = first["reqs"]
    fa_launches = fa.LAUNCHES["flash_attention"]
    bad = [r.rid for r in reqs if len(r.out_tokens) != ENGINE_NEW or not all(0 <= t < cfg.vocab for t in r.out_tokens)]
    done = [r for r in reqs if r.done]
    if len(done) != ENGINE_REQUESTS or bad or first["decode_steps"] != ENGINE_DECODE_STEPS:
        raise AssertionError(f"engine: done={len(done)} bad requests={bad} decode_steps={first['decode_steps']} "
                             f"(want {ENGINE_REQUESTS}, none, {ENGINE_DECODE_STEPS})")
    slots = min(ENGINE["slots"], ENGINE_REQUESTS)
    want = {"decode": (1, ENGINE_DECODE_STEPS - 1), "prefill": (0, 0), "scatter": (slots, ENGINE_REQUESTS - slots)}
    got = {k: (stats[k]["compiles"], stats[k]["graph_replays"]) for k in want}
    if got != want or stats["prefill"]["eager_calls"] != ENGINE_REQUESTS:
        raise AssertionError(f"engine {cfg.name}: (compiles, graph_replays) {got}, want {want}; prefill eager "
                             f"calls {stats['prefill']['eager_calls']}, want {ENGINE_REQUESTS}")
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in reqs]
    n_tok = sum(len(r.out_tokens) for r in reqs)
    decode_ms = first["decode_ms"]
    out = dict(tokens_per_s=n_tok / first["wall_s"], decode_ms=float(np.mean(decode_ms)), ttft_ms=ttft,
               wall_s=first["wall_s"], prefill_ms=[ms for _, ms in rec["prefill_ms"]], stats=stats)
    print(f"engine {cfg.name} slots={ENGINE['slots']} max_seq={ENGINE['max_seq']} greedy, decode and scatter "
          f"captured, prefill eager: {len(done)} requests, prompts {sorted(lengths)}, {ENGINE_NEW} new tokens each, "
          f"decode_steps={first['decode_steps']}, flash launches={fa_launches} (the cache path attends through "
          f"_sdpa_auto); {engine_counts(stats)} (want (compiles, graph_replays) {want}); wall_s={first['wall_s']:.3f} "
          f"tokens_per_s={out['tokens_per_s']:.1f}; TTFT ms wave 1 {', '.join(f'{t:.1f}' for t in ttft[:4])}, wave 2 "
          f"{', '.join(f'{t:.1f}' for t in ttft[4:])}; prefill ms "
          f"{', '.join(f'S={S} {ms:.1f}' for S, ms in rec['prefill_ms'])}; decode-only step ms "
          f"mean={np.mean(decode_ms):.3f} median={np.median(decode_ms):.3f} min={np.min(decode_ms):.3f} "
          f"max={np.max(decode_ms):.3f} first (the graph's first replay)={decode_ms[0]:.3f} over {len(decode_ms)} "
          f"steps; steps with admissions ms={', '.join(f'{t:.1f}' for t in first['admit_ms'])}; reserved now "
          f"{torch.cuda.memory_reserved()}")

    # the eager reference run, instrumented: request 0's calls (the first
    # prefill, then the first two decode steps, slot 0); for each, every
    # layer's input and last-position output, and the logits
    ref = engine_eager(torch)(cfg, model, EngineConfig(**ENGINE))
    ref_rec = engine_recorded(torch, ref)
    inst = {"prefill": 0, "decode": 0, "on": False}
    captured, logits = [], []
    prefill, decode_step, layer_apply = model.prefill, model.decode_step, tr._layer_apply

    def record_layer(*args, **kw):
        y = layer_apply(*args, **kw)
        if inst["on"]:
            x = args[3]
            captured[-1].append((x[:1].clone(), y[:1, -1:].clone()))
        return y

    def record(fn, kind: str, first_calls: int):
        def call(*args):
            inst["on"] = inst[kind] < first_calls
            inst[kind] += 1
            if inst["on"]:
                captured.append([])
            lg, cache = fn(*args)
            if inst["on"]:
                logits.append(lg[0].clone())
            inst["on"] = False
            return lg, cache

        return call

    model.prefill, model.decode_step = record(prefill, "prefill", 1), record(decode_step, "decode", 2)
    tr._layer_apply = record_layer
    try:
        eager = engine_pass(torch, ref, prompts, max_steps=eager_steps or 10_000)
    finally:
        del model.prefill, model.decode_step
        tr._layer_apply = layer_apply
    n_dec, n_pre = len(ref_rec["decode"]), len(ref_rec["prefill"])
    same = (all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(rec["decode"][:n_dec], ref_rec["decode"]))
            and all(torch.equal(a, b) for a, b in zip(rec["prefill"][:n_pre], ref_rec["prefill"]))
            and all(e.out_tokens == c.out_tokens[:len(e.out_tokens)] for e, c in zip(eager["reqs"], reqs)))
    eager_ms = float(np.mean(eager["decode_ms"])) if eager["decode_ms"] else float("nan")
    out["eager_decode_ms"] = eager_ms
    print(f"engine {cfg.name} eager reference run (the plain programs) of {n_dec} decode steps and {n_pre} "
          f"prefills: tokens, every decode step's next tokens and logits and every prefill's logits equal to the "
          f"captured engine's bit for bit: {same}; eager decode-only step ms mean={eager_ms:.3f} over "
          f"{len(eager['decode_ms'])} steps (captured {out['decode_ms']:.3f}); eager prefill ms "
          f"{', '.join(f'{ms:.1f}' for _, ms in ref_rec['prefill_ms'])}")
    if not same or n_dec == 0:
        diffs = [(a[1] - b[1]).abs().max().item() for a, b in zip(rec["decode"], ref_rec["decode"])]
        raise AssertionError(f"engine {cfg.name}: the captured programs differ from the eager ones: decode logits "
                             f"max diffs {diffs[:8]}")
    del ref, ref_rec
    if check:
        pre, d1, d2 = captured
        n = ENGINE_PROBE + 2
        pos = torch.arange(n, device=model.device)[None]
        errs = []
        for i, (desc, p) in enumerate(model_layers(model)):
            x = torch.cat([pre[i][0], d1[i][0], d2[i][0]], dim=1)  # (1, n, D): the inputs the engine's layer saw
            y = layer_apply(cfg, desc, p, x, pos, None, None)
            got_y = torch.cat([pre[i][1], d1[i][1], d2[i][1]], dim=1)
            errs.append(max(rel_l2(g, w) for g, w in zip(got_y[0], y[0, -3:])))
        want_lg = model.lm_logits(norm_apply(cfg, model.params["final_norm"], y[0, -3:]))
        lg_errs = [rel_l2(g, w) for g, w in zip(logits, want_lg)]
        top1 = [bool(g.argmax() == w.argmax()) for g, w in zip(logits, want_lg)]
        r0 = reqs[0]
        if eng.stub:
            emb = eng.stub_table[torch.tensor(r0.out_tokens[:2], device=model.device)]
            seq = {"embeds": torch.cat([torch.from_numpy(r0.prompt).cuda(), emb])[None].to(cfg.compute_dtype)}
        else:
            seq = {"tokens": torch.from_numpy(np.concatenate([r0.prompt, r0.out_tokens[:2]])[None]).cuda()}
        h, _ = model(seq)
        free = model.lm_logits(h[0, -3:])
        print(f"engine request 0 (prompt {ENGINE_PROBE}): prefill and decode steps 1-2 of the eager reference run "
              f"vs a no-cache forward of {n} tokens at positions {n - 3}..{n - 1}, teacher-forced: max layer "
              f"rel_l2={max(errs):.3e} (layer {errs.index(max(errs))}), logits rel_l2="
              f"{', '.join(f'{e:.3e}' for e in lg_errs)} top1_agree={top1} (tol {LM_TOL}); free-running (not a "
              f"check) logits rel_l2={', '.join(f'{rel_l2(g, w):.3e}' for g, w in zip(logits, free))} top1_agree="
              f"{[bool(g.argmax() == w.argmax()) for g, w in zip(logits, free)]}")
        if max(errs + lg_errs) > LM_TOL:
            raise AssertionError(f"engine disagrees with the no-cache forward: layers {errs} logits {lg_errs}")
        out["check_layer_max"], out["check_logits_max"] = max(errs), max(lg_errs)
    del captured, logits
    engine_unrecorded(eng, rec)
    if profile:
        toks = torch.zeros(ENGINE["slots"], dtype=torch.long, device=model.device)
        pos = torch.full((ENGINE["slots"],), ENGINE_PROBE, device=model.device)
        replays = eng._decode.graph_replays

        def decode():
            eng._decode(eng.cache, toks, pos)[0].cpu()  # as a step: the sampled tokens come back to the host
            return f"slots={ENGINE['slots']} graph_replays={eng._decode.graph_replays - replays}"

        profiled(torch, f"engine {cfg.name} decode step (a graph replay)", decode, classify=lm_kernel)
    eng.release()
    del eng, rec
    if sampled:
        out["sampled"] = engine_sampled(torch, model, prompts)
    return out


def engine_sampled(torch, model, prompts) -> dict:
    """6d's sampled run: ``ServeEngine`` at ENGINE's shape with
    ENGINE_SAMPLED's temperature and top-k, captured, on the first wave's
    prompts: every decoded token of every slot lies in its step's top-k set
    of the logits the decode program returned; then two replays of the
    decode graph from the same inputs: equal logits, the generator's offset
    advanced by each, and other draws."""
    import numpy as np

    from repro_torch.serving import EngineConfig, ServeEngine

    cfg = model.cfg
    k = ENGINE_SAMPLED["top_k"]
    eng = ServeEngine(cfg, model, EngineConfig(**ENGINE, **ENGINE_SAMPLED))
    rec = engine_recorded(torch, eng)
    run = engine_pass(torch, eng, prompts[:ENGINE["slots"]])
    outside = 0
    for nxt, lg in rec["decode"]:
        outside += int((torch.topk(lg, k, dim=-1).indices != nxt[:, None]).all(-1).sum())
    engine_unrecorded(eng, rec)
    toks = torch.as_tensor(eng.slot_tok, device=model.device)
    pos = torch.full((ENGINE["slots"],), ENGINE_PROBE, device=model.device)
    offsets = [eng._gen.get_offset()]
    a = eng._decode(eng.cache, toks, pos)
    offsets.append(eng._gen.get_offset())
    b = eng._decode(eng.cache, toks, pos)
    offsets.append(eng._gen.get_offset())
    stats = eng.stats
    lg = a[1].float() / ENGINE_SAMPLED["temperature"]
    top = torch.topk(lg, k, dim=-1).values
    p = torch.softmax(top, dim=-1)
    agree = float(torch.prod((p * p).sum(-1)))  # both replays draw the same tokens in every slot
    print(f"engine {cfg.name} sampled, captured (temperature={ENGINE_SAMPLED['temperature']} top_k={k}): "
          f"{len(run['reqs'])} requests, {run['decode_steps']} decode steps, tokens outside their step's top-k: "
          f"{outside} of {len(rec['decode']) * ENGINE['slots']}; {engine_counts(stats)}; two replays from the same "
          f"inputs: logits equal {torch.equal(a[1], b[1])}, tokens {a[0].tolist()} and {b[0].tolist()}, generator "
          f"offsets {offsets} (the chance that both draw alike in every slot: {agree:.3e}); decode-only step ms "
          f"mean={np.mean(run['decode_ms']):.3f}")
    if (outside or not torch.equal(a[1], b[1]) or torch.equal(a[0], b[0]) or not offsets[0] < offsets[1] < offsets[2]
            or stats["decode"]["compiles"] != 1 or stats["decode"]["graph_replays"] != run["decode_steps"] + 1):
        raise AssertionError(f"engine sampled: outside top-k {outside}, replays {a[0].tolist()} {b[0].tolist()}, "
                             f"offsets {offsets}, {stats}")
    eng.release()
    return {"outside_top_k": outside, "decode_ms": float(np.mean(run["decode_ms"]))}


def matmul_path(torch, tl, rng) -> dict:
    """Phase 6e: the standalone ``kernels.ops.matmul`` entry point, as a
    caller would use it, at 4096^3 in float32 and in bfloat16, each call
    between zeroed and read launch counts; the products against float64.
    Returns each route's launches."""
    from repro_torch.kernels import ops

    n, launches = MM_N, {}
    for dtype in (torch.float32, torch.bfloat16):
        a, b = randn(torch, rng, (n, n), dtype), randn(torch, rng, (n, n), dtype)
        tl.reset_launches()
        c = ops.matmul(a, b)
        torch.cuda.synchronize()
        took = {r: v for r, v in tl.MATMUL_LAUNCHES.items() if v}
        err = close(c.float(), a.double() @ b.double(), MATMUL_TOL[str(dtype).split(".")[-1]])
        print(f"matmul entry point m=k=n={n} {str(dtype)[6:]}: launches={took} shape={tuple(c.shape)} "
              f"max_abs_err_vs_f64={err:.3e}")
        want = {tl.TF32X3 if dtype == torch.float32 else tl.WGMMA: 1}
        if took != want or c.shape != (n, n):
            raise AssertionError(f"ops.matmul {dtype}: launches={took} shape={tuple(c.shape)}")
        for r, v in took.items():
            launches[r] = launches.get(r, 0) + v
    return launches


def lm_path(torch, tl, rng) -> list:
    """Phase 6: the kernels' checks and times (6a, 6b), the full-width
    forward and the float32 one (6c), the engine (6d) and the matmul entry
    point (6e).  Returns the three kernels' entries of the ``kernels``
    line: the Hopper flash kernel, the simple one and the matmul."""
    from repro_torch.kernels import flash_attention as fa

    torch.cuda.empty_cache()
    flash_err = flash_checks(torch, fa, rng)
    matmul_err = matmul_checks(torch, tl, rng)
    flash = flash_timing(torch, fa, rng, LM, 1, 36, 4, LM_S, 128, 0)
    local = flash_timing(torch, fa, rng, "gemma3-12b local", 1, 16, 8, LM_S, 256, 1024)
    simple = flash_timing(torch, fa, rng, f"{LM} float32", 1, 36, 4, LM_F32["S"], 128, 0, dt=torch.float32)
    mm = matmul_timing(torch, tl, rng)
    model, flash_launches = lm_forward(torch, fa)
    LM_NUMBERS["engine"] = lm_engine(torch, model, sampled=True)
    del model
    simple_launches = lm_forward_f32(torch, fa)
    mm_launches = matmul_path(torch, tl, rng)
    fp32 = mm[tl.TF32X3]
    return [
        {"name": "flash_attention_sm90", "route": "cuda", "source": FLASH_SM90_SOURCE, "replaces": FLASH_REPLACES,
         "launches": flash_launches, "max_abs_err": max(flash_err[fa.SM90], flash["err"], local["err"]),
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
         "shape": f"(1, 36, 4, {LM_S}, 128) bf16 causal", "simple_kernel_ms": flash["simple_ms"],
         "gemma3_local_ms": local["ms"], "gemma3_local_library_ms": local["library_ms"]},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": simple_launches, "max_abs_err": max(flash_err[fa.SIMPLE], simple["err"]), "ms": simple["ms"],
         "plain_ms": simple["plain_ms"], "bound_ms": simple["bound_ms"], "bound_by": simple["bound_by"],
         "library_ms": simple["library_ms"], "shape": f"(1, 36, 4, {LM_F32['S']}, 128) float32 causal"},
        {"name": "matmul", "route": "cuda", "source": MATMUL_SOURCE, "replaces": MATMUL_REPLACES,
         "launches": sum(mm_launches.values()), "max_abs_err": max(matmul_err[tl.TF32X3], fp32["err"]),
         "ms": fp32["ms"], "plain_ms": fp32["plain_ms"], "bound_ms": fp32["bound_ms"], "bound_by": fp32["bound_by"],
         "library_ms": fp32["library_ms"], "shape": fp32["shape"],
         "routes": {r: {"launches": mm_launches.get(r, 0), "max_abs_err": max(matmul_err[r], t["err"]),
                        **{k: v for k, v in t.items() if k != "err"}} for r, t in mm.items()}},
    ]


# --------------------------------------------------------------------------
# Phase 7: the non-dense LM families
# --------------------------------------------------------------------------
# each family at its published widths, bf16, seeded random weights: the
# no-cache forward's length, its flash launches (one a layer with attention;
# zamba2: one a group, its shared block; rwkv6: none), a depth cut where the
# card cannot hold the model, and whether ServeEngine runs it
NONDENSE = {
    "granite-moe-1b-a400m": dict(phase="7a", S=4096, flash=24, engine=True),
    "zamba2-2.7b": dict(phase="7b", S=4096, flash=9, engine=True),
    "rwkv6-3b": dict(phase="7c", S=4096, flash=0, engine=True),
    # 48 layers of 18.6 B parameters a group are 890 GB in bf16: one group
    # (a dense-MLP layer and a routed layer of 128 experts, top-1, shared
    # expert), 37 GB, and one fp32 expert leaf of 21.5 GB while it is drawn
    "llama4-maverick-400b-a17b": dict(phase="7d", S=2048, flash=2, n_layers=2, engine=False),
    "musicgen-large": dict(phase="7e", S=4096, flash=48, engine=True),
    "pixtral-12b": dict(phase="7e", S=4096, flash=40, engine=False),
}
# functions of the forward whose device time the profile groups by the
# function that launched it (module, function, group); the innermost wins
SPANS = (("moe", "_expert_ffn", "expert_gemm"), ("moe", "_gather_dispatch", "dispatch"),
         ("moe", "_router", "router"), ("ssm", "ssd_chunked", "ssd_chunk_loop"),
         ("rwkv", "wkv6_chunked", "wkv_chunk_loop"))


class spans:
    """Within the block, each function of SPANS runs inside a
    ``record_function("span:<group>")`` range, which the profiler's tree
    keeps above the ops that launch its kernels."""

    def __enter__(self):
        import importlib

        from torch.profiler import record_function

        self.saved = []
        for mod, fn, group in SPANS:
            m = importlib.import_module(f"repro_torch.models.{mod}")
            f = getattr(m, fn)

            def wrapped(*a, _f=f, _g=group, **kw):
                with record_function(f"span:{_g}"):
                    return _f(*a, **kw)

            setattr(m, fn, wrapped)
            self.saved.append((m, fn, f))
        return self

    def __exit__(self, *exc):
        for m, fn, f in self.saved:
            setattr(m, fn, f)


def span_groups(ops: dict, ranges: list, kernels: list) -> tuple:
    """Device time by group: each kernel (linked op id, start, end, name)
    under the innermost range (start, end, group) open when the op that
    launched it started (``ops``: op id -> start; host clock), else under
    ``lm_kernel``'s group of its name.  One sweep over the host timeline.
    Returns ({group: (kernels, us)}, us under a range)."""
    points = sorted([(r0, 1, i) for i, (r0, _, _) in enumerate(ranges)] +
                    [(r1, 0, i) for i, (_, r1, _) in enumerate(ranges)])
    launched = sorted((ops[op], j) for j, (op, _, _, _) in enumerate(kernels) if op in ops)
    label = [None] * len(kernels)
    open_, p = [], 0
    for t, j in launched:
        while p < len(points) and points[p][0] <= t:
            _, opens, i = points[p]
            open_.append(i) if opens else open_.remove(i)
            p += 1
        if open_:
            label[j] = ranges[open_[-1]][2]
    by, under = {}, 0.0
    for (_, k0, k1, name), g in zip(kernels, label):
        us = (k1 - k0) / 1e3
        g, under = (g, under + us) if g else (lm_kernel(name), under)
        n, tot = by.get(g, (0, 0.0))
        by[g] = (n + 1, tot + us)
    return by, under


def profiled_forward(torch, label: str, run) -> None:
    """``profiled``'s numbers for one forward (wall, host dispatch, device
    busy, span and idle share), with the device time grouped by SPANS and
    kernel names (``span_groups``).  It reads the profiler's raw events:
    building its Python event tree costs about 70 us an event, minutes
    for a recurrent forward's 10^6 events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with spans(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm_up(torch)
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops, span_list, kernels = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name, t0_ns = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            # a record_function range shows as a device annotation too: not a kernel
            if not name.startswith("span:") and WARMUP_KERNEL not in name:
                kernels.append((e.linked_correlation_id(), t0_ns, t0_ns + e.duration_ns(), name))
        elif name.startswith("span:"):
            span_list.append((t0_ns, t0_ns + e.duration_ns(), name[5:]))
        elif e.correlation_id():
            ops[e.correlation_id()] = t0_ns
    if not kernels:
        print(f"{label} profile: no device events recorded (wall_ms={wall_ms:.3f}); device time not measured")
        return
    iv = sorted((k0, k1) for _, k0, k1, _ in kernels)
    busy, (cs, ce) = 0, iv[0]
    for k0, k1 in iv[1:]:
        if k0 > ce:
            busy, cs, ce = busy + (ce - cs), k0, k1
        else:
            ce = max(ce, k1)
    busy, span = (busy + ce - cs) / 1e6, (max(k1 for _, k1 in iv) - iv[0][0]) / 1e6
    by, under = span_groups(ops, span_list, kernels)
    total = sum(us for _, us in by.values())
    parts = " ".join(f"{k}={v[1] / 1e3:.3f}ms/{v[0]}" for k, v in sorted(by.items(), key=lambda kv: -kv[1][1]))
    print(f"{label} profile (profiler on): wall_ms={wall_ms:.3f} host_dispatch_ms={host_ms:.3f} "
          f"device_span_ms={span:.3f} device_busy_ms={busy:.3f} idle_share_of_span={1 - busy / span:.3f}; "
          f"kernels {total / 1e3:.3f} ms, by group ({under / 1e3:.3f} ms of it under a SPANS function): {parts}")


def nondense_model(torch, name: str, spec: dict):
    """A family's model on the card, bf16 at its published widths (and
    depth, but for a cut in ``spec``), seeded random weights; prints its
    configuration, parameters and bytes.  MoE routers must be fp32."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    published = get_arch(name)
    cfg = dataclasses.replace(published, use_pallas=True, n_layers=spec.get("n_layers", published.n_layers))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    counts = model.param_counts()
    cut = f" (cut from {published.n_layers}: one group)" if cfg.n_layers != published.n_layers else " (published)"
    print(f"lm {name}: family={cfg.family} layers={cfg.n_layers}{cut} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv} hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab} experts={cfg.n_experts} "
          f"top_k={cfg.top_k} ssm_heads={cfg.ssm_heads} ssm_state={cfg.ssm_state} rwkv_head={cfg.rwkv_head_size} "
          f"frontend={cfg.frontend} params={n_params} (template {counts['total']}, active {counts['active']}) "
          f"bytes={n_bytes} ({n_bytes / 1e9:.2f} GB) peak_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"init_s={time.perf_counter() - t0:.2f}")
    if n_params != counts["total"]:
        raise AssertionError(f"{name}: {n_params} parameters on the card, the template counts {counts['total']}")
    routers = [p["mlp"]["router"] for d, p in model_layers(model) if d.moe]
    if cfg.is_moe:
        bad = [(r.dtype, r.device) for r in routers if r.dtype != torch.float32 or r.device != model.device]
        if not routers or bad:
            raise AssertionError(f"{name}: {len(routers)} routers, not fp32 on the card: {bad}")
        print(f"lm {name}: {len(routers)} MoE routers, all torch.float32 on {routers[0].device}")
    return model


def nondense_forward(torch, fa, model, spec: dict) -> int:
    """The no-cache forward at B = 1, S = spec["S"] between zeroed and read
    flash launch counts (exactly spec["flash"], all on the Hopper kernel),
    timed with the flash kernel and with the plain attention, checked
    teacher-forced layer by layer (``teacher_forced``) where it attends,
    and profiled (``profiled_forward``).  Returns the flash launches."""
    import dataclasses

    import numpy as np

    from repro_torch.models.frontend import synth_embeddings, uses_stub_frontend

    cfg = model.cfg
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    S = spec["S"]
    if uses_stub_frontend(cfg):
        batch = {"embeds": synth_embeddings(cfg, 0, 1, S, model.device)}
    else:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, S))).cuda()}
    fa.reset_launches()
    t0 = time.perf_counter()
    h, _ = model(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, sm90 = fa.LAUNCHES["flash_attention"], fa.LAUNCHES["flash_attention_sm90"]
    if launches != spec["flash"] or sm90 != launches:
        raise AssertionError(f"{cfg.name} forward launched flash_attention {launches} times ({sm90} on the Hopper "
                             f"kernel), not {spec['flash']} on it")
    if h.shape != (1, S, cfg.d_model) or h.dtype != torch.bfloat16 or not torch.isfinite(h).all():
        raise AssertionError(f"{cfg.name} forward: hidden {tuple(h.shape)} {h.dtype}, finite "
                             f"{bool(torch.isfinite(h).all())}")
    recurrent = cfg.family in ("rwkv", "hybrid")  # host bound: tens of thousands of small launches
    reps, warmup = (1, 0) if recurrent else (3, 2)
    ms = cuda_ms(lambda: model(batch), reps, warmup=warmup)
    line = f"lm {cfg.name} forward S={S}: flash launches={launches} ({sm90} on the Hopper kernel) " \
           f"first_s={first_s:.3f} forward_ms use_pallas=True {ms:.3f}"
    if launches:
        model.cfg = plain_cfg
        plain_ms = cuda_ms(lambda: model(batch), 2, warmup=1)
        model.cfg = cfg
        line += f", use_pallas=False (plain _sdpa_auto) {plain_ms:.3f}"
    print(line)
    del h
    if launches:
        got = teacher_forced(torch, model, batch, plain_cfg)
        moe_note = ""
        if cfg.is_moe:
            moe_note = (f"; MoE layers: tokens whose top-k set differs between the paths {got['topk_differ']}, "
                        f"whose kept experts differ {got['rerouted']} (left out of the per-position maximum); "
                        f"(token, k) assignments dropped at capacity {got['dropped']:.4f} of all")
        print(f"lm {cfg.name} forward teacher-forced, each layer flash vs plain on the same input: per layer "
              f"largest per-position rel_l2 [{', '.join(f'{e:.2e}' for e in got['per_layer'])}], whole-layer "
              f"rel_l2 [{', '.join(f'{e:.2e}' for e in got['per_layer_rel'])}]; max {got['layer_max']:.3e} "
              f"(layer {got['layer_worst']}; {got['over']} positions above tol), final hidden {got['hidden']:.3e}, "
              f"logits {got['logits']:.3e}, top1 agreement {got['top1']:.4f} (tol {LM_TOL}){moe_note}")
        if max(got["layer_max"], got["layer_rel_max"], got["hidden"], got["logits"]) > LM_TOL:
            raise AssertionError(f"{cfg.name}: the flash forward disagrees with the plain one: {got}")
    profiled_forward(torch, f"lm {cfg.name} forward S={S}", lambda: model(batch))
    print(f"lm {cfg.name} peak device memory GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return launches


def nondense_path(torch) -> dict:
    """Phase 7: each family of NONDENSE built (7a granite, 7b zamba2, 7c
    rwkv6, 7d llama4's one group, 7e musicgen and pixtral), its forward run
    and checked (``nondense_forward``), then ``ServeEngine`` over it where
    NONDENSE says so (``lm_engine``; an MoE model twice: at its published
    capacity, timed, and at capacity n_experts / top_k, where no token drops,
    for the teacher-forced check), and freed before the next.  Returns the
    flash launches of each forward that attends."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa

    paths = {}
    for name, spec in NONDENSE.items():
        t0 = time.perf_counter()
        model = nondense_model(torch, name, spec)
        launches = nondense_forward(torch, fa, model, spec)
        if launches:
            paths[name] = launches
        if spec["engine"]:
            cfg = model.cfg
            lm_engine(torch, model, check=not cfg.is_moe, eager_steps=ENGINE_EAGER_STEPS)
            if cfg.is_moe:
                model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
                print(f"engine {name}: again at capacity_factor={model.cfg.capacity_factor} (no drops) for the "
                      f"teacher-forced check")
                lm_engine(torch, model, check=True, profile=False, eager_steps=ENGINE_EAGER_STEPS)
                model.cfg = cfg
        del model
        torch.cuda.empty_cache()
        print(f"phase {spec['phase']} {name} s={time.perf_counter() - t0:.2f}")
    return paths


# --------------------------------------------------------------------------
# Phase 8: the training path
# --------------------------------------------------------------------------
TRAIN_LM = "starcoder2-7b"  # published widths, bf16 compute, fp32 masters and moments
TRAIN_LAYERS = 8  # of 32: masters, gradients and two fp32 moments take 16 bytes a parameter
TRAIN_SEQ, TRAIN_BATCH = 4096, 4
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
TRAIN_LR = (3e-4, 2)  # warmup_cosine(peak, warmup, total=TRAIN_STEPS)
# no global-norm clip: at the seeded init the gradient's norm grows steeply
# with depth, in the reference as in the port (tests/test_torch_train.py
# test_grad_norm_growth_with_depth_is_the_reference; 8.1e8 at 8 layers at
# this width, nearly all of it the embedding's), so a clip at 1.0 scales every
# other gradient under Adam's eps and only the embedding moves (PERF.md,
# section 6)
TRAIN_CLIP = 0.0
# one step captured against the same step eager, from one state: the largest
# relative L2 difference of a parameter leaf (the embedding gradient's
# atomics are not deterministic, and a bf16 gradient moves with them)
CAPTURED_TOL = 1e-3
# Besides the last five steps' mean below the first five's, 8a's loss check
# is paired: the last five steps' losses against the losses of the seeded
# init (the same run at lr 0) on the same batches, whose mean must fall by
# at least LOSS_FALL.  A loss at fixed parameters is the same in the
# captured step and eager to 0 (8b), so a run that trained nothing falls by
# 0, where the batches' own spread (0.04 in 20 steps, PERF.md section 6)
# hides a fall of 0.02 between the first five steps and the last
LOSS_FALL = 5e-3
# 8b: the head's backward (bf16 GEMMs on the fp32 gradient split into two
# bf16 parts) against float64 on the card: relative L2 of each product.  A
# tenth of the bf16 rounding each product then takes (2**-9 / sqrt(3) =
# 1.1e-3).  The bf16 GEMMs' own fp32 accumulation over K = 49152 costs
# about 6e-5, the reference's fp32 contraction 4e-6 (PERF.md, section 6)
HEAD_GRAD_TOL = 1e-4
# 8d, card vs CPU.  lr 1e-4: Adam divides each gradient element by its own
# size plus eps = 1e-8, so an element of ~eps whose fp32 sums differ by a few
# percent between the devices ends ~lr / 15 apart; at lr 1e-3 one embedding
# element of 16384 ended 6.7e-5 apart, past atol 2e-5 (PERF.md, section 6)
TRAIN_F32 = {"arch": "starcoder2-7b", "seq": 32, "batch": 4, "steps": 2, "lr": 1e-4}
TRAIN_DEVICE = "cuda"
TRAIN_F32_TOL = {"rtol": 2e-4, "atol": 2e-5}


def train_opt_cfg(cfg):
    from repro_torch import optim

    return optim.AdamWConfig(lr=optim.warmup_cosine(TRAIN_LR[0], warmup=TRAIN_LR[1], total=TRAIN_STEPS),
                             clip_norm=TRAIN_CLIP, state_dtype=cfg.optim_state_dtype)


def train_cfg():
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(TRAIN_LM), n_layers=TRAIN_LAYERS, remat="full", use_pallas=False)


def reset_state(torch, cfg, params: dict, opt: dict, seed: int = 0) -> None:
    """Bring ``params`` and ``opt`` back, in place, to the state a trainer
    seeded with ``seed`` starts from (the same draws, leaf by leaf, as
    ``build_model(..., train=True)``), without a second copy on the card."""
    from repro_torch.models.layers import init_tensor, map_template
    from repro_torch.models.model import model_template

    gen = torch.Generator(device=params["final_norm.scale"].device).manual_seed(seed)

    def draw(spec, path):
        p = params[path.strip("/").replace("/", ".")]
        with torch.no_grad():
            p.copy_(init_tensor(spec, gen, cfg.param_dtype, p.device))

    map_template(model_template(cfg), draw)
    for t in list(opt["m"].values()) + list(opt["v"].values()) + [opt["count"]]:
        t.zero_()


def max_leaf_rel(torch, got: dict, want: dict) -> float:
    """The largest relative L2 difference over the leaves of two flat trees."""
    worst = 0.0
    for k, w in want.items():
        w = w.float()
        worst = max(worst, ((got[k].float() - w).norm() / w.norm().clamp_min(1e-30)).item())
    return worst


def train_kernel(name: str) -> str:
    """The group of a device kernel of the training step: the bf16 products
    (the weight GEMMs and the head: cuBLASLt's ``nvjet`` kernels on the
    H100), the plain attention's float32 products (FFMA ``f32f32``/``sgemm``
    kernels: no float32 GEMM outside the attention) and softmax, and the
    rest (elementwise, reductions, copies; the attention's mask and scale
    passes over its fp32 scores among them)."""
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "attention" if any(k in low for k in ("f32f32", "sgemm", "simt")) else "gemm"
    if "softmax" in low:
        return "attention"
    return "elementwise"


def profiled_train_step(torch, label: str, run, n_opt: int) -> None:
    """One captured step under the profiler: device busy and idle share,
    device time by group (``train_kernel``; the last ``n_opt`` kernels in
    time, the AdamW update's count, as "optimizer"), and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm_up(torch)
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA and WARMUP_KERNEL not in ev.name),
                 key=lambda ev: ev.time_range.start)
    if len(evs) <= n_opt:
        print(f"{label} profile: {len(evs)} device events recorded (wall_ms={wall_ms:.3f}); device time not measured")
        return
    busy, span, _ = device_busy(prof, train_kernel)
    by, top = {}, {}
    for i, ev in enumerate(evs):
        group = "optimizer" if i >= len(evs) - n_opt else train_kernel(ev.name)
        n, us = by.get(group, (0, 0.0))
        by[group] = (n + 1, us + ev.time_range.elapsed_us())
        n, us = top.get(ev.name, (0, 0.0))
        top[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    parts = " ".join(f"{k}={v[1] / 1e3:.3f}ms/{v[0]}" for k, v in sorted(by.items()))
    print(f"{label} profile (profiler on): wall_ms={wall_ms:.3f} host_dispatch_ms={host_ms:.3f} "
          f"device_span_ms={span / 1e3:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"idle_share_of_span={1 - busy / span:.3f} kernels={len(evs)} by_group: {parts}")
    for name, (n, us) in sorted(top.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"{label} kernel {us / 1e3:.3f}ms/{n} [{train_kernel(name)}] {name[:150]}")


def optimizer_kernels(torch, params: dict, opt: dict, opt_cfg) -> int:
    """Kernels one AdamW update launches on the trainer's tree (zero
    gradients; the state moves, it is not read again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim

    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        optim.update(grads, opt, params, opt_cfg)
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if ev.device_type == DeviceType.CUDA)


def trainer_run(torch) -> dict:
    """8a: ``Trainer`` for TRAIN_STEPS steps from a seeded init on the
    captured step, checkpoints every TRAIN_CKPT_EVERY into a temporary
    directory; then a profiled replay."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models import param_counts
    from repro_torch.train import Trainer, TrainerConfig

    cfg = train_cfg()
    shape = ShapeConfig("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt_cfg = train_opt_cfg(cfg)
    counts = param_counts(cfg)
    flops = model_flops(cfg, shape)
    print(f"train {TRAIN_LM}: layers={cfg.n_layers} (of 32) d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv} "
          f"hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab} compute={cfg.compute_dtype} masters={cfg.param_dtype} "
          f"moments={opt_cfg.state_dtype} remat={cfg.remat} use_pallas={cfg.use_pallas} clip={opt_cfg.clip_norm} "
          f"seq={TRAIN_SEQ} "
          f"batch={TRAIN_BATCH} params={counts['total']} model_flops={flops:.4e}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state_bytes = counts["total"] * (4 + 2 * opt_cfg.state_dtype.itemsize)
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as d:
        free = shutil.disk_usage(d).free
        print(f"train checkpoints in {d}: {free / 1e9:.1f} GB free, {state_bytes / 1e9:.1f} GB a checkpoint")
        trainer = Trainer(cfg, shape, None, TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=d,
                                                          log_every=5, seed=0), opt_cfg, device=TRAIN_DEVICE)
        seen, ckpt_s = [], {"save": 0.0, "wait": 0.0}

        def timed(name, fn):
            def run(*a, **k):
                t, waited = time.perf_counter(), ckpt_s["wait"]
                try:
                    return fn(*a, **k)
                finally:  # a save's own time leaves out the wait inside it
                    ckpt_s[name] += time.perf_counter() - t - (ckpt_s["wait"] - waited if name == "save" else 0)
            return run

        # the trainer's own checkpoint calls, timed: a save's host copy, and
        # the waits for the writer thread
        trainer.ckpt.save = timed("save", trainer.ckpt.save)
        trainer.ckpt.wait = timed("wait", trainer.ckpt.wait)

        dropped = []

        def on_metrics(step, m):
            seen.append((trainer.step_fn.compiles, trainer.step_fn.graph_replays))
            if step == TRAIN_STEPS - 1:  # one checkpoint on disk at a time: the chip tool's disk holds 45 GiB
                dropped.append(drop_verified_checkpoint(trainer.ckpt, TRAIN_CKPT_EVERY, state_bytes))
            print(f"train step {step}: loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} lr={m['lr']:.3e} "
                  f"ms={m['step_time_s'] * 1e3:.1f} compiles={seen[-1][0]} graph_replays={seen[-1][1]}")

        t0 = time.perf_counter()
        out = trainer.train(on_metrics=on_metrics)
        train_s = time.perf_counter() - t0
        steps = trainer.ckpt.all_steps()
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in out["metrics"]]
    times = [m["step_time_s"] for m in out["metrics"]]
    median_s = float(np.median(times[1:]))
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / median_s
    mfu = flops / median_s / PEAK_BF16_FLOPS
    print(f"train result: steps={out['step']} first_step_ms={times[0] * 1e3:.1f} (warm-up + capture) "
          f"median_replay_step_ms={median_s * 1e3:.1f} tokens_per_s={tokens_s:.1f} model_flops={flops:.4e} "
          f"mfu={mfu:.4f} peak_memory_GB={peak / 1e9:.2f} train_s={train_s:.2f} checkpoints={steps} "
          f"checkpoint_GB={ckpt_bytes / 1e9:.2f} checkpoint_save_s={ckpt_s['save']:.2f} "
          f"checkpoint_wait_s={ckpt_s['wait']:.2f} stragglers={out['stragglers']} failures={out['failures']} "
          f"loss_first5={np.mean(losses[:5]):.4f} loss_last5={np.mean(losses[-5:]):.4f}")
    if out["step"] != TRAIN_STEPS or out["failures"]:
        raise AssertionError(f"train: stopped at step {out['step']} with {out['failures']} failures")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite losses {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if seen[0] != (1, 0) or seen[-1] != (1, TRAIN_STEPS - 1):
        raise AssertionError(f"train: (compiles, graph replays) {seen[0]} after step 1 and {seen[-1]} at the end, "
                             f"expected (1, 0) and (1, {TRAIN_STEPS - 1})")
    if dropped != [TRAIN_CKPT_EVERY] or steps != [TRAIN_STEPS]:
        raise AssertionError(f"train: checkpoint {dropped} verified and dropped, {steps} left")
    params, opt = out["params"], out["opt_state"]
    batch = next(trainer._batches(TRAIN_STEPS))
    step_fn, ds = trainer.step_fn, trainer.dataset
    del trainer, out
    n_opt = optimizer_kernels(torch, params, opt, opt_cfg)
    profiled_train_step(torch, "train replay", lambda: step_fn(params, opt, batch), n_opt)
    del step_fn
    lr0 = losses_at_init(torch, cfg, params, opt, ds, TRAIN_STEPS - 5)
    fall = np.asarray(lr0) - np.asarray(losses[-5:])
    print(f"train loss: last five steps {np.round(losses[-5:], 6).tolist()} against the seeded init (lr 0) on the "
          f"same batches {np.round(lr0, 6).tolist()}: fall mean={fall.mean():.6f} min={fall.min():.6f} "
          f"(first five steps' mean {np.mean(losses[:5]):.6f}, last five's {np.mean(losses[-5:]):.6f})")
    if not fall.mean() >= LOSS_FALL:
        raise AssertionError(f"train: the loss did not fall against lr 0 on the same batches: {fall.tolist()}")
    del params, opt, batch
    torch.cuda.empty_cache()
    return {"first_step_ms": times[0] * 1e3, "median_step_ms": median_s * 1e3, "tokens_per_s": tokens_s,
            "model_flops": flops, "mfu": mfu, "peak_memory_bytes": peak, "losses": losses, "loss_fall": fall.tolist()}


def drop_verified_checkpoint(ckpt, step: int, state_bytes: int) -> int:
    """Wait for ``step``'s checkpoint, check that it is whole (its meta
    names every leaf and its arrays hold the state's bytes), and delete it:
    the next one then has the disk to itself.  Returns ``step``."""
    import json
    import shutil

    ckpt.wait()
    d = ckpt.dir / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    size = (d / "arrays.npz").stat().st_size
    print(f"train checkpoint {step}: {len(meta['keys'])} leaves, {size / 1e9:.2f} GB; deleted before step "
          f"{step + TRAIN_CKPT_EVERY}'s")
    if ckpt.all_steps() != [step] or size < state_bytes or set(meta["crc"]) != set(meta["keys"]):
        raise AssertionError(f"train: checkpoint {step} is not whole: {ckpt.all_steps()}, {size} bytes")
    shutil.rmtree(d)
    return step


def losses_at_init(torch, cfg, params: dict, opt: dict, ds, start: int) -> list:
    """The seeded init's loss (``params`` and ``opt`` are put back to it in
    place) on the trainer's batches (``ds``) of steps ``start + 1 ..
    TRAIN_STEPS``: the losses the same run at lr 0 reports."""
    from repro_torch.data import sharded_batches
    from repro_torch.models import build_model

    reset_state(torch, cfg, params, opt)
    model = build_model(cfg, device="meta", train=True)
    batches = sharded_batches(ds, TRAIN_DEVICE, start_index=start)
    with torch.no_grad():
        return [float(model.loss_of(params, next(batches))[0]) for _ in range(TRAIN_STEPS - start)]


def captured_vs_eager_step(torch) -> tuple:
    """8b: one step from the seeded state on batch 0 eager (``plan.fn``),
    then captured (the first call warms up and captures; the state is put
    back and the second call replays the graph): parameters within
    CAPTURED_TOL.  Returns (the eager step's parameters, the state
    tensors, the batch, the dataset) for 8c."""
    import numpy as np

    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg = train_cfg()
    shape = ShapeConfig("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt_cfg = train_opt_cfg(cfg)
    plan = make_train_step(cfg, None, shape, opt_cfg, device=TRAIN_DEVICE)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0))
    batch = next(sharded_batches(ds, TRAIN_DEVICE))
    params = build_model(cfg, seed=0, device=TRAIN_DEVICE, train=True).train_params()
    opt = optim.init(params, opt_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m_eager = plan.fn(params, opt, batch)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    eager = {k: v.detach().clone() for k, v in params.items()}  # 8.8 GB, kept on the card for 8c
    step = plan.jitted()
    reset_state(torch, cfg, params, opt)
    t0 = time.perf_counter()
    step(params, opt, batch)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    reset_state(torch, cfg, params, opt)
    t0 = time.perf_counter()
    _, _, m_graph = step(params, opt, batch)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    diff = max_leaf_rel(torch, params, eager)
    loss_d = abs(float(m_graph["loss"]) - float(m_eager["loss"])) / abs(float(m_eager["loss"]))
    gn_d = abs(float(m_graph["grad_norm"]) - float(m_eager["grad_norm"])) / abs(float(m_eager["grad_norm"]))
    print(f"train captured vs eager: eager_step_ms={eager_ms:.1f} first_call_s={capture_s:.2f} (warm-up + capture) "
          f"replay_step_ms={replay_ms:.1f} graph_replays={step.graph_replays} compiles={step.compiles} "
          f"max_param_rel_l2={diff:.3e} loss_rel={loss_d:.3e} grad_norm_rel={gn_d:.3e} "
          f"(eager loss={float(m_eager['loss']):.6f} grad_norm={float(m_eager['grad_norm']):.6f})")
    if not (step.captured and step.graph_replays == 1 and step.compiles == 1):
        raise AssertionError("train: the captured step did not replay a graph")
    if not max(diff, loss_d, gn_d) <= CAPTURED_TOL or not np.isfinite(diff):
        raise AssertionError(f"train: captured step vs eager {diff:.3e} / {loss_d:.3e} / {gn_d:.3e} > {CAPTURED_TOL}")
    del step, plan
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    head_backward_check(torch, cfg, params["lm_head"] if "lm_head" in params else params["embed"].t())
    return eager, params, opt, batch, ds


def head_backward_check(torch, cfg, w_master) -> None:
    """8b: the head's backward on one loss chunk of the main path (h of
    shape (batch x loss_chunk, d_model) in bf16, the model's head weight in
    bf16, the fp32 logit gradient softmax - one-hot over the chunk's
    tokens) against the same products in float64: each within
    HEAD_GRAD_TOL relative L2.  Also prints how far the reference's
    arithmetic (the fp32 gradient contracted with the bf16 operands in
    fp32, no TF32) and the cheaper arithmetic this backward does not use
    (the gradient rounded to bf16, two GEMMs in place of four) land."""
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.models.model import bf16_head_grads

    gen = torch.Generator(device=w_master.device).manual_seed(1)
    n = TRAIN_BATCH * min(cfg.loss_chunk, TRAIN_SEQ)
    w = w_master.detach().to(cfg.compute_dtype)
    h = torch.randn(n, cfg.d_model, generator=gen, device=w.device).to(cfg.compute_dtype)
    labels = torch.randint(0, cfg.vocab, (n,), generator=gen, device=w.device)
    with fp32_matmul():
        g = torch.softmax(h.float() @ w.float(), dim=-1)
    g[torch.arange(n, device=g.device), labels] -= 1
    g /= n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dh, dw = bf16_head_grads(h, w, g)
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) * 1e3
    want = (g.double() @ w.double().t(), h.double().t() @ g.double())

    def rel(got):
        return [((a.double() - b).norm() / b.norm()).item() for a, b in zip(got, want)]

    err = rel((dh, dw))
    del dh, dw
    with fp32_matmul():
        ref = rel((g @ w.float().t(), h.float().t() @ g))
    gr = g.to(cfg.compute_dtype)
    rounded = rel((torch.mm(gr, w.t(), out_dtype=torch.float32), torch.mm(h.t(), gr, out_dtype=torch.float32)))
    print(f"train head backward ({n} x {cfg.d_model} @ {cfg.d_model} x {cfg.vocab}), rel_l2 (dh, dw) against "
          f"float64: split bf16 GEMMs {err[0]:.3e} {err[1]:.3e} (tol {HEAD_GRAD_TOL}); the fp32 contraction "
          f"{ref[0]:.3e} {ref[1]:.3e}; the gradient rounded to bf16 first {rounded[0]:.3e} {rounded[1]:.3e}; "
          f"split_ms={split_ms:.2f}")
    if not max(err) <= HEAD_GRAD_TOL:
        raise AssertionError(f"train head backward: {err} > {HEAD_GRAD_TOL}")


def utp_fused_steps(torch, eager: dict, params: dict, opt: dict, batch: dict, ds) -> None:
    """8c: ``UTPTrainStep`` fused, m = 2, from the seeded state: the first
    call (warm-up and capture) within CAPTURED_TOL of 8b's eager step, two
    replays on batches 1 and 2 (compiles 1, then 0), and a replay from the
    seeded state on batch 0 held to 8b's step again."""
    from repro_torch import optim
    from repro_torch.data import sharded_batches
    from repro_torch.models import build_model
    from repro_torch.train import UTPTrainStep

    cfg = train_cfg()
    opt_cfg = train_opt_cfg(cfg)
    model = build_model(cfg, device="meta", train=True)
    utp = UTPTrainStep(model.value_and_grad, opt_cfg, microbatches=2, executor="fused", device=TRAIN_DEVICE)
    reset_state(torch, cfg, params, opt)
    torch.cuda.reset_peak_memory_stats()
    compiles, diffs, ms = [], [], []
    batches = sharded_batches(ds, TRAIN_DEVICE, start_index=1)
    for i, b in enumerate([batch, next(batches), next(batches), batch]):
        if i == 3:
            reset_state(torch, cfg, params, opt)
        before = utp.executor.stats["compiles"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = utp(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        compiles.append(utp.executor.stats["compiles"] - before)
        if i in (0, 3):
            diffs.append(max_leaf_rel(torch, params, eager))
        print(f"train utp fused m=2 call {i + 1}: ms={ms[-1]:.1f} compiles={compiles[-1]} "
              f"graph_replays={utp.executor.stats['graph_replays']} loss={float(met['loss']):.4f}")
    print(f"train utp fused: vs 8b's eager step max_param_rel_l2 first_call={diffs[0]:.3e} replay={diffs[1]:.3e} "
          f"peak_memory_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if compiles != [1, 0, 0, 0] or utp.executor.stats["graph_replays"] != 3:
        raise AssertionError(f"train utp: compiles {compiles}, graph replays {utp.executor.stats['graph_replays']}")
    if not max(diffs) <= CAPTURED_TOL:
        raise AssertionError(f"train utp: {diffs} vs the eager step > {CAPTURED_TOL}")


def card_vs_cpu(torch) -> None:
    """8d: a reduced float32 configuration, the same captured step on the
    card and eager on the CPU from one init over the same batches: every
    parameter within TRAIN_F32_TOL."""
    import dataclasses

    import numpy as np

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    f = TRAIN_F32
    cfg = dataclasses.replace(get_arch(f["arch"]).reduced(), remat="full")
    shape = ShapeConfig("train_f32", f["seq"], f["batch"], "train")
    opt_cfg = optim.AdamWConfig(lr=f["lr"])
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=f["seq"], global_batch=f["batch"], seed=0))
    init = build_model(cfg, seed=0, device="cpu", train=True).train_params()
    out = {}
    for dev in ("cpu", TRAIN_DEVICE):
        params = {k: v.detach().to(dev, copy=True) for k, v in init.items()}
        opt = optim.init(params, opt_cfg)
        step = make_train_step(cfg, None, shape, opt_cfg, device=dev).jitted()
        for b in [next(sharded_batches(ds, dev, start_index=i)) for i in range(f["steps"])]:
            params, opt, met = step(params, opt, b)
        out[dev] = ({k: v.detach().cpu() for k, v in params.items()}, float(met["loss"]), step)
    worst = max(float(((out[TRAIN_DEVICE][0][k] - v).abs() - TRAIN_F32_TOL["rtol"] * v.abs()).max())
                for k, v in out["cpu"][0].items())
    print(f"train card vs cpu ({f['arch']} reduced, float32, {f['steps']} steps): loss card={out[TRAIN_DEVICE][1]:.6f} "
          f"cpu={out['cpu'][1]:.6f} graph_replays={out[TRAIN_DEVICE][2].graph_replays} "
          f"worst |diff| - rtol |cpu| = {worst:.3e} (atol {TRAIN_F32_TOL['atol']})")
    if out[TRAIN_DEVICE][2].graph_replays != f["steps"] - 1:
        raise AssertionError("train card vs cpu: the card's step did not replay its graph")
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out[TRAIN_DEVICE][0][k].numpy(), v.numpy(), **TRAIN_F32_TOL, err_msg=k)


def train_path(torch) -> dict:
    """Phase 8: the trainer (8a), captured against eager (8b), the UTP task
    tree fused (8c) and the card against the CPU (8d)."""
    import gc

    t0 = time.perf_counter()
    result = trainer_run(torch)
    print(f"phase 8a s={time.perf_counter() - t0:.2f}")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    eager, params, opt, batch, ds = captured_vs_eager_step(torch)
    print(f"phase 8b s={time.perf_counter() - t1:.2f}")
    t1 = time.perf_counter()
    utp_fused_steps(torch, eager, params, opt, batch, ds)
    del eager, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8c s={time.perf_counter() - t1:.2f}")
    t1 = time.perf_counter()
    card_vs_cpu(torch)
    print(f"phase 8d s={time.perf_counter() - t1:.2f}")
    return result


# --------------------------------------------------------------------------
# Phase 9: the launch layer's plans over a one-device mesh
# --------------------------------------------------------------------------
PLAN_S = 4096  # 9a's prefill: B = 1, S = 4096, as 6c's forward
PLAN_PROMPT = 64  # 9b: every slot's prompt, prefilled before the decode steps
PLAN_TRAIN = dict(layers=2, batch=4, seq=4096)  # 9c
LM_NUMBERS: dict = {}  # phase 6's numbers that phase 9 prints beside its own


def one_device_mesh(torch, tmp: str):
    """A world-size-1 NCCL process group and its (1, 1) ("data", "model")
    mesh on cuda:0 (the caller destroys the group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def clone_tree(torch, tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def trees_equal(torch, a, b) -> bool:
    from repro_torch.tree import leaves

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def plan_prefill(torch, fa, mesh) -> tuple:
    """9a: ``make_prefill_step`` for starcoder2-7b (published widths, all 32
    layers, bf16, seeded weights) at B = 1, S = PLAN_S over the (1, 1) mesh,
    ``use_pallas`` on.  The plan fills a cache, and with a cache attention
    runs through ``_sdpa_auto`` over the cache, in the reference as here
    (its ``attention_apply`` calls flash only without one): no flash
    launch, counted between zeroed and read counters.  The logits and the
    cache equal ``Model.prefill``'s on the same inputs; timed.  Returns
    (model, flash launches)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch(LM), use_pallas=True)
    model = build_model(cfg, seed=0, device="cuda")
    params = {k: v.detach() for k, v in model.train_params().items()}
    plan = st.make_prefill_step(cfg, mesh, ShapeConfig("prefill_4k", PLAN_S, 1, "prefill"), device="cuda")
    if plan.in_shardings is None or plan.mesh is not mesh:
        raise AssertionError("9a: the prefill plan carries no placements over the mesh")
    g = torch.Generator(device="cuda").manual_seed(9)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, PLAN_S), generator=g, device="cuda", dtype=torch.int32)}
    cache = model.init_cache(1, PLAN_S)
    fa.reset_launches()
    logits, _ = plan.fn(params, batch, cache)
    torch.cuda.synchronize()
    launches, sm90 = fa.LAUNCHES["flash_attention"], fa.LAUNCHES["flash_attention_sm90"]
    if launches != 0 or sm90 != 0:
        raise AssertionError(f"9a: {launches} flash launches ({sm90} on sm90); the cache path launches none")
    own = model.init_cache(1, PLAN_S)
    want, _ = model.prefill(batch, own)
    if not torch.equal(logits, want) or not trees_equal(torch, cache, own):
        raise AssertionError(f"9a: the prefill plan differs from Model.prefill: logits max diff "
                             f"{(logits - want).abs().max().item():.3e}")
    ms = cuda_ms(lambda: plan.fn(params, batch, cache), reps=5)
    ms_model = cuda_ms(lambda: model.prefill(batch, own), reps=5)
    print(f"phase 9a {LM} prefill plan over mesh (1, 1): B=1 S={PLAN_S} flash launches={launches} (sm90 {sm90}); "
          f"(attention over the cache through _sdpa_auto, as the reference's prefill); "
          f"logits and cache equal to Model.prefill bit for bit; plan ms={ms:.3f} Model.prefill ms={ms_model:.3f} "
          f"tokens_per_s={PLAN_S / ms * 1e3:.1f}")
    del cache, own
    return model, launches


def plan_decode(torch, model, mesh) -> dict:
    """9b: ``make_decode_step`` at 6d's engine shape (ENGINE slots, max_seq)
    over the (1, 1) mesh, from every slot's PLAN_PROMPT-token prompt
    prefilled: its ``jitted()`` step captured into one CUDA graph on the
    first call (compiles 1) and replayed for ENGINE_DECODE_STEPS more
    greedy steps (compiles 0), the tokens and logits of every step equal to
    the same steps run eagerly from the same cache; ms a step captured and
    eager and a profiled replay, beside 6d's engine."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st

    cfg = model.cfg
    B, T = ENGINE["slots"], ENGINE["max_seq"]
    plan = st.make_decode_step(cfg, mesh, ShapeConfig("decode", T, B, "decode"), device="cuda")
    params = {k: v.detach() for k, v in model.train_params().items()}
    g = torch.Generator(device="cuda").manual_seed(10)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (B, PLAN_PROMPT), generator=g, device="cuda", dtype=torch.int32)}
    cache0 = model.init_cache(B, T)
    first, _ = model.prefill(prompt, cache0)

    def run(step, cache):
        tok = first.argmax(-1, keepdim=True).to(torch.int32)
        toks, logits = [], []
        for i in range(ENGINE_DECODE_STEPS + 1):
            pos = torch.tensor(PLAN_PROMPT + i, dtype=torch.int32, device="cuda")
            lg, _ = step(params, cache, {"tokens": tok}, pos)
            logits.append(lg.clone())
            tok = lg.argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        return torch.cat(toks, 1), torch.stack(logits)

    captured = plan.jitted()
    cache_c = clone_tree(torch, cache0)
    compiles = []

    def counted(*args):
        before = captured.compiles
        out = captured(*args)
        compiles.append(captured.compiles - before)
        return out

    toks_c, logits_c = run(counted, cache_c)
    replays = captured.graph_replays
    if compiles != [1] + [0] * ENGINE_DECODE_STEPS or replays != ENGINE_DECODE_STEPS:
        raise AssertionError(f"9b: compiles {compiles[:3]}... replays {captured.graph_replays}, want 1 then 0 "
                             f"and {ENGINE_DECODE_STEPS} replays")
    cache_e = clone_tree(torch, cache0)
    toks_e, logits_e = run(plan.fn, cache_e)
    if not torch.equal(toks_c, toks_e) or not torch.equal(logits_c, logits_e) or not trees_equal(torch, cache_c,
                                                                                                cache_e):
        raise AssertionError(f"9b: the captured decode differs from eager: tokens equal {torch.equal(toks_c, toks_e)}"
                             f", logits max diff {(logits_c - logits_e).abs().max().item():.3e}")
    tok = toks_e[:, -1:].contiguous()
    pos = torch.tensor(PLAN_PROMPT + ENGINE_DECODE_STEPS, dtype=torch.int32, device="cuda")
    ms_c = cuda_ms(lambda: captured(params, cache_c, {"tokens": tok}, pos), reps=20)
    ms_e = cuda_ms(lambda: plan.fn(params, cache_e, {"tokens": tok}, pos), reps=20)
    engine = LM_NUMBERS.get("engine", {}).get("decode_ms", float("nan"))
    print(f"phase 9b {LM} decode plan over mesh (1, 1): slots={B} max_seq={T} prompt={PLAN_PROMPT}: "
          f"{ENGINE_DECODE_STEPS + 1} greedy steps, compiles {compiles[0]} then {sum(compiles[1:])}, "
          f"graph_replays={replays}; tokens, logits and cache equal to the eager steps bit for bit; "
          f"ms a step captured={ms_c:.3f} eager={ms_e:.3f} (6d engine decode-only step mean={engine:.3f}); "
          f"tokens_per_s captured={B / ms_c * 1e3:.1f}")
    def replay():
        captured(params, cache_c, {"tokens": tok}, pos)[0].cpu()  # the logits come back, as a sampler's would
        return f"slots={B}"

    profiled(torch, f"9b {LM} decode plan replay", replay, classify=lm_kernel)
    del cache0, cache_c, cache_e
    return {"captured_ms": ms_c, "eager_ms": ms_e}


def plan_train(torch, mesh) -> None:
    """9c: ``make_train_step`` for starcoder2-7b at its published widths,
    PLAN_TRAIN's layers, batch and sequence, over the (1, 1) mesh, against
    the mesh-None plan (PR 24's), each captured and run once from the same
    seeded state: the loss and metrics equal bit for bit, and every
    parameter and moment leaf but the embedding's (its gradient sums rows
    with atomics: 8b) bit for bit; the embedding within CAPTURED_TOL."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch(LM), n_layers=PLAN_TRAIN["layers"])
    shape = ShapeConfig("train_4k", PLAN_TRAIN["seq"], PLAN_TRAIN["batch"], "train")
    opt_cfg = train_opt_cfg(cfg)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch))
    batch = next(sharded_batches(ds, "cuda"))
    out = []
    for m in (None, mesh):
        plan = st.make_train_step(cfg, m, shape, opt_cfg, device="cuda")
        blocks = build_model(cfg, seed=0, device="cuda", train=True).train_params()
        p, o = st.train_state(plan, blocks, opt_cfg)
        del blocks
        step = plan.jitted()
        t0 = time.perf_counter()
        _, _, met = step(p, o, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if step.compiles != 1 or not step.captured:
            raise AssertionError(f"9c: the step over mesh {m} was not captured (compiles {step.compiles})")
        out.append(({k: v.cpu() for k, v in p.items()}, {k: v.cpu() for k, v in o["m"].items()},
                    {k: v.clone() for k, v in met.items()}, first_s))
        step.release()
        del p, o, step, plan
        torch.cuda.empty_cache()
    (p0, m0, met0, s0), (p1, m1, met1, s1) = out
    if any(not torch.equal(met0[k], met1[k]) for k in met0):
        raise AssertionError(f"9c: metrics differ: {met0} vs {met1}")
    diff = [k for k in p0 if k != "embed" and not (torch.equal(p0[k], p1[k]) and torch.equal(m0[k], m1[k]))]
    if diff:
        raise AssertionError(f"9c: leaves differ between the plans: {diff[:5]}")
    emb = rel_l2(p1["embed"], p0["embed"])
    n_emb = int((p1["embed"] != p0["embed"]).sum())
    if emb > CAPTURED_TOL:
        raise AssertionError(f"9c: embedding rel_l2 {emb:.3e} > {CAPTURED_TOL}")
    print(f"phase 9c {LM} train plan over mesh (1, 1), {cfg.n_layers} layers, B={shape.global_batch} "
          f"S={shape.seq_len}: captured, loss={float(met1['loss']):.6f} grad_norm={float(met1['grad_norm']):.6e}; "
          f"metrics and every parameter and moment leaf but the embedding's ({len(p0) - 1} of {len(p0)}) equal to "
          f"the mesh-None plan's bit for bit; embedding rel_l2={emb:.3e}, {n_emb} elements differ (its gradient "
          f"sums rows with atomics; tol {CAPTURED_TOL}); first call s (capture included) mesh-None={s0:.2f} "
          f"mesh={s1:.2f}")


def plan_moe(torch, fa, mesh) -> int:
    """9d: granite-moe-1b-a400m at its published widths (bf16, seeded
    weights): the prefill plan over the (1, 1) mesh at B = 1, S = PLAN_S
    takes the EP path (every MoE layer through ``_moe_ep``, each router
    fp32 in and fp32 logits), held against ``Model.prefill`` (the local
    gather path) within LM_TOL (7a's).  Returns its flash launches (none:
    the cache path, as 9a)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model, moe

    name = "granite-moe-1b-a400m"
    cfg = dataclasses.replace(get_arch(name), use_pallas=True)
    model = build_model(cfg, seed=0, device="cuda")
    params = {k: v.detach() for k, v in model.train_params().items()}
    plan = st.make_prefill_step(cfg, mesh, ShapeConfig("prefill_4k", PLAN_S, 1, "prefill"), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, PLAN_S), generator=g, device="cuda", dtype=torch.int32)}
    calls, routers = [], []
    real_ep, real_router = moe._moe_ep, moe._router

    def ep(*a, **kw):
        calls.append(1)
        return real_ep(*a, **kw)

    def router(c, w, xf, *rest):
        out = real_router(c, w, xf, *rest)
        routers.append((w.dtype, out[0].dtype))
        return out

    moe._moe_ep, moe._router = ep, router
    try:
        cache = model.init_cache(1, PLAN_S)
        fa.reset_launches()
        logits, _ = plan.fn(params, batch, cache)
        launches = fa.LAUNCHES["flash_attention_sm90"]
    finally:
        moe._moe_ep, moe._router = real_ep, real_router
    if launches != 0 or len(calls) != cfg.n_layers or any(r != (torch.float32, torch.float32) for r in routers):
        raise AssertionError(f"9d: {len(calls)} EP layers (want {cfg.n_layers}), routers {set(routers)}")
    own = model.init_cache(1, PLAN_S)
    want, _ = model.prefill(batch, own)
    err = rel_l2(logits[0], want[0])
    from repro_torch.tree import leaves

    cache_err = max(rel_l2(a, b) for a, b in zip(leaves(cache), leaves(own)))
    if err > LM_TOL or cache_err > LM_TOL:
        raise AssertionError(f"9d: EP prefill vs local: logits rel_l2 {err:.3e}, cache {cache_err:.3e} > {LM_TOL}")
    print(f"phase 9d {name} prefill plan over mesh (1, 1): {len(calls)} MoE layers on the EP path, "
          f"{len(routers)} routers fp32 (weights and logits); vs Model.prefill (local gather path): logits "
          f"rel_l2={err:.3e} cache max rel_l2={cache_err:.3e} (tol {LM_TOL}); flash launches={launches} (sm90)")
    return launches


def plan_path(torch) -> dict:
    """Phase 9: 9a-9d over one world-size-1 NCCL mesh, destroyed at the
    end.  Returns the Hopper flash kernel's launches by plan."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa

    with tempfile.TemporaryDirectory() as tmp:
        mesh = one_device_mesh(torch, tmp)
        try:
            t0 = time.perf_counter()
            model, pre = plan_prefill(torch, fa, mesh)
            print(f"phase 9a s={time.perf_counter() - t0:.2f}")
            t0 = time.perf_counter()
            plan_decode(torch, model, mesh)
            del model
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase 9b s={time.perf_counter() - t0:.2f}")
            t0 = time.perf_counter()
            plan_train(torch, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase 9c s={time.perf_counter() - t0:.2f}")
            t0 = time.perf_counter()
            moe_launches = plan_moe(torch, fa, mesh)
            print(f"phase 9d s={time.perf_counter() - t0:.2f}")
        finally:
            dist.destroy_process_group()
    return {f"prefill_plan {LM}": pre, "prefill_plan granite-moe-1b-a400m": moe_launches}


# --------------------------------------------------------------------------
# phase 10: the dry run against the card
# --------------------------------------------------------------------------
DRY_TOL = 0.2  # the predicted peak within 20 % of the measured one
# (name, layers (0: all 32), mesh, batch, PERF.md's measured peak in GB a card, its origin)
DRY_CELLS = (("9c", PLAN_TRAIN["layers"], (1, 1), PLAN_TRAIN["batch"], None, ""),
             ("phase 8", TRAIN_LAYERS, (1, 1), TRAIN_BATCH, 48.67, "phase 8's captured step, PERF.md"),
             ("four cards", 0, (4, 1), 4, 33.65, "examples/torch_train_sharded.py --cuda (c), PERF.md"))


def dry_cfg(layers: int):
    """starcoder2-7b at its published widths, ``layers`` of them (0: all),
    remat ``full`` and ``use_pallas`` off (the configuration's defaults, as
    9c, phase 8 and the four-card run train it)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(LM)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def dry_phase() -> int:
    """Phase 10's traces, on the CPU, in the process ``main`` starts for them
    (``chip_smoke.py --phase 10-dry``): one JSON line of their records."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    out = {}
    for name, layers, mesh, batch, _, _ in DRY_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(dry_cfg(layers), ShapeConfig("train_4k", TRAIN_SEQ, batch, "train"), name,
                              mesh_shape=mesh, out=None)
        out[name] = {"flops": rec["hlo_flops"], "memory": rec["memory"], "bottleneck": rec["bottleneck"],
                     "collectives": rec["collectives"], "s": time.perf_counter() - t0, "ops": rec["ops"]}
    print(json.dumps(out), flush=True)
    return 0


def start_dry_phase():
    """Starts phase 10's traces in a process of their own (CPU only)."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--phase", "10-dry"],
                            stdout=subprocess.PIPE, text=True)


def dryrun_path(torch, proc) -> None:
    """Phase 10: the dry run's 2-layer train step against one eager call of
    the same plan on the card (module docstring)."""
    import gc
    import tempfile

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    stdout, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 10: the dry run's process exited {proc.returncode}")
    dry = json.loads(stdout.strip().splitlines()[-1])
    print(f"phase 10 dry runs (CPU, fake tensors): waited {time.perf_counter() - t0:.2f} s; trace s "
          + ", ".join(f"{k} {v['s']:.1f} ({v['ops']} ops)" for k, v in dry.items()))
    name, layers, mesh_shape, batch, _, _ = DRY_CELLS[0]
    cfg = dry_cfg(layers)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, batch, "train")
    opt_cfg = optim.AdamWConfig(state_dtype=cfg.optim_state_dtype)  # the plan's default, as the dry run's
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = one_device_mesh(torch, tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            plan = st.make_train_step(cfg, mesh, shape, opt_cfg, device="cuda")
            p, o = st.train_state(plan, build_model(cfg, seed=0, device="cuda", train=True).train_params(), opt_cfg)
            batch_t = next(sharded_batches(ds, "cuda"))
            torch.cuda.synchronize()
            with FlopCounterMode(display=False) as fc:
                _, _, met = plan.fn(p, o, batch_t)
                loss = float(met["loss"])
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated() - base
            flops = fc.get_total_flops()
            del p, o, batch_t, met, plan
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    want = dry[name]
    predicted = want["memory"]["total"]
    ratio = predicted / measured
    print(f"phase 10 {LM} {cfg.n_layers} layers, B={shape.global_batch} S={shape.seq_len}, mesh {mesh_shape}: "
          f"FLOPs dry run={want['flops']:.6e} card (FlopCounterMode, one eager call)={flops:.6e} "
          f"equal={want['flops'] == flops}; peak predicted={predicted / 1e9:.3f} GB (argument "
          f"{want['memory']['argument_size_in_bytes'] / 1e9:.3f}, temp {want['memory']['temp_size_in_bytes'] / 1e9:.3f})"
          f" measured={measured / 1e9:.3f} GB (max_memory_allocated less {base / 1e9:.3f} GB allocated before) "
          f"ratio={ratio:.4f} (tol {DRY_TOL}); loss={loss:.6f}")
    for name, layers, mesh_shape, batch, gb, origin in DRY_CELLS[1:]:
        m = dry[name]["memory"]
        print(f"phase 10 dry run {name}: {LM} {dry_cfg(layers).n_layers} layers, B={batch} S={TRAIN_SEQ}, mesh "
              f"{mesh_shape}: peak a card predicted={m['total'] / 1e9:.3f} GB (argument "
              f"{m['argument_size_in_bytes'] / 1e9:.3f}, temp {m['temp_size_in_bytes'] / 1e9:.3f}) beside measured "
              f"{gb} GB ({origin}); ratio={m['total'] / 1e9 / gb:.4f}; FLOPs a card={dry[name]['flops']:.6e}, "
              f"collectives {dry[name]['collectives']}, bottleneck {dry[name]['bottleneck']}")
    if want["flops"] != flops:
        raise AssertionError(f"phase 10: the dry run's FLOPs {want['flops']:.6e} != the card's {flops:.6e}")
    if abs(ratio - 1) > DRY_TOL:
        raise AssertionError(f"phase 10: predicted peak {predicted / 1e9:.3f} GB vs measured {measured / 1e9:.3f} GB")


# --------------------------------------------------------------------------
# C5: the allocator after phases 2-7
# --------------------------------------------------------------------------
RESERVED_SLACK = 2 << 30  # reserved may exceed allocated by at most this after the release


def segments_report(torch) -> str:
    """The allocator's segments, largest first: size, bytes in live blocks
    and each live block's size (and allocating frames where
    ``torch.cuda.memory._record_memory_history`` ran: ours only)."""
    snap = torch.cuda.memory._snapshot()
    lines = []
    for seg in sorted(snap["segments"], key=lambda s: -s["total_size"]):
        live = [b for b in seg["blocks"] if b["state"] == "active_allocated"]
        lines.append(f"segment {seg['total_size'] / 2**20:.1f} MiB pool={seg.get('segment_pool_id')} "
                     f"live={sum(b['size'] for b in live) / 2**20:.3f} MiB in {len(live)} blocks")
        for b in live[:8]:
            frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}" for f in b.get("frames", [])
                      if "repro" in f["filename"] or "chip_smoke" in f["filename"]][:4]
            lines.append(f"  block {b['size'] / 2**20:.3f} MiB: {' < '.join(frames) or 'no frames of ours'}")
    return "\n".join(lines)


# phase 11: each rank's program captured over a mesh of several cards
MULTI_CHOLESKY = ("--graph", "g4", "--n", "4096", "--levels", "4x4,8x8")
MULTI_LINE = re.compile(r"rank (\d+) (\w+): launches=(\d+) graph_replays=(\d+) .* max_err=(\S+) sha1=(\w+)")
# the train step over the cards: phase 8's shape (B = 4, S = 4096, 8 layers)
MULTI_TRAIN_LAYERS, MULTI_TRAIN_STEPS = 8, 8
MULTI_TRAIN_LINE = re.compile(r"\(c\) rank (\d+) a replay vs eager from the same state: .*'_reduce_scatter_base_': "
                              r"[1-9]")


def multi_card_run(cmd, timeout: int) -> str:
    """Run one of phase 11's jobs (its ranks are processes of its own) and
    print its output; a job that exits non-zero fails the phase."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    sys.stdout.flush()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    for line in out.stdout.splitlines():
        print(f"phase 11 | {line}")
    if out.returncode:
        raise AssertionError(f"phase 11: {' '.join(map(str, cmd[1:]))} exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    return out.stdout


def multi_card_path(torch) -> None:
    """Phase 11, on a machine with two cards or more (on one card it prints
    that it did not run): over W = min(4, cards) ranks, one process a card,
    the distributed g4 Cholesky of ``examples/torch_distributed_cholesky.py``
    (n = 4096 in (4, 4) then (8, 8); a first drain and two memo replays),
    whose every rank must run each of its lists as a graph replay
    (``graph_replays`` = ``launches``), hold the error within Cholesky's
    2e-4 and a whole result with one card's sha1; then
    ``examples/torch_train_sharded.py``'s (d) on a (1, W) mesh:
    starcoder2-7b's captured prefill and decode plans (one capture, then a
    graph replay a step on every rank) and their float32 check against one
    device within ``DECODE_TOL`` (the example fails otherwise); then its
    (c) with ``--check-capture`` on (W, 1) and (1, W): starcoder2-7b's
    train step at phase 8's shape (8 layers, B = 4, S = 4096, bf16)
    captured on every rank (compiles 1, then a graph replay a step), the
    collectives it recorded counted by operator (the backward's
    reduce-scatters among them) equal to those an eager step calls, a
    replay from the seeded state within 1e-3 relative L2 of the eager step
    (``plan.fn``) in every parameter block, the loss and the grad norm, and
    the loss finite and falling over ``MULTI_TRAIN_STEPS`` steps on the
    first batch again (the example fails otherwise)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"phase 11 needs two cards or more and this machine has {cards}: it did not run")
        return
    from repro_torch.core.executors import release_captured

    release_captured()  # the ranks' processes share card 0 with this one
    W = min(4, cards)
    example = str(ROOT / "examples" / "torch_distributed_cholesky.py")
    lines = {}
    for w in (W, 1):
        text = multi_card_run([sys.executable, example, "--cuda", "--ranks", str(w), *MULTI_CHOLESKY], 600)
        lines[w] = [m.groups() for m in map(MULTI_LINE.search, text.splitlines()) if m]
        if len(lines[w]) != 3 * w:
            raise AssertionError(f"phase 11: {len(lines[w])} rank lines from {w} ranks, want {3 * w}")
    one = {drain: sha for _, drain, *_, sha in lines[1]}
    for rank, drain, launches, replays, err, sha in lines[W]:
        if int(replays) != int(launches) or int(launches) == 0:
            raise AssertionError(f"phase 11: rank {rank} {drain}: {replays} graph replays of {launches} lists")
        if float(err) > 2e-4 or sha != one[drain]:
            raise AssertionError(f"phase 11: rank {rank} {drain}: error {err}, sha1 {sha} against one card's "
                                 f"{one[drain]}")
    print(f"phase 11 g4 cholesky over {W} cards: every rank's lists ran as graph replays, sha1 one card's")
    multi_card_run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(W),
                    str(ROOT / "examples" / "torch_train_sharded.py"), "--cuda", "--mesh", f"1,{W}", "--layers", "0",
                    "--steps", "0", "--decode", "16"], 900)
    for mesh in (f"{W},1", f"1,{W}"):  # the train step captured on every rank, against its eager step
        text = multi_card_run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                               str(W), str(ROOT / "examples" / "torch_train_sharded.py"), "--cuda", "--mesh", mesh,
                               "--layers", "0", "--train-layers", str(MULTI_TRAIN_LAYERS), "--steps",
                               str(MULTI_TRAIN_STEPS), "--check-capture"], 900)
        checked = [m.group(1) for m in map(MULTI_TRAIN_LINE.search, text.splitlines()) if m]
        if sorted(map(int, checked)) != list(range(W)):
            raise AssertionError(f"phase 11: the train step's check printed ranks {checked} of {W} on ({mesh})")
    print(f"phase 11 train step over ({W}, 1) and (1, {W}): captured on every rank, a replay within "
          f"1e-3 of the eager step, the recorded collectives the eager step's")


def release_check(torch) -> None:
    """C5: after phase 7, ``release_captured`` (every captured program and
    call, their pools, the capture streams' cuBLAS workspaces) and
    ``empty_cache``: print allocated and reserved and the segments left
    with their live blocks (also to chiprun_out/c5_segments.txt), and
    require reserved <= allocated + RESERVED_SLACK.  (The fault this found,
    a failed capture that left the allocator counting a capture underway,
    is repaired in ``captured.py`` ``_abort_capture``; phase 5's capture
    probe checks it.)"""
    import gc

    from repro_torch.core.executors import release_captured

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    release_captured()
    alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    report = segments_report(torch)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "c5_segments.txt").write_text(report + "\n")
    free, total = torch.cuda.mem_get_info()
    print(f"C5 after phase 7 and release_captured: {alloc / 1e9:.3f} GB allocated, {reserved / 1e9:.3f} GB reserved "
          f"(before the release {before / 1e9:.3f} GB), {(total - free) / 1e9:.2f} GB of {total / 1e9:.2f} GB in "
          f"use on the card; segments (largest first):\n" + "\n".join(report.splitlines()[:24]))
    if reserved > alloc + RESERVED_SLACK:
        raise AssertionError(f"C5: {reserved / 1e9:.2f} GB reserved for {alloc / 1e9:.2f} GB allocated")


def train_phase() -> int:
    """Phase 8 alone, in the process ``main`` starts for it
    (``chip_smoke.py --phase 8``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    train_path(torch)
    print(f"phase 8 s={time.perf_counter() - t0:.2f}")
    return 0


def main() -> int:
    import torch

    if sys.argv[1:] == ["--phase", "8"]:
        return train_phase()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--phase", "10-dry"]:
        return dry_phase()
    dry = start_dry_phase()  # phase 10's traces, on the CPU, beside phases 8 and 1-9
    try:
        return main_phases(torch, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()


def main_phases(torch, dry) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl

    if set(KERNELS) != set(tl.LAUNCHES):
        raise AssertionError(f"chip_smoke checks {KERNELS}, the port has {sorted(tl.LAUNCHES)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    # phase 8 first, in a process of its own, before this one touches the
    # card: its 50 GB peak needs the whole card, and after phases 2-7 this
    # process's allocator is fragmented and holds memory its captured
    # programs keep (numbered 8: it was added after them).  Its temporary
    # files (8a's checkpoints, 26 GB each) go under a directory of this
    # process's, removed even if the child is killed
    import shutil
    import tempfile

    t0 = time.perf_counter()
    sys.stdout.flush()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase8_")
    try:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase", "8"], check=True, timeout=900,
                       env=dict(os.environ, TMPDIR=tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 8 process s={time.perf_counter() - t0:.2f}", flush=True)
    t0 = time.perf_counter()
    sources = ["tile_lu_sm90", "flash_attention", "flash_attention_sm90", "matmul"]
    reports = _build.build(sources)
    print(f"kernel build s={time.perf_counter() - t0:.2f} (built: {sorted(reports) or 'cached'})")
    for name in sources:  # every library's compiler report, a cached one's too
        log = (_build._target(name).parent / "build.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "setmaxnreg" in line:
                print("  ptxas:", line.strip())
            if name != "flash_attention" and ("setmaxnreg" in line or re.search(r"[1-9]\d* bytes spill", line)):
                raise AssertionError(f"{name}: {line.strip()}")

    rng = np.random.default_rng(0)
    errs = kernel_checks(torch, tl, rng)
    tensor_core_accuracy(torch, tl, rng)
    stacked_errs = stacked_checks(torch, tl, rng)
    times = kernel_timings(torch, tl)
    times.update(multiseg_timings(torch, tl, rng))
    stacked_times = stacked_timings(torch, tl, rng)
    times.update(stacked_multiseg_timings(torch, tl, rng))
    launches = main_path(torch, tl)
    for k, v in lu_main_path(torch, tl).items():
        launches[k] += v
    g4_launches = distributed_path(torch, tl)
    stacked_launches = serving_path(torch, tl)
    capture_probe(torch)
    lm_kernels = lm_path(torch, tl, rng)
    t0 = time.perf_counter()
    flash_paths = nondense_path(torch)
    print(f"phase 7 s={time.perf_counter() - t0:.2f}")
    release_check(torch)
    t0 = time.perf_counter()
    plan_paths = plan_path(torch)
    print(f"phase 9 s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    dryrun_path(torch, dry)
    print(f"phase 10 s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    multi_card_path(torch)
    print(f"phase 11 s={time.perf_counter() - t0:.2f}")
    sm90 = lm_kernels[0]
    sm90["paths"] = {LM: sm90["launches"], **flash_paths, **plan_paths}
    sm90["launches"] = sum(sm90["paths"].values())

    kernels = []
    for name in KERNELS:
        t = times[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} was launched no time on its main path")
        if g4_launches[name] == 0:
            raise AssertionError(f"{name} was launched no time on the g4 path")
        entry = {
            "name": name, "route": "cuda", "source": f"{CSRC}/{tl.LIBRARY[name]}.cu", "library": tl.LIBRARY[name],
            "replaces": REPLACES[name], "launches": launches[name] + g4_launches[name],
            "paths": {"g2p": launches[name], "g4": g4_launches[name]}, "max_abs_err": max(errs[name], t["err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "tasks": t["tasks"], "ctas": t["ctas"],
            "arith": t["arith"],
        }
        if name in SOLVE_GROUPS:  # the solves' groups (2b): where a kernel spends its launches
            entry["groups"] = {k: times[k] for k in SOLVE_GROUPS[name]}
            entry["max_abs_err"] = max(entry["max_abs_err"], *(g["err"] for g in entry["groups"].values()))
        kernels.append(entry)
    for name in KERNELS:
        t = stacked_times[name]
        if stacked_launches[name] == 0:
            raise AssertionError(f"{name}_stacked was launched no time on the serving path")
        kernels.append({
            "name": f"{name}_stacked", "route": "cuda", "source": f"{CSRC}/{tl.LIBRARY[name]}.cu",
            "library": tl.LIBRARY[name], "replaces": STACKED_REPLACES,
            "launches": stacked_launches[name], "max_abs_err": max(stacked_errs[name], t["err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "tasks": t["tasks"], "lanes": LANES, "ctas": t["ctas"],
            "arith": t["arith"], "unstacked_launches_ms": t["unstacked_ms"],
        })
    for key, (name, stacked) in MULTISEG.items():  # B5: the groups of several segments
        t = times[key]
        paths = ({"g2p stacked": SEGMENTED_BY_GRAPH.get("g2p stacked", {}).get(name, 0)} if stacked else
                 {g: SEGMENTED_BY_GRAPH.get(g, {}).get(name, 0) for g in ("g2p", "g4")})
        if not all(paths.values()):
            raise AssertionError(f"{key} was launched no time on a path: {paths}")
        kernels.append({
            "name": key, "route": "cuda", "source": f"{CSRC}/{tl.LIBRARY[name]}.cu", "library": tl.LIBRARY[name],
            "replaces": MULTISEG_REPLACES, "launches": sum(paths.values()), "paths": paths,
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": f"none; the gather form (gather, batched_{name}, scatter) in its place",
            "tasks": t["tasks"], "segments": t["segments"], "lanes": t["lanes"],
            "ctas": t["ctas"], "arith": t["arith"],
        })
    for entry in lm_kernels:
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was launched no time on its path")
    kernels += lm_kernels
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
