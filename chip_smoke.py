"""Smoke run of pyrenderer_tpu_torch on one NVIDIA GPU: build, check, render, time.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. Environment: requires a CUDA device; prints the card's name and power
   limit (nvidia-smi), the torch and CUDA versions.
1. Build: compiles csrc/*.cu with nvcc for sm_90a (kernels/build.py, one
   nvcc per source, in parallel) and prints the build time and ptxas's
   register/shared-memory report.
2. Each whole-table kernel against its plain PyTorch twin on the card, bit
   for bit on every ray (hit, t's bits, face, occlusion), at the Cornell
   path's shapes (65,536 rays against the 36 triangles): random rays, real
   camera rays, rays with dead lanes (t1 = 0), and a ragged N = 100, with
   scalar and per-ray t1; then 65,536 random rays against the spheres
   table (3,852 triangles), exact duplicate triangles where a lane split
   or a tile would separate them, and each table's launch edges (N = 1,
   31, 33, 129, all rays dead, every third dead, t1 = 0, below t0, NaN,
   negative or inf; perf/clusterbench.py whole_sets).
3. The Cornell path through the CLI entry point: reference estimator,
   1024x1024, 4 bounces, 16 spp on cuda:0. Checks the PNG and EXR, a finite
   HDR, exactly 16 passes x 16 chunks x 4 bounces launches of each
   whole-table kernel, and no call of a plain twin.
4. GPU against CPU: render_image at 64x64 (2 spp, 4 bounces, seed 3) on the
   card and with the CPU twins; then the mean radiance at 160x160
   (32 spp, 8 bounces, seed 1) against the JAX package's CPU value.
5. Timings: each whole-table kernel and its twin on the card (medians of
   CUDA-event timings, in turns; every kernel time in this script is the
   replay of a CUDA graph of 20 calls, the device's time without the
   host's launch cost; perf/kernelbench.graph_ms and cuda_ms) on phase 2's
   dead-lane set (the kernel line's time), then the closest hit on
   Cornell's own bounce-1 wavefront and the any hit on its shadow rays
   (the pbrt frame's, as phase 14 takes them), and the phase-3 frame in
   Mrays/s, counted as bench.py counts.
6. Each cluster-sweep kernel against its twin on the card, at the
   terrain100k tables (100,364 triangles, 785 clusters padded to 800):
   65,536 random rays, camera rays, the integrator's real bounce-1
   wavefront and its NEE shadow rays, dead lanes, per-ray t1 and a ragged
   N = 100, each with Moeller-Trumbore and watertight leaves, sort off and
   on: equal hit masks and occlusion, and the closest hit's t and face
   equal to the twin's on every ray; then the shared-edge leak hunt (4,096
   rays) through the watertight kernels.
7. The large-scene path through ProgressiveRenderer: terrain100k,
   reference estimator, 512x512, 4 spp, 4 bounces, chunks of 2^16,
   cluster_sort and cluster_watertight on "auto" (both resolve to on).
   Checks a finite HDR, exactly 4 passes x 4 chunks x 4 bounces launches of
   each cluster kernel, no twin call and no whole-table launch; prints
   Mrays/s.
8. GPU against references: the terrain8k image (32x32, 2 spp) on the card
   and with the CPU twins, with MT and with watertight leaves; the
   terrain100k mean radiance (32x32, 2 spp, 4 bounces, seed 0) against the
   JAX package's CPU value.
9. Timings on the bounce-1 wavefront at terrain100k (the closest hit) and
   its shadow rays (the any hit), watertight: each cluster kernel alone
   (one launch on operands prepared beforehand, kernels/cluster.py
   _operands and _launch), sorted and unsorted, and its wrapper with the
   sort, rank and scatter glue, sorted and unsorted, beside its twin; the
   kernel line's time is the kernel alone on sorted operands, as the frame
   runs it. Their bounds from the tests the kernels' front-to-back walk
   needs at the least (perf/clusterbench.walk), the any-hit walk's
   occlusion checked against the twin's.
10. The four binned kernels against their twins on the card at terrain100k
   (200 bins of 512 triangles, 224 box rows), on phase 6's ray sets, with
   W at its default and at 1 (overflow and peel rounds), MT and watertight
   leaves: prepass and peel bit for bit, each leaf's per-pair (t, slot) key
   bit for bit, also on the leaves' launch edges (one pair, 33 pairs, a bin
   of more than 128, a last piece of one pair, all SENTINEL, dead rays) and
   on exact duplicate triangles in one bin (the lower slot must win; both
   from perf/clusterbench.py); the prepass (with and without the words)
   and every peel round after it, until no ray has a bit left, bit for bit
   on their launch edges (clusterbench.prepass_edges: all rays dead, every
   third dead, t1 exactly t0, one float below it, NaN, inf, negative; N =
   1, 31, 33, 129) at W = 6 and 1, the peel on edge words (bit 31, full
   words; clusterbench.edge_words) at W = 1, 6, 10, and terrain330k's table
   (672 box rows, more than one staging pass) at W = 6, 1 and 10; then the
   public binned closest_hit / occluded, resident and streamed, against
   phase 6's sweep-twin results (equal hit masks and occlusion, faces >=
   0.999); the leak hunt through the binned watertight path.
11. The binned path through ProgressiveRenderer: phase 7's frame with
   backend "cluster_binned" and with "cluster_streamed". Checks a finite
   HDR, at least 4 passes x 4 chunks x 4 bounces x 2 queries launches of
   the prepass and of the path's leaf kernel, at least one launch of its
   overflow stage (the sweep, or the peel), no twin call and no
   whole-table launch, and the HDR against phase 7's "cluster" frame (close
   > 0.999 at rtol 1e-3, median |diff| 0); prints the three frames' Mrays/s.
   Then one CLI render with --backend cluster_binned (Cornell, 64x64).
12. Timings on the bounce-1 wavefront: each binned kernel alone and its
   twin, with its bound and ptxas's registers and spill; the prepass also
   at W = 10 with the words and the peel on the words it leaves (the
   streamed path's calls), and the prepass on the shadow rays; the binned
   wrappers (glue included) against the sweep's.
13. The four probe kernels of perf/kernelbench.py (csrc/kernelbench.cu:
   leaf, extract, cond, ctz) against their twins, bit for bit (+0 and -0
   told apart), on every parameter of the harness's lists at its shape
   (256 tiles of 128 rays), at N = 128, 384 and 38,400, at 256 rays in
   rows 4 bytes past a 16-byte boundary, and on the edge sets of
   perf/clusterbench.py probe_edges (ties in t, det == 0, zero
   directions, origins on a vertex) at L and N of 0, 1, 7 and 9; on every
   one of these sets the extract also at K of 0, 1, 7 and 9 and the ctz at
   words 0, 0x80000000 and 0x80000001 (clusterbench probe_params); each
   timed at the harness's shape beside its twin, both replayed from CUDA
   graphs, with its bound, its ptxas line and its floor at the card's
   maximum SM clock: for the leaf, cond and ctz the issue floor (the SASS
   instructions a test of its loop, clusterbench sass_loops), for the
   extract the latency floor (K x the cycles of one round's dependent
   chain, read off the round's SASS, clusterbench round_cycles, with each
   instruction's latency measured on the card by perf/latency.cu); the
   phase fails if the SASS cannot be read, a probe's loop is not found,
   the extract's round adds acc to fewer than 16 values a lane, or the
   latencies cannot be measured.
14. The pbrt path: the CLI with its default estimator (pbrt), Cornell,
   1024x1024, 4 bounces, 16 spp, with exactly 16 x 16 x 4 launches of each
   whole-table kernel and no twin call; GPU against CPU images at 64x64
   (2 spp) for the Cornell box with a metal tall box and a glass short box
   and for scenes/spheres.json; the whole-table kernels against their
   twins at T = 3,852 (spheres) on its bounce-1 wavefront and shadow rays,
   bit for bit, and timed there (the closest hit on the wavefront, the any
   hit on the shadow rays, each with its bound and ptxas's registers); the
   Cornell pbrt mean radiance at 160x160 (32 spp, 8 bounces, seed 1)
   against the JAX package's CPU value.
15. The entry points: ``python -m pyrenderer_tpu_torch.bench`` as a
   subprocess for cornell (reference, pbrt), spheres (pbrt) and
   terrain100k (reference), each JSON line checked (metric, finite value,
   calib_ns_per_leaf, the card's name, and the launches it reports: exactly
   spp x chunks x 4 bounces of each query's kernel, whole-table or
   cluster, and the calibration's leaf-probe launches, no other kernel and
   no twin call); then the microbenchmark harness (``perf/kernelbench.py``,
   all seven benchmarks) in this process, with exactly 1 + 2 x 20 launches
   of each probe per parameter (graph_ms counts replays) and no twin call.
   One more bench row, terrain100k with BENCH_ROUNDS=2, holds the
   suspend/resume launches: two closest-hit launches per query, one of
   each pass.
16. The closest-hit kernel's resume mode (suspend/resume rounds) against
   its twin accel/clusters.closest_hit_resume_ref on phase 6's ray sets,
   budgets 1, 2 and 8, MT and watertight, sort off and on: pass 1's t,
   slot and done bit for bit (some rays suspended at budget 1), the resume
   pass after budget 1 bit for bit, and closest_hit with rounds=2 equal to
   the one-pass kernel's t and face on every ray.
17. The slice's path: phase 7's frame with cluster_rounds=2 and
   cluster_budget=8, bit-identical to phase 7's HDR, with exactly 128
   closest-hit launches (64 of each pass) and 64 any-hit launches; then a
   rounds=1 frame, so that both frames' Mrays/s come from this call.
18. Timings of the resume mode alone (kernels/cluster.py _operands and
   _launch) on the bounce-1 wavefront, sorted: pass 1 at budget 8 and the
   resume pass on pass 1's compacted rays, beside the twin; their bounds
   from perf/clusterbench.walk (pass 1 stopping after 8 superclusters, the
   resume pass over the suspended rays).
19. The chunked sweep: terrain330k (329,684 triangles, 3 chunks of at most
   CHUNK_MAX_TRIS; the scene and its ClusterScene built in phase 10)
   through "cluster_chunked" and the monolithic "cluster":
   equal hit masks and occlusion on 65,536 random rays, faces equal except
   exact ties; the 512x512 2-spp frames (3 launches of each kernel per
   query against 1), > 99.9% of pixels close with a median |diff| of 0,
   and their Mrays/s.
20. The BVH (plain PyTorch, no kernel): the native SAH builder must load on
   this machine; terrain8k 32x32 2 spp through backend "bvh" on the card
   and on the CPU (> 95% close, median |diff| < 1e-5), and its Mrays/s.
21. The wavefront sort (PYRENDERER_WF_SORT=1): the terrain100k frame with
   both estimators, each within rtol 1e-5 of the same frame with the
   per-query sort, with the launches of phase 7, and all four Mrays/s.

22. Gradients on the card: the sum of dist/render.render_field over every
   pixel, differentiated by torch autograd w.r.t. vertices, albedo and
   emission in float32: (a) Cornell, reference, 256x256, 4 spp, 4 bounces,
   backend "cuda" (B1/B2); (b) Cornell, pbrt, 6 bounces (Russian roulette
   from bounce 4), the reddest albedo grey as the example sets it; (c)
   terrain8k (8,204 triangles), pbrt, 64x64, 2 spp, 4 bounces, backend
   "cluster" (B3/B4). Each forward and backward is a counting window with
   exactly spp x bounces launches of each kernel (one chunk), none in the
   backward. Every gradient finite, the albedo's non-zero; (a) and (b)
   against the same loss with backend "brute" on the card: images equal
   bit for bit (the same hit decisions) and each gradient within relative
   L2 1e-5; (c) against the CPU twins: at least 99.9% of the pixels'
   radiance agrees (rtol 1e-4) and the albedo and emission gradients of
   the whole loss are within relative L2 1e-3; printed beside them, the
   same over the agreeing pixels only and the vertex entries' share
   within rtol 1e-3 there.
23. Training: examples/invrender.recover at its defaults (48x48, 4 spp,
   3 bounces, 80 steps, albedo lr 30) on the card as one counting window
   (81 fields x 12 launches of each whole-table kernel): the loss falls at
   least 10x, the albedo's max error is below 0.05, vertices and emission
   come back bit-identical; then one train_step at Cornell 1024x1024 (16
   chunks of 2^16, 1 spp, 4 bounces, reference, all three parameters
   trained; 64 launches of each kernel): its wall, the same step split
   into each chunk's forward and backward (synchronised), the device's
   idle share (torch.profiler's busy union against the unprofiled step;
   the phase fails if the profiler sees no device event) and the peak
   memory (torch.cuda.max_memory_allocated, with what the
   step added to the memory allocated before it).
24. Adaptive sampling through the CLI: a copy of cornell_box.json with
   renderer.adaptive_sampling, reference, 1024x1024, 4 bounces, spp 16,
   the default minimum of 8 and tolerance of 0.02, backend "cuda": exactly
   4 x (8 x 16 + the sum over the sweeps of ceil(k_i / 2^16)) launches of
   each whole-table kernel (each sweep's k_i printed), the film's spp_map
   in [8, 16], every pixel at err <= tol or at the cap; the wall and
   Mrays/s. Then at 64x64, 3 bounces, spp 12, minimum 4, tolerance 0.05
   (where a share of the pixels converges: spp_map not constant, >= 5%
   below the cap), the card's spp_map against the CPU twins' (equal on >=
   98% of the pixels).
25. run_resilient at 1024x1024, 4 spp, reference, 4 bounces: a chunk of
   pass 1 raises, pass 3 comes back with a NaN (both injected by wrapping
   render/driver._render_pass); the film ends bit-identical to an
   uninterrupted run's with the same rays_traced, and 4 launches of each
   kernel per chunk that rendered; a render that always fails re-raises
   after max_retries; then the CLI's --live --resilient at 256x256, 2 spp,
   on a non-tty stream: the ANSI frame appears and the exit code is 0.
26. The tonemap mode on the card: phase 3's frame written as an EXR, then
   cli.main(["tonemap", "--input", exr, "--tonemap", "filmic", "--out",
   png]); the PNG equals the CPU tonemap of read_exr to 1 LSB.
27. The matmul backend under torch.set_float32_matmul_precision("high")
   (restored after): the CLI's Cornell 1024x1024 16-spp 4-bounce frame
   with --backend matmul launches no kernel. Phase 3's "cuda" frame
   rendered again (a counting window) with every closest-hit and any-hit
   query also asked of intersect_matmul / occluded_matmul: hit masks
   flipped on < 1e-5 of the live rays, face materials on < 1e-4, occlusion
   on < 1e-3 of the shadow rays; the same product unguarded (TF32) must
   fail that gate. Against phase 3's frame, > 99% of the values close at
   rtol 1e-3 (atol 1e-6) and the mean within 1e-3 relative; on phase 2's
   65,536 random rays intersect_matmul
   against closest_hit: hit masks and faces equal on > 99.5%, t within
   rtol 2e-4 where the faces agree (tests/test_intersect.py's bounds),
   bit for bit the result under "highest"; printed beside them, the same
   product unguarded (TF32).
28. The analytic tracer (analytic.py, plain PyTorch, no kernel): the CLI's
   analytic mode at its defaults (400x400, 25 spp, depth 10, 160,000 rays
   a wavefront) writing the PNG and the .npy HDR, a counting window with
   no launch: a finite HDR, the left wall red and the right wall green,
   its wall time; the same frame under set_float32_matmul_precision("high")
   bit-identical to it (the TF32 guard; the precision restored after); one
   sample of it timed, then profiled (device kernels, busy, idle share); at
   64x64, 25 spp, depth 10, seed 0 the card's frame against the port's CPU
   frame (>= 99% of the values close at rtol 1e-3, atol 1e-6) and its mean
   against the JAX package's CPU mean (5e-3 relative).
29. The debug path records (debug/logger.py): the CLI's --debug-paths on
   Cornell (49 rays at the scene's 1024x1024 and 16 bounces) with exactly
   16 launches of each whole-table kernel and no twin call, the HTML's
   embedded JSON (49 paths, the wireframe) and the PLY's header; log_paths
   over every pixel of phase 3's 1024x1024 frame (reference, 4 bounces,
   seed 0) with exactly 4 launches of each kernel, its last-bounce radiance
   bit-identical to trace_reference on the same rays; on a 64x64 grid its
   records against the CPU twins' (hit and tri equal on >= 99.9%); and
   log_paths(backend="cluster") on terrain8k with cluster_sort=True, with
   PYRENDERER_WF_SORT=1 and =0: 4 launches of each cluster kernel in each
   run and every record equal.
30. The golden HDR check: Cornell, pbrt, 64x64, 32 spp, 8 bounces, seed 1
   through B1/B2 (exactly 256 launches of each) against the Tungsten
   renderer's EXR (tests/data/tungsten_gt_256.exr read by utils/exr.py,
   box-downsampled to 64x64): whole-image mean within 3%, each channel's
   within 5%, the 8x8 blocks' mean relative error below 8%
   (tests/test_torch_golden.py's bounds).
31. Distribution, a world of one NCCL rank (dist/multihost.initialize with
   one process): render_field_sharded on a (dp, sp) = (1, 1) mesh at
   Cornell 256x256, 4 spp, 4 bounces, reference, bit-identical to
   render_field with exactly 16 launches of each whole-table kernel; then
   train_step(mesh=...): its loss bit-identical to train_step()'s, its
   steps within 1e-4 of the largest (the backward's scatters add with
   atomics in no fixed order; the spread of two train_step() calls is
   printed beside it).
32. The dp x sp path at full width: phase 3's frame (Cornell 1024x1024,
   reference, 4 bounces, 16 spp) by four `python -m
   pyrenderer_tpu_torch.dist.worker` ranks on the card over gloo (NCCL
   takes one rank per GPU), dp = 2, sp = 2: the assembled image within
   rtol 2e-5, atol 1e-6 of phase 3's HDR, every rank on the card with
   exactly 512 launches of each whole-table kernel over its two frames
   (warm-up and timed) and no twin call; its time per frame and Mrays/s.
   Then two ranks (dp = 2) at 1024x1024, 1 spp, --train-steps 1 beside a
   one-process worker (a world of one NCCL rank): losses and the mean
   absolute gradients equal at rtol 1e-5.
33. The gp path (dist/geometry.py), two ranks that chip_smoke starts
   (gp_rank) on the card over gloo: Cornell 256x256, 4 spp, 4 bounces
   through B1/B2 on each rank's 18-triangle shard (exactly 16 launches
   each) against render_field at rtol 2e-5, atol 2e-6; then phase 7's
   frame (terrain100k, 512x512, 4 spp, 4 bounces) at gp = 2, each rank
   holding its own ClusterScene of 50,182 triangles and launching B3/B4
   (exactly 64 each): > 99% of the values close to phase 7's HDR at rtol
   1e-3, atol 1e-4 and the means within 1e-3 relative; its wall and phase
   7's rays over it in Mrays/s. A rank that fails or outlives its timeout
   fails the phase, and the survivors are killed.
34. The stage-breakdown harnesses (pyrenderer_tpu_torch/perf/, the JAX
   package's perf/ counterparts), each through its main() at its own width
   with --reps 2 and --no-profile (in this long-lived process
   torch.profiler drops device records: perf/harness.py), each run one
   counting window: estbench (Cornell, 262,144 rays,
   both estimators), microbench and ablate (2^20 rays), glue2 (262,144
   rays, fetch tables of 8,204 and 100,364 rows, terrain res 64) and
   binnedglue (terrain100k). Every row has a finite, positive eager ms; the
   launches of one call are exact (4 of each of B1 and B2 in a trace, one
   of each in kernel_pair, one B3 in wrap_full and wrap_bare, one of each
   binned kernel in its row, the streamed core's as its rounds through the
   twins count them, none where a stage has no kernel) and no twin runs;
   each stage's output on the card is held against the same stage on the
   CPU (the twins) at 2,048-8,192 rays: bit for bit where the stage is
   integer, a gather, a kernel or a Threefry draw, at rtol 1e-4 / atol 1e-6
   for shading arithmetic, and by the GPU-against-CPU criterion of phase 4
   for traces. Then binnedgran: one child process each at PYRENDERER_BIN =
   4, 1 and 2 (180 s each at most), each with a row, the launches of one
   prepass and one leaf a core, and hit agreement 1.0 with the sweep's twin
   on 4,096 rays; each child reports its launches, which count as a
   counting window. Prints the phase's seconds.

Every main-path run above (the frames of phases 3, 7, 11, 14, 17-21,
24-25, 27 and 30-33, the CLI runs, the bench rows, the harness, the gradient and
training runs of phases 22-23, the path records of phase 29 and the
harnesses of phase 34) is a counting window: every
wrapper's counts are zeroed just before it and read just after (in the
ranks of phases 32-33 by each rank, and in binnedgran's children in phase
34 by each child, which reports them). The line
before the last is a JSON object with one entry per kernel: its launches
summed over those windows, its largest difference from the twin, its time
and the twin's, and its bound (the larger of its fp32 operations over the
card's 67 TFLOP/s and its bytes, each input read once and each output
written once, over 3.35 TB/s), counted from this run's inputs; the last
line is {"ok": true, "device": {...}}. No result is printed when a phase
fails or when no CUDA device is present.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "cornell_box.json")
N_RAYS = 1 << 16
T0 = 1e-5
T_MAX = 99999.9

# Mean radiance of the Cornell box at 160x160, 32 spp, 8 bounces, seed 1,
# "reference" estimator, float32: pyrenderer_tpu.core.integrator.render_image
# on the CPU (JAX 0.9.0).
JAX_MEAN_RADIANCE_160 = 0.10746552795171738
MEAN_TOL = 1e-3

# Mean radiance of the terrain100k scene (scene/procgen.py
# big_scene_data("terrain", res=224)) at 32x32, 2 spp, 4 bounces, seed 0,
# "reference" estimator, float32, watertight leaves (cluster_watertight
# "auto"): pyrenderer_tpu.core.integrator.render_image(..., backend="cluster")
# on the CPU (JAX 0.9.0), i.e.
#   scene, camera, _ = build_scene(big_scene_data("terrain", res=224))
#   render_image(jax.tree.map(jnp.asarray, scene),
#                camera._replace(resolution=(32, 32)),
#                RenderConfig(max_bounces=4, spp=2, seed=0,
#                             estimator="reference"), backend="cluster").mean()
JAX_MEAN_RADIANCE_TERRAIN100K = 0.044580455869436264

# Mean radiance of the Cornell box at 160x160, 32 spp, 8 bounces, seed 1,
# "pbrt" estimator (russian_roulette_start 4), float32:
# pyrenderer_tpu.core.integrator.render_image on the CPU (JAX 0.9.0), i.e.
#   scene, camera, _ = load_tungsten("scenes/cornell_box.json")
#   render_image(jax.tree.map(jnp.asarray, scene),
#                camera._replace(resolution=(160, 160)),
#                RenderConfig(max_bounces=8, spp=32, seed=1,
#                             estimator="pbrt")).mean()
JAX_MEAN_RADIANCE_160_PBRT = 0.11940412223339081

# Mean radiance of the analytic scene at 64x64, 25 spp, depth 10, seed 0,
# float32: pyrenderer_tpu.analytic.render on the CPU (JAX 0.9.0), i.e.
#   float(np.asarray(analytic.render(res=(64, 64), spp=25, seed=0,
#                                    max_depth=10)).mean())
# Seeds 1-3 give 0.008376, 0.008206 and 0.008127: seed-to-seed noise is 1-2%.
JAX_MEAN_RADIANCE_ANALYTIC_64 = 0.008213918656110764
ANALYTIC_MEAN_TOL = 5e-3

# The bound of each kernel: the larger of its fp32 operations over the
# card's peak and its bytes over the memory rate (NVIDIA's H100 SXM data
# sheet: fp32 outside the tensor cores, HBM3; the rates assume 700 W).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per test, counted in the CUDA sources (each add,
# multiply, compare, min, max, abs and select one operation, an IEEE
# division one): a watertight test without its rare compensated fallback
# and a slab test (perf/clusterbench.py counts the Moeller-Trumbore test,
# MT_OPS, and the probes' products, COND_OPS).
WT_OPS = 75
SLAB_OPS = 26

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "closest_hit": ("pyrenderer_tpu_torch/csrc/intersect.cu",
                    "pyrenderer_tpu/kernels/pallas_intersect.py:80"),
    "occluded": ("pyrenderer_tpu_torch/csrc/intersect.cu",
                 "pyrenderer_tpu/kernels/pallas_intersect.py:111"),
    "cluster_closest_hit": ("pyrenderer_tpu_torch/csrc/cluster.cu",
                            "pyrenderer_tpu/kernels/pallas_cluster.py:449"),
    "cluster_occluded": ("pyrenderer_tpu_torch/csrc/cluster.cu",
                         "pyrenderer_tpu/kernels/pallas_cluster.py:577"),
    # the closest-hit kernel's resume mode (resume=True there): pass 1 of
    # suspend/resume rounds, with a budget, and the passes that resume
    "cluster_closest_suspend": ("pyrenderer_tpu_torch/csrc/cluster.cu",
                                "pyrenderer_tpu/kernels/pallas_cluster.py:449"),
    "cluster_closest_resume": ("pyrenderer_tpu_torch/csrc/cluster.cu",
                               "pyrenderer_tpu/kernels/pallas_cluster.py:449"),
    "binned_prepass": ("pyrenderer_tpu_torch/csrc/binned.cu",
                       "pyrenderer_tpu/kernels/pallas_binned.py:167"),
    "binned_peel": ("pyrenderer_tpu_torch/csrc/binned.cu",
                    "pyrenderer_tpu/kernels/pallas_binned.py:216"),
    "binned_leaf": ("pyrenderer_tpu_torch/csrc/binned.cu",
                    "pyrenderer_tpu/kernels/pallas_binned.py:236"),
    "binned_leaf_streamed": ("pyrenderer_tpu_torch/csrc/binned.cu",
                             "pyrenderer_tpu/kernels/pallas_binned.py:439"),
    "kb_leaf": ("pyrenderer_tpu_torch/csrc/kernelbench.cu", "perf/kernelbench.py:70"),
    "kb_extract": ("pyrenderer_tpu_torch/csrc/kernelbench.cu", "perf/kernelbench.py:129"),
    "kb_cond": ("pyrenderer_tpu_torch/csrc/kernelbench.cu", "perf/kernelbench.py:162"),
    "kb_ctz": ("pyrenderer_tpu_torch/csrc/kernelbench.cu", "perf/kernelbench.py:206"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# launches of each kernel, summed over the counting windows of the main paths
TALLY = collections.Counter()


def counted(fn, label, expect=None):
    """fn() as one counting window of a main path: every kernel wrapper's
    counts zeroed just before it and read just after. Checks that no twin
    ran (and, given `expect`, exactly those launches), adds the launches to
    TALLY; returns (fn()'s result, the launches)."""
    from pyrenderer_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    launches, twins = kernels.counts()
    print(f"{label}: launches {launches}, twin calls {twins}", flush=True)
    check(not twins, f"{label}: twin calls {twins}")
    if expect is not None:
        check(launches == expect, f"{label}: launches {launches}, expected {expect}")
    TALLY.update(launches)
    return out, launches


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(ops, nbytes):
    """(bound ms, "operations" or "bytes"): the least time of `ops` fp32
    operations and `nbytes` bytes of device memory traffic on the card."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def cuda_ms_pair(kernel_fn, twin_fn, reps=20, twin_reps=3, twin_graph=False):
    """(kernel ms, twin ms): medians of CUDA-event timings, in turns twin,
    kernel, kernel, twin so that drift of the card shows in neither alone.
    The kernel side replays `reps` calls from a CUDA graph
    (perf/kernelbench.graph_ms: the device's time, without the host's
    launch cost, which is as long as many of these kernels); the twin runs
    eagerly, `twin_reps` calls (perf/kernelbench.cuda_ms), unless
    twin_graph (then as the kernel)."""
    from pyrenderer_tpu_torch.perf.kernelbench import cuda_ms, graph_ms

    def twin():
        if twin_graph:
            return graph_ms(twin_fn, reps)
        return cuda_ms(twin_fn, reps=twin_reps, warmup=1)

    twin_a = twin()
    kern_a = graph_ms(kernel_fn, reps)
    kern_b = graph_ms(kernel_fn, reps)
    twin_b = twin()
    return float(np.median([kern_a, kern_b])), float(np.median([twin_a, twin_b]))


def compare_kernels(ki, table, ro, rd, t1, label):
    """Kernel against twin on the card, bit for bit on every ray: hit, t's
    bits, face and occlusion. Returns the max absolute differences
    (closest-hit t, occluded flag) over all rays: 0 when it passes."""
    hit, t, tri = ki.closest_hit(table, ro, rd, T0, t1)
    occ = ki.occluded(table, ro, rd, T0, t1)
    torch.cuda.synchronize()
    hit_r, t_r, tri_r = ki.closest_hit_ref(table, ro, rd, T0, t1)
    occ_r = ki.occluded_ref(table, ro, rd, T0, t1)
    check(torch.equal(hit, hit_r), f"{label}: hit masks differ on {int((hit != hit_r).sum())}")
    check(bool((tri[~hit] == -1).all()) and bool((t[~hit] == 0).all()),
          f"{label}: miss contract (tri=-1, t=0) broken")
    check(torch.equal(tri, tri_r), f"{label}: faces differ on {int((tri != tri_r).sum())} rays")
    t_bits, t_bits_r = t.view(torch.int32), t_r.view(torch.int32)
    check(torch.equal(t_bits, t_bits_r),
          f"{label}: t's bits differ on {int((t_bits != t_bits_r).sum())} rays")
    check(torch.equal(occ, occ_r), f"{label}: occluded differs on {int((occ != occ_r).sum())}")
    err_t = float((t - t_r).abs().max()) if t.numel() else 0.0
    err_occ = float((occ.float() - occ_r.float()).abs().max()) if occ.numel() else 0.0
    print(f"{label}: n={ro.shape[0]} T={table.shape[1]} hits={int(hit.sum())}, (hit, t bits, "
          f"face) equal on every ray; occluded={int(occ.sum())} (equal)", flush=True)
    return np.array([err_t, err_occ])


def main() -> int:
    phase("0 environment")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda:0")

    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.perf.clusterbench import (random_rays, whole_bounds, whole_scenes,
                                                        whole_sets, whole_wavefronts)

    phase("1 build")
    t = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    print(build.build_log().strip(), flush=True)

    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import render_image
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device
    from pyrenderer_tpu_torch.utils.exr import read_exr

    host_scene, host_camera, _ = load_tungsten(SCENE)
    scene, camera = to_device(host_scene, host_camera, dev)
    table = ki.pack_triangles(scene.vertices, scene.faces)
    n_tris = table.shape[1]

    phase(f"2 kernels against twins on the card, bit for bit ({N_RAYS} rays x {n_tris} "
          "triangles; the spheres table; duplicates; launch edges)")
    whole = whole_scenes(dev)
    check(torch.equal(whole["cornell"][2], table), "whole_scenes' Cornell table differs")
    err = np.zeros(2)
    for label, (tab, r_o, r_d, t1) in whole_sets(dev, whole).items():
        err = np.maximum(err, compare_kernels(ki, tab, r_o, r_d, t1, label))
    ro, rd = random_rays(N_RAYS, 0, dev)
    lanes = torch.arange(N_RAYS, device=dev)
    t1_dead = torch.where(lanes % 3 == 0, 0.0, T_MAX).float().contiguous()
    hit_dead, _, _ = ki.closest_hit(table, ro, rd, T0, t1_dead)
    check(not bool(hit_dead[lanes % 3 == 0].any()), "a dead lane (t1=0) hit")
    max_abs_err = {"closest_hit": float(err[0]), "occluded": float(err[1])}

    phase("3 main path: CLI, cornell_box.json, reference, 1024x1024, 4 bounces, 16 spp")
    spp, depth, res, chunk = 16, 4, 1024, 1 << 16
    expect = spp * ((res * res + chunk - 1) // chunk) * depth
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cornell.png")
        exr = os.path.join(tmp, "cornell.exr")
        argv = [SCENE, "--estimator", "reference", "--depth", str(depth),
                "--spp", str(spp), "--res", str(res), str(res),
                "--out", png, "--hdr-out", exr]
        (rc, log), _ = counted(lambda: run_cli(cli, argv), "CLI reference frame",
                               {"closest_hit": expect, "occluded": expect})
        check(rc == 0, f"cli.main returned {rc}")
        check(os.path.getsize(png) > 0 and os.path.getsize(exr) > 0, "outputs missing")
        hdr = read_exr(exr)
    check(hdr.shape == (res, res, 3), f"HDR shape {hdr.shape}")
    check(bool(np.isfinite(hdr).all()), "HDR has non-finite values")
    print(f"HDR mean {float(hdr.mean()):.6f}", flush=True)
    m = re.search(r"(\d+) rays in ([0-9.]+) s = ([0-9.]+) Mrays/s", log)
    check(m is not None, "the CLI printed no ray count")
    rays, secs = int(m.group(1)), float(m.group(2))

    phase("4 GPU against CPU")
    cfg = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
    cam64 = host_camera._replace(resolution=(64, 64))
    s_gpu, c_gpu = to_device(host_scene, cam64, dev)
    s_cpu, c_cpu = to_device(host_scene, cam64, "cpu")
    img_gpu = render_image(s_gpu, c_gpu, cfg).cpu().numpy()
    img_cpu = render_image(s_cpu, c_cpu, cfg).numpy()
    close = float(np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean())
    med = float(np.median(np.abs(img_gpu - img_cpu)))
    print(f"64x64: close fraction {close:.6f} (> 0.95), median |diff| {med:.3g} (< 1e-5)")
    check(close > 0.95 and med < 1e-5, "GPU and CPU images disagree")
    cfg160 = RenderConfig(max_bounces=8, spp=32, seed=1, estimator="reference")
    s160, c160 = to_device(host_scene, host_camera._replace(resolution=(160, 160)), dev)
    mean = float(render_image(s160, c160, cfg160).mean())
    print(f"160x160 mean radiance {mean!r}, JAX CPU {JAX_MEAN_RADIANCE_160!r}, "
          f"|diff| {abs(mean - JAX_MEAN_RADIANCE_160):.3g} (<= {MEAN_TOL})", flush=True)
    check(abs(mean - JAX_MEAN_RADIANCE_160) <= MEAN_TOL, "mean radiance off")

    phase(f"5 timings on {card}")
    ms, plain_ms = {}, {}
    for name, fn, ref in (("closest_hit", ki.closest_hit, ki.closest_hit_ref),
                          ("occluded", ki.occluded, ki.occluded_ref)):
        ms[name], plain_ms[name] = cuda_ms_pair(lambda: fn(table, ro, rd, T0, t1_dead),
                                                lambda: ref(table, ro, rd, T0, t1_dead))
    bounds = whole_bounds(table, ro, rd, t1_dead)
    for name in ms:
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
              f"{bounds[name][0]:.6f} ms ({bounds[name][1]}) ({N_RAYS} rays x {n_tris} tris, "
              f"{card})")
    time_whole_table(ki, table, whole_wavefronts(*whole["cornell"][:2], dev), "Cornell", card)
    print(f"frame: {rays} rays in {secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s "
          f"(1024x1024, 16 spp, 4 bounces, {card})", flush=True)

    large, ctx = large_scene_phases(dev, card)
    binned = binned_phases(dev, card, ctx)
    probes = probe_phases(dev, card)
    pbrt_phases(dev, card, rays / secs / 1e6)
    entry_point_phases(dev, card)
    rounds = resume_phases(dev, card, ctx)
    accel_phases(dev, card, ctx)
    gradient_phases(dev, card)
    render_mode_phases(dev, card, hdr, ro, rd, table)
    analytic_phase(dev, card)
    debug_path_phases(dev, card)
    golden_phase(dev, card)
    dist_phases(dev, card, hdr, host_scene, host_camera, ctx)
    harness_phase(dev, card)
    for entries in (large, binned, probes, rounds):
        max_abs_err.update(entries["max_abs_err"])
        ms.update(entries["ms"])
        plain_ms.update(entries["plain_ms"])
        bounds.update(entries["bounds"])
    print(f"launches over the main paths' counting windows: {dict(TALLY)}", flush=True)
    check(all(TALLY[name] > 0 for name in KERNELS),
          f"a kernel was never launched on a main path: {dict(TALLY)}")

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": TALLY[name], "max_abs_err": max_abs_err[name],
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def compare_cluster(kc, cl, cs, ro, rd, t1, label, refs):
    """Both cluster kernels against their twins on one ray set, with MT and
    watertight leaves, sort off and on; returns the max absolute
    differences (closest-hit t, occluded flag) over all of them. The ray
    set and the twin's results go into refs[label] for phase 10."""
    err = np.zeros(2)
    refs[label] = {"rays": (ro, rd, t1)}
    for wt in (False, True):
        hit_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=wt)
        refs[label][wt] = (hit_r, t_r, slot_r)
        face_r = cl.slot_to_face(cs, slot_r).to(torch.int32)
        occ_r = cl.occluded_ref(cs, ro, rd, T0, t1, watertight=wt)
        for sort in (False, True):
            tag = f"{label}, {'watertight' if wt else 'MT'}, sort {'on' if sort else 'off'}"
            hit, t, face = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort,
                                          watertight=wt, exact_t=False)
            occ = kc.occluded(cs, ro, rd, T0, t1, sort=sort, watertight=wt)
            torch.cuda.synchronize()
            check(torch.equal(hit, hit_r), f"{tag}: hit masks differ")
            n_hit = int(hit.sum())
            same = (face == face_r) & hit
            n_same = int(same.sum())
            check(n_same >= 0.999 * n_hit, f"{tag}: faces equal on {n_same}/{n_hit} hits")
            torch.testing.assert_close(t[same], t_r[same], rtol=1e-5, atol=0.0)
            check(torch.equal(occ, occ_r), f"{tag}: occluded differs")
            err_t = float((t - t_r).abs().max()) if t.numel() else 0.0
            err = np.maximum(err, [err_t, float((occ != occ_r).any())])
            n_equal = int(((t == t_r) & (face == face_r)).sum())
            print(f"{tag}: n={ro.shape[0]} hits={n_hit} faces equal {n_same}/{n_hit} "
                  f"max|dt|={err_t:.3g} (t, face) equal on {n_equal}/{ro.shape[0]} rays "
                  f"occluded={int(occ.sum())} (equal)", flush=True)
            check(n_equal == ro.shape[0], f"{tag}: t or face differ from the twin's")
    return err


def large_scene_phases(dev, card):
    """Phases 6-9 (the terrain100k cluster path); returns the kernel-line
    entries of the two cluster kernels, and what the binned phases reuse:
    the scene, the ray sets with their sweep-twin results, and phase 7's
    frame."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.camera import generate_rays, morton_pixel_order
    from pyrenderer_tpu_torch.core.integrator import TraceTables, render_image
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf.clusterbench import random_rays, walk, wavefronts
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
    from pyrenderer_tpu_torch.scene import procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    host, host_cam, _ = build_scene(procgen.big_scene_data("terrain", res=224))
    cam512 = host_cam._replace(resolution=(512, 512))
    scene, camera = to_device(host, cam512, dev)
    t = time.perf_counter()
    cs = cl.build_clusters(host.vertices, host.faces).to(dev)
    print(f"terrain100k: {host.faces.shape[0]} triangles, {cs.n_clusters} clusters, "
          f"{cs.n_superclusters} superclusters, built in {time.perf_counter() - t:.3f} s",
          flush=True)
    cfg = RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference")

    phase(f"6 cluster kernels against twins on the card ({N_RAYS} rays, terrain100k)")
    err = np.zeros(2)
    refs = {}
    ro, rd = random_rays(N_RAYS, 0, dev)
    err = np.maximum(err, compare_cluster(kc, cl, cs, ro, rd, T_MAX, "random, scalar t1",
                                          refs))
    perm, _ = morton_pixel_order(512, 512)
    ys, xs = np.mgrid[0:512, 0:512]
    px = torch.as_tensor(xs.reshape(-1)[perm][:N_RAYS], device=dev)
    py = torch.as_tensor(ys.reshape(-1)[perm][:N_RAYS], device=dev)
    cro, crd = generate_rays(camera, px, py, 0, 0)
    err = np.maximum(err, compare_cluster(kc, cl, cs, cro.contiguous(), crd.contiguous(),
                                          T_MAX, "camera rays, scalar t1", refs))
    tables = TraceTables(scene, cfg, accel=cs)
    bounce1, shadow1 = wavefronts(scene, camera, tables, cfg, px, py)
    err = np.maximum(err, compare_cluster(kc, cl, cs, *bounce1, "bounce-1 wavefront", refs))
    err = np.maximum(err, compare_cluster(kc, cl, cs, *shadow1, "bounce-1 shadow rays", refs))
    lanes = torch.arange(N_RAYS, device=dev)
    t1_dead = torch.where(lanes % 3 == 0, 0.0, T_MAX).float()
    err = np.maximum(err, compare_cluster(kc, cl, cs, ro, rd, t1_dead,
                                          "random, dead lanes t1=0", refs))
    hit_dead, _, _ = kc.closest_hit(cs, ro, rd, T0, t1_dead, sort=True)
    occ_dead = kc.occluded(cs, ro, rd, T0, t1_dead, sort=True)
    check(not bool((hit_dead | occ_dead)[lanes % 3 == 0].any()), "a dead lane (t1=0) hit")
    t1_var = torch.as_tensor(np.random.RandomState(1).uniform(0.1, 3.0, N_RAYS),
                             dtype=torch.float32, device=dev)
    err = np.maximum(err, compare_cluster(kc, cl, cs, ro, rd, t1_var, "random, per-ray t1",
                                          refs))
    rro, rrd = random_rays(100, 4, dev)
    err = np.maximum(err, compare_cluster(kc, cl, cs, rro, rrd, T_MAX, "ragged N=100", refs))
    max_abs_err = {"cluster_closest_hit": float(err[0]), "cluster_occluded": float(err[1])}

    # shared-edge leak hunt (tests/test_watertight.py:168-205) on the kernels
    quad = cl.build_clusters(np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32),
                             np.array([[0, 1, 2], [0, 2, 3]], np.int32)).to(dev)
    ts = np.linspace(1e-4, 1.0 - 1e-4, 4096).astype(np.float32)
    edge_ro = torch.as_tensor(np.stack([ts, ts, np.ones_like(ts)], axis=1), device=dev)
    edge_rd = torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(4096, 3).contiguous()
    for sort in (False, True):
        hit, t, _ = kc.closest_hit(quad, edge_ro, edge_rd, T0, 10.0, sort=sort, watertight=True)
        occ = kc.occluded(quad, edge_ro, edge_rd, T0, 10.0, sort=sort, watertight=True)
        mt_hit, _, _ = kc.closest_hit(quad, edge_ro, edge_rd, T0, 10.0, sort=sort)
        leaked, leaked_occ = int((~hit).sum()), int((~occ).sum())
        print(f"leak hunt, sort {'on' if sort else 'off'}: watertight kernels leaked "
              f"{leaked} (closest) and {leaked_occ} (occluded) of 4096 shared-edge rays; "
              f"MT leaves leak {int((~mt_hit).sum())}", flush=True)
        check(leaked == 0 and leaked_occ == 0, "the watertight kernels leak")
        torch.testing.assert_close(t, torch.ones_like(t), rtol=1e-4, atol=0.0)

    phase("7 large-scene path: ProgressiveRenderer, terrain100k, 512x512, 4 spp, 4 bounces")
    renderer = ProgressiveRenderer(scene, camera, cfg, chunk=1 << 16)
    check(renderer.backend == "cluster" and renderer.tables.cluster_sort
          and renderer.tables.cluster_watertight,
          f"auto resolved to {renderer.backend}, sort/watertight not both on")
    expect = 4 * 4 * 4
    film, _ = counted(lambda: renderer.run(quiet=True), "terrain100k cluster frame",
                      {"cluster_closest_hit": expect, "cluster_occluded": expect})
    hdr = film.hdr
    check(hdr.shape == (512, 512, 3) and bool(np.isfinite(hdr).all()), "HDR not finite")
    print(f"HDR mean {float(hdr.mean()):.6f}", flush=True)
    rays, secs = renderer.rays_traced, renderer.render_seconds
    print(f"frame: {rays:.0f} rays in {secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s "
          f"(terrain100k, 512x512, 4 spp, 4 bounces, {card})", flush=True)

    phase("8 GPU against references (terrain8k images, terrain100k mean radiance)")
    host8, cam8, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    cam32 = cam8._replace(resolution=(32, 32))
    s_gpu, c_gpu = to_device(host8, cam32, dev)
    s_cpu, c_cpu = to_device(host8, cam32, "cpu")
    for wt in (False, True):
        cfg8 = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference",
                            cluster_watertight=wt)
        # "cluster" on both devices: CPU "auto" would take the BVH
        img_gpu = render_image(s_gpu, c_gpu, cfg8, backend="cluster").cpu().numpy()
        img_cpu = render_image(s_cpu, c_cpu, cfg8, backend="cluster").numpy()
        close = float(np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean())
        med = float(np.median(np.abs(img_gpu - img_cpu)))
        print(f"terrain8k 32x32, {'watertight' if wt else 'MT'} leaves: close fraction "
              f"{close:.6f} (> 0.95), median |diff| {med:.3g} (< 1e-5)", flush=True)
        check(close > 0.95 and med < 1e-5, "terrain8k GPU and CPU images disagree")
    s32, c32 = to_device(host, host_cam._replace(resolution=(32, 32)), dev)
    cfg32 = RenderConfig(max_bounces=4, spp=2, seed=0, estimator="reference")
    mean = float(render_image(s32, c32, cfg32).mean())
    ref = JAX_MEAN_RADIANCE_TERRAIN100K
    print(f"terrain100k 32x32 mean radiance {mean!r}, JAX CPU {ref!r}, "
          f"|diff| {abs(mean - ref):.3g} (<= {MEAN_TOL})", flush=True)
    check(abs(mean - ref) <= MEAN_TOL, "terrain100k mean radiance off")

    phase(f"9 cluster timings on {card}")
    from pyrenderer_tpu_torch.perf.kernelbench import graph_ms

    b_ro, b_rd, b_t1 = bounce1
    s_ro, s_rd, s_t1 = shadow1
    ms, plain_ms = {}, {}
    queries = {
        "cluster_closest_hit": (kc.closest_hit, bounce1, "wavefront", cl.closest_hit_ref,
                                (torch.empty(N_RAYS, device=dev),
                                 torch.empty(N_RAYS, dtype=torch.int32, device=dev))),
        "cluster_occluded": (kc.occluded, shadow1, "shadow rays", cl.occluded_ref,
                             (torch.empty(N_RAYS, dtype=torch.bool, device=dev),)),
    }
    for name, (wrapper, (ro, rd, t1), what, twin, outs) in queries.items():
        # the kernel alone: one launch on operands prepared beforehand
        ops = {sort: kc._operands(cs, ro, rd, t1, sort) for sort in (False, True)}
        alone = {sort: (lambda o=ops[sort]: kc._launch(wrapper, cs, o, T0, True, outs))
                 for sort in (False, True)}
        ms[name], plain_ms[name] = cuda_ms_pair(
            alone[True], lambda: twin(cs, ro, rd, T0, t1, watertight=True))
        extra = {"kernel alone, unsorted": alone[False]}
        for sort in (False, True):
            kw = {"exact_t": False} if wrapper is kc.closest_hit else {}
            extra[f"wrapper, {'sorted' if sort else 'unsorted'}"] = (
                lambda sort=sort, kw=kw: wrapper(cs, ro, rd, T0, t1, sort=sort,
                                                 watertight=True, **kw))
        times = {label: [] for label in extra}
        for label in list(extra) + list(reversed(extra)):
            times[label].append(graph_ms(extra[label]))
        print(f"{name}: kernel alone, sorted {ms[name]:.4f} ms, "
              + ", ".join(f"{label} {float(np.median(t)):.4f} ms" for label, t in times.items())
              + f" (CUDA-graph replays, bounce-1 {what}, terrain100k, watertight, {card})",
              flush=True)
    hit_r, t_r, _ = refs["bounce-1 wavefront"][True]
    b_t1v = torch.as_tensor(b_t1, dtype=torch.float32, device=dev).expand(N_RAYS)
    walks = {"cluster_closest_hit": walk(cs, b_ro, b_rd, b_t1, torch.where(hit_r, t_r, b_t1v)),
             "cluster_occluded": walk(cs, s_ro, s_rd, s_t1)}
    work = {name: (int(slabs.sum()), int(tests.sum())) for name, (slabs, tests, _) in walks.items()}
    check(torch.equal(walks["cluster_occluded"][2], refs["bounce-1 shadow rays"][True][0]),
          "the any-hit walk's occlusion differs from the twin's")
    # the kernels' scene operands: the triangle rows, the compact box
    # copies and the supercluster rank
    tables_bytes = nbytes(cs.tri, cs.child_box8, cs.super_cols8) + 4 * cs.super_cols8.shape[0]
    bounds = {name: bound(slabs * SLAB_OPS + leaves * WT_OPS,
                          28 * N_RAYS + tables_bytes + (9 if "closest" in name else 1) * N_RAYS)
              for name, (slabs, leaves) in work.items()}
    for name in ms:
        slabs, leaves = work[name]
        print(f"{name}: kernel alone {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
              f"{bounds[name][0]:.6f} ms ({bounds[name][1]}; {slabs} slab tests, {leaves} "
              f"triangle tests) (bounce-1 {'wavefront' if 'closest' in name else 'shadow rays'}"
              f" of {N_RAYS} rays, terrain100k, watertight, sorted, {card})", flush=True)
    ctx = {"host": host, "cs": cs, "scene": scene, "camera": camera, "cfg": cfg,
           "refs": refs, "quad": quad, "edge": (edge_ro, edge_rd), "hdr_cluster": hdr,
           "mrays_cluster": rays / secs / 1e6, "rays_cluster": rays}
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bounds": bounds}, ctx


def compare_binned_kernels(kb, cs, rays, w, label):
    """The four binned kernels against their twins on one ray set at one W:
    prepass (with and without the words) and peel bit for bit, each leaf's
    keys bit for bit, MT and watertight; returns the max absolute
    differences (prepass, peel, leaf t, streamed leaf t)."""
    ids, ovf, words = kb.prepass(cs, rays, T0, w, emit_words=True)
    ids2, ovf2 = kb.prepass(cs, rays, T0, w)
    ids_r, ovf_r, words_r = kb.prepass_ref(cs, rays, T0, w, emit_words=True)
    check(torch.equal(ids, ids_r) and torch.equal(ovf, ovf_r) and torch.equal(words, words_r),
          f"{label}, W={w}: prepass differs from its twin")
    check(torch.equal(ids2, ids) and torch.equal(ovf2, ovf),
          f"{label}, W={w}: prepass without words differs")
    p_ids, p_ovf, p_words = kb.peel(words, w)
    for a, b in zip((p_ids, p_ovf, p_words), kb.peel_ref(words, w)):
        check(torch.equal(a, b), f"{label}, W={w}: peel differs from its twin")
    n_real = int((ids != kb.SENTINEL).sum())
    sortd, pair_ray = kb.sort_pairs(ids, n_real)
    blocks = kb.blocks_for(sortd, cs.n_clusters // kb.BIN)
    err = [0.0, 0.0, 0.0, 0.0]
    for wt in (False, True):
        keys = kb.leaf(cs, sortd, pair_ray, rays, T0, wt)
        keys_s = kb.leaf_streamed(cs, blocks, pair_ray, rays, T0, wt)
        keys_r = kb.leaf_ref(cs, sortd, pair_ray, rays, T0, wt)
        keys_sr = kb.leaf_streamed_ref(cs, blocks, pair_ray, rays, T0, wt)
        torch.cuda.synchronize()
        t_r = kb.decode(keys_r)[1]
        for i, (k, k_r) in enumerate(((keys, keys_r), (keys_s, keys_sr)), start=2):
            hit = k_r != kb.MISS_KEY
            dt = (kb.decode(k)[1] - t_r)[hit].abs()
            err[i] = max(err[i], float(dt.max()) if dt.numel() else 0.0)
        check(torch.equal(keys, keys_r), f"{label}, W={w}, wt={wt}: leaf keys differ")
        check(torch.equal(keys_s, keys_sr), f"{label}, W={w}, wt={wt}: streamed leaf keys differ")
    print(f"{label}, W={w}: prepass, peel bit-equal; {n_real} pairs "
          f"({int(ovf.sum())} rays overflow), {int((blocks[:, 0] >= 0).sum())} streamed blocks; "
          f"leaf and streamed leaf keys bit-equal (MT, watertight)", flush=True)
    return np.array(err)


def compare_binned_edges(kb, cs, refs, dev):
    """Both leaves against their twins, bit for bit, MT and watertight, on
    the launch edges (perf/clusterbench.edge_streams of phase 6's random
    rays: one pair, 33, a bin of more than 128, a last piece of one pair,
    all SENTINEL, dead rays) and on the duplicate triangles
    (perf/clusterbench.duplicate_set: the lower slot wins); returns the max
    absolute differences (leaf t, streamed leaf t)."""
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf import clusterbench as cb

    rays = kc._prepare(cs, *refs["random, scalar t1"]["rays"], sort=False)[0]
    cs_d, rays_d, sortd_d, pair_d, copies, sources = cb.duplicate_set(cs, dev)
    cases = [(label, cs, stream) for label, stream in cb.edge_streams(kb, cs, rays).items()]
    cases.append(("duplicate triangles", cs_d, (sortd_d, pair_d, rays_d)))
    err = np.zeros(2)
    for label, scene, (sortd, pair_ray, r) in cases:
        blocks = kb.blocks_for(sortd, cs.n_clusters // kb.BIN)
        for wt in (False, True):
            keys = kb.leaf(scene, sortd, pair_ray, r, T0, wt)
            keys_s = kb.leaf_streamed(scene, blocks, pair_ray, r, T0, wt)
            keys_r = kb.leaf_ref(scene, sortd, pair_ray, r, T0, wt)
            keys_sr = kb.leaf_streamed_ref(scene, blocks, pair_ray, r, T0, wt)
            torch.cuda.synchronize()
            tag = f"binned leaf edge {label}, {'watertight' if wt else 'MT'}"
            check(torch.equal(keys, keys_r), f"{tag}: leaf keys differ from the twin")
            check(torch.equal(keys_s, keys_sr), f"{tag}: streamed leaf keys differ from the twin")
            check(torch.equal(keys_s, keys), f"{tag}: the two leaves differ")
            slot = kb.decode(keys)[2]
            if scene is cs_d:
                check(not torch.isin(slot, torch.tensor(copies, device=dev)).any()
                      and torch.isin(slot, torch.tensor(sources, device=dev)).all(),
                      f"{tag}: a duplicate did not resolve to its lower slot")
            hit = keys_r != kb.MISS_KEY
            for i, k in enumerate((keys, keys_s)):
                dt = (kb.decode(k)[1] - kb.decode(keys_r)[1])[hit].abs()
                err[i] = max(err[i], float(dt.max()) if dt.numel() else 0.0)
        print(f"{label}: {sortd.shape[0]} pairs, {int((blocks[:, 0] >= 0).sum())} streamed "
              f"blocks, {int(hit.sum())} hits; both leaves' keys bit-equal to the twins "
              f"(MT, watertight)", flush=True)
    return err


def check_prepass_peel(kb, cs, rays, label, ws):
    """The prepass, with and without the words, and every peel round after
    it until no ray has a bit left, against their twins bit for bit, at
    each W of `ws`; returns the most peel rounds."""
    most = 0
    for w in ws:
        for emit in (False, True):
            for a, b in zip(kb.prepass(cs, rays, T0, w, emit),
                            kb.prepass_ref(cs, rays, T0, w, emit)):
                check(torch.equal(a, b), f"{label}, W={w}, words {emit}: prepass differs")
        words = kb.prepass(cs, rays, T0, w, emit_words=True)[2]
        rounds = 0
        while bool((words != 0).any()):
            out = kb.peel(words, w)
            for a, b in zip(out, kb.peel_ref(words, w)):
                check(torch.equal(a, b), f"{label}, W={w}: peel round {rounds + 1} differs")
            words = out[2]
            rounds += 1
        most = max(most, rounds)
    return most


def compare_prepass_edges(kb, cl, cs, refs, dev):
    """The prepass and the peel against their twins, bit for bit, on their
    launch edges (perf/clusterbench.prepass_edges of phase 6's random rays:
    all dead, every third dead, t1 exactly t0, t1 one float below t0, NaN,
    inf, negative, N = 1, 31, 33, 129) at W = 6 and 1 (many peel rounds);
    the peel on edge words (clusterbench.edge_words: bit 31, full words);
    then terrain330k's table (more box rows than one staging pass holds) on
    65,536 random rays at W = 6, 1 and 10 and its t1 = t0 set. Returns
    terrain330k's (host scene, camera, ClusterScene on the card, build
    seconds) for phase 19."""
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf import clusterbench as cb
    from pyrenderer_tpu_torch.scene import procgen
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    ro, rd, t1 = refs["random, scalar t1"]["rays"]
    for label, rays in cb.prepass_edges(cs, kc._prepare(cs, ro, rd, t1, sort=False)[0]).items():
        rounds = check_prepass_peel(kb, cs, rays, f"prepass edge {label}", (6, 1))
        print(f"prepass edge {label}: n={rays.shape[0]}, live {int((rays[:, 6] >= T0).sum())}; "
              f"prepass and {rounds} peel rounds bit-equal to the twins", flush=True)
    for w in (1, 6, 10):
        words = torch.as_tensor(cb.edge_words(4096, cs.bin_box8.shape[0] // 32), device=dev)
        rounds = 0
        while bool((words != 0).any()):
            out = kb.peel(words, w)
            for a, b in zip(out, kb.peel_ref(words, w)):
                check(torch.equal(a, b), f"peel edge words, W={w}: round {rounds + 1} differs")
            words = out[2]
            rounds += 1
        print(f"peel edge words (bit 31, full words), W={w}: {rounds} rounds bit-equal",
              flush=True)
    host, host_cam, _ = build_scene(procgen.big_scene_data("terrain", res=406))
    t = time.perf_counter()
    cs330 = cl.build_clusters(host.vertices, host.faces).to(dev)
    t_build = time.perf_counter() - t
    n_rows = cs330.bin_box8.shape[0]
    check(n_rows > 512, f"terrain330k has {n_rows} box rows: one staging pass")
    rays = kc._prepare(cs330, ro, rd, t1, sort=False)[0]
    rounds = check_prepass_peel(kb, cs330, rays, "terrain330k random", (6, 1, 10))
    inside = cb.prepass_edges(cs330, rays)["t1 = t0, origins in bins"]
    check_prepass_peel(kb, cs330, inside, "terrain330k t1 = t0", (6, 1))
    print(f"terrain330k ({n_rows} box rows): prepass and up to {rounds} peel rounds bit-equal on "
          f"{rays.shape[0]} random rays at W = 6, 1, 10 and on its t1 = t0 set", flush=True)
    return host, host_cam, cs330, t_build


def compare_binned_wrappers(kb, cl, cs, refs, label):
    """The public binned closest_hit / occluded, resident and streamed, W at
    its default and at 1, MT and watertight, against phase 6's sweep-twin
    results; returns the largest number of peel launches of one query."""
    ro, rd, t1 = refs["rays"]
    most_peels = 0
    for wt in (False, True):
        hit_r, t_r, slot_r = refs[wt]
        face_r = cl.slot_to_face(cs, slot_r).to(torch.int32)
        for streamed in (False, True):
            for w in (kb._W_DEFAULT, 1):
                kb.W_SLOTS = w
                peels = kb.peel.launches
                hit, t, face = kb.closest_hit(cs, ro, rd, T0, t1, watertight=wt,
                                              streamed=streamed, exact_t=False)
                most_peels = max(most_peels, kb.peel.launches - peels)
                occ = kb.occluded(cs, ro, rd, T0, t1, watertight=wt, streamed=streamed)
                kb.W_SLOTS = kb._W_DEFAULT
                shown = kb._w_slots(streamed) if w == kb._W_DEFAULT else w
                tag = (f"{label}, {'watertight' if wt else 'MT'}, "
                       f"{'streamed' if streamed else 'resident'}, W={shown}")
                check(torch.equal(hit, hit_r), f"{tag}: hit masks differ from the sweep twin")
                check(torch.equal(occ, hit_r), f"{tag}: occlusion differs from the sweep twin")
                n_hit = int(hit.sum())
                same = (face == face_r) & hit
                n_same = int(same.sum())
                check(n_same >= 0.999 * n_hit, f"{tag}: faces equal on {n_same}/{n_hit} hits")
                torch.testing.assert_close(t[same], t_r[same], rtol=1e-5, atol=0.0)
                err_t = float((t - t_r).abs().max()) if t.numel() else 0.0
                print(f"{tag}: hits={n_hit} faces equal {n_same}/{n_hit} max|dt|={err_t:.3g}, "
                      "occlusion equal", flush=True)
    return most_peels


def binned_phases(dev, card, ctx):
    """Phases 10-12 (the binned traversal at terrain100k); returns the
    kernel-line entries of the four binned kernels."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.kernels import binned as kb
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf.clusterbench import ptxas_report
    from pyrenderer_tpu_torch.perf.kernelbench import cuda_ms
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer

    cs, refs = ctx["cs"], ctx["refs"]
    names = ("binned_prepass", "binned_peel", "binned_leaf", "binned_leaf_streamed")
    phase(f"10 binned kernels against twins on the card (terrain100k, {cs.n_clusters // kb.BIN}"
          f" bins, {cs.bin_box.shape[0]} box rows)")
    err = np.zeros(4)
    for label, ref in refs.items():
        rays = kc._prepare(cs, *ref["rays"], sort=False)[0]
        for w in (kb._W_DEFAULT, 1):
            err = np.maximum(err, compare_binned_kernels(kb, cs, rays, w, label))
    err[2:] = np.maximum(err[2:], compare_binned_edges(kb, cs, refs, dev))
    ctx["terrain330k"] = compare_prepass_edges(kb, cl, cs, refs, dev)
    max_abs_err = dict(zip(names, (float(e) for e in err)))
    peels = {label: compare_binned_wrappers(kb, cl, cs, ref, label)
             for label, ref in refs.items()}
    print(f"most peel rounds of one streamed query (W=1): {peels}", flush=True)
    quad = ctx["quad"]
    edge_ro, edge_rd = ctx["edge"]
    for streamed in (False, True):
        hit, t, _ = kb.closest_hit(quad, edge_ro, edge_rd, T0, 10.0, watertight=True,
                                   streamed=streamed)
        occ = kb.occluded(quad, edge_ro, edge_rd, T0, 10.0, watertight=True, streamed=streamed)
        leaked, leaked_occ = int((~hit).sum()), int((~occ).sum())
        print(f"leak hunt, binned {'streamed' if streamed else 'resident'}: leaked {leaked} "
              f"(closest) and {leaked_occ} (occluded) of 4096 shared-edge rays", flush=True)
        check(leaked == 0 and leaked_occ == 0, "the binned watertight path leaks")
        torch.testing.assert_close(t, torch.ones_like(t), rtol=1e-4, atol=0.0)

    phase("11 binned path: ProgressiveRenderer, terrain100k, 512x512, 4 spp, 4 bounces")
    mrays = {"cluster": ctx["mrays_cluster"]}
    expect = 4 * 4 * 4 * 2
    for backend, leaf_name in (("cluster_binned", "binned_leaf"),
                               ("cluster_streamed", "binned_leaf_streamed")):
        renderer = ProgressiveRenderer(ctx["scene"], ctx["camera"], ctx["cfg"],
                                       backend=backend, chunk=1 << 16, accel=cs)
        check(renderer.backend == backend and renderer.tables.cluster_watertight
              and not renderer.tables.cluster_sort,
              f"{backend}: resolved {renderer.backend}, watertight/sort not on/off")
        film, run = counted(lambda: renderer.run(quiet=True), f"terrain100k {backend} frame")
        hdr = film.hdr
        check(hdr.shape == (512, 512, 3) and bool(np.isfinite(hdr).all()), "HDR not finite")
        ref = ctx["hdr_cluster"]
        close = float(np.isclose(hdr, ref, rtol=1e-3, atol=0.0).mean())
        med = float(np.median(np.abs(hdr - ref)))
        print(f"{backend}: against the cluster frame: close fraction {close:.6f} (> 0.999), "
              f"median |diff| {med:.3g} (0), HDR mean {float(hdr.mean()):.6f}", flush=True)
        check(run.get("binned_prepass", 0) >= expect and run.get(leaf_name, 0) >= expect,
              f"{backend}: prepass or leaf launched fewer than {expect} times")
        # at terrain100k some rays cross more than W bins on every bounce, so
        # each path also runs its overflow stage: the sweep or the peel
        overflow = (("cluster_closest_hit", "cluster_occluded") if backend == "cluster_binned"
                    else ("binned_peel",))
        check(sum(run.get(name, 0) for name in overflow) > 0,
              f"{backend}: the overflow stage never ran")
        check("closest_hit" not in run and "occluded" not in run,
              f"{backend}: the path reached the whole-table kernels")
        check(close > 0.999 and med == 0.0, f"{backend}: frame differs from the cluster frame")
        mrays[backend] = renderer.rays_traced / renderer.render_seconds / 1e6
    print("frames (terrain100k, 512x512, 4 spp, 4 bounces, Mrays/s as bench.py counts): "
          + ", ".join(f"{b} {m:.3f}" for b, m in mrays.items()) + f" ({card})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "binned.png")
        argv = [SCENE, "--estimator", "reference", "--backend", "cluster_binned", "--res",
                "64", "64", "--spp", "2", "--depth", "4", "--out", png,
                "--hdr-out", os.path.join(tmp, "binned.exr")]
        (rc, log), run = counted(lambda: run_cli(cli, argv), "CLI --backend cluster_binned")
        check(rc == 0 and os.path.getsize(png) > 0, "the --backend cluster_binned CLI run failed")
        check("(cluster_binned backend)" in log and run.get("binned_prepass") == 2 * 4 * 2,
              "the CLI run did not route to the binned kernels")

    phase(f"12 binned timings on {card}")
    b_ro, b_rd, b_t1 = refs["bounce-1 wavefront"]["rays"]
    s_ro, s_rd, s_t1 = refs["bounce-1 shadow rays"]["rays"]
    rays = kc._prepare(cs, b_ro, b_rd, b_t1, sort=False)[0]
    w = kb._w_slots()
    ids, ovf, words = kb.prepass(cs, rays, T0, w, emit_words=True)
    n_real = int((ids != kb.SENTINEL).sum())
    sortd, pair_ray = kb.sort_pairs(ids, n_real)
    blocks = kb.blocks_for(sortd, cs.n_clusters // kb.BIN)
    print(f"bounce-1 wavefront: {int((b_t1 > 0).sum())} live rays, {n_real} pairs at W={w}, "
          f"{int(ovf.sum())} overflow rays", flush=True)
    ms, plain_ms = {}, {}
    ms["binned_prepass"], plain_ms["binned_prepass"] = cuda_ms_pair(
        lambda: kb.prepass(cs, rays, T0, w), lambda: kb.prepass_ref(cs, rays, T0, w))
    ms["binned_peel"], plain_ms["binned_peel"] = cuda_ms_pair(
        lambda: kb.peel(words, w), lambda: kb.peel_ref(words, w))
    ms["binned_leaf"], plain_ms["binned_leaf"] = cuda_ms_pair(
        lambda: kb.leaf(cs, sortd, pair_ray, rays, T0, True),
        lambda: kb.leaf_ref(cs, sortd, pair_ray, rays, T0, True), twin_reps=2)
    ms["binned_leaf_streamed"], plain_ms["binned_leaf_streamed"] = cuda_ms_pair(
        lambda: kb.leaf_streamed(cs, blocks, pair_ray, rays, T0, True),
        lambda: kb.leaf_streamed_ref(cs, blocks, pair_ray, rays, T0, True), twin_reps=2)
    # the prepass tests every bin for each live ray (t1 >= t0) only
    n_live = int((rays[:, 6] >= T0).sum())
    n_bins = cs.n_clusters // kb.BIN
    leaf_ops = n_real * kb.BIN * 128 * WT_OPS
    leaf_bytes = nbytes(pair_ray, rays, cs.tri) + 8 * n_real
    bounds = {
        "binned_prepass": bound(n_live * n_bins * SLAB_OPS,
                                nbytes(rays, cs.bin_box8, ids, ovf)),
        "binned_peel": bound(N_RAYS * (words.shape[1] + w), 2 * nbytes(words) + nbytes(ids, ovf)),
        "binned_leaf": bound(leaf_ops, leaf_bytes + nbytes(sortd)),
        "binned_leaf_streamed": bound(leaf_ops, leaf_bytes + nbytes(blocks)),
    }
    ptxas = ptxas_report(build.build_log(), "binned")
    for name in names:
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
              f"{bounds[name][0]:.6f} ms ({bounds[name][1]}) (bounce-1 wavefront of {N_RAYS} "
              f"rays, {n_live} live, {n_real} pairs, terrain100k, watertight, {card})",
              flush=True)
        for line in ptxas:
            if line.startswith((f"ptxas {name}_kernel ", f"ptxas {name}_kernel:")):
                print(f"  {line}", flush=True)
    # the other calls of the two candidate kernels on the binned paths: the
    # streamed path's prepass (W = 10, with the words) and its first peel
    # (round 2), and the shadow rays' prepass
    s_rays = kc._prepare(cs, s_ro, s_rd, s_t1, sort=False)[0]
    w10 = kb.W_SLOTS_STREAMED
    words10 = kb.prepass(cs, rays, T0, w10, emit_words=True)[2]
    ids10, ovf10, _ = kb.peel(words10, w10)
    extra = {
        f"binned_prepass, W={w10} with words (the streamed path)": (
            lambda: kb.prepass(cs, rays, T0, w10, emit_words=True),
            lambda: kb.prepass_ref(cs, rays, T0, w10, emit_words=True),
            bound(n_live * n_bins * SLAB_OPS, nbytes(rays, cs.bin_box8, words10) + 4 * N_RAYS
                  * w10 + N_RAYS)),
        f"binned_peel, W={w10} on the streamed path's round-2 words": (
            lambda: kb.peel(words10, w10), lambda: kb.peel_ref(words10, w10),
            bound(N_RAYS * (words10.shape[1] + w10), 2 * nbytes(words10) + nbytes(ids10, ovf10))),
        f"binned_prepass, W={w}, the bounce-1 shadow rays": (
            lambda: kb.prepass(cs, s_rays, T0, w), lambda: kb.prepass_ref(cs, s_rays, T0, w),
            bound(int((s_rays[:, 6] >= T0).sum()) * n_bins * SLAB_OPS,
                  nbytes(s_rays, cs.bin_box8, ids, ovf))),
    }
    for name, (kernel_fn, twin_fn, (b_ms, b_by)) in extra.items():
        k_ms, t_ms = cuda_ms_pair(kernel_fn, twin_fn)
        print(f"{name}: kernel {k_ms:.4f} ms, plain {t_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by}) (terrain100k, {card})", flush=True)
    wrappers = {
        "closest, binned": lambda: kb.closest_hit(cs, b_ro, b_rd, T0, b_t1, watertight=True,
                                                  exact_t=False),
        "closest, streamed": lambda: kb.closest_hit(cs, b_ro, b_rd, T0, b_t1, watertight=True,
                                                    streamed=True, exact_t=False),
        "closest, sweep sorted": lambda: kc.closest_hit(cs, b_ro, b_rd, T0, b_t1, sort=True,
                                                        watertight=True, exact_t=False),
        "closest, sweep unsorted": lambda: kc.closest_hit(cs, b_ro, b_rd, T0, b_t1,
                                                          watertight=True, exact_t=False),
        "occluded, binned": lambda: kb.occluded(cs, s_ro, s_rd, T0, s_t1, watertight=True),
        "occluded, streamed": lambda: kb.occluded(cs, s_ro, s_rd, T0, s_t1, watertight=True,
                                                  streamed=True),
        "occluded, sweep sorted": lambda: kc.occluded(cs, s_ro, s_rd, T0, s_t1, sort=True,
                                                      watertight=True),
        "occluded, sweep unsorted": lambda: kc.occluded(cs, s_ro, s_rd, T0, s_t1,
                                                        watertight=True),
    }
    order = list(wrappers) + list(reversed(wrappers))
    times = {name: [] for name in wrappers}
    for name in order:
        times[name].append(cuda_ms(wrappers[name]))
    for name in wrappers:
        print(f"wrapper {name}: {float(np.median(times[name])):.4f} ms (median of two means "
              f"of 20 calls, bounce-1 "
              f"{'shadow rays' if name.startswith('occluded') else 'wavefront'}, "
              f"watertight, {card})", flush=True)
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bounds": bounds}


def max_sm_clock():
    """The card's maximum SM clock in MHz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def probe_phases(dev, card):
    """Phase 13 (the four probe kernels of csrc/kernelbench.cu); returns
    their kernel-line entries (phase 15 counts their launches)."""
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.perf import kernelbench as kb
    from pyrenderer_tpu_torch.perf.clusterbench import (latency_report, probe_bound, probe_call,
                                                        probe_floor, probe_params, probe_parity,
                                                        probe_ptxas, probe_sets, probe_tests,
                                                        sass_dump, sass_loops)

    phase(f"13 probe kernels against twins on the card ({kb.N_TILES} tiles x "
          f"{kb.RAY_TILE} rays; N = 128, 384, 38,400; offset rows; the edge sets)")
    build.library()
    with tempfile.TemporaryDirectory() as tmp:
        bad, err = probe_parity(kb, probe_sets(dev), tmp)
    check(bad == 0, f"{bad} probe cases differ from their twins")
    print("every probe bit-equal to its twin on every set", flush=True)

    rcol, tri = kb.inputs(kb.N_TILES, dev)
    n = rcol.shape[0]
    twins = {"leaf": lambda x: kb.leaf_ref(rcol, tri, x),
             "extract": lambda x: kb.extract_ref(rcol, x),
             "cond": lambda x: kb.cond_ref(rcol, tri, *x),
             "ctz": lambda x: kb.ctz_ref(rcol, tri, x)}
    # each kernel's loop in the SASS (instructions a test on its fast path;
    # the extract's: a round) and its ptxas lines; the floors from them at
    # the card's maximum SM clock
    tags = {probe: f"kb_{probe}_kernel" for probe in twins}
    try:
        loops = sass_loops(sass_dump(build.build()))
        lat, lines = latency_report(dev)
    except RuntimeError as exc:
        check(False, f"the probes' SASS or the latencies could not be read: {exc}")
    for probe in twins:
        check(loops.get(tags[probe]) is not None,
              f"no loop with a test found in {tags[probe]}'s SASS: no floor")
    fadds = loops[tags["extract"]]["ops"].get("FADD", 0) / loops[tags["extract"]]["tests"]
    check(fadds >= 16, f"the extract's round has {fadds} FADDs a lane: acc hoisted out of the max")
    for line in lines:
        print(line, flush=True)
    ptxas = collections.defaultdict(list)
    for line in probe_ptxas(build.build_log()):
        tag, _, report = line[len("ptxas "):].partition(": ")
        ptxas[tag].append(report)
    clock = max_sm_clock()
    ms, plain_ms, bounds = {}, {}, {}
    params = probe_params("harness")
    for probe, param in params:
        name = f"kb_{probe}"
        k_ms, t_ms = cuda_ms_pair(probe_call(kb, rcol, tri, probe, param),
                                  lambda p=probe, x=param: twins[p](x), twin_graph=True)
        b = probe_bound(probe, param, n)
        # the kernel line keeps the last, heaviest parameter of each list
        ms[name], plain_ms[name], bounds[name] = k_ms, t_ms, b
        if probe != "extract" and not probe_tests(probe, param, n):
            floor = "issue floor 0 (no tests)"
        else:
            floor = probe_floor(loops, lat, probe, param, n, clock)[1]
            if probe == "extract":
                floor += (f", {fadds:.0f} FADDs a lane and round; it holds at that clock, the "
                          f"card's maximum")
        print(f"{name} {param}: kernel {k_ms:.4f} ms, plain {t_ms:.4f} ms, bound "
              f"{b[0]:.6f} ms ({b[1]}), {floor} ({n} rays, {card})", flush=True)
        if (probe, param) == [x for x in params if x[0] == probe][-1]:
            print(f"ptxas {tags[probe]}: "
                  + ("; ".join(ptxas[tags[probe]]) or "not in this process's build log"),
                  flush=True)
    return {"max_abs_err": {f"kb_{p}": e for p, e in err.items()}, "ms": ms,
            "plain_ms": plain_ms, "bounds": bounds}


def metal_glass_cornell():
    """The Cornell box with a metal tall box (roughness 0.1) and a glass
    short box (ior 1.5), as tests/test_pbrt.py:21-30 makes it."""
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    with open(SCENE) as fh:
        data = json.load(fh)
    for b in data["bsdfs"]:
        if b["name"] == "TallBox":
            b.update(type="metal", roughness=0.1)
        if b["name"] == "ShortBox":
            b.update(type="dielectric", ior=1.5)
    return build_scene(data)[:2]


def time_whole_table(ki, table, waves, scene, card):
    """Times the closest hit on the bounce-1 wavefront and the any hit on
    its shadow rays (waves: the two (ro, rd, t1) of whole_wavefronts),
    each beside its twin, its bound from those rays and ptxas's lines of
    its kernel."""
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.perf.clusterbench import whole_bounds, whole_ptxas

    ptxas = whole_ptxas(build.build_log())
    for name, fn, ref, (ro, rd, t1), rays in (
            ("closest_hit", ki.closest_hit, ki.closest_hit_ref, waves[0], "bounce-1 wavefront"),
            ("occluded", ki.occluded, ki.occluded_ref, waves[1], "bounce-1 shadow rays")):
        k_ms, t_ms = cuda_ms_pair(lambda: fn(table, ro, rd, T0, t1),
                                  lambda: ref(table, ro, rd, T0, t1))
        b = whole_bounds(table, ro, rd, t1)[name]
        closest = name == "closest_hit"
        kernel = f"{'closest' if closest else 'anyhit'}_kernel G=" + str(
            build.library().pr_whole_table_lanes(int(closest), table.shape[1]))
        regs = "; ".join(line.split(": ", 1)[1] for line in ptxas
                         if line.startswith(f"ptxas {kernel}:"))
        print(f"{name} at T={table.shape[1]}: kernel {k_ms:.4f} ms, plain {t_ms:.4f} ms, bound "
              f"{b[0]:.6f} ms ({b[1]}) ({scene} {rays}, {ro.shape[0]} rays, "
              f"{int((torch.as_tensor(t1) > T0).sum())} live; {card}); ptxas {kernel}: "
              f"{regs or 'not built in this process'}", flush=True)


def pbrt_phases(dev, card, mrays_reference):
    """Phase 14 (the pbrt estimator on the card)."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.camera import morton_pixel_order
    from pyrenderer_tpu_torch.core.integrator import TraceTables, render_image
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.perf.clusterbench import wavefronts
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device
    from pyrenderer_tpu_torch.utils.exr import read_exr

    phase("14 pbrt path: CLI with its default estimator, cornell_box.json, 1024x1024, "
          "4 bounces, 16 spp")
    spp, depth, res, chunk = 16, 4, 1024, 1 << 16
    expect = spp * ((res * res + chunk - 1) // chunk) * depth
    with tempfile.TemporaryDirectory() as tmp:
        exr = os.path.join(tmp, "pbrt.exr")
        argv = [SCENE, "--depth", str(depth), "--spp", str(spp), "--res", str(res), str(res),
                "--out", os.path.join(tmp, "pbrt.png"), "--hdr-out", exr]
        (rc, log), _ = counted(lambda: run_cli(cli, argv), "CLI pbrt frame",
                               {"closest_hit": expect, "occluded": expect})
        check(rc == 0, f"cli.main returned {rc}")
        hdr = read_exr(exr)
    check(hdr.shape == (res, res, 3) and bool(np.isfinite(hdr).all()), "pbrt HDR not finite")
    print(f"HDR mean {float(hdr.mean()):.6f}", flush=True)
    m = re.search(r"(\d+) rays in ([0-9.]+) s = ([0-9.]+) Mrays/s", log)
    check(m is not None, "the CLI printed no ray count")
    mrays = int(m.group(1)) / float(m.group(2)) / 1e6
    print(f"frame: pbrt {mrays:.3f} Mrays/s against reference {mrays_reference:.3f} "
          f"(phase 3), 1024x1024, 16 spp, 4 bounces, {card}", flush=True)

    cfg = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="pbrt")
    spheres, spheres_cam, _ = load_tungsten(os.path.join(ROOT, "scenes", "spheres.json"))
    for label, (host, cam) in (("cornell metal/glass", metal_glass_cornell()),
                               ("spheres", (spheres, spheres_cam))):
        cam64 = cam._replace(resolution=(64, 64))
        img_gpu = render_image(*to_device(host, cam64, dev), cfg).cpu().numpy()
        img_cpu = render_image(*to_device(host, cam64, "cpu"), cfg).numpy()
        close = float(np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean())
        med = float(np.median(np.abs(img_gpu - img_cpu)))
        print(f"{label} ({host.faces.shape[0]} tris) 64x64 pbrt: close fraction {close:.6f} "
              f"(> 0.95), median |diff| {med:.3g} (< 1e-5), mean {float(img_gpu.mean()):.6f}",
              flush=True)
        check(close > 0.95 and med < 1e-5 and bool(np.isfinite(img_gpu).all()),
              f"{label}: GPU and CPU pbrt images disagree")

    scene, camera = to_device(spheres, spheres_cam._replace(resolution=(1024, 1024)), dev)
    cfg_s = RenderConfig(max_bounces=4, spp=1, seed=0, estimator="pbrt")
    tables = TraceTables(scene, cfg_s)
    perm, _ = morton_pixel_order(1024, 1024)
    ys, xs = np.mgrid[0:1024, 0:1024]
    px = torch.as_tensor(xs.reshape(-1)[perm][:N_RAYS], device=dev)
    py = torch.as_tensor(ys.reshape(-1)[perm][:N_RAYS], device=dev)
    waves = wavefronts(scene, camera, tables, cfg_s, px, py, module="kernels")
    table = tables.tri_table
    for label, rays in zip(("spheres bounce-1 wavefront", "spheres bounce-1 shadow rays"), waves):
        compare_kernels(ki, table, *rays, label)
    time_whole_table(ki, table, waves, "spheres", card)

    host, host_cam, _ = load_tungsten(SCENE)
    s160, c160 = to_device(host, host_cam._replace(resolution=(160, 160)), dev)
    mean = float(render_image(s160, c160, RenderConfig(max_bounces=8, spp=32, seed=1,
                                                       estimator="pbrt")).mean())
    ref = JAX_MEAN_RADIANCE_160_PBRT
    print(f"160x160 pbrt mean radiance {mean!r}, JAX CPU {ref!r}, |diff| {abs(mean - ref):.3g} "
          f"(<= {MEAN_TOL})", flush=True)
    check(abs(mean - ref) <= MEAN_TOL, "pbrt mean radiance off")


def resume_phases(dev, card, ctx):
    """Phases 16-18 (the closest-hit kernel's resume mode and the rounds
    frame at terrain100k); returns the kernel-line entries of its two
    passes."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf.clusterbench import walk
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer

    cs, refs = ctx["cs"], ctx["refs"]
    phase("16 resume mode against its twin on the card (terrain100k, phase 6's ray sets)")
    err = {"cluster_closest_suspend": 0.0, "cluster_closest_resume": 0.0}
    suspended = 0
    for label, ref in refs.items():
        ro, rd, t1 = ref["rays"]
        n = ro.shape[0]
        for wt in (False, True):
            tag = f"{label}, {'watertight' if wt else 'MT'}"
            h0, t_0, f0 = kc.closest_hit(cs, ro, rd, T0, t1, watertight=wt, exact_t=False)
            ops = {sort: kc._operands(cs, ro, rd, t1, sort) for sort in (False, True)}
            rays, _, order, super_sorted = ops[False]
            for budget in (1, 2, 8):
                # the twin walks each ray alone, so the unsorted launch
                # order (the caller's) serves both launches
                t_r, slot_r, done_r = cl.closest_hit_resume_ref(
                    cs, rays, order, super_sorted, torch.full((n,), cl.MISS_T, device=dev),
                    torch.full((n,), -1, dtype=torch.int32, device=dev), T0, budget, wt)
                for sort in (False, True):
                    perm = ops[sort][1]
                    t, slot, done = (kc._unsort(x, perm)
                                     for x in kc.suspend_pass(cs, ops[sort], T0, budget, wt))
                    torch.cuda.synchronize()
                    check(torch.equal(t, t_r) and torch.equal(slot, slot_r)
                          and torch.equal(done, done_r),
                          f"{tag}, budget {budget}, sort {sort}: pass 1 differs from the twin")
                    hit = slot_r >= 0
                    if hit.any():
                        err["cluster_closest_suspend"] = max(
                            err["cluster_closest_suspend"], float((t - t_r)[hit].abs().max()))
                    h, tt, f = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort, watertight=wt,
                                              exact_t=False, rounds=2, budget=budget)
                    check(torch.equal(h, h0) and torch.equal(tt, t_0) and torch.equal(f, f0),
                          f"{tag}, budget {budget}, sort {sort}: rounds=2 differs from one pass")
                n_susp = int((done_r == 0).sum())
                if budget == 1:
                    suspended += n_susp
                    # the resume pass, as _rounds runs it, against the twin
                    _, ops_b, t_in, slot_in = kc.resume_operands(
                        ops[True], *kc.suspend_pass(cs, ops[True], T0, budget, wt))
                    out = kc.resume_pass(cs, ops_b, t_in, slot_in, T0, wt)
                    want = cl.closest_hit_resume_ref(cs, ops_b[0], order, super_sorted, t_in,
                                                     slot_in, T0, 0, wt)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(out, want)),
                          f"{tag}: the resume pass differs from the twin")
                    hit = want[1] >= 0
                    if hit.any():
                        err["cluster_closest_resume"] = max(
                            err["cluster_closest_resume"],
                            float((out[0] - want[0])[hit].abs().max()))
                print(f"{tag}, budget {budget}: pass 1 (t, slot, done) equal to the twin on "
                      f"all {n} rays, sort off and on, {n_susp} suspended; rounds=2 equal to "
                      f"one pass" + (", resume pass equal to the twin" if budget == 1 else ""),
                      flush=True)
    print(f"rays suspended at budget 1 over all sets: {suspended}", flush=True)
    check(suspended > 0, "no ray was suspended at budget 1: the phase proves nothing")

    phase("17 the slice's path: terrain100k frame with cluster_rounds=2, cluster_budget=8")
    cfg2 = ctx["cfg"].replace(cluster_rounds=2, cluster_budget=8)
    frames = {}
    for rounds, c, expect in (
            (2, cfg2, {"cluster_closest_hit": 128, "cluster_closest_suspend": 64,
                       "cluster_closest_resume": 64, "cluster_occluded": 64}),
            (1, ctx["cfg"], {"cluster_closest_hit": 64, "cluster_occluded": 64})):
        renderer = ProgressiveRenderer(ctx["scene"], ctx["camera"], c, chunk=1 << 16, accel=cs)
        check(renderer.backend == "cluster" and renderer.tables.cluster_sort
              and renderer.tables.cluster_watertight, f"rounds {rounds}: not the sorted sweep")
        film, _ = counted(lambda r=renderer: r.run(quiet=True),
                          f"terrain100k cluster frame, rounds={rounds}", expect)
        check(np.array_equal(film.hdr, ctx["hdr_cluster"]),
              f"rounds {rounds}: the frame differs from phase 7's")
        frames[rounds] = renderer.rays_traced / renderer.render_seconds / 1e6
    print(f"rounds=2 and rounds=1 frames bit-identical to phase 7's; Mrays/s rounds=2 "
          f"{frames[2]:.3f}, rounds=1 {frames[1]:.3f} (phase 7: {ctx['mrays_cluster']:.3f}; "
          f"terrain100k, 512x512, 4 spp, 4 bounces, watertight, {card})", flush=True)

    phase(f"18 resume-mode timings on {card}")
    b_ro, b_rd, b_t1 = refs["bounce-1 wavefront"]["rays"]
    hit_f, t_f, _ = refs["bounce-1 wavefront"][True]
    n = b_ro.shape[0]
    ops = kc._operands(cs, b_ro, b_rd, b_t1, True)     # sorted, as the frame runs it
    rays, perm, order, super_sorted = ops
    miss_t = torch.full((n,), cl.MISS_T, device=dev)
    miss_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pass1 = kc.suspend_pass(cs, ops, T0, 8, True)
    done_s = pass1[2]
    _, ops_b, t_in, slot_in = kc.resume_operands(ops, *pass1)

    def outs():
        return (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))

    o1, o2 = outs(), outs()
    ms, plain_ms = {}, {}
    ms["cluster_closest_suspend"], plain_ms["cluster_closest_suspend"] = cuda_ms_pair(
        lambda: kc._launch(kc.suspend_pass, cs, ops, T0, True, o1, resume=(miss_t, miss_s, 8)),
        lambda: cl.closest_hit_resume_ref(cs, rays, order, super_sorted, miss_t, miss_s, T0, 8,
                                          True))
    ms["cluster_closest_resume"], plain_ms["cluster_closest_resume"] = cuda_ms_pair(
        lambda: kc._launch(kc.resume_pass, cs, ops_b, T0, True, o2, resume=(t_in, slot_in, 0)),
        lambda: cl.closest_hit_resume_ref(cs, ops_b[0], order, super_sorted, t_in, slot_in,
                                          T0, 0, True))
    # the bounds: pass 1 walks each live ray until its 8th supercluster, the
    # resume pass the whole walk of the suspended rays, both culled with the
    # final t
    t1v = torch.as_tensor(b_t1, dtype=torch.float32, device=dev).expand(n)
    t_final = torch.where(hit_f, t_f, t1v)
    susp = perm[(done_s == 0).nonzero()[:, 0]]
    walks = {"cluster_closest_suspend": walk(cs, b_ro, b_rd, b_t1, t_final, budget=8),
             "cluster_closest_resume": walk(cs, b_ro[susp], b_rd[susp], t1v[susp],
                                            t_final[susp])}
    tables_bytes = nbytes(cs.tri, cs.child_box8, cs.super_cols8) + 4 * cs.super_cols8.shape[0]
    bounds = {}
    for name, (slabs, tests, _) in walks.items():
        slabs, tests = int(slabs.sum()), int(tests.sum())
        # rays, t_in and slot_in in; t, slot and done out
        bounds[name] = bound(slabs * SLAB_OPS + tests * WT_OPS, 28 * n + tables_bytes + 20 * n)
        print(f"{name}: kernel alone {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
              f"{bounds[name][0]:.6f} ms ({bounds[name][1]}; {slabs} slab tests, {tests} "
              f"triangle tests) (bounce-1 wavefront of {n} rays, "
              f"{int((t1v > T0).sum())} live, {susp.numel()} suspended at budget 8, "
              f"terrain100k, watertight, sorted, {card})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bounds": bounds}


def accel_phases(dev, card, ctx):
    """Phases 19-21: the chunked sweep at terrain330k, the BVH at terrain8k
    and the wavefront sort at terrain100k."""
    from pyrenderer_tpu_torch import native
    from pyrenderer_tpu_torch.accel import bvh as bvh_mod
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core import integrator as integ
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf.clusterbench import random_rays
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
    from pyrenderer_tpu_torch.scene import procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    phase("19 chunked sweep against the monolithic one (terrain330k)")
    # the scene and its ClusterScene from phase 10
    host, host_cam, cs, t_cs = ctx["terrain330k"]
    t = time.perf_counter()
    cc = cl.build_chunked_clusters(host.vertices, host.faces).to(dev)
    t_cc = time.perf_counter() - t
    check(isinstance(cc, cl.ClusterChunks) and len(cc.chunks) == 3,
          "terrain330k does not make 3 chunks")
    print(f"terrain330k: {host.faces.shape[0]} triangles; {len(cc.chunks)} chunks of "
          f"{cc.faces_per_chunk} ({cc.n_clusters} clusters) built in {t_cc:.3f} s, one "
          f"ClusterScene of {cs.n_clusters} clusters in {t_cs:.3f} s", flush=True)
    ro, rd = random_rays(N_RAYS, 0, dev)
    for wt in (False, True):
        h_c, t_c, f_c = kc.closest_hit_chunked(cc, ro, rd, T0, T_MAX, watertight=wt)
        h_m, t_m, f_m = kc.closest_hit(cs, ro, rd, T0, T_MAX, sort=True, watertight=wt)
        occ_c = kc.occluded_chunked(cc, ro, rd, T0, T_MAX, watertight=wt)
        occ_m = kc.occluded(cs, ro, rd, T0, T_MAX, sort=True, watertight=wt)
        torch.cuda.synchronize()
        tag = f"terrain330k {'watertight' if wt else 'MT'}"
        check(torch.equal(h_c, h_m) and torch.equal(occ_c, occ_m) and torch.equal(occ_c, h_c),
              f"{tag}: chunked and monolithic hit masks or occlusion differ")
        n_hit = int(h_m.sum())
        differ = h_m & (f_c != f_m)
        # a face that differs must be an exact tie: the same t
        torch.testing.assert_close(t_c[differ], t_m[differ], rtol=1e-6, atol=0.0)
        check(int(differ.sum()) <= 0.001 * n_hit, f"{tag}: faces differ on {int(differ.sum())}")
        same = h_m & ~differ
        print(f"{tag}: {N_RAYS} random rays, hits {n_hit} equal, occlusion equal, faces differ "
              f"on {int(differ.sum())} (ties, |dt| <= 1e-6 t), max|dt| on equal faces "
              f"{float((t_c - t_m)[same].abs().max()):.3g}", flush=True)
    cam512 = host_cam._replace(resolution=(512, 512))
    scene, camera = to_device(host, cam512, dev)
    cfg = RenderConfig(max_bounces=4, spp=2, seed=0, estimator="reference")
    per_query = 2 * 4 * 4
    frames, mrays = {}, {}
    for backend, accel, per in (("cluster_chunked", cc, 3), ("cluster", cs, 1)):
        renderer = ProgressiveRenderer(scene, camera, cfg, backend=backend, chunk=1 << 16,
                                       accel=accel)
        check(renderer.backend == backend and renderer.tables.cluster_watertight,
              f"{backend}: resolved {renderer.backend}, or not watertight")
        film, _ = counted(lambda r=renderer: r.run(quiet=True), f"terrain330k {backend} frame",
                          {"cluster_closest_hit": per * per_query,
                           "cluster_occluded": per * per_query})
        check(bool(np.isfinite(film.hdr).all()), f"{backend}: HDR not finite")
        frames[backend] = film.hdr
        mrays[backend] = renderer.rays_traced / renderer.render_seconds / 1e6
    close = float(np.isclose(frames["cluster_chunked"], frames["cluster"], rtol=1e-3,
                             atol=0.0).mean())
    med = float(np.median(np.abs(frames["cluster_chunked"] - frames["cluster"])))
    print(f"terrain330k 512x512 2 spp: chunked against monolithic close fraction {close:.6f} "
          f"(> 0.999), median |diff| {med:.3g} (0); Mrays/s cluster_chunked "
          f"{mrays['cluster_chunked']:.3f}, cluster {mrays['cluster']:.3f} ({card})", flush=True)
    check(close > 0.999 and med == 0.0, "the chunked frame differs from the monolithic one")

    phase("20 BVH: terrain8k 32x32 2 spp, backend bvh on the card and on the CPU")
    check(native.load_library() is not None,
          "the native SAH builder did not build on this machine (g++)")
    host8, cam8, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    cam32 = cam8._replace(resolution=(32, 32))
    cfg8 = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
    films = {}
    for where in (dev, "cpu"):
        renderer = ProgressiveRenderer(*to_device(host8, cam32, where), cfg8, backend="bvh")
        check(renderer.backend == "bvh" and isinstance(renderer.accel, bvh_mod.FlatBVH),
              "not the BVH")
        film, _ = counted(lambda r=renderer: r.run(quiet=True), f"terrain8k bvh frame ({where})",
                          {})
        films[str(where)] = (film.hdr, renderer.rays_traced / renderer.render_seconds / 1e6)
    (img_gpu, m_gpu), (img_cpu, m_cpu) = films[str(dev)], films["cpu"]
    close = float(np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean())
    med = float(np.median(np.abs(img_gpu - img_cpu)))
    print(f"terrain8k bvh (native SAH): close fraction {close:.6f} (> 0.95), median |diff| "
          f"{med:.3g} (< 1e-5); Mrays/s on the card {m_gpu:.3f}, on the CPU {m_cpu:.3f} "
          f"({card})", flush=True)
    check(close > 0.95 and med < 1e-5 and bool(np.isfinite(img_gpu).all()),
          "the GPU and CPU bvh images disagree")

    phase("21 wavefront sort (PYRENDERER_WF_SORT=1): terrain100k, both estimators")
    cs100 = ctx["cs"]
    expect = {"cluster_closest_hit": 64, "cluster_occluded": 64}
    mrays = {}
    for estimator in ("reference", "pbrt"):
        c = ctx["cfg"].replace(estimator=estimator)
        hdr = {}
        for wf in ("0", "1"):
            os.environ["PYRENDERER_WF_SORT"] = wf
            try:
                renderer = ProgressiveRenderer(ctx["scene"], ctx["camera"], c, chunk=1 << 16,
                                               accel=cs100)
                check(integ.use_wavefront_sort(renderer.tables) == (wf == "1"),
                      f"{estimator}: the wavefront sort is not {'on' if wf == '1' else 'off'}")
                film, _ = counted(lambda r=renderer: r.run(quiet=True),
                                  f"terrain100k {estimator} frame, PYRENDERER_WF_SORT={wf}",
                                  expect)
            finally:
                del os.environ["PYRENDERER_WF_SORT"]
            hdr[wf] = film.hdr
            mrays[(estimator, wf)] = renderer.rays_traced / renderer.render_seconds / 1e6
        if estimator == "reference":
            check(np.array_equal(hdr["0"], ctx["hdr_cluster"]), "the frame differs from phase 7's")
        check(bool(np.isfinite(hdr["1"]).all()), f"{estimator}: HDR not finite")
        close = np.isclose(hdr["1"], hdr["0"], rtol=1e-5, atol=1e-7)
        print(f"{estimator}: wavefront-sorted frame within rtol 1e-5 of the per-query-sorted "
              f"one on {int(close.sum())}/{close.size} values, max|diff| "
              f"{float(np.abs(hdr['1'] - hdr['0']).max()):.3g}", flush=True)
        check(bool(close.all()), f"{estimator}: the wavefront sort changes the frame")
    print("frames (terrain100k, 512x512, 4 spp, 4 bounces, Mrays/s): "
          + ", ".join(f"{e} WF_SORT={wf} {m:.3f}" for (e, wf), m in mrays.items())
          + f" ({card})", flush=True)


WHOLE_TABLE = {"closest_hit": 1, "occluded": 1}
CLUSTER = {"cluster_closest_hit": 1, "cluster_occluded": 1}
# suspend/resume rounds = 2: two closest-hit launches per query, one of each pass
ROUNDS = dict(CLUSTER, cluster_closest_hit=2, cluster_closest_suspend=1,
              cluster_closest_resume=1)
# (scene, estimator, launches of each kernel per query, further bench env)
BENCH_ROWS = (("cornell", "reference", WHOLE_TABLE, {}), ("cornell", "pbrt", WHOLE_TABLE, {}),
              ("spheres", "pbrt", WHOLE_TABLE, {}), ("terrain100k", "reference", CLUSTER, {}),
              ("terrain100k", "reference", ROUNDS, {"BENCH_ROUNDS": "2"}))


PARAMS = ("vertices", "albedo", "emission")


def field_graph(scene, cam, cfg, backend="auto", accel=None):
    """(image, params): the radiance of every pixel of `cam` as a function
    of fresh leaves (vertices, albedo, emission) that require grad, through
    dist/render.render_field (backend "auto", the entry point a user calls)
    or render_block with an explicit backend."""
    from pyrenderer_tpu_torch.core.integrator import render_block
    from pyrenderer_tpu_torch.dist.render import pixel_grid, render_field

    params = [getattr(scene, k).detach().clone().requires_grad_() for k in PARAMS]
    s = scene._replace(**dict(zip(PARAMS, params)))
    px, py = pixel_grid(cam)
    if backend == "auto":
        return render_field(s, cam, cfg, px, py, accel=accel), params
    return render_block(s, cam, cfg, cfg.seed, cfg.spp, px, py, backend=backend,
                        accel=accel), params


def grads_of(loss, params):
    return torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True,
                               materialize_grads=True)


def image_and_grads(scene, cam, cfg, backend="auto"):
    """(image, gradients of its sum w.r.t. (vertices, albedo, emission))."""
    img, params = field_graph(scene, cam, cfg, backend)
    return img.detach(), grads_of(img.sum(), params)


def rel_l2(a, b) -> float:
    """|a - b| / |b| (L2); 0 when both are 0."""
    num = float(torch.linalg.vector_norm((a - b).double()))
    den = float(torch.linalg.vector_norm(b.double()))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def check_grads(grads, label):
    for k, g in zip(PARAMS, grads):
        check(bool(torch.isfinite(g).all()), f"{label}: a {k} gradient is not finite")
    check(float(grads[1].abs().sum()) > 0, f"{label}: the albedo gradient is zero")


def gradient_phases(dev, card):
    """Phases 22-23: gradients through the kernels on the card, then
    training (the inverse-rendering example and one train_step's
    timing)."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.dist.render import CHUNK, pixel_grid, render_field, train_step
    from pyrenderer_tpu_torch.examples import invrender
    from pyrenderer_tpu_torch.utils.profiling import device_busy
    from pyrenderer_tpu_torch.scene import load_tungsten, procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    phase("22 gradients on the card: d(sum of the image)/d(vertices, albedo, emission)")
    host, host_cam, _ = load_tungsten(SCENE)
    grey = host.albedo.copy()
    grey[int(np.argmax(grey[:, 0] - grey[:, 1]))] = [0.5, 0.5, 0.5]
    cases = (("(a) Cornell, reference, 4 bounces", host,
              RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference")),
             ("(b) Cornell, pbrt, 6 bounces (Russian roulette), the reddest albedo grey",
              host._replace(albedo=grey),
              RenderConfig(max_bounces=6, spp=4, seed=0, estimator="pbrt")))
    for label, h, cfg in cases:
        scene, cam = to_device(h, host_cam._replace(resolution=(256, 256)), dev)
        per = cfg.spp * cfg.max_bounces  # one chunk of 2^16 pixels
        ((img_k, g_k), _), t_k = timed(lambda: counted(
            lambda: image_and_grads(scene, cam, cfg),
            f"{label}, 256x256, {cfg.spp} spp, backend cuda",
            {"closest_hit": per, "occluded": per}))
        (img_b, g_b), t_b = timed(lambda: image_and_grads(scene, cam, cfg, "brute"))
        check_grads(g_k, label)
        n_diff = int((img_k != img_b).any(dim=-1).sum())
        rels = [rel_l2(a, b) for a, b in zip(g_k, g_b)]
        print(f"{label}: forward+backward {t_k:.3f} s (kernels), {t_b:.3f} s (brute); "
              f"pixels whose radiance differs from brute's: {n_diff}; relative L2 of the "
              f"gradients against brute's (vertices, albedo, emission): "
              + ", ".join(f"{r:.3g}" for r in rels) + f"; |g| "
              + ", ".join(f"{float(torch.linalg.vector_norm(g)):.6g}" for g in g_k)
              + f" ({card})", flush=True)
        check(n_diff == 0, f"{label}: the kernels' image differs from brute's on {n_diff} "
              "pixels (hit decisions differ)")
        check(max(rels) <= 1e-5, f"{label}: gradients differ from brute's: {rels}")

    label = "(c) terrain8k, pbrt, 4 bounces"
    host8, cam8, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    cam64 = cam8._replace(resolution=(64, 64))
    cfg = RenderConfig(max_bounces=4, spp=2, seed=0, estimator="pbrt")
    check(host8.faces.shape[0] == 8204, f"terrain8k has {host8.faces.shape[0]} triangles")
    cs = cl.build_clusters(host8.vertices, host8.faces)
    per = cfg.spp * cfg.max_bounces
    scene, cam = to_device(host8, cam64, dev)
    (img_g, p_g), _ = counted(lambda: field_graph(scene, cam, cfg, accel=cs.to(dev)),
                              f"{label}, 64x64, {cfg.spp} spp, backend cluster (forward)",
                              {"cluster_closest_hit": per, "cluster_occluded": per})
    g_g, _ = counted(lambda: grads_of(img_g.sum(), p_g), f"{label} (backward)", {})
    check_grads(g_g, label)
    t = time.perf_counter()
    img_c, p_c = field_graph(*to_device(host8, cam64, "cpu"), cfg, accel=cs)
    g_c = grads_of(img_c.sum(), p_c)
    t_cpu = time.perf_counter() - t
    keep = torch.isclose(img_g.detach().cpu(), img_c.detach(), rtol=1e-4, atol=1e-6).all(dim=-1)
    g_gm = [g.cpu() for g in grads_of(img_g[keep.to(dev)].sum(), p_g)]
    g_cm = grads_of(img_c[keep].sum(), p_c)
    rel_all = [rel_l2(a.cpu(), b) for a, b in zip(g_g, g_c)]
    rel_keep = [rel_l2(a, b) for a, b in zip(g_gm, g_cm)]
    close = float(torch.isclose(g_gm[0], g_cm[0], rtol=1e-3, atol=0).float().mean())
    print(f"{label}: CPU twins {t_cpu:.1f} s; {int(keep.sum())} of {keep.numel()} pixels agree "
          f"with the CPU's (rtol 1e-4); relative L2 of the gradients against the CPU's "
          f"(vertices, albedo, emission), every pixel: "
          + ", ".join(f"{r:.3g}" for r in rel_all) + "; the pixels that agree: "
          + ", ".join(f"{r:.3g}" for r in rel_keep)
          + f"; vertex entries within rtol 1e-3 there: {close:.4f} ({card})", flush=True)
    check(keep.float().mean() >= 0.999, f"{label}: the GPU and CPU images disagree on "
          f"{int((~keep).sum())} pixels")
    check(max(rel_all[1:]) <= 1e-3, f"{label}: albedo/emission gradients differ: {rel_all}")

    phase("23 training on the card: examples/invrender at its defaults, then one train_step "
          "at 1024x1024")
    fields = 80 + 1  # a target and 80 steps, one chunk each
    per = 4 * 3
    out, _ = counted(lambda: invrender.recover(dev, log=lambda line: print(line, flush=True)),
                     "invrender (48x48, 4 spp, 3 bounces, 80 steps, albedo lr 30)",
                     {"closest_hit": fields * per, "occluded": fields * per})
    err = float(np.abs(out["albedo"] - out["true_albedo"]).max())
    print(f"invrender: loss {out['loss0']:.4e} -> {out['loss']:.4e} "
          f"({out['loss0'] / out['loss']:.1f}x), albedo max err {err:.5f} ({card})", flush=True)
    check(out["loss"] < out["loss0"] / 10, "invrender: the loss did not fall 10x")
    check(err < 0.05, f"invrender: albedo max err {err}")
    check(torch.equal(out["params"][0], out["params0"][0])
          and torch.equal(out["params"][2], out["params0"][2]),
          "invrender: vertices or emission moved")

    res = 1024
    cfg = RenderConfig(max_bounces=4, spp=1, seed=0, estimator="reference")
    scene, cam = to_device(host, host_cam._replace(resolution=(res, res)), dev)
    px, py = pixel_grid(cam)
    n_chunks = px.shape[0] // CHUNK
    with torch.no_grad():
        target = render_field(scene._replace(albedo=torch.as_tensor(grey, device=dev)), cam,
                              cfg, px, py)
    params = (scene.vertices, scene.albedo, scene.emission)
    lr = (1e-4, 1.0, 1.0)
    per = n_chunks * cfg.spp * cfg.max_bounces

    def step():
        return train_step(params, scene, cam, cfg, target, px, py, lr)

    counted(step, f"train_step warm-up ({res}x{res}, {n_chunks} chunks)",
            {"closest_hit": per, "occluded": per})
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (loss, new), t_step = timed(lambda: counted(step, f"train_step ({res}x{res})",
                                                {"closest_hit": per, "occluded": per})[0])
    peak = torch.cuda.max_memory_allocated(dev)
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(p).all()) for p in new),
          "train_step: loss or params not finite")
    # the same step split: each chunk's forward (render and loss, with the
    # graph) and its backward, each ending in a sync
    t_fwd = t_bwd = 0.0
    for start in range(0, px.shape[0], CHUNK):
        sl = slice(start, start + CHUNK)
        leaves = [p.detach().requires_grad_() for p in params]
        s = scene._replace(**dict(zip(PARAMS, leaves)))
        t0 = time.perf_counter()
        part = torch.sum((render_field(s, cam, cfg, px[sl], py[sl]) - target[sl]) ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(part / target.numel(), leaves, allow_unused=True,
                            materialize_grads=True)
        torch.cuda.synchronize()
        t_fwd += t1 - t0
        t_bwd += time.perf_counter() - t1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t
    busy_us, _, n_events = device_busy(prof.events())
    check(n_events > 0, "train_step: torch.profiler saw no device activity")
    idle = f"{1.0 - busy_us / 1e6 / t_step:.4f}"
    print(f"train_step {res}x{res} ({n_chunks} chunks of 2^16, {cfg.spp} spp, "
          f"{cfg.max_bounces} bounces, reference, all three params): step {t_step * 1e3:.1f} ms; "
          f"split by chunk: forward {t_fwd * 1e3:.1f} ms, backward {t_bwd * 1e3:.1f} ms "
          f"(backward/forward {t_bwd / t_fwd:.3f}); device busy {busy_us / 1e3:.1f} ms of "
          f"{t_prof * 1e3:.1f} ms profiled, idle share {idle} (against the unprofiled step); "
          f"peak memory {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB allocated before the step ({card})", flush=True)


def timed(fn):
    """(fn(), wall seconds), the card synchronised before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def entry_point_phases(dev, card):
    """Phase 15: bench.py's counterpart as a subprocess for each of
    BENCH_ROWS, with the launches it reports checked (spp x chunks x 4
    bounces of each query's kernel in the timed pass, the leaf probe's of
    the calibration, nothing else, no twin call) and added to TALLY; then
    the harness in this process as one counting window."""
    from pyrenderer_tpu_torch import bench
    from pyrenderer_tpu_torch.perf import kernelbench as kb

    phase("15 entry points: python -m pyrenderer_tpu_torch.bench, then the harness")
    kind = torch.cuda.get_device_name(dev)
    base_env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    for scene, estimator, per_query_launches, extra_env in BENCH_ROWS:
        _, res, spp, _ = bench.SCENES[scene]
        per_query = spp * -(-res * res // (1 << 16)) * 4
        expect = {name: n * per_query for name, n in per_query_launches.items()}
        expect["kb_leaf"] = bench.CALIB_WARMUP + bench.CALIB_REPS
        env = dict(base_env, BENCH_SCENE=scene, BENCH_ESTIMATOR=estimator, **extra_env)
        label = "/".join([scene, estimator] + [f"{k}={v}" for k, v in extra_env.items()])
        proc = subprocess.run([sys.executable, "-m", "pyrenderer_tpu_torch.bench"], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr)
        check(proc.returncode == 0, f"bench {label} exited {proc.returncode}")
        lines = proc.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench {label} printed {len(lines)} lines")
        row = json.loads(lines[0])
        metric = bench.SCENES[scene][3] + ("" if estimator == "reference" else "_" + estimator)
        calib = row.get("calib_ns_per_leaf")
        check(row.get("metric") == metric and row.get("unit") == "Mrays/s",
              f"bench {label}: metric {row.get('metric')!r}")
        check(isinstance(row.get("value"), float) and np.isfinite(row["value"])
              and row["value"] > 0, f"bench {label}: value {row.get('value')!r}")
        check(isinstance(calib, float) and np.isfinite(calib) and calib > 0,
              f"bench {label}: calib_ns_per_leaf {calib!r}")
        check(row.get("device") == kind, f"bench {label}: device {row.get('device')!r}")
        print(f"bench {label}: {lines[0]} ({card})", flush=True)
        check(row.get("launches") == expect and row.get("twin_calls") == {},
              f"bench {label}: launches {row.get('launches')}, twin calls "
              f"{row.get('twin_calls')}; expected {expect} and none")
        TALLY.update(row["launches"])

    # graph_ms: a warm-up launch, then a graph of REPS launches replayed twice
    per_graph = 1 + 2 * kb.REPS
    rc, launches = counted(lambda: kb.main(list(kb.BENCHES)), f"harness ({card})")
    check(rc == 0, f"the harness returned {rc}")
    probes = {"kb_leaf": len(kb.LEAF_L), "kb_extract": len(kb.EXTRACT_K),
              "kb_cond": 2 * len(kb.COND_N), "kb_ctz": len(kb.CTZ_WORDS)}
    for name, n in probes.items():
        check(launches.get(name) == n * per_graph,
              f"harness: {name} launched {launches.get(name)} times, expected {n * per_graph}")


def read_png(path):
    """(H, W, 3) uint8 of a PNG that utils/image_io.write_png wrote (8-bit
    RGB, one IDAT, filter type 0 on every row)."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        buf = fh.read()
    w, h = struct.unpack(">II", buf[16:24])
    i = buf.index(b"IDAT")
    (n,) = struct.unpack(">I", buf[i - 4:i])
    raw = np.frombuffer(zlib.decompress(buf[i + 4:i + 4 + n]), np.uint8).reshape(h, 1 + 3 * w)
    check(not raw[:, 0].any(), f"{path}: a row has a PNG filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def cli_rate(log, label, card):
    """The CLI's 'N rays in S s = M Mrays/s' line, printed with the card."""
    m = re.search(r"(\d+) rays in ([0-9.]+) s = ([0-9.]+) Mrays/s", log)
    check(m is not None, f"{label}: the CLI printed no ray count")
    print(f"{label}: {m.group(1)} rays in {m.group(2)} s = {m.group(3)} Mrays/s ({card})",
          flush=True)


def render_mode_phases(dev, card, hdr_cuda, ro, rd, table):
    """Phases 24-27: the rest of the render entry point on the card, each
    main-path run a counting window: the adaptive frame, run_resilient
    with injected failures and the CLI's --live --resilient, the tonemap
    mode, the matmul backend. `hdr_cuda` is phase 3's frame, (ro, rd) phase
    2's random rays and `table` the Cornell kernel table."""
    import math
    import unittest.mock as mock

    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core import intersect as isect
    from pyrenderer_tpu_torch.core.film import Film
    from pyrenderer_tpu_torch.core.tonemap import tonemap
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.render import driver as drv
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device
    from pyrenderer_tpu_torch.utils.exr import read_exr, write_exr

    res, depth, chunk = 1024, 4, 1 << 16
    chunks = -(-res * res // chunk)
    host_scene, host_camera, _ = load_tungsten(SCENE)

    phase("24 adaptive sampling: CLI, cornell_box.json with renderer.adaptive_sampling, "
          "reference, 1024x1024, 4 bounces, spp 16 (minimum 8, tolerance 0.02)")
    with tempfile.TemporaryDirectory() as tmp:
        with open(SCENE) as fh:
            data = json.load(fh)
        data["renderer"]["adaptive_sampling"] = True
        scene_file = os.path.join(tmp, "adaptive.json")
        with open(scene_file, "w") as fh:
            json.dump(data, fh)
        ckpt = os.path.join(tmp, "film.npz")
        argv = [scene_file, "--estimator", "reference", "--depth", str(depth), "--spp", "16",
                "--res", str(res), str(res), "--backend", "cuda",
                "--out", os.path.join(tmp, "a.png"), "--hdr-out", os.path.join(tmp, "a.exr"),
                "--checkpoint", ckpt, "--checkpoint-interval", "1000000"]
        ((rc, log), wall), launches = counted(lambda: timed(lambda: run_cli(cli, argv)),
                                              "CLI adaptive frame")
        check(rc == 0, f"cli.main returned {rc}")
        film = Film.load(ckpt)
    sweeps = [int(k) for k in re.findall(r"adaptive: refined (\d+) pixels", log)]
    expect = depth * (8 * chunks + sum(math.ceil(k / chunk) for k in sweeps))
    print(f"adaptive sweeps refined k_i = {sweeps} pixels; launches of B1 and B2 expected "
          f"4 x (8 x {chunks} + sum ceil(k_i / 2^16)) = {expect}", flush=True)
    check(launches == {"closest_hit": expect, "occluded": expect},
          f"adaptive frame: launches {launches}, expected {expect} of each")
    spp = film.spp_map
    err = film.relative_error()
    check(spp.shape == (res, res) and spp.min() == 8 and spp.max() <= 16,
          f"spp_map in [{spp.min()}, {spp.max()}], not within [8, 16]")
    check(bool(np.all((err <= 0.02) | (spp >= 16))),
          "a pixel below the cap has a relative error above the tolerance")
    check(bool(np.isfinite(film.hdr).all()), "the adaptive HDR has non-finite values")
    print(f"spp_map: min {spp.min()}, max {spp.max()}, mean {spp.mean():.4f}; every pixel at "
          f"err <= 0.02 or at the cap; HDR mean {film.hdr.mean():.6f}; wall of cli.main "
          f"{wall:.3f} s ({card})", flush=True)
    cli_rate(log, "adaptive frame", card)

    # at Tungsten's defaults ~97% of the pixels reach the cap, so the
    # refine/skip decisions are held against the twins at the settings of
    # tests/test_torch_driver.py's ADAPTIVE, where a share of them converge
    # (~16% below the cap at 64x64 on the CPU)
    cfg64 = RenderConfig(max_bounces=3, spp=12, spp_step=1, seed=4, estimator="reference",
                         adaptive=True, adaptive_min_spp=4, adaptive_tolerance=0.05)
    cam64 = host_camera._replace(resolution=(64, 64))
    films = {}
    for where in (dev, "cpu"):
        s, c = to_device(host_scene, cam64, where)
        films[str(where)] = drv.ProgressiveRenderer(s, c, cfg64, backend="cuda").run(quiet=True)
    spp64 = films[str(dev)].spp_map
    agree = float((spp64 == films["cpu"].spp_map).mean())
    below = float((spp64 < 12).mean())
    print(f"64x64 adaptive (3 bounces, spp 12, minimum 4, tolerance 0.05): spp_map in "
          f"[{spp64.min()}, {spp64.max()}], {below:.6f} of the pixels below the cap (>= 0.05), "
          f"equal to the CPU twins' on {agree:.6f} of the pixels (>= 0.98)", flush=True)
    check(spp64.max() > spp64.min() and below >= 0.05,
          "the 64x64 adaptive frame refined (almost) every pixel to the cap")
    check(agree >= 0.98, "the card's spp_map differs from the CPU twins'")

    phase("25 run_resilient: Cornell, reference, 1024x1024, 4 bounces, 4 spp, one pass "
          "raising and one poisoned with a NaN; then the CLI's --live --resilient")
    cfg = RenderConfig(max_bounces=depth, spp=4, seed=0, estimator="reference")
    scene, cam = to_device(host_scene, host_camera._replace(resolution=(res, res)), dev)
    clean = drv.ProgressiveRenderer(scene, cam, cfg, backend="cuda")
    per_run = 4 * chunks * depth
    _, secs_clean = counted(lambda: timed(lambda: clean.run(quiet=True)),
                            "uninterrupted 4-spp frame",
                            {"closest_hit": per_run, "occluded": per_run})[0]
    render_pass = drv._render_pass
    calls = {"n": 0, "ran": 0}
    # a chunk call in the middle of pass 1 raises before it renders; the
    # first chunk of pass 3 (after pass 1's retry and pass 2) renders and
    # comes back with a NaN: that pass is rejected whole
    raise_at = chunks // 2 + 1
    nan_at = raise_at + 2 * chunks + 1

    def injected(*args):
        calls["n"] += 1
        if calls["n"] == raise_at:
            raise RuntimeError("injected device failure")
        out = render_pass(*args)
        calls["ran"] += 1
        if calls["n"] == nan_at:
            out[0][0, 0] = float("nan")
        return out

    flaky = drv.ProgressiveRenderer(scene, cam, cfg, backend="cuda")
    with mock.patch.object(drv, "_render_pass", injected):
        (film, secs), launches = counted(
            lambda: timed(lambda: flaky.run_resilient(max_retries=2, backoff=0.01, quiet=True)),
            "resilient 4-spp frame")
    expect = depth * calls["ran"]
    # the raising pass's first chunks, the rejected pass, then the 4 passes
    check(calls["ran"] == raise_at - 1 + 5 * chunks and calls["n"] == calls["ran"] + 1,
          f"chunk calls {calls}: the injections did not fire as planned")
    check(launches == {"closest_hit": expect, "occluded": expect},
          f"resilient frame: launches {launches}, expected {expect} of each")
    check(np.array_equal(film.radiance_sum, clean.film.radiance_sum)
          and np.array_equal(film.sq_sum, clean.film.sq_sum)
          and np.array_equal(film.spp_map, clean.film.spp_map),
          "the resilient frame is not bit-identical to the uninterrupted one")
    check(flaky.rays_traced == clean.rays_traced,
          f"rays_traced {flaky.rays_traced} against {clean.rays_traced} uninterrupted")
    print(f"resilient frame bit-identical to the uninterrupted one after a raised and a "
          f"rejected pass; rays_traced {flaky.rays_traced:.0f} equal; {calls['ran']} chunk "
          f"renders for {4 * chunks}; wall {secs:.3f} s against {secs_clean:.3f} s "
          f"uninterrupted ({card})", flush=True)
    doomed = drv.ProgressiveRenderer(scene, cam, cfg, backend="cuda")

    def always_fails():
        raise RuntimeError("persistent device failure")

    doomed.render_one_pass = always_fails
    try:
        doomed.run_resilient(max_retries=2, backoff=0.01, quiet=True)
        check(False, "a render that always fails did not re-raise")
    except RuntimeError as e:
        check("persistent device failure" in str(e), f"re-raised {e!r}")
    print("a render that always fails re-raises after max_retries=2", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        argv = [SCENE, "--estimator", "reference", "--depth", str(depth), "--spp", "2",
                "--res", "256", "256", "--live", "--resilient",
                "--out", os.path.join(tmp, "l.png"), "--hdr-out", os.path.join(tmp, "l.exr")]
        (rc, log), _ = counted(lambda: run_cli(cli, argv), "CLI --live --resilient 256x256",
                               {"closest_hit": 2 * depth, "occluded": 2 * depth})
    check(rc == 0, f"cli.main --live --resilient returned {rc}")
    check("\u2580" in log and "2/2 spp" in log and "Mrays/s" not in log,
          "--live drew no ANSI frame (or did not silence the progress prints)")
    print(f"--live --resilient: exit 0, {log.count(chr(0x2580))} half-block cells drawn on "
          "a non-tty stream", flush=True)

    phase("26 tonemap mode on the card: phase 3's frame as an EXR, filmic")
    with tempfile.TemporaryDirectory() as tmp:
        exr, png = os.path.join(tmp, "in.exr"), os.path.join(tmp, "out.png")
        write_exr(exr, hdr_cuda)
        ((rc, log), wall), _ = counted(
            lambda: timed(lambda: run_cli(cli, ["tonemap", "--input", exr, "--tonemap", "filmic",
                                                "--out", png])),
            "CLI tonemap mode", {})
        check(rc == 0 and "on cuda:0" in log, f"tonemap mode returned {rc} ({log.strip()})")
        ours = read_png(png).astype(np.int32)
        ldr = tonemap(torch.from_numpy(read_exr(exr)), "filmic").numpy()
    plain = (np.clip(ldr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(np.int32)
    diff = np.abs(ours - plain)
    print(f"tonemap PNG {ours.shape} against the CPU tonemap of read_exr: max |diff| "
          f"{diff.max()} LSB, {int((diff > 0).sum())} of {diff.size} values differ; wall "
          f"{wall:.3f} s ({card})", flush=True)
    check(ours.shape == (res, res, 3) and diff.max() <= 1, "the tonemap mode's PNG is off")

    phase("27 matmul backend under torch.set_float32_matmul_precision(\"high\"): CLI, "
          "reference, 1024x1024, 16 spp, 4 bounces")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            exr = os.path.join(tmp, "m.exr")
            argv = [SCENE, "--estimator", "reference", "--depth", str(depth), "--spp", "16",
                    "--res", str(res), str(res), "--backend", "matmul",
                    "--out", os.path.join(tmp, "m.png"), "--hdr-out", exr]
            ((rc, log), wall), _ = counted(lambda: timed(lambda: run_cli(cli, argv)),
                                           "CLI matmul frame", {})
            check(rc == 0, f"cli.main --backend matmul returned {rc}")
            hdr = read_exr(exr)
        hit, t, tri = isect.intersect_matmul(scene, ro, rd, T0, T_MAX)
        # the frame's own decisions: phase 3's "cuda" frame rendered again
        # with every query also asked of the matmul backend and of the same
        # product unguarded (TF32 under "high")
        cfg16 = RenderConfig(max_bounces=depth, spp=16, seed=0, estimator="reference")
        (decisions, d_secs), _ = counted(
            lambda: timed(lambda: matmul_decisions(scene, cam, cfg16)),
            "cuda frame with every query asked of the matmul backend too",
            {"closest_hit": 16 * chunks * depth, "occluded": 16 * chunks * depth})
        check(torch.get_float32_matmul_precision() == "high",
              "the matmul backend did not restore the process's precision")
        # what the guard prevents, on phase 2's rays
        hit_tf32, _, tri_tf32 = unguarded_closest(scene, isect.build_tri_matrix(scene), ro, rd,
                                                  T0, T_MAX)
    finally:
        torch.set_float32_matmul_precision(prev)
    torch.set_float32_matmul_precision("highest")
    try:
        ieee = isect.intersect_matmul(scene, ro, rd, T0, T_MAX)
    finally:
        torch.set_float32_matmul_precision(prev)
    check(all(torch.equal(a, b) for a, b in zip((hit, t, tri), ieee)),
          "intersect_matmul under \"high\" differs from the same under \"highest\"")
    check(hdr.shape == hdr_cuda.shape and bool(np.isfinite(hdr).all()), "matmul HDR malformed")
    ours, tf32 = decisions["ieee"], decisions["tf32"]
    # the two formulations round t, u and v differently, so grazing rays
    # flip: occlusion and face materials at the bounds of tests/
    # test_torch_matmul.py::test_frame_decisions_against_brute, hit masks
    # (none in its 220k rays) on < 1e-5 of the live rays; the TF32 product
    # flips each 100x as often or more
    passes = {key: d["hit"] < 1e-5 * d["rays"] and d["material"] < 1e-4 * d["rays"]
              and d["occluded"] < 1e-3 * d["shadow_rays"] for key, d in decisions.items()}
    print(f"the cuda frame's queries asked of intersect_matmul / occluded_matmul under \"high\": "
          f"{ours} -> hit masks flipped on {ours['hit'] / ours['rays']:.3g} of the live rays "
          f"(< 1e-5), face materials on "
          f"{ours['material'] / ours['rays']:.3g} of the live rays (< 1e-4), occlusion on "
          f"{ours['occluded'] / ours['shadow_rays']:.3g} of the shadow rays (< 1e-3); the "
          f"unguarded TF32 product: {tf32} -> {tf32['hit'] / tf32['rays']:.3g} hit masks, "
          f"{tf32['material'] / tf32['rays']:.3g} materials, "
          f"{tf32['occluded'] / tf32['shadow_rays']:.3g} occlusions; the gate passes the "
          f"guarded product: {passes['ieee']}, the TF32 one: {passes['tf32']}; {d_secs:.3f} s "
          f"({card})", flush=True)
    check(passes["ieee"], "the matmul backend decides otherwise than the kernels on the frame")
    check(not passes["tf32"], "the frame's decision gate does not tell TF32 from IEEE float32")
    close = float(np.isclose(hdr, hdr_cuda, rtol=1e-3, atol=1e-6).mean())
    rel_mean = abs(float(hdr.mean()) - float(hdr_cuda.mean())) / float(hdr_cuda.mean())
    print(f"matmul frame against phase 3's cuda frame: {close:.6f} of values close at rtol "
          f"1e-3, atol 1e-6 (> 0.99); means {hdr.mean():.6f} / {hdr_cuda.mean():.6f}, "
          f"relative {rel_mean:.3g} (< 1e-3); wall of cli.main {wall:.3f} s ({card})",
          flush=True)
    cli_rate(log, "matmul frame", card)
    check(close > 0.99 and rel_mean < 1e-3, "the matmul frame differs from the cuda frame")
    hit_k, t_k, tri_k = ki.closest_hit(table, ro, rd, T0, T_MAX)
    tri = torch.where(hit, tri, -1)
    same_hit = float((hit == hit_k).float().mean())
    same_face = tri == tri_k
    both = same_face & hit
    t_close = bool(torch.isclose(t[both], t_k[both], rtol=2e-4, atol=2e-5).all())
    print(f"intersect_matmul against closest_hit on {ro.shape[0]} random rays: hit masks "
          f"equal on {same_hit:.6f}, faces on {float(same_face.float().mean()):.6f} (> 0.995 "
          f"each), t within rtol 2e-4 where the faces agree: {t_close}; bit for bit the "
          f"result under \"highest\"; the unguarded product under \"high\" (TF32): hit "
          f"masks equal on {float((hit_tf32 == hit_k).float().mean()):.6f}, faces on "
          f"{float((torch.where(hit_tf32, tri_tf32, -1) == tri_k).float().mean()):.6f}",
          flush=True)
    check(same_hit > 0.995 and float(same_face.float().mean()) > 0.995 and t_close,
          "intersect_matmul disagrees with the closest-hit kernel")


def unguarded_terms(w, ro, rd):
    """mt_terms_matmul's (det, t, u, v) from a plain `@`, in whatever
    precision the process has set (TF32 under "high")."""
    from pyrenderer_tpu_torch.core.intersect import ray_features

    raw = (ray_features(ro, rd) @ w.reshape(16, -1)).reshape(ro.shape[0], -1, 4)
    det = raw[..., 0]
    f = 1.0 / torch.where(det == 0, 1.0, det)
    return det, raw[..., 3] * f, raw[..., 1] * f, raw[..., 2] * f


def unguarded_closest(scene, w, ro, rd, t0, t1):
    """intersect_matmul's (hit, t, tri) through unguarded_terms."""
    from pyrenderer_tpu_torch.core.intersect import _accept

    det, t, u, v = unguarded_terms(w, ro, rd)
    t = torch.where(_accept(det, t, u, v, t0, t1), t, torch.inf)
    t_hit, tri = t.min(dim=1)
    return torch.isfinite(t_hit), t_hit, tri


def matmul_decisions(scene, cam, cfg):
    """A "cuda" ProgressiveRenderer frame of (scene, cam, cfg) with every
    closest-hit and any-hit query also asked of intersect_matmul /
    occluded_matmul ("ieee") and of the unguarded product ("tf32"): for
    each, the live rays and how many it decides otherwise than the kernels
    (hit mask; face material where both hit), and the live shadow rays and
    how many it occludes otherwise. Summed on the card, read once."""
    import unittest.mock as mock

    from pyrenderer_tpu_torch.core import integrator as integ
    from pyrenderer_tpu_torch.core import intersect as isect
    from pyrenderer_tpu_torch.render import driver as drv

    w = isect.build_tri_matrix(scene)
    mat = scene.face_material
    keys = ("rays", "hit", "material", "shadow_rays", "occluded")
    counts = {k: {c: torch.zeros((), dtype=torch.int64, device=w.device) for c in keys}
              for k in ("ieee", "tf32")}
    closest, any_hit = integ._closest, integ._any_hit

    def both_closest(scene_, tables, cfg_, ro, rd, t1, sort=None):
        hit, t, tri = closest(scene_, tables, cfg_, ro, rd, t1, sort)
        live = t1 > 0
        others = {"ieee": isect.intersect_matmul(scene_, ro, rd, cfg_.t_min, t1, w),
                  "tf32": unguarded_closest(scene_, w, ro, rd, cfg_.t_min, t1)}
        for key, (hit_m, _, tri_m) in others.items():
            c = counts[key]
            c["rays"] += live.sum()
            c["hit"] += ((hit != hit_m) & live).sum()
            c["material"] += (live & hit & hit_m
                              & (mat[tri.long()] != mat[tri_m.long()])).sum()
        return hit, t, tri

    def both_any_hit(scene_, tables, cfg_, ro, rd, t1, sort=None):
        occ = any_hit(scene_, tables, cfg_, ro, rd, t1, sort)
        live = t1 > 0
        det, t, u, v = unguarded_terms(w, ro, rd)
        others = {"ieee": isect.occluded_matmul(scene_, ro, rd, cfg_.t_min, t1, w),
                  "tf32": isect._accept(det, t, u, v, cfg_.t_min, t1).any(dim=1)}
        for key, occ_m in others.items():
            counts[key]["shadow_rays"] += live.sum()
            counts[key]["occluded"] += ((occ != occ_m) & live).sum()
        return occ

    with mock.patch.object(integ, "_closest", both_closest), \
            mock.patch.object(integ, "_any_hit", both_any_hit):
        drv.ProgressiveRenderer(scene, cam, cfg, backend="cuda").run(quiet=True)
    return {key: {k: int(v) for k, v in c.items()} for key, c in counts.items()}


def analytic_phase(dev, card):
    """Phase 28: the analytic tracer through the CLI at its defaults, the
    TF32 guard, and the 64x64 frame against the CPU and the JAX mean."""
    from pyrenderer_tpu_torch import analytic
    from pyrenderer_tpu_torch.render import cli

    phase("28 analytic: CLI at its defaults (400x400, 25 spp, depth 10)")
    with tempfile.TemporaryDirectory() as tmp:
        png, npy = os.path.join(tmp, "analytic.png"), os.path.join(tmp, "analytic.npy")
        ((rc, _), _), wall = timed(lambda: counted(
            lambda: run_cli(cli, ["analytic", "--out", png, "--hdr-out", npy]),
            "CLI analytic frame", {}))
        check(rc == 0, f"cli.main analytic returned {rc}")
        ldr = read_png(png)
        hdr = np.load(npy)
    check(hdr.shape == (400, 400, 3) and ldr.shape == (400, 400, 3),
          f"analytic shapes {hdr.shape}, {ldr.shape}")
    check(bool(np.isfinite(hdr).all()), "the analytic HDR has non-finite values")
    left = ldr[:, :100].reshape(-1, 3).mean(0)
    right = ldr[:, -100:].reshape(-1, 3).mean(0)
    print(f"analytic 400x400 25 spp depth 10: {wall:.3f} s wall (CLI, PNG and .npy included), "
          f"HDR mean {float(hdr.mean())!r}, left wall RGB {left.round(1)}, right wall "
          f"RGB {right.round(1)} ({card})", flush=True)
    check(left[0] > left[1] * 1.15, f"the left wall is not red: {left}")
    check(right[1] > right[0] * 1.15, f"the right wall is not green: {right}")

    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        high = analytic.render(res=(400, 400), spp=25, seed=0, max_depth=10, device=dev)
    finally:
        torch.set_float32_matmul_precision(precision)
    same = bool(np.array_equal(high.cpu().numpy(), hdr))
    print(f"analytic frame under matmul precision 'high' bit-identical to '{precision}': "
          f"{same}", flush=True)
    check(same, "the analytic frame depends on the float32 matmul precision")

    # one sample of that frame (160,000 rays, 10 bounces), unprofiled then
    # under torch.profiler: the device's busy union against the wall
    from pyrenderer_tpu_torch.utils.profiling import device_busy

    def one_sample():
        ro, rd, pixel, sample = analytic.camera_rays((400, 400), 0, 0, device=dev)
        return analytic.trace(ro, rd, pixel, sample, 0, max_depth=10)

    _, t_sample = timed(one_sample)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        timed(one_sample)
    busy_us, _, n_events = device_busy(prof.events())
    check(n_events > 0, "analytic: torch.profiler saw no device activity")
    print(f"analytic sample 400x400 depth 10: {t_sample * 1e3:.1f} ms wall, {n_events} device "
          f"kernels, device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / t_sample:.4f} (against the unprofiled sample) ({card})",
          flush=True)

    frame = {where: analytic.render(res=(64, 64), spp=25, seed=0, max_depth=10,
                                    device=where).cpu().numpy() for where in (dev, "cpu")}
    close = float(np.isclose(frame[dev], frame["cpu"], rtol=1e-3, atol=1e-6).mean())
    mean = float(frame[dev].mean())
    rel = abs(mean - JAX_MEAN_RADIANCE_ANALYTIC_64) / JAX_MEAN_RADIANCE_ANALYTIC_64
    print(f"analytic 64x64 25 spp depth 10 seed 0: GPU vs CPU close fraction {close:.6f} "
          f"(>= 0.99); mean {mean!r}, CPU {float(frame['cpu'].mean())!r}, JAX CPU "
          f"{JAX_MEAN_RADIANCE_ANALYTIC_64!r}, relative diff {rel:.3g} "
          f"(<= {ANALYTIC_MEAN_TOL})", flush=True)
    check(close >= 0.99, "the analytic GPU and CPU frames disagree")
    check(rel <= ANALYTIC_MEAN_TOL, "the analytic mean radiance is off")


def debug_path_phases(dev, card):
    """Phase 29: the debug path records through the CLI and log_paths, on
    the whole-table kernels (B1/B2) and the cluster sweep (B3/B4)."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.camera import generate_rays
    from pyrenderer_tpu_torch.core.integrator import trace_reference
    from pyrenderer_tpu_torch.debug.logger import log_paths
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.scene import load_tungsten, procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    phase("29 debug paths: CLI --debug-paths on Cornell, log_paths at 1024x1024, "
          "the CPU twins, terrain8k with the wavefront sort")
    host, host_cam, scene_cfg = load_tungsten(SCENE)
    bounces = scene_cfg.max_bounces
    with tempfile.TemporaryDirectory() as tmp:
        html = os.path.join(tmp, "paths.html")
        ((rc, log), _), wall = timed(lambda: counted(
            lambda: run_cli(cli, [SCENE, "--debug-paths", html]), "CLI --debug-paths",
            {"closest_hit": bounces, "occluded": bounces}))
        check(rc == 0, f"cli.main --debug-paths returned {rc}")
        check("(49 paths)" in log, "the CLI did not report 49 paths")
        with open(html) as fh:
            m = re.search(r"const DATA = (\{.*?\});\n", fh.read(), re.S)
        check(m is not None, "no DATA in the HTML")
        data = json.loads(m.group(1))
        with open(os.path.join(tmp, "paths.ply")) as fh:
            ply = fh.read()
    check(len(data["paths"]) == 49 and len(data["wire"]) > 0 and data["radius"] > 0,
          f"HTML: {len(data['paths'])} paths, {len(data['wire'])} wire edges")
    check(ply.startswith("ply\nformat ascii 1.0\nelement vertex ") and "element edge" in ply,
          "PLY header")
    print(f"CLI --debug-paths: {bounces} bounces, 49 paths, {len(data['shadow'])} shadow "
          f"rays, {len(data['wire'])} wire edges in {wall:.3f} s ({card})", flush=True)

    cfg = RenderConfig(max_bounces=4, seed=0, estimator="reference")
    res = host_cam.resolution[0]
    scene, cam = to_device(host, host_cam._replace(resolution=(res, res)), dev)
    ys, xs = np.mgrid[0:res, 0:res]
    px, py = xs.reshape(-1), ys.reshape(-1)
    records, wall = timed(lambda: counted(lambda: log_paths(scene, cam, cfg, px, py),
                                          f"log_paths {res}x{res}",
                                          {"closest_hit": 4, "occluded": 4})[0])
    px_t, py_t = (torch.as_tensor(a, device=dev) for a in (px, py))
    ro, rd = generate_rays(cam, px_t, py_t, 0, cfg.seed)
    rad = trace_reference(scene, cfg, ro, rd, py_t * res + px_t, 0, cfg.seed).cpu().numpy()
    check(records.hit_point.shape == (4, res * res, 3), f"records {records.hit_point.shape}")
    same = bool(np.array_equal(records.radiance[-1], rad))
    print(f"log_paths {res}x{res} 4 bounces: {wall:.3f} s ({card}); last-bounce radiance "
          f"bit-identical to trace_reference: {same}", flush=True)
    check(same, "log_paths' radiance differs from trace_reference's")

    ys, xs = np.mgrid[0:64, 0:64]
    cam64 = host_cam._replace(resolution=(64, 64))
    logs = {where: log_paths(*to_device(host, cam64, where), cfg, xs.reshape(-1),
                             ys.reshape(-1)) for where in (dev, "cpu")}
    hit_eq = float((logs[dev].hit == logs["cpu"].hit).mean())
    tri_eq = float((logs[dev].tri == logs["cpu"].tri).mean())
    print(f"log_paths 64x64 GPU vs CPU twins: hit equal {hit_eq:.6f}, tri equal {tri_eq:.6f} "
          "(>= 0.999)", flush=True)
    check(hit_eq >= 0.999 and tri_eq >= 0.999, "GPU and CPU path records disagree")

    host8, cam8, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    scene8, cam8 = to_device(host8, cam8._replace(resolution=(64, 64)), dev)
    cfg8 = RenderConfig(max_bounces=4, seed=0, estimator="reference", cluster_sort=True)
    cluster = {"cluster_closest_hit": 4, "cluster_occluded": 4}
    saved = os.environ.get("PYRENDERER_WF_SORT")
    wf = {}
    try:
        for flag in ("1", "0"):
            os.environ["PYRENDERER_WF_SORT"] = flag
            wf[flag], _ = counted(
                lambda: log_paths(scene8, cam8, cfg8, xs.reshape(-1), ys.reshape(-1),
                                  backend="cluster"),
                f"log_paths terrain8k cluster, PYRENDERER_WF_SORT={flag}", cluster)
    finally:
        if saved is None:
            os.environ.pop("PYRENDERER_WF_SORT", None)
        else:
            os.environ["PYRENDERER_WF_SORT"] = saved
    differ = [k for k in wf["0"].__dataclass_fields__
              if not np.array_equal(getattr(wf["1"], k), getattr(wf["0"], k))]
    print(f"log_paths terrain8k 64x64 4 bounces, PYRENDERER_WF_SORT=1 against =0: records "
          f"that differ {differ}; hits per bounce {wf['0'].hit.sum(axis=1).tolist()}",
          flush=True)
    check(not differ, f"wavefront-sorted records differ: {differ}")


def golden_errors(hdr, gt):
    """(whole-image mean, worst channel mean, 8x8-block mean) relative
    errors of a 64x64 linear frame against the 256x256 ground truth
    box-downsampled to 64x64 (tests/test_torch_golden.py hdr_errors)."""
    gt64 = gt.reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
    mean_rel = abs(hdr.mean() - gt64.mean()) / gt64.mean()
    chan = gt64.reshape(-1, 3).mean(0)
    chan_rel = np.abs(hdr.reshape(-1, 3).mean(0) - chan) / chan
    ours8 = hdr.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3))
    gt8 = gt64.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3))
    block_rel = (np.abs(ours8 - gt8) / np.maximum(gt8, 1e-3)).mean()
    return float(mean_rel), float(chan_rel.max()), float(block_rel)


def golden_phase(dev, card):
    """Phase 30: the pbrt estimator on the card against the Tungsten
    renderer's linear EXR."""
    from pyrenderer_tpu_torch.core.integrator import render_image
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device
    from pyrenderer_tpu_torch.utils.exr import read_exr

    phase("30 golden HDR: Cornell, pbrt, 64x64, 32 spp, 8 bounces, seed 1, against Tungsten")
    host, host_cam, cfg = load_tungsten(SCENE)
    scene, cam = to_device(host, host_cam._replace(resolution=(64, 64)), dev)
    cfg = cfg.replace(spp=32, max_bounces=8, estimator="pbrt", seed=1)
    expect = cfg.spp * cfg.max_bounces
    hdr, _ = counted(lambda: render_image(scene, cam, cfg), "golden pbrt frame",
                     {"closest_hit": expect, "occluded": expect})
    hdr = hdr.cpu().numpy().astype(np.float64)
    gt = read_exr(os.path.join(ROOT, "tests", "data", "tungsten_gt_256.exr")).astype(np.float64)
    check(gt.shape == (256, 256, 3), f"ground truth shape {gt.shape}")
    mean_rel, chan_rel, block_rel = golden_errors(hdr, gt)
    print(f"golden HDR against Tungsten: mean {mean_rel:.4%} (< 3%), worst channel "
          f"{chan_rel:.4%} (< 5%), 8x8 blocks {block_rel:.4f} (< 0.08) ({card})", flush=True)
    check(mean_rel < 0.03 and chan_rel < 0.05 and block_rel < 0.08,
          "the pbrt frame is off the Tungsten ground truth")


def spawn(cmds, label, timeout):
    """Start every command at once from the repo's root, wait for all of
    them within `timeout` seconds, kill the survivors; check that each
    exited 0. Returns their standard outputs. Outputs go to files, not
    pipes: a rank blocked in a collective must not wait on a full pipe."""
    with tempfile.TemporaryDirectory() as logs:
        procs = []
        try:
            for i, cmd in enumerate(cmds):
                out = open(os.path.join(logs, f"{i}.out"), "w+")
                err = open(os.path.join(logs, f"{i}.err"), "w+")
                procs.append((subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err), out, err))
            deadline = time.monotonic() + timeout
            for p, _, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"check failed: {label}: a rank outlived {timeout} s")
        finally:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for i, (p, out, err) in enumerate(procs):
            out.seek(0)
            err.seek(0)
            text, etext = out.read(), err.read()
            out.close()
            err.close()
            check(p.returncode == 0, f"{label}: rank {i} exited {p.returncode}:\n{text[-2000:]}"
                                     f"\n{etext[-4000:]}")
            texts.append(text)
        return texts


def worker_results(texts):
    """The RESULT line of each dist.worker rank, parsed."""
    out = []
    for text in texts:
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        check(len(lines) == 1, f"a worker printed {len(lines)} RESULT lines")
        out.append(json.loads(lines[0][len("RESULT "):]))
    return out


def worker_cmd(rank, world, init, flags, out=None):
    cmd = [sys.executable, "-m", "pyrenderer_tpu_torch.dist.worker", SCENE,
           "--coordinator", init, "--num-processes", str(world), "--process-id", str(rank),
           "--backend", "gloo"] + flags
    return cmd + (["--out", out] if out else [])


def gp_rank(rank: int, world: int, init: str, out_dir: str) -> int:
    """One rank of phase 33, started by dist_phases as
    python -c "import chip_smoke; chip_smoke.gp_rank(...)": the Cornell and
    terrain100k frames at gp = world over gloo on the card. Each frame is a
    counting window. Rank 0 saves the assembled images (and render_field's
    Cornell frame, after the windows); every rank writes its counts and
    walls to out_dir/rank{rank}.json."""
    import torch.distributed as dist

    from pyrenderer_tpu_torch import kernels
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.dist import multihost
    from pyrenderer_tpu_torch.dist.geometry import (build_shard_clusters, make_geom_mesh,
                                                    render_field_geometry_sharded)
    from pyrenderer_tpu_torch.dist.render import all_gather, axis_index, pixel_grid, render_field
    from pyrenderer_tpu_torch.scene import load_tungsten, procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    multihost.initialize(init, world, rank, backend="gloo")
    try:
        dev = multihost.rank_device()
        mesh = make_geom_mesh(gp=world)
        g = axis_index(mesh, "gp")
        result = {"rank": rank, "device": torch.cuda.get_device_name(dev)}
        cfg = RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference")

        def frame(scene, camera, cluster_stack=None):
            px, py = pixel_grid(camera)
            torch.cuda.synchronize(dev)
            kernels.reset_counters()
            t = time.perf_counter()
            with torch.no_grad():
                part = render_field_geometry_sharded(scene, camera, cfg, mesh, px, py,
                                                     cluster_stack=cluster_stack)
                full = all_gather(part).flatten(0, 1)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            launches, twins = kernels.counts()
            w, h = camera.resolution
            img = full.cpu().numpy().reshape(h, w, 3)[::-1]
            return img, {"wall_s": wall, "launches": launches, "twin_calls": twins}

        host, host_cam, _ = load_tungsten(SCENE)
        scene, camera = to_device(host, host_cam._replace(resolution=(256, 256)), dev)
        img, result["cornell"] = frame(scene, camera)
        if rank == 0:
            px, py = pixel_grid(camera)
            with torch.no_grad():
                ref = render_field(scene, camera, cfg, px, py).cpu().numpy()
            np.save(os.path.join(out_dir, "cornell.npy"), img)
            np.save(os.path.join(out_dir, "cornell_ref.npy"), ref.reshape(256, 256, 3)[::-1])

        # terrain100k at gp = 2: each shard keeps ~390 clusters, at least
        # AUTO_SORT_MIN_CLUSTERS = 256, so each resolves its sort and its
        # watertight leaves on, as phase 7's un-sharded frame does (at gp = 4
        # the shards would fall below it and take Moeller-Trumbore leaves)
        host, host_cam, _ = build_scene(procgen.big_scene_data("terrain", res=224))
        scene, camera = to_device(host, host_cam._replace(resolution=(512, 512)), dev)
        t = time.perf_counter()
        cs = build_shard_clusters(scene, world, rank=g)
        result["shard"] = {"triangles": -(-host.faces.shape[0] // world),
                           "clusters": cs.n_clusters, "build_s": time.perf_counter() - t}
        img, result["terrain"] = frame(scene, camera, cs)
        if rank == 0:
            np.save(os.path.join(out_dir, "terrain.npy"), img)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        return 0
    finally:
        dist.destroy_process_group()


def dist_phases(dev, card, hdr_cornell, host_scene, host_camera, ctx):
    """Phases 31-33: the sharded renders and train steps (dist/)."""
    import torch.distributed as dist

    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.dist import multihost
    from pyrenderer_tpu_torch.dist.render import (gather_dp, make_mesh, pixel_grid, render_field,
                                                  render_field_sharded, train_step)
    from pyrenderer_tpu_torch.scene import to_device

    phase("31 a world of one NCCL rank: render_field_sharded and train_step(mesh=...) at "
          "dp = sp = 1, Cornell 256x256, 4 spp, 4 bounces")
    check(multihost.initialize() is False and dist.get_backend() == "nccl",
          "initialize() did not bring up a world of one NCCL rank")
    try:
        mesh = make_mesh(dp=1, sp=1)
        scene, camera = to_device(host_scene, host_camera._replace(resolution=(256, 256)), dev)
        cfg = RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference")
        px, py = pixel_grid(camera)
        with torch.no_grad():
            block, _ = counted(lambda: render_field_sharded(scene, camera, cfg, mesh, px, py),
                               "dp x sp render, world of one", {"closest_hit": 16, "occluded": 16})
            full = gather_dp(block, mesh)
            ref = render_field(scene, camera, cfg, px, py)
        check(torch.equal(full, ref), "render_field_sharded at dp = sp = 1 differs from "
              f"render_field (max |diff| {float((full - ref).abs().max()):.3g})")
        params = (scene.vertices, scene.albedo, scene.emission)
        target = torch.zeros_like(ref)
        lr = (1e-3, 0.5, 0.1)
        (loss_m, new_m), _ = counted(
            lambda: train_step(params, scene, camera, cfg, target, px, py, lr, mesh=mesh),
            "train_step, world of one", {"closest_hit": 16, "occluded": 16})
        loss_1, new_1 = train_step(params, scene, camera, cfg, target, px, py, lr)
        _, new_2 = train_step(params, scene, camera, cfg, target, px, py, lr)
        check(torch.equal(loss_m, loss_1), f"train_step(mesh=...) loss {float(loss_m)!r}, "
              f"train_step() {float(loss_1)!r}")
        # the backward's scatters (index_select's, index_put's) add with
        # atomics on the card, in no fixed order: two train_step() calls
        # differ in the last bits (the albedo's step by up to ~1e-5 of the
        # largest on an H100), so the steps are compared to 1e-4 of the
        # largest, beside that run-to-run spread
        diffs, spread = [], []
        for p0, a, b, c in zip(params, new_m, new_1, new_2):
            # a step of 0 (the reference estimator's emission) must stay 0
            step = float((b - p0).abs().max()) or 1.0
            diffs.append(float(((a - p0) - (b - p0)).abs().max()) / step)
            spread.append(float(((c - p0) - (b - p0)).abs().max()) / step)
        check(max(diffs) <= 1e-4, f"train_step(mesh=...) steps off train_step()'s by {diffs} "
              f"of the largest (two train_step() calls: {spread})")
        print(f"world of one ({dist.get_backend()}): render_field_sharded bit-identical to "
              f"render_field; train_step(mesh=...) loss {float(loss_m)!r} bit-identical to "
              f"train_step()'s, its steps within {diffs} of the largest (two train_step() "
              f"calls: {spread})", flush=True)
    finally:
        dist.destroy_process_group()

    phase("32 dp x sp: four dist.worker ranks on the card over gloo, dp = 2, sp = 2, Cornell "
          "1024x1024, reference, 4 bounces, 16 spp; then train steps, dp = 2")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "img.npy")
        init = "file://" + os.path.join(tmp, "pg")
        flags = ["--res", "1024", "--spp", "16", "--depth", "4", "--sp", "2"]
        t = time.perf_counter()
        res = worker_results(spawn([worker_cmd(r, 4, init, flags, out if r == 0 else None)
                                    for r in range(4)], "dp x sp workers", 300))
        wall = time.perf_counter() - t
        img = np.load(out)
    check(img.shape == hdr_cornell.shape, f"assembled image {img.shape}")
    close = np.isclose(img, hdr_cornell, rtol=2e-5, atol=1e-6)
    check(bool(close.all()), f"dp x sp image: {int((~close).sum())} values off phase 3's HDR "
          f"(max |diff| {float(np.abs(img - hdr_cornell).max()):.3g})")
    for r in res:
        check(r["device"] == torch.cuda.get_device_name(0) and r["backend"] == "gloo"
              and r["global_devices"] == 4, f"rank {r['process_id']}: {r}")
        check(r["launches"] == {"closest_hit": 512, "occluded": 512} and not r["twin_calls"],
              f"rank {r['process_id']}: launches {r['launches']}, twins {r['twin_calls']}")
        check(r["image_mean"] == res[0]["image_mean"], "the ranks' frames differ")
        TALLY.update(r["launches"])
    print(f"dp x sp frame equal to phase 3's HDR at rtol 2e-5, atol 1e-6 (max |diff| "
          f"{float(np.abs(img - hdr_cornell).max()):.3g}); each rank 512 launches of each "
          "whole-table kernel", flush=True)
    for r in res:
        print(f"rank {r['process_id']}: {r['time_s']:.3f} s a frame, {r['mrays_per_s']:.3f} "
              f"Mrays/s (dp = 2 x sp = 2, four gloo ranks sharing one {card})", flush=True)
    print(f"wall of the four worker processes {wall:.3f} s (start-up, warm-up frame, timed "
          f"frame, ray count; {card})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "pg")
        flags = ["--res", "1024", "--spp", "1", "--depth", "4", "--train-steps", "1"]
        one = [sys.executable, "-m", "pyrenderer_tpu_torch.dist.worker", SCENE] + flags
        t = time.perf_counter()
        res = worker_results(spawn([worker_cmd(r, 2, init, flags) for r in range(2)] + [one],
                                   "train-step workers", 300))
        wall = time.perf_counter() - t
    two, single = res[:2], res[2]
    check(single["backend"] == "nccl" and not single["multi"],
          f"the one-process worker ran {single['backend']}")
    for r in two:
        for key in ("train_losses", "grad_mean_abs"):
            check(np.allclose(r[key], single[key], rtol=1e-5, atol=0),
                  f"rank {r['process_id']} {key} {r[key]} against one process {single[key]}")
    for r in res:
        TALLY.update(r["launches"])
    print(f"train step at dp = 2 over gloo: losses {two[0]['train_losses']}, grad_mean_abs "
          f"{two[0]['grad_mean_abs']}; one NCCL process: {single['train_losses']}, "
          f"{single['grad_mean_abs']} (rtol 1e-5); wall of the three processes {wall:.3f} s "
          f"({card})", flush=True)

    phase("33 gp: two ranks on the card over gloo, Cornell 256x256 through B1/B2 per shard, "
          "then terrain100k 512x512, 4 spp, 4 bounces through B3/B4 per shard")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "pg")
        cmds = [[sys.executable, "-c", "import sys, chip_smoke; "
                 f"sys.exit(chip_smoke.gp_rank({r}, 2, {init!r}, {tmp!r}))"] for r in range(2)]
        t = time.perf_counter()
        spawn(cmds, "gp ranks", 300)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        cornell = np.load(os.path.join(tmp, "cornell.npy"))
        cornell_ref = np.load(os.path.join(tmp, "cornell_ref.npy"))
        terrain = np.load(os.path.join(tmp, "terrain.npy"))
    for r in ranks:
        check(r["device"] == torch.cuda.get_device_name(0), f"rank {r['rank']} on {r['device']}")
        check(r["cornell"]["launches"] == {"closest_hit": 16, "occluded": 16}
              and not r["cornell"]["twin_calls"], f"rank {r['rank']}: Cornell {r['cornell']}")
        check(r["terrain"]["launches"] == {"cluster_closest_hit": 64, "cluster_occluded": 64}
              and not r["terrain"]["twin_calls"], f"rank {r['rank']}: terrain {r['terrain']}")
        TALLY.update(r["cornell"]["launches"])
        TALLY.update(r["terrain"]["launches"])
    close = np.isclose(cornell, cornell_ref, rtol=2e-5, atol=2e-6)
    check(bool(close.all()), f"gp Cornell frame: {int((~close).sum())} values off render_field")
    hdr7 = ctx["hdr_cluster"]
    frac = float(np.isclose(terrain, hdr7, rtol=1e-3, atol=1e-4).mean())
    rel = abs(float(terrain.mean()) - float(hdr7.mean())) / float(hdr7.mean())
    check(terrain.shape == hdr7.shape and frac > 0.99 and rel < 1e-3,
          f"gp terrain frame against phase 7's: close fraction {frac}, mean relative {rel}")
    secs = max(r["terrain"]["wall_s"] for r in ranks)
    print(f"gp Cornell frame within rtol 2e-5, atol 2e-6 of render_field (max |diff| "
          f"{float(np.abs(cornell - cornell_ref).max()):.3g}), 16 launches of each whole-table "
          f"kernel a rank; walls {[r['cornell']['wall_s'] for r in ranks]} s", flush=True)
    print(f"gp terrain100k frame: shards of {ranks[0]['shard']['triangles']} triangles, "
          f"{ranks[0]['shard']['clusters']} clusters each; close fraction {frac:.6f} (> 0.99), "
          f"mean relative {rel:.3g} (< 1e-3); 64 launches of each cluster kernel a rank",
          flush=True)
    print(f"gp terrain100k frame: {secs:.3f} s wall, {ctx['rays_cluster'] / secs / 1e6:.3f} "
          f"Mrays/s (phase 7's rays; two gloo ranks sharing one {card}); phase 7 un-sharded "
          f"{ctx['mrays_cluster']:.3f} Mrays/s; wall of the two processes {wall:.3f} s",
          flush=True)


# phase 34: the stage-breakdown harnesses (perf/estbench.py ... binnedgran.py)
Q1 = {"closest_hit": 1, "occluded": 1}
Q4 = {"closest_hit": 4, "occluded": 4}
SWEEP1 = {"cluster_closest_hit": 1}

# (module, argv at the harness's own width, the kernel launches of one call
# of each row that launches any, the rule each row's output is held to on
# the card against the CPU, the rays of that comparison)
HARNESSES = (
    ("estbench", ["--reps", "2", "--no-profile"],
     {"trace4_full": Q4, "pbrt_trace4_full": Q4, "kernel_pair": Q1},
     {"fetch_light": "close", "shade": "close", "camera": "close", "trace4_full": "frame",
      "trace4_stub": "frame", "pbrt_trace4_full": "frame", "pbrt_trace4_stub": "frame"}, 4096),
    ("microbench", ["--reps", "2", "--no-profile"],
     {"cuda_closest": {"closest_hit": 1}, "cuda_occluded": {"occluded": 1},
      "trace_4bounce_cuda": Q4},
     {"intersect_matmul": "frame", "intersect_brute": "frame", "occluded_matmul": "frame",
      "frame_math": "close", "trace_4bounce_cuda": "frame", "camera_raygen": "close"}, 4096),
    ("ablate", ["--reps", "2", "--no-profile"],
     {"full_4bounce": Q4, "isect_only_4x2": Q4},
     {"full_4bounce": "frame", "isect_only_4x2": "frame", "fetch_only_4x": "close",
      "rng_frame_4x": "close"}, 4096),
    ("glue2", ["--reps", "2", "--no-profile"],
     {"wrap_full": SWEEP1, "wrap_bare": SWEEP1},
     {"wrap_full": "close", "bounce4x": "frame"}, 2048),
    ("binnedglue", ["--reps", "2", "--no-profile"],
     {"prepass": {"binned_prepass": 1}, "leaf": {"binned_leaf": 1},
      "peel": {"binned_peel": 1}, "leaf_streamed": {"binned_leaf_streamed": 1},
      "resid_sweep": SWEEP1, "sweep_sorted": SWEEP1,
      "core_resident": {"binned_prepass": 1, "binned_leaf": 1}},
     {"exact_t": "close"}, 8192),
)


def run_harness(mod, argv):
    """mod.main(argv) in this process, its output echoed; returns its JSON
    line."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    sys.stdout.write(buf.getvalue())
    check(rc == 0, f"{mod.__name__}.main({argv}) returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def streamed_launches(x):
    """The launches of one streamed core on binnedglue's inputs, counted by
    running its rounds through the twins (plain torch, here on the card):
    one prepass, a peel per round after the first, a leaf per round with a
    pair."""
    from pyrenderer_tpu_torch.kernels import binned as kb
    from pyrenderer_tpu_torch.perf.binnedglue import T0

    ids, ovf, words = kb.prepass_ref(x.cs, x.rays, T0, x.w_streamed, emit_words=True)
    out = collections.Counter(binned_prepass=1)
    while True:
        out["binned_leaf_streamed"] += int(bool((ids != kb.SENTINEL).any()))
        if not bool(ovf.any()):
            return dict(out)
        ids, ovf, words = kb.peel_ref(words, x.w_streamed)
        out["binned_peel"] += 1


def hold_output(card_out, cpu_out, rule, label):
    """A stage's output on the card against the same stage on the CPU:
    "bits" bit for bit; "close" at rtol 1e-4, atol 1e-6 (the CPU tests'
    tolerance for shading arithmetic); "frame" by PERF.md's GPU-against-CPU
    criterion (> 95% of the values close at rtol 1e-3, atol 1e-4, median
    |diff| < 1e-5; boolean and integer outputs equal on > 99%)."""
    if isinstance(card_out, (tuple, list)):
        check(len(card_out) == len(cpu_out), f"{label}: outputs differ in number")
        for k, (a, b) in enumerate(zip(card_out, cpu_out)):
            hold_output(a, b, rule, f"{label}[{k}]")
        return
    if not torch.is_tensor(card_out):
        check(card_out == cpu_out, f"{label}: {card_out} != {cpu_out}")
        return
    a, b = card_out.detach().cpu(), cpu_out.detach()
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{label}: {a.dtype} {tuple(a.shape)} against {b.dtype} {tuple(b.shape)}")
    if rule == "bits" or not a.is_floating_point():
        if rule == "frame" and a.numel():
            frac = float((a == b).float().mean())
            check(frac > 0.99, f"{label}: equal on {frac:.6f} (> 0.99)")
            return
        same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
            if a.dtype == torch.float32 else torch.equal(a, b)
        check(same, f"{label}: differs in {int((a != b).sum())} of {a.numel()} values")
        return
    if rule == "close":
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
              f"{label}: max |diff| {float((a - b).abs().max()):.3g}")
        return
    close = float(torch.isclose(a, b, rtol=1e-3, atol=1e-4).float().mean())
    med = float((a - b).abs().median())
    check(close > 0.95 and med < 1e-5, f"{label}: close {close:.6f}, median |diff| {med:.3g}")


def harness_phase(dev, card):
    """Phase 34: every stage-breakdown harness at its own width."""
    import importlib

    from pyrenderer_tpu_torch.perf import binnedgran

    phase("34 the harnesses: estbench (262,144 rays, both estimators), microbench and "
          "ablate (2^20), glue2 (262,144, tables of 8,204 and 100,364 rows), binnedglue "
          "(terrain100k), binnedgran (BIN = 4, 1, 2)")
    t_phase = time.perf_counter()
    for name, argv, launches, rules, n_cmp in HARNESSES:
        mod = importlib.import_module(f"pyrenderer_tpu_torch.perf.{name}")
        t = time.perf_counter()
        result, _ = counted(lambda: run_harness(mod, argv), f"{name} run")
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
        check(result["card"] == card, f"{name}: card {result['card']!r}")
        x_card = mod.inputs(dev, n_cmp)
        x_cpu = (mod.inputs("cpu", n_cmp, backend="cuda") if name == "microbench"
                 else mod.inputs("cpu", n_cmp))
        if name == "binnedglue":
            launches = dict(launches, core_streamed=streamed_launches(mod.inputs(dev)))
        rows = {r["name"]: r for r in result["rows"]}
        stages_card, stages_cpu = mod.stages(x_card), mod.stages(x_cpu)
        check(sorted(rows) == sorted(s[0] for s in stages_card),
              f"{name}: rows {sorted(rows)}")
        for row_name, row in rows.items():
            check(np.isfinite(row["eager_ms"]) and row["eager_ms"] > 0,
                  f"{name} {row_name}: eager ms {row['eager_ms']}")
            want = launches.get(row_name, {})
            check(row["launches"] == want,
                  f"{name} {row_name}: launches {row['launches']}, expected {want}")
            check(row["twin_calls"] == {}, f"{name} {row_name}: twin calls {row['twin_calls']}")
        for (row_name, fn, args, *_), (_, fn_cpu, args_cpu, *_) in zip(stages_card, stages_cpu):
            hold_output(fn(*args), fn_cpu(*args_cpu), rules.get(row_name, "bits"),
                        f"{name} {row_name} card against CPU")
        print(f"{name}: {len(rows)} rows, launches exact, outputs held against the CPU at "
              f"{n_cmp} rays; {time.perf_counter() - t:.1f} s with the comparison", flush=True)
        del x_card, x_cpu, stages_card, stages_cpu
        torch.cuda.empty_cache()
    t = time.perf_counter()
    result = run_harness(binnedgran, ["--reps", "2", "--timeout", "180"])
    launches, twins = result["launches_total"], result["twin_calls_total"]
    print(f"binnedgran children: launches {launches}, twin calls {twins}", flush=True)
    check(not twins, f"binnedgran: twin calls {twins}")
    TALLY.update(launches)
    print(f"binnedgran: {time.perf_counter() - t:.1f} s", flush=True)
    check(result["failed"] == [] and [r["bin"] for r in result["rows"]] == [4, 1, 2],
          f"binnedgran: rows {result['rows']}, failed {result['failed']}")
    for row in result["rows"]:
        check(row["hit_agree"] == 1.0, f"binnedgran BIN={row['bin']}: hit agreement "
                                        f"{row['hit_agree']}")
        check(row["launches"] == {"binned_prepass": 1, "binned_leaf": 1}
              and row["twin_calls"] == {},
              f"binnedgran BIN={row['bin']}: launches {row['launches']}, twins "
              f"{row['twin_calls']}")
        check(np.isfinite(row["core_ms"]) and row["core_ms"] > 0,
              f"binnedgran BIN={row['bin']}: core ms {row['core_ms']}")
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


def run_cli(cli, argv):
    """cli.main(argv) in-process; returns (exit code, its stderr), echoing it."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    sys.stderr.write(buf.getvalue())
    return rc, buf.getvalue()


if __name__ == "__main__":
    sys.exit(main())
