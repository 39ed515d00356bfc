#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (owl_path_tracer_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py            # main path at spp 8
    python3 chip_smoke.py --spp 64   # the headline spp

Phases (one line each, with times; any failure exits non-zero):
  1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build the kernels from csrc/ (nvcc, sm_90a; the three sources in
     parallel, csrc/tensor_ops.cuh included by two), with ptxas' registers
     per entry and the HMMA (tensor-core) instruction count of each MXU
     instantiation in the SASS (cuobjdump): the tensor-core forms (K1b, and
     K4 on f32 planes) hold some, the exact CUDA-core forms none; threads,
     CTAs per block of rays, registers, shared bytes (with the form of the
     frontier row that launches) and blocks per SM of each component entry
     (the slot-parallel K1-K4 and the serial yardsticks) at dragon7's K and
     C;
  3. kernel vs plain version on a small triangle soup, blocks 128 and 256,
     per-ray t_max, padding rays, and max_steps=1 (unresolved blocks);
  4. kernel vs plain version at the main path's shapes: the dragon scene at
     icosphere subdivision 7 (~328k triangles), one 131072-ray wave of
     primaries through the image centre and the bounce wave the port's own
     trace_bounce makes of it (K1; K4 on the bounce wave): every column equal
     bit for bit to the serial body's (component_wave), the profile entry's
     clock64 split of both bodies (slowest and mean block), resources, the
     slot-parallel body timed in turns with the serial one (serial, new, new,
     serial; CUDA events), the plain version's time, the fp32-peak bound and
     the no-FMA ceiling;
  3b. the any-hit (K2) and mixed (K3) modes vs their plain versions on the
     soup: blocks 128 and 256, per-ray t_max, max_steps=1;
  4b. K2 and K3 vs plain at the NEE path's shapes (cornell-box, C=512,
     cid2): a 131072-ray wave of shadow rays from the bounce wave's vertices
     toward sample_lights points, and the 262144-ray mixed wave the deferred
     form traces (those bounce rays plus those shadow rays); as phase 4 (K2
     has no serial entry: its serial body runs through the profile entry and
     is not timed);
  5. frame parity: cornell-box 64x64, spp 4, depth 4, rendered on the GPU
     and through the port on the CPU (plain version), golden rule;
  5b. the same with NEE, both forms, card vs CPU, and the deferred form vs
     the separate one on the card;
  6. main path: dragon sub 7, 1024x1024, depth 4, auto sky, 131072 lanes,
     block 256, sort on; kernel launch counts are reset just before it;
  6b. the NEE main path: cornell-box 1024x1024, depth 4, NEE on, 131072
     lanes, block 256, sort on (cid2), once separate (fused_nee=False) and
     once deferred (fused_nee=True), counts reset just before each.
Phases 3-6b run the component layout (kernels K1-K3), built explicitly with
build_fused2_scene(mxu=False).  The MXU feature layout (make_accel's
"fused2" with f32 planes and "fused2-bf16"; kernel K1b, fanout 2) and the
no-attributes closest hit (K4) follow:
  3c. K1b (f32 and bf16 planes; closest, any-hit, mixed) and K4 (component
     and MXU f32) vs their plain versions on the soup: blocks 128 and 256,
     fanout 1 and 2 (bit-identical), per-ray t_max, padding rays,
     max_steps=1 through the wrappers; bf16 + no attributes raises; the
     tensor-core entries (bf16 products; f32: 3xTF32; K4 on f32 planes too,
     its loop t/u/v within the sums' rounding) under compare_near_tie's
     rounding kind and the exact CUDA-core closest hits (with and without
     attributes) equal to the plain version;
  4c. the same at the main path's shapes, CUDA events: the dragon primary and
     bounce waves on fused2-bf16 and fused2 (K1b closest, and K4 on the
     bounce wave on fused2; the exact form and the tensor-core form timed in
     turns, exact, tensor, tensor, exact, with the fp32-peak and TF32
     bounds),
     the cornell shadow wave (any-hit) and 262144-ray mixed wave on
     fused2-bf16 and fused2; registers, shared memory, blocks per SM and
     HMMA count of each K1b entry at the dragon's K and C; on fused2 the
     worst |tensor-core sum - plain sum| / sum |terms| over every slot of
     8192 rays' clusters (the diagnostic entry fused2.mxu_tensor_sums)
     beside SUM_GAMMA_F32;
  5c. frame parity on fused2-bf16 and fused2, card vs CPU: cornell-box 64x64
     spp 4, without NEE and with NEE in both forms; on fused2 the dragon at
     128x128 spp 2;
  6c. the headline main path (phase 6's configuration) on fused2-bf16 and on
     fused2, then the cornell NEE path (phase 6b's) on fused2-bf16 and on
     fused2, separate and deferred; counts reset just before each; then
     phase 6's frame rendered twice on fused2 and on the component layout,
     the films compared bit for bit.
The fused kernel (K5, make_accel("fused"), clusters of C=128) under the scan
renderer (render/film.py) and the CLI:
  3d. K5 vs its plain version on the soup (C=64): blocks 128 and 256, per-ray
     and scalar t_max with padding rays, columns 0-6 identical; max_steps=1
     through fused_closest_hit leaves rows unresolved and the wrapper's
     answers equal the CPU wrapper's;
  4d. K5 vs plain at the main path's shapes: dragon sub 7 on
     make_accel("fused"), the 65536-ray primary wave of add_samples' first
     pixel chunk and the bounce wave trace_bounce makes of it, then the same
     for the chunk through the image centre; CUDA events; then dragon sub 8
     (~1.3M triangles, K above the 9,088 clusters K5 took while its block
     held the boxes in shared memory): the centre chunk's bounce wave, the
     kernel on all 65536 rays, the plain version on every 8th block;
     registers, shared memory and blocks per SM of K5 at both K and for
     both list-scan kinds; on both centre bounce waves both scan kinds
     (serial, and group skips with warp rescans) equal to the plain version,
     split per block by the profile entry's clock64 (set-up scan, pick and
     stage, slot loop, list updates and rescans), with rescans and boxes
     slab-tested per ray and per block, and timed in turns with the serial
     scan; the group-skip set-up scan's box count equal to the plain list
     scan's (fused.nearest_lists);
  4e. the fused2 kernels above their old cluster limit (the frontier row
     [K] of a block no longer fits in shared memory beside the rest, so it
     lies in device memory): 480,000 random triangles in clusters of C=8
     (K about 81,000, above every entry's old limit, printed with it), 2048
     rays in bundles of one block each, through every fused2 entry (K1-K4,
     the serial yardsticks, the profile entry, K1b's three modes on both
     plane types, K4 on f32 planes, the exact forms) against the plain
     version by each entry's usual rule; then the same clusters widened to
     C=512 by pad slots, where a block of rays is a thread block cluster of
     4 CTAs that share one frontier row in device memory, K1, K3 and K4 on
     the bundles of three seeds, each launched three times, equal bit for
     bit to the serial body at C=512 and to the C=8 entry (one CTA); then
     on dragon8 at C=128 (K about 11,000) the fused2-bf16 and fused2
     closest-hit entries on the centre chunk's bounce wave with the row in
     shared memory and in device memory, equal bit for bit, timed in turns
     (ten calls a turn, every timing's spread printed), with shared bytes
     and blocks per SM of both forms and the form that ships
     (``--row-timing ROUNDS`` runs only the timing of the form that ships,
     on the package beside the script, and prints it as JSON: copied into
     another checkout, it times that checkout's kernels);
  5d. scan-renderer frame parity on make_accel("fused"): cornell-box 64x64,
     spp 4, depth 4, card vs CPU, without and with NEE (fused_occluded), and
     the textured cube (the texture lookup of the shade-blob fetch);
  6d. the scan main path (bench.py's scan branch): dragon sub 7 on
     make_accel("fused"), 1024x1024, depth 4, auto sky, new_film +
     add_samples with 65536-pixel chunks; then render_image_wavefront on the
     same accelerator at 131072 lanes; counts reset just before each;
  6e. the CLI in process (utils/cli.main): the car scene of
     assets/settings.json at its 1080x1440 and depth 16, --intersector fused
     --no-sweep, spp cut to 2, with its textured Ground, into
     chiprun_out/smoke_cli/.
The retirement-loop latency probe (K6, ops/latency_probe.py, run by
tools/latency_probe.py) and the production path (tools/render_production.py)
with the wavefront's drained checkpoints:
  3f. K6 vs its plain version on the soup's MXU clusters (C=64, f32 and bf16
     planes): every variant, blocks 128 and 256, P = 1, 2 and 4, iters 0, 3
     and 8; the exact CUDA-core form's column 0 bit-equal (rtol 1e-6 with
     the approximate reciprocal), the tensor form's within the sums'
     rounding of every slot its block tested (compare_probe_tensor),
     columns 1-15 zero;
  4f. the probe at its default shapes through tools/latency_probe.run (the
     tensor form; dragon sub 7, C=512, K=768, 131072 bounce rays, blocks of
     256, iters 0, 8 and 16), the default variants and the bf16 and recip
     ones, one JSON line each with its slope; launch counts reset just
     before it; then every variant in both forms vs its plain version at
     iters 16, as in 3f (the exact form's interleave2 and interleave4 on f32
     planes copy in tiles of 256 and 128 slots), and the product variants
     timed in turns (exact, tensor, tensor, exact) beside both bounds;
  6f. the production frame: assets/settings.json's car at 1080x1440, depth
     16, 131072 lanes, sort on, spp cut to 2 in segments of 1, each frame
     uninterrupted and stopped mid-segment (drained checkpoints after each
     of 2 launches of 4 steps, their seconds read from the progress lines)
     then resumed, the golden rule against the uninterrupted frame: first on
     the component layout at the same C, whose winners do not depend on the
     rays beside them, with exactly the uninterrupted frame's rays; then on
     fused2-bf16, the production accelerator, where a ray's winner may depend
     on its block's other rays (near ties of the bf16 planes) and resumed
     waves hold other rays, so the rays are held to 1e-4; a checkpoint
     refused under another accelerator or scene; then render_production's
     main in process into chiprun_out/smoke_production/tool/ (nothing under
     docs/gallery/).
The gradient path (render/diff.py; K1b under autograd, the refit of
make_intersectors(..., differentiable=True)):
  5g. gradients on the card against the same calls on CPU tensors (the
     plain versions), per field allclose(rtol 1e-4, atol 1e-6 max|g|):
     material gradients of tests/test_diff.py's 16x16 sphere (spp 4, depth
     3), its camera gradients through the refit (the radius-2 sphere), the
     car's material gradients and cornell-box's with NEE (32x32, spp 2,
     depth 3; K1b f32 closest hit and any-hit), all on make_accel("fused2");
     every kernel wave recorded and held to the plain version by
     compare_near_tie / compare_flags (tensor-core rounding kinds), pixels
     whose winners differ left out of the gradient comparison; an element
     float32 cannot resolve (the CPU's value outside the tolerance of the
     float64 gradient, brute sweep on the card) is printed and held to the
     float64 value; one FD check of base_color through K1b (rtol 0.05);
     fused2-bf16 material gradients finite; brute equal to cluster bit for
     bit on the card (a frame, hits and occlusion);
  6g. material recovery at full size (BASELINE.json config 5): mitsuba and
     the car (22,084 triangles) on make_accel("fused2"), 256x256 (one scan
     chunk), spp 4, depth 3, auto sky, 10 Adam steps on one material's
     base_color (the car's window glass alone, by grad_mask); the loss must
     fall (car: below 0.7 of its first value); seconds per step, fwd+bwd
     Mrays/s (live rays of one more loss + backward over its synchronised
     wall time), peak memory and K1b launches per step; one loss + backward
     under metrics.profile_trace: device busy share and the owlpt.* ranges.
Multi-device rendering (parallel/shard.py on torch.distributed), the
per-ray-stack bvh accelerator and the strided film:
  6h. phase 6's main path through render_image_wavefront_sharded on
     fused2-bf16 in an NCCL group of world size 1 (work_map the identity),
     counts reset just before it: the film equal to render_image_wavefront's
     at the same settings bit for bit, K1b launches counted; then
     sharded_loss_and_grad at world size 1 on mitsuba 256x256, spp 4, depth
     3, fused2, against render/diff.py::loss_and_grad to rtol 1e-6 (atol 1e-6
     max|g|), K1b launches per call; then two ranks spawned on the one card
     (gloo, explicitly: NCCL refuses two ranks on one card) render the
     dragon at 256x256 on fused2-bf16 with both work splits, each image held
     to the world-1 frame by the golden rule, with per_chip_rays and
     load_balance;
  6i. the bvh accelerator (make_accel("bvh"), plain PyTorch): bvh_closest_hit
     on phase 4's primary and bounce waves equal to cluster_closest_hit bit
     for bit (tri, t, u, v; an exact t tie between two triangles is counted
     and excused), bvh_occluded on phase 4b's cornell shadow wave equal to
     cluster_occluded, each timed beside the cluster query; then one frame
     of the dragon at 1024x1024, depth 4, spp 1 through
     render_image_wavefront on bvh and on cluster, with their seconds and
     Mrays/s, then the bvh frame again with every wave held to the cluster
     query on its own rays: winners may differ only at exact t ties between
     two triangles (either is the closest hit; one of 1.85M rays on dragon7
     at spp 1), and the frames must then meet the golden rule with equal
     rays, else be equal bit for bit;
  6j. the strided film at phase 6's configuration on the component layout
     (8 pixels per lane), held to the queue film by tests/test_wavefront.py's
     rule (rtol 1e-5, atol 1e-6, equal rays), timed in turns queue,
     strided, strided, queue; then once each on fused2-bf16 (golden rule).
The second-to-last lines are the kernels JSON (the component rows K1-K4
give the slot-parallel entries, with bound_no_fma_ms, the ceiling of a
kernel built with --fmad=false, and serial_ms, the serial body's time from
the same turns; fused2_serial_closest_hit and fused2_serial_sweep_mixed,
the serial yardsticks, and fused2_profile, the profile entry, are off every
render path; the K1b rows give the
tensor-core entries, with sharded_launches, their launches on phase 6h's
sharded paths, and on the bf16 closest-hit row sharded_launches_two_ranks;
fused2_mxu_exact_closest_hit, fused2_mxu_bf16_exact_closest_hit and
fused2_mxu_exact_closest_hit_noattr, off every render path, the exact forms'
times from the same turns; the K1b closest-hit rows carry phase 4e's dragon8
times of both frontier-row forms; latency_probe is K6's tensor form, with
its exact form's time and per-variant times in turns, latency_probe_exact
the exact form) and the GPU's nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  Each kernel's bound_ms is
the largest of its times at the wave it was timed on, per ray and slot of
each cluster that ray's exact query needs (see needed_clusters; K5 adds
the slab test of each such cluster's box, fused_bound): component
layout, 45 Moller-Trumbore fp32 operations over the H100's published
67 TFLOP/s fp32 peak (700 W); MXU layout, the 2 x 16 x 4 = 128 FLOP of the
feature products over the planes' dtype peak (bf16 dense tensor cores
989 TFLOP/s, the peak of K1b's tensor-core form and the least the exact
form's work needs; f32 67 TFLOP/s, the fp32 products' own rate: the tensor
cores reach f32 only as three TF32 products, at 495 TFLOP/s), and the
28 fp32 operations of the winner chain over 67 TFLOP/s; and for both, the
bytes (inputs read once at their width, output written once) over 3.35 TB/s.
The rows of the f32 tensor-core entries also carry bound_tf32_ms and
bound_tf32_by: the same bound with their products as the kernel computes
them, three TF32 products of one k=8 step per column group (TF32_FLOP per
ray and slot) at 495 TFLOP/s.
K6's bound (probe_bound) is its launch's slab tests and, per chain and loop
iteration: the exact form, the feature products of the 10 ray feature rows
that are not constant zeros and the window chain over the fp32 peak
(CUDA cores), against the whole planes' bytes; the tensor form, the larger
of the products at the tensor rate (bf16 MXU_FLOP, or f32 TF32_FLOP) and
the window chain at the fp32 peak, against the bytes of the rows it
stages.

Imports nothing of JAX or of the JAX package; the dragon scene file is made
by assets/generate.py in a child process.  Needs no network.
"""
import argparse
import concurrent.futures
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# main path (bench.py's headline configuration, spp from --spp)
DRAGON_SUB, SIZE, DEPTH, LANES, BLOCK = 7, 1024, 4, 131072, 256
# frame-parity configuration
FRAME_SCENE, FRAME_SIZE, FRAME_SPP, FRAME_LANES = "cornell-box", 64, 4, 4096
# the dragon frame held card vs CPU on fused2 (size and spp cut for the CPU)
DRAGON_FRAME_SIZE, DRAGON_FRAME_SPP = 128, 2
# NEE configuration (docs/PERF.md round 3's NEE cell)
NEE_SCENE = "cornell-box"
SOURCE = "owl_path_tracer_tpu_torch/csrc/fused2_traverse.cu"
REPLACES = "owl_path_tracer_tpu/ops/fused2.py:269"
FUSED_SOURCE = "owl_path_tracer_tpu_torch/csrc/fused_traverse.cu"
FUSED_REPLACES = "owl_path_tracer_tpu/ops/fused.py:86"
# scan renderer (bench.py's scan branch): pixels per chunk
SCAN_CHUNK = 65536
# the CLI run: assets/settings.json's scene at its own size and depth, spp cut
CLI_SPP = 2
# the production frame (tools/render_production.py): spp cut from 12,288, in segments of 1
PRODUCTION_SPP = 2
PROBE_SOURCE = "owl_path_tracer_tpu_torch/csrc/latency_probe.cu"
PROBE_REPLACES = "tools/tpu_probe6.py:68"
# K6's ray feature rows that can change its result: d, o x d, o, 1 (rows
# 10-15 are constant zeros that the kernel multiplies all the same)
PROBE_LIVE_FEATURES = 10
# bound: Moller-Trumbore fp32 operations per ray, slot and needed cluster
# (component layout); MXU layout: feature-product FLOP (2 x 16 features x 4
# groups) and winner-chain fp32 operations (ops/fused2.py:616-653 of the JAX
# package: sign 2, |det| and the three sign flips 4, window 14, safe divisor
# 2, divide and select 2, min 1, lowest-slot pick 3) per ray, slot and needed
# cluster; published peaks of one H100 SXM at 700 W (fp32 FLOP/s outside the
# tensor cores, dense bf16 tensor-core FLOP/s, HBM bytes/s)
MT_OPS, MXU_FLOP, CHAIN_OPS = 45, 2 * 16 * 4, 28
# K5's slab test per ray and box (ops/cluster.py::_cluster_entries): per
# axis two products, two differences and four min/max; then the T_MIN clamp,
# the far clamp, the compare and the select
SLAB_OPS = 28
FP32_FLOPS, BF16_FLOPS, HBM_BYTES_S = 67e12, 989e12, 3.35e12
# The component kernels' ceiling: the fp32 peak counts a fused multiply-add
# as two operations, and the kernels are built with --fmad=false (the
# bit-equality contract), so each operation is one instruction issued at
# half that rate; no component kernel can pass half of its fp32-peak bound.
FP32_NO_FMA_OPS = FP32_FLOPS / 2
# dense TF32 tensor-core FLOP/s of one H100 SXM, and the TF32 FLOP per ray
# and slot of the f32 tensor-core form (K1b f32's second bound, K6's tensor
# form): three products (lo*hi, hi*lo, hi*hi), each one k=8 step per column
# group, 2 x 8 x 4 FLOP (12 mma.sync m16n8k8 per 16 rays and 8 slots)
TF32_FLOPS, TF32_FLOP = 495e12, 3 * 2 * 8 * 4
# How far the tensor cores' feature sums (K1b on bf16 planes) may lie from
# the plain version's, per unit of the sum of the terms' magnitudes: the
# products are exact; the plain version rounds 9 times along its 10 live rows
# (< 9 x 2^-24); the tensor core, aligning each product to the largest one
# and truncating, loses < 2^-23 of the largest term per product and once
# more in the result (< 11 x 2^-23 = 22 x 2^-24); so < 31 x 2^-24 < 2^-19.
SUM_GAMMA = 2.0**-19
# The same for K1b's f32 tensor-core form (3xTF32), per unit of the sum of
# the terms' magnitudes: (a) each operand x = hi + lo + r with hi = tf32(x),
# lo = tf32(x - hi), |lo| <= 2^-11 |x|, |r| <= 2^-22 |x|; the dropped lo*lo
# and the remainders' products are < 3 x 2^-22 = 12 x 2^-24 of each product;
# (b) the plain version's 6 product and 5 sum roundings (at most 6 live rows
# per column group) < 11 x 2^-24; (c) the tensor core's three mma.sync per
# group, each aligning up to 6 live exact products and the accumulator to
# the largest and truncating, < (6 + 2) x 2^-23 = 16 x 2^-24 each, 48 x 2^-24
# over three (Hopper's accumulator rounding is undocumented: phase 4c prints
# the worst ratio observed on the card beside this bound); so < 71 x 2^-24
# < 2^-17.8, and 2^-17 leaves room.
SUM_GAMMA_F32 = 2.0**-17
# phase 4e: the soup above every fused2 entry's old shared-row cluster
# limit (random triangles in clusters of LIMIT_C, rays in bundles of one
# block each)
LIMIT_TRIS, LIMIT_C, LIMIT_BUNDLES = 480_000, 8, 8
LIMIT_MIN_K = 60_000  # above every entry's old limit at C=8 on an H100 (232,448 bytes per block)
# its clusters widened by pad slots to LIMIT_WIDE_C, where a slot-parallel
# block of rays is a thread block cluster of 4 CTAs (K above their old limit
# of 49,052), on the bundles of each of LIMIT_SEEDS, each entry launched
# LIMIT_REPEATS times
LIMIT_WIDE_C, LIMIT_SEEDS, LIMIT_REPEATS = 512, (5, 6, 7), 3
# phase 4e's dragon8 timing (and --row-timing): timings a turn
ROW_REPS = 10
# one rounding of a float32 operation, relative (the window's own sums,
# products and the t division round on both sides)
EPS32 = 2.0**-23
# K6's tensor form: roundings of t beyond its division's, by which its best t
# may lie off a slot's plain t (the approximate reciprocal's one ulp, and the
# window's product with the running best t, rounded on both sides)
PROBE_T_SLACK = 3
# the gradient path (phases 5g, 6g): tests/test_diff.py's sphere frame, the
# car / cornell frame held card vs CPU, the full-size recovery frame (one scan
# chunk) and its Adam steps; card vs CPU gradients per field to
# allclose(rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * max|g_cpu|)
GRAD_SIZE, GRAD_CAR_SIZE, GRAD_FULL, GRAD_STEPS = 16, 32, 256, 10
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-6
# phase 6h's two-rank frame (the dragon, cut from 1024x1024 so that two
# spawned ranks on one card build and render it in well under a minute)
TWO_RANK_SIZE = 256


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.2f} s", flush=True)


def run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=600, **kw).stdout.strip()


def cuda_times(fn, reps: int = 3):
    """Milliseconds of ``reps`` timed calls after one warm-up (CUDA events)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def launch_times(fn, reps: int, batch: int = 10):
    """Milliseconds per call of ``fn`` (a launch that does not wait for the
    card), from ``reps`` timings of ``batch`` calls back to back after one
    warm-up: the host's time between launches hides behind the card's, so
    this is the kernel's time and not the wrapper's."""
    return [t / batch for t in cuda_times(lambda: [fn() for _ in range(batch)], reps)]


def cuda_ms(fn, reps: int = 3):
    """Median milliseconds of ``reps`` timed calls after one warm-up (CUDA events)."""
    return statistics.median(cuda_times(fn, reps))


def in_turns(a, b, reps: int = 3):
    """Median milliseconds of ``a`` and of ``b``, timed in turns a, b, b, a
    (``reps`` calls each turn, CUDA events), so that a drift of the card's
    clock over the four turns weighs on both alike."""
    ta, tb = cuda_times(a, reps), cuda_times(b, reps)
    tb += cuda_times(b, reps)
    ta += cuda_times(a, reps)
    return statistics.median(ta), statistics.median(tb)


def hmma_counts(lib):
    """HMMA (tensor-core) instructions per fused2_kernel instantiation (its
    shared-row form) in the SASS of ``lib`` (cuobjdump beside nvcc) ->
    {(mode, layout, attrs, tensor): count}."""
    import re

    from owl_path_tracer_tpu_torch.native import nvcc_path

    sass = run([str(pathlib.Path(nvcc_path()).parent / "cuobjdump"), "-sass", str(lib)])
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # the fifth flag is the profile form (component layout only), the
            # sixth the frontier row in device memory
            found = re.search(r"fused2_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)ELb0ELb0E", line)
            key = tuple(int(x) for x in found.groups()) if found else None
            if key:
                counts[key] = 0
        elif key and "HMMA" in line:
            counts[key] += 1
    return counts


def compare(got, want, allow_ties: bool):
    """Kernel output vs plain output ([N,32]) -> max |t,u,v| error on agreeing rows.

    tri must match exactly, except (``allow_ties``) where both t agree to
    5e-6 relative -- a true tie between triangles of different clusters.
    Agreeing rows: t/u/v to rtol 5e-6 and the attribute blob exactly."""
    import torch

    check(bool((got[:, 5] == 1).all()), "kernel left rays unresolved")
    same = got[:, 3] == want[:, 3]
    if allow_ties:
        tie = torch.isclose(got[:, 0], want[:, 0], rtol=5e-6, atol=0)
        check(bool((same | tie).all()), f"{int((~same & ~tie).sum())} winners differ beyond ties")
    else:
        check(bool(same.all()), f"{int((~same).sum())} winners differ")
    g, w = got[same], want[same]
    for col in (4, 7, 8):
        check(bool((g[:, col] == w[:, col]).all()), f"column {col} differs")
    check(bool((g[:, 16:32] == w[:, 16:32]).all()), "attribute blob differs")
    torch.testing.assert_close(g[:, 0:3], w[:, 0:3], rtol=5e-6, atol=1e-6)
    return float((g[:, 0:3] - w[:, 0:3]).abs().max()) if len(g) else 0.0, int((~same).sum())


def k2_error(got, want, rays):
    """Largest difference of an any-hit output from its contract: the
    occlusion flag against the plain version's, and t (column 0) against the
    ray's tmax, which any-hit mode never lowers."""
    return max(float((got[:, 4] - want[:, 4]).abs().max()), float((got[:, 0] - rays[:, 6]).abs().max()))


def needed_clusters(rays, want, fb, any_hit):
    """Per ray [N], the clusters an exact query has to test on these inputs.

    ``want`` is the plain version's output on ``rays`` and ``any_hit`` [N]
    marks the occlusion lanes.  A closest-hit lane needs every cluster whose
    box it enters before its closest hit (t = tmax on a miss): the plain
    version's entry-ordered walk tests exactly these.  An occluded any-hit
    lane needs one cluster; one that is not occluded needs every cluster whose
    box meets its window."""
    import torch

    from owl_path_tracer_tpu_torch.ops import math as m
    from owl_path_tracer_tpu_torch.ops.cluster import _cluster_entries

    counts = []
    for lo in range(0, rays.shape[0], 16384):
        r, w, ah = rays[lo : lo + 16384], want[lo : lo + 16384], any_hit[lo : lo + 16384]
        best_t = torch.where(ah, r[:, 6], w[:, 0])
        entries = _cluster_entries(r[:, 0:3], r[:, 3:6], fb.cluster, m.T_MIN, r[:, 6])
        n = (entries < best_t[:, None]).sum(1)
        counts.append(torch.where(ah & (w[:, 4] > 0), 1, n))
    return torch.cat(counts)


def bound(rays, want, fb, any_hit, with_attrs=True, tf32=False, no_fma=False):
    """(bound_ms, bound_by, needed clusters per ray) of one kernel call: the
    operations on the slots of the clusters each ray needs over their peak
    (component: Moller-Trumbore over fp32; MXU: the feature products over
    the planes' dtype peak, and the winner chain over fp32, whichever takes
    longer), vs inputs read once and output written once over HBM bytes/s.
    ``tf32``: f32 planes' products as the f32 tensor-core form computes
    them, TF32_FLOP per slot at the TF32 tensor-core rate.  ``no_fma``
    (component): the operations at FP32_NO_FMA_OPS, one instruction each,
    the ceiling of a kernel built with --fmad=false."""
    need = needed_clusters(rays, want, fb, any_hit)
    slots = fb.cluster_size * float(need.sum())
    if fb.mxu:
        flop, peak = MXU_FLOP, BF16_FLOPS if fb.planes.dtype.itemsize == 2 else FP32_FLOPS
        if tf32:
            flop, peak = TF32_FLOP, TF32_FLOPS
        t_ops = max(flop * slots / peak, CHAIN_OPS * slots / FP32_FLOPS) * 1e3
    else:
        t_ops = MT_OPS * slots / (FP32_NO_FMA_OPS if no_fma else FP32_FLOPS) * 1e3
    nbytes = (4 * (rays.numel() + want.numel() + fb.boxes.numel() + (fb.attrs.numel() if with_attrs else 0))
              + fb.planes.numel() * fb.planes.dtype.itemsize)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")), float(need.float().mean())


def sum_gamma(fb):
    """How far K1b's tensor-core sums may lie from the plain version's, per
    unit of the sum of the terms' magnitudes: SUM_GAMMA on bf16 planes,
    SUM_GAMMA_F32 on f32 planes."""
    return SUM_GAMMA if fb.layout == "mxu_bf16" else SUM_GAMMA_F32


def window_bounds(sums, absolute, gamma, t_max):
    """How the MXU window of slots with plain feature sums ``sums`` (det,
    u*det, v*det, t*det) and absolute sums ``absolute`` is decided, against
    how far another summation (the tensor cores') may move each sum
    (``gamma`` times its absolute terms); any broadcastable shapes -> (within,
    close, sure, t, t_err):

      within  every window inequality (|det| >= 1e-12, u >= 0, v >= 0,
              u + v <= det, t > t_min, t < t_max, on the sign-folded sums)
              holds in the plain arithmetic or fails by less than its bound;
      close   some inequality's margin is smaller than its bound (another
              summation could decide it the other way);
      sure    every inequality holds by more than its bound;
      t       the matmul-space t (t*det / det);
      t_err   the bound on its error (inf where |det| is within its own)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import math as m

    det, ua, vb, tcd = sums
    e_det, e_u, e_v, e_t = (gamma * a for a in absolute)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    dd, u, v, tc = det * sgn, ua * sgn, vb * sgn, tcd * sgn
    ineqs = (  # (margin, > 0 where it holds; bound on how far another summation moves it)
        (dd - 1e-12, e_det),
        (u, e_u),
        (v, e_v),
        (dd - (u + v), e_det + e_u + e_v + EPS32 * (u.abs() + v.abs() + dd)),
        (tc - dd * m.T_MIN, e_t + m.T_MIN * e_det + EPS32 * (tc.abs() + dd * m.T_MIN)),
        (dd * t_max - tc, e_t + t_max * e_det + EPS32 * (tc.abs() + dd * t_max)),
    )
    within = close = None
    sure = None
    for margin, bnd in ineqs:
        w, cl, su = margin > -bnd, torch.isfinite(margin) & (margin.abs() < bnd), margin > bnd
        within = w if within is None else within & w
        close = cl if close is None else close | cl
        sure = su if sure is None else sure & su
    t = tc / dd
    t_err = (e_t + t.abs() * e_det) / torch.clamp(dd - e_det, min=0.0) + EPS32 * t.abs()
    return within, close, sure, t, torch.where(dd > e_det, t_err, torch.inf)


def sums_decisions(rays, fb, cid, slot):
    """How the window of slot ``slot`` of cluster ``cid`` (per ray of the
    packed ``rays``; cid < 0: no winner) is decided, against how far the
    tensor cores' sums may lie from the plain version's (``sum_gamma``
    times each sum's absolute terms, ``fused2.mxu_slot_sums``) -> (within,
    close, t, t_err) of :func:`window_bounds` at the ray's t_max, false
    and inf without a winner."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    sums, absolute = fused2.mxu_slot_sums(rays[:, 0:3], rays[:, 3:6], fb, cid, slot)
    within, close, _, t, t_err = window_bounds(sums, absolute, sum_gamma(fb), rays[:, 6])
    has = cid >= 0
    return within & has, close & has, torch.where(has, t, torch.inf), torch.where(has, t_err, torch.inf)


def loop_tuv_errors(rays, fb, cid, slot):
    """[N,3] bounds on how far the loop's t = t*det / det, u = u*det / det
    and v = v*det / det of slot ``slot`` of cluster ``cid`` (per packed ray;
    K4's outputs) may move when the tensor cores sum the features
    (``sum_gamma``), each quotient's division rounded on both sides."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    (det, ua, vb, tcd), absolute = fused2.mxu_slot_sums(rays[:, 0:3], rays[:, 3:6], fb, cid, slot)
    e_det, e_u, e_v, e_t = (sum_gamma(fb) * a for a in absolute)
    dd = det.abs()
    errs = []
    for num, e in ((tcd, e_t), (ua, e_u), (vb, e_v)):
        q = (num / dd).abs()
        errs.append(torch.where(dd > e_det, (e + q * e_det) / (dd - e_det) + 2 * EPS32 * q, torch.inf))
    return torch.stack(errs, 1)


def compare_near_tie(got, want, rays, fb, what, blob=True, tensor=False):
    """Kernel vs plain output ([N,32]) on the MXU layout -> (max |t,u,v| error
    on agreeing rows, rows whose winners differ).

    Winners (tri) must be equal on every ray except where the kernel's
    winner passes the kernel's window at its own (cluster, slot), recomputed
    from the planes (``fused2.mxu_slot_test``: det, u, v, t_min and the ray's
    t_max), and
      * both winners pass it and their matmul-space t agree to 1e-5 relative
        (a near tie: the sums round alike, the visiting orders differ), or
      * the nearer winner lies in a cluster that the other side never tests,
        because an exact traversal skips a box whose entry is beyond its best
        t: both winners pass the window, the nearer one's matmul-space t lies
        before the finite box entry of its own cluster for this ray, and that
        entry is not before the farther winner's t; or
      * the kernel's winner lies in a cluster whose box this ray does not
        enter at all, which the plain version never tests, and the plain
        version misses or its winner passes the window and is farther.
    The plain version walks each ray's boxes in entry order; a kernel block
    retires clusters for all its rays and every searching ray tests them, so
    each side reaches such a hit or not on its own.  bf16 planes round t by
    ~1e-3 relative and more, far beyond a box's margin; f32 planes may have
    no row of the last two kinds, and bf16 ones at most 0.5% of the rows
    compared.
    With ``tensor`` (the tensor-core entries, whose feature sums may differ
    from the plain version's by rounding, ``sums_decisions``)
    a row is also explained when each side's winner passes its window or
    fails it by less than the sums' rounding bound, and a window inequality
    of either winner, or the two winners' t order, lies within that bound;
    then all the explained rows together may be at most 0.5% of the rows
    (rounded up).
    The counts are printed.  On agreeing rows t/u/v to rtol 5e-6, and hit,
    winner cluster and slot and (``blob``) the attribute blob exactly; with
    ``tensor`` and no blob (K4, whose t/u/v are the loop's quotients of the
    tensor-core sums) a row outside rtol 5e-6 must lie within the sums'
    rounding bound of each quotient (``loop_tuv_errors``)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops import math as m
    from owl_path_tracer_tpu_torch.ops.cluster import _cluster_entries

    check(bool((got[:, 5] == 1).all()), f"{what}: kernel left rays unresolved")
    same = got[:, 3] == want[:, 3]
    diff = torch.nonzero(~same).squeeze(1)
    if diff.numel():
        r = rays[diff]
        tg, ok_g = fused2.mxu_slot_test(r[:, 0:3], r[:, 3:6], fb, got[diff, 7], got[diff, 8], r[:, 6])
        tw, ok_w = fused2.mxu_slot_test(r[:, 0:3], r[:, 3:6], fb, want[diff, 7], want[diff, 8], r[:, 6])
        valid = ok_g & ok_w
        tie = valid & torch.isclose(tg, tw, rtol=1e-5, atol=0)
        near_cid = torch.where(tg <= tw, got[diff, 7], want[diff, 7]).long()
        entries = _cluster_entries(r[:, 0:3], r[:, 3:6], fb.cluster, m.T_MIN, r[:, 6])
        entry = entries[torch.arange(diff.numel(), device=r.device), near_cid.clamp(min=0)]
        apart = valid & ~tie
        before_entry = (apart & torch.isfinite(entry) & (torch.minimum(tg, tw) < entry)
                        & (entry >= torch.maximum(tg, tw)))
        unentered = ok_g & (ok_w | (want[diff, 7] < 0)) & (tg < tw) & torch.isinf(entry)
        unreached = before_entry | unentered
        rounding = torch.zeros_like(tie)
        if tensor:
            within_g, close_g, t_g, err_g = sums_decisions(r, fb, got[diff, 7].long(), got[diff, 8].long())
            within_w, close_w, t_w, err_w = sums_decisions(r, fb, want[diff, 7].long(), want[diff, 8].long())
            order = torch.isfinite(t_g) & torch.isfinite(t_w) & ((t_g - t_w).abs() < err_g + err_w)
            rounding = (~tie & ~unreached & (within_g | (got[diff, 7] < 0)) & (within_w | (want[diff, 7] < 0))
                        & (close_g | close_w | order))
        bad = diff[~tie & ~unreached & ~rounding]
        for i in torch.nonzero(~tie & ~unreached & ~rounding).squeeze(1)[:8].tolist():
            j = int(diff[i])
            print(f"  {what}: ray {j} kernel tri {int(got[j, 3])} loop t {float(tg[i]):.7g} window "
                  f"{bool(ok_g[i])} (cluster {int(got[j, 7])}), plain tri {int(want[j, 3])} loop t "
                  f"{float(tw[i]):.7g} window {bool(ok_w[i])} (cluster {int(want[j, 7])}), nearer cluster's "
                  f"entry {float(entry[i]):.7g}")
        print(f"  {what}: winners differ on {diff.numel()} of {got.shape[0]} rays: {int(tie.sum())} near ties, "
              f"{int(before_entry.sum())} hits before their cluster's entry, {int(unentered.sum())} kernel hits "
              f"in a box the ray does not enter, "
              + (f"{int(rounding.sum())} decided within the sums' rounding, " if tensor else "")
              + f"{bad.numel()} otherwise")
        check(bad.numel() == 0, f"{what}: {bad.numel()} of {got.shape[0]} winners differ beyond the near-tie rule")
        if tensor:
            cap = math.ceil(0.005 * got.shape[0])
            check(diff.numel() <= cap, f"{what}: {diff.numel()} explained rows, more than {cap}")
        else:
            cap = int(0.005 * got.shape[0]) if fb.planes.dtype == torch.bfloat16 else 0
            check(int(unreached.sum()) <= cap,
                  f"{what}: {int(unreached.sum())} hits in clusters only one side tests, more than {cap}")
    g, w = got[same], want[same]
    for col in (4, 7, 8):
        check(bool((g[:, col] == w[:, col]).all()), f"{what}: column {col} differs")
    if blob:
        check(bool((g[:, 16:32] == w[:, 16:32]).all()), f"{what}: attribute blob differs")
    else:
        check(bool((got[:, 16:32] == 0).all()), f"{what}: the no-attributes blob is not zero")
    if tensor and not blob:
        far = torch.nonzero(~torch.isclose(g[:, 0:3], w[:, 0:3], rtol=5e-6, atol=1e-6).all(1)).squeeze(1)
        if far.numel():
            bnd = loop_tuv_errors(rays[same][far], fb, w[far, 7].long(), w[far, 8].long())
            inside = ((g[far, 0:3] - w[far, 0:3]).abs() <= bnd).all(1)
            print(f"  {what}: {far.numel()} agreeing rows' loop t/u/v outside rtol 5e-6, {int(inside.sum())} of them "
                  "within the sums' rounding bound")
            check(bool(inside.all()), f"{what}: {int((~inside).sum())} rows' loop t/u/v beyond the sums' rounding")
    else:
        torch.testing.assert_close(g[:, 0:3], w[:, 0:3], rtol=5e-6, atol=1e-6)
    return float((g[:, 0:3] - w[:, 0:3]).abs().max()) if len(g) else 0.0, int(diff.numel())


def flag_rounding(rays, fb):
    """Per packed ray [N]: does some slot of some cluster decide the ray's
    any-hit window within the sums' rounding bound (every inequality holds
    or fails by less than its bound, and some margin is smaller than it:
    ``sums_decisions``'s within and close)?  Then a tensor-core sum may
    decide that slot's hit the other way.  Every cluster counts, entered or
    not: a kernel block tests every cluster it retires for each of its
    searching rays."""
    import torch

    k, c = fb.num_clusters, fb.cluster_size
    out = torch.zeros(rays.shape[0], dtype=torch.bool, device=rays.device)
    cid = torch.arange(k, device=rays.device).repeat_interleave(c)
    slot = torch.arange(c, device=rays.device).repeat(k)
    for i in range(rays.shape[0]):
        within, close, _, _ = sums_decisions(rays[i : i + 1].expand(cid.numel(), -1), fb, cid, slot)
        out[i] = bool((within & close).any())
    return out


def compare_flags(got, want, what, min_share=0.9999, rays=None, fb=None):
    """Occlusion flags (col 4) -> rays that differ; fails below ``min_share``
    equal.  With ``rays`` and ``fb`` (a tensor-core entry, whose sums may
    differ from the plain version's by rounding) every differing flag must
    also be explained by ``flag_rounding``, and only flags of rays from the
    park point (the wavefront's dead lanes, wavefront.PARK, whose window
    sums cancel from terms of ~1e8) are exempt from ``min_share``."""
    from owl_path_tracer_tpu_torch.render.wavefront import PARK

    differ = (got[:, 4] != want[:, 4]).nonzero().squeeze(1)
    if differ.numel():
        print(f"  {what}: {differ.numel()} flags differ, rays {differ[:16].tolist()}")
    counted = differ
    if rays is not None and differ.numel():
        explained = flag_rounding(rays[differ], fb)
        print(f"  {what}: {int(explained.sum())} of the {differ.numel()} differing flags decided within the sums' "
              "rounding", flush=True)
        check(bool(explained.all()), f"{what}: {int((~explained).sum())} flags differ beyond the sums' rounding")
        counted = differ[~(rays[differ, 0:3] == PARK).all(1)]
    check(1.0 - counted.numel() / got.shape[0] >= min_share,
          f"{what}: {counted.numel()} flags differ" + (" off the park point" if rays is not None else ""))
    return differ.numel()


def differing_columns(got, want):
    """{column: rows} of the [N,32] columns where two outputs differ bit for
    bit (float32 bits compared, so -0.0 differs from 0.0 and NaN equals
    itself)."""
    import torch

    diff = got.contiguous().view(torch.int32) != want.contiguous().view(torch.int32)
    per_col = diff.sum(0)
    return {int(col): int(per_col[col]) for col in torch.nonzero(per_col).flatten()}


def profile_split(prof):
    """A profile entry's [blocks, PROFILE_COLS] clock64 rows -> the slowest
    block (by total cycles) and the mean block: cycles and each phase's share
    of them, and clusters retired per block (mean, max, the slowest's)."""
    from owl_path_tracer_tpu_torch.ops import fused2

    cols = fused2.PROFILE_COLS
    phases, tot, st = cols[: cols.index("total")], cols.index("total"), cols.index("steps")
    prof = prof.double().cpu()
    slow = int(prof[:, tot].argmax())
    mean = prof.mean(0)
    share = lambda row: {ph: float(row[i] / row[tot]) if row[tot] > 0 else 0.0 for i, ph in enumerate(phases)}  # noqa: E731
    return {"slowest": {"block": slow, "cycles": float(prof[slow, tot]), "share": share(prof[slow]),
                        "clusters": int(prof[slow, st])},
            "mean": {"cycles": float(mean[tot]), "share": share(mean)},
            "clusters_per_block": {"mean": float(mean[st]), "max": int(prof[:, st].max())}}


def format_split(split, mhz=None):
    """One line of a profile_split: cycles (and ms at ``mhz``) and phase
    shares of the slowest and the mean block, clusters per block."""
    def part(what, x):
        ms = f" = {x['cycles'] / (mhz * 1e3):.3f} ms at {mhz:.0f} MHz" if mhz else ""
        shares = ", ".join(f"{ph} {100 * v:.1f}%" for ph, v in x["share"].items())
        return f"{what} {x['cycles']:.0f} cycles{ms} ({shares})"

    cpb = split["clusters_per_block"]
    return (f"{part('slowest block', split['slowest'])}, {split['slowest']['clusters']} clusters; "
            f"{part('mean block', split['mean'])}; clusters per block mean {cpb['mean']:.2f} max {cpb['max']}")


def same_outputs(a, b):
    """Fanout-1 vs fanout-2 outputs: every column but steps (col 6) bit-identical."""
    import torch

    cols = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
    cols[6] = False
    return bool(torch.equal(a[:, cols], b[:, cols]))


def golden(img, want, rays_got, rays_want, what):
    """The golden rule of tests/test_golden.py, and ray counts within 0.5%."""
    import torch

    close = torch.isclose(img, want, rtol=1e-4, atol=1e-5).float().mean().item()
    mean_rel = abs(img.mean().item() - want.mean().item()) / abs(want.mean().item())
    print(f"  {what}: {close:.4%} pixels close, mean rel diff {mean_rel:.2e}, rays {rays_got} vs {rays_want}")
    check(close > 0.995 and mean_rel < 1e-3, f"{what} fails the golden rule")
    check(abs(rays_got - rays_want) <= 0.005 * rays_want, f"{what}: ray counts differ by more than 0.5%")


def soup_arrays():
    """3000 random triangles (vertices, indices, normals, texcoords, material
    ids) and 300 rays (o, d, t_max; half with a finite t_max), from seed 0."""
    import numpy as np

    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(9000, dtype=np.int32).reshape(3000, 3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    tc = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    mat = r.integers(0, 5, 3000).astype(np.int32)
    n = 300  # not a multiple of either block: padding rays
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10).astype(np.float32)
    return (verts, idx, normals, tc, mat), (o, d, tmax)


def tie_soup_arrays():
    """Exact-t ties inside one cluster: 62 random triangles and two copies of
    one triangle (z = 0.5, around the origin), from seed 2, with normals,
    texcoords and material ids; at C=64 the copies share cluster 0 at slots
    29 and 32, one below and one above the slot halves (tests check it).
    128 rays (o, d, t_max, shadow flags): 64 through the copies (along +z
    and -z, and tilted), 64 random ones; every other pair a shadow lane."""
    import numpy as np

    r = np.random.default_rng(2)
    fill = r.uniform(-4, 4, (62, 1, 3)) + r.normal(0, 0.3, (62, 3, 3))
    copy = np.array([[[-1.0, -1.0, 0.5], [1.0, -1.0, 0.5], [0.0, 1.0, 0.5]]])
    verts = np.concatenate([fill, copy, copy]).astype(np.float32).reshape(-1, 3)
    idx = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    texcoords = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    tri_mat = r.integers(0, 5, len(idx)).astype(np.int32)
    xy = r.uniform(-0.3, 0.3, (64, 2))
    side = np.where(np.arange(64) % 2 == 0, -1.0, 1.0)
    tie_o = np.stack([xy[:, 0], xy[:, 1], 0.5 + 3.0 * side], 1)
    tie_d = np.stack([r.normal(0, 0.05, 64), r.normal(0, 0.05, 64), -side], 1)
    o = np.concatenate([tie_o, r.uniform(-6, 6, (64, 3))]).astype(np.float32)
    d = np.concatenate([tie_d, r.normal(size=(64, 3))]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(128, 1e10, np.float32)
    shadow = np.arange(128) % 4 >= 2
    return (verts, idx, normals, texcoords, tri_mat), (o, d, tmax, shadow)


def soup(device, **build):
    """The soup as fused2 clusters (C=64) and its rays on ``device``;
    ``build`` picks the layout (``mxu``, ``plane_dtype``)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    mesh, rays = soup_arrays()
    fb = fused2.build_fused2(*mesh[:2], 64, *mesh[2:], device=device, **build)
    return fb, [torch.as_tensor(x, device=device) for x in rays]


def fused_soup(device):
    """The soup as K5's clusters (C=64) and its rays on ``device``."""
    import torch

    from owl_path_tracer_tpu_torch.ops.cluster import build_clusters
    from owl_path_tracer_tpu_torch.ops.fused import build_fused

    (verts, idx, *_), rays = soup_arrays()
    return build_fused(build_clusters(verts, idx, 64, device=device)), [torch.as_tensor(x, device=device)
                                                                         for x in rays]


def corner_groups(device):
    """K5's group-skip case: 64 one-triangle clusters (C=1), group 0 (ids
    0-31) tiny triangles in two opposite corners of the square [0,1]^2 at
    z=0, group 1 (ids 32-63) one triangle across (0.5, 0.5) at z=3 and 31
    off to the side; and 128 rays along +z through (0.5, 0.5): each enters
    group 0's box and none of its members, and hits cluster 32 at t = 4."""
    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.ops.cluster import ClusterBVH
    from owl_path_tracer_tpu_torch.ops.fused import build_fused

    tri = np.zeros((64, 3, 3), np.float32)
    unit = np.array([[0, 0, 0], [0.05, 0, 0], [0, 0.05, 0]], np.float32)
    for i in range(32):
        corner = np.array([0, 0, 0] if i % 2 else [0.95, 0.95, 0], np.float32)
        tri[i] = unit + corner
    tri[32] = np.array([[0.4, 0.4, 3], [0.6, 0.4, 3], [0.5, 0.6, 3]], np.float32)
    for i in range(33, 64):
        tri[i] = unit + np.array([5 + i, 0, 3], np.float32)
    p0 = tri[:, 0]
    planes = np.concatenate([p0, tri[:, 1] - p0, tri[:, 2] - p0], 1)[:, :, None]  # [K,9,1]
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    cb = ClusterBVH(cmin=as_t(tri.min(1)), cmax=as_t(tri.max(1)), tri_planes=as_t(planes),
                    tri_id=as_t(np.arange(64, dtype=np.int32)[:, None]))
    o = torch.tensor([[0.5, 0.5, -1.0]], device=device).expand(128, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(128, 3).contiguous()
    return build_fused(cb), o, d


def sorted_rays(o, d, t, fb, mode, shadow=None):
    """Packed rays in the wrappers' sorted order (shadow class on bit 30) -> (rays, permutation)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    keys = fused2.wave_sort_keys(o, d, t, fb, mode=mode)
    if shadow is not None:
        keys = keys | (shadow.to(torch.int64) << fused2.SHADOW_CLASS_BIT)
    perm = torch.sort(keys, stable=True).indices
    return fused2.pack_rays(o, d, t, shadow)[perm], perm


def wrapper_reference(fb, rays, raw):
    """What a wrapper must return when the kernel (``raw``) left some rows
    to the exact query: the kernel's own rows where it resolved them (the
    tensor-core forms, whose winners the near-tie rule holds apart from the
    plain version's), the plain version's rows elsewhere."""
    from owl_path_tracer_tpu_torch.ops import fused2

    mode = "mixed" if bool((rays[:, 7] > 0).any()) else "closest"
    want = fused2.fused2_traverse_packed_plain(rays, fb, mode)
    want[:, 5] = raw[:, 5]
    keep = raw[:, 5] > 0
    want[keep] = raw[keep]
    return want


def component_resources(k=768, c=512, block=BLOCK):
    """Phase 2: threads, registers, shared bytes and blocks per SM of each
    component entry (the slot-parallel body, then the serial yardsticks) at
    dragon7's K and C and the main path's block (phase 4 prints them again
    at each scene's own K)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    fb = fused2.Fused2BVH(boxes=torch.zeros(8, k), planes=torch.zeros(k, 16, c), attrs=torch.zeros(k, 32, c),
                          attr_table=torch.zeros(1, 32), bounds=torch.zeros(2, 3), cluster=None)
    for mode, attrs, serial in (("closest", True, False), ("any_hit", False, False), ("mixed", True, False),
                                ("closest", False, False), ("closest", True, True), ("mixed", True, True)):
        res = fused2.kernel_resources(fb, mode, block, attrs, serial=serial)
        print(f"  {res['entry']} at K={k} C={c} block {block}: {res['threads']} threads, {res['registers']} "
              f"registers, {res['shared_bytes']} bytes of shared memory (frontier row in {res['row']} memory), "
              f"{res['blocks_per_sm']} blocks per SM", flush=True)


def dragon_setup(dev, spp):
    """Phase 4's inputs: the dragon scene (icosphere subdivision DRAGON_SUB)
    at SIZE x SIZE on the component layout, its sort mode, the main path's
    settings at ``spp``, and a mid-frame wave (the work items of the rows
    through the image centre) of LANES primaries and the bounce wave the
    port's own trace_bounce makes of it -> (dragon, scene, accel, mode,
    settings, waves {"primary", "bounce": (o, d)}, ids)."""
    import torch

    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render import integrator, wavefront
    from owl_path_tracer_tpu_torch.render.film import scene_has_textures
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_dragon

    dragon = ensure_dragon(DRAGON_SUB)
    scene = compile_scene(ROOT / "assets", dragon, (SIZE, SIZE), device=dev)
    accel = fused2.build_fused2_scene(scene, mxu=False)
    mode = fused2.auto_sort_mode(scene)
    print(f"  {dragon}: {scene.num_tris} triangles, K={accel.num_clusters} C={accel.cluster_size}, sort {mode}")
    settings = RenderSettings(width=SIZE, height=SIZE, max_samples=spp, max_path_depth=DEPTH,
                              environment_auto=True)
    ids = settings.width * settings.height * spp // 2 - LANES // 2 + torch.arange(LANES, device=dev)
    state = fresh_paths(scene, settings, ids)
    isect, _ = integrator.make_intersectors(scene, accel, fused2_block=BLOCK, fused2_sort=mode)
    bounce = integrator.trace_bounce(scene, settings, state, isect, scene_has_textures(scene))
    waves = {
        "primary": (state.ray_o, state.ray_d),
        "bounce": (torch.where(bounce.alive[:, None], bounce.ray_o, wavefront.PARK), bounce.ray_d),
    }
    return dragon, scene, accel, mode, settings, waves, ids


def fresh_paths(scene, settings, ids):
    """integrator.PathState of the work items ``ids`` at their camera rays."""
    import torch

    from owl_path_tracer_tpu_torch.render import integrator, wavefront

    n, dev = ids.shape[0], ids.device
    _, ray_o, ray_d, rng = wavefront._spawn(scene, settings, ids)
    return integrator.PathState(
        ray_o=ray_o, ray_d=ray_d, result=torch.zeros_like(ray_o), throughput=torch.ones_like(ray_o),
        rng=rng, alive=torch.ones(n, dtype=torch.bool, device=dev),
        prev_lobe=torch.full((n,), -1, dtype=torch.int64, device=dev),
        depth=torch.zeros(n, dtype=torch.int64, device=dev), prev_pdf=torch.zeros(n, device=dev),
    )


def nee_setup(dev, spp, ids):
    """Phase 4b's inputs: NEE_SCENE on the component layout, its sort mode
    and NEE settings at ``spp``; from the work items ``ids``, the bounce wave
    and a wave of shadow rays from its vertices toward sample_lights points
    -> (scene, accel, mode, settings, waves {"shadow": (o, d, t), "mixed":
    (o, d, t, shadow flags) of the bounce rays then the shadow rays, the
    wave the deferred form traces})."""
    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.models.lights import build_light_table, sample_lights
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops import math as m
    from owl_path_tracer_tpu_torch.render import integrator, wavefront

    nee_scene = compile_scene(ROOT / "assets", NEE_SCENE, (SIZE, SIZE), env_map_path=None, device=dev)
    nee_accel = fused2.build_fused2_scene(nee_scene, mxu=False)
    nee_mode = fused2.auto_sort_mode(nee_scene)
    lights = build_light_table(nee_scene)
    print(f"  {NEE_SCENE}: {nee_scene.num_tris} triangles, {lights.count} light triangles, "
          f"K={nee_accel.num_clusters} C={nee_accel.cluster_size}, sort {nee_mode}")
    nset = RenderSettings(width=SIZE, height=SIZE, max_samples=spp, max_path_depth=DEPTH,
                          environment_auto=True, use_nee=True)
    lanes = ids.shape[0]
    state = fresh_paths(nee_scene, nset, ids)
    isect, _ = integrator.make_intersectors(nee_scene, nee_accel, fused2_block=BLOCK, fused2_sort=nee_mode)
    bounce = integrator.trace_bounce(nee_scene, nset, state, isect, False)
    # shadow rays from the bounce wave's vertices (its rays' origins) toward light samples
    u3 = torch.as_tensor(np.random.default_rng(2).random((lanes, 3), dtype=np.float32), device=dev)
    ls = sample_lights(lights, bounce.ray_o, u3)
    on = bounce.alive & (ls.pdf > 0)
    sh_o = torch.where(on[:, None], bounce.ray_o, wavefront.PARK)
    sh_d = torch.where(on[:, None], ls.direction, torch.tensor([0.0, 0.0, 1.0], device=dev))
    sh_t = torch.where(on, ls.distance - m.T_MIN, m.T_MIN)
    print(f"  shadow wave: {int(on.sum())}/{lanes} live")
    b_o = torch.where(bounce.alive[:, None], bounce.ray_o, wavefront.PARK)
    b_t = torch.full((lanes,), m.T_MAX, device=dev)
    comb_sh = torch.cat([torch.zeros(lanes, dtype=torch.bool, device=dev),
                         torch.ones(lanes, dtype=torch.bool, device=dev)])
    waves = {"shadow": (sh_o, sh_d, sh_t),
             "mixed": (torch.cat([b_o, sh_o]), torch.cat([bounce.ray_d, sh_d]), torch.cat([b_t, sh_t]), comb_sh)}
    return nee_scene, nee_accel, nee_mode, nset, waves


def component_wave(what, rays, fb, block, mode="closest", with_attrs=True, shadow=None, mhz=None):
    """One sorted main-path wave through a component entry (the
    slot-parallel body): its outputs held to the plain version (winners
    equal but for true ties between clusters, t/u/v to rtol 5e-6, blob
    exact; any-hit and the mixed sweep's shadow flags identical); every
    column equal bit for bit to the serial body's (its entry for closest hit
    with attributes and the mixed sweep, the profile entry's serial body for
    any-hit and K4); the profile entry's clock64 split of both bodies, each
    with outputs equal to its plain entry's; registers, shared bytes, blocks
    per SM and threads; and the kernel's time, in turns with the serial
    entry where there is one (serial, new, new, serial), beside the plain
    version's, the fp32-peak bound and the no-FMA ceiling -> dict."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    def run(serial=False):
        return fused2.fused2_traverse_packed(rays, fb, block=block, mode=mode, with_attrs=with_attrs, serial=serial)

    n = rays.shape[0]
    got = run()
    want = fused2.fused2_traverse_packed_plain(rays, fb, mode, with_attrs)
    ties = 0
    if mode == "any_hit":
        check(bool((got[:, 5] == 1).all()), f"{what}: rays unresolved")
        err = k2_error(got, want, rays)
        check(err == 0.0, f"{what}: flags differ from the plain version or t was lowered: max error {err}")
        any_hit = torch.ones(n, dtype=torch.bool, device=rays.device)
    elif mode == "mixed":
        err, ties = compare(got[~shadow], want[~shadow], allow_ties=True)
        check(bool((got[shadow, 5] == 1).all()), f"{what}: shadow rays unresolved")
        check(bool((got[shadow, 4] == want[shadow, 4]).all()), f"{what}: shadow flags differ from the plain version")
        any_hit = shadow
    else:
        err, ties = compare(got, want, allow_ties=True)
        any_hit = torch.zeros(n, dtype=torch.bool, device=rays.device)
    has_entry = mode == "mixed" or (mode == "closest" and with_attrs)
    if has_entry:
        serial = run(serial=True)
    else:
        serial, _ = fused2.fused2_traverse_profile(rays, fb, block, mode=mode, with_attrs=with_attrs, serial=True)
    diff = differing_columns(got, serial)
    check(not diff, f"{what}: the slot-parallel body differs from the serial body in {{column: rows}} {diff}")
    splits = {}
    for body, ref in (("slot-parallel", got), ("serial", serial)):
        out, prof = fused2.fused2_traverse_profile(rays, fb, block, mode=mode, with_attrs=with_attrs,
                                                   serial=body == "serial")
        diff = differing_columns(out, ref)
        check(not diff, f"{what}: the {body} profile entry's outputs differ from its plain entry's: {diff}")
        phases = prof[:, : fused2.PROFILE_COLS.index("total")].sum(1)
        check(bool((phases == prof[:, fused2.PROFILE_COLS.index("total")]).all()),
              f"{what}: the {body} profile's phases do not add up to its total")
        splits[body] = profile_split(prof)
        print(f"  {what}, {body} body: {format_split(splits[body], mhz)}", flush=True)
    res = fused2.kernel_resources(fb, mode, block, with_attrs)
    print(f"  {res['entry']} at K={fb.num_clusters} C={fb.cluster_size} block {block}: {res['threads']} threads, "
          f"{res['registers']} registers, {res['shared_bytes']} bytes of shared memory, {res['blocks_per_sm']} "
          "blocks per SM", flush=True)
    if has_entry:
        s_ms, k_ms = in_turns(lambda: run(serial=True), run)
        turns = (f"serial body {s_ms:.3f} ms (in turns serial, new, new, serial; {s_ms / k_ms:.2f}x), ")
    else:
        s_ms, k_ms = None, cuda_ms(run)
        turns = ""
    prof_ms = cuda_ms(lambda: fused2.fused2_traverse_profile(rays, fb, block, mode=mode, with_attrs=with_attrs))
    p_ms = cuda_ms(lambda: fused2.fused2_traverse_packed_plain(rays, fb, mode, with_attrs))
    attrs = with_attrs and mode != "any_hit"
    bnd, need = bound(rays, want, fb, any_hit, with_attrs=attrs)
    ceiling = bound(rays, want, fb, any_hit, with_attrs=attrs, no_fma=True)[0]
    steps = got[:, 6].reshape(-1, block)[:, 0]
    hits = int(got[~any_hit, 4].sum()) if mode == "mixed" else int(got[:, 4].sum())
    print(f"  {what}: {hits}/{n} {'hit' if mode != 'any_hit' else 'occluded'}"
          f"{f', {int(got[shadow, 4].sum())} shadow lanes occluded' if mode == 'mixed' else ''}, {ties} tie swaps, "
          f"max err {err:.3g}, every column equal to the serial body's, clusters/block mean {float(steps.mean()):.2f} "
          f"max {int(steps.max())}, clusters needed/ray mean {need:.3f}; slot-parallel {k_ms:.3f} ms, {turns}"
          f"profile entry {prof_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {100 * bnd[0] / k_ms:.2f}% reached), no-FMA "
          f"ceiling {ceiling[0]:.4f} ms ({ceiling[1]}, {100 * ceiling[0] / k_ms:.2f}% reached)", flush=True)
    return {"err": err, "ms": k_ms, "serial_ms": s_ms, "profile_ms": prof_ms, "plain_ms": p_ms, "bound": bnd,
            "bound_no_fma": ceiling, "split": splits, "resources": res}


def phase_3c(dev, results):
    """K1b (MXU f32 and bf16 planes, three modes; the tensor-core forms
    under the sums' rounding rule, the exact CUDA-core forms equal to the
    plain version) and K4 vs plain on the soup."""
    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops.fused2 import pack_rays

    plain = fused2.fused2_traverse_packed_plain
    comp, _ = soup(dev, mxu=False)
    fb32 = None
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fb, (o, d, tmax) = soup(dev, plane_dtype=dtype)
        fb32 = fb if name == "f32" else fb32
        r = np.random.default_rng(1)
        shadow = torch.as_tensor(np.arange(300) % 2 == 1, device=dev)
        dist = torch.as_tensor(np.where(shadow.cpu().numpy(), r.uniform(2.0, 20.0, 300), 1e10).astype(np.float32),
                               device=dev)
        errs, ties, flag_diffs = [], 0, 0
        for block in (128, 256):
            rays = pack_rays(*fused2._pad_rays(o, d, tmax, block)[:3])
            o_p, d_p, t_p, _ = fused2._pad_rays(o, d, dist, block)
            sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - 300)])
            mrays = pack_rays(o_p, d_p, t_p, sh_p)
            want, want_a, want_m = plain(rays, fb), plain(rays, fb, "any_hit"), plain(mrays, fb, "mixed")
            outs = {}
            for fo in (1, 2):
                what = f"K1b {name} soup block {block} fanout {fo}"
                got = fused2.fused2_traverse_packed(rays, fb, block=block, fanout=fo)
                e, tie = compare_near_tie(got, want, rays, fb, what, tensor=True)
                check(bool((got[300:, 4] == 0).all()), f"{what}: a padding ray hit")
                got_a = fused2.fused2_traverse_packed(rays, fb, block=block, fanout=fo, mode="any_hit")
                check(bool((got_a[:, 5] == 1).all()), f"{what}: any-hit left rays unresolved")
                check(bool((got_a[:, 0] == rays[:, 6]).all()), f"{what}: any-hit lowered t")
                flag_diffs += compare_flags(got_a, want_a, f"{what} any-hit")
                got_m = fused2.fused2_traverse_packed(mrays, fb, block=block, fanout=fo, mode="mixed")
                e_m, tie_m = compare_near_tie(got_m[~sh_p], want_m[~sh_p], mrays[~sh_p], fb, f"{what} mixed",
                                              tensor=True)
                check(bool((got_m[sh_p, 5] == 1).all()), f"{what}: mixed left shadow rays unresolved")
                flag_diffs += compare_flags(got_m[sh_p], want_m[sh_p], f"{what} mixed shadow lanes")
                errs += [e, e_m]
                ties += tie + tie_m
                # the CUDA-core form: the plain version's arithmetic
                got_x = fused2.fused2_traverse_packed(rays, fb, block=block, fanout=fo, exact=True)
                e_x, tie_x = compare_near_tie(got_x, want, rays, fb, f"{what} exact")
                check(tie_x == 0, f"{what}: the exact form differs from the plain version on {tie_x} rows")
                errs.append(e_x)
                outs[fo] = (got, got_a, got_m)
            check(all(same_outputs(a, b) for a, b in zip(outs[1], outs[2])),
                  f"K1b {name} block {block}: fanout 1 and 2 differ")
            got = outs[2][0]
            print(f"  K1b {name} soup block {block}: {int(got[:300, 4].sum())}/300 hits, "
                  f"{int(want_a[:300, 4].sum())}/300 occluded, {int(want_m[sh_p, 4].sum())}/{int(sh_p.sum())} "
                  f"shadow lanes occluded; fanout 1 == fanout 2 bit for bit")
        results[f"k1b_{name}_err"] = max(errs)
        print(f"  K1b {name} soup: max |tuv err| {max(errs):.3g}, {ties} explained rows, {flag_diffs} flags differ"
              f"; the exact {name} form equal to the plain version on every row")
        # max_steps=1: rows left unresolved go to the exact query in every wrapper
        o_p, d_p, t_p, _ = fused2._pad_rays(o, d, tmax, 128)
        rays = pack_rays(o_p, d_p, t_p)
        raw = fused2.fused2_traverse_packed(rays, fb, block=128, max_steps=1)
        check(bool((raw[:, 5] == 0).any()), f"K1b {name} max_steps=1 left no ray unresolved")
        ref, ref_blob = fused2._hits_from_output(wrapper_reference(fb, rays, raw)[:300], o, d, fb, 1e-3,
                                                 tmax)
        rec, blob = fused2.fused2_closest_hit(o, d, fb, t_max=tmax, max_steps=1)
        check(bool((rec.tri == ref.tri).all()) and bool((blob == ref_blob).all()),
              f"K1b {name} max_steps=1 closest hit differs")
        torch.testing.assert_close(rec.t, ref.t, rtol=5e-6, atol=1e-6)
        raw = fused2.fused2_traverse_packed(rays, fb, block=128, max_steps=1, mode="any_hit")[:300]
        check(bool((raw[:, 5] == 0).any()), f"K1b {name} any-hit max_steps=1 left no ray unresolved")
        occ_ref = torch.where(raw[:, 5] > 0, raw[:, 4] > 0,
                              fused2.cluster_occluded(o, d, fb.cluster, 1e-3, tmax))
        check(bool((fused2.fused2_occluded(o, d, fb, t_max=tmax, max_steps=1) == occ_ref).all()),
              f"K1b {name} max_steps=1 occlusion differs")
        o_p, d_p, t_p, _ = fused2._pad_rays(o, d, dist, 128)
        mrays = pack_rays(o_p, d_p, t_p, torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - 300)]))
        raw = fused2.fused2_traverse_packed(mrays, fb, block=128, max_steps=1, mode="mixed")
        ref, ref_blob = fused2._hits_from_output(wrapper_reference(fb, mrays, raw)[:300], o, d, fb, 1e-3,
                                                 dist)
        rec, blob, occ = fused2.fused2_sweep_mixed(o, d, dist, shadow, fb, max_steps=1)
        check(bool((occ[shadow] == (ref.tri >= 0)[shadow]).all()), f"K1b {name} max_steps=1 mixed flags differ")
        check(bool((rec.tri[~shadow] == ref.tri[~shadow]).all()) and bool((blob[~shadow] == ref_blob[~shadow]).all()),
              f"K1b {name} max_steps=1 mixed closest-hit lanes differ")
        print(f"  K1b {name} max_steps=1: closest, any-hit and mixed wrappers equal the plain version "
              "with the exact query on unresolved rows")
    # K4: closest hit without attributes, component and MXU f32 planes (the
    # tensor form under the sums' rounding rule, the exact CUDA-core form
    # equal to the plain version)
    errs = []
    fbs = {"component": comp, "MXU f32": fb32}
    for name, fb in fbs.items():
        for block in (128, 256):
            rays = pack_rays(*fused2._pad_rays(o, d, tmax, block)[:3])
            got = fused2.fused2_traverse_packed(rays, fb, block=block, with_attrs=False)
            want = plain(rays, fb, with_attrs=False)
            what = f"K4 {name} soup block {block}"
            if fb.mxu:
                e, _ = compare_near_tie(got, want, rays, fb, what, blob=False, tensor=True)
                got1 = fused2.fused2_traverse_packed(rays, fb, block=block, with_attrs=False, fanout=1)
                check(same_outputs(got1, got), f"{what}: fanout 1 and 2 differ")
                got_x = fused2.fused2_traverse_packed(rays, fb, block=block, with_attrs=False, exact=True)
                e_x, tie_x = compare_near_tie(got_x, want, rays, fb, f"{what} exact", blob=False)
                check(tie_x == 0, f"{what}: the exact form differs from the plain version on {tie_x} rows")
                errs.append(e_x)
            else:
                e, _ = compare(got, want, allow_ties=False)
            errs.append(e)
    try:
        fused2.fused2_closest_hit(o, d, soup(dev, plane_dtype=torch.bfloat16)[0], with_attrs=False)
        raise SmokeFailure("bf16 planes with with_attrs=False did not raise")
    except ValueError:
        pass
    results["k4_err"] = max(errs)
    print(f"  K4 component and MXU f32 (tensor and exact forms), blocks 128/256: held to the plain version, max "
          f"|tuv err| {max(errs):.3g}; the exact MXU form equal to it; bf16 + no attributes raises ValueError")


def time_kernel(what, rays, fb, block, mode="closest", with_attrs=True, shadow=None):
    """Kernel vs plain on one sorted wave: checks, CUDA-event times, bound ->
    dict.  On MXU planes the kernel is the tensor-core form, held to the
    sums' rounding rule; for closest hit (with attributes, and K4 without)
    the exact CUDA-core form is also held to the plain version and timed in
    turns with it (key "exact")."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    tensor = fb.mxu
    run = lambda fo=fused2.FANOUT, exact=False: fused2.fused2_traverse_packed(  # noqa: E731
        rays, fb, block=block, mode=mode, fanout=fo, with_attrs=with_attrs, exact=exact)
    got = run()
    want = fused2.fused2_traverse_packed_plain(rays, fb, mode, with_attrs)
    if mode == "any_hit":
        check(bool((got[:, 5] == 1).all()), f"{what}: rays unresolved")
        err, ties = float((got[:, 4] - want[:, 4]).abs().max()), compare_flags(got, want, what)
        any_hit = torch.ones_like(got[:, 0], dtype=torch.bool)
    elif mode == "mixed":
        err, ties = compare_near_tie(got[~shadow], want[~shadow], rays[~shadow], fb, what, tensor=tensor)
        check(bool((got[shadow, 5] == 1).all()), f"{what}: shadow rays unresolved")
        ties += compare_flags(got[shadow], want[shadow], f"{what} shadow lanes")
        any_hit = shadow
    else:
        err, ties = compare_near_tie(got, want, rays, fb, what, blob=with_attrs, tensor=tensor)
        any_hit = torch.zeros_like(got[:, 0], dtype=torch.bool)
    if fb.mxu:
        check(same_outputs(run(1), got), f"{what}: fanout 1 and 2 differ")
        print(f"  {what}: fanout 1 == fanout 2 bit for bit")
    exact = None
    if tensor and mode == "closest":
        got_x = run(exact=True)
        err_x, ties_x = compare_near_tie(got_x, want, rays, fb, f"{what}, exact form", blob=with_attrs)
        x_ms, k_ms = in_turns(lambda: run(exact=True), run)
        exact = {"err": err_x, "ms": x_ms}
        print(f"  {what}: exact CUDA-core form {x_ms:.3f} ms, tensor-core form {k_ms:.3f} ms (in turns exact, "
              f"tensor, tensor, exact; {x_ms / k_ms:.2f}x); the exact form differs from the plain version on "
              f"{ties_x} rows (the tensor form on {ties})", flush=True)
    else:
        k_ms = cuda_ms(run)
    p_ms = cuda_ms(lambda: fused2.fused2_traverse_packed_plain(rays, fb, mode, with_attrs))
    attrs = with_attrs and mode != "any_hit"
    bnd, need = bound(rays, want, fb, any_hit, with_attrs=attrs)
    bnd_tf32 = None
    if tensor and fb.layout == "mxu_f32":
        # beside the fp32-peak bound: the same slots at the TF32 tensor rate
        # (3 products each), against the window chain's fp32 operations
        bnd_tf32 = bound(rays, want, fb, any_hit, with_attrs=attrs, tf32=True)[0]
        print(f"  {what}: bound at the TF32 tensor-core rate (3xTF32 products, window on CUDA cores) "
              f"{bnd_tf32[0]:.4f} ms ({bnd_tf32[1]}, {100 * bnd_tf32[0] / k_ms:.2f}% reached)", flush=True)
    steps = got[:, 6].reshape(-1, block)[:, 0]
    print(f"  {what}: {int(got[:, 4].sum())}/{rays.shape[0]} hit, {ties} explained rows / differing flags, "
          f"max err {err:.3g}, clusters/block mean {float(steps.mean()):.2f} max {int(steps.max())}, "
          f"clusters needed/ray mean {need:.3f}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}, {100 * bnd[0] / k_ms:.2f}% reached)", flush=True)
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "bound": bnd, "bound_tf32": bnd_tf32, "exact": exact}


def tensor_sums_ratio(rays, want, fb, warps: int = 256):
    """The worst |tensor-core sum - plain sum| / sum |terms| of the f32
    tensor form (``fused2.mxu_tensor_sums``, the kernel's own staging and
    products) over every slot and column group, for the first ``warps`` x 32
    packed rays, each warp against the winner cluster of its first hitting
    ray in ``want`` (the plain output) -> (worst ratio, sums compared)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    n = 32 * warps
    r, w = rays[:n], want[:n].view(warps, 32, -1)
    first = torch.argmax((w[:, :, 4] > 0).int(), dim=1)
    cids = w[torch.arange(warps, device=w.device), first, 7].clamp(min=0).long()
    tc = fused2.mxu_tensor_sums(r, fb, cids)  # [n,4,C]
    cid = cids.repeat_interleave(32)
    feat = fused2._ray_features(r[:, 0:3], r[:, 3:6], False)
    plain = fused2._feature_sums(feat, fb.planes, cid, slice(0, fb.cluster_size))
    absolute = fused2._feature_sums(feat, fb.planes, cid, slice(0, fb.cluster_size), absolute=True)
    worst, count = 0.0, 0
    for g in range(4):
        live = absolute[g] > 0
        ratio = (tc[:, g].double() - plain[g].double()).abs()[live] / absolute[g].double()[live]
        worst, count = max(worst, float(ratio.max())), count + int(live.sum())
    return worst, count


def phase_4c(scene, mode, waves, nee_scene, nee_mode, nee_waves, block, results, hmma):
    """K1b and K4 vs plain at the main path's shapes."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render.film import make_accel

    for kind in ("fused2-bf16", "fused2"):
        accel = make_accel(scene, kind)
        layout_i = 2 if kind == "fused2-bf16" else 1
        print(f"  {kind}: K={accel.num_clusters} C={accel.cluster_size}, planes {tuple(accel.planes.shape)} "
              f"{accel.planes.dtype}", flush=True)
        forms = [(m_name, m_name != "any_hit", exact) for m_name in fused2.MODES
                 for exact in ([False, True] if m_name == "closest" else [False])]
        if kind == "fused2":  # K4 on f32 planes, both forms
            forms += [("closest", False, False), ("closest", False, True)]
        for m_name, attrs, exact in forms:
            res = fused2.kernel_resources(accel, m_name, block, with_attrs=attrs, exact=exact)
            count = hmma[(fused2.MODES.index(m_name), layout_i, int(attrs), int(not exact))]
            print(f"  {res['entry']} at K={accel.num_clusters} C={accel.cluster_size} block {block}: "
                  f"{res['registers']} registers, {res['shared_bytes']} bytes of shared memory (frontier row in "
                  f"{res['row']} memory), {res['blocks_per_sm']} blocks per SM, {count} HMMA instructions in its "
                  "SASS", flush=True)
        for name, (wo, wd) in waves.items():
            tm = torch.full((wo.shape[0],), 1e10, device=wo.device)
            rays, _ = sorted_rays(wo, wd, tm, accel, mode)
            results[f"{kind} closest {name}"] = time_kernel(f"{kind} {name} wave", rays, accel, block)
            if kind == "fused2":
                want = fused2.fused2_traverse_packed_plain(rays, accel)
                worst, count = tensor_sums_ratio(rays, want, accel)
                results["tf32_ratio"] = max(results.get("tf32_ratio", 0.0), worst)
                print(f"  f32 tensor-core sums on the {name} wave: worst |tensor - plain| / sum |terms| "
                      f"{worst:.3g} = 2^{math.log2(worst) if worst > 0 else -math.inf:.2f} over {count} sums, "
                      f"SUM_GAMMA_F32 = 2^{math.log2(SUM_GAMMA_F32):.0f}", flush=True)
                check(worst <= SUM_GAMMA_F32, f"f32 tensor-core sums exceed SUM_GAMMA_F32: {worst}")
            if kind == "fused2" and name == "bounce":  # K4 component: phase 4
                results["K4 mxu"] = time_kernel(f"K4 {kind} {name} wave", rays, accel, block, with_attrs=False)
        nee_accel = make_accel(nee_scene, kind)
        sh_o, sh_d, sh_t = nee_waves["shadow"]
        rays, _ = sorted_rays(sh_o, sh_d, sh_t, nee_accel, nee_mode)
        results[f"{kind} any_hit"] = time_kernel(f"{kind} cornell shadow wave", rays, nee_accel, block, "any_hit")
        co, cd, ct, csh = nee_waves["mixed"]
        rays, perm = sorted_rays(co, cd, ct, nee_accel, nee_mode, shadow=csh)
        results[f"{kind} mixed"] = time_kernel(f"{kind} cornell mixed wave ({rays.shape[0]} rays)", rays,
                                               nee_accel, block, "mixed", shadow=csh[perm])


def phase_5c(dev, block, dragon):
    """fused2-bf16 and fused2 frames, card vs CPU: cornell-box without and
    with NEE, and (fused2) the dragon at DRAGON_FRAME_SIZE."""
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.render import wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel

    for kind in ("fused2-bf16", "fused2"):
        for use_nee, forms in ((False, (False,)), (True, (False, True))):
            fset = RenderSettings(width=FRAME_SIZE, height=FRAME_SIZE, max_samples=FRAME_SPP,
                                  max_path_depth=DEPTH, environment_auto=True, use_nee=use_nee)
            extra = {"env_map_path": None} if use_nee else {}
            cpu_scene = compile_scene(ROOT / "assets", FRAME_SCENE, (FRAME_SIZE, FRAME_SIZE), device="cpu",
                                      **extra)
            cpu_accel = make_accel(cpu_scene, kind)
            for fused_nee in forms:
                kw = dict(lanes=FRAME_LANES, fused2_block=block, fused2_sort=True, fused_nee=fused_nee)
                want, rays_want = wavefront.render_image_wavefront(cpu_scene, fset, cpu_accel, **kw)
                img, rays_got = wavefront.render_image_wavefront(cpu_scene.to(dev), fset, cpu_accel.to(dev), **kw)
                form = "" if not use_nee else (" NEE deferred" if fused_nee else " NEE separate")
                golden(img.cpu(), want, rays_got, rays_want,
                       f"{FRAME_SCENE} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP}{form} on {kind}, GPU vs CPU")
    # the dragon main path's scene on fused2 (f32 tensor cores), at a size
    # the CPU's plain version renders in seconds
    size = DRAGON_FRAME_SIZE
    fset = RenderSettings(width=size, height=size, max_samples=DRAGON_FRAME_SPP, max_path_depth=DEPTH,
                          environment_auto=True)
    cpu_scene = compile_scene(ROOT / "assets", dragon, (size, size), device="cpu")
    cpu_accel = make_accel(cpu_scene, "fused2")
    kw = dict(lanes=LANES, fused2_block=block, fused2_sort=True)
    start = time.perf_counter()
    want, rays_want = wavefront.render_image_wavefront(cpu_scene, fset, cpu_accel, **kw)
    cpu_s = time.perf_counter() - start
    img, rays_got = wavefront.render_image_wavefront(cpu_scene.to(dev), fset, cpu_accel.to(dev), **kw)
    golden(img.cpu(), want, rays_got, rays_want,
           f"{dragon} {size}x{size} spp {DRAGON_FRAME_SPP} on fused2, GPU vs CPU (CPU {cpu_s:.1f} s)")


def main_path(what, scene, settings, accel, lanes, block, fused_nee=False):
    """One timed frame with the counts reset just before it -> (launches by entry, Mrays/s)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render import wavefront

    torch.cuda.synchronize()
    fused2.reset_counts()
    start = time.perf_counter()
    img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes, fused2_block=block,
                                                 fused2_sort=True, fused_nee=fused_nee)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {k: v for k, v in fused2.LAUNCHES.items() if v}
    check(bool(torch.isfinite(img).all()), f"{what}: non-finite pixels")
    check(img.shape == (settings.height, settings.width, 3), f"{what}: image shape {tuple(img.shape)}")
    check(0.0 < img.mean().item() < 10.0, f"{what}: implausible image mean {img.mean().item()}")
    print(f"  {what} {settings.width}x{settings.height} spp {settings.max_samples} depth {DEPTH}: {rays} rays "
          f"in {seconds:.3f} s = {rays / seconds / 1e6:.3f} Mrays/s; launches {launches}, unresolved rays "
          f"{fused2.UNRESOLVED_RAYS}, image mean {img.mean().item():.6f}", flush=True)
    return launches


def film_determinism(scene, settings, lanes, block):
    """Phase 6's frame rendered twice in this process on fused2 and on the
    component layout; the two films ([H*W,3], the image is the film over spp)
    compared bit for bit -> differing values per accelerator.  On fused2 the
    frame is also rendered twice with the film banked by CUDA ``index_add_``
    (atomics, the banking before ``wavefront._bank``), in turns atomic,
    deterministic, deterministic, atomic, timed on the host clock."""
    import unittest.mock

    import torch

    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render import wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel

    def render(accel, atomic):
        bank = (lambda acc, pixel, contrib: acc.index_add_(0, pixel, contrib)) if atomic else wavefront._bank
        torch.cuda.synchronize()
        start = time.perf_counter()
        with unittest.mock.patch.object(wavefront, "_bank", bank):
            img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes, fused2_block=block,
                                                         fused2_sort=True)
        torch.cuda.synchronize()
        return img.reshape(-1, 3), rays, time.perf_counter() - start

    f2 = make_accel(scene, "fused2")
    atomic_a, sorted_a, sorted_b, atomic_b = (render(f2, atomic) for atomic in (True, False, False, True))
    comp = fused2.build_fused2_scene(scene, mxu=False)
    pairs = {"fused2": (sorted_a, sorted_b), "the component layout": (render(comp, False), render(comp, False)),
             "fused2, atomic banking": (atomic_a, atomic_b)}
    differ = {}
    for kind, ((a, rays_a, sec_a), (b, rays_b, sec_b)) in pairs.items():
        differ[kind] = int((a != b).sum())
        print(f"  film determinism, {kind}: two renders of the {settings.width}x{settings.height} spp "
              f"{settings.max_samples} frame differ in {differ[kind]} of {a.numel()} film values "
              f"(max |diff| {float((a - b).abs().max()):.3g}), rays {rays_a} / {rays_b}, {sec_a:.3f} / {sec_b:.3f} s",
              flush=True)
        check(rays_a == rays_b, f"film determinism, {kind}: the two renders traced {rays_a} and {rays_b} rays")
    print(f"  fused2 frame with the deterministic banking {statistics.median([sorted_a[2], sorted_b[2]]):.3f} s, "
          f"with atomic banking {statistics.median([atomic_a[2], atomic_b[2]]):.3f} s (in turns atomic, "
          "deterministic, deterministic, atomic)", flush=True)
    del differ["fused2, atomic banking"]  # the banking it replaced: expected to differ
    return differ


def fused_bound(rays, want, fb):
    """(bound_ms, bound_by, needed clusters per ray) of one K5 call: the slab
    test of each box a ray enters before its closest hit and Moller-Trumbore
    on that cluster's slots (the clusters its exact query needs), over the
    fp32 peak, vs inputs read once and output written once over HBM bytes/s."""
    import torch

    need = needed_clusters(rays, want, fb, torch.zeros_like(rays[:, 0], dtype=torch.bool))
    ops = (SLAB_OPS + MT_OPS * fb.cluster_size) * float(need.sum())
    t_ops = ops / FP32_FLOPS * 1e3
    t_bytes = 4 * (rays.numel() + want.numel() + fb.boxes.numel() + fb.planes.numel()) / HBM_BYTES_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")), float(need.float().mean())


def phase_3d(dev, results):
    """K5 vs its plain version on the soup."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused as tfu

    fb, (o, d, tmax) = fused_soup(dev)
    n = o.shape[0]
    errs = []
    for block in (128, 256):
        pad = (-n) % block
        o_p = torch.cat([o, torch.zeros((pad, 3), device=dev)])
        d_p = torch.cat([d, torch.tensor([0.0, 0.0, 1.0], device=dev).expand(pad, 3)])
        for t_name, t in (("per-ray", torch.cat([tmax, torch.full((pad,), 1e-3, device=dev)])),
                          ("scalar", 1e10)):
            got = tfu.fused_traverse(o_p, d_p, t, fb, block)
            want = tfu.fused_traverse_plain(o_p, d_p, t, fb, block)
            what = f"K5 soup block {block} {t_name} t_max"
            check(torch.equal(got[:, :7], want[:, :7]), f"{what}: columns 0-6 differ from the plain version")
            check(bool((got[:, 7] == 0).all()) and bool((got[:, 5] == 1).all()), f"{what}: col 7 or resolved")
            errs.append(float((got[:, :3] - want[:, :3]).abs().max()))
            if t_name == "per-ray":
                check(bool((got[n:, 4] == 0).all()), f"{what}: a padding ray hit")
            steps = got[:, 6].reshape(-1, block)[:, 0]
            print(f"  {what}: {int(got[:n, 4].sum())}/{n} hits, columns 0-6 identical, clusters/block "
                  f"{steps.tolist()}")
    results["k5_err"] = max(errs)
    # both list-scan kinds, and the group box entered with no member entered
    cg, co, cd = corner_groups(dev)
    pad = (-n) % 128
    o_p = torch.cat([o, torch.zeros((pad, 3), device=dev)])
    d_p = torch.cat([d, torch.tensor([0.0, 0.0, 1.0], device=dev).expand(pad, 3)])
    want = tfu.fused_traverse_plain(o_p, d_p, 1e10, fb, 128)
    want_c = tfu.fused_traverse_plain(co, cd, 1e10, cg)
    for scan in tfu.SCANS:
        check(torch.equal(tfu.fused_traverse(o_p, d_p, 1e10, fb, 128, scan=scan)[:, :7], want[:, :7]),
              f"K5 ({scan} scan) soup: columns 0-6 differ from the plain version")
        got = tfu.fused_traverse(co, cd, 1e10, cg, scan=scan)
        check(torch.equal(got[:, :7], want_c[:, :7]) and bool((got[:, 0] == 4.0).all()),
              f"K5 ({scan} scan): the corner-groups case differs from the plain version")
    print(f"  K5 scan kinds {list(tfu.SCANS)}: soup columns 0-6 identical; rays through a group box that meet "
          "none of its members hit the cluster behind (t = 4), as the plain version")
    raw = tfu.fused_traverse(torch.cat([o, o[:84]]), torch.cat([d, d[:84]]), 1e10, fb, 128, 1)
    check(bool((raw[:, 5] == 0).any()), "K5 max_steps=1 left no ray unresolved")
    unresolved = tfu.UNRESOLVED_RAYS
    rec = tfu.fused_closest_hit(o, d, fb, t_max=tmax, max_steps=1)
    check(tfu.UNRESOLVED_RAYS > unresolved, "fused_closest_hit max_steps=1 sent no row to the exact query")
    ref = tfu.fused_closest_hit(o.cpu(), d.cpu(), fb.to("cpu"), t_max=tmax.cpu(), max_steps=1)
    check(torch.equal(rec.tri.cpu(), ref.tri), "K5 max_steps=1 winners differ from the CPU wrapper's")
    torch.testing.assert_close(rec.t.cpu(), ref.t, rtol=5e-6, atol=1e-7)
    torch.testing.assert_close(rec.uv.cpu(), ref.uv, rtol=5e-6, atol=1e-6)
    print(f"  max_steps=1: {tfu.UNRESOLVED_RAYS - unresolved} rows unresolved, the wrapper's answers equal "
          "the CPU wrapper's")


def scan_waves(scene, settings, accel, chunk_names=("first chunk", "centre chunk")):
    """The scan path's waves on ``accel``: the first sample of add_samples'
    first pixel chunk (the bottom image rows: ground) and of the chunk
    through the image centre (the dragon), primary and the bounce wave
    trace_bounce makes of it -> {name: (origins, directions)}."""
    import torch

    from owl_path_tracer_tpu_torch.models.camera import primary_rays
    from owl_path_tracer_tpu_torch.ops import rng as rng_mod
    from owl_path_tracer_tpu_torch.render import film, integrator

    dev = scene.vertices.device
    fl = film.new_film(settings, device=dev)
    grid = film._pixel_grid(settings.width, settings.height, dev)
    isect, _ = integrator.make_intersectors(scene, accel)
    chunks = settings.width * settings.height // SCAN_CHUNK
    starts = {"first chunk": 0, "centre chunk": chunks // 2 * SCAN_CHUNK}
    waves = {}
    for chunk_name in chunk_names:
        lo = starts[chunk_name]
        j0, st = rng_mod.next_f32(fl.rng[lo : lo + SCAN_CHUNK])
        j1, st = rng_mod.next_f32(st)
        o, d = primary_rays(scene.camera, grid[lo : lo + SCAN_CHUNK], torch.stack([j0, j1], -1),
                            (settings.width, settings.height))
        n = o.shape[0]
        state = integrator.PathState(
            ray_o=o, ray_d=d, result=torch.zeros_like(o), throughput=torch.ones_like(o), rng=st,
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            prev_lobe=torch.full((n,), -1, dtype=torch.int64, device=dev),
            depth=torch.zeros(n, dtype=torch.int64, device=dev), prev_pdf=torch.zeros(n, device=dev),
        )
        bounce = integrator.trace_bounce(scene, settings, state, isect, film.scene_has_textures(scene))
        # the scan renderer traces every lane: dead lanes keep their last ray
        waves[f"{chunk_name} primary"] = (o, d)
        waves[f"{chunk_name} bounce"] = (bounce.ray_o, bounce.ray_d)
    return waves


def k5_resources(accel, what):
    from owl_path_tracer_tpu_torch.ops import fused as tfu

    for scan in tfu.SCANS:
        res = tfu.kernel_resources(accel, tfu.BLOCK_RAYS, scan)
        print(f"  K5 ({scan} scan) on {what} (K={accel.num_clusters} C={accel.cluster_size}, block "
              f"{tfu.BLOCK_RAYS}): {res['registers']} registers, {res['shared_bytes']} bytes of shared memory, "
              f"{res['blocks_per_sm']} blocks per SM", flush=True)


def k5_split(wo, wd, accel, what, sub=None, mhz=None):
    """K5's time per block on one wave, for both scan kinds: columns 0-6 of
    each kind equal to the plain version's (on the rays ``sub``, every
    ray if None), the profile entry's clock64 split (set-up scan, pick and
    stage, slot loop, list updates and rescans) of the slowest block and the
    mean over blocks, rescans and boxes slab-tested per ray and per block,
    and the kernel's time, the default kind in turns with the serial scan
    (serial, default, default, serial) -> {scan: ms}."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused as tfu
    from owl_path_tracer_tpu_torch.ops import math as m

    b = tfu.BLOCK_RAYS
    idx = torch.arange(wo.shape[0], device=wo.device) if sub is None else sub
    want = tfu.fused_traverse_plain(wo[idx], wd[idx], m.T_MAX, accel)
    ms = {}
    for scan in tfu.SCANS:
        got = tfu.fused_traverse(wo, wd, m.T_MAX, accel, scan=scan)
        check(torch.equal(got[idx, :7], want[:, :7]),
              f"K5 ({scan} scan) {what}: columns 0-6 differ from the plain version")
        out, prof, counts = tfu.fused_traverse_profile(wo, wd, m.T_MAX, accel, scan=scan)
        check(torch.equal(out[:, :7], got[:, :7]), f"K5 profile entry ({scan} scan) {what}: columns 0-6 differ")
        prof = prof.double()
        slow = int(torch.argmax(prof[:, 4]))
        shares = ", ".join(f"{name} {100 * float(prof[slow, i] / prof[slow, 4]):.1f}% "
                           f"(mean {100 * float((prof[:, i] / prof[:, 4]).mean()):.1f}%)"
                           for i, name in enumerate(tfu.PROFILE_COLS[:4]))
        per_block = counts.view(-1, b, 2).sum(1).double()
        clock = f" = {float(prof[slow, 4]) / (mhz * 1e3):.3f} ms at {mhz:.0f} MHz" if mhz else ""
        print(f"  K5 ({scan} scan) {what}: columns 0-6 equal to the plain version; slowest block "
              f"{int(prof[slow, 4])} cycles{clock}, {int(prof[slow, 5])} steps: {shares}; rescans per ray mean "
              f"{float(counts[:, 0].double().mean()):.3f} max {int(counts[:, 0].max())}, per block mean "
              f"{float(per_block[:, 0].mean()):.1f} max {int(per_block[:, 0].max())} (slowest block "
              f"{int(per_block[slow, 0])}); boxes slab-tested per ray mean {float(counts[:, 1].double().mean()):.1f} "
              f"max {int(counts[:, 1].max())}, per block mean {float(per_block[:, 1].mean()):.0f} max "
              f"{int(per_block[:, 1].max())}", flush=True)
        if scan == "serial":
            continue
        serial_ms, ms[scan] = in_turns(lambda: tfu.fused_traverse(wo, wd, m.T_MAX, accel, scan="serial"),
                                       lambda: tfu.fused_traverse(wo, wd, m.T_MAX, accel, scan=scan))
        ms["serial"] = min(ms.get("serial", math.inf), serial_ms)
        print(f"  K5 {what}: {scan} scan {ms[scan]:.3f} ms, serial scan {serial_ms:.3f} ms (in turns serial, "
              f"{scan}, {scan}, serial; {serial_ms / ms[scan]:.2f}x)", flush=True)
    return ms


def phase_4d(scene, settings, results, mhz):
    """K5 vs plain at the scan main path's shapes -> the fused accelerator.
    The kernels line takes the centre chunk's bounce wave, the heaviest,
    where both scan kinds are also split by the profile entry and timed in
    turns with the serial scan; a group-skip set-up scan (max_steps=0)
    slab-tests exactly the boxes the plain list scan counts.  Then the
    1.3M-triangle dragon (subdivision 8, K above the 9,088 clusters one
    block's shared memory held before the box rows moved to device memory):
    its centre chunk's bounce wave, the kernel on all 65,536 rays, the plain
    version on every 8th block of them, split and timed the same way."""
    import torch

    from owl_path_tracer_tpu_torch.models.scene import compile_scene
    from owl_path_tracer_tpu_torch.ops import fused as tfu
    from owl_path_tracer_tpu_torch.ops import math as m
    from owl_path_tracer_tpu_torch.render import film
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_dragon

    t0 = time.perf_counter()
    accel = film.make_accel(scene, "fused")
    torch.cuda.synchronize()
    print(f"  fused accel: K={accel.num_clusters} C={accel.cluster_size} ({accel.groups.shape[1]} group boxes of "
          f"{tfu.GROUP_SIZE}), built in {time.perf_counter() - t0:.2f} s; default scan {tfu.SCAN}", flush=True)
    k5_resources(accel, "dragon7")
    for name, (wo, wd) in scan_waves(scene, settings, accel).items():
        got = tfu.fused_traverse(wo, wd, m.T_MAX, accel)
        want = tfu.fused_traverse_plain(wo, wd, m.T_MAX, accel)
        check(torch.equal(got[:, :7], want[:, :7]), f"K5 {name} wave: columns 0-6 differ from the plain version")
        results["k5_err"] = max(results["k5_err"], float((got[:, :3] - want[:, :3]).abs().max()))
        k_ms = cuda_ms(lambda: tfu.fused_traverse(wo, wd, m.T_MAX, accel))
        # max_steps=0: the block set-up and each ray's first box scan only
        s_ms = cuda_ms(lambda: tfu.fused_traverse(wo, wd, m.T_MAX, accel, tfu.BLOCK_RAYS, 0))
        p_ms = cuda_ms(lambda: tfu.fused_traverse_plain(wo, wd, m.T_MAX, accel), reps=1)
        bnd, need = fused_bound(tfu.pack_rays(wo, wd, m.T_MAX), want, accel)
        steps = got[:, 6].reshape(-1, tfu.BLOCK_RAYS)[:, 0]
        results[f"k5 {name}"] = {"ms": k_ms, "plain_ms": p_ms, "bound": bnd}
        print(f"  K5 {name} wave ({wo.shape[0]} rays, block {tfu.BLOCK_RAYS}): {int(got[:, 4].sum())} hits, "
              f"{int((got[:, 5] == 0).sum())} unresolved, columns 0-6 identical (t/u/v error 0), "
              f"clusters retired/block mean {float(steps.mean()):.2f} max {int(steps.max())}, clusters needed/ray "
              f"mean {need:.3f}, kernel {k_ms:.3f} ms (set-up and first box scan {s_ms:.3f}), plain {p_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}, {100 * bnd[0] / k_ms:.2f}% reached)",
              flush=True)
        if name == "centre chunk bounce":
            results["k5_scans dragon7"] = k5_split(wo, wd, accel, f"dragon7 {name} wave", mhz=mhz)
            # the set-up scan with group skips tests exactly the plain list scan's boxes
            n = 4096
            _, _, counts = tfu.fused_traverse_profile(wo[:n], wd[:n], m.T_MAX, accel, max_steps=0)
            _, _, tests = tfu.nearest_lists(wo[:n], wd[:n], m.T_MAX, accel, groups=True)
            check(torch.equal(counts[:, 1].long(), tests), "K5 group-skip set-up scan: boxes tested differ from "
                                                           "the plain list scan's")
            print(f"  K5 group-skip set-up scan on {n} rays: boxes slab-tested per ray equal to the plain list "
                  f"scan's (mean {float(tests.double().mean()):.1f} of {accel.num_clusters} + "
                  f"{accel.groups.shape[1]} group boxes)", flush=True)

    t0 = time.perf_counter()
    big = compile_scene(ROOT / "assets", ensure_dragon(8), (settings.width, settings.height),
                        device=scene.vertices.device)
    big_accel = film.make_accel(big, "fused")
    torch.cuda.synchronize()
    k = big_accel.num_clusters
    print(f"  dragon8: {big.num_tris} triangles, K={k} C={big_accel.cluster_size}, made and built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(k > 9088, f"dragon8 has K={k} clusters, not above the old limit of 9,088")
    k5_resources(big_accel, "dragon8")
    wo, wd = scan_waves(big, settings, big_accel, ("centre chunk",))["centre chunk bounce"]
    got = tfu.fused_traverse(wo, wd, m.T_MAX, big_accel)
    b = tfu.BLOCK_RAYS
    sub = torch.arange(wo.shape[0], device=wo.device).view(-1, b)[::8].reshape(-1)  # every 8th block
    results["k5_scans dragon8"] = k5_split(wo, wd, big_accel, "dragon8 centre chunk bounce wave", sub, mhz)
    k_ms = cuda_ms(lambda: tfu.fused_traverse(wo, wd, m.T_MAX, big_accel))
    # the bound of the whole wave counts each ray's needed clusters from the
    # kernel's own t, equal to the plain version's on the blocks compared
    bnd, need = fused_bound(tfu.pack_rays(wo, wd, m.T_MAX), got, big_accel)
    steps = got[:, 6].reshape(-1, b)[:, 0]
    print(f"  K5 dragon8 centre chunk bounce wave ({wo.shape[0]} rays): {int(got[:, 4].sum())} hits, "
          f"{int((got[:, 5] == 0).sum())} unresolved, columns 0-6 identical to the plain version on {sub.numel()} "
          f"rays (every 8th block), clusters retired/block mean {float(steps.mean()):.2f} max {int(steps.max())}, "
          f"clusters needed/ray mean {need:.3f}, kernel {k_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
          f"{100 * bnd[0] / k_ms:.2f}% reached)", flush=True)
    return accel, big, (wo, wd)


def limit_soup_arrays(block=BLOCK, seed=5):
    """LIMIT_TRIS random triangles in [-20, 20]^3 (vertices, indices,
    normals, texcoords, material ids; in clusters of LIMIT_C = 8, K is about
    81,000, above every fused2 entry's old shared-row limit), from seed 5,
    and LIMIT_BUNDLES bundles of ``block`` nearly parallel rays from 30
    units outside toward the volume (o, d, shadow flags, light distances:
    every other ray a shadow lane of the mixed sweep), from ``seed``.  Each
    bundle is one block of rays and retires about 60 clusters, well inside
    max_steps."""
    import numpy as np

    r = np.random.default_rng(5)
    tri = r.uniform(-20, 20, (LIMIT_TRIS, 1, 3)) + r.normal(0, 0.3, (LIMIT_TRIS, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * LIMIT_TRIS, dtype=np.int32).reshape(LIMIT_TRIS, 3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    texcoords = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    mat = r.integers(0, 5, LIMIT_TRIS).astype(np.int32)
    if seed != 5:
        r = np.random.default_rng(seed)
    side = r.normal(size=(LIMIT_BUNDLES, 3))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    start = r.uniform(-15, 15, (LIMIT_BUNDLES, 3)) + 30 * side
    n = LIMIT_BUNDLES * block
    o = (np.repeat(start, block, 0) + r.normal(0, 0.05, (n, 3))).astype(np.float32)
    d = np.repeat(-side, block, 0) + r.normal(0, 0.01, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    shadow = np.arange(n) % 2 == 1
    dist = np.where(shadow, r.uniform(20, 40, n), 1e10).astype(np.float32)
    return (verts, idx, normals, texcoords, mat), (o, d, shadow, dist)


def limit_rays(dev, block=BLOCK, seed=5):
    """The LIMIT_TRIS soup's arrays and its packed rays on ``dev`` for
    ``seed``'s bundles -> (mesh, closest-hit rays, mixed rays, shadow)."""
    import torch

    from owl_path_tracer_tpu_torch.ops.fused2 import pack_rays

    mesh, (o, d, shadow, dist) = limit_soup_arrays(block, seed)
    o, d, dist = (torch.as_tensor(x, device=dev) for x in (o, d, dist))
    shadow = torch.as_tensor(shadow, device=dev)
    return mesh, pack_rays(o, d, 1e10), pack_rays(o, d, dist, shadow), shadow


def old_row_limit(fb, mode, block, limit, with_attrs=True, exact=False, serial=False):
    """The most clusters K whose frontier row [K] f32 (padded to a multiple
    of 4) would have fitted in shared memory beside the rest of the entry's
    block (the kernel library's count) under ``limit``: the cluster limit
    each entry had while its row lay in shared memory."""
    from owl_path_tracer_tpu_torch.ops import fused2

    spare = limit - fused2.block_bytes(fb, mode, block, with_attrs, exact, serial, global_row=True)
    return max(spare // 4 & ~3, 0)


def limit_case(what, fb, rays, want, block, mode, attrs, exact=False, serial=False, shadow=None):
    """One fused2 entry at K above its old shared-row limit: the frontier
    rows must go to device memory, and the outputs meet the plain version
    by the entry's usual rule (component bit for bit
    up to true ties between clusters; the MXU forms by compare_near_tie,
    with the sums' rounding kind and compare_flags for the tensor forms:
    the exact forms differ only where an exact walk never tests a cluster
    the block retires, on bf16 planes at most 0.5% of the rows) ->
    (outputs, old limit)."""
    from owl_path_tracer_tpu_torch.ops import fused2

    limit = fused2.smem_limit(rays.device)
    k, c = fb.num_clusters, fb.cluster_size
    old = old_row_limit(fb, mode, block, limit, attrs, exact, serial)
    form = fused2.row_form(fb, mode, block, rays.device, attrs, exact, serial)
    check(k > old and form == "global", f"{what}: K={k}, old limit {old}, row form {form}")
    got = fused2.fused2_traverse_packed(rays, fb, block=block, mode=mode, with_attrs=attrs, exact=exact,
                                        serial=serial)
    tensor = fb.mxu and not exact
    lanes = ~shadow if mode == "mixed" else None
    if mode == "any_hit":
        check(bool((got[:, 5] == 1).all()), f"{what}: rays unresolved")
        if fb.mxu:
            compare_flags(got, want, what, rays=rays, fb=fb)
        else:
            check(k2_error(got, want, rays) == 0.0, f"{what}: flags differ from the plain version or t lowered")
    else:
        g, w, r = (got, want, rays) if lanes is None else (got[lanes], want[lanes], rays[lanes])
        if fb.mxu:
            compare_near_tie(g, w, r, fb, what, blob=attrs, tensor=tensor)
        else:
            compare(g, w, allow_ties=True)
        if lanes is not None:
            check(bool((got[shadow, 5] == 1).all()), f"{what}: shadow lanes unresolved")
            if fb.mxu:
                compare_flags(got[shadow], want[shadow], f"{what} shadow lanes", rays=rays[shadow], fb=fb)
            else:
                check(bool((got[shadow, 4] == want[shadow, 4]).all()), f"{what}: shadow flags differ")
    steps = got[:, 6].reshape(-1, block)[:, 0]
    print(f"  {what}: K={k} above the old shared-row limit of {old} (C={c}, block {block}, device limit {limit} "
          f"bytes), frontier rows in device memory; {int(got[:, 4].sum())}/{got.shape[0]} hit, clusters/block "
          f"mean {float(steps.mean()):.1f} max {int(steps.max())}; held to the plain version", flush=True)
    return got, old


def above_old_limit(dev, results, block):
    """Phase 4e, first part: every fused2 entry on the LIMIT_TRIS soup (K
    above every entry's old shared-row limit; its rows in device memory)
    against the plain version, the serial yardsticks and the profile entry
    against the slot-parallel body bit for bit -> the component build."""
    import dataclasses

    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    t0 = time.perf_counter()
    mesh, rays, mrays, shadow = limit_rays(dev, block)
    comp = fused2.build_fused2(*mesh[:2], LIMIT_C, *mesh[2:], mxu=False, device=dev)
    f32 = fused2.build_fused2(*mesh[:2], LIMIT_C, *mesh[2:], device=dev)
    bf16 = dataclasses.replace(f32, planes=f32.planes.to(torch.bfloat16))
    k = comp.num_clusters
    check(k >= LIMIT_MIN_K and f32.num_clusters == k, f"the limit soup has K={k} clusters")
    print(f"  {LIMIT_TRIS} triangles in clusters of C={LIMIT_C}: K={k}, {rays.shape[0]} rays in {LIMIT_BUNDLES} "
          f"bundles, built in {time.perf_counter() - t0:.2f} s", flush=True)
    olds = {}
    for fb in (comp, f32, bf16):
        for mode, attrs in (("closest", True), ("any_hit", False), ("mixed", True), ("closest", False)):
            if fb.layout == "mxu_bf16" and (mode, attrs) == ("closest", False):
                continue
            r = mrays if mode == "mixed" else rays
            want = fused2.fused2_traverse_packed_plain(r, fb, mode, attrs)
            sh = shadow if mode == "mixed" else None
            name = fused2._entry(fb, mode, attrs)
            got, olds[name] = limit_case(name, fb, r, want, block, mode, attrs, shadow=sh)
            if fb.layout != "component" and mode == "closest":
                name = fused2._entry(fb, mode, attrs, exact=True)
                _, olds[name] = limit_case(name, fb, r, want, block, mode, attrs, exact=True)
            if fb.layout == "component" and attrs:
                name = fused2._entry(fb, mode, attrs, serial=True)
                serial, olds[name] = limit_case(name, fb, r, want, block, mode, attrs, serial=True, shadow=sh)
                diff = differing_columns(got, serial)
                check(not diff, f"{name}: differs from the slot-parallel body at K={k}: {diff}")
            if fb.layout == "component" and (mode, attrs) == ("closest", True):
                for body in (False, True):
                    out, _ = fused2.fused2_traverse_profile(r, fb, block, serial=body)
                    diff = differing_columns(out, got)
                    check(not diff, f"the profile entry (serial={body}) differs at K={k}: {diff}")
                print(f"  {fused2.PROFILE_ENTRY} (both bodies) at K={k}: equal to the slot-parallel entry bit for "
                      "bit", flush=True)
    results["limit"] = {"k": k, "old_limits": olds}
    return comp


def widen(fb, c):
    """A component build with its clusters widened to ``c`` slots by pad
    slots (zero planes, tri id -1, zero attributes), which no ray hits: the
    same clusters, boxes and answers at another C."""
    import dataclasses

    import torch

    pad = c - fb.cluster_size
    planes = torch.nn.functional.pad(fb.planes, (0, pad))
    planes[:, 9, fb.cluster_size:] = -1.0
    return dataclasses.replace(fb, planes=planes, attrs=torch.nn.functional.pad(fb.attrs, (0, pad)))


def shared_rows(comp, results, block):
    """Phase 4e, second part: the component closest hit (K1), mixed sweep
    (K3) and closest hit without attributes (K4) at C=LIMIT_WIDE_C, where a
    block of rays is a thread block cluster of 4 CTAs that share one
    frontier row in device memory (each writes its share of a refresh,
    every one retires the current cluster in it), at K above their old
    limit: the LIMIT_TRIS soup's clusters widened by pad slots, on the
    bundles of each of LIMIT_SEEDS.  Every launch (LIMIT_REPEATS each)
    equals the serial body at C=512 and the entry at C=8 (one CTA, held to
    the plain version: pad slots change no answer) bit for bit in every
    column; a CTA that retired a cluster before another had picked it would
    set the CTAs testing different clusters."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    dev = comp.boxes.device
    wide = widen(comp, LIMIT_WIDE_C)
    k, limit = wide.num_clusters, fused2.smem_limit(dev)
    ctas = fused2._slot_shape(LIMIT_WIDE_C, "closest")[1]
    check(ctas == 4, f"C={LIMIT_WIDE_C}: {ctas} CTAs per block of rays")
    checked = 0
    for seed in LIMIT_SEEDS:
        _, rays, mrays, shadow = limit_rays(dev, block, seed)
        for mode, attrs in (("closest", True), ("mixed", True), ("closest", False)):
            r = mrays if mode == "mixed" else rays
            name = fused2._entry(wide, mode, attrs)
            old = old_row_limit(wide, mode, block, limit, attrs)
            form = fused2.row_form(wide, mode, block, dev, attrs)
            check(k > old and form == "global", f"{name} at C={LIMIT_WIDE_C}: K={k}, old limit {old}, row form {form}")
            narrow = fused2.fused2_traverse_packed(r, comp, block=block, mode=mode, with_attrs=attrs)
            want = fused2.fused2_traverse_packed_plain(r, comp, mode, attrs)
            if mode == "mixed":
                compare(narrow[~shadow], want[~shadow], allow_ties=True)
                check(bool((narrow[shadow, 4] == want[shadow, 4]).all()), f"{name} seed {seed}: shadow flags differ")
            else:
                compare(narrow, want, allow_ties=True)
            serial, _ = fused2.fused2_traverse_profile(r, wide, block, mode=mode, with_attrs=attrs, serial=True)
            for rep in range(LIMIT_REPEATS):
                got = fused2.fused2_traverse_packed(r, wide, block=block, mode=mode, with_attrs=attrs)
                for other, what in ((serial, "the serial body at C=512"), (narrow, f"the C={LIMIT_C} entry")):
                    diff = differing_columns(got, other)
                    check(not diff, f"{name} at C={LIMIT_WIDE_C}, K={k}, seed {seed}, launch {rep}: differs from "
                                    f"{what}: {diff}")
                checked += 1
    torch.cuda.synchronize()
    results["limit"]["wide"] = {"c": LIMIT_WIDE_C, "ctas": ctas, "launches": checked}
    print(f"  {comp.num_clusters} clusters widened to C={LIMIT_WIDE_C} ({ctas} CTAs per block of rays sharing its "
          f"row; K above the old limit of {old_row_limit(wide, 'closest', block, limit)}): K1, K3 and K4 on seeds "
          f"{list(LIMIT_SEEDS)}, {LIMIT_REPEATS} launches each ({checked} in all), every one equal bit for bit to "
          f"the serial body at C={LIMIT_WIDE_C} and to the C={LIMIT_C} entry (held to the plain version)",
          flush=True)


def dragon8_c128(big, big_wave):
    """dragon8's fused2 builds at C=128 (K about 11,000, where both row
    forms launch) and the centre chunk's bounce wave sorted for each ->
    [(kind, build, packed rays)] for fused2-bf16 and fused2."""
    import dataclasses

    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    wo, wd = big_wave
    t0 = time.perf_counter()
    big32 = fused2.build_fused2_scene(big, cluster_size=128)
    big16 = dataclasses.replace(big32, planes=big32.planes.to(torch.bfloat16))
    torch.cuda.synchronize()
    print(f"  dragon8 fused2 at C=128: K={big32.num_clusters}, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    tm = torch.full((wo.shape[0],), 1e10, device=wo.device)
    mode = fused2.auto_sort_mode(big)
    return [(kind, fb, sorted_rays(wo, wd, tm, fb, mode)[0]) for kind, fb in (("fused2-bf16", big16), ("fused2", big32))]


def row_placement(results, big, big_wave, block):
    """Phase 4e, third part: on dragon8 at C=128 the fused2-bf16 and fused2
    closest-hit entries with the frontier row in shared memory and in device
    memory on the centre chunk's bounce wave, equal bit for bit, timed in
    turns shared, global, global, shared (ROW_REPS timings of 10 launches
    back to back a turn), with each form's median and range."""
    from owl_path_tracer_tpu_torch.ops import fused2

    for kind, fb, rays in dragon8_c128(big, big_wave):
        run = lambda form, fb=fb, rays=rays: fused2._fused2_traverse_cuda(  # noqa: E731
            rays, fb, block, fused2.MAX_STEPS, row=form)
        diff = differing_columns(run("shared"), run("global"))
        check(not diff, f"dragon8 {kind}: the global row differs from the shared row: {diff}")
        times = {"shared": launch_times(lambda: run("shared"), ROW_REPS)}
        times["global"] = launch_times(lambda: run("global"), ROW_REPS) + launch_times(lambda: run("global"), ROW_REPS)
        times["shared"] += launch_times(lambda: run("shared"), ROW_REPS)
        res = {form: fused2.kernel_resources(fb, "closest", block, row=form) for form in fused2.ROW_FORMS}
        ms = {form: statistics.median(t) for form, t in times.items()}
        ships = fused2.row_form(fb, "closest", block, rays.device)
        results[f"row {kind}"] = {"shared_ms": ms["shared"], "global_ms": ms["global"], "ships": ships,
                                  "range_ms": {f: [min(t), max(t)] for f, t in times.items()},
                                  "blocks_per_sm": {f: r["blocks_per_sm"] for f, r in res.items()}}
        print(f"  dragon8 {kind} closest hit, centre chunk bounce wave ({rays.shape[0]} rays, K={fb.num_clusters} "
              f"C=128, block {block}): row in shared memory {ms['shared']:.3f} ms (range {min(times['shared']):.3f}-"
              f"{max(times['shared']):.3f}; {res['shared']['shared_bytes']} bytes, {res['shared']['blocks_per_sm']} "
              f"blocks per SM), in device memory {ms['global']:.3f} ms (range {min(times['global']):.3f}-"
              f"{max(times['global']):.3f}; {res['global']['shared_bytes']} bytes, {res['global']['blocks_per_sm']} "
              f"blocks per SM; in turns shared, global, global, shared, {ROW_REPS} x 10 launches each; "
              f"{ms['global'] / ms['shared']:.3f}x); outputs equal bit for bit; the form that ships at this K: "
              f"{ships}", flush=True)


def row_timing(rounds):
    """``--row-timing``: only phase 4e's dragon8 entries in the form that
    ships, ``rounds`` rounds of ROW_REPS timings of 10 launches back to back
    per entry, on the package beside this script, printed as one JSON line.
    It calls only long-standing functions of the package (compile_scene,
    make_accel, build_fused2_scene, the wave sort, _fused2_traverse_cuda),
    so that the script copied into another checkout times that checkout's
    kernels: run it in turns there and here (other, this, this, other) to
    compare two trees on one card."""
    import torch

    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render import film
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_dragon

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"])
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    settings = RenderSettings(width=SIZE, height=SIZE, max_samples=8, max_path_depth=DEPTH, environment_auto=True)
    big = compile_scene(ROOT / "assets", ensure_dragon(8), (SIZE, SIZE), device=dev)
    wave = scan_waves(big, settings, film.make_accel(big, "fused"), ("centre chunk",))["centre chunk bounce"]
    times = {}
    cases = dragon8_c128(big, wave)
    for _ in range(rounds):
        for kind, fb, rays in cases:
            times.setdefault(kind, []).extend(launch_times(
                lambda fb=fb, rays=rays: fused2._fused2_traverse_cuda(rays, fb, BLOCK, fused2.MAX_STEPS), ROW_REPS))
    print(json.dumps({"row_timing": {"root": str(ROOT), "device": smi, "ms": {
        kind: {"median": statistics.median(t), "min": min(t), "max": max(t), "n": len(t)}
        for kind, t in times.items()}}}), flush=True)


def phase_5d(dev):
    """Scan-renderer frames on make_accel("fused"), card vs CPU: cornell-box
    without and with NEE, and the textured cube."""
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.render import film

    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_texture

    ensure_texture("cube-textures/cube.png")
    for scene_name, use_nee in ((FRAME_SCENE, False), (FRAME_SCENE, True), ("cube", False)):
        fset = RenderSettings(width=FRAME_SIZE, height=FRAME_SIZE, max_samples=FRAME_SPP, max_path_depth=DEPTH,
                              environment_auto=True, use_nee=use_nee)
        extra = {"env_map_path": None} if use_nee else {}
        cpu_scene = compile_scene(ROOT / "assets", scene_name, (FRAME_SIZE, FRAME_SIZE), device="cpu", **extra)
        check(film.scene_has_textures(cpu_scene) == (scene_name == "cube"), f"{scene_name}: textures")
        cpu_accel = film.make_accel(cpu_scene, "fused")
        kw = dict(pixel_chunk=FRAME_SIZE * FRAME_SIZE)
        want = film.add_samples(cpu_scene, fset, film.new_film(fset, device="cpu"), FRAME_SPP, accel=cpu_accel, **kw)
        got = film.add_samples(cpu_scene.to(dev), fset, film.new_film(fset, device=dev), FRAME_SPP,
                               accel=cpu_accel.to(dev), **kw)
        golden(film.finalize(got).cpu(), film.finalize(want), got.rays_traced, want.rays_traced,
               f"scan {scene_name} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP}{' NEE' if use_nee else ''}"
               f"{' textured' if scene_name == 'cube' else ''} on fused, GPU vs CPU")


def phase_6d(scene, settings, accel, lanes):
    """The scan main path, then the wavefront, on the fused accelerator -> K5 launches of the scan frame."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused as tfu
    from owl_path_tracer_tpu_torch.render import film, wavefront

    warm = film.new_film(settings, device=scene.vertices.device)
    film.add_samples(scene, settings, warm, 1, pixel_chunk=SCAN_CHUNK, accel=accel)
    torch.cuda.synchronize()
    tfu.reset_counts()
    start = time.perf_counter()
    fl = film.add_samples(scene, settings, film.new_film(settings, device=scene.vertices.device),
                          settings.max_samples, pixel_chunk=SCAN_CHUNK, accel=accel)
    img = film.finalize(fl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, unresolved = tfu.LAUNCHES[tfu.ENTRY], tfu.UNRESOLVED_RAYS
    chunks = -(-settings.width * settings.height // SCAN_CHUNK)
    expect = chunks * settings.max_samples * settings.max_path_depth
    check(launches == expect, f"scan frame launched K5 {launches} times, expected {expect}")
    check(bool(torch.isfinite(img).all()) and img.shape == (settings.height, settings.width, 3), "scan frame image")
    check(0.0 < img.mean().item() < 10.0, f"scan frame: implausible image mean {img.mean().item()}")
    print(f"  scan, fused {settings.width}x{settings.height} spp {settings.max_samples} depth "
          f"{settings.max_path_depth}: {fl.rays_traced} rays in {seconds:.3f} s = "
          f"{fl.rays_traced / seconds / 1e6:.3f} Mrays/s; K5 launches {launches} ({chunks} chunks x spp x depth), "
          f"unresolved rays {unresolved}, image mean {img.mean().item():.6f}", flush=True)
    torch.cuda.synchronize()
    tfu.reset_counts()
    start = time.perf_counter()
    # bench.py's wavefront flags; the block and sort apply to fused2 only
    img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes, fused2_block=BLOCK,
                                                 fused2_sort=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(tfu.LAUNCHES[tfu.ENTRY] > 0, "the wavefront on fused launched no K5")
    check(bool(torch.isfinite(img).all()) and 0.0 < img.mean().item() < 10.0, "wavefront on fused: image")
    print(f"  wavefront, fused, {lanes} lanes: {rays} rays in {seconds:.3f} s = {rays / seconds / 1e6:.3f} Mrays/s; "
          f"K5 launches {tfu.LAUNCHES[tfu.ENTRY]}, unresolved rays {tfu.UNRESOLVED_RAYS}, image mean "
          f"{img.mean().item():.6f}", flush=True)
    return launches


def phase_6e():
    """The CLI in process on assets/settings.json's scene -> K5 launches."""
    import json

    from owl_path_tracer_tpu_torch.models.scene import compile_scene
    from owl_path_tracer_tpu_torch.ops import fused as tfu
    from owl_path_tracer_tpu_torch.render import film
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_car
    from owl_path_tracer_tpu_torch.utils import cli
    from owl_path_tracer_tpu_torch.utils.image import read_png

    cfg = json.loads((ROOT / "assets" / "settings.json").read_text())
    scene = ensure_car()
    check(film.scene_has_textures(compile_scene(ROOT / "assets", scene, (8, 8), device="cpu")),
          "the car scene the CLI loads has no texture")
    check(cfg["scene"] == scene, f"settings.json renders {cfg['scene']!r}, not {scene!r}")
    out = ROOT / "chiprun_out" / "smoke_cli"
    tfu.reset_counts()
    start = time.perf_counter()
    paths = cli.main(["--assets", str(ROOT / "assets"), "--out", str(out), "--intersector", "fused", "--no-sweep",
                      "--spp", str(CLI_SPP)])
    seconds = time.perf_counter() - start
    width, height = cfg["buffer_size"]
    check([p.name for p in paths] == [f"{scene}.png"], f"CLI wrote {paths}")
    img = read_png(paths[0])
    check(img.shape == (height, width, 4), f"CLI PNG is {img.shape[1]}x{img.shape[0]}, expected {width}x{height}")
    check(img[..., :3].mean() > 0, "CLI PNG is black")
    launches = tfu.LAUNCHES[tfu.ENTRY]
    check(launches > 0, "the CLI launched no K5")
    print(f"  CLI {scene} {width}x{height} depth {cfg['max_path_depth']} spp {CLI_SPP} (settings.json: "
          f"{cfg['max_samples']}, cut for time), textured Ground, --intersector fused: {paths[0].name} "
          f"{img.shape[1]}x{img.shape[0]}, mean {img[..., :3].mean():.3f}/255, {seconds:.3f} s, K5 launches "
          f"{launches}, unresolved rays {tfu.UNRESOLVED_RAYS}", flush=True)


def probe_bound(rays, boxes, planes, name, iters, block, tensor=False):
    """(bound_ms, bound_by) of one K6 launch: phase A's slab tests (every
    ray against every box, fp32) and, per chain and loop iteration, the
    product and the window chain (CHAIN_OPS per ray and slot, fp32), vs the
    inputs read once and the output written once over HBM bytes/s.  The
    CUDA-core (exact) form: the product of the live feature rows (2 x 10 x
    4C FLOP per ray) beside the window over the fp32 peak, and the whole
    planes copied.  ``tensor`` (the tensor form, a variant with a product):
    per chain iteration the larger of the product at the tensor rate (bf16:
    MXU_FLOP per slot at BF16_FLOPS; f32: TF32_FLOP at TF32_FLOPS) and the
    window at the fp32 peak, and the bytes its staging copies (bf16 plane
    rows 0-9, f32 the 19 non-zero feature rows)."""
    from owl_path_tracer_tpu_torch.ops import latency_probe as lp

    v = lp.variant(name)
    n, k, c = rays.shape[0], boxes.shape[1], planes.shape[2] // 4
    chain_iters = n * lp.trips(v, iters) * v.chains
    io = 4 * (rays.numel() + boxes.numel() + n * lp.OUT_COLS)
    if tensor and v.mm:
        flop, peak = (MXU_FLOP, BF16_FLOPS) if v.bf16 else (TF32_FLOP, TF32_FLOPS)
        t_ops = (n * SLAB_OPS * k / FP32_FLOPS + chain_iters * c * max(flop / peak, CHAIN_OPS / FP32_FLOPS)) * 1e3
        staged = k * (10 * 4 * c * 2 if v.bf16 else 19 * c * 4)
        nbytes = io + (staged if v.copy else 0)
    else:
        per_iter = (2 * PROBE_LIVE_FEATURES * 4 * c + CHAIN_OPS * c) if v.mm else 0
        t_ops = (n * SLAB_OPS * k + chain_iters * per_iter) / FP32_FLOPS * 1e3
        nbytes = io + (planes.numel() * planes.dtype.itemsize if v.copy else 0)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def probe_window_bounds(rays, planes, cids, bf16):
    """Per packed ray [n]: (lo, hi), where the tensor form of K6 may put its
    best t, from the plain sums of every slot of the clusters ``cids`` [n, T]
    it tests and their rounding bound (``window_bounds`` with SUM_GAMMA on
    bf16 planes, SUM_GAMMA_F32 on f32): its best t is some slot's t that
    passed its window, so at least lo, the least t - t_err over the slots
    whose window may pass (within); and a slot that surely passes sets the
    best t to its t or lower, so at most hi, the least t + t_err over those
    slots and t_max.  t_err gains PROBE_T_SLACK roundings of t: the
    approximate reciprocal and the window's comparison with the running
    best t, which the plain version rounds otherwise."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    gamma = SUM_GAMMA if bf16 else SUM_GAMMA_F32
    c = planes.shape[2] // 4
    t_max = rays[:, 6]
    lo, hi = t_max.clone(), t_max.clone()
    feat = fused2._ray_features(rays[:, 0:3], rays[:, 3:6], bf16)
    for col in range(cids.shape[1]):
        sums = fused2._feature_sums(feat, planes, cids[:, col], slice(0, c))
        absolute = fused2._feature_sums(feat, planes, cids[:, col], slice(0, c), absolute=True)
        within, _, sure, t, t_err = window_bounds(sums, absolute, gamma, t_max[:, None])
        err = t_err + PROBE_T_SLACK * EPS32 * t.abs()
        low = torch.where(torch.isfinite(err), t - err, -torch.inf)
        lo = torch.minimum(lo, torch.where(within, low, torch.inf).amin(1))
        hi = torch.minimum(hi, torch.where(sure & torch.isfinite(err), t + err, torch.inf).amin(1))
    return lo, hi


def compare_probe_tensor(got, want, rays, boxes, planes, name, iters, block, what):
    """K6's tensor form vs the plain version: columns 1-15 zero, and column
    0 (best t) equal, or within the bounds that the sums' rounding leaves
    it on every slot the block tested (``probe_window_bounds``; the tested
    clusters from ``latency_probe.tested_clusters``); a variant whose
    product reads no planes must be equal -> (max |column 0 error|, rows
    that differ)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import latency_probe as lp

    v = lp.variant(name)
    check(bool((got[..., 1:] == 0).all()), f"{what}: columns 1-15 are not zero")
    g0, w0 = got[..., 0].reshape(-1), want[..., 0].reshape(-1)
    differ = torch.nonzero(g0 != w0).squeeze(1)
    if not differ.numel():
        return 0.0, 0
    check(v.mm and v.copy, f"{what}: column 0 differs from the plain version on {differ.numel()} rows without a "
                           "product of planes")
    cids = lp.tested_clusters(rays, boxes, name, iters, block)[differ // block]
    inside = []
    for lo_i in range(0, differ.numel(), 2048):
        rows = differ[lo_i : lo_i + 2048]
        lo, hi = probe_window_bounds(rays[rows], planes, cids[lo_i : lo_i + 2048], v.bf16)
        inside.append((g0[rows] >= lo) & (g0[rows] <= hi))
    inside = torch.cat(inside)
    print(f"  {what}: best t differs from the plain version on {differ.numel()} of {g0.numel()} rays, "
          f"{int(inside.sum())} within the sums' rounding", flush=True)
    check(bool(inside.all()), f"{what}: {int((~inside).sum())} rays' best t beyond the sums' rounding")
    return float((g0 - w0).abs().max()), differ.numel()


def compare_probe(got, want, name, what):
    """K6's exact form vs its plain version: column 0 bit-equal (rtol 1e-6
    with the approximate reciprocal), columns 1-15 zero -> max |column 0
    error|."""
    import torch

    from owl_path_tracer_tpu_torch.ops import latency_probe as lp

    check(bool((got[..., 1:] == 0).all()), f"{what}: columns 1-15 are not zero")
    if lp.variant(name).recip:
        torch.testing.assert_close(got[..., 0], want[..., 0], rtol=1e-6, atol=0)
    else:
        check(torch.equal(got[..., 0], want[..., 0]), f"{what}: column 0 differs from the plain version")
    return float((got[..., 0] - want[..., 0]).abs().max())


def phase_3f(dev, results):
    """K6 vs its plain version on the soup (MXU clusters of C=64, f32 and
    bf16 planes), every variant, blocks 128 and 256, iters 0, 3 and 8: the
    exact form bit-equal, the tensor form by compare_probe_tensor."""
    import torch

    from owl_path_tracer_tpu_torch.ops import latency_probe as lp
    from owl_path_tracer_tpu_torch.ops.fused2 import pack_rays

    fbs = {dt: soup(dev, plane_dtype=dt)[0] for dt in (torch.float32, torch.bfloat16)}
    _, (o, d, tmax) = soup(dev)
    rays = pack_rays(o[:256], d[:256], tmax[:256])
    err = 0.0
    for name in [*lp.VARIANTS, "interleave2", "interleave4"]:
        v = lp.variant(name)
        fb = fbs[torch.bfloat16 if v.bf16 else torch.float32]
        hits, differ = [], 0
        for block in (128, 256):
            for it in (0, 3, 8):
                what = f"K6 {name} soup block {block} iters {it}"
                want = lp.latency_probe_plain(rays, fb.boxes, fb.planes, name, it, block)
                got_x = lp.latency_probe(rays, fb.boxes, fb.planes, name, it, block, exact=True)
                err = max(err, compare_probe(got_x, want, name, f"{what}, exact form"))
                got = lp.latency_probe(rays, fb.boxes, fb.planes, name, it, block)
                e, n = compare_probe_tensor(got, want, rays, fb.boxes, fb.planes, name, it, block, what)
                err, differ = max(err, e), differ + n
                hits.append(int((got[..., 0].reshape(-1) < rays[:, 6]).sum()))
        print(f"  K6 {name}: the exact form equal to the plain version, the tensor form within the sums' rounding "
              f"({differ} rows differ) at blocks 128/256, iters 0/3/8 (tensor-form hits {hits})", flush=True)
    results["k6_err"] = err


# K6's variants timed in turns, exact form against tensor form (phase 4f)
PROBE_TURNS = ("pick_dma_mm", "pick_dma_mm_bf16", "sched_mm", "sched_mm_bf16", "sched_mm_recip")


def phase_4f(results):
    """The latency probe at its default shapes through the tool's own code
    (the tensor form), every default variant and the bf16 and recip ones ->
    K6 launches; then both forms vs the plain version at iters 16, and the
    product variants timed in turns, exact form against tensor form, beside
    both forms' bounds."""
    import torch

    from owl_path_tracer_tpu_torch.ops import latency_probe as lp
    from owl_path_tracer_tpu_torch.tools import latency_probe as tool

    names = [*lp.DEFAULT_VARIANTS, "sched_mm_bf16", "sched_mm_recip", "sched_dma_bf16", "pick_dma_mm_bf16"]
    args = tool.parse_args(["--variants", ",".join(names)])
    torch.cuda.synchronize()
    lp.reset_counts()
    probe, records = tool.run(args)
    torch.cuda.synchronize()
    launches, exact_launches = lp.LAUNCHES[lp.ENTRY], lp.LAUNCHES[lp.EXACT_ENTRY]
    iters = [int(x) for x in args.iters.split(",")]
    check(launches == len(names) * len(iters) * (1 + tool.REPEATS), f"the probe launched K6 {launches} times")
    check(exact_launches == 0, f"the probe launched the exact form {exact_launches} times")
    for rec in records:
        print(f"  K6 tensor form, {rec['variant']}: {rec['us_per_block_iter']:.4f} us per block and iteration "
              f"(tile {rec['tile']} slots), ms at iters {rec['ms_at']}", flush=True)
    err = 0.0
    it = iters[-1]
    for name in names:
        planes = probe.planes_for(name)
        want = lp.latency_probe_plain(probe.rays, probe.boxes, planes, name, it, args.b)
        what = f"K6 {name} at the default shapes, iters {it}"
        got_x = lp.latency_probe(probe.rays, probe.boxes, planes, name, it, args.b, exact=True)
        tile_x = lp.kernel_tile(probe.rays, probe.boxes, planes, name, args.b, exact=True)
        err = max(err, compare_probe(got_x, want, name, f"{what}, exact form (tiles of {tile_x} slots)"))
        got = lp.latency_probe(probe.rays, probe.boxes, planes, name, it, args.b)
        err = max(err, compare_probe_tensor(got, want, probe.rays, probe.boxes, planes, name, it, args.b,
                                            f"{what}, tensor form")[0])
    turns = {}
    for name in PROBE_TURNS:
        planes = probe.planes_for(name)
        x_ms, t_ms = in_turns(lambda: lp.latency_probe(probe.rays, probe.boxes, planes, name, it, args.b, exact=True),
                              lambda: lp.latency_probe(probe.rays, probe.boxes, planes, name, it, args.b))
        bnd_t = probe_bound(probe.rays, probe.boxes, planes, name, it, args.b, tensor=True)
        bnd_x = probe_bound(probe.rays, probe.boxes, planes, name, it, args.b)
        turns[name] = {"ms": t_ms, "exact_ms": x_ms, "bound": bnd_t, "exact_bound": bnd_x}
        print(f"  K6 {name} at iters {it}: exact form {x_ms:.3f} ms, tensor form {t_ms:.3f} ms (in turns exact, "
              f"tensor, tensor, exact; {x_ms / t_ms:.2f}x); tensor bound {bnd_t[0]:.4f} ms ({bnd_t[1]}, "
              f"{100 * bnd_t[0] / t_ms:.1f}% reached), exact bound {bnd_x[0]:.4f} ms ({bnd_x[1]}, "
              f"{100 * bnd_x[0] / x_ms:.1f}% reached)", flush=True)
    planes = probe.planes_for("pick_dma_mm")
    plain_ms = cuda_ms(lambda: lp.latency_probe_plain(probe.rays, probe.boxes, planes, "pick_dma_mm", it, args.b),
                       reps=1)
    full = turns["pick_dma_mm"]
    print(f"  K6 vs plain at iters {it}: every variant's exact form equal, tensor form within the sums' rounding "
          f"(max |col 0 err| {err:.3g}); pick_dma_mm tensor {full['ms']:.3f} ms, exact {full['exact_ms']:.3f} ms, "
          f"plain {plain_ms:.3f} ms; {launches} launches", flush=True)
    results["k6"] = dict(full, plain_ms=plain_ms, launches=launches, exact_launches=exact_launches, turns=turns)
    results["k6_err"] = max(results["k6_err"], err)


def phase_6f(dev):
    """The production path (tools/render_production.py's frame): the car of
    assets/settings.json at its size and depth, 131072 lanes, sort on, spp
    cut to 2 in segments of 1, each frame uninterrupted and then stopped
    mid-segment by drained checkpoints and resumed: on the component layout
    (the exact witness of resumption) and on fused2-bf16 (the production
    accelerator); a checkpoint refused under another scene or accelerator;
    then the tool's own main."""
    import contextlib
    import dataclasses
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.models.scene import compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render import wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel
    from owl_path_tracer_tpu_torch.tools import render_production as rp
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_car

    ensure_car()
    name, one = rp.production_settings(ROOT / "assets", 1)
    scene = compile_scene(ROOT / "assets", name, (one.width, one.height), device=dev)
    accel = make_accel(scene, "fused2-bf16")
    comp = fused2.build_fused2_scene(scene, cluster_size=accel.cluster_size, mxu=False)
    out = ROOT / "chiprun_out" / "smoke_production"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    kw = dict(lanes=LANES, fused2_sort=True)
    total = one.width * one.height

    def frame(acc, extra):
        """The frame's segments on ``acc``, each with ``extra(sample_base)`` -> (mean image, rays)."""
        imgs, rays = [], 0
        for base in range(PRODUCTION_SPP):
            img, r = wavefront.render_image_wavefront(scene, one, acc, sample_base=base, **kw, **extra(base))
            imgs.append(img)
            rays += r
        return torch.stack(imgs).mean(0), rays

    def timed_frame(acc, what):
        torch.cuda.synchronize()
        start = time.perf_counter()
        img, rays = frame(acc, lambda base: {})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        check(bool(torch.isfinite(img).all()) and 0.0 < img.mean().item() < 10.0, f"{what}: production frame image")
        print(f"  car {one.width}x{one.height} depth {one.max_path_depth} spp {PRODUCTION_SPP} ({PRODUCTION_SPP} "
              f"segments of 1) on {what}: {rays} rays in {seconds:.3f} s = {rays / seconds / 1e6:.3f} Mrays/s; "
              f"unresolved rays {fused2.UNRESOLVED_RAYS}, image mean {img.mean().item():.6f}", flush=True)
        return img, rays

    def stop_and_resume(acc, what, ck_dir):
        """Segment 0 stopped after 2 launches of 4 steps, each followed by a
        drained checkpoint, then the frame resumed -> (image, rays)."""
        ck_dir.mkdir()
        ck = ck_dir / "seg0.ck"
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            wavefront.render_image_wavefront(scene, one, acc, checkpoint_path=str(ck), checkpoint_every_s=0.0,
                                             max_launches=2, iters_per_launch=4, progress=True, **kw)
        drains = re.findall(r"drain ([0-9.]+) s", log.getvalue())
        writes = re.findall(r"write ([0-9.]+) s", log.getvalue())
        check(len(drains) == len(writes) == 2, f"{what}: not 2 checkpoints in the progress lines {log.getvalue()!r}")
        with np.load(ck) as z:
            stopped_at = int(z["work_counter"])
        check(0 < stopped_at < total, f"{what}: the stopped segment is not mid-segment: work counter "
                                      f"{stopped_at}/{total}")
        shutil.copy(ck, ck_dir / "seg0_stopped.ck")
        img, rays = frame(acc, lambda base: dict(checkpoint_path=str(ck_dir / f"seg{base}.ck")))
        print(f"  {what}: stopped at work item {stopped_at}/{total} after 2 launches of 4 steps, each drained "
              f"({', '.join(drains)} s) and written ({', '.join(writes)} s); resumed: {rays} rays", flush=True)
        return img, rays

    # the exact witness: on the component layout a ray's winner does not
    # depend on the rays beside it, so the resumed frame traces the same rays
    want_c, rays_want_c = timed_frame(comp, "the component layout")
    img, rays = stop_and_resume(comp, "component layout", out / "component")
    check(rays == rays_want_c, f"component layout: the resumed frame traced {rays} rays, the uninterrupted one "
                               f"{rays_want_c}")
    golden(img.cpu(), want_c.cpu(), rays, rays_want_c, "car on the component layout, stopped and resumed")

    torch.cuda.synchronize()
    fused2.reset_counts()
    want, rays_want = timed_frame(accel, "fused2-bf16")
    launches = fused2.LAUNCHES["owlpt_fused2_mxu_bf16_closest_hit"]
    check(launches > 0, "the production frame launched no K1b bf16 closest hit")
    print(f"  K1b bf16 closest-hit launches of the fused2-bf16 frame: {launches}", flush=True)
    img, rays = stop_and_resume(accel, "fused2-bf16", out / "bf16")
    # on bf16 planes a ray's winner may depend on the rays beside it in its
    # block (a near tie, or a hit in a cluster its own walk would not test:
    # compare_near_tie), and the resumed waves hold other rays, so a few
    # paths may take another turn; the component layout's frame above
    # resumes to exactly its rays
    check(abs(rays - rays_want) <= 1e-4 * rays_want,
          f"fused2-bf16: the resumed frame traced {rays} rays, the uninterrupted one {rays_want}: more than 1e-4 "
          "apart")
    golden(img.cpu(), want.cpu(), rays, rays_want, "car production frame, stopped and resumed vs uninterrupted")

    # a checkpoint written under another accelerator or scene is refused
    mats = scene.materials
    brighter = dataclasses.replace(scene, materials=dataclasses.replace(mats, emission=mats.emission * 2))
    for what, (sc, ac) in {"accel": (scene, make_accel(scene, "fused2")), "scene": (brighter, accel)}.items():
        try:
            wavefront.render_image_wavefront(sc, one, ac, checkpoint_path=str(out / "bf16" / "seg0_stopped.ck"),
                                             **kw)
            raise SmokeFailure(f"a checkpoint was resumed under another {what}")
        except ValueError as e:
            check(f"'{what}'" in str(e), f"the refusal does not name {what!r}: {e}")
    print("  resuming under another accelerator (fused2) or scene (emission x2) raises ValueError naming it")

    gallery = sorted((ROOT / "docs" / "gallery").glob("*"))
    start = time.perf_counter()
    rec = rp.main(["--spp", str(PRODUCTION_SPP), "--seg-spp", "1", "--device", "cuda", "--out-dir",
                   str(out / "tool")])
    seconds = time.perf_counter() - start
    check(rec["rays_total"] == rays_want, f"render_production traced {rec['rays_total']} rays, not {rays_want}")
    check((out / "tool" / f"car_production_spp{PRODUCTION_SPP}.png").exists(), "render_production wrote no PNG")
    check(sorted((ROOT / "docs" / "gallery").glob("*")) == gallery, "render_production wrote under docs/gallery")
    print(f"  render_production --spp {PRODUCTION_SPP} --seg-spp 1: {rec['rays_total']} rays, "
          f"{rec['mrays_per_s']:.3f} Mrays/s over its segments, {seconds:.3f} s in main, PNG and JSON in "
          f"{(out / 'tool').relative_to(ROOT)}", flush=True)
    return launches


# ── the gradient path (render/diff.py): phases 5g and 6g ─────────────────


def sphere_mesh(radius, n_theta=24, n_phi=48):
    """tests/test_integrator.py's UV sphere about the origin -> (vertices, indices, normals)."""
    import numpy as np

    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = i * n_phi + j, (i + 1) * n_phi + j
            c, d = (i + 1) * n_phi + (j + 1) % n_phi, i * n_phi + (j + 1) % n_phi
            if i > 0:
                idx.append((a, b, d))
            if i < n_theta - 1:
                idx.append((b, c, d))
    return (radius * n).astype(np.float32), np.asarray(idx, np.int32), n.astype(np.float32)


def grad_sphere(radius=1.0, size=GRAD_SIZE, **mat):
    """tests/test_diff.py's diffuse sphere (camera at (3, 0, 0)) on the CPU."""
    import numpy as np

    from owl_path_tracer_tpu_torch.models import camera, material
    from owl_path_tracer_tpu_torch.models.scene import scene_from_arrays
    from owl_path_tracer_tpu_torch.utils.parser import CameraDesc

    v, idx, n = sphere_mesh(radius)
    mats = material.single(device="cpu", **{"base_color": (0.6, 0.4, 0.3), "roughness": 0.7, "specular": 0.0, **mat})
    cam = camera.make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (size, size), device="cpu")
    return scene_from_arrays(v, idx, mats, np.zeros(len(idx), np.int32), cam, normals=n, device="cpu")


class recorded_waves:
    """Context: every launch of the fused2 kernel as (packed rays, accel,
    launch arguments, output), for checking the waves against the plain
    version afterwards."""

    def __enter__(self):
        from owl_path_tracer_tpu_torch.ops import fused2

        self.waves, self.launch = [], fused2._fused2_traverse_cuda

        def record(rays, fb, *args):
            out = self.launch(rays, fb, *args)
            self.waves.append((rays, fb, args, out))
            return out

        fused2._fused2_traverse_cuda = record
        return self.waves

    def __exit__(self, *exc):
        from owl_path_tracer_tpu_torch.ops import fused2

        fused2._fused2_traverse_cuda = self.launch


class counted_rays:
    """Context: the live-ray counts of every ``integrator.sample_sum`` call
    (0-dim tensors; the gradient path renders through it)."""

    def __enter__(self):
        from owl_path_tracer_tpu_torch.render import integrator

        self.counts, self.inner = [], integrator.sample_sum

        def sample_sum(*args, **kw):
            acc, state, rays = self.inner(*args, **kw)
            self.counts.append(rays)
            return acc, state, rays

        integrator.sample_sum = sample_sum
        return self.counts

    def __exit__(self, *exc):
        from owl_path_tracer_tpu_torch.render import integrator

        integrator.sample_sum = self.inner


def differing_rows(waves, what):
    """Each recorded wave against the plain version of its rays, by
    compare_near_tie (closest, mixed) or compare_flags (any-hit), the
    tensor-core rounding kinds -> the rows (= pixels of the scan loop) whose
    winners or flags differ, every one explained."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    rows = set()
    for i, (rays, fb, args, out) in enumerate(waves):
        mode, with_attrs = args[2], args[4]
        want = fused2.fused2_traverse_packed_plain(rays, fb, mode, with_attrs)
        if mode == "any_hit":
            compare_flags(out, want, f"{what}, wave {i} (any-hit)", min_share=0.995, rays=rays, fb=fb)
            differ = out[:, 4] != want[:, 4]
        else:
            compare_near_tie(out, want, rays, fb, f"{what}, wave {i} ({mode})", blob=with_attrs,
                             tensor=fb.layout != "component")
            differ = out[:, 3] != want[:, 3]
        rows |= set(torch.nonzero(differ).squeeze(1).tolist())
    return rows


def as_arrays(grads):
    """Gradients (a tensor or a dataclass of tensors) -> dict of numpy arrays."""
    from owl_path_tracer_tpu_torch import convert

    if hasattr(grads, "shape"):
        return {"env_map": grads.detach().cpu().numpy()}
    return convert.to_numpy(grads)


def float64(bundle):
    """A dataclass of tensors with its floating fields in float64."""
    import dataclasses

    def cast(v):
        if dataclasses.is_dataclass(v):
            return float64(v)
        return v.double() if v.is_floating_point() else v

    return dataclasses.replace(bundle, **{f.name: cast(getattr(bundle, f.name)) for f in dataclasses.fields(bundle)})


def hold_grads(got, want, what, exact=None):
    """Card gradients against the CPU's, per field allclose(rtol=GRAD_RTOL,
    atol=GRAD_ATOL_OF_MAX * max|g_cpu|) -> worst ratio of the difference to
    that tolerance.  ``exact()`` (the same loss in float64 on the card, the
    brute sweep) is asked only when an element is outside it: such an
    element passes only when float32 cannot resolve it, i.e. the CPU's
    float32 value lies outside the tolerance of the float64 one and the
    card's within 4x the CPU's distance from it; they are counted and printed."""
    import numpy as np

    worst, explained = 0.0, []
    e = None
    for name, w in want.items():
        g = got[name]
        check(g.shape == w.shape and np.isfinite(g).all(), f"{what}: {name} gradient not finite")
        tol = GRAD_RTOL * np.abs(w) + GRAD_ATOL_OF_MAX * np.abs(w).max()
        off = ~(np.abs(g - w) <= tol)
        if off.any():
            e = exact() if e is None else e
            x = e[name]
            ok = (np.abs(w - x) > tol) & (np.abs(g - x) <= 4 * np.abs(w - x))
            check(bool(ok[off].all()), f"{what}: {name} card {g[off][:4]} vs CPU {w[off][:4]} (float64 {x[off][:4]})")
            explained.append(f"{name}{np.argwhere(off).tolist()}: card {g[off]}, CPU {w[off]}, float64 {x[off]}")
            g = np.where(off, w, g)
        if tol.max() > 0:
            worst = max(worst, float((np.abs(g - w) / np.where(tol > 0, tol, 1.0)).max()))
    print(f"  {what}: worst |card - CPU| / tolerance {worst:.3g}; {len(explained)} fields with elements float32 "
          f"cannot resolve" + "".join(f"\n    {x}" for x in explained), flush=True)
    return worst


def grads_card_vs_cpu(dev, what, fn, scene, accel, px, exact=None):
    """``fn(scene, accel, px) -> (loss, grads)`` on the card (its fused2
    waves recorded and held against the plain version) and on the CPU (the
    plain versions); where winners differ, both again without those pixels.
    -> (card launches by entry, worst ratio)."""
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    fused2.reset_counts()
    with recorded_waves() as waves:
        loss_g, g_g = fn(scene.to(dev), None if accel is None else accel.to(dev), px.to(dev))
    launches = {k: v for k, v in fused2.LAUNCHES.items() if v}
    rows = differing_rows(waves, what)
    keep = torch.ones(px.shape[0], dtype=torch.bool)
    if rows:
        keep[sorted(rows)] = False
        print(f"  {what}: {len(rows)} pixels whose winners differ are left out", flush=True)
        loss_g, g_g = fn(scene.to(dev), accel.to(dev), px[keep].to(dev))
    loss_c, g_c = fn(scene, accel, px[keep])
    check(math.isclose(float(loss_g), float(loss_c), rel_tol=GRAD_RTOL),
          f"{what}: loss {float(loss_g)} on the card, {float(loss_c)} on the CPU")
    worst = hold_grads(as_arrays(g_g), as_arrays(g_c), what,
                       exact=None if exact is None else lambda: as_arrays(exact(px[keep].to(dev))[1]))
    print(f"  {what}: loss {float(loss_g):.7g} (CPU {float(loss_c):.7g}), launches {launches}", flush=True)
    return launches, worst


def phase_5g(dev):
    """Gradients on the card against the CPU: material, camera and NEE
    gradients through make_accel("fused2") (K1b f32 under autograd,
    differentiable=True), an FD check through K1b, fused2-bf16 material
    gradients, and brute against cluster bit for bit -> K1b launches of the
    gradient path by entry."""
    import dataclasses

    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops.cluster import cluster_closest_hit, cluster_occluded
    from owl_path_tracer_tpu_torch.ops.intersect import any_hit_brute, closest_hit_brute
    from owl_path_tracer_tpu_torch.render import diff
    from owl_path_tracer_tpu_torch.render.film import _pixel_grid, make_accel, render_image
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_car

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def zeros(px):
        return torch.zeros((px.shape[0], 3), device=px.device)

    def material_fn(settings, spp):
        return lambda scene, accel, px: diff.loss_and_grad(scene, scene.materials, settings, px, zeros(px), spp,
                                                           accel)

    def exact_of(scene, settings, spp):
        s64 = float64(scene.to(dev))
        return lambda px: diff.loss_and_grad(s64, s64.materials, settings, px, zeros(px), spp, None)

    # the 16x16 diffuse sphere of tests/test_diff.py, 4 spp, depth 3
    sphere = grad_sphere()
    sset = RenderSettings(width=GRAD_SIZE, height=GRAD_SIZE, max_samples=4, max_path_depth=3,
                          environment_color=(1.0, 0.9, 0.8), environment_intensity=1.0)
    px = _pixel_grid(GRAD_SIZE, GRAD_SIZE, "cpu")
    accel = make_accel(sphere, "fused2")
    counts, _ = grads_card_vs_cpu(dev, "sphere materials, fused2", material_fn(sset, 4), sphere, accel, px,
                                  exact=exact_of(sphere, sset, 4))
    check(counts.get("owlpt_fused2_mxu_closest_hit", 0) > 0, "the gradient path did not launch K1b f32 closest hit")
    add(counts)
    # one FD check of base_color through K1b (tests/test_diff.py's rtol 0.05)
    sc, ac, pxd = sphere.to(dev), accel.to(dev), px.to(dev)
    target = torch.zeros((pxd.shape[0], 3), device=dev)
    _, g = diff.loss_and_grad(sc, sc.materials, sset, pxd, target, 4, ac)

    def loss_at(delta):
        bc = sc.materials.base_color.clone()
        bc[0, 0] += delta
        return float(diff.image_loss(sc, dataclasses.replace(sc.materials, base_color=bc), sset, pxd, target, 4, ac))

    fd = (loss_at(1e-3) - loss_at(-1e-3)) / 2e-3
    ad = float(g.base_color[0, 0])
    print(f"  sphere base_color[0,0] through K1b: autograd {ad:.7g}, central difference {fd:.7g}", flush=True)
    check(abs(ad - fd) <= 0.05 * abs(fd), f"FD check through K1b: {ad} vs {fd}")

    # camera gradients through the refit: tests/test_diff.py's radius-2 sphere
    big = grad_sphere(radius=2.0)
    cset = dataclasses.replace(sset, environment_auto=True)

    def camera_fn(scene, accel, px):
        return diff.camera_loss_and_grad(scene, scene.camera, cset, px, zeros(px), 4, accel)

    b64 = float64(big.to(dev))
    counts, _ = grads_card_vs_cpu(dev, "sphere camera, fused2 refit", camera_fn, big, make_accel(big, "fused2"), px,
                                  exact=lambda p: camera_fn(b64, None, p))
    add(counts)

    # the car at 32x32 (materials), and cornell-box with NEE (K1b any-hit too)
    ensure_car()
    car = compile_scene(ROOT / "assets", "car", (GRAD_CAR_SIZE, GRAD_CAR_SIZE), env_map_path=None, device="cpu")
    carset = RenderSettings(width=GRAD_CAR_SIZE, height=GRAD_CAR_SIZE, max_samples=2, max_path_depth=3,
                            environment_auto=True)
    cpx = _pixel_grid(GRAD_CAR_SIZE, GRAD_CAR_SIZE, "cpu")
    counts, _ = grads_card_vs_cpu(dev, "car materials, fused2", material_fn(carset, 2), car, make_accel(car, "fused2"), cpx,
                                  exact=exact_of(car, carset, 2))
    add(counts)
    cornell = compile_scene(ROOT / "assets", NEE_SCENE, (GRAD_CAR_SIZE, GRAD_CAR_SIZE), env_map_path=None,
                            device="cpu")
    nset = dataclasses.replace(carset, use_nee=True)
    counts, _ = grads_card_vs_cpu(dev, "cornell NEE materials, fused2", material_fn(nset, 2), cornell,
                                  make_accel(cornell, "fused2"), cpx, exact=exact_of(cornell, nset, 2))
    check(counts.get("owlpt_fused2_mxu_occluded", 0) > 0, "the NEE gradient path did not launch K1b f32 any-hit")
    add(counts)

    # fused2-bf16: material gradients must be finite
    fused2.reset_counts()
    cd = car.to(dev)
    loss, g = diff.loss_and_grad(cd, cd.materials, carset, cpx.to(dev), zeros(cpx.to(dev)), 2,
                                 make_accel(cd, "fused2-bf16"))
    arrays = as_arrays(g)
    check(all(np.isfinite(a).all() for a in arrays.values()) and np.abs(arrays["base_color"]).max() > 0,
          "fused2-bf16 material gradients are not finite")
    check(fused2.LAUNCHES["owlpt_fused2_mxu_bf16_closest_hit"] > 0, "the bf16 gradient path did not launch K1b bf16")
    print(f"  car materials on fused2-bf16: loss {float(loss):.7g}, |base_color grad| max "
          f"{np.abs(arrays['base_color']).max():.4g}, launches "
          f"{ {k: v for k, v in fused2.LAUNCHES.items() if v} }", flush=True)
    add({k: v for k, v in fused2.LAUNCHES.items() if v})

    # brute against cluster, bit for bit, on the card
    cs = cornell.to(dev)
    cb = make_accel(cs, "cluster", cluster_size=64)
    frame = RenderSettings(width=GRAD_CAR_SIZE, height=GRAD_CAR_SIZE, max_samples=2, max_path_depth=DEPTH,
                           environment_auto=True)
    a = render_image(cs, frame, pixel_chunk=4096, intersector="brute")
    b = render_image(cs, frame, pixel_chunk=4096, accel=cb)
    check(torch.equal(a, b), "brute and cluster frames differ on the card")
    gen = torch.Generator(device="cpu").manual_seed(0)
    lo, hi = cs.vertices.min(0).values, cs.vertices.max(0).values
    o = lo + (torch.rand((8192, 3), generator=gen) * 0.8 + 0.1).to(dev) * (hi - lo)
    d = torch.nn.functional.normalize(torch.randn((8192, 3), generator=gen), dim=-1).to(dev)
    rb, rc = closest_hit_brute(o, d, cs.vertices, cs.tri_idx), cluster_closest_hit(o, d, cb)
    check(torch.equal(rb.tri, rc.tri) and torch.equal(rb.t, rc.t) and torch.equal(rb.uv, rc.uv),
          "brute and cluster hits differ on the card")
    tmax = torch.full((8192,), 0.5, device=dev)
    check(torch.equal(any_hit_brute(o, d, cs.vertices, cs.tri_idx, t_max=tmax), cluster_occluded(o, d, cb, t_max=tmax)),
          "brute and cluster occlusion differ on the card")
    print(f"  brute = cluster on the card: {NEE_SCENE} {GRAD_CAR_SIZE}x{GRAD_CAR_SIZE} frame bit for bit, 8192 rays' "
          f"tri/t/u/v ({int((rb.tri >= 0).sum())} hits) and occlusion", flush=True)
    return launches


def phase_6g(dev, smi):
    """Material recovery at full size (BASELINE.json config 5): mitsuba and
    the car on make_accel("fused2"), GRAD_FULL x GRAD_FULL (one scan chunk),
    spp 4, depth 3, auto sky, 10 Adam steps on one material's base_color
    -> K1b launches per step by scene."""
    import dataclasses
    import tempfile

    import torch

    from owl_path_tracer_tpu_torch.models.material import Materials
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.render import diff, metrics
    from owl_path_tracer_tpu_torch.render.film import _pixel_grid, make_accel
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_car, ensure_mitsuba

    size, spp, steps = GRAD_FULL, 4, GRAD_STEPS
    settings = RenderSettings(width=size, height=size, max_samples=spp, max_path_depth=3, environment_auto=True,
                              environment_intensity=1.0)
    px = _pixel_grid(size, size, dev)
    per_step = {}
    for name, lr in ((ensure_mitsuba(), 0.1), (ensure_car(), 0.08)):
        scene = compile_scene(ROOT / "assets", name, (size, size), env_map_path=None, device=dev)
        accel = make_accel(scene, "fused2")
        with torch.no_grad():
            target = diff.render_with_materials(scene, scene.materials, settings, px, spp, accel)
        mats, mask = scene.materials, None
        row = 0
        if name == "car":  # the window glass, alone (tests/test_diff.py::test_car_recovery_smoke)
            row = int(torch.nonzero(mats.specular_transmission >= 0.99)[0])
            mask = Materials(**{f.name: torch.zeros_like(getattr(mats, f.name)) for f in dataclasses.fields(Materials)})
            mask.base_color[row] = 1.0
        bc = mats.base_color.clone()
        bc[row] = torch.tensor([0.2, 0.2, 0.2] if name == "car" else [0.5, 0.5, 0.5], device=dev)
        init = dataclasses.replace(mats, base_color=bc)
        # warm-up, untimed (the first Adam step of a process imports and sets up the optimiser's code)
        diff.recover_materials(scene, settings, target, px, init, steps=1, lr=lr, num_samples=spp, accel=accel,
                               trainable=("base_color",), grad_mask=mask)
        fused2.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        res = diff.recover_materials(scene, settings, target, px, init, steps=steps, lr=lr, num_samples=spp,
                                     accel=accel, trainable=("base_color",), grad_mask=mask)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {k: v for k, v in fused2.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        losses = [round(float(x), 7) for x in res.losses]
        drop = 0.7 if name == "car" else 1.0
        check(all(math.isfinite(x) for x in losses) and losses[-1] < drop * losses[0],
              f"{name} recovery: the loss did not fall below {drop} of its first value: {losses}")
        # one more loss + backward, timed alone with its live rays and under the profiler
        with counted_rays() as counts:
            torch.cuda.synchronize()
            start = time.perf_counter()
            diff.loss_and_grad(scene, res.materials, settings, px, target, spp, accel)
            torch.cuda.synchronize()
            fwd_bwd = time.perf_counter() - start
        rays = int(sum(int(c) for c in counts))
        with tempfile.TemporaryDirectory() as trace_dir, metrics.profile_trace(trace_dir) as prof:
            start = time.perf_counter()
            diff.loss_and_grad(scene, res.materials, settings, px, target, spp, accel)
            torch.cuda.synchronize()
            traced = time.perf_counter() - start
        # host time of each owlpt.* range (CPU events) and the span of its
        # work on the card (the range's device annotation); device busy =
        # the kernels' and copies' own time, annotations left out
        host, span, kernels = {}, {}, {}
        for ev in prof.events():
            us = ev.time_range.elapsed_us()
            if ev.name.startswith("owlpt."):
                side = span if ev.device_type == torch.autograd.DeviceType.CUDA else host
                side[ev.name] = side.get(ev.name, 0.0) + us / 1e3
            elif ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3
        device_us = 1e3 * sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        per_step[name] = {k: v / steps for k, v in launches.items()}
        print(f"  {name} {size}x{size} spp {spp} depth 3 on fused2 ({int(scene.tri_idx.shape[0])} triangles, "
              f"K={accel.num_clusters}, C={accel.cluster_size}), {steps} Adam steps on base_color row {row}: "
              f"losses {losses}", flush=True)
        print(f"  {name}: {seconds / steps:.4f} s per step; loss + backward {fwd_bwd:.4f} s for {rays} live rays = "
              f"{rays / fwd_bwd / 1e6:.4f} Mrays/s (fwd+bwd); peak memory {peak / 2**30:.3f} GiB; K1b launches per "
              f"step {per_step[name]}; [{smi}]", flush=True)
        print(f"  {name}, one traced loss + backward ({traced:.4f} s): device busy {device_us / 1e6:.4f} s "
              f"({device_us / 1e6 / traced:.1%} of the wall time); forward ranges, host ms / device span ms: "
              + ", ".join(f"{k} {v:.1f} / {span.get(k, 0.0):.1f}" for k, v in sorted(host.items()))
              + "; top device kernels, ms: " + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top), flush=True)
    return per_step


def two_rank_frames(mesh, dragon, size, spp, lanes, block):
    """One rank of phase 6h's two-rank run (spawned): dragon at ``size`` on
    fused2-bf16, both work splits -> (split, image, rays, stats, K1b bf16
    closest-hit launches) per split, as numpy and ints."""
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.parallel import shard
    from owl_path_tracer_tpu_torch.render.film import make_accel

    scene = compile_scene(ROOT / "assets", dragon, (size, size), device=mesh.device)
    settings = RenderSettings(width=size, height=size, max_samples=spp, max_path_depth=DEPTH, environment_auto=True)
    accel = make_accel(scene, "fused2-bf16")
    out = []
    for split in ("sample", "contiguous"):
        fused2.reset_counts()
        img, rays, stats = shard.render_image_wavefront_sharded(
            scene, settings, mesh=mesh, accel=accel, lanes_per_chip=lanes, fused2_block=block, fused2_sort=True,
            work_split=split, return_stats=True)
        out.append((split, img.cpu().numpy(), rays, stats, fused2.LAUNCHES["owlpt_fused2_mxu_bf16_closest_hit"]))
    return out


def phase_6h(dev, scene, settings, dragon, lanes, block, smi):
    """Multi-device rendering (parallel/shard.py) -> K1b launches of the
    sharded paths: {"bf16": world-1 frame, "f32": per sharded loss call,
    "two_ranks": each rank's bf16 launches per split}."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.ops import fused2, rng
    from owl_path_tracer_tpu_torch.parallel import shard
    from owl_path_tracer_tpu_torch.render import diff, wavefront
    from owl_path_tracer_tpu_torch.render.film import _pixel_grid, make_accel, scene_has_textures
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_mitsuba

    launches = {}
    accel = make_accel(scene, "fused2-bf16")
    with tempfile.TemporaryDirectory() as tmp:
        mesh = shard.make_pixel_mesh(dev, init_method=(pathlib.Path(tmp) / "store").as_uri(), rank=0,
                                     world_size=1)
        try:
            check(mesh.size == 1, f"world 1 mesh {mesh}")
            # the main path, sharded at world size 1 (work_map the identity),
            # in turns with the unsharded frame: unsharded, sharded, sharded, unsharded
            def frame(sharded):
                torch.cuda.synchronize()
                fused2.reset_counts()
                start = time.perf_counter()
                if sharded:
                    img, rays, _ = shard.render_image_wavefront_sharded(
                        scene, settings, mesh=mesh, accel=accel, lanes_per_chip=lanes, fused2_block=block,
                        fused2_sort=True, return_stats=True)
                else:
                    img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes,
                                                                 fused2_block=block, fused2_sort=True)
                torch.cuda.synchronize()
                return img, rays, time.perf_counter() - start, fused2.LAUNCHES["owlpt_fused2_mxu_bf16_closest_hit"]

            turns = [frame(sharded) for sharded in (False, True, True, False)]
            (want, rays_want, _, _), (img, rays, _, launches["bf16"]) = turns[0], turns[1]
            check(launches["bf16"] > 0, "the sharded main path launched no K1b")
            differ = max(int((t[0] != want).sum()) for t in turns)
            print(f"  {dragon} {settings.width}x{settings.height} spp {settings.max_samples} on fused2-bf16 through "
                  f"{mesh.backend} at world size 1: {rays} rays, {turns[1][2]:.3f} / {turns[2][2]:.3f} s = "
                  f"{rays / statistics.median([turns[1][2], turns[2][2]]) / 1e6:.3f} Mrays/s; unsharded, in turns: "
                  f"{rays_want} rays, {turns[0][2]:.3f} / {turns[3][2]:.3f} s; K1b launches {launches['bf16']} "
                  f"(unsharded {turns[0][3]}); differing film values {differ}; [{smi}]", flush=True)
            check(differ == 0 and all(t[1] == rays_want for t in turns),
                  "the world-1 sharded frame differs from render_image_wavefront")

            # sharded_loss_and_grad at world size 1 against render/diff.py::loss_and_grad
            gscene = compile_scene(ROOT / "assets", ensure_mitsuba(), (GRAD_FULL, GRAD_FULL), env_map_path=None,
                                   device=dev)
            gset = RenderSettings(width=GRAD_FULL, height=GRAD_FULL, max_samples=4, max_path_depth=3,
                                  environment_auto=True, environment_intensity=1.0)
            check(not scene_has_textures(gscene), "mitsuba has textures: the two losses would differ")
            gaccel = make_accel(gscene, "fused2")
            px = _pixel_grid(GRAD_FULL, GRAD_FULL, dev)
            target = torch.full((px.shape[0], 3), 0.5, device=dev)
            fn = shard.sharded_loss_and_grad(mesh, gscene, gset, gaccel, 4)
            fused2.reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss, grads = fn(gscene.materials, px, rng.seed(px[:, 0], px[:, 1]), target)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches["f32"] = fused2.LAUNCHES["owlpt_fused2_mxu_closest_hit"]
            loss_1, grads_1 = diff.loss_and_grad(gscene, gscene.materials, gset, px, target, 4, gaccel)
            worst = 0.0
            for f in dataclasses.fields(grads_1):
                g, w = getattr(grads, f.name), getattr(grads_1, f.name)
                torch.testing.assert_close(g, w, rtol=1e-6, atol=GRAD_ATOL_OF_MAX * float(w.abs().max()))
                worst = max(worst, float(((g - w).abs() / w.abs().clamp(min=1e-30)).max()))
            torch.testing.assert_close(loss, loss_1, rtol=1e-6, atol=0.0)
            print(f"  sharded_loss_and_grad, mitsuba {GRAD_FULL}x{GRAD_FULL} spp 4 depth 3 on fused2, world size 1: "
                  f"loss {float(loss):.7g} vs {float(loss_1):.7g}, worst relative gradient difference {worst:.3g} "
                  f"(rtol 1e-6, atol 1e-6 max|g|), {seconds:.3f} s, K1b f32 closest-hit launches per call {launches['f32']}", flush=True)
            check(launches["f32"] > 0, "sharded_loss_and_grad launched no K1b")
        finally:
            mesh.close()

    # two ranks on the one card (gloo: NCCL refuses two ranks on one card)
    size = TWO_RANK_SIZE
    wset = RenderSettings(width=size, height=size, max_samples=settings.max_samples, max_path_depth=DEPTH,
                          environment_auto=True)
    wscene = compile_scene(ROOT / "assets", dragon, (size, size), device=dev)
    want, rays_want = wavefront.render_image_wavefront(wscene, wset, make_accel(wscene, "fused2-bf16"), lanes=lanes,
                                                       fused2_block=block, fused2_sort=True)
    start = time.perf_counter()
    ranks = shard.spawn_ranks(two_rank_frames, 2, device=str(dev), backend="gloo",
                              args=(dragon, size, settings.max_samples, lanes, block), timeout_s=600)
    print(f"  two gloo ranks on one card, {dragon} {size}x{size} spp {settings.max_samples} on fused2-bf16: "
          f"{time.perf_counter() - start:.1f} s with the ranks' start-up", flush=True)
    launches["two_ranks"] = {}
    for i, (split, img, rays, stats, _) in enumerate(ranks[0]):
        check(all(r[i][2] == rays and r[i][3] == stats for r in ranks), f"{split}: the ranks disagree")
        check(all(np.array_equal(r[i][1], img) for r in ranks), f"{split}: the ranks' images differ")
        golden(torch.as_tensor(img), want.cpu(), rays, rays_want, f"two ranks, {split} split, vs world 1")
        launches["two_ranks"][split] = [r[i][4] for r in ranks]
        print(f"  {split}: per_chip_rays {stats['per_chip_rays']}, load_balance {stats['load_balance']:.4f}, "
              f"K1b launches per rank {launches['two_ranks'][split]}", flush=True)
    return launches


def phase_6i(scene, settings, waves, nee_scene, nee_waves, lanes, smi):
    """The per-ray-stack BVH (ops/traverse.py): the main path's waves and the
    cornell shadow wave against the cluster query, and one frame."""
    import dataclasses
    import unittest.mock

    import torch

    from owl_path_tracer_tpu_torch.ops import cluster, traverse
    from owl_path_tracer_tpu_torch.render import integrator, wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    start = time.perf_counter()
    bvh = make_accel(scene, "bvh")
    cb = make_accel(scene, "cluster")
    torch.cuda.synchronize()
    print(f"  bvh of {scene.num_tris} triangles: {bvh.node_a.shape[0]} nodes; bvh + cluster build "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    for name, (wo, wd) in waves.items():
        got, s_bvh = timed(lambda: traverse.bvh_closest_hit(wo, wd, bvh))
        want, s_cl = timed(lambda: cluster.cluster_closest_hit(wo, wd, cb))
        same = got.tri == want.tri
        ties = int((~same & (got.t == want.t)).sum())
        check(bool((same | (got.t == want.t)).all()), f"bvh {name} wave: {int((~same).sum())} winners differ")
        check(torch.equal(got.t, want.t) and torch.equal(got.uv[same], want.uv[same]),
              f"bvh {name} wave: t/u/v differ from the cluster query")
        print(f"  bvh {name} wave ({wo.shape[0]} rays, {int((got.tri >= 0).sum())} hits): equal to the cluster "
              f"query bit for bit ({ties} exact t ties with another triangle); bvh {s_bvh:.3f} s = "
              f"{wo.shape[0] / s_bvh / 1e6:.3f} Mrays/s, cluster query {s_cl:.3f} s", flush=True)
    sh_o, sh_d, sh_t = nee_waves["shadow"]
    nbvh, ncb = make_accel(nee_scene, "bvh"), make_accel(nee_scene, "cluster")
    occ, s_bvh = timed(lambda: traverse.bvh_occluded(sh_o, sh_d, nbvh, t_max=sh_t))
    want, s_cl = timed(lambda: cluster.cluster_occluded(sh_o, sh_d, ncb, t_max=sh_t))
    check(torch.equal(occ, want), f"bvh shadow wave: {int((occ != want).sum())} flags differ")
    print(f"  bvh shadow wave ({sh_o.shape[0]} rays, {int(occ.sum())} occluded): flags equal the cluster query's; "
          f"bvh {s_bvh:.3f} s, cluster query {s_cl:.3f} s", flush=True)

    fset = dataclasses.replace(settings, max_samples=1)
    (img, rays), s_bvh = timed(lambda: wavefront.render_image_wavefront(scene, fset, bvh, lanes=lanes))
    (want, rays_want), s_cl = timed(lambda: wavefront.render_image_wavefront(scene, fset, cb, lanes=lanes))
    differ = int((img != want).sum())
    print(f"  bvh frame {fset.width}x{fset.height} spp 1 depth {fset.max_path_depth}: {rays} rays in {s_bvh:.3f} s = "
          f"{rays / s_bvh / 1e6:.4f} Mrays/s; cluster frame {rays_want} rays in {s_cl:.3f} s = "
          f"{rays_want / s_cl / 1e6:.4f} Mrays/s; differing image values {differ}; [{smi}]", flush=True)
    # the frame again, every wave held to the cluster query on its own rays:
    # winners may differ only at an exact t tie between two triangles (a
    # shared edge), where either is the closest hit and the traversal order
    # picks one (tests/test_bvh.py allows the same)
    held = {"waves": 0, "rows": 0, "ties": 0}

    def held_intersector(acc, max_leaf=4):
        def intersect(o, d):
            got = traverse.bvh_closest_hit(o, d, acc, max_leaf=max_leaf)
            ref = cluster.cluster_closest_hit(o, d, cb)
            rows = (got.tri != ref.tri) | (got.t != ref.t) | (got.uv != ref.uv).any(-1)
            held["waves"] += 1
            held["rows"] += int(rows.sum())
            held["ties"] += int((rows & (got.t == ref.t) & (got.tri != ref.tri)).sum())
            return got
        return intersect

    with unittest.mock.patch.object(integrator, "make_bvh_intersector", held_intersector):
        again, rays_again = wavefront.render_image_wavefront(scene, fset, bvh, lanes=lanes)
    check(torch.equal(again, img) and rays_again == rays, "two bvh frames differ")
    print(f"  bvh frame's {held['waves']} waves held to the cluster query: {held['rows']} rows differ, "
          f"{held['ties']} of them exact t ties between two triangles", flush=True)
    check(held["rows"] == held["ties"], f"bvh: {held['rows'] - held['ties']} rows differ from the cluster query "
          "beyond exact ties")
    check(rays == rays_want, f"bvh frame traced {rays} rays, the cluster frame {rays_want}")
    if held["ties"]:
        golden(img.cpu(), want.cpu(), rays, rays_want, "bvh frame vs cluster frame, with exact ties")
    else:
        check(differ == 0, "the bvh frame differs from the cluster frame")


def phase_6j(scene, settings, comp_accel, lanes, block, smi):
    """The strided film at full size against the queue film, on the
    component layout (its winners do not depend on a block's other rays),
    timed in turns queue, strided, strided, queue; then once each on
    fused2-bf16."""
    import torch

    from owl_path_tracer_tpu_torch.render import wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel

    def render(accel, strided):
        torch.cuda.synchronize()
        start = time.perf_counter()
        img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes, fused2_block=block,
                                                     fused2_sort=True, strided=strided)
        torch.cuda.synchronize()
        return img, rays, time.perf_counter() - start

    q1, s1, s2, q2 = (render(comp_accel, strided) for strided in (False, True, True, False))
    p = settings.width * settings.height * settings.max_samples // lanes // settings.max_samples
    torch.testing.assert_close(s1[0], q1[0], rtol=1e-5, atol=1e-6)
    check(s1[1] == q1[1] == s2[1] == q2[1], f"strided rays {s1[1]} / {s2[1]}, queue {q1[1]} / {q2[1]}")
    check(torch.equal(s1[0], s2[0]), "two strided frames differ")
    print(f"  strided film ({p} pixels per lane) vs queue film, {settings.width}x{settings.height} spp "
          f"{settings.max_samples} on the component layout: max |diff| {float((s1[0] - q1[0]).abs().max()):.3g} "
          f"(rtol 1e-5, atol 1e-6), rays {s1[1]} both; frame s in turns: queue {q1[2]:.3f} / {q2[2]:.3f}, strided "
          f"{s1[2]:.3f} / {s2[2]:.3f}; [{smi}]", flush=True)
    bf16 = make_accel(scene, "fused2-bf16")
    q, s = render(bf16, False), render(bf16, True)
    golden(s[0].cpu(), q[0].cpu(), s[1], q[1], "strided vs queue film on fused2-bf16")
    print(f"  on fused2-bf16: queue {q[2]:.3f} s ({q[1]} rays), strided {s[2]:.3f} s ({s[1]} rays)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=8, help="main-path samples per pixel (64: headline)")
    ap.add_argument("--row-timing", type=int, default=0, metavar="ROUNDS",
                    help="only time phase 4e's dragon8 entries, ROUNDS rounds, and print them as JSON")
    args = ap.parse_args()

    if not (ROOT / "owl_path_tracer_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure(f"{ROOT} is not a checkout of the repository (no owl_path_tracer_tpu_torch)")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    if args.row_timing:
        row_timing(args.row_timing)
        return
    from owl_path_tracer_tpu_torch.models.lights import build_light_table, sample_lights
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.native import nvcc_path
    from owl_path_tracer_tpu_torch.ops import fused as tfu
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops import latency_probe as tlp
    from owl_path_tracer_tpu_torch.ops import math as m
    from owl_path_tracer_tpu_torch.ops.fused2 import pack_rays
    from owl_path_tracer_tpu_torch.render import integrator, wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel

    from owl_path_tracer_tpu_torch.render.film import scene_has_textures
    from owl_path_tracer_tpu_torch.tools.probe_common import ensure_dragon

    dev = torch.device("cuda", 0)
    results = {"max_abs_err": 0.0}

    # 1 ── environment
    t0 = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"])
    print(smi, flush=True)
    # the SM clock that converts K5's clock64 profile to time (its maximum)
    sm_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "--id=0"]))
    print(f"max SM clock {sm_mhz:.0f} MHz", flush=True)
    lines = run([nvcc_path(), "--version"]).splitlines()
    nvcc = next((ln for ln in lines if "release" in ln), lines[-1])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc}, python {sys.version.split()[0]}")
    phase("1 environment", t0)

    # 2 ── build: one nvcc per kernel source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = list(pool.map(lambda mod: mod.build_kernels(), (fused2, tfu, tlp)))
    for path, seconds, log in builds:
        for line in log.splitlines():
            if any(w in line for w in ("registers", "smem", "spill", "Compiling entry")):
                print("  ptxas:", line.strip())
        print(f"built {path.name} in {seconds:.2f} s")
    # the MXU entries (layout 1 f32, 2 bf16): the tensor-core forms hold HMMA,
    # the CUDA-core forms (the exact yardsticks) none
    hmma = hmma_counts(builds[0][0])
    names = {0: "closest", 1: "any-hit", 2: "mixed"}
    for (mode_i, layout_i, attrs_i, tensor_i), count in sorted(hmma.items()):
        if layout_i in (1, 2):
            what = f"{'f32' if layout_i == 1 else 'bf16'} {names[mode_i]}{'' if attrs_i else ' (no attributes)'}"
            print(f"  SASS: fused2_kernel {what} {'tensor cores' if tensor_i else 'CUDA cores'}: {count} HMMA "
                  "instructions")
            check((count > 0) == bool(tensor_i), f"{what} tensor={tensor_i}: {count} HMMA")
    for layout_i, want in ((1, 6), (2, 4)):
        check(sum(1 for key in hmma if key[1] == layout_i) == want,
              f"expected {want} instantiations of layout {layout_i} in the SASS, got {hmma}")
    component_resources()
    phase("2 build", t0)

    # 3 ── kernel vs plain, small
    t0 = time.perf_counter()
    fb, (o, d, tmax) = soup(dev, mxu=False)
    for block in (128, 256):
        rays = pack_rays(*fused2._pad_rays(o, d, tmax, block)[:3])
        got = fused2.fused2_traverse_packed(rays, fb, block=block)
        want = fused2.fused2_traverse_packed_plain(rays, fb)
        err, _ = compare(got, want, allow_ties=False)
        check(bool((got[300:, 4] == 0).all()), "a padding ray hit")
        results["max_abs_err"] = max(results["max_abs_err"], err)
        print(f"  soup block {block}: {int(got[:, 4].sum())}/300 hits, max |tuv err| {err:.3g}")
    overflow = fused2.fused2_traverse_packed(pack_rays(*fused2._pad_rays(o, d, tmax, 128)[:3]), fb,
                                             block=128, max_steps=1)
    check(bool((overflow[:, 5] == 0).any()), "max_steps=1 left no block unresolved")
    rec, blob = fused2.fused2_closest_hit(o, d, fb, t_max=tmax, max_steps=1)
    ref, ref_blob = fused2._hits_from_output(
        fused2.fused2_traverse_packed_plain(pack_rays(o, d, tmax), fb), o, d, fb, 1e-3, tmax)
    check(bool((rec.tri == ref.tri).all()) and bool((blob == ref_blob).all()), "max_steps=1 differs")
    torch.testing.assert_close(rec.t, ref.t, rtol=5e-6, atol=1e-6)
    print(f"  max_steps=1: {int((overflow[:, 5] == 0).sum())} rays unresolved, answers equal the plain version")
    phase("3 kernel vs plain, small", t0)

    # 3b ── any-hit (K2) and mixed (K3) vs plain, small
    t0 = time.perf_counter()
    err2, err3 = 0.0, 0.0
    r = np.random.default_rng(1)
    shadow = torch.as_tensor(np.arange(300) % 2 == 1, device=dev)
    dist = torch.as_tensor(np.where(shadow.cpu().numpy(), r.uniform(2.0, 20.0, 300), 1e10).astype(np.float32),
                           device=dev)
    for block in (128, 256):
        rays = pack_rays(*fused2._pad_rays(o, d, tmax, block)[:3])
        got = fused2.fused2_traverse_packed(rays, fb, block=block, mode="any_hit")
        want = fused2.fused2_traverse_packed_plain(rays, fb, mode="any_hit")
        check(bool((got[:, 5] == 1).all()), "K2 left rays unresolved")
        e2 = k2_error(got, want, rays)
        check(e2 == 0.0, f"K2 differs from the plain version (flags) or lowered t: max error {e2}")
        err2 = max(err2, e2)
        o_p, d_p, t_p, _ = fused2._pad_rays(o, d, dist, block)
        sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - 300)])
        rays = pack_rays(o_p, d_p, t_p, sh_p)
        got = fused2.fused2_traverse_packed(rays, fb, block=block, mode="mixed")
        want = fused2.fused2_traverse_packed_plain(rays, fb, mode="mixed")
        e, _ = compare(got[~sh_p], want[~sh_p], allow_ties=False)
        err3 = max(err3, e)
        check(bool((got[sh_p, 5] == 1).all()), "K3 left shadow rays unresolved")
        check(bool((got[sh_p, 4] == want[sh_p, 4]).all()), "K3 shadow flags differ from the plain version")
        print(f"  soup block {block}: K2 {int(want[:300, 4].sum())}/300 occluded, identical; K3 "
              f"{int(want[sh_p, 4].sum())}/{int(sh_p.sum())} shadow lanes occluded, identical, closest-hit "
              f"lanes max |tuv err| {e:.3g}")
    # max_steps=1 leaves rows unresolved in both modes (closest and shadow
    # lanes in K3), so the wrappers' exact fallback runs
    o_p, d_p, t_p, _ = fused2._pad_rays(o, d, tmax, 128)
    out = fused2.fused2_traverse_packed(pack_rays(o_p, d_p, t_p), fb, block=128, max_steps=1, mode="any_hit")
    check(bool((out[:, 5] == 0).any()), "K2 max_steps=1 left no ray unresolved")
    o_p, d_p, t_p, _ = fused2._pad_rays(o, d, dist, 128)
    sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - 300)])
    out = fused2.fused2_traverse_packed(pack_rays(o_p, d_p, t_p, sh_p), fb, block=128, max_steps=1, mode="mixed")
    check(bool((out[sh_p, 5] == 0).any()) and bool((out[~sh_p, 5] == 0).any()),
          "K3 max_steps=1 left no shadow or no closest-hit ray unresolved")
    cpu_fb = fb.to("cpu")
    oc, dc, tc, distc, shc = (x.cpu() for x in (o, d, tmax, dist, shadow))
    unresolved = fused2.UNRESOLVED_RAYS
    occ = fused2.fused2_occluded(o, d, fb, t_max=tmax, max_steps=1)
    check(fused2.UNRESOLVED_RAYS > unresolved, "fused2_occluded max_steps=1 sent no row to the exact query")
    check(bool((occ.cpu() == fused2.fused2_occluded(oc, dc, cpu_fb, t_max=tc)).all()), "K2 max_steps=1 differs")
    unresolved = fused2.UNRESOLVED_RAYS
    rec, blob, occ = fused2.fused2_sweep_mixed(o, d, dist, shadow, fb, max_steps=1)
    check(fused2.UNRESOLVED_RAYS > unresolved, "fused2_sweep_mixed max_steps=1 sent no row to the exact query")
    ref, ref_blob, ref_occ = fused2.fused2_sweep_mixed(oc, dc, distc, shc, cpu_fb)
    check(bool((occ.cpu()[shc] == ref_occ[shc]).all()), "K3 max_steps=1 shadow flags differ")
    check(bool((rec.tri.cpu()[~shc] == ref.tri[~shc]).all()), "K3 max_steps=1 winners differ")
    check(bool((blob.cpu()[~shc] == ref_blob[~shc]).all()), "K3 max_steps=1 blobs differ")
    torch.testing.assert_close(rec.t.cpu()[~shc], ref.t[~shc], rtol=5e-6, atol=1e-6)
    print("  max_steps=1: both modes left rows unresolved; K2 and K3 wrapper answers equal the plain version's")
    results["k2_err"], results["k3_err"] = err2, err3
    phase("3b any-hit and mixed vs plain, small", t0)

    # 4 ── kernel vs plain at the main path's shapes
    t0 = time.perf_counter()
    size, lanes, block = SIZE, LANES, BLOCK
    dragon, scene, accel, mode, settings, waves, ids = dragon_setup(dev, args.spp)
    for name, (wo, wd) in waves.items():
        tm = torch.full((lanes,), 1e10, device=dev)
        rays, _ = sorted_rays(wo, wd, tm, accel, mode)
        results[f"k1 {name}"] = r = component_wave(f"{name} wave", rays, accel, block, mhz=sm_mhz)
        results["max_abs_err"] = max(results["max_abs_err"], r["err"])
        if name == "bounce":  # K4: the same body without attributes
            results["K4 component"] = component_wave(f"K4 {name} wave", rays, accel, block, with_attrs=False,
                                                     mhz=sm_mhz)
    phase("4 kernel vs plain, main-path shapes", t0)

    # 4b ── K2 and K3 vs plain at the NEE path's shapes
    t0 = time.perf_counter()
    nee_scene, nee_accel, nee_mode, nset, nee_waves = nee_setup(dev, args.spp, ids)
    sh_o, sh_d, sh_t = nee_waves["shadow"]
    rays2, _ = sorted_rays(sh_o, sh_d, sh_t, nee_accel, nee_mode)
    results["k2"] = r = component_wave("shadow wave", rays2, nee_accel, block, "any_hit", with_attrs=False,
                                       mhz=sm_mhz)
    results["k2_err"] = max(results["k2_err"], r["err"])
    comb_o, comb_d, comb_t, comb_sh = nee_waves["mixed"]
    rays3, perm = sorted_rays(comb_o, comb_d, comb_t, nee_accel, nee_mode, shadow=comb_sh)
    results["k3"] = r = component_wave(f"mixed wave ({rays3.shape[0]} rays)", rays3, nee_accel, block, "mixed",
                                       shadow=comb_sh[perm], mhz=sm_mhz)
    results["k3_err"] = max(results["k3_err"], r["err"])
    phase("4b any-hit and mixed vs plain, NEE shapes", t0)

    # 5 ── frame parity: GPU (kernel) vs CPU (plain version)
    t0 = time.perf_counter()
    fset = RenderSettings(width=FRAME_SIZE, height=FRAME_SIZE, max_samples=FRAME_SPP,
                          max_path_depth=DEPTH, environment_auto=True)
    cpu_scene = compile_scene(ROOT / "assets", FRAME_SCENE, (FRAME_SIZE, FRAME_SIZE), device="cpu")
    cpu_accel = fused2.build_fused2_scene(cpu_scene, mxu=False)
    want, rays_want = wavefront.render_image_wavefront(cpu_scene, fset, cpu_accel, lanes=FRAME_LANES,
                                                       fused2_block=block, fused2_sort=True)
    img, rays_got = wavefront.render_image_wavefront(cpu_scene.to(dev), fset, cpu_accel.to(dev),
                                                     lanes=FRAME_LANES, fused2_block=block,
                                                     fused2_sort=True)
    golden(img.cpu(), want, rays_got, rays_want,
           f"{FRAME_SCENE} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP}, GPU vs CPU")
    phase("5 frame parity", t0)

    # 5b ── NEE frame parity, both forms
    t0 = time.perf_counter()
    nset_small = RenderSettings(width=FRAME_SIZE, height=FRAME_SIZE, max_samples=FRAME_SPP,
                                max_path_depth=DEPTH, environment_auto=True, use_nee=True)
    cpu_scene = compile_scene(ROOT / "assets", NEE_SCENE, (FRAME_SIZE, FRAME_SIZE), env_map_path=None,
                              device="cpu")
    cpu_accel = fused2.build_fused2_scene(cpu_scene, mxu=False)
    frames = {}
    for fused_nee in (False, True):
        form = "deferred" if fused_nee else "separate"
        want, rays_want = wavefront.render_image_wavefront(
            cpu_scene, nset_small, cpu_accel, lanes=FRAME_LANES, fused2_block=block, fused2_sort=True,
            fused_nee=fused_nee)
        img, rays_got = wavefront.render_image_wavefront(
            cpu_scene.to(dev), nset_small, cpu_accel.to(dev), lanes=FRAME_LANES, fused2_block=block,
            fused2_sort=True, fused_nee=fused_nee)
        frames[form] = (img.cpu(), rays_got)
        golden(frames[form][0], want, rays_got, rays_want,
               f"{NEE_SCENE} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP} NEE {form}, GPU vs CPU")
    (img_s, rays_s), (img_d, rays_d) = frames["separate"], frames["deferred"]
    check(rays_s == rays_d, f"deferred form traced {rays_d} rays, separate {rays_s}")
    torch.testing.assert_close(img_d, img_s, rtol=1e-4, atol=1e-5)
    print(f"  GPU deferred vs separate: equal to rtol 1e-4 / atol 1e-5, max |diff| "
          f"{float((img_d - img_s).abs().max()):.3g}, rays {rays_d} both")
    phase("5b NEE frame parity", t0)

    # 6 ── main path
    t0 = time.perf_counter()
    warm = RenderSettings(width=size, height=size, max_samples=1, max_path_depth=DEPTH,
                          environment_auto=True)
    wavefront.render_image_wavefront(scene, warm, accel, lanes=lanes, fused2_block=block, fused2_sort=True)
    torch.cuda.synchronize()
    fused2.reset_counts()
    start = time.perf_counter()
    img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes, fused2_block=block,
                                                 fused2_sort=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    comp_launches, unresolved = dict(fused2.LAUNCHES), fused2.UNRESOLVED_RAYS
    launches = comp_launches["owlpt_fused2_closest_hit"]
    check(launches > 0, "the main path launched no traversal kernel")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(img.shape == (size, size, 3), f"image shape {tuple(img.shape)}")
    check(0.0 < img.mean().item() < 10.0, f"implausible image mean {img.mean().item()}")
    print(f"  {dragon} {size}x{size} spp {args.spp} depth {DEPTH}: {rays} rays in {seconds:.3f} s = "
          f"{rays / seconds / 1e6:.3f} Mrays/s; kernel launches {launches}, unresolved rays "
          f"{unresolved}, image mean {img.mean().item():.6f}")
    phase("6 main path", t0)
    k1_launches = launches
    # the serial entries and the profile entry on the component main paths
    # (phases 6 and 6b): no render path launches them
    off_path = ("owlpt_fused2_serial_closest_hit", "owlpt_fused2_serial_sweep_mixed", fused2.PROFILE_ENTRY)
    serial_launches = {e: comp_launches[e] for e in off_path}

    # 6b ── the NEE main path, separate and deferred
    t0 = time.perf_counter()
    warm = RenderSettings(width=size, height=size, max_samples=1, max_path_depth=DEPTH,
                          environment_auto=True, use_nee=True)
    for fused_nee in (False, True):
        wavefront.render_image_wavefront(nee_scene, warm, nee_accel, lanes=lanes, fused2_block=block,
                                         fused2_sort=True, fused_nee=fused_nee)
    nee_launches = {}
    for fused_nee in (False, True):
        form = "deferred" if fused_nee else "separate"
        torch.cuda.synchronize()
        fused2.reset_counts()
        start = time.perf_counter()
        img, rays = wavefront.render_image_wavefront(nee_scene, nset, nee_accel, lanes=lanes, fused2_block=block,
                                                     fused2_sort=True, fused_nee=fused_nee)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = tuple(fused2.LAUNCHES[f"owlpt_fused2_{e}"] for e in ("closest_hit", "occluded", "sweep_mixed"))
        nee_launches[form] = counts
        for e in off_path:
            serial_launches[e] += fused2.LAUNCHES[e]
        check(bool(torch.isfinite(img).all()), f"NEE {form}: non-finite pixels")
        check(img.shape == (size, size, 3), f"NEE {form}: image shape {tuple(img.shape)}")
        check(0.0 < img.mean().item() < 10.0, f"NEE {form}: implausible image mean {img.mean().item()}")
        print(f"  {NEE_SCENE} NEE {form} {size}x{size} spp {args.spp} depth {DEPTH}: {rays} rays in "
              f"{seconds:.3f} s = {rays / seconds / 1e6:.3f} Mrays/s; launches K1 {counts[0]} K2 {counts[1]} "
              f"K3 {counts[2]}, unresolved rays {fused2.UNRESOLVED_RAYS}, image mean {img.mean().item():.6f}")
    check(nee_launches["separate"][0] > 0 and nee_launches["separate"][1] > 0,
          "the separate NEE path did not launch K1 and K2")
    check(nee_launches["deferred"][2] > 0, "the deferred NEE path did not launch K3")
    phase("6b NEE main path", t0)

    # 3c ── K1b and K4 vs plain, small
    t0 = time.perf_counter()
    phase_3c(dev, results)
    phase("3c MXU layout (K1b) and no-attributes (K4) vs plain, small", t0)

    # 4c ── K1b and K4 vs plain at the main path's shapes
    t0 = time.perf_counter()
    phase_4c(scene, mode, waves, nee_scene, nee_mode, nee_waves, block, results, hmma)
    phase("4c K1b and K4 vs plain, main-path shapes", t0)

    # 5c ── fused2-bf16 frame parity
    t0 = time.perf_counter()
    phase_5c(dev, block, dragon)
    phase("5c fused2-bf16 and fused2 frame parity", t0)

    # 6c ── the headline main path and the NEE path on the MXU layouts
    t0 = time.perf_counter()
    mxu = {}
    for kind in ("fused2-bf16", "fused2"):
        mxu[kind] = main_path(f"{dragon} {kind}", scene, settings, make_accel(scene, kind), lanes, block)
        nee_mxu = make_accel(nee_scene, kind)
        for fused_nee in (False, True):
            form = "deferred" if fused_nee else "separate"
            mxu[f"{kind} {form}"] = main_path(f"{NEE_SCENE} NEE {form} {kind}", nee_scene, nset, nee_mxu, lanes,
                                              block, fused_nee)
    film_differ = film_determinism(scene, settings, lanes, block)
    check(not any(film_differ.values()), f"the wavefront film is not deterministic: {film_differ}")
    phase("6c main paths on fused2-bf16 and fused2, film determinism", t0)

    # 3d ── K5 vs plain, small
    t0 = time.perf_counter()
    phase_3d(dev, results)
    phase("3d fused kernel (K5) vs plain, small", t0)

    # 4d ── K5 vs plain at the scan main path's shapes
    t0 = time.perf_counter()
    fused_accel, big, big_wave = phase_4d(scene, settings, results, sm_mhz)
    phase("4d K5 vs plain, main-path shapes", t0)

    # 4e ── fused2 above its old cluster limit; rows shared by 4 CTAs; dragon8's rows
    t0 = time.perf_counter()
    comp = above_old_limit(dev, results, block)
    shared_rows(comp, results, block)
    del comp
    row_placement(results, big, big_wave, block)
    del big, big_wave
    phase("4e fused2 above the old cluster limit, frontier rows in device memory", t0)

    # 5d ── scan-renderer frame parity on fused
    t0 = time.perf_counter()
    phase_5d(dev)
    phase("5d scan frame parity on fused", t0)

    # 6d ── the scan main path and the wavefront on fused
    t0 = time.perf_counter()
    k5_launches = phase_6d(scene, settings, fused_accel, lanes)
    phase("6d scan main path and wavefront on fused", t0)

    # 6e ── the CLI
    t0 = time.perf_counter()
    phase_6e()
    phase("6e CLI", t0)

    # 3f ── K6 vs plain, small
    t0 = time.perf_counter()
    phase_3f(dev, results)
    phase("3f latency probe (K6) vs plain, small", t0)

    # 4f ── the latency probe at its default shapes
    t0 = time.perf_counter()
    phase_4f(results)
    phase("4f latency probe at its default shapes", t0)

    # 6f ── the production path with drained checkpoints
    t0 = time.perf_counter()
    phase_6f(dev)
    phase("6f production path, checkpoint and resume", t0)

    # 5g ── gradients on the card against the CPU
    t0 = time.perf_counter()
    grad_launches = phase_5g(dev)
    phase("5g gradients, card vs CPU", t0)

    # 6g ── material recovery at full size
    t0 = time.perf_counter()
    recovery = phase_6g(dev, smi)
    phase("6g material recovery at full size", t0)

    # 6h ── multi-device rendering on torch.distributed
    t0 = time.perf_counter()
    sharded = phase_6h(dev, scene, settings, dragon, lanes, block, smi)
    phase("6h multi-device rendering (NCCL at world size 1, two gloo ranks on one card)", t0)

    # 6i ── the per-ray-stack bvh accelerator
    t0 = time.perf_counter()
    phase_6i(scene, settings, waves, nee_scene, nee_waves, lanes, smi)
    phase("6i the bvh accelerator", t0)

    # 6j ── the strided film
    t0 = time.perf_counter()
    phase_6j(scene, settings, accel, lanes, block, smi)
    phase("6j the strided film", t0)

    check("jax" not in sys.modules and "owl_path_tracer_tpu" not in sys.modules,
          "the JAX package was imported")

    def entry(name, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}

    def mxu_entry(layout, kind, mode, path, key, err):
        name = f"fused2_mxu{layout}_{mode}"
        launches = mxu[path].get(f"owlpt_{name}", 0)
        check(launches > 0, f"the {path} path did not launch {name}")
        r = results[key]
        row = entry(name, launches, max(err, r["err"]), r["ms"], r["plain_ms"], r["bound"])
        # the gradient path's launches (phase 5g's card runs; 6g's per recovery step)
        row["gradient_launches"] = grad_launches.get(f"owlpt_{name}", 0)
        row["recovery_launches_per_step"] = {s: c.get(f"owlpt_{name}", 0) for s, c in recovery.items()}
        if r["bound_tf32"] is not None:
            # the f32 tensor-core entries: the same work at the TF32 rate
            row["bound_tf32_ms"], row["bound_tf32_by"] = r["bound_tf32"]
        # the sharded paths' launches (phase 6h): the world-1 frame on
        # fused2-bf16, one sharded loss + backward on fused2, the two ranks'
        row["sharded_launches"] = sharded.get(
            {"_bf16_closest_hit": "bf16", "_closest_hit": "f32"}.get(f"{layout}_{mode}"), 0)
        if layout == "_bf16" and mode == "closest_hit":
            row["sharded_launches_two_ranks"] = sharded["two_ranks"]
        if mode == "closest_hit":  # phase 4e: the frontier row in shared vs device memory, dragon8 at C=128
            row["dragon8_row"] = results[f"row {kind}"]
        return row

    def component_entry(name, launches, err, r):
        # the slot-parallel body's row, with the serial body's time from the
        # same turns (where it has an entry) and the no-FMA ceiling
        row = entry(name, launches, err, r["ms"], r["plain_ms"], r["bound"])
        row["bound_no_fma_ms"], row["bound_no_fma_by"] = r["bound_no_fma"]
        if r["serial_ms"] is not None:
            row["serial_ms"] = r["serial_ms"]
        return row

    k1, k3 = results["k1 bounce"], results["k3"]
    kernels = [
        component_entry("fused2_closest_hit", k1_launches, results["max_abs_err"], k1),
        component_entry("fused2_occluded", nee_launches["separate"][1], results["k2_err"], results["k2"]),
        component_entry("fused2_sweep_mixed", nee_launches["deferred"][2], results["k3_err"], k3),
        # the serial body, K1's and K3's yardstick (timed in turns with them)
        # and the profile entry (a diagnostic): no render path launches them
        entry("fused2_serial_closest_hit", serial_launches["owlpt_fused2_serial_closest_hit"],
              results["max_abs_err"], k1["serial_ms"], k1["plain_ms"], k1["bound"]),
        entry("fused2_serial_sweep_mixed", serial_launches["owlpt_fused2_serial_sweep_mixed"], results["k3_err"],
              k3["serial_ms"], k3["plain_ms"], k3["bound"]),
        entry("fused2_profile", serial_launches[fused2.PROFILE_ENTRY], results["max_abs_err"], k1["profile_ms"],
              k1["plain_ms"], k1["bound"]),
    ]
    for layout, kind in (("", "fused2"), ("_bf16", "fused2-bf16")):
        err = results[f"k1b_{'f32' if kind == 'fused2' else 'bf16'}_err"]
        err = max(err, results[f"{kind} closest primary"]["err"])
        kernels += [
            mxu_entry(layout, kind, "closest_hit", kind, f"{kind} closest bounce", err),
            mxu_entry(layout, kind, "occluded", f"{kind} separate", f"{kind} any_hit", 0.0),
            mxu_entry(layout, kind, "sweep_mixed", f"{kind} deferred", f"{kind} mixed", err),
        ]
    # the exact CUDA-core forms of MXU closest hit, timed in turns with the
    # tensor-core forms on the same bounce wave; no main path launches them
    for kind, name in (("fused2", "fused2_mxu_exact_closest_hit"),
                       ("fused2-bf16", "fused2_mxu_bf16_exact_closest_hit")):
        x = results[f"{kind} closest bounce"]
        kernels.append(entry(name, mxu[kind].get(f"owlpt_{name}", 0),
                             max(x["exact"]["err"], results[f"{kind} closest primary"]["exact"]["err"]),
                             x["exact"]["ms"], x["plain_ms"], x["bound"]))
    # K4 is an entry point off the main paths: its launches on the dragon
    # main path of its layout (phase 6, component; phase 6c, fused2)
    r = results["K4 component"]
    kernels.append(component_entry("fused2_closest_hit_noattr", comp_launches["owlpt_fused2_closest_hit_noattr"],
                                   max(results["k4_err"], r["err"]), r))
    r = results["K4 mxu"]
    row = entry("fused2_mxu_closest_hit_noattr", mxu["fused2"].get("owlpt_fused2_mxu_closest_hit_noattr", 0),
                max(results["k4_err"], r["err"]), r["ms"], r["plain_ms"], r["bound"])
    row["bound_tf32_ms"], row["bound_tf32_by"] = r["bound_tf32"]
    kernels.append(row)
    # its exact CUDA-core form, timed in turns with it; no path launches it
    kernels.append(entry("fused2_mxu_exact_closest_hit_noattr",
                         mxu["fused2"].get("owlpt_fused2_mxu_exact_closest_hit_noattr", 0), r["exact"]["err"],
                         r["exact"]["ms"], r["plain_ms"], r["bound"]))
    k5 = results["k5 centre chunk bounce"]
    kernels.append(dict(entry("fused_traverse", k5_launches, results["k5_err"], k5["ms"], k5["plain_ms"],
                              k5["bound"]), source=FUSED_SOURCE, replaces=FUSED_REPLACES))
    # K6 runs on no render path: its launches are the probe run's (phase 4f),
    # the tensor form's; the exact form is its yardstick, timed in turns
    k6 = results["k6"]
    row = dict(entry("latency_probe", k6["launches"], results["k6_err"], k6["ms"], k6["plain_ms"], k6["bound"]),
               source=PROBE_SOURCE, replaces=PROBE_REPLACES)
    row["exact_ms"], row["variants"] = k6["exact_ms"], {
        name: {"ms": t["ms"], "exact_ms": t["exact_ms"], "bound_ms": t["bound"][0], "exact_bound_ms": t["exact_bound"][0]}
        for name, t in k6["turns"].items()}
    kernels.append(row)
    kernels.append(dict(entry("latency_probe_exact", k6["exact_launches"], results["k6_err"], k6["exact_ms"],
                              k6["plain_ms"], k6["exact_bound"]), source=PROBE_SOURCE, replaces=PROBE_REPLACES))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except (SmokeFailure, subprocess.CalledProcessError, AssertionError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
