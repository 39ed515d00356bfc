// Fused traversal over fat triangle clusters, for Hopper (sm_90a).
//
// Replaces the Pallas kernel owl_path_tracer_tpu/ops/fused2.py:_kernel
// (launched by fused2_traverse_packed) in all of its plane layouts and modes:
//   closest        closest hit + attributes (with_attrs=True)         -> K1, K1b
//   closest_noattr closest hit, loop t/u/v and in-plane tri id, no
//                  attributes (with_attrs=False, f32 planes)          -> K4
//   any-hit        occlusion only (any_hit=True, no attrs)            -> K2, K1b
//   mixed          closest hit + attributes for lanes with ray col 7 = 0,
//                  occlusion for lanes with col 7 > 0 (mixed=True)    -> K3, K1b
// on two plane layouts:
//   component  planes [K,16,C] f32 (rows 0-8 p0/e1/e2, row 9 tri id):
//              Moller-Trumbore per slot, one cluster per iteration (K1-K3, K4);
//   MXU        planes [K,16,4C] f32 or bf16, column groups det | u*det | v*det
//              | t*det (ops/fused2.py _mxu_features): per slot, the ray
//              features [d, o x d, o, 1] dotted with the group columns, then
//              the reference's window and winner chain; up to `fanout`
//              clusters per iteration (K1b, K4).
// attrs [K,32,C] f32, boxes [8,K]; rays [N,8] (o, d, tmax, shadow flag) ->
// out [N,32] (t u v tri hit resolved steps wcid wslot, 0..., attr rows 0-15).
// One templated body serves every (mode, layout, attrs) combination, as the
// Pallas kernel's static flags do, and on MXU planes the tensor-core or the
// CUDA-core slot test; each has its own extern "C" entry point.  The
// component entries (K1-K4) run a second body, slot-parallel (slot_kernel
// below): the same block algorithm, with the slots of a cluster tested in
// parallel; the one-thread-per-ray body stays on the component layout as
// the yardstick entries owlpt_fused2_serial_closest_hit and
// owlpt_fused2_serial_sweep_mixed (no render path launches them).
//
// The block algorithm, one CUDA block per `block` rays (in the serial body
// one thread per ray):
//   1. scene gate: the block skips everything when no ray enters the scene AABB;
//   2. phase A: the block frontier bent[K] (nearest entry over the block's
//      rays, per cluster) in shared memory, or in device memory where the
//      block's bytes with the row would exceed the device's opt-in limit
//      (the global form: any K the reference renders, as its VMEM row
//      (1, K) does) -- each thread owns the clusters j = tid, tid + B, ...
//      and slab-tests them against every ray, whose origin, 1/d, tmax and
//      cap sit in shared memory;
//   3. retirement loop (at most max_steps iterations): retire the current
//      group of up to `fanout` clusters, pick the next group (the `fanout`
//      nearest entries below the block's prune bound, each pick excluding the
//      earlier ones; ties to the lowest id) with the prune bound from before
//      this group's test, then test the group's clusters one after another,
//      each staged alone in shared memory (each cluster's test reads only
//      its own planes), with strict < so that a later cluster prunes against
//      an earlier one's best and the lowest slot wins a tie; every
//      max(1, refresh / fanout) iterations the frontier is recomputed with
//      each ray's own cap (retired clusters stay retired);
//   4. a block that ends at max_steps with a candidate nearer than its prune
//      bound marks all its rays unresolved (the wrapper answers them with the
//      exact cluster query);
//   5. closest and mixed: the winner's 32-float attribute row is read straight
//      from attrs, and its (t, u, v) replayed from the winner geometry rows
//      17-25 wherever the replay's |det| > 1e-12 (the MXU loop keeps no
//      u/v: a degenerate replay leaves the loop t and u = v = 0).
//
// The prune bound and the refresh cap are where the modes differ:
//   closest  bound = max over rays of best t; cap = best t.
//   any-hit  best t is never lowered (column 0 stays tmax); an occluded ray
//            leaves the bound (it counts as -inf, so a block whose rays are
//            all occluded picks nothing and stops) and gets cap 0, so the
//            refresh finds no cluster it needs; an occluded thread skips its
//            slot loop, and a thread stops its loop at its first valid hit --
//            both exact for the flag.
//   mixed    the closest-hit chain on every lane; after each retired group
//            a shadow lane with a hit gets best t := t_min, which takes it out
//            of the bound and of any later hit, and (cap t_min <= every entry)
//            out of the refresh; its thread then skips its loop.  Pruning is
//            conservative, so a closest-hit lane gets the closest-hit answer
//            whatever shares its block (up to the visiting order of a tie).
//
// Arithmetic.  Component slots follow ops/intersect.py mt_components
// operation for operation (1/det then multiply, sums left to right).  MXU
// slots on CUDA cores (the yardstick entries owlpt_fused2_mxu_exact_closest_hit,
// owlpt_fused2_mxu_exact_closest_hit_noattr and
// owlpt_fused2_mxu_bf16_exact_closest_hit) sum feature x plane products in
// ascending plane-row order from each group's first non-zero row (group 0
// rows 0-2, groups 1-2 rows 0-5, group 3 rows 6-9; the other rows are zero,
// and adding their zero products changes no float32 sum), in float32, as
// ops/fused2.py's plain version does; bf16 planes widen exactly to float32
// and the ray features are rounded to bf16 (nearest even) first, as the
// reference rounds its feature matrix, so every product is exact and only
// the sums round.  Built with --fmad=false and IEEE division, so no product
// is contracted into an FMA and these entries agree bit for bit with the
// plain PyTorch version on every cluster both test.
//
// The MXU entries of the main path (closest hit, any-hit, mixed, on bf16 and
// on f32 planes) and K4 on f32 planes take the feature products on the
// tensor cores instead (TensorOps and the staging in tensor_ops.cuh, shared
// with the latency probe; tensor_test below):
//   * each warp owns two 16-ray m-tiles; each ray's features sit in mma A
//     fragments for the whole launch;
//   * a ring of two cluster buffers in shared memory holds the staged
//     plane rows, padded so that the B fragment loads hit distinct banks;
//     the next cluster in visiting order, which may be the first of the next
//     group, is copied with 16-byte cp.async while the current one is
//     tested (the ring leaves shared memory for two blocks of 256 per SM
//     at C=512);
//   * per 8-slot n-tile the four column groups det | u*det | v*det | t*det
//     come out of mma.sync with fp32 accumulators; by the accumulator layout
//     lane (g, q) then holds all four sums of slots 2q, 2q+1 for rays g and
//     g+8, so the reference's window runs on those registers with the same
//     operations in the same order (fused2.py:616-632), each lane keeps its
//     best (t, slot) in ascending slot order (K4 also the loop's u = u*det /
//     det and v = v*det / det of it, and reads the winner's tri id from row
//     10 of its planes once the winner is known), and a quad argmin (lowest
//     slot on equal t) gives the ray's cluster winner; a warp whose rays are
//     all done skips the cluster, and an m-tile whose rays are all done
//     skips its products.
// bf16 planes: the raw plane rows 0-9 (40 KB per cluster at C=512; ldmatrix
// reads k 10-15 from one shared zero row), the 10 bf16 features at k 0-9,
// one mma.sync.m16n8k16 per column group, B from ldmatrix.x4.trans; the
// products are exact in the fp32 accumulator.
// f32 planes (3xTF32): the 19 non-zero feature rows (38 KB per cluster at
// C=512, each row a contiguous run of C floats in the planes); every operand
// is split into two TF32 terms, hi = tf32(x) and lo = tf32(x - hi), and each
// column group sums lo*hi, hi*lo, hi*hi with one mma.sync.m16n8k8 each (12
// per n-tile and m-tile): det, u*det and v*det take d, m at k 0-5, t*det
// takes o, 1 at k 0-3, so each group is one k-step.  The dropped lo*lo term
// and the remainders of the splits are below 3 x 2^-22 of each product.
// In both the tensor core sums in its own order and rounding, so det, u*det,
// v*det and t*det may differ from the plain version's left-to-right sums by
// a few ulps of the summed magnitudes (chip_smoke.py's SUM_GAMMA for bf16,
// SUM_GAMMA_F32 for f32), and a window decision or t order inside that
// margin may flip (chip_smoke.py::compare_near_tie names and bounds such
// rows).  The same instructions on the same inputs give the same sums, so
// the answers still do not depend on the fanout.
//
// What bounds it on the card.  Component: the Moller-Trumbore arithmetic,
// about 45 fp32 operations per ray and slot; built with --fmad=false each is
// one instruction, so the kernels issue them at half the fp32 peak (which
// counts an FMA as two) and can reach at most half of the fp32-peak bound.
// The slot-parallel body issues about 80 instructions per ray and 32-slot
// warp step (the window, the division's range check and its rcp and Newton
// step, the ray's shared loads and the ballot), and every ray of a block
// tests every cluster the block retires, 2-3x the clusters its own exact
// query needs.  Its design answers what held the serial body back (the
// profile entry's clock64 split, chip_smoke.py phase 4 on an H100, dragon7
// bounce wave: slot tests 90-95% of the slowest block, which retired 42
// clusters against a mean of 6.7 and ran nearly alone at the end of the
// wave, 8 warps deep): a cluster's slots are split over up
// to 4 CTAs of 512 threads, a thread block cluster, so a block's tests run
// on 4 SMs at 16 warps each; the blocks that enter the most clusters start
// first (frontier_kernel, order_blocks), so no heavy block is left alone at
// the end; the next cluster's plane rows are staged by cp.async during the
// current test.  What paces it then is the issue rate of the slot tests
// (below the SM's four warp instructions per cycle) and the blocks'
// over-retirement, which the reference's pick rule sets.
// MXU: 2 x 16 x 4 = 128 product
// FLOP per ray and slot as the reference's matmul counts them, plus the
// 28-operation window and winner chain.  On CUDA cores (the exact
// yardsticks) both are fp32 work (67 TFLOP/s), the products the larger share
// (19 non-zero multiply-add pairs, separate under --fmad=false).  On the
// tensor cores the products run at the bf16 (989 TFLOP/s) or TF32 (495
// TFLOP/s, three products per f32 product) rate and the window on CUDA
// cores paces the loop: about 48 fp32 instruction slots per warp and n-tile
// against 4 bf16 or 12 TF32 mma.sync (f32 adds 12 splits of the B values),
// so wgmma's higher product rate would buy nothing yet.  A ray tests every cluster its block retires while it is
// still searching, which is at least the clusters its own exact query needs
// (chip_smoke.py's bound counts those); any-hit and shadow lanes stop at
// their first hit (on the tensor path, at the end of the n-tile that found
// it).  For coherent blocks the per-iteration block reductions (pick over
// K, max of the bound) come next.  Plane bytes per retired cluster
// (component 10 x C floats, 20 KB at C=512; MXU 19 x C values, 38 KB f32 /
// 19 KB bf16, or on the bf16 tensor path 10 x 4C bf16, 40 KB) are read once per
// block, not once per ray, and stay L2-resident for the scene sizes of the
// main path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

#include "tensor_ops.cuh"

namespace {

constexpr int kMtRows = 10;     // component rows staged per cluster: p0 e1 e2 (9) + tri id
constexpr int kMaxFanout = 4;
constexpr int kAttrRows = 32;
constexpr int kOutCols = 32;
constexpr float kTMin = 1e-3f;
constexpr float kEpsDet = 1e-12f;
constexpr float kInf = INFINITY;

enum Mode { kClosest = 0, kAnyHit = 1, kMixed = 2 };

__device__ __forceinline__ float inv_dir(float dc) {
  const float safe = fabsf(dc) < 1e-12f ? (dc < 0.0f ? -1e-12f : 1e-12f) : dc;
  return 1.0f / safe;
}

// ops/intersect.py mt_components, one ray against one triangle.
__device__ __forceinline__ bool mt_components(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float t_min, float t_max,
    float& t, float& u, float& v, float& det) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  det = e1x * hx + e1y * hy + e1z * hz;
  const float inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
  const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
  u = inv * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = inv * (dx * qx + dy * qy + dz * qz);
  t = inv * (e2x * qx + e2y * qy + e2z * qz);
  return fabsf(det) >= kEpsDet && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > t_min && t < t_max;
}

// Slab test of one ray against one box -> t_enter = max(t_near, t_min); t_far out.
__device__ __forceinline__ float slab_enter(
    float ox, float oy, float oz, float ix, float iy, float iz,
    const float* bmin, const float* bmax, float& t_far) {
  float tn = -kInf, tf = kInf;
  const float o[3] = {ox, oy, oz};
  const float ia[3] = {ix, iy, iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float oi = o[a] * ia[a];
    const float t0 = ia[a] * bmin[a] - oi;
    const float t1 = ia[a] * bmax[a] - oi;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  t_far = tf;
  return fmaxf(tn, kTMin);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// (value, index) minimum; equal values keep the lower index.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// Block-wide reductions; every thread gets the result.  red_f/red_i hold one
// slot per warp; the trailing barrier lets the caller reuse them at once.
__device__ float block_max(float v, float* red_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red_f[warp] = v;
  __syncthreads();
  float r = -kInf;
  for (int w = 0; w < nw; ++w) r = fmaxf(r, red_f[w]);
  __syncthreads();
  return r;
}

__device__ float block_min(float v, float* red_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_min(v);
  if (lane == 0) red_f[warp] = v;
  __syncthreads();
  float r = kInf;
  for (int w = 0; w < nw; ++w) r = fminf(r, red_f[w]);
  __syncthreads();
  return r;
}

__device__ void block_argmin(float& v, int& i, float* red_f, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_argmin(v, i);
  if (lane == 0) { red_f[warp] = v; red_i[warp] = i; }
  __syncthreads();
  v = red_f[0];
  i = red_i[0];
  for (int w = 1; w < nw; ++w) {
    if (red_f[w] < v || (red_f[w] == v && red_i[w] < i)) { v = red_f[w]; i = red_i[w]; }
  }
  __syncthreads();
}

// The next group: up to `fanout` nearest still-needed clusters, each the
// lowest id holding the minimum of bent over the clusters not picked before
// it, if that minimum is below pmax; else k (none).
__device__ void pick_group(const float* bent, int k, float pmax, int fanout, int* ids,
                           float* red_f, int* red_i) {
  for (int w = 0; w < fanout; ++w) {
    float mn = kInf;
    int idx = k;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      bool taken = false;
      for (int x = 0; x < w; ++x) taken = taken || ids[x] == j;
      if (!taken && bent[j] < mn) { mn = bent[j]; idx = j; }
    }
    block_argmin(mn, idx, red_f, red_i);
    ids[w] = mn < pmax ? idx : k;
  }
}

template <int kLayout>
__device__ __forceinline__ float plane_value(const void* planes, long long idx) {
  if (kLayout == kMxuBf16) {
    const unsigned bits = static_cast<const unsigned short*>(planes)[idx];
    return __uint_as_float(bits << 16);  // exact
  }
  return static_cast<const float*>(planes)[idx];
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The MXU ray features d, m = o x d, o, 1 (reference op order).
__device__ __forceinline__ void ray_features(float ox, float oy, float oz, float dx, float dy, float dz,
                                             float (&f)[10]) {
  f[0] = dx; f[1] = dy; f[2] = dz;
  f[3] = oy * dz - oz * dy; f[4] = oz * dx - ox * dz; f[5] = ox * dy - oy * dx;
  f[6] = ox; f[7] = oy; f[8] = oz; f[9] = 1.0f;
}

// One warp's tensor-core test of one staged cluster (buf: its ring buffer).
//   ops: the lane's operands (TensorOps, tensor_ops.cuh);
//   live: bit i set while warp ray i still searches; bt[mt][h]: best t of
//   ray 16 mt + 8 h + g (lane = 4 g + q), fixed for the cluster.
// Returns in lt / ls (closest, mixed) each of the lane's four rays' cluster
// winner (t, slot), inf if none, reduced over the quad, and with kLoopUV
// (closest hit without attributes) the winner's u = u*det / det and
// v = v*det / det in lu / lv; in lh (any-hit) its hit flag, ORed over the
// quad.
template <int kMode, int kLayout, bool kLoopUV>
__device__ __forceinline__ void tensor_test(const TensorOps<kLayout>& ops, const unsigned char* buf,
                                            const unsigned char* zero_row, int ntiles, unsigned live,
                                            const float (&bt)[2][2], float (&lt)[2][2], int (&ls)[2][2],
                                            bool (&lh)[2][2], float (&lu)[2][2], float (&lv)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  bool sr[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sr[mt][h] = (live >> (16 * mt + 8 * h + g)) & 1u;
      lt[mt][h] = kInf;
      ls[mt][h] = 0;
      lh[mt][h] = false;
      lu[mt][h] = lv[mt][h] = 0.0f;
    }
  }
  bool mt_live[2] = {(live & 0xffffu) != 0u, (live >> 16) != 0u};
  for (int j = 0; j < ntiles; ++j) {
    const auto b = ops.load(buf, zero_row, j);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!mt_live[mt]) continue;  // uniform over the warp
      float det[4], ua[4], vb[4], tcd[4];
      ops.sums(mt, b, det, ua, vb, tcd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // accumulator e: ray row g + 8 (e >> 1), slot 8 j + 2 q + (e & 1)
        const int h = e >> 1;
        // fused2.py:616-632: |det| window, no tid term (pads are zero)
        const float sgn = det[e] < 0.0f ? -1.0f : 1.0f;
        const float dd = det[e] * sgn;
        const float u = ua[e] * sgn;
        const float v = vb[e] * sgn;
        const float tc = tcd[e] * sgn;
        const bool ok = sr[mt][h] && dd >= kEpsDet && u >= 0.0f && v >= 0.0f && u + v <= dd &&
                        tc > dd * kTMin && tc < dd * bt[mt][h];
        if (kMode == kAnyHit) {
          lh[mt][h] = lh[mt][h] || ok;
        } else if (ok) {
          const float t = tc / dd;
          if (t < lt[mt][h]) {
            lt[mt][h] = t;
            ls[mt][h] = 8 * j + 2 * q + (e & 1);
            if (kLoopUV) {  // the CUDA-core loop's u / dd, v / dd
              lu[mt][h] = u / dd;
              lv[mt][h] = v / dd;
            }
          }
        }
      }
    }
    if (kMode == kAnyHit) {  // an m-tile whose rays have all hit is done
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        bool need = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // every lane shuffles (no short-circuit: the shuffles name all 32 lanes)
          const bool o1 = __shfl_xor_sync(0xffffffffu, lh[mt][h], 1);
          lh[mt][h] = lh[mt][h] || o1;
          const bool o2 = __shfl_xor_sync(0xffffffffu, lh[mt][h], 2);
          lh[mt][h] = lh[mt][h] || o2;
          need = need || (sr[mt][h] && !lh[mt][h]);
        }
        const bool any_need = __any_sync(0xffffffffu, need);
        mt_live[mt] = mt_live[mt] && any_need;
      }
      if (!mt_live[0] && !mt_live[1]) break;
    }
  }
  if (kMode != kAnyHit) {  // quad argmin: the lowest slot on equal t
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ot = __shfl_xor_sync(0xffffffffu, lt[mt][h], off);
          const int os = __shfl_xor_sync(0xffffffffu, ls[mt][h], off);
          float ou = 0.0f, ov = 0.0f;
          if (kLoopUV) {
            ou = __shfl_xor_sync(0xffffffffu, lu[mt][h], off);
            ov = __shfl_xor_sync(0xffffffffu, lv[mt][h], off);
          }
          if (ot < lt[mt][h] || (ot == lt[mt][h] && os < ls[mt][h])) {
            lt[mt][h] = ot;
            ls[mt][h] = os;
            lu[mt][h] = ou;
            lv[mt][h] = ov;
          }
        }
      }
    }
  }
}

// Frontier pass: bent[j] = min over rays of the entry distance of rays that
// need cluster j (entry within [t_min, min(t_far, tmax)] and, unless first,
// below the ray's cap).  Retired (inf) clusters stay retired unless first.
// The clusters j0 <= j < j1 (default all k).
__device__ void frontier_update(float* bent, const float* __restrict__ boxes, int k,
                                const float* s_ray, int b, bool first, int j0 = 0, int j1 = -1) {
  const float* s_ox = s_ray;
  const float* s_oy = s_ray + b;
  const float* s_oz = s_ray + 2 * b;
  const float* s_ix = s_ray + 3 * b;
  const float* s_iy = s_ray + 4 * b;
  const float* s_iz = s_ray + 5 * b;
  const float* s_tmax = s_ray + 6 * b;
  const float* s_cap = s_ray + 7 * b;
  for (int j = j0 + threadIdx.x; j < (j1 < 0 ? k : j1); j += blockDim.x) {
    if (!first && bent[j] == kInf) continue;
    const float bmin[3] = {boxes[j], boxes[k + j], boxes[2 * k + j]};
    const float bmax[3] = {boxes[3 * k + j], boxes[4 * k + j], boxes[5 * k + j]};
    float fresh = kInf;
    for (int r = 0; r < b; ++r) {
      float tf;
      const float te = slab_enter(s_ox[r], s_oy[r], s_oz[r], s_ix[r], s_iy[r], s_iz[r],
                                  bmin, bmax, tf);
      bool need = te <= fminf(tf, s_tmax[r]);
      if (!first) need = need && te < s_cap[r];
      if (need) fresh = fminf(fresh, te);
    }
    bent[j] = fresh;
  }
  __syncthreads();
}

// Per-block clock64 split of the component bodies (the profile entry): the
// cycles of the scene gate and the first frontier (setup), of the picks with
// their bound reductions, the frontier refreshes and the overflow test
// (pick), of the wait for a cluster's plane rows (stage), of the slot tests
// with the per-ray combine (test) and of the winner payload (payload), each
// phase up to the barrier that ends it, so that a phase's time is its
// slowest thread's; then the block's total cycles (the sum of the five) and
// its retired clusters.  Thread 0's clock is the one written.
enum Phase { kPhSetup = 0, kPhPick, kPhStage, kPhTest, kPhPayload, kPhases };
constexpr int kProfileCols = kPhases + 2;

template <bool kOn>
struct PhaseClock {
  long long start = 0, last = 0, cycles[kPhases] = {0, 0, 0, 0, 0};
  __device__ PhaseClock() {
    if (kOn) start = last = clock64();
  }
  // call right after a barrier: the cycles since the last mark go to `phase`
  __device__ __forceinline__ void mark(int phase) {
    if (kOn) {
      const long long t = clock64();
      cycles[phase] += t - last;
      last = t;
    }
  }
  // the payload up to a final barrier, then thread 0 writes row `row`
  __device__ __forceinline__ void finish(long long* profile, int steps, int row) {
    if (!kOn) return;
    __syncthreads();
    mark(kPhPayload);
    if (threadIdx.x == 0) {
      long long* p = profile + static_cast<long long>(row) * kProfileCols;
      for (int ph = 0; ph < kPhases; ++ph) p[ph] = cycles[ph];
      p[kPhases] = last - start;
      p[kPhases + 1] = steps;
    }
  }
};

// Staged rows per cluster on CUDA cores.
template <int kLayout>
__host__ __device__ constexpr int staged_rows() {
  return kLayout == kComponent ? kMtRows : kMxuRows;
}

// The block's frontier row bent [k] f32 lies in dynamic shared memory (the
// shared form) wherever the block's bytes fit under the device's opt-in
// limit, else in device memory (the global form): row blk of a scratch
// [n / block, k] f32 that the wrapper allocates (ops/fused2.py row_form,
// from each entry's _shared_bytes).
// Only where the row lies differs; the arithmetic is the same.  The form is
// a template flag of both bodies (the launch picks the instantiation), so
// every use of the row is a shared or a global access, never a generic
// one.  A row in device memory is read through L1 (one CTA writes and
// reads it in fused2_kernel; slot_kernel's CTAs share it, see there).
//
// Dynamic shared memory of one block, in fused2_kernel's carve-up order.
// CUDA cores: bent [k] (padded to 4; none in the global form), the staged
// cluster [rows, c] f32, the ray rows [8, b], reductions [64].  Tensor
// cores: a ring of two clusters (tensor_buffer_bytes each: bf16
// [10][tensor_row_bytes(c)] bytes, f32 [19][f32_row_words(c)] floats), a
// 16-byte zero row, then bent, rays and reductions as above.
template <int kLayout, bool kTensor>
size_t shared_bytes(int k, int c, int b, bool global_row) {
  const size_t row = global_row ? 0 : static_cast<size_t>((k + 3) & ~3);
  const size_t tail = (row + 8 * static_cast<size_t>(b) + 64) * sizeof(float);
  if (kTensor) return 2 * static_cast<size_t>(tensor_buffer_bytes<kLayout>(c)) + 16 + tail;
  return static_cast<size_t>(staged_rows<kLayout>()) * c * sizeof(float) + tail;
}

template <int kMode, int kLayout, bool kAttrs, bool kTensor, bool kProfile, bool kGlobalRow>
__global__ void fused2_kernel(
    const float* __restrict__ rays, const float* __restrict__ boxes,
    const void* __restrict__ planes, const float* __restrict__ attrs,
    float* __restrict__ out, float* __restrict__ rows, int k, int c, int max_steps, int refresh, int fanout,
    long long* __restrict__ profile) {
  constexpr bool kMxu = kLayout != kComponent;
  static_assert(!kTensor || (kMxu && (kMode != kAnyHit || !kAttrs)),
                "the tensor-core test serves the MXU entries (any-hit reads no attributes)");
  // closest hit without attributes: the loop's t/u/v and the in-plane tri id
  constexpr bool kLoopUV = kMode == kClosest && !kAttrs;
  static_assert(!kProfile || kLayout == kComponent, "the profile serves the component layout");
  PhaseClock<kProfile> clock;
  // the tensor-core operands of this layout (unused on CUDA cores)
  constexpr int kOpsLayout = kLayout == kMxuF32 ? kMxuF32 : kMxuBf16;
  constexpr int kRows = staged_rows<kLayout>();
  extern __shared__ __align__(16) float smem[];
  const int b = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // tensor path: the cluster ring and the zero row come first
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  const int ring_bytes = kTensor ? tensor_buffer_bytes<kLayout>(c) : 0;  // per buffer
  unsigned char* zero_row = ring + 2 * ring_bytes;
  float* tail = kTensor ? reinterpret_cast<float*>(zero_row + 16) : smem;
  // the frontier row [k]: the shared form's, padded to a multiple of 4, or
  // this block's row of the scratch in device memory (the form is a
  // template flag, so each instantiation reads the row in one known
  // address space)
  float* bent = kGlobalRow ? rows + static_cast<long long>(blockIdx.x) * k : tail;
  float* s_plane = tail + (kGlobalRow ? 0 : ((k + 3) & ~3));  // [kRows, c], 16-byte aligned (CUDA cores)
  float* s_ray = s_plane + (kTensor ? 0 : kRows * c);  // [8, b]: o, 1/d, tmax, cap
  float* red_f = s_ray + 8 * b;         // [32]
  int* red_i = reinterpret_cast<int*>(red_f + 32);  // [32]
  if (kTensor && tid < 4) reinterpret_cast<unsigned*>(zero_row)[tid] = 0u;

  const long long ray = static_cast<long long>(blockIdx.x) * b + tid;
  const float* r = rays + ray * 8;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  const float tmax = r[6];
  const bool shadow = kMode == kMixed && r[7] > 0.0f;
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);

  // MXU ray features d, m = o x d, o, 1 (reference op order), bf16-rounded
  // for bf16 planes
  float f[10];
  ray_features(ox, oy, oz, dx, dy, dz, f);
  if (kLayout == kMxuBf16) {
#pragma unroll
    for (int q = 0; q < 10; ++q) f[q] = round_bf16(f[q]);
  }
  // tensor path: this lane's A fragments and B addressing (TensorOps)
  TensorOps<kOpsLayout> ops;
  if constexpr (kTensor) ops.init(f, c);

  // ── scene gate: the AABB of all real boxes (pads sit at >= 1e30) ──
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l = kInf, h = -kInf;
    for (int j = tid; j < k; j += b) {
      const float bl = boxes[a * k + j], bh = boxes[(3 + a) * k + j];
      if (bl < 1e30f) l = fminf(l, bl);
      if (bh < 1e30f) h = fmaxf(h, bh);
    }
    lo[a] = block_min(l, red_f);
    hi[a] = block_max(h, red_f);
  }
  float gtf;
  const float g_e = slab_enter(ox, oy, oz, ix, iy, iz, lo, hi, gtf);
  const bool scene_live = __syncthreads_or(g_e <= fminf(gtf, tmax));
  if (!scene_live) clock.mark(kPhSetup);

  float best_t = tmax, best_u = 0.0f, best_v = 0.0f, best_tri = -1.0f;
  bool hit = false;
  int wcid = -1, wslot = -1;
  int steps = 0;
  bool resolved = true;

  if (scene_live) {
    // this ray's share of the block prune bound, and its refresh cap
    auto bound_t = [&]() { return kMode == kAnyHit && hit ? -kInf : best_t; };
    auto cap_t = [&]() { return kMode == kAnyHit && hit ? 0.0f : best_t; };
    // a ray that is done needs no more slot tests
    auto searching = [&]() {
      return kMode == kClosest || !hit || (kMode == kMixed && !shadow);
    };

    s_ray[tid] = ox;
    s_ray[b + tid] = oy;
    s_ray[2 * b + tid] = oz;
    s_ray[3 * b + tid] = ix;
    s_ray[4 * b + tid] = iy;
    s_ray[5 * b + tid] = iz;
    s_ray[6 * b + tid] = tmax;
    s_ray[7 * b + tid] = tmax;
    __syncthreads();
    frontier_update(bent, boxes, k, s_ray, b, true);
    clock.mark(kPhSetup);
    int grp[kMaxFanout], nxt[kMaxFanout];
    pick_group(bent, k, block_max(bound_t(), red_f), fanout, grp, red_f, red_i);
    bool done = grp[0] >= k;
    const int refresh_p = refresh / fanout > 1 ? refresh / fanout : 1;
    int i = 0;
    int buf = 0;  // tensor path: the ring buffer of the cluster tested next
    if (kTensor) {  // the first cluster's copy
      if (!done) stage_cluster<kLayout>(ring, planes, grp[0], c, 0, c);
      cp_async_commit();
    }
    while (!done && i < max_steps) {
      if (i % refresh_p == refresh_p - 1) {
        s_ray[7 * b + tid] = cap_t();
        __syncthreads();
        frontier_update(bent, boxes, k, s_ray, b, false);
      }
      if (tid == 0) {  // retire the current group
        for (int w = 0; w < fanout; ++w)
          if (grp[w] < k) bent[grp[w]] = kInf;
      }
      __syncthreads();
      // the next pick uses the bound from BEFORE this group's test
      pick_group(bent, k, block_max(bound_t(), red_f), fanout, nxt, red_f, red_i);

      for (int w = 0; w < fanout; ++w) {
        const int cur = grp[w];
        if (cur >= k) continue;  // uniform over the block
        ++steps;
        if constexpr (kTensor) {
          // the next cluster in visiting order (picks are a prefix of the group)
          const int nx = w + 1 < fanout && grp[w + 1] < k ? grp[w + 1] : nxt[0];
          __syncthreads();  // every warp is done with the other buffer
          if (nx < k)
            stage_cluster<kLayout>(ring + (buf ^ 1) * ring_bytes, planes, nx, c, 0, c);
          cp_async_commit();
          cp_async_wait<1>();  // this thread's copies of cur have landed ...
          __syncthreads();     // ... and every thread's
          const unsigned live = __ballot_sync(0xffffffffu, searching());
          if (live) {  // uniform over the warp
            float bt[2][2], lt[2][2];
            int ls[2][2];
            bool lh[2][2];
            float lu[2][2], lv[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) bt[mt][h] = __shfl_sync(0xffffffffu, best_t, 16 * mt + 8 * h + (lane >> 2));
            tensor_test<kMode, kLayout, kLoopUV>(ops, ring + buf * ring_bytes, zero_row, tensor_cols(c) / 8, live,
                                                 bt, lt, ls, lh, lu, lv);
            // this ray's answer from the quad that holds its rows (lanes 4 g .. 4 g + 3)
            const int src = 4 * (lane & 7), my_mt = lane >> 4, my_h = (lane >> 3) & 1;
            float tc = kInf, tu = 0.0f, tv = 0.0f;
            int wcol = 0;
            bool any = false;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float ot = __shfl_sync(0xffffffffu, lt[mt][h], src);
                const int os = __shfl_sync(0xffffffffu, ls[mt][h], src);
                const bool oh = __shfl_sync(0xffffffffu, lh[mt][h], src);
                float ou = 0.0f, ov = 0.0f;
                if (kLoopUV) {
                  ou = __shfl_sync(0xffffffffu, lu[mt][h], src);
                  ov = __shfl_sync(0xffffffffu, lv[mt][h], src);
                }
                if (mt == my_mt && h == my_h) { tc = ot; wcol = os; any = oh; tu = ou; tv = ov; }
              }
            }
            if (kMode == kAnyHit) {
              hit = hit || any;
            } else if (tc < best_t) {
              best_t = tc; best_u = tu; best_v = tv;
              hit = true; wcid = cur; wslot = wcol;
            }
          }
          buf ^= 1;
          continue;
        }
        // stage this cluster's plane rows in smem
        clock.mark(kPhPick);
        if (!kMxu) {
          const float* src = static_cast<const float*>(planes) + static_cast<long long>(cur) * kPlaneRows * c;
          if ((c & 3) == 0) {
            const float4* src4 = reinterpret_cast<const float4*>(src);
            float4* dst4 = reinterpret_cast<float4*>(s_plane);
            for (int q = tid; q < kMtRows * c / 4; q += b) dst4[q] = src4[q];
          } else {
            for (int q = tid; q < kMtRows * c; q += b) s_plane[q] = src[q];
          }
        } else {
          const long long base = static_cast<long long>(cur) * kPlaneRows * 4 * c;
          for (int q = tid; q < kRows * c; q += b) {
            const int srow = q / c, slot = q - srow * c;
            int row, group;
            mxu_source(srow, row, group);
            s_plane[q] = plane_value<kLayout>(planes, base + static_cast<long long>(row) * 4 * c +
                                                          group * c + slot);
          }
        }
        __syncthreads();
        clock.mark(kPhStage);

        if (searching()) {
          float tc = kInf, tu = 0.0f, tv = 0.0f;
          int wcol = 0;
          for (int s = 0; s < c; ++s) {
            bool ok;
            float t = kInf, u = 0.0f, v = 0.0f;
            if (!kMxu) {
              float det;
              ok = mt_components(
                  ox, oy, oz, dx, dy, dz,
                  s_plane[s], s_plane[c + s], s_plane[2 * c + s],
                  s_plane[3 * c + s], s_plane[4 * c + s], s_plane[5 * c + s],
                  s_plane[6 * c + s], s_plane[7 * c + s], s_plane[8 * c + s],
                  kTMin, best_t, t, u, v, det) && s_plane[9 * c + s] >= 0.0f;
            } else {
              const float* sp = s_plane + s;
              float det = f[0] * sp[0];
              det = det + f[1] * sp[c];
              det = det + f[2] * sp[2 * c];
              float ua = f[0] * sp[3 * c], vb = f[0] * sp[9 * c];
#pragma unroll
              for (int q = 1; q < 6; ++q) {
                ua = ua + f[q] * sp[(3 + q) * c];
                vb = vb + f[q] * sp[(9 + q) * c];
              }
              float tcd = f[6] * sp[15 * c];
              tcd = tcd + f[7] * sp[16 * c];
              tcd = tcd + f[8] * sp[17 * c];
              tcd = tcd + f[9] * sp[18 * c];
              // fused2.py:616-632: |det| window, no tid term (pads are zero)
              const float sgn = det < 0.0f ? -1.0f : 1.0f;
              const float dd = det * sgn;
              ua = ua * sgn;
              vb = vb * sgn;
              tcd = tcd * sgn;
              ok = dd >= kEpsDet && ua >= 0.0f && vb >= 0.0f && ua + vb <= dd &&
                   tcd > dd * kTMin && tcd < dd * best_t;
              if (ok) {
                t = tcd / dd;
                if (!kAttrs) {  // the no-attrs mode reports the winner's u, v
                  u = ua / dd;
                  v = vb / dd;
                }
              }
            }
            if (kMode == kAnyHit) {
              if (ok) { hit = true; break; }
            } else if (ok && t < tc) {
              tc = t; tu = u; tv = v; wcol = s;
            }
          }
          if (kMode != kAnyHit && tc < best_t) {
            best_t = tc; best_u = tu; best_v = tv;
            hit = true; wcid = cur; wslot = wcol;
            if (!kAttrs && !kMxu) best_tri = s_plane[9 * c + wcol];
          }
        }
        __syncthreads();  // s_plane is restaged next
        clock.mark(kPhTest);
      }
      // a shadow lane with a hit is done: t -> t_min
      if (kMode == kMixed && shadow && hit) best_t = kTMin;
      ++i;
#pragma unroll
      for (int w = 0; w < kMaxFanout; ++w) grp[w] = nxt[w];
      done = grp[0] >= k;
    }
    if (kTensor) cp_async_wait<0>();  // no copy is left in flight
    if (!done) {
      // max_steps overflow: a candidate nearer than the block's prune bound
      // taints the whole block
      float near_j = kInf;
      for (int j = tid; j < k; j += b) near_j = fminf(near_j, bent[j]);
      const float nearest = block_min(near_j, red_f);
      resolved = !(nearest < block_max(bound_t(), red_f));
    }
    clock.mark(kPhPick);
  }

  float* o = out + ray * kOutCols;
  float tri = -1.0f;
  float t_out = best_t, u_out = best_u, v_out = best_v;
  if (kMode != kAnyHit && kAttrs && hit) {
    // winner payload, and (t, u, v) replayed from its geometry rows
    const float* a = attrs + static_cast<long long>(wcid) * kAttrRows * c + wslot;
#pragma unroll
    for (int row = 0; row < 16; ++row) o[16 + row] = a[row * c];
    tri = a[16 * c];
    float t3, u3, v3, det3;
    mt_components(ox, oy, oz, dx, dy, dz,
                  a[17 * c], a[18 * c], a[19 * c], a[20 * c], a[21 * c], a[22 * c],
                  a[23 * c], a[24 * c], a[25 * c], kTMin, kInf, t3, u3, v3, det3);
    if (fabsf(det3) > 1e-12f) { t_out = t3; u_out = u3; v_out = v3; }
  } else {
    // no-attrs mode: the in-plane tri id (MXU planes: row 10 of group 0)
    if (kMode == kClosest && hit)
      tri = kMxu ? plane_value<kLayout>(planes, (static_cast<long long>(wcid) * kPlaneRows + 10) * 4 * c + wslot)
                 : best_tri;
#pragma unroll
    for (int row = 0; row < 16; ++row) o[16 + row] = 0.0f;
  }
  o[0] = t_out;
  o[1] = u_out;
  o[2] = v_out;
  o[3] = tri;
  o[4] = hit ? 1.0f : 0.0f;
  o[5] = resolved ? 1.0f : 0.0f;
  o[6] = static_cast<float>(steps);
  o[7] = static_cast<float>(wcid);
  o[8] = static_cast<float>(wslot);
#pragma unroll
  for (int col = 9; col < 16; ++col) o[col] = 0.0f;
  clock.finish(profile, steps, blockIdx.x);
}

// ── the slot-parallel component body (K1-K4) ──

// At most kSlotCluster CTAs, a thread block cluster, share the slots of one
// block of rays.
constexpr int kSlotCluster = 4;
static_assert(kSlotCluster >= 1 && kSlotCluster <= 8, "a portable thread block cluster has at most 8 CTAs");
// threads per CTA of the slot-parallel body
constexpr int kSlotThreads = 512;
// a CTA tests at least this many 32-slot chunks of a cluster
constexpr int kMinCtaChunks = 4;

// CTAs per block of rays (the thread block cluster's size) at C slots: the
// 32-slot chunks split over up to kSlotCluster CTAs, each with at least
// kMinCtaChunks of them.  Any-hit keeps one CTA up to kAnyHitChunks chunks,
// since its blocks retire about one cluster each (the first hit ends a
// shadow ray) and the CTAs' shared work would outweigh the split slot tests;
// above that its two staged clusters (80 bytes a slot) would crowd out the
// rays' shared memory, so it splits like the other modes.
constexpr int kAnyHitChunks = 64;
__host__ __device__ constexpr int slot_ctas(int c, int mode) {
  const int chunks = (c + 31) >> 5, n = chunks / kMinCtaChunks;
  return (mode == kAnyHit && chunks <= kAnyHitChunks) || n < 1 ? 1 : (n > kSlotCluster ? kSlotCluster : n);
}
// slots per CTA (whole chunks)
__host__ __device__ constexpr int slot_span(int c, int mode) {
  return (((c + 31) >> 5) + slot_ctas(c, mode) - 1) / slot_ctas(c, mode) * 32;
}

// Dynamic shared memory of one slot-parallel CTA, in slot_kernel's carve-up
// order: a ring of two clusters' plane rows 0-9 over the CTA's slots
// ([2][10][slot_span(c, mode)] f32), the test's ray rows [b] float4 x 2 (o, dx |
// dy, dz, best t, shadow flag), the combine keys [b] u64 and the combined
// keys [b] u64, bent [k] (padded to 4; none in the global form, where the
// block's row lies in device memory), the frontier's ray rows [8, b],
// hit / winner cluster / winner slot / any-hit flag / searching list [b]
// int each, 32 segment counts and the list length (36 ints), reductions
// [64].
size_t slot_shared_bytes(int k, int c, int b, int mode, bool global_row) {
  const size_t row = global_row ? 0 : static_cast<size_t>((k + 3) & ~3);
  return 4 * 2 * static_cast<size_t>(kMtRows) * slot_span(c, mode) + 16 * 2 * static_cast<size_t>(b) +
         8 * 2 * static_cast<size_t>(b) +
         4 * (row + 8 * static_cast<size_t>(b) + 5 * static_cast<size_t>(b) + 36 + 64);
}

// 4-byte cp.async; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// Stage plane rows 0-9 of cluster cid over slots [s0, s0 + span) into one
// ring buffer ([10][span] f32, slot-major rows; slots past C are zeros,
// which fail the det window): 16-byte copies where C is a multiple of 4,
// else 4-byte ones.
__device__ void stage_slots(float* dst, const float* __restrict__ planes, int cid, int c, int s0, int span) {
  const float* src = planes + static_cast<long long>(cid) * kPlaneRows * c;
  if ((c & 3) == 0) {
    const int quads = span >> 2;
    for (int q = threadIdx.x; q < kMtRows * quads; q += blockDim.x) {
      const int row = q / quads, s = s0 + 4 * (q - row * quads);
      float* d = dst + row * span + (s - s0);
      if (s < c) cp_async16(d, src + row * c + s);
      else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int q = threadIdx.x; q < kMtRows * span; q += blockDim.x) {
      const int row = q / span, s = s0 + (q - row * span);
      cp_async4(dst + row * span + (s - s0), src + row * c + (s < c ? s : 0), s < c ? 4 : 0);
    }
  }
}

// The frontier's rows of ray r (o, 1/d, tmax, cap = tmax) from its packed row rr.
__device__ __forceinline__ void load_ray_rows(float* s_ray, const float* rr, int b, int r) {
  s_ray[r] = rr[0];
  s_ray[b + r] = rr[1];
  s_ray[2 * b + r] = rr[2];
  s_ray[3 * b + r] = inv_dir(rr[3]);
  s_ray[4 * b + r] = inv_dir(rr[4]);
  s_ray[5 * b + r] = inv_dir(rr[5]);
  s_ray[6 * b + r] = rr[6];
  s_ray[7 * b + r] = rr[6];
}

__device__ int block_sum(int v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) red_i[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < nw; ++w) r += red_i[w];
  __syncthreads();
  return r;
}

// The serial body's scene gate over the block's ray rows (s_ray, [8, b]):
// does any ray enter the AABB of all real boxes (pads sit at >= 1e30)?
// Every thread gets the answer.
__device__ bool scene_gate(const float* __restrict__ boxes, int k, const float* s_ray, int b, float* red_f) {
  const int nt = blockDim.x, tid = threadIdx.x;
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l = kInf, h = -kInf;
    for (int j = tid; j < k; j += nt) {
      const float bl = boxes[a * k + j], bh = boxes[(3 + a) * k + j];
      if (bl < 1e30f) l = fminf(l, bl);
      if (bh < 1e30f) h = fmaxf(h, bh);
    }
    lo[a] = block_min(l, red_f);
    hi[a] = block_max(h, red_f);
  }
  bool enters = false;
  for (int r = tid; r < b; r += nt) {
    float gtf;
    const float g_e = slab_enter(s_ray[r], s_ray[b + r], s_ray[2 * b + r], s_ray[3 * b + r], s_ray[4 * b + r],
                                 s_ray[5 * b + r], lo, hi, gtf);
    enters = enters || g_e <= fminf(gtf, s_ray[6 * b + r]);
  }
  return __syncthreads_or(enters);
}

// Dynamic shared memory of one frontier_kernel CTA: the frontier's ray rows
// [8, b], reductions [64].
size_t frontier_shared_bytes(int b) { return 4 * (8 * static_cast<size_t>(b) + 64); }

// Ahead of the slot-parallel traversal, one CTA per block of b rays: the
// serial body's scene gate (the AABB of all real boxes) and its first
// frontier pass (phase A) into bent0[blk, 0:k], and the number of clusters
// the block's rays enter (the finite entries) into entered[blk]; -1 when no
// ray enters the scene, and bent0's row is then not written.
__global__ void __launch_bounds__(kSlotThreads)
frontier_kernel(const float* __restrict__ rays, const float* __restrict__ boxes, float* __restrict__ bent0,
                int* __restrict__ entered, int k, int b) {
  extern __shared__ __align__(16) float smem[];
  float* s_ray = smem;  // [8, b]
  float* red_f = s_ray + 8 * b;
  int* red_i = reinterpret_cast<int*>(red_f + 32);
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long blk = blockIdx.x;
  for (int r = tid; r < b; r += nt) load_ray_rows(s_ray, rays + (blk * b + r) * 8, b, r);
  __syncthreads();
  if (!scene_gate(boxes, k, s_ray, b, red_f)) {
    if (tid == 0) entered[blk] = -1;
    return;
  }
  float* bent = bent0 + blk * k;
  frontier_update(bent, boxes, k, s_ray, b, true);
  int count = 0;
  for (int j = tid; j < k; j += nt) count += bent[j] < kInf;  // this thread's own entries
  count = block_sum(count, red_i);
  if (tid == 0) entered[blk] = count;
}

// order[rank] = blk: the blocks by clusters entered, most first, ties in
// block order (a stable rank by counting), so that the blocks that retire
// the most clusters start first and none is left alone at the end.
// Any-hit skips the ordering: its blocks retire about one cluster each.
__host__ __device__ constexpr bool ordered_blocks(int mode) { return mode != kAnyHit; }
__global__ void order_blocks(const int* __restrict__ entered, int* __restrict__ order, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= blocks) return;
  const int e = entered[i];
  int rank = 0;
  for (int j = 0; j < blocks; ++j) {
    const int f = entered[j];
    rank += f > e || (f == e && j < i);
  }
  order[rank] = i;
}

// The component entries' body, slot-parallel (K1 closest + attributes, K2
// any-hit, K3 mixed, K4 closest without attributes).  The block's picks,
// frontier, prune bound, refresh, overflow rule and payload are the serial
// body's (fused2_kernel on the component layout, kept as the yardstick
// entries owlpt_fused2_serial_*), run by kSlotThreads threads over the b
// rays' rows in shared memory.  A block of rays is a thread block cluster of
// slot_ctas(c, mode) CTAs: each holds all of the block's ray state and runs
// the same picks, tests its own slot_span(c, mode) slots of each cluster, and
// computes its share of each frontier refresh, which the CTAs then exchange
// through distributed shared memory.  Except for any-hit, the scene gate and
// the first frontier come from frontier_kernel, and the clusters take their
// blocks in order_blocks' order (`order`, `bent0`, `entered`; any-hit runs
// both itself, in launch order).  The global form (kGlobalRow: the block's
// bytes with the row in shared memory exceed the device's opt-in limit)
// keeps one frontier row per block of rays in device memory, row blk of
// bent0 [blocks, k] (the ordered modes' first frontiers, worked on in
// place; any-hit's scratch), shared by the cluster's CTAs: each writes its
// share of a refresh, and after the cluster barrier every CTA reads the
// whole row, with no exchange.  cluster.sync() is barrier.cluster.arrive
// (release) and .wait (acquire) at cluster scope, which orders the CTAs'
// device-memory writes before the other CTAs' reads of them as it orders
// their shared-memory ones.  Every CTA retires the current cluster in the
// row itself (each writes the same inf before its own next pick), so no CTA
// may retire one before every CTA has made the pick that it retires: a
// cluster barrier follows the first pick, and every later pick comes
// before the key combine's barrier of its iteration, which the next
// retirement follows.  A cluster's test: each warp owns one 32-slot chunk of its CTA's slots and a
// share of the rays (several warps share a chunk and split the rays); the
// CTA's plane rows are staged by cp.async into a two-cluster ring while the
// previous cluster is tested.  Per (ray, warp): mt_components on the warp's
// 32 slots with the ray's best t from before the cluster, a ballot of the
// valid slots and, only when one is valid, the warp's (t, slot) minimum
// (the lowest slot of the lowest t) into the ray's 64-bit key by a shared
// atomicMin on (bits of t, slot): t > t_min > 0, so its bits order as an
// unsigned integer, and across warps the minimum is again the lowest slot of
// the lowest t, the serial loop's strict-< winner.  Any-hit ORs the ballots.
// The CTAs of a cluster then take the minimum of their keys (and the OR of
// their flags) through distributed shared memory, so every CTA applies the
// same winners (best t, winner, hit), takes a mixed-mode shadow lane with a
// hit to t_min, and rebuilds the list of rays still searching (best t above
// t_min, any-hit lanes without a hit): a done ray is skipped by whole warps.
template <int kMode, bool kAttrs, bool kProfile, bool kGlobalRow>
__global__ void __launch_bounds__(kSlotThreads, 2)
slot_kernel(const float* __restrict__ rays, const float* __restrict__ boxes, const float* __restrict__ planes,
            const float* __restrict__ attrs, float* __restrict__ out, const int* __restrict__ order,
            float* __restrict__ bent0, const int* __restrict__ entered, int k, int c, int b, int max_steps,
            int refresh, long long* __restrict__ profile) {
  PhaseClock<kProfile> clock;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int ctas = slot_ctas(c, kMode), span = slot_span(c, kMode);
  const int rank = ctas > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  // this CTA's share of the frontier pass: clusters [f0, f1)
  const int kshare = (k + ctas - 1) / ctas;
  const int f0 = rank * kshare < k ? rank * kshare : k, f1 = f0 + kshare < k ? f0 + kshare : k;
  float* ring = smem;  // [2][10][span]
  float4* s_ta = reinterpret_cast<float4*>(ring + 2 * kMtRows * span);  // [b] ox oy oz dx
  float4* s_tb = s_ta + b;                                               // [b] dy dz best_t shadow
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_tb + b);  // [b] this CTA's
  unsigned long long* s_all = s_key + b;                                         // [b] the cluster's
  float* const tail = reinterpret_cast<float*>(s_all + b);
  constexpr unsigned long long kNoKey = ~0ull;
  constexpr bool kOrdered = ordered_blocks(kMode);
  // this cluster's block of rays: heavy blocks first (order_blocks)
  const int blk = kOrdered ? order[blockIdx.x / ctas] : blockIdx.x / ctas;
  const long long base = static_cast<long long>(blk) * b;
  // the frontier row [k]: this CTA's in shared memory (padded to a multiple
  // of 4), or the block's in device memory, shared by the cluster's CTAs
  float* bent = kGlobalRow ? bent0 + static_cast<long long>(blk) * k : tail;
  float* s_ray = tail + (kGlobalRow ? 0 : ((k + 3) & ~3));  // [8, b]: o, 1/d, tmax, cap (frontier_update)
  int* s_hit = reinterpret_cast<int*>(s_ray + 8 * b);
  int* s_wcid = s_hit + b;
  int* s_wslot = s_wcid + b;
  int* s_flag = s_wslot + b;  // any-hit: a slot of the current cluster hit (this CTA's)
  int* s_list = s_flag + b;   // the rays still searching, ascending
  int* s_cnt = s_list + b;    // [36]: per 32-ray segment counts; [32] the list length
  float* red_f = reinterpret_cast<float*>(s_cnt + 36);
  int* red_i = reinterpret_cast<int*>(red_f + 32);

  for (int r = tid; r < b; r += nt) {
    const float* rr = rays + (base + r) * 8;
    const float dx = rr[3], dy = rr[4], dz = rr[5];
    s_ta[r] = make_float4(rr[0], rr[1], rr[2], dx);
    s_tb[r] = make_float4(dy, dz, rr[6], kMode == kMixed && rr[7] > 0.0f ? 1.0f : 0.0f);
    s_key[r] = kNoKey;
    s_hit[r] = 0;
    s_wcid[r] = -1;
    s_wslot[r] = -1;
    s_flag[r] = 0;
    load_ray_rows(s_ray, rr, b, r);
  }
  __syncthreads();
  // the scene gate and the first frontier: frontier_kernel's (the global
  // form works on its row in place), or here
  const bool scene_live = kOrdered ? entered[blk] >= 0 : scene_gate(boxes, k, s_ray, b, red_f);
  if (kOrdered && scene_live && !kGlobalRow) {
    const float* src = bent0 + static_cast<long long>(blk) * k;
    for (int j = tid; j < k; j += nt) bent[j] = src[j];
  }

  // a ray's share of the block prune bound and its refresh cap (the serial
  // body's bound_t and cap_t), and whether it still needs slot tests
  auto bound_of = [&](int r) { return kMode == kAnyHit && s_hit[r] ? -kInf : s_tb[r].z; };
  auto cap_of = [&](int r) { return kMode == kAnyHit && s_hit[r] ? 0.0f : s_tb[r].z; };
  auto searching = [&](int r) { return s_tb[r].z > kTMin && !(kMode == kAnyHit && s_hit[r]); };
  auto block_bound = [&]() {
    float v = -kInf;
    for (int r = tid; r < b; r += nt) v = fmaxf(v, bound_of(r));
    return block_max(v, red_f);
  };
  // s_list / s_cnt[32] := the searching rays in ascending order (b is a
  // multiple of 32: one 32-ray segment per ballot)
  auto build_list = [&]() {
    const int nseg = b >> 5;
    for (int seg = warp; seg < nseg; seg += nw) {
      const unsigned m = __ballot_sync(0xffffffffu, searching(seg * 32 + lane));
      if (lane == 0) s_cnt[seg] = __popc(m);
    }
    __syncthreads();
    for (int seg = warp; seg < nseg; seg += nw) {
      int off = 0;
      for (int q = 0; q < seg; ++q) off += s_cnt[q];
      const int r = seg * 32 + lane;
      const bool on = searching(r);
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) s_list[off + __popc(m & ((1u << lane) - 1u))] = r;
      if (seg == nseg - 1 && lane == 0) s_cnt[32] = off + __popc(m);
    }
    __syncthreads();
  };
  // one warp's (t, slot) minimum over its ballot into ray r's key, or its hit flag
  auto record = [&](int r, bool ok, float t, int slot0) {
    const unsigned any = __ballot_sync(0xffffffffu, ok);
    if (any == 0u) return;
    if (kMode == kAnyHit) {
      if (lane == 0) s_flag[r] = 1;
    } else {
      const unsigned bits = ok ? __float_as_uint(t) : 0xffffffffu;
      const unsigned lowest = __reduce_min_sync(0xffffffffu, bits);
      const unsigned at = __ballot_sync(0xffffffffu, bits == lowest);
      if (lane == 0)
        atomicMin(&s_key[r], (static_cast<unsigned long long>(lowest) << 32) |
                                 static_cast<unsigned>(slot0 + __ffs(at) - 1));
    }
  };

  // this CTA's chunks (32 slots each) and each warp's (chunk, ray group)
  // pairs: with fewer chunks than warps, `groups` warps share each chunk and
  // split the rays
  const int cw = span >> 5;
  const int groups = cw <= nw ? nw / cw : 1;
  const int pairs = cw * groups;
  const int s0 = rank * span;  // this CTA's first slot

  // the frontier pass, each CTA over its share of the clusters, then every
  // CTA reads the others' shares (bent is the same in every CTA after it);
  // in the global form the shares are already in the one row
  auto frontier = [&](bool first) {
    frontier_update(bent, boxes, k, s_ray, b, first, f0, f1);
    if (ctas > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every CTA's share is written (global form: and visible to every CTA)
      if (!kGlobalRow) {
        for (int j = tid; j < k; j += nt) {
          const int owner = j / kshare;
          if (owner != rank) bent[j] = cluster.map_shared_rank(bent, owner)[j];
        }
        cluster.sync();  // no CTA reads another's shares any more
      }
    }
  };

  if (!kOrdered && scene_live) frontier(true);
  __syncthreads();
  clock.mark(kPhSetup);

  int steps = 0;
  bool resolved = true;
  if (scene_live) {
    build_list();
    int cur;
    pick_group(bent, k, block_bound(), 1, &cur, red_f, red_i);
    // the global form: no CTA retires cur in the shared row (below) before
    // every CTA has picked it
    if (ctas > 1 && kGlobalRow) cg::this_cluster().sync();
    bool done = cur >= k;
    if (!done) stage_slots(ring, planes, cur, c, s0, span);
    cp_async_commit();
    const int refresh_p = refresh > 1 ? refresh : 1;
    int i = 0, buf = 0;
    while (!done && i < max_steps) {
      if (i % refresh_p == refresh_p - 1) {
        for (int r = tid; r < b; r += nt) s_ray[7 * b + r] = cap_of(r);
        __syncthreads();
        frontier(false);
      }
      if (tid == 0) bent[cur] = kInf;  // retire the current cluster
      __syncthreads();
      // the next pick uses the bound from BEFORE this cluster's test
      int nxt;
      pick_group(bent, k, block_bound(), 1, &nxt, red_f, red_i);
      // the next cluster's rows land while this one is tested
      if (nxt < k) stage_slots(ring + (buf ^ 1) * kMtRows * span, planes, nxt, c, s0, span);
      cp_async_commit();
      clock.mark(kPhPick);
      cp_async_wait<1>();  // this thread's copies of cur have landed ...
      __syncthreads();     // ... and every thread's
      clock.mark(kPhStage);
      ++steps;

      const int nl = s_cnt[32];
      const float* cur_rows = ring + buf * kMtRows * span;
      for (int p = warp; p < pairs; p += nw) {
        const int chunk = p % cw, grp = p / cw;
        float q[kMtRows];
#pragma unroll
        for (int row = 0; row < kMtRows; ++row) q[row] = cur_rows[row * span + chunk * 32 + lane];
        const bool slot_ok = q[9] >= 0.0f;  // a real triangle (pads: tri id -1 or zero rows)
        const int slot0 = s0 + chunk * 32;
        for (int idx = grp; idx < nl; idx += groups) {
          const int r = s_list[idx];
          // any-hit: a ray another warp already found a hit for needs no test
          if (kMode == kAnyHit && __any_sync(0xffffffffu, s_flag[r])) continue;
          const float4 ta = s_ta[r], tb = s_tb[r];
          float t, u, v, det;
          const bool ok = mt_components(ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, q[0], q[1], q[2], q[3], q[4], q[5],
                                        q[6], q[7], q[8], kTMin, tb.z, t, u, v, det) && slot_ok;
          record(r, ok, t, slot0);
        }
      }
      // the cluster's winners: the minimum of the CTAs' keys (the OR of their flags)
      const unsigned long long* keys = s_key;
      if (ctas > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every CTA's keys are final
        for (int r = tid; r < b; r += nt) {
          unsigned long long key = kMode == kAnyHit ? 0ull : kNoKey;
          for (int q = 0; q < ctas; ++q) {
            if (kMode == kAnyHit) {
              key |= static_cast<unsigned long long>(cluster.map_shared_rank(s_flag, q)[r]);
            } else {
              const unsigned long long other = cluster.map_shared_rank(s_key, q)[r];
              key = other < key ? other : key;
            }
          }
          s_all[r] = key;
        }
        cluster.sync();  // no CTA reads another's keys any more
        keys = s_all;
      } else {
        __syncthreads();
      }
      // apply them; a shadow lane with a hit is done: t -> t_min
      for (int r = tid; r < b; r += nt) {
        if (kMode == kAnyHit) {
          if (ctas > 1 ? keys[r] != 0ull : s_flag[r] != 0) {
            s_hit[r] = 1;
            s_flag[r] = 1;
          }
        } else {
          const unsigned long long key = keys[r];
          if (key != kNoKey) {
            s_tb[r].z = __uint_as_float(static_cast<unsigned>(key >> 32));
            s_wcid[r] = cur;
            s_wslot[r] = static_cast<int>(key & 0xffffffffu);
            s_hit[r] = 1;
          }
          s_key[r] = kNoKey;
          if (kMode == kMixed && s_tb[r].w > 0.0f && s_hit[r]) s_tb[r].z = kTMin;
        }
      }
      __syncthreads();
      // closest hit keeps its list: best t stays above t_min
      if (kMode != kClosest) build_list();
      clock.mark(kPhTest);
      ++i;
      cur = nxt;
      buf ^= 1;
      done = cur >= k;
    }
    cp_async_wait<0>();  // no copy is left in flight
    if (!done) {
      // max_steps overflow: a candidate nearer than the block's prune bound
      // taints the whole block
      float near_j = kInf;
      for (int j = tid; j < k; j += nt) near_j = fminf(near_j, bent[j]);
      const float nearest = block_min(near_j, red_f);
      resolved = !(nearest < block_bound());
    }
    clock.mark(kPhPick);
  }

  // the payload: each CTA of the cluster writes every ctas-th ray
  for (int r = tid * ctas + rank; r < b; r += nt * ctas) {
    const float4 ta = s_ta[r], tb = s_tb[r];
    const bool hit = s_hit[r] != 0;
    const int wcid = s_wcid[r], wslot = s_wslot[r];
    float* o = out + (base + r) * kOutCols;
    float tri = -1.0f, t_out = tb.z, u_out = 0.0f, v_out = 0.0f;
    bool loop_uv = false;
    if (kMode != kAnyHit && kAttrs && hit) {
      // winner payload, and (t, u, v) replayed from its geometry rows
      const float* a = attrs + static_cast<long long>(wcid) * kAttrRows * c + wslot;
#pragma unroll
      for (int row = 0; row < 16; ++row) o[16 + row] = a[row * c];
      tri = a[16 * c];
      float t3, u3, v3, det3;
      mt_components(ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, a[17 * c], a[18 * c], a[19 * c], a[20 * c], a[21 * c],
                    a[22 * c], a[23 * c], a[24 * c], a[25 * c], kTMin, kInf, t3, u3, v3, det3);
      if (fabsf(det3) > 1e-12f) {
        t_out = t3; u_out = u3; v_out = v3;
      } else {
        loop_uv = true;
      }
    } else {
      loop_uv = kMode != kAnyHit && hit;
#pragma unroll
      for (int row = 0; row < 16; ++row) o[16 + row] = 0.0f;
    }
    if (loop_uv) {
      // the loop's (u, v) of the winner: mt_components on its plane rows with
      // the same operands, so the same bits (u and v do not read t_max)
      const float* pw = planes + static_cast<long long>(wcid) * kPlaneRows * c + wslot;
      float t2, det2;
      mt_components(ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, pw[0], pw[c], pw[2 * c], pw[3 * c], pw[4 * c], pw[5 * c],
                    pw[6 * c], pw[7 * c], pw[8 * c], kTMin, kInf, t2, u_out, v_out, det2);
      if (!kAttrs) tri = pw[9 * c];  // the no-attrs mode: the in-plane tri id
    }
    o[0] = t_out;
    o[1] = u_out;
    o[2] = v_out;
    o[3] = tri;
    o[4] = hit ? 1.0f : 0.0f;
    o[5] = resolved ? 1.0f : 0.0f;
    o[6] = static_cast<float>(steps);
    o[7] = static_cast<float>(wcid);
    o[8] = static_cast<float>(wslot);
#pragma unroll
    for (int col = 9; col < 16; ++col) o[col] = 0.0f;
  }
  if (rank == 0) clock.finish(profile, steps, blk);  // the block's row: rank 0's clock
  else if (kProfile) __syncthreads();
}

// Diagnostic (no render path): the tensor-core feature sums of the f32
// entries, det | u*det | v*det | t*det of every slot of cluster cids[w] for
// the 32 rays of block w (one warp), by the same staging and products as
// the traversal -> out [N, 4, C].
__global__ void tf32_sums_kernel(const float* __restrict__ rays, const float* __restrict__ planes,
                                 const int* __restrict__ cids, float* __restrict__ out, int c) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* buf = reinterpret_cast<unsigned char*>(smem);
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const long long base = static_cast<long long>(blockIdx.x) * 32;
  const float* r = rays + (base + lane) * 8;
  float f[10];
  ray_features(r[0], r[1], r[2], r[3], r[4], r[5], f);
  TensorOps<kMxuF32> ops;
  ops.init(f, c);
  stage_f32(buf, planes, cids[blockIdx.x], c, 0, c);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int j = 0; j < tensor_cols(c) / 8; ++j) {
    const auto b = ops.load(buf, nullptr, j);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float sums[4][4];
      ops.sums(mt, b, sums[0], sums[1], sums[2], sums[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = 8 * j + 2 * q + (e & 1);
        if (slot >= c) continue;
        float* o = out + (base + 16 * mt + g + 8 * (e >> 1)) * 4 * c + slot;
#pragma unroll
        for (int grp = 0; grp < 4; ++grp) o[grp * c] = sums[grp][e];
      }
    }
  }
}

// The serial body (fused2_kernel) on `stream`; `rows` (null: the shared
// form) is the global form's scratch [n / block, k] f32.
template <int kMode, int kLayout, bool kAttrs, bool kTensor, bool kProfile = false>
int launch(const float* rays, const float* boxes, const void* planes, const float* attrs,
           float* out, float* rows, long long n, int k, int c, int block, int max_steps, int refresh,
           int fanout, void* stream, long long* profile = nullptr) {
  constexpr bool kMxu = kLayout != kComponent;
  if (n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || k <= 0 ||
      c <= 0 || refresh <= 0 || n / block > 0x7fffffffLL || fanout < 1 || fanout > kMaxFanout ||
      (!kMxu && fanout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes<kLayout, kTensor>(k, c, block, rows != nullptr);
  const auto kernel = rows ? fused2_kernel<kMode, kLayout, kAttrs, kTensor, kProfile, true>
                           : fused2_kernel<kMode, kLayout, kAttrs, kTensor, kProfile, false>;
  // every launch sets its own bytes: a resource query or a launch at
  // another K may have left the attribute below them
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(n / block);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      rays, boxes, planes, attrs, out, rows, k, c, max_steps, refresh, fanout, profile);
  return static_cast<int>(cudaGetLastError());
}

// The slot-parallel component body, three launches on `stream`: the scene
// gates and first frontiers (frontier_kernel, into the scratch bent0
// [n / block, k] f32 and entered [n / block] int32), the blocks' order
// (order_blocks, into order [n / block] int32), then the traversal, each
// block of `block` rays a thread block cluster of slot_ctas(c, mode) CTAs
// of kSlotThreads threads.  global_row: the blocks' frontier rows are
// bent0's (any-hit: a scratch [n / block, k] f32 that only the traversal
// writes).
template <int kMode, bool kAttrs, bool kProfile = false>
int launch_slot(const float* rays, const float* boxes, const void* planes, const float* attrs,
                float* out, int* order, float* bent0, int* entered, long long n, int k, int c, int block,
                int max_steps, int refresh, int fanout, int global_row, void* stream, long long* profile = nullptr) {
  const int ctas = slot_ctas(c, kMode);
  if (n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || k <= 0 ||
      c <= 0 || refresh <= 0 || n / block * ctas > 0x7fffffffLL || fanout != 1 || (global_row && !bent0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slot_shared_bytes(k, c, block, kMode, global_row != 0);
  const auto kernel =
      global_row ? slot_kernel<kMode, kAttrs, kProfile, true> : slot_kernel<kMode, kAttrs, kProfile, false>;
  // every launch sets its own bytes (see launch)
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = static_cast<int>(n / block);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ordered_blocks(kMode)) {
    frontier_kernel<<<blocks, kSlotThreads, frontier_shared_bytes(block), st>>>(rays, boxes, bent0, entered, k,
                                                                                block);
    order_blocks<<<(blocks + 255) / 256, 256, 0, st>>>(entered, order, blocks);
    const cudaError_t pre = cudaGetLastError();
    if (pre != cudaSuccess) return static_cast<int>(pre);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n / block * ctas));
  cfg.blockDim = dim3(kSlotThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, rays, boxes, static_cast<const float*>(planes), attrs, out,
                         static_cast<const int*>(order), bent0, static_cast<const int*>(entered), k, c, block,
                         max_steps, refresh, profile);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Registers per thread, dynamic shared bytes per block and resident blocks
// per SM of a kernel launched with `threads` threads and `smem` bytes on the
// current device -> out[0..2]; returns the CUDA error.
template <typename Kernel>
int kernel_resources(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = e == cudaSuccess ? attr.numRegs : -1;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  return static_cast<int>(e);
}

template <int kMode, int kLayout, bool kAttrs, bool kTensor>
int resources(int k, int c, int block, int global_row, int* out) {
  return kernel_resources(global_row ? fused2_kernel<kMode, kLayout, kAttrs, kTensor, false, true>
                                    : fused2_kernel<kMode, kLayout, kAttrs, kTensor, false, false>,
                          block, shared_bytes<kLayout, kTensor>(k, c, block, global_row != 0), out);
}

template <int kMode, bool kAttrs>
int resources_slot(int k, int c, int block, int global_row, int* out) {
  return kernel_resources(
      global_row ? slot_kernel<kMode, kAttrs, false, true> : slot_kernel<kMode, kAttrs, false, false>, kSlotThreads,
      slot_shared_bytes(k, c, block, kMode, global_row != 0), out);
}

// The profile entry's instantiation of (mode, attrs, serial body or not);
// global_row: the serial body takes bent0 as its rows scratch.
template <int kMode, bool kAttrs>
int launch_profile(bool serial, const float* rays, const float* boxes, const void* planes, const float* attrs,
                   float* out, int* order, float* bent0, int* entered, long long n, int k, int c, int block,
                   int max_steps, int refresh, int global_row, long long* profile, void* stream) {
  return serial ? launch<kMode, kComponent, kAttrs, false, true>(rays, boxes, planes, attrs, out,
                                                                 global_row ? bent0 : nullptr, n, k, c, block,
                                                                 max_steps, refresh, 1, stream, profile)
                : launch_slot<kMode, kAttrs, true>(rays, boxes, planes, attrs, out, order, bent0, entered, n, k, c,
                                                   block, max_steps, refresh, 1, global_row, stream, profile);
}

}  // namespace

extern "C" int owlpt_fused2_mxu_tf32_sums(const float* rays, const float* planes, const int* cids, float* out,
                                          long long n, int c, void* stream) {
  if (n <= 0 || n % 32 || c <= 0 || n / 32 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tensor_buffer_bytes<kMxuF32>(c));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tf32_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tf32_sums_kernel<<<static_cast<unsigned>(n / 32), 32, smem, static_cast<cudaStream_t>(stream)>>>(rays, planes,
                                                                                                cids, out, c);
  return static_cast<int>(cudaGetLastError());
}

// The device's opt-in shared memory per block, in bytes; -1 if it cannot be
// read.  Above it a block keeps its frontier row in device memory.
extern "C" int owlpt_fused2_smem_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return limit;
}

// Launch shape of the slot-parallel component entries at C slots in mode
// `mode` (0 closest, 1 any-hit, 2 mixed): threads per CTA -> out[0], CTAs
// per block of rays (the thread block cluster) -> out[1], whether the
// blocks are ordered (frontier_kernel and order_blocks run first, and the
// entry reads the scratch order, bent0 and entered; else it may get null
// pointers) -> out[2].
extern "C" void owlpt_fused2_slot_shape(int c, int mode, int* out) {
  out[0] = kSlotThreads;
  out[1] = slot_ctas(c, mode);
  out[2] = ordered_blocks(mode) ? 1 : 0;
}

// Diagnostic (no render path): a component entry with clock64 phase times
// per block of rays -> profile [N / block, kProfileCols] (int64;
// PhaseClock).  mode 0 closest, 1 any-hit, 2 mixed; with_attrs 0 only with
// closest (K4); serial 1 runs the serial body (the yardstick; order and
// entered unused, bent0 its rows scratch in the global form), 0 the
// slot-parallel one (its scratch as for launch_slot; the profile's setup
// phase then counts the copy of the first frontier, not frontier_kernel);
// global_row 1 the global form.
extern "C" int owlpt_fused2_profile(const float* rays, const float* boxes, const void* planes, const float* attrs,
                                    float* out, int* order, float* bent0, int* entered, long long n, int k, int c,
                                    int block, int max_steps, int refresh, int mode, int with_attrs, int serial,
                                    int global_row, long long* profile, void* stream) {
  const bool s = serial != 0;
  if (mode == kClosest && with_attrs)
    return launch_profile<kClosest, true>(s, rays, boxes, planes, attrs, out, order, bent0, entered, n, k, c, block,
                                          max_steps, refresh, global_row, profile, stream);
  if (mode == kClosest)
    return launch_profile<kClosest, false>(s, rays, boxes, planes, attrs, out, order, bent0, entered, n, k, c,
                                           block, max_steps, refresh, global_row, profile, stream);
  if (mode == kAnyHit && !with_attrs)
    return launch_profile<kAnyHit, false>(s, rays, boxes, planes, attrs, out, order, bent0, entered, n, k, c, block,
                                          max_steps, refresh, global_row, profile, stream);
  if (mode == kMixed && with_attrs)
    return launch_profile<kMixed, true>(s, rays, boxes, planes, attrs, out, order, bent0, entered, n, k, c, block,
                                        max_steps, refresh, global_row, profile, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The entries of the serial body (fused2_kernel): rows is the global form's
// scratch [n / block, k] f32, null for the shared form; the slot-parallel
// entries take the scratch of launch_slot and the form as global_row.  Each
// entry's _resources(k, c, block, global_row, out) reports the form asked
// for, and _shared_bytes(k, c, block, global_row) the dynamic shared memory
// one block (one CTA) of that form needs: the wrapper picks the form by it.
#define OWLPT_FUSED2_ENTRY(name, mode, layout, with_attrs, tensor)                                \
  extern "C" int name(const float* rays, const float* boxes, const void* planes,                  \
                      const float* attrs, float* out, float* rows, long long n, int k, int c,      \
                      int block, int max_steps, int refresh, int fanout, void* stream) {           \
    return launch<mode, layout, with_attrs, tensor>(rays, boxes, planes, attrs, out, rows, n, k, c, \
                                                    block, max_steps, refresh, fanout, stream);     \
  }                                                                                                \
  extern "C" int name##_resources(int k, int c, int block, int global_row, int* out) {             \
    return resources<mode, layout, with_attrs, tensor>(k, c, block, global_row, out);              \
  }                                                                                                \
  extern "C" long long name##_shared_bytes(int k, int c, int block, int global_row) {              \
    return static_cast<long long>(shared_bytes<layout, tensor>(k, c, block, global_row != 0));     \
  }

#define OWLPT_FUSED2_SLOT_ENTRY(name, mode, with_attrs)                                             \
  extern "C" int name(const float* rays, const float* boxes, const void* planes,                   \
                      const float* attrs, float* out, int* order, float* bent0, int* entered,       \
                      long long n, int k, int c, int block, int max_steps, int refresh, int fanout, \
                      int global_row, void* stream) {                                               \
    return launch_slot<mode, with_attrs>(rays, boxes, planes, attrs, out, order, bent0, entered, n, \
                                         k, c, block, max_steps, refresh, fanout, global_row,       \
                                         stream);                                                   \
  }                                                                                                 \
  extern "C" int name##_resources(int k, int c, int block, int global_row, int* out) {              \
    return resources_slot<mode, with_attrs>(k, c, block, global_row, out);                          \
  }                                                                                                 \
  extern "C" long long name##_shared_bytes(int k, int c, int block, int global_row) {               \
    return static_cast<long long>(slot_shared_bytes(k, c, block, mode, global_row != 0));           \
  }

// component layout, the slot-parallel body: K1, K2, K3, K4
OWLPT_FUSED2_SLOT_ENTRY(owlpt_fused2_closest_hit, kClosest, true)
OWLPT_FUSED2_SLOT_ENTRY(owlpt_fused2_occluded, kAnyHit, false)
OWLPT_FUSED2_SLOT_ENTRY(owlpt_fused2_sweep_mixed, kMixed, true)
OWLPT_FUSED2_SLOT_ENTRY(owlpt_fused2_closest_hit_noattr, kClosest, false)
// component layout, the serial body (one thread per ray, the slots of each
// cluster in turn): K1's and K3's in-call speed yardsticks and bit-exact
// witnesses; no render path calls them
OWLPT_FUSED2_ENTRY(owlpt_fused2_serial_closest_hit, kClosest, kComponent, true, false)
OWLPT_FUSED2_ENTRY(owlpt_fused2_serial_sweep_mixed, kMixed, kComponent, true, false)
// MXU layout, f32 planes: K1b in its three modes and K4 (closest hit without
// attributes) on the tensor cores (3xTF32), and closest hit with and
// without attributes on CUDA cores in the plain version's arithmetic (the
// in-call speed yardsticks and bit-exact witnesses of the tensor forms)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_closest_hit, kClosest, kMxuF32, true, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_occluded, kAnyHit, kMxuF32, false, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_sweep_mixed, kMixed, kMxuF32, true, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_closest_hit_noattr, kClosest, kMxuF32, false, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_exact_closest_hit, kClosest, kMxuF32, true, false)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_exact_closest_hit_noattr, kClosest, kMxuF32, false, false)
// MXU layout, bf16 planes: K1b in its three modes on the tensor cores, and
// closest hit on CUDA cores in the plain version's arithmetic (the in-call
// speed yardstick and bit-exact witness of the tensor form)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_bf16_closest_hit, kClosest, kMxuBf16, true, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_bf16_occluded, kAnyHit, kMxuBf16, false, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_bf16_sweep_mixed, kMixed, kMxuBf16, true, true)
OWLPT_FUSED2_ENTRY(owlpt_fused2_mxu_bf16_exact_closest_hit, kClosest, kMxuBf16, true, false)
