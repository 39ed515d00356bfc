// Fused closest-hit traversal over small clusters, for Hopper (sm_90a).
//
// Replaces the Pallas kernel owl_path_tracer_tpu/ops/fused.py:_kernel
// (launched by fused_traverse; the round-1 kernel behind make_accel("fused")).
// rays [N,8] (o, d, tmax, 0), boxes [8,K] (cmin xyz, cmax xyz, 0, 0), planes
// [K,16,C] (p0, e1, e2 components, tri id as float, 6 zero rows) -> out [N,8]
// (t, u, v, tri, hit, resolved, steps, 0).
//
// One CUDA block per `block` consecutive rays, one thread per ray, the same
// grouping as the reference's grid.  Per iteration (at most max_steps):
//   1. a ray is active while its nearest un-retired entry is nearer than its
//      best hit; the block picks the LOWEST cluster id among its active rays'
//      nearest clusters (each ray's nearest: lowest id on equal entries) and
//      stops for good when no ray is active;
//   2. the picked cluster's ten plane rows are staged in shared memory, and
//      every ray whose entry to it is nearer than its best hit tests its C
//      slots with Moller-Trumbore (window (t_min, best t), the lowest slot
//      winning a tie); a hit replaces the best only when strictly nearer;
//   3. the step count goes up on every row, and the cluster is retired for
//      the whole block.
// After the loop a ray that still has an un-retired entry nearer than its
// best hit is unresolved (the wrapper answers it with the exact cluster
// query).  Column 7 is written 0 (the Pallas kernel leaves it unwritten).
//
// Design.  The reference keeps the block's [B,K] entry matrix in VMEM; at
// the main path's K (2,688 clusters of C=128 for the 327,680-triangle dragon)
// that matrix is 1.4 MB at B=128, against 227 KB of shared memory per block.
// An [N,K] matrix in device memory would be 0.7 GB at N=65,536 and be read
// again every iteration.  Instead each thread keeps only a sorted list of
// its 8 nearest un-retired entries and their ids, and the block keeps one
// retired bit per cluster in shared memory.  The box rows are read from
// `boxes` in device memory (6 x 4 B x K: 64.5 KB at K=2,688, 257 KB at the
// 1.3M-triangle dragon's K of about 10,700; L2-resident, and the same
// addresses for every thread of a warp).  Entries only ever change by
// retirement, so a thread scans the boxes again (the reference's slab ops in
// its order, NaN-propagating like jnp.maximum / jnp.minimum) only when its
// whole list has been retired while it is still active; the entry to the
// picked cluster is recomputed with the same ops, so every entry,
// comparison and pick is the reference's.  Shared memory (shared_bytes
// below) is one cluster's ten plane rows, 32 reduction slots and K/8 bytes of
// retired bits: 5.6 KB at C=128 and K=2,688, 6.6 KB at K=10,700.  So K has
// no limit of its own, as in the reference, and registers, not shared
// memory, set the blocks per SM (80 registers x 128 threads: 6 blocks).
//
// Arithmetic.  Moller-Trumbore follows ops/intersect.py mt_components
// operation for operation (1/det then multiply, sums left to right); built
// with --fmad=false and IEEE division, so t/u/v agree bit for bit with the
// plain PyTorch version (ops/fused.py fused_traverse_plain).
//
// Work.  The least an exact query does per ray is the slab test (28
// operations) and Moller-Trumbore (about 45 fp32 operations per slot) of
// each cluster whose box it enters before its closest hit; this kernel also
// slab-tests every box at least once per ray.  Measured (PERF.md, PR 4), the
// set-up and first box scan took about 1 ms per 65,536 rays with the boxes
// in shared memory, and each retirement is a block-wide step (pick,
// staging, 128 slots with an IEEE division each, three barriers).
// Plane rows (10 x C floats, 5 KB at C=128) are read once per block and
// retired cluster.  No tensor cores, no cp.async staging.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kPlaneRows = 16;  // rows per cluster in planes
constexpr int kMtRows = 10;     // rows staged per cluster: p0 e1 e2 (9) + tri id
constexpr int kCols = 8;        // ray and output columns
constexpr float kTMin = 1e-3f;
constexpr float kEpsDet = 1e-12f;
constexpr float kInf = INFINITY;

__device__ __forceinline__ float inv_dir(float dc) {
  const float safe = fabsf(dc) < 1e-12f ? (dc < 0.0f ? -1e-12f : 1e-12f) : dc;
  return 1.0f / safe;
}

// jnp.maximum / jnp.minimum: a NaN operand gives NaN (fmaxf would drop it);
// one instruction each on sm_80 and later
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ops/intersect.py mt_components, one ray against one triangle.
__device__ __forceinline__ bool mt_components(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float t_min, float t_max,
    float& t, float& u, float& v) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
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

// One ray's slab entry into box j (+inf if missed): the reference's
// phase A for one column.  o*inv precomputed per axis (oi).
struct Ray {
  float o[3], inv[3], oi[3], tmax;
};

__device__ __forceinline__ float entry(const Ray& r, const float* __restrict__ boxes, int k, int j) {
  float tn = -kInf, tf = kInf;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = r.inv[a] * __ldg(boxes + a * k + j) - r.oi[a];
    const float t1 = r.inv[a] * __ldg(boxes + (3 + a) * k + j) - r.oi[a];
    tn = max_nan(tn, min_nan(t0, t1));
    tf = min_nan(tf, max_nan(t0, t1));
  }
  const float te = max_nan(tn, kTMin);
  return te <= min_nan(tf, r.tmax) ? te : kInf;
}

// A thread's nearest un-retired entries, ascending by (entry, id): the kCand
// smallest finite ones when the boxes were last scanned, minus those consumed
// since.  Entries change only by retirement, so while one listed cluster is
// un-retired the first such is the ray's nearest entry overall; the boxes
// are scanned again only when a full list is used up.
constexpr int kCand = 8;

struct Nearest {
  float e[kCand];
  int id[kCand];
  int left;   // listed entries not consumed yet (the first `left` slots)
  bool full;  // the scan found kCand finite entries: there may be more
};

// Retired bit of cluster j.
__device__ __forceinline__ bool retired(const unsigned* s_dead, int j) {
  return (s_dead[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ void scan(const Ray& r, const float* __restrict__ boxes, const unsigned* s_dead, int k,
                                     Nearest& nb) {
#pragma unroll
  for (int i = 0; i < kCand; ++i) { nb.e[i] = kInf; nb.id[i] = k; }
  for (int j = 0; j < k; ++j) {
    if (retired(s_dead, j)) continue;
    float ce = entry(r, boxes, k, j);
    if (!(ce < nb.e[kCand - 1])) continue;  // ascending j: an equal entry keeps the lower id first
    int ci = j;
    bool moving = false;  // once placed, every later slot moves down one
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      if (moving || ce < nb.e[i]) {
        const float te = nb.e[i];
        const int ti = nb.id[i];
        nb.e[i] = ce; nb.id[i] = ci;
        ce = te; ci = ti;
        moving = true;
      }
    }
  }
  nb.left = 0;
#pragma unroll
  for (int i = 0; i < kCand; ++i) nb.left += nb.e[i] < kInf;
  nb.full = nb.left == kCand;
}

// The nearest cluster was retired: drop it and any retired ones after it.
__device__ __forceinline__ void advance(const Ray& r, const float* __restrict__ boxes, const unsigned* s_dead,
                                        int k, Nearest& nb) {
  do {
#pragma unroll
    for (int i = 0; i + 1 < kCand; ++i) { nb.e[i] = nb.e[i + 1]; nb.id[i] = nb.id[i + 1]; }
    nb.e[kCand - 1] = kInf;
    nb.id[kCand - 1] = k;
    --nb.left;
  } while (nb.left > 0 && retired(s_dead, nb.id[0]));
  if (nb.left == 0 && nb.full) scan(r, boxes, s_dead, k, nb);
}

// Block-wide integer minimum; every thread gets it.  red holds one slot per
// warp; the trailing barrier lets the caller reuse it at once.
__device__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < nw; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

// Dynamic shared memory of one block, in fused_kernel's carve-up order: one
// cluster's ten plane rows [10,C], 32 reduction slots, a retired bit per
// cluster (32-bit words).
size_t shared_bytes(int k, int c) {
  return 4 * (static_cast<size_t>(kMtRows) * c + 32 + (static_cast<size_t>(k) + 31) / 32);
}

__global__ void fused_kernel(const float* __restrict__ rays, const float* __restrict__ boxes,
                             const float* __restrict__ planes, float* __restrict__ out, int k, int c,
                             int max_steps) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  const int tid = threadIdx.x;
  float* s_plane = smem;                                     // [10, c]
  int* red = reinterpret_cast<int*>(s_plane + kMtRows * c);  // [32]
  unsigned* s_dead = reinterpret_cast<unsigned*>(red + 32);  // [(k + 31) / 32] retired bits

  for (int q = tid; q < (k + 31) / 32; q += b) s_dead[q] = 0u;

  const long long row = static_cast<long long>(blockIdx.x) * b + tid;
  const float* rr = rays + row * kCols;
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = rr[a];
    r.inv[a] = inv_dir(rr[3 + a]);
    r.oi[a] = r.o[a] * r.inv[a];
  }
  const float dx = rr[3], dy = rr[4], dz = rr[5];
  r.tmax = rr[6];
  __syncthreads();

  float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f, best_tri = -1.0f;
  bool hit = false;
  int steps = 0;
  Nearest nb;  // nb.e[0], nb.id[0]: the nearest entry (inf, k when none is left)
  scan(r, boxes, s_dead, k, nb);

  for (int i = 0; i < max_steps; ++i) {
    const int cstar = block_min(nb.e[0] < best_t ? nb.id[0] : k, red);
    if (cstar >= k) break;  // no active ray: the block is done (uniform)
    const float* src = planes + static_cast<long long>(cstar) * kPlaneRows * c;
    for (int q = tid; q < kMtRows * c; q += b) s_plane[q] = src[q];
    __syncthreads();

    if (entry(r, boxes, k, cstar) < best_t) {
      float tc = kInf, tu = 0.0f, tv = 0.0f, ttri = 0.0f;
      for (int s = 0; s < c; ++s) {
        float t, u, v;
        const bool ok = mt_components(
            r.o[0], r.o[1], r.o[2], dx, dy, dz,
            s_plane[s], s_plane[c + s], s_plane[2 * c + s],
            s_plane[3 * c + s], s_plane[4 * c + s], s_plane[5 * c + s],
            s_plane[6 * c + s], s_plane[7 * c + s], s_plane[8 * c + s],
            kTMin, best_t, t, u, v) && s_plane[9 * c + s] >= 0.0f;
        if (ok && t < tc) { tc = t; tu = u; tv = v; ttri = s_plane[9 * c + s]; }
      }
      if (tc < best_t) {
        best_t = tc; best_u = tu; best_v = tv; best_tri = ttri;
        hit = true;
      }
    }
    ++steps;
    __syncthreads();  // s_plane is restaged next iteration
    if (tid == 0) s_dead[cstar >> 5] |= 1u << (cstar & 31);  // retire for the whole block
    __syncthreads();
    // only a still-active ray needs its next nearest entry: entries only
    // grow and best t only shrinks, so an inactive ray stays inactive (and
    // resolved) with its stale nearest entry
    if (nb.id[0] == cstar && nb.e[0] < best_t) advance(r, boxes, s_dead, k, nb);
  }

  float* o = out + row * kCols;
  o[0] = best_t;
  o[1] = best_u;
  o[2] = best_v;
  o[3] = best_tri;
  o[4] = hit ? 1.0f : 0.0f;
  o[5] = nb.e[0] < best_t ? 0.0f : 1.0f;  // a nearer candidate is left: unresolved
  o[6] = static_cast<float>(steps);
  o[7] = 0.0f;
}

}  // namespace

// Registers per thread, dynamic shared bytes per block and resident blocks
// per SM at (k, c, block) on the current device -> out[0..2]; returns the
// CUDA error.
extern "C" int owlpt_fused_traverse_resources(int k, int c, int block, int* out) {
  const size_t smem = shared_bytes(k, c);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fused_kernel);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_kernel, block, smem);
  out[0] = e == cudaSuccess ? attr.numRegs : -1;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  return static_cast<int>(e);
}

extern "C" int owlpt_fused_traverse(const float* rays, const float* boxes, const float* planes,
                                    float* out, long long n, int k, int c, int block, int max_steps,
                                    void* stream) {
  if (n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || k <= 0 || c <= 0 ||
      max_steps < 0 || n / block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(k, c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>(n / block);
  fused_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(rays, boxes, planes, out, k, c,
                                                                          max_steps);
  return static_cast<int>(cudaGetLastError());
}
