// Fused closest-hit traversal over small clusters, for Hopper (sm_90a).
//
// Replaces the Pallas kernel owl_path_tracer_tpu/ops/fused.py:_kernel
// (launched by fused_traverse; the round-1 kernel behind make_accel("fused")).
// rays [N,8] (o, d, tmax, 0), boxes [8,K] (cmin xyz, cmax xyz, 0, 0), group
// boxes [8,ceil(K/G)] (the same rows over each run of G consecutive
// clusters), planes [K,16,C] (p0, e1, e2 components, tri id as float, 6
// zero rows) -> out [N,8] (t, u, v, tri, hit, resolved, steps, 0).
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
// memory, set the blocks per SM (78-96 registers x 128 threads: 5-6
// blocks).
//
// The scans (Scan below; the default, ops/fused.py SCAN, is kWarpGroups).
// Measured on the dragon7 / dragon8 centre bounce waves (PERF.md, K5)
// with every ray scanning all K boxes itself (kSerial), a thread
// slab-tested 2,804 / 11,359 boxes on average, and the set-up scan was half
// the time of the average block; rescans are rare (0.04-0.06 per ray) but
// each stalled its warp for a K-box scan and the block at the next barrier.
// Group boxes (G = 32 clusters each) let a scan skip every member of a group
// that the ray enters no nearer than its list's last entry, exactly (a
// member never enters before its group): 162 / 438 boxes per ray.  A rescan
// is shared by the warp, each lane taking every 32nd group, and kCand rounds
// of a warp argmin merge the lanes' lists.  Both kinds build the same lists,
// so every output column is the same for both; kSerial stays as the
// yardstick that the default is timed against.
//
// Arithmetic.  Moller-Trumbore follows ops/intersect.py mt_components
// operation for operation (1/det then multiply, sums left to right); built
// with --fmad=false and IEEE division, so t/u/v agree bit for bit with the
// plain PyTorch version (ops/fused.py fused_traverse_plain).
//
// Work.  The least an exact query does per ray is the slab test (28
// operations) and Moller-Trumbore (about 45 fp32 operations per slot) of
// each cluster whose box it enters before its closest hit; this kernel also
// slab-tests every group box and the members of the groups it cannot skip.
// With the group scans each retirement, a block-wide step (pick, staging,
// 128 slots with an IEEE division each, three barriers), takes most of a
// block's time (the profile entry owlpt_fused_traverse_profile splits it
// with clock64).  Plane rows (10 x C floats, 5 KB at C=128) are read once
// per block and retired cluster.  No tensor cores, no cp.async staging.

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

// How a list is (re)built.  Both kinds build the same list, the kCand
// smallest (entry, id) pairs over the un-retired clusters (a scan in
// ascending j keeps an equal entry's lower id first):
//   kSerial      each thread scans all K boxes for its own ray, set-up scan
//                and rescans alike;
//   kWarpGroups  each thread's set-up scan tests the group boxes (the exact
//                bounds of G consecutive clusters) and only the members of a
//                group whose entry is below its list's last entry: a
//                member's slab entry is never below its group's (the slab
//                ops and their roundings are monotone in the bounds), so the
//                skip is exact.  A rescan is done by the whole warp, one
//                needing ray at a time: lane l takes groups l, l + 32, ...,
//                skipping as above, keeps its own kCand smallest, and kCand
//                rounds of a warp (entry, id) argmin merge them.
enum Scan { kSerial = 0, kWarpGroups = 1 };

// Retired bit of cluster j.
__device__ __forceinline__ bool retired(const unsigned* s_dead, int j) {
  return (s_dead[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ void clear(Nearest& nb, int k) {
#pragma unroll
  for (int i = 0; i < kCand; ++i) { nb.e[i] = kInf; nb.id[i] = k; }
}

// Insert (ce, j) into the ascending list if it is below the last entry (j
// ascends over the calls: an equal entry keeps the lower id first).
__device__ __forceinline__ void insert(Nearest& nb, float ce, int j) {
  if (!(ce < nb.e[kCand - 1])) return;
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

// Scan clusters [j0, j1) (un-retired ones) into nb; returns the boxes tested.
__device__ __forceinline__ int scan_range(const Ray& r, const float* __restrict__ boxes, const unsigned* s_dead,
                                          int k, int j0, int j1, Nearest& nb) {
  int tests = 0;
  for (int j = j0; j < j1; ++j) {
    if (retired(s_dead, j)) continue;
    insert(nb, entry(r, boxes, k, j), j);
    ++tests;
  }
  return tests;
}

// Scan groups gi = g0, g0 + gstep, ... (G = gsize clusters each) into nb,
// each group's members only where the group's entry is below nb's last
// entry; returns the boxes tested (groups and members).
__device__ __forceinline__ int scan_groups(const Ray& r, const float* __restrict__ boxes,
                                           const float* __restrict__ groups, const unsigned* s_dead, int k,
                                           int gsize, int g0, int gstep, Nearest& nb) {
  const int kg = (k + gsize - 1) / gsize;
  int tests = 0;
  for (int gi = g0; gi < kg; gi += gstep) {
    ++tests;
    if (!(entry(r, groups, kg, gi) < nb.e[kCand - 1])) continue;  // no member enters before it
    tests += scan_range(r, boxes, s_dead, k, gi * gsize, min(k, (gi + 1) * gsize), nb);
  }
  return tests;
}

__device__ __forceinline__ void finish(Nearest& nb) {
  nb.left = 0;
#pragma unroll
  for (int i = 0; i < kCand; ++i) nb.left += nb.e[i] < kInf;
  nb.full = nb.left == kCand;
}

// One thread's scan of its own ray -> nb; returns the boxes tested.
template <bool kG>
__device__ int scan(const Ray& r, const float* __restrict__ boxes, const float* __restrict__ groups,
                    const unsigned* s_dead, int k, int gsize, Nearest& nb) {
  clear(nb, k);
  const int tests = kG ? scan_groups(r, boxes, groups, s_dead, k, gsize, 0, 1, nb)
                       : scan_range(r, boxes, s_dead, k, 0, k, nb);
  finish(nb);
  return tests;
}

// (value, id) minimum over the warp; equal values keep the lower id.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// The warp rebuilds the list of every lane with `need`, one lane at a time
// (every lane of the warp calls this), with the group skips; adds the boxes
// tested to that lane's `tests`.
__device__ void warp_rescan(const Ray& r, bool need, const float* __restrict__ boxes,
                            const float* __restrict__ groups, const unsigned* s_dead, int k, int gsize, Nearest& nb,
                            int& tests) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(0xffffffffu, need);
  while (pending) {  // uniform over the warp
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    Ray q;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      q.o[a] = __shfl_sync(0xffffffffu, r.o[a], src);
      q.inv[a] = __shfl_sync(0xffffffffu, r.inv[a], src);
      q.oi[a] = __shfl_sync(0xffffffffu, r.oi[a], src);
    }
    q.tmax = __shfl_sync(0xffffffffu, r.tmax, src);
    Nearest loc;
    clear(loc, k);
    const int mine = scan_groups(q, boxes, groups, s_dead, k, gsize, lane, 32, loc);
    const int all = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(mine)));
    // kCand rounds: the warp's smallest (entry, id) head; its lane pops it
    // (ids are distinct over the lanes; empty heads are (inf, k) everywhere)
#pragma unroll
    for (int w = 0; w < kCand; ++w) {
      float v = loc.e[0];
      int id = loc.id[0];
      warp_argmin(v, id);
      if (v < kInf && loc.id[0] == id) {
#pragma unroll
        for (int i = 0; i + 1 < kCand; ++i) { loc.e[i] = loc.e[i + 1]; loc.id[i] = loc.id[i + 1]; }
        loc.e[kCand - 1] = kInf;
        loc.id[kCand - 1] = k;
      }
      if (lane == src) { nb.e[w] = v; nb.id[w] = v < kInf ? id : k; }
    }
    if (lane == src) {
      finish(nb);
      tests += all;
    }
  }
}

// The nearest cluster was retired: drop it and any retired ones after it;
// returns whether the list is used up while the boxes may hold more (a
// rescan is needed).
__device__ __forceinline__ bool pop(const unsigned* s_dead, int k, Nearest& nb) {
  do {
#pragma unroll
    for (int i = 0; i + 1 < kCand; ++i) { nb.e[i] = nb.e[i + 1]; nb.id[i] = nb.id[i + 1]; }
    nb.e[kCand - 1] = kInf;
    nb.id[kCand - 1] = k;
    --nb.left;
  } while (nb.left > 0 && retired(s_dead, nb.id[0]));
  return nb.left == 0 && nb.full;
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

// Profile columns per block (kProfile): cycles of the set-up scan, of pick
// and staging, of the slot loop with the retirement, and of the list
// updates with their rescans (each phase up to the barrier after it, so a
// phase's time is its slowest thread's), the block's total cycles and its
// retirement steps.
constexpr int kProfileCols = 6;

template <int kScan, bool kProfile>
__global__ void fused_kernel(const float* __restrict__ rays, const float* __restrict__ boxes,
                             const float* __restrict__ groups, const float* __restrict__ planes,
                             float* __restrict__ out, int k, int c, int gsize, int max_steps,
                             long long* __restrict__ profile, int* __restrict__ counts) {
  constexpr bool kG = kScan == kWarpGroups;
  extern __shared__ float smem[];
  const int b = blockDim.x;
  const int tid = threadIdx.x;
  float* s_plane = smem;                                     // [10, c]
  int* red = reinterpret_cast<int*>(s_plane + kMtRows * c);  // [32]
  unsigned* s_dead = reinterpret_cast<unsigned*>(red + 32);  // [(k + 31) / 32] retired bits

  const long long t_start = kProfile ? clock64() : 0;
  long long t_phase[4] = {0, 0, 0, 0};  // set-up scan, pick and stage, slot loop, list updates
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
  int steps = 0, rescans = 0;
  Nearest nb;  // nb.e[0], nb.id[0]: the nearest entry (inf, k when none is left)
  int tests = scan<kG>(r, boxes, groups, s_dead, k, gsize, nb);
  long long t_mark = 0;
  if (kProfile) {
    __syncthreads();
    t_mark = clock64();
    t_phase[0] = t_mark - t_start;
  }

  for (int i = 0; i < max_steps; ++i) {
    const int cstar = block_min(nb.e[0] < best_t ? nb.id[0] : k, red);
    if (cstar >= k) break;  // no active ray: the block is done (uniform)
    const float* src = planes + static_cast<long long>(cstar) * kPlaneRows * c;
    for (int q = tid; q < kMtRows * c; q += b) s_plane[q] = src[q];
    __syncthreads();
    if (kProfile) {
      const long long t = clock64();
      t_phase[1] += t - t_mark;
      t_mark = t;
    }

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
    if (kProfile) {
      const long long t = clock64();
      t_phase[2] += t - t_mark;
      t_mark = t;
    }
    // only a still-active ray needs its next nearest entry: entries only
    // grow and best t only shrinks, so an inactive ray stays inactive (and
    // resolved) with its stale nearest entry
    bool need = false;
    if (nb.id[0] == cstar && nb.e[0] < best_t) need = pop(s_dead, k, nb);
    rescans += need;
    if constexpr (kG) {
      warp_rescan(r, need, boxes, groups, s_dead, k, gsize, nb, tests);
    } else if (need) {
      tests += scan<kG>(r, boxes, groups, s_dead, k, gsize, nb);
    }
    if (kProfile) {
      __syncthreads();
      const long long t = clock64();
      t_phase[3] += t - t_mark;
      t_mark = t;
    }
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
  if (kProfile) {
    counts[2 * row] = rescans;
    counts[2 * row + 1] = tests;
    __syncthreads();
    if (tid == 0) {
      long long* p = profile + static_cast<long long>(blockIdx.x) * kProfileCols;
#pragma unroll
      for (int x = 0; x < 4; ++x) p[x] = t_phase[x];
      p[4] = clock64() - t_start;
      p[5] = steps;
    }
  }
}

template <int kScan, bool kProfile>
void* kernel_of() {
  return reinterpret_cast<void*>(fused_kernel<kScan, kProfile>);
}

// The instantiation of scan kind `scan` (nullptr if none).
template <bool kProfile>
void* kernel_for(int scan) {
  switch (scan) {
    case kSerial: return kernel_of<kSerial, kProfile>();
    case kWarpGroups: return kernel_of<kWarpGroups, kProfile>();
    default: return nullptr;
  }
}

int launch(bool profile_on, const float* rays, const float* boxes, const float* groups, const float* planes,
           float* out, long long n, int k, int c, int gsize, int block, int max_steps, int scan,
           long long* profile, int* counts, void* stream) {
  if (n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || k <= 0 || c <= 0 || gsize <= 0 ||
      max_steps < 0 || n / block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  void* kernel = profile_on ? kernel_for<true>(scan) : kernel_for<false>(scan);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(k, c);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>(n / block);
  void* args[] = {&rays, &boxes, &groups, &planes, &out, &k, &c, &gsize, &max_steps, &profile, &counts};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(grid), dim3(block), args, smem,
                                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Registers per thread, dynamic shared bytes per block and resident blocks
// per SM of scan kind `scan` at (k, c, block) on the current device ->
// out[0..2]; returns the CUDA error.
extern "C" int owlpt_fused_traverse_resources(int k, int c, int block, int scan, int* out) {
  const size_t smem = shared_bytes(k, c);
  const void* kernel = kernel_for<false>(scan);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, smem);
  out[0] = e == cudaSuccess ? attr.numRegs : -1;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  return static_cast<int>(e);
}

extern "C" int owlpt_fused_traverse(const float* rays, const float* boxes, const float* groups,
                                    const float* planes, float* out, long long n, int k, int c, int gsize,
                                    int block, int max_steps, int scan, void* stream) {
  return launch(false, rays, boxes, groups, planes, out, n, k, c, gsize, block, max_steps, scan, nullptr, nullptr,
                stream);
}

// Diagnostic (no render path): the same traversal with clock64 phase times
// per block -> profile [N / block, kProfileCols] (int64), and per ray its
// rescans and boxes slab-tested -> counts [N, 2] (int32).
extern "C" int owlpt_fused_traverse_profile(const float* rays, const float* boxes, const float* groups,
                                            const float* planes, float* out, long long n, int k, int c,
                                            int gsize, int block, int max_steps, int scan, long long* profile,
                                            int* counts, void* stream) {
  return launch(true, rays, boxes, groups, planes, out, n, k, c, gsize, block, max_steps, scan, profile, counts,
                stream);
}
