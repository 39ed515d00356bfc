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
// comparison and pick is the reference's.  So K has no limit of its own,
// as in the reference.
//
// The list scans.  Measured on the dragon7 / dragon8 centre bounce waves
// (PERF.md, K5) with every ray scanning all K boxes itself, a thread
// slab-tested 2,804 / 11,359 boxes on average, and the set-up scan was half
// the time of the average block; rescans are rare (0.04-0.06 per ray) but
// each stalled its warp for a K-box scan and the block at the next barrier.
// Group boxes (G = 32 clusters each) let a scan skip every member of a group
// that the ray enters no nearer than its list's last entry, exactly (a
// member never enters before its group): 162 / 438 boxes per ray.  A rescan
// is shared by the warp (warp_member_scan).  The lists are those of a scan
// of every box (ops/fused.py nearest_lists is the plain version of both).
//
// The step.  What bounded the step this kernel replaced (one thread per
// ray, testing its slots in turn) on this card: it was paced by its slowest
// block, which retires 80 / 142 clusters on the dragon7 / dragon8 centre
// bounce waves against a mean of 21 / 36 and runs nearly alone at the end of
// a wave of 512 blocks (fewer than the card holds at once).  Per step that
// block waited on three things, all latency,
// none throughput (a ray tests 2.4-2.5 clusters on those waves, about the
// clusters its exact query needs, and the card's issue rate is far from
// used): one thread per ray tests its C slots one after another, each a
// dependent Moller-Trumbore chain with an IEEE division whose slow-path
// branch keeps chains from overlapping, so a warp with one ray entering the
// cluster pays C chains; the rescans, in which one lane at a time scans the
// members of a group its ray enters, one after another, while its warp and
// then the block wait at the next barrier; and the ten plane rows staged by
// ten dependent loads per thread.  The slot-parallel step (slot_kernel)
// keeps the block algorithm, the lists and the picks, and runs a step so:
//   * a pre-pass (weight_kernel) weighs each block by the distinct group
//     boxes its rays enter, a count that follows the block's retirements
//     closely; order_blocks ranks the blocks by weight and the step kernel
//     takes them heaviest first;
//   * after the pick (one barrier: the reduction slots alternate between
//     two buffers), one thread starts a bulk copy (cp.async.bulk, the 1-D
//     TMA) of the cluster's ten plane rows, which are contiguous (40 C bytes
//     rounded up to 16, 5 KB at C=128), on an mbarrier, and retires the
//     cluster; while the copy is in flight every thread recomputes its ray's
//     entry to the cluster and the rays that will test it are compacted into
//     a list (a ballot and one shared atomic per warp);
//   * each warp takes one listed ray at a time and its lanes take the slots
//     (lane, lane + 32, ...), four at a time in three passes (det, 1/det,
//     the rest), so that the chains overlap; every slot uses the window
//     fixed at the step's start, and a shuffle argmin on (t, slot) picks the
//     lowest slot of the lowest t, a slot loop's strict-< winner; the
//     winning lane leaves (t, u, v, tri) for the ray's own thread, which
//     applies it after one barrier;
//   * a rescan is the warp's, one ray at a time (warp_member_scan): the
//     lanes slab-test 32 group boxes at once and the members of an entered
//     group at once, so a rescan costs a few rounds of loads instead of one
//     lane's members in a row.  The set-up scan stays one thread per ray:
//     run by warp_member_scan it lost on the coherent primary waves (whose
//     lanes enter the same groups and test their members together anyway)
//     and gained nothing measurable on the bounce waves, whether for every
//     warp or only for warps whose rays enter groups of their own.
// So a step costs the block work in proportion to the rays that enter the
// cluster, not to the warps that hold one.

// Arithmetic.  Moller-Trumbore follows ops/intersect.py mt_components
// operation for operation (1/det then multiply, sums left to right); built
// with --fmad=false and IEEE division, so t/u/v agree bit for bit with the
// plain PyTorch version (ops/fused.py fused_traverse_plain), whichever
// thread tests the slot.
//
// Work.  The least an exact query does per ray is the slab test (28
// operations) and Moller-Trumbore (about 45 fp32 operations per slot) of
// each cluster whose box it enters before its closest hit; this kernel also
// slab-tests every group box and the members of the groups it cannot skip,
// and a ray tests every cluster its block retires while it enters it
// before its best hit (the reference's pick rule: 14x the needed clusters
// per block on dragon8).  Plane rows (10 x C floats) are read once per
// block and retired cluster, by the copy engine in the slot-parallel step.
// Shared memory (step_shared_bytes below) is a few KB per block, so
// registers set the blocks per SM.

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

// The SM's cycle counter for the profile entry.  clock64() is an intrinsic
// without memory effects, which the compiler may move across a
// __syncthreads(), and then a phase's wait at its closing barrier lands in
// the next phase; an asm statement with a memory clobber stays in place.
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t)::"memory");
  return t;
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

// How a list is (re)built: the kCand smallest (entry, id) pairs over the
// un-retired clusters (a scan in ascending j keeps an equal entry's lower
// id first).  Each thread's set-up scan tests the group boxes (the exact
// bounds of G consecutive clusters) and only the members of a group whose
// entry is below its list's last entry: a member's slab entry is never
// below its group's (the slab ops and their roundings are monotone in the
// bounds), so the skip is exact.  A rescan is done by the whole warp
// (warp_member_scan).

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

// Scan the groups (G = gsize clusters each) into nb, each group's members
// only where the group's entry is below nb's last entry; returns the boxes
// tested (groups and members).
__device__ __forceinline__ int scan_groups(const Ray& r, const float* __restrict__ boxes,
                                           const float* __restrict__ groups, const unsigned* s_dead, int k,
                                           int gsize, Nearest& nb) {
  const int kg = (k + gsize - 1) / gsize;
  int tests = 0;
  for (int gi = 0; gi < kg; ++gi) {
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

// One thread's set-up scan of its own ray -> nb; returns the boxes tested.
__device__ int scan(const Ray& r, const float* __restrict__ boxes, const float* __restrict__ groups,
                    const unsigned* s_dead, int k, int gsize, Nearest& nb) {
  clear(nb, k);
  const int tests = scan_groups(r, boxes, groups, s_dead, k, gsize, nb);
  finish(nb);
  return tests;
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

// Profile columns per block (kProfile), row = the block of rays: cycles of
// the set-up scan, of pick and staging, of the slot tests with the retirement, and of the list
// updates with their rescans (each phase up to the barrier after it, so a
// phase's time is its slowest thread's), the block's total cycles, its
// retirement steps, its launch rank (blockIdx.x of the CTA that ran it) and
// its weight (the pre-pass's).
constexpr int kProfileCols = 8;
// Count columns per ray (kProfile): its rescans, the boxes it slab-tested
// and the clusters whose slots it tested.
constexpr int kCountCols = 3;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that one arrival (with its transaction bytes) completes.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One bulk copy (1-D TMA) of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from device memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Wait until bar's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bytes of a cluster's ten plane rows as one bulk copy: 40 C rounded up to
// 16 (the rounding reads into row 10, a zero row of the same cluster).
__host__ __device__ constexpr unsigned plane_bytes(int c) { return (40u * c + 15u) & ~15u; }

// Block-wide integer minimum with one barrier; every thread gets it.  red
// holds one slot per warp, and a caller alternates between two such buffers
// over its iterations (a buffer is written again only two barriers after
// its last read).
__device__ __forceinline__ int block_min_once(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < nw; ++w) r = min(r, red[w]);
  return r;
}

__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(v)));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < nw; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Ray row `row` of rays [N,8] -> r (and its direction, for the slot tests).
__device__ __forceinline__ void load_ray(const float* __restrict__ rays, long long row, Ray& r, float (&d)[3]) {
  const float* rr = rays + row * kCols;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = rr[a];
    d[a] = rr[3 + a];
    r.inv[a] = inv_dir(d[a]);
    r.oi[a] = r.o[a] * r.inv[a];
  }
  r.tmax = rr[6];
}

// order[rank] = blk: the blocks by weight, heaviest first, ties in block
// order (a stable rank by counting; csrc/fused2_traverse.cu order_blocks).
__global__ void order_blocks(const int* __restrict__ weight, int* __restrict__ order, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= blocks) return;
  const int e = weight[i];
  int rank = 0;
  for (int j = 0; j < blocks; ++j) {
    const int f = weight[j];
    rank += f > e || (f == e && j < i);
  }
  order[rank] = i;
}

// Slots a lane tests per batch in test_ray.
constexpr int kLaneSlots = 4;

// One listed ray (o, d in ta / tb.xy, best t at the step's start in tb.z)
// against the staged cluster, by one warp: lane l tests slots l, l + 32, ...
// in ascending order (strict <: its lowest slot of its lowest t), and a
// shuffle argmin on (t, slot) gives the lowest slot of the lowest t over the
// cluster; the lane that holds it writes (t, u, v, tri) to win, lane 0
// writes t = inf when no slot is valid.  A lane takes kLaneSlots slots at a
// time in three passes, each over all of them: det, then 1/det, then the
// rest of mt_components with the same operations in the same order; each
// IEEE reciprocal ends in a branch to its slow path, so in one pass per slot
// the chains could not overlap, and in three passes the first and the last
// interleave.
__device__ __forceinline__ void test_ray(const float* s_plane, int c, float4 ta, float4 tb, float4* win) {
  const int lane = threadIdx.x & 31;
  const float ox = ta.x, oy = ta.y, oz = ta.z, dx = ta.w, dy = tb.x, dz = tb.y, t_max = tb.z;
  float tc = kInf, tu = 0.0f, tv = 0.0f;
  int ts = c;
  for (int s0 = lane; s0 < c; s0 += 32 * kLaneSlots) {
    float hx[kLaneSlots], hy[kLaneSlots], hz[kLaneSlots], det[kLaneSlots], inv[kLaneSlots];
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      const int s = min(s0 + 32 * j, c - 1);  // a slot past C repeats the last one and is not kept
      const float e1x = s_plane[3 * c + s], e1y = s_plane[4 * c + s], e1z = s_plane[5 * c + s];
      const float e2x = s_plane[6 * c + s], e2y = s_plane[7 * c + s], e2z = s_plane[8 * c + s];
      hx[j] = dy * e2z - dz * e2y;
      hy[j] = dz * e2x - dx * e2z;
      hz[j] = dx * e2y - dy * e2x;
      det[j] = e1x * hx[j] + e1y * hy[j] + e1z * hz[j];
    }
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) inv[j] = 1.0f / (fabsf(det[j]) < kEpsDet ? 1.0f : det[j]);
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      const int s = min(s0 + 32 * j, c - 1);
      const float p0x = s_plane[s], p0y = s_plane[c + s], p0z = s_plane[2 * c + s];
      const float e1x = s_plane[3 * c + s], e1y = s_plane[4 * c + s], e1z = s_plane[5 * c + s];
      const float e2x = s_plane[6 * c + s], e2y = s_plane[7 * c + s], e2z = s_plane[8 * c + s];
      const float tri = s_plane[9 * c + s];
      const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
      const float u = inv[j] * (sx * hx[j] + sy * hy[j] + sz * hz[j]);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = inv[j] * (dx * qx + dy * qy + dz * qz);
      const float t = inv[j] * (e2x * qx + e2y * qy + e2z * qz);
      const bool ok = fabsf(det[j]) >= kEpsDet && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin &&
                      t < t_max && tri >= 0.0f && s0 + 32 * j < c;
      if (ok && t < tc) { tc = t; tu = u; tv = v; ts = s0 + 32 * j; }
    }
  }
  float bt = tc;
  int bs = ts;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
    const int os = __shfl_xor_sync(0xffffffffu, bs, off);
    if (ot < bt || (ot == bt && os < bs)) { bt = ot; bs = os; }
  }
  if (bs >= c) {
    if (lane == 0) *win = make_float4(kInf, 0.0f, 0.0f, 0.0f);
  } else if (ts == bs) {
    *win = make_float4(bt, tu, tv, s_plane[9 * c + bs]);
  }
}

// The slot-parallel step's rescan: the warp builds the list of every lane
// with `need` anew, one lane at a time (every lane of the warp calls this),
// and adds the boxes tested to that lane's `tests`.  Every lane holds the list
// being built.  The lanes slab-test 32 group boxes at a time; a group whose
// entry is below the list's last entry (the group skip of scan_groups,
// exact) has its members slab-tested by the lanes at once, and those below
// the last entry go into the list in ascending id, so the list is the kCand
// smallest (entry, id) pairs, as every scan builds it.  (warp_rescan hands
// each lane a group and its members in turn: a lane with an entered group
// then tests its members one after another while the warp, and at the next
// barrier the block, waits.)
__device__ void warp_member_scan(const Ray& r, bool need, const float* __restrict__ boxes,
                                    const float* __restrict__ groups, const unsigned* s_dead, int k, int gsize,
                                    Nearest& nb, int& tests) {
  const int lane = threadIdx.x & 31;
  const int kg = (k + gsize - 1) / gsize;
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
    Nearest loc;  // the same on every lane
    clear(loc, k);
    int mine = 0;
    for (int g0 = 0; g0 < kg; g0 += 32) {
      const int gi = g0 + lane;
      const float ge = gi < kg ? entry(q, groups, kg, gi) : kInf;
      mine += gi < kg;
      unsigned entered = __ballot_sync(0xffffffffu, ge < loc.e[kCand - 1]);
      while (entered) {  // uniform: the groups in ascending id
        const int l = __ffs(entered) - 1;
        entered &= entered - 1;
        if (!(__shfl_sync(0xffffffffu, ge, l) < loc.e[kCand - 1])) continue;  // the list has moved below it
        const int j1 = min(k, (g0 + l + 1) * gsize);
        for (int j0 = (g0 + l) * gsize; j0 < j1; j0 += 32) {
          const int j = j0 + lane;
          const bool live = j < j1 && !retired(s_dead, j);
          const float e = live ? entry(q, boxes, k, j) : kInf;
          mine += live;
          unsigned below = __ballot_sync(0xffffffffu, e < loc.e[kCand - 1]);
          while (below) {  // uniform: the members in ascending id
            const int m = __ffs(below) - 1;
            below &= below - 1;
            insert(loc, __shfl_sync(0xffffffffu, e, m), j0 + m);
          }
        }
      }
    }
    const int all = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(mine)));
    if (lane == src) {
#pragma unroll
      for (int i = 0; i < kCand; ++i) { nb.e[i] = loc.e[i]; nb.id[i] = loc.id[i]; }
      finish(nb);
      tests += all;
    }
  }
}

// The pre-pass of the slot-parallel step, one CTA per block of rays and one
// thread per ray: the block's weight, the distinct group boxes (gsize
// consecutive clusters each) that its rays enter within their t_max, into
// weight[blk].  Every lane tests every group box, so the warp stays in step
// and no member is tested: a fraction of the set-up scan, which the step
// kernel runs itself, where the scans of light blocks overlap the steps of
// heavy ones.
__global__ void weight_kernel(const float* __restrict__ rays, const float* __restrict__ groups,
                              int* __restrict__ weight, int k, int gsize) {
  extern __shared__ unsigned s_bits[];  // [(kg + 31) / 32]: the groups entered
  const int kg = (k + gsize - 1) / gsize, words = (kg + 31) / 32;
  int* red = reinterpret_cast<int*>(s_bits + words);  // [32]
  const int b = blockDim.x, tid = threadIdx.x;
  for (int q = tid; q < words; q += b) s_bits[q] = 0u;
  Ray r;
  float d[3];
  load_ray(rays, static_cast<long long>(blockIdx.x) * b + tid, r, d);
  __syncthreads();
  for (int gi = 0; gi < kg; ++gi) {  // uniform over the block
    const unsigned m = __ballot_sync(0xffffffffu, entry(r, groups, kg, gi) < kInf);
    if ((tid & 31) == 0 && m != 0u) atomicOr(&s_bits[gi >> 5], 1u << (gi & 31));
  }
  __syncthreads();
  int entered = 0;
  for (int q = tid; q < words; q += b) entered += __popc(s_bits[q]);
  entered = block_sum(entered, red);
  if (tid == 0) weight[blockIdx.x] = entered;
}

// Dynamic shared memory of one slot-parallel block, in slot_kernel's
// carve-up order: the ten plane rows (plane_bytes), the rays' rows [b]
// float4 x 2 (ox oy oz dx | dy dz best_t 0), their cluster winners [b]
// float4 (t u v tri), the mbarrier (16 bytes with its pad), the list of
// testing rays [b] int, two reduction buffers [2][32] int, the list length
// (4 ints), a retired bit per cluster.
size_t step_shared_bytes(int k, int c, int b) {
  return plane_bytes(c) + 16 * 3 * static_cast<size_t>(b) + 16 +
         4 * (static_cast<size_t>(b) + 64 + 4 + (static_cast<size_t>(k) + 31) / 32);
}

// The slot-parallel step (see the note at the top): the CTA blockIdx.x runs
// the block of rays order[blockIdx.x]; weight is read by the profile only.
template <bool kProfile>
__global__ void slot_kernel(const float* __restrict__ rays, const float* __restrict__ boxes,
                            const float* __restrict__ groups, const float* __restrict__ planes,
                            const int* __restrict__ order, const int* __restrict__ weight, float* __restrict__ out,
                            int k, int c, int gsize, int max_steps, long long* __restrict__ profile,
                            int* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockDim.x, tid = threadIdx.x, warp = tid >> 5, nw = b >> 5;
  const unsigned pbytes = plane_bytes(c);
  float* s_plane = smem;                                                      // [10, c] (+ pad)
  float4* s_ta = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + pbytes);  // [b]
  float4* s_tb = s_ta + b;                                                    // [b]
  float4* s_win = s_tb + b;                                                   // [b]
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(s_win + b);
  int* s_list = reinterpret_cast<int*>(bar + 2);  // [b]
  int* red = s_list + b;                          // [2][32]
  int* s_n = red + 64;                            // [4]: the list length
  unsigned* s_dead = reinterpret_cast<unsigned*>(s_n + 4);

  const long long t_start = kProfile ? clock_now() : 0;
  long long t_phase[4] = {0, 0, 0, 0};  // set-up scan, pick and stage, slot tests, list updates
  for (int q = tid; q < (k + 31) / 32; q += b) s_dead[q] = 0u;
  if (tid == 0) {
    mbar_init(bar);
    *s_n = 0;
  }
  const int blk = order[blockIdx.x];
  const long long row = static_cast<long long>(blk) * b + tid;
  Ray r;
  float d[3];
  load_ray(rays, row, r, d);
  s_ta[tid] = make_float4(r.o[0], r.o[1], r.o[2], d[0]);
  s_tb[tid] = make_float4(d[1], d[2], r.tmax, 0.0f);
  __syncthreads();

  float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f, best_tri = -1.0f;
  bool hit = false;
  int steps = 0, rescans = 0, tested = 0;
  Nearest nb;  // nb.e[0], nb.id[0]: the nearest entry (inf, k when none is left)
  int tests = scan(r, boxes, groups, s_dead, k, gsize, nb);
  long long t_mark = 0;
  if (kProfile) {
    __syncthreads();
    t_mark = clock_now();
    t_phase[0] = t_mark - t_start;
  }

  unsigned parity = 0;
  for (int i = 0; i < max_steps; ++i) {
    const int cstar = block_min_once(nb.e[0] < best_t ? nb.id[0] : k, red + 32 * (i & 1));
    if (cstar >= k) break;  // no active ray: the block is done (uniform)
    if (tid == 0) {
      bulk_load(s_plane, planes + static_cast<long long>(cstar) * kPlaneRows * c, pbytes, bar);
      s_dead[cstar >> 5] |= 1u << (cstar & 31);  // retired for the whole block (read after the next barrier)
    }
    // while the rows land: the rays that test this cluster, as a list
    const bool test = entry(r, boxes, k, cstar) < best_t;
    const unsigned m = __ballot_sync(0xffffffffu, test);
    int at = 0;
    if ((tid & 31) == 0 && m != 0u) at = atomicAdd(s_n, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (test) s_list[at + __popc(m & ((1u << (tid & 31)) - 1u))] = tid;
    __syncthreads();
    const int nl = *s_n;
    mbar_wait(bar, parity);
    parity ^= 1u;
    if (kProfile) {
      const long long t = clock_now();
      t_phase[1] += t - t_mark;
      t_mark = t;
    }

    for (int idx = warp; idx < nl; idx += nw) {
      const int q = s_list[idx];
      test_ray(s_plane, c, s_ta[q], s_tb[q], s_win + q);
    }
    __syncthreads();  // every winner is written; s_plane, s_list and s_n are free
    if (tid == 0) *s_n = 0;
    if (test) {
      ++tested;
      const float4 w = s_win[tid];
      if (w.x < best_t) {
        best_t = w.x; best_u = w.y; best_v = w.z; best_tri = w.w;
        hit = true;
        s_tb[tid].z = best_t;
      }
    }
    ++steps;
    if (kProfile) {
      const long long t = clock_now();
      t_phase[2] += t - t_mark;
      t_mark = t;
    }
    // only a still-active ray needs its next nearest entry: entries only
    // grow and best t only shrinks, so an inactive ray stays inactive (and
    // resolved) with its stale nearest entry
    bool need = false;
    if (nb.id[0] == cstar && nb.e[0] < best_t) need = pop(s_dead, k, nb);
    rescans += need;
    warp_member_scan(r, need, boxes, groups, s_dead, k, gsize, nb, tests);
    if (kProfile) {
      __syncthreads();
      const long long t = clock_now();
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
    counts[kCountCols * row] = rescans;
    counts[kCountCols * row + 1] = tests;
    counts[kCountCols * row + 2] = tested;
    __syncthreads();
    if (tid == 0) {
      long long* p = profile + static_cast<long long>(blk) * kProfileCols;
#pragma unroll
      for (int x = 0; x < 4; ++x) p[x] = t_phase[x];
      p[4] = clock_now() - t_start;
      p[5] = steps;
      p[6] = blockIdx.x;
      p[7] = weight[blk];
    }
  }
}

// ── launches ──────────────────────────────────────────────────────────────

bool bad_shape(long long n, int k, int c, int gsize, int block, int max_steps) {
  return n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || k <= 0 || c <= 0 || gsize <= 0 ||
         max_steps < 0 || n / block > 0x7fffffffLL;
}

// Three launches on `stream`: the block weights (weight_kernel, into the
// scratch weight [n / block] int32), the blocks' order (order_blocks, into
// order [n / block] int32), then slot_kernel.  planes must be 16-byte
// aligned (the bulk copy's source).
int launch(bool profile_on, const float* rays, const float* boxes, const float* groups, const float* planes,
           float* out, int* weight, int* order, long long n, int k, int c, int gsize, int block, int max_steps,
           long long* profile, int* counts, void* stream) {
  if (bad_shape(n, k, c, gsize, block, max_steps) || !weight || !order ||
      (reinterpret_cast<unsigned long long>(planes) & 15ull) || (profile_on && (!profile || !counts)))
    return static_cast<int>(cudaErrorInvalidValue);
  void* kernel =
      profile_on ? reinterpret_cast<void*>(slot_kernel<true>) : reinterpret_cast<void*>(slot_kernel<false>);
  const auto st = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(n / block);
  const size_t weight_smem = 4 * ((static_cast<size_t>((k + gsize - 1) / gsize) + 31) / 32 + 32);
  // every launch sets its own bytes: a resource query at a smaller K may
  // have left the attribute below them
  cudaError_t e = cudaFuncSetAttribute(weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(weight_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  weight_kernel<<<blocks, block, weight_smem, st>>>(rays, groups, weight, k, gsize);
  order_blocks<<<(blocks + 255) / 256, 256, 0, st>>>(weight, order, blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = step_shared_bytes(k, c, block);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&rays, &boxes, &groups, &planes, &order, &weight, &out, &k, &c, &gsize, &max_steps, &profile,
                  &counts};
  e = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(block), args, smem, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Registers per thread, dynamic shared bytes per block and resident blocks
// per SM of slot_kernel at (k, c, block) on the current device -> out[0..2];
// returns the CUDA error.
extern "C" int owlpt_fused_traverse_resources(int k, int c, int block, int* out) {
  const size_t smem = step_shared_bytes(k, c, block);
  const void* kernel = reinterpret_cast<const void*>(slot_kernel<false>);
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

// The traversal: weight and order [n / block] int32 are the wrapper's scratch.
extern "C" int owlpt_fused_traverse(const float* rays, const float* boxes, const float* groups,
                                    const float* planes, float* out, int* weight, int* order, long long n, int k,
                                    int c, int gsize, int block, int max_steps, void* stream) {
  return launch(false, rays, boxes, groups, planes, out, weight, order, n, k, c, gsize, block, max_steps, nullptr,
                nullptr, stream);
}

// Diagnostic (no render path): the traversal with clock64 phase times per
// block -> profile [N / block, kProfileCols] (int64), and per ray its
// rescans, boxes slab-tested and clusters tested -> counts [N, 3] (int32);
// the scratch as for owlpt_fused_traverse.
extern "C" int owlpt_fused_traverse_profile(const float* rays, const float* boxes, const float* groups,
                                            const float* planes, float* out, int* weight, int* order, long long n,
                                            int k, int c, int gsize, int block, int max_steps, long long* profile,
                                            int* counts, void* stream) {
  return launch(true, rays, boxes, groups, planes, out, weight, order, n, k, c, gsize, block, max_steps, profile,
                counts, stream);
}
