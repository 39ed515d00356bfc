// Fused traversal over fat triangle clusters, for Hopper (sm_90a).
//
// Replaces the component-plane modes of the Pallas kernel
// owl_path_tracer_tpu/ops/fused2.py:_kernel (launched by fused2_traverse_packed):
//   closest  closest hit + attributes  (with_attrs=True)          -> K1
//   any-hit  occlusion only            (any_hit=True, no attrs)   -> K2
//   mixed    closest hit + attributes for lanes with ray col 7 = 0,
//            occlusion for lanes with col 7 > 0 (mixed=True)      -> K3
// on the layout planes [K,16,C] (rows 0-8 p0/e1/e2, row 9 tri id),
// attrs [K,32,C], boxes [8,K]; rays [N,8] (o, d, tmax, shadow flag) ->
// out [N,32] (t u v tri hit resolved steps wcid wslot, 0..., attr rows 0-15).
// One templated body serves the three modes, as the Pallas kernel's static
// flags do; each mode has its own extern "C" entry point.
//
// One CUDA block per `block` rays, one thread per ray:
//   1. scene gate: the block skips everything when no ray enters the scene AABB;
//   2. phase A: the block frontier bent[K] (nearest entry over the block's
//      rays, per cluster) in shared memory -- each thread owns the clusters
//      j = tid, tid + B, ... and slab-tests them against every ray, whose
//      origin, 1/d, tmax and cap sit in shared memory;
//   3. retirement loop (at most max_steps): retire the current cluster, pick
//      the next one (nearest entry below the block's prune bound; ties to
//      the lowest id) with the prune bound from before this cluster's test,
//      stage the current cluster's 10 x C plane rows in shared memory, run
//      Moller-Trumbore per ray over the C slots (strict <, so the lowest slot
//      wins a tie); every `refresh` iterations the frontier is recomputed with
//      each ray's own cap (retired clusters stay retired);
//   4. a block that ends at max_steps with a candidate nearer than its prune
//      bound marks all its rays unresolved (the wrapper answers them with the
//      exact cluster query);
//   5. closest and mixed: the winner's 32-float attribute row is read straight
//      from attrs, and its (t, u, v) replayed from the winner geometry rows
//      17-25.
//
// The prune bound and the refresh cap are where the modes differ:
//   closest  bound = max over rays of best t; cap = best t.
//   any-hit  best t is never lowered (column 0 stays tmax); an occluded ray
//            leaves the bound (it counts as -inf, so a block whose rays are
//            all occluded picks nothing and stops) and gets cap 0, so the
//            refresh finds no cluster it needs; an occluded thread skips its
//            Moller-Trumbore loop, and a thread stops its loop at its first
//            valid hit -- both exact for the flag.
//   mixed    the closest-hit chain on every lane; after each retired cluster
//            a shadow lane with a hit gets best t := t_min, which takes it out
//            of the bound and of any later hit, and (cap t_min <= every entry)
//            out of the refresh; its thread then skips its loop.  Pruning is
//            conservative, so a closest-hit lane gets K1's answer whatever
//            shares its block (up to the visiting order of an exact t tie).
//
// Intersection arithmetic follows ops/intersect.py mt_components operation
// for operation (1/det then multiply, sums left to right).  Built with
// --fmad=false and IEEE division, so no product is contracted into an FMA and
// the kernel's t/u/v are bit-equal to the plain PyTorch version's.
//
// What bounds it on the card: the Moller-Trumbore arithmetic, about 45 fp32
// operations per ray and slot (C slots per cluster).  A ray tests every
// cluster its block retires while it is still searching, which is at least
// the clusters its own exact query needs (chip_smoke.py's bound counts
// those); any-hit and shadow lanes stop at their first hit.  For
// coherent blocks the per-iteration block reductions (pick over K, max of the
// bound) come next.  Plane bytes per retired cluster (10 x C floats, 20 KB at
// C=512) are read once per block, not once per ray, and stay L2-resident for
// the scene sizes of the main path.  No cp.async/TMA double buffering, no
// fanout and no bf16 planes yet: this is the simple, exact form of the kernel.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kPlaneRows = 16;  // rows per cluster in planes
constexpr int kMtRows = 10;     // rows staged per cluster: p0 e1 e2 (9) + tri id
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

// Nearest still-needed cluster: the lowest id holding the minimum of bent,
// if that minimum is below pmax; else k (none).
__device__ int pick_cluster(const float* bent, int k, float pmax, float* red_f, int* red_i) {
  float mn = kInf;
  int idx = k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (bent[j] < mn) { mn = bent[j]; idx = j; }
  }
  block_argmin(mn, idx, red_f, red_i);
  return mn < pmax ? idx : k;
}

// Frontier pass: bent[j] = min over rays of the entry distance of rays that
// need cluster j (entry within [t_min, min(t_far, tmax)] and, unless first,
// below the ray's cap).  Retired (inf) clusters stay retired unless first.
__device__ void frontier_update(float* bent, const float* __restrict__ boxes, int k,
                                const float* s_ray, int b, bool first) {
  const float* s_ox = s_ray;
  const float* s_oy = s_ray + b;
  const float* s_oz = s_ray + 2 * b;
  const float* s_ix = s_ray + 3 * b;
  const float* s_iy = s_ray + 4 * b;
  const float* s_iz = s_ray + 5 * b;
  const float* s_tmax = s_ray + 6 * b;
  const float* s_cap = s_ray + 7 * b;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
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

template <int kMode>
__global__ void fused2_kernel(
    const float* __restrict__ rays, const float* __restrict__ boxes,
    const float* __restrict__ planes, const float* __restrict__ attrs,
    float* __restrict__ out, int k, int c, int max_steps, int refresh) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  const int tid = threadIdx.x;
  float* bent = smem;                   // [k], padded to a multiple of 4
  float* s_plane = bent + ((k + 3) & ~3);  // [kMtRows, c], 16-byte aligned
  float* s_ray = s_plane + kMtRows * c; // [8, b]: o, 1/d, tmax, cap
  float* red_f = s_ray + 8 * b;         // [32]
  int* red_i = reinterpret_cast<int*>(red_f + 32);  // [32]

  const long long ray = static_cast<long long>(blockIdx.x) * b + tid;
  const float* r = rays + ray * 8;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  const float tmax = r[6];
  const bool shadow = kMode == kMixed && r[7] > 0.0f;
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);

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

  float best_t = tmax, best_u = 0.0f, best_v = 0.0f;
  bool hit = false;
  int wcid = -1, wslot = -1;
  int steps = 0;
  bool resolved = true;

  if (scene_live) {
    // this ray's share of the block prune bound, and its refresh cap
    auto bound_t = [&]() { return kMode == kAnyHit && hit ? -kInf : best_t; };
    auto cap_t = [&]() { return kMode == kAnyHit && hit ? 0.0f : best_t; };
    // a ray that is done needs no more Moller-Trumbore tests
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
    int cur = pick_cluster(bent, k, block_max(bound_t(), red_f), red_f, red_i);
    bool done = cur >= k;
    int i = 0;
    while (!done && i < max_steps) {
      if (i % refresh == refresh - 1) {
        s_ray[7 * b + tid] = cap_t();
        __syncthreads();
        frontier_update(bent, boxes, k, s_ray, b, false);
      }
      if (tid == 0) bent[cur] = kInf;  // retire the current cluster
      __syncthreads();
      // the next pick uses the bound from BEFORE this cluster's test
      const int nxt = pick_cluster(bent, k, block_max(bound_t(), red_f), red_f, red_i);

      // stage the current cluster's plane rows 0-9 (contiguous) in smem
      const float* src = planes + static_cast<long long>(cur) * kPlaneRows * c;
      if ((c & 3) == 0) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
        float4* dst4 = reinterpret_cast<float4*>(s_plane);
        for (int q = tid; q < kMtRows * c / 4; q += b) dst4[q] = src4[q];
      } else {
        for (int q = tid; q < kMtRows * c; q += b) s_plane[q] = src[q];
      }
      __syncthreads();

      if (searching()) {
        float tc = kInf, tu = 0.0f, tv = 0.0f;
        int wcol = 0;
        for (int s = 0; s < c; ++s) {
          float t, u, v, det;
          const bool ok = mt_components(
              ox, oy, oz, dx, dy, dz,
              s_plane[s], s_plane[c + s], s_plane[2 * c + s],
              s_plane[3 * c + s], s_plane[4 * c + s], s_plane[5 * c + s],
              s_plane[6 * c + s], s_plane[7 * c + s], s_plane[8 * c + s],
              kTMin, best_t, t, u, v, det) && s_plane[9 * c + s] >= 0.0f;
          if (kMode == kAnyHit) {
            if (ok) { hit = true; break; }
          } else if (ok && t < tc) {
            tc = t; tu = u; tv = v; wcol = s;
          }
        }
        if (kMode != kAnyHit && tc < best_t) {
          best_t = tc; best_u = tu; best_v = tv;
          hit = true; wcid = cur; wslot = wcol;
        }
        // a shadow lane with a hit is done: t -> t_min
        if (kMode == kMixed && shadow && hit) best_t = kTMin;
      }
      ++steps;
      ++i;
      cur = nxt;
      done = nxt >= k;
      __syncthreads();  // s_plane is restaged next iteration
    }
    if (!done) {
      // max_steps overflow: a candidate nearer than the block's prune bound
      // taints the whole block
      float near_j = kInf;
      for (int j = tid; j < k; j += b) near_j = fminf(near_j, bent[j]);
      const float nearest = block_min(near_j, red_f);
      resolved = !(nearest < block_max(bound_t(), red_f));
    }
  }

  float* o = out + ray * kOutCols;
  float tri = -1.0f;
  float t_out = best_t, u_out = best_u, v_out = best_v;
  if (kMode != kAnyHit && hit) {
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
}

template <int kMode>
int launch(const float* rays, const float* boxes, const float* planes, const float* attrs,
           float* out, long long n, int k, int c, int block, int max_steps, int refresh,
           void* stream) {
  if (n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || k <= 0 ||
      c <= 0 || refresh <= 0 || n / block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>((k + 3) & ~3) + static_cast<size_t>(kMtRows) * c +
                       8 * static_cast<size_t>(block) + 64) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused2_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused2_kernel<kMode><<<static_cast<unsigned>(n / block), block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rays, boxes, planes, attrs, out, k, c, max_steps, refresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define OWLPT_FUSED2_ENTRY(name, mode)                                                     \
  extern "C" int name(const float* rays, const float* boxes, const float* planes,          \
                      const float* attrs, float* out, long long n, int k, int c, int block, \
                      int max_steps, int refresh, void* stream) {                           \
    return launch<mode>(rays, boxes, planes, attrs, out, n, k, c, block, max_steps,        \
                        refresh, stream);                                                   \
  }

OWLPT_FUSED2_ENTRY(owlpt_fused2_closest_hit, kClosest)
OWLPT_FUSED2_ENTRY(owlpt_fused2_occluded, kAnyHit)
OWLPT_FUSED2_ENTRY(owlpt_fused2_sweep_mixed, kMixed)
