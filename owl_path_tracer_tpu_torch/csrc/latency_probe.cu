// Retirement-loop latency probe, for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/tpu_probe6.py:mini_kernel (launched by
// run_variant(...).tv): the skeleton of the fused2 retirement loop with its
// stages switched on or off, so that a launch's time over the loop's trip
// count splits one iteration into pick, copy, product and loop control.
// rays [N,8] (o, d, tmax, 0), boxes [8,K], planes [K,16,4C] float32 or
// bfloat16 (the MXU feature layout) -> out [N/B,B,16] (best t, zeros).
//
// One CUDA block per `block` consecutive rays, one thread per ray.
//   phase A  thread j takes clusters j, j+B, ...: for each it slab-tests
//            the box against every ray of the block (the reference's
//            ia*bmin - o*ia order, NaN-propagating min/max) and keeps the
//            minimum entry over the rays that need the cluster; every
//            chain's row [K] in shared memory starts as that front.
//   loop     `trips` iterations of the P chains (P = `chains`):
//     pick     block-wide minimum of the chain's row, lowest id among equal
//              entries (warp shuffles, then one slot per warp, two
//              barriers), then the cluster is retired (set to inf); an
//              all-inf row keeps picking cluster 0, as the reference does.
//              Without pick the cluster is (i*P + p) % K.
//     copy     the cluster's plane rows into the chain's shared-memory
//              buffer with 16-byte cp.async.cg, then cp.async.wait_group +
//              __syncthreads (the counterpart of make_async_copy(...).start();
//              .wait()).  All P chains' first tiles are issued together after
//              the picks, so chain p waits only for its own group.
//     product  each ray's features times the 4C columns, then the MXU
//              layout's window (det sign flips, t in (t_min, best t)) and the
//              best-t update on CUDA cores; `recip` takes rcp.approx.ftz for
//              the reference's pl.reciprocal(approx=True), else IEEE division.
//   Chain p's window uses the best t left by chain p-1, as the reference.
//   Without any stage the loop runs an empty volatile body: its slope is
//   the loop-control floor.
//
// Two forms of the copy and product stages, one entry each:
//   tensor (owlpt_latency_probe, the form tools/latency_probe.py times):
//     the stages K1b's tensor-core form runs (fused2_traverse.cu, through
//     tensor_ops.cuh): the copy stages what K1b stages, plane rows 0-9 of
//     4C bf16 or the 19 non-zero f32 feature rows, into the chain's buffer
//     (stage_cluster), and the product is TensorOps' mma.sync on the
//     tensor cores (bf16 products; f32 planes as 3xTF32), each warp's 32
//     rays two 16-ray m-tiles, the window on the accumulator registers and
//     a quad minimum.  Variants without a product stage run the CUDA-core
//     form's kernel (the forms differ only where the product is on).
//   exact (owlpt_latency_probe_exact, latency_probe(..., exact=True)): the
//     whole [16, 4C] cluster copied, and each thread multiplies its ray's 16
//     features into the 4C columns on CUDA cores, summing the 16 products in
//     ascending row order without FMA (built with --fmad=false): the plain
//     version's arithmetic bit for bit, the yardstick of the tensor form.
// The tensor cores sum in their own order and rounding, so the tensor
// form's best t may differ from the plain version's by the sums' rounding
// bound (chip_smoke.py compare_probe_tensor holds it there).
//
// Design.  The exact form's whole cluster is 16 x 4C x 4 B = 128 KB of
// float32 at C = 512 (64 KB bf16), the tensor form's staging about 40 KB,
// against 227 KB of shared memory per block on an H100; the TPU's VMEM had
// room for P of them.  The buffers hold column tiles of `tile` slots of
// each column group (chosen by the wrapper so that P buffers fit:
// ops/latency_probe.py tile_cols, shared_bytes below): a chain copies and
// tests tile after tile, the whole cluster every iteration, keeping the
// window at the best t it started with and the minimum over its slots, so
// the tiling changes no result.  The exact form's products read four
// consecutive slots per 16-byte shared load.
//
// Bound, per block and iteration of a chain: the product's FLOP per ray and
// slot (exact form: 2 x 10 live features x 4 groups at the fp32 CUDA-core
// peak, 67 TFLOP/s; feature rows 10-15 are zeros, multiplied all the same,
// as the reference's [B,16] product does; tensor form: 2 x 16 x 4 at the
// bf16 tensor rate, or three TF32 products each at the TF32 rate), the
// 28-operation window chain per slot at the fp32 peak, and the copy's
// bytes (from HBM or L2).  On CUDA cores the product bounds it; on the
// tensor cores the window does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <array>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "tensor_ops.cuh"

namespace {

constexpr int kRows = 16;     // feature rows
constexpr int kGroups = 4;    // column groups: det | u*det | v*det | t*det
constexpr int kCols = 8;      // ray columns
constexpr int kOutCols = 16;  // output columns
constexpr int kMaxChains = 16;
constexpr float kTMin = 1e-3f;
constexpr float kInf = INFINITY;

__device__ __forceinline__ float inv_dir(float dc) {
  const float safe = fabsf(dc) < 1e-12f ? (dc < 0.0f ? -1e-12f : 1e-12f) : dc;
  return 1.0f / safe;
}

// jnp.maximum / jnp.minimum: a NaN operand gives NaN
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

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// wait until at most n of this thread's most recent groups are pending
// (wait_group takes an immediate; above 7, wait for all)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Floats before the plane buffers: the chains' rows [P,K], the block's rays
// [10,B] (o, 1/d, o/d per axis, tmax), 32 reduction values and 32 ids;
// padded to 16 bytes.
__host__ __device__ size_t head_floats(int k, int chains, int b) {
  return (static_cast<size_t>(chains) * k + 10 * static_cast<size_t>(b) + 64 + 3) & ~static_cast<size_t>(3);
}
// Bytes of one chain's buffer of `tile` slots per column group: the exact
// form's [16][4][tile] plane elements, the tensor form's staging
// (tensor_buffer_bytes: bf16 [10][8 tile + 16] bytes, f32 [19][row words]).
__host__ __device__ size_t buffer_bytes(int tile, int elem_bytes, bool tensor) {
  if (tensor) return elem_bytes == 2 ? tensor_buffer_bytes<kMxuBf16>(tile) : tensor_buffer_bytes<kMxuF32>(tile);
  return static_cast<size_t>(kRows) * kGroups * tile * elem_bytes;
}
// The head, P buffers and, in the tensor form, a 16-byte zero row (bf16
// ldmatrix reads k 10-15 from it).
size_t shared_bytes(int k, int chains, int b, int tile, int elem_bytes, bool tensor) {
  return 4 * head_floats(k, chains, b) + chains * buffer_bytes(tile, elem_bytes, tensor) + (tensor ? 16 : 0);
}

// Block-wide (value, id) minimum of row[0:k], lowest id among equal values;
// retires it (row[id] = inf) and returns it to every thread.
__device__ int block_pick(float* row, int k, float* red_v, int* red_i) {
  const int b = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = b >> 5;
  float v = kInf;
  int id = k;
  for (int j = tid; j < k; j += b) {
    const float x = row[j];
    if (x < v || (x == v && j < id)) { v = x; id = j; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    if (ov < v || (ov == v && oi < id)) { v = ov; id = oi; }
  }
  if (lane == 0) { red_v[warp] = v; red_i[warp] = id; }
  __syncthreads();
  v = red_v[0];
  id = red_i[0];
  for (int w = 1; w < nw; ++w) {
    if (red_v[w] < v || (red_v[w] == v && red_i[w] < id)) { v = red_v[w]; id = red_i[w]; }
  }
  if (id >= k) id = 0;  // only an all-NaN row, which phase A never makes
  __syncthreads();  // every thread has read red_* and row[id] before the retire
  if (tid == 0) row[id] = kInf;
  __syncthreads();
  return id;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);  // bf16 -> f32 widens exactly
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Copy columns [t0, t0+tile) of each of the 16 x 4 row groups of cluster
// `cid` into buf [16][4][tile]; 16-byte pieces, spread over the block.
template <typename T>
__device__ __forceinline__ void issue_tile(T* buf, const T* planes, int cid, int c, int t0, int tile) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte piece
  const int pieces = tile / kPer;       // per row group
  const int total = kRows * kGroups * pieces;
  const T* src = planes + static_cast<size_t>(cid) * kRows * kGroups * c;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    const int seg = q / pieces, off = (q - seg * pieces) * kPer;  // seg = row * 4 + group
    const int row = seg >> 2, grp = seg & 3;
    cp_async16(buf + static_cast<size_t>(seg) * tile + off,
               src + static_cast<size_t>(row) * kGroups * c + static_cast<size_t>(grp) * c + t0 + off);
  }
  cp_async_commit();
}

// One tile of one chain: the 16-row feature product of every slot, the
// window at best_in, the minimum t over the tile's slots.
template <typename T, bool RECIP>
__device__ __forceinline__ float test_tile(const float (&f)[kRows], const T* buf, int tile, float best_in) {
  float tc = kInf;
  for (int s = 0; s < tile; s += 4) {
    float acc[kGroups][4];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float v[4];
      load4<T>(buf + static_cast<size_t>(g) * tile + s, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = f[0] * v[j];
    }
#pragma unroll
    for (int r = 1; r < kRows; ++r) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float v[4];
        load4<T>(buf + static_cast<size_t>(r * kGroups + g) * tile + s, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] = acc[g][j] + f[r] * v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float det = acc[0][j];
      const float sgn = det < 0.0f ? -1.0f : 1.0f;
      const float dd = det * sgn, ua = acc[1][j] * sgn, vb = acc[2][j] * sgn, tcd = acc[3][j] * sgn;
      const bool ok = dd >= 1e-12f && ua >= 0.0f && vb >= 0.0f && ua + vb <= dd && tcd > dd * kTMin &&
                      tcd < dd * best_in;
      const float dd_safe = dd < 1e-12f ? 1.0f : dd;
      if (ok) tc = fminf(tc, RECIP ? tcd * rcp_approx(dd_safe) : tcd / dd_safe);
    }
  }
  return tc;
}

// One tile of one chain on the tensor cores (the tensor form): the warp's
// feature products with the staged tile (TensorOps), the window at each
// ray's best_in on the accumulator registers, and the minimum t over the
// tile's slots, reduced over the quad -> this lane's own ray's minimum.
template <int kLayout, bool RECIP>
__device__ __forceinline__ float tensor_tile(const TensorOps<kLayout>& ops, const unsigned char* buf,
                                             const unsigned char* zero_row, int tile, float best_in) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  float bt[2][2], lt[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bt[mt][h] = __shfl_sync(0xffffffffu, best_in, 16 * mt + 8 * h + g);
      lt[mt][h] = kInf;
    }
  }
  for (int j = 0; j < tensor_cols(tile) / 8; ++j) {
    const auto bf = ops.load(buf, zero_row, j);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float det[4], ua[4], vb[4], tcd[4];
      ops.sums(mt, bf, det, ua, vb, tcd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // accumulator e: ray row g + 8 (e >> 1) of the m-tile
        const int h = e >> 1;
        const float sgn = det[e] < 0.0f ? -1.0f : 1.0f;
        const float dd = det[e] * sgn, u = ua[e] * sgn, v = vb[e] * sgn, tc = tcd[e] * sgn;
        const bool ok = dd >= 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= dd && tc > dd * kTMin &&
                        tc < dd * bt[mt][h];
        const float dd_safe = dd < 1e-12f ? 1.0f : dd;
        if (ok) lt[mt][h] = fminf(lt[mt][h], RECIP ? tc * rcp_approx(dd_safe) : tc / dd_safe);
      }
    }
  }
  // the quad's minimum, then this lane's ray from the quad that holds it (lanes 4 g' .. 4 g' + 3)
  const int src = 4 * (lane & 7), my_mt = lane >> 4, my_h = (lane >> 3) & 1;
  float mine = kInf;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = lt[mt][h];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float o = __shfl_sync(0xffffffffu, v, src);
      if (mt == my_mt && h == my_h) mine = o;
    }
  }
  return mine;
}

// Issue one chain's copy of columns [t0, t0 + tile) of cluster cid: the
// exact form's [16][4][tile] elements, the tensor form's staging; one
// cp.async group.
template <typename T, bool TENSOR>
__device__ __forceinline__ void issue(unsigned char* buf, const T* planes, int cid, int c, int t0, int tile) {
  if constexpr (TENSOR) {
    stage_cluster<sizeof(T) == 2 ? kMxuBf16 : kMxuF32>(buf, planes, cid, c, t0, tile);
    cp_async_commit();
  } else {
    issue_tile<T>(reinterpret_cast<T*>(buf), planes, cid, c, t0, tile);
  }
}

template <bool PICK, bool COPY, bool MM, bool BF16, bool RECIP, bool TENSOR>
__global__ void probe_kernel(const float* __restrict__ rays, const float* __restrict__ boxes,
                             const void* __restrict__ planes_raw, float* __restrict__ out, int k, int c,
                             int trips, int chains, int tile) {
  static_assert(!TENSOR || MM, "the tensor form differs from the exact one only in the product stage");
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int kLayout = BF16 ? kMxuBf16 : kMxuF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockDim.x, tid = threadIdx.x;
  float* s_bent = reinterpret_cast<float*>(smem);  // [chains, k]
  float* s_ray = s_bent + chains * k;              // [10, b]
  float* red_v = s_ray + 10 * b;                   // [32]
  int* red_i = reinterpret_cast<int*>(red_v + 32);  // [32]
  // the chains' buffers (exact: [16][4][tile] elements; tensor: the staging), then the tensor form's zero row
  unsigned char* s_buf = smem + 4 * head_floats(k, chains, b);
  const size_t buf_bytes = buffer_bytes(tile, sizeof(T), TENSOR);
  unsigned char* zero_row = s_buf + chains * buf_bytes;
  const T* planes = static_cast<const T*>(planes_raw);

  const long long row = static_cast<long long>(blockIdx.x) * b + tid;
  const float* rr = rays + row * kCols;
  const float ox = rr[0], oy = rr[1], oz = rr[2], dx = rr[3], dy = rr[4], dz = rr[5], tmx = rr[6];
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ia = inv_dir(d[a]);
    s_ray[a * b + tid] = o[a];
    s_ray[(3 + a) * b + tid] = ia;
    s_ray[(6 + a) * b + tid] = o[a] * ia;
  }
  s_ray[9 * b + tid] = tmx;
  // ray features d, m = o x d, o, 1, 0 x 6
  float f[kRows] = {dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, ox, oy, oz, 1.0f,
                    0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (BF16) {
#pragma unroll
    for (int r = 0; r < 10; ++r) f[r] = __bfloat162float(__float2bfloat16_rn(f[r]));
  }
  // tensor form: this lane's A fragments (its warp's rays) and B addressing in a buffer of `tile` slots
  TensorOps<kLayout> ops;
  if constexpr (TENSOR) {
    const float f10[10] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
    ops.init(f10, tile);
    if (tid < 4) reinterpret_cast<unsigned*>(zero_row)[tid] = 0u;
  }
  if (MM && !COPY) {  // the buffers nothing fills read as zeros
    unsigned* words = reinterpret_cast<unsigned*>(s_buf);
    for (size_t q = tid; q < chains * buf_bytes / 4; q += b) words[q] = 0u;
  }
  __syncthreads();

  // phase A: the block's front row, into every chain's row (every variant
  // runs it, as the reference does; only the picks read it)
  {
    for (int kk = tid; kk < k; kk += b) {
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) { lo[a] = boxes[a * k + kk]; hi[a] = boxes[(3 + a) * k + kk]; }
      float front = kInf;
      for (int r = 0; r < b; ++r) {
        float tn = -kInf, tf = kInf;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float ia = s_ray[(3 + a) * b + r], oi = s_ray[(6 + a) * b + r];
          const float t0 = ia * lo[a] - oi, t1 = ia * hi[a] - oi;
          tn = max_nan(tn, min_nan(t0, t1));
          tf = min_nan(tf, max_nan(t0, t1));
        }
        const float te = max_nan(tn, kTMin);
        if (te <= min_nan(tf, s_ray[9 * b + r])) front = fminf(front, te);  // false for a NaN entry
      }
      for (int p = 0; p < chains; ++p) s_bent[p * k + kk] = front;
    }
    __syncthreads();
  }

  float best = tmx;
  if (!PICK && !COPY && !MM) {
    for (int i = 0; i < trips; ++i) asm volatile("");  // the loop-control floor
  } else {
    for (int i = 0; i < trips; ++i) {
      if (COPY) __syncthreads();  // the last iteration's reads of the buffers are done
      int cid[kMaxChains];
      for (int p = 0; p < chains; ++p) {
        cid[p] = PICK ? block_pick(s_bent + p * k, k, red_v, red_i)
                      : static_cast<int>((static_cast<long long>(i) * chains + p) % k);
      }
      if (COPY) {
        for (int p = 0; p < chains; ++p) issue<T, TENSOR>(s_buf + p * buf_bytes, planes, cid[p], c, 0, tile);
      }
      for (int p = 0; p < chains; ++p) {
        const float best_in = best;
        float tc = kInf;
        unsigned char* buf = s_buf + p * buf_bytes;
        for (int t0 = 0; t0 < c; t0 += tile) {
          if (COPY) {
            if (t0 == 0) {
              cp_async_wait_pending(chains - 1 - p);  // groups of the later chains may still be in flight
            } else {
              __syncthreads();  // the previous tile is read
              issue<T, TENSOR>(buf, planes, cid[p], c, t0, tile);
              cp_async_wait<0>();
            }
            __syncthreads();
          }
          if constexpr (TENSOR) tc = fminf(tc, tensor_tile<kLayout, RECIP>(ops, buf, zero_row, tile, best_in));
          else if (MM) tc = fminf(tc, test_tile<T, RECIP>(f, reinterpret_cast<const T*>(buf), tile, best_in));
        }
        if (MM && tc < best) best = tc;
      }
    }
  }

  float* o_row = out + row * kOutCols;
  o_row[0] = best;
#pragma unroll
  for (int j = 1; j < kOutCols; ++j) o_row[j] = 0.0f;
}

struct Args {
  const float* rays;
  const float* boxes;
  const void* planes;
  float* out;
  unsigned grid;
  int block, k, c, trips, chains, tile;
  size_t smem;
  cudaStream_t stream;
};

template <int F, bool TENSOR>
cudaError_t launch(const Args& a) {
  auto kernel =
      probe_kernel<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0, (F & 8) != 0, (F & 16) != 0, TENSOR>;
  if (a.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(a.smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.grid, a.block, a.smem, a.stream>>>(a.rays, a.boxes, a.planes, a.out, a.k, a.c, a.trips, a.chains,
                                                a.tile);
  return cudaGetLastError();
}

// The tensor form's kernel of flags F: its own where the product stage is
// on (flags & 4), the CUDA-core one elsewhere (no product: the forms agree).
template <int F>
constexpr auto tensor_launcher() {
  if constexpr ((F & 4) != 0) return &launch<F, true>;
  else return &launch<F, false>;
}

using Launcher = cudaError_t (*)(const Args&);
template <int... F>
constexpr std::array<Launcher, sizeof...(F)> exact_launchers(std::integer_sequence<int, F...>) {
  return {&launch<F, false>...};
}
template <int... F>
constexpr std::array<Launcher, sizeof...(F)> tensor_launchers(std::integer_sequence<int, F...>) {
  return {tensor_launcher<F>()...};
}
constexpr auto kExactLaunchers = exact_launchers(std::make_integer_sequence<int, 32>{});
constexpr auto kTensorLaunchers = tensor_launchers(std::make_integer_sequence<int, 32>{});

int run(const float* rays, const float* boxes, const void* planes, float* out, long long n, int block, int k,
        int c, int trips, int chains, int tile, int flags, bool tensor, void* stream) {
  if (n <= 0 || block < 32 || block > 1024 || (block & 31) || n % block || n / block > 0x7fffffffLL || k <= 0 ||
      c <= 0 || c % 8 || tile <= 0 || tile % 8 || c % tile || trips < 0 || chains < 1 || chains > kMaxChains ||
      flags < 0 || flags > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool t = tensor && (flags & 4);
  Args a{rays, boxes, planes, out, static_cast<unsigned>(n / block), block, k, c, trips, chains, tile,
         shared_bytes(k, chains, block, tile, (flags & 8) ? 2 : 4, t), static_cast<cudaStream_t>(stream)};
  return static_cast<int>((t ? kTensorLaunchers : kExactLaunchers)[flags](a));
}

}  // namespace

// The device's opt-in shared memory per block, in bytes; -1 if it cannot be read.
extern "C" int owlpt_latency_probe_smem_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return limit;
}

// tensor: the tensor form's bytes (its staging and zero row).
extern "C" long long owlpt_latency_probe_shared_bytes(int k, int chains, int block, int tile, int elem_bytes,
                                                      int tensor) {
  return static_cast<long long>(shared_bytes(k, chains, block, tile, elem_bytes, tensor != 0));
}

// flags: 1 pick, 2 copy, 4 product, 8 bf16 planes, 16 approximate reciprocal.
// The tensor form (the product on the tensor cores, K1b's staging).
extern "C" int owlpt_latency_probe(const float* rays, const float* boxes, const void* planes, float* out,
                                   long long n, int block, int k, int c, int trips, int chains, int tile,
                                   int flags, void* stream) {
  return run(rays, boxes, planes, out, n, block, k, c, trips, chains, tile, flags, true, stream);
}

// The exact form: the plain version's CUDA-core arithmetic (the yardstick).
extern "C" int owlpt_latency_probe_exact(const float* rays, const float* boxes, const void* planes, float* out,
                                         long long n, int block, int k, int c, int trips, int chains, int tile,
                                         int flags, void* stream) {
  return run(rays, boxes, planes, out, n, block, k, c, trips, chains, tile, flags, false, stream);
}
