// Tensor-core feature products of the MXU plane layout, for Hopper (sm_90a).
//
// What the fused2 traversal (fused2_traverse.cu, K1b and K4 on MXU planes)
// and the retirement-loop latency probe (latency_probe.cu, K6) share: the
// cp.async staging of a cluster's plane rows into a shared-memory ring
// buffer, and TensorOps, a warp's products of its 32 rays' features with the
// staged rows on the tensor cores (mma.sync with fp32 accumulators):
//
//   bf16 planes: the raw plane rows 0-9 (k 10-15 read one shared zero row),
//     the ten bf16 ray features at k 0-9, one mma.sync.m16n8k16 per column
//     group, B from ldmatrix.x4.trans; every product is exact in the fp32
//     accumulator.
//   f32 planes (3xTF32): the 19 non-zero feature rows (mxu_source), each
//     operand split into two TF32 terms, hi = tf32(x) and lo = tf32(x - hi);
//     each column group sums lo*hi, hi*lo, hi*hi with one mma.sync.m16n8k8
//     each (12 per n-tile and m-tile).  The dropped lo*lo term and the
//     remainders of the splits are below 3 x 2^-22 of each product.
//
// The MXU layout (ops/fused2.py _mxu_features): planes [K,16,4C], column
// groups det | u*det | v*det | t*det of C slots each; the ray features
// [d, o x d, o, 1, 0 x 6] times a cluster's feature matrix give the four
// sums per slot.  Only rows 0-2 of det, 0-5 of u*det and v*det and 6-9 of
// t*det are non-zero; row 10 of group 0 holds the tri id (feature 0).
//
// A staged buffer holds W slots of each column group: a whole cluster (W =
// C, the traversal) or a column tile [t0, t0 + W) of it (the probe, where P
// whole clusters do not fit); TensorOps::init(f, W) addresses it, and a test
// runs tensor_cols(W) / 8 n-tiles.  Included by both kernel sources; each
// compiles its own copy (internal linkage).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPlaneRows = 16;  // rows per cluster in planes
// MXU rows staged per cluster: the 19 non-zero feature rows (det 3, u*det 6,
// v*det 6, t*det 4), in mxu_source's order
constexpr int kMxuRows = 19;
// tensor path, bf16: plane rows 0-9 meet non-zero ray features (k 10-15 read a zero row)
constexpr int kLiveRows = 10;

enum Layout { kComponent = 0, kMxuF32 = 1, kMxuBf16 = 2 };

// Plane row and column group of MXU staging row q < kMxuRows.
__device__ __forceinline__ void mxu_source(int q, int& row, int& group) {
  if (q < 3) { row = q; group = 0; }
  else if (q < 9) { row = q - 3; group = 1; }
  else if (q < 15) { row = q - 9; group = 2; }
  else { row = q - 9; group = 3; }  // rows 6-9
}

// Slots per column group in a staged row: W rounded up to whole 8-slot
// n-tiles (the pad slots are zero: det = 0 fails the window).
__host__ __device__ constexpr int tensor_cols(int w) { return (w + 7) & ~7; }
// bf16: bytes per staged row: four column groups, then 16 bytes of pad.
__host__ __device__ constexpr int tensor_row_bytes(int w) { return 8 * tensor_cols(w) + 16; }
// f32: floats per staged row, W rounded up to whole n-tiles and then padded
// so that rows lie 8 banks apart (stride = 8 mod 32 words): the B fragment
// loads of a warp (rows q, columns g of an n-tile) hit 32 banks.
__host__ __device__ constexpr int f32_row_words(int w) { return tensor_cols(w) + ((8 - tensor_cols(w)) & 31); }

// Bytes of one staged buffer of W slots: bf16 [10][tensor_row_bytes(W)]
// bytes, f32 [19][f32_row_words(W)] floats (both multiples of 16).
template <int kLayout>
__host__ __device__ constexpr int tensor_buffer_bytes(int w) {
  return kLayout == kMxuBf16 ? kLiveRows * tensor_row_bytes(w) : kMxuRows * f32_row_words(w) * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory"); }

// Stage plane rows 0-9, columns [t0, t0 + w) of each group, of cluster cid
// (bf16 [16, 4C]) into one buffer ([10][tensor_row_bytes(w)] bytes): 16-byte
// cp.async when every group's run starts on a 16-byte boundary and w is
// whole n-tiles (C, t0 and w multiples of 8), else element by element with
// the pad slots zeroed.  The whole cluster (the traversal's case) copies
// each row as one run of 4C, with no division per chunk.
__device__ void stage_bf16(unsigned char* dst, const unsigned short* __restrict__ planes, int cid, int c, int t0,
                           int w) {
  const unsigned short* src = planes + static_cast<long long>(cid) * kPlaneRows * 4 * c + t0;
  const int rs = tensor_row_bytes(w);
  if ((c & 7) == 0 && t0 == 0 && w == c) {
    const int chunks = c / 2;  // 16-byte chunks per row of 4C
    for (int q = threadIdx.x; q < kLiveRows * chunks; q += blockDim.x) {
      const int row = q / chunks, ch = q - row * chunks;
      cp_async16(dst + row * rs + ch * 16, src + row * 4 * c + ch * 8);
    }
  } else if ((c & 7) == 0 && (t0 & 7) == 0 && (w & 7) == 0) {
    const int per = w / 8, chunks = 4 * per;  // 16-byte chunks per group and per staged row
    for (int q = threadIdx.x; q < kLiveRows * chunks; q += blockDim.x) {
      const int row = q / chunks, ch = q - row * chunks, g = ch / per;
      cp_async16(dst + row * rs + ch * 16, src + row * 4 * c + g * c + (ch - g * per) * 8);
    }
  } else {
    const int cp = tensor_cols(w);
    for (int q = threadIdx.x; q < kLiveRows * 4 * cp; q += blockDim.x) {
      const int row = q / (4 * cp), col = q - row * 4 * cp;
      const int g = col / cp, slot = col - g * cp;
      reinterpret_cast<unsigned short*>(dst + row * rs)[col] = slot < w ? src[row * 4 * c + g * c + slot] : 0;
    }
  }
}

// Stage the 19 non-zero feature rows (staging order of mxu_source), columns
// [t0, t0 + w), of cluster cid (f32 [16, 4C]) into one buffer
// ([19][f32_row_words(w)] floats): each row is a contiguous run of w floats
// in the planes, copied with 16-byte cp.async when C and t0 are multiples of
// 4 and w of 8, else element by element with the pad slots zeroed.
__device__ void stage_f32(unsigned char* dst, const float* __restrict__ planes, int cid, int c, int t0, int w) {
  const float* src = planes + static_cast<long long>(cid) * kPlaneRows * 4 * c + t0;
  float* d = reinterpret_cast<float*>(dst);
  const int rw = f32_row_words(w);
  if ((c & 3) == 0 && (t0 & 3) == 0 && (w & 7) == 0) {
    const int chunks = w / 4;  // 16-byte chunks per row
    for (int q = threadIdx.x; q < kMxuRows * chunks; q += blockDim.x) {
      const int srow = q / chunks, ch = q - srow * chunks;
      int row, group;
      mxu_source(srow, row, group);
      cp_async16(d + srow * rw + ch * 4, src + row * 4 * c + group * c + ch * 4);
    }
  } else {
    const int cp = tensor_cols(w);
    for (int q = threadIdx.x; q < kMxuRows * cp; q += blockDim.x) {
      const int srow = q / cp, slot = q - srow * cp;
      int row, group;
      mxu_source(srow, row, group);
      d[srow * rw + slot] = slot < w ? src[row * 4 * c + group * c + slot] : 0.0f;
    }
  }
}

template <int kLayout>
__device__ __forceinline__ void stage_cluster(unsigned char* dst, const void* planes, int cid, int c, int t0,
                                              int w) {
  if constexpr (kLayout == kMxuBf16) stage_bf16(dst, static_cast<const unsigned short*>(planes), cid, c, t0, w);
  else stage_f32(dst, static_cast<const float*>(planes), cid, c, t0, w);
}

// x rounded to TF32 (nearest, ties away), as fp32 bits with the low 13 bits zero.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (a remainder below 2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in fp32).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d = A B + c: m16n8k8, tf32 operands, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                                  unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// d = A B with a zero accumulator: m16n8k16, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// Two bf16 values (already bf16-exact floats) in one register, lo in bits 0-15.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// A lane's operands of the tensor-core test: the A fragments of its warp's
// two 16-ray m-tiles (rays 16 mt .. 16 mt + 15, the warp's lanes; built once
// per launch from the rays' own features by shuffles), how it addresses its
// B fragments in a staged buffer of W slots, and per 8-slot n-tile the four
// column-group products (det, u*det, v*det, t*det; accumulator e of lane
// (g, q) = 4 g + q: ray row g + 8 (e >> 1), slot 2 q + (e & 1) of the
// n-tile).
template <int kLayout>
struct TensorOps;

// bf16 planes: per n-tile one mma.sync.m16n8k16 per column group, the ten
// bf16 features at k 0-9 (k 10-15 zero), B from ldmatrix.x4.trans.
template <>
struct TensorOps<kMxuBf16> {
  unsigned a[2][4];
  unsigned addr_a, addr_b, step;  // ldmatrix byte offsets in a buffer; advance per n-tile
  struct B {
    unsigned d0, d1, u0, u1, v0, v1, t0, t1;
  };

  __device__ __forceinline__ void init(const float (&f)[10], int w) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    unsigned words[5];
#pragma unroll
    for (int p = 0; p < 5; ++p) words[p] = pack_bf16(f[2 * p], f[2 * p + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mt][r] = 0u;
#pragma unroll
      for (int p = 0; p < 5; ++p) {  // features two per register, rays in their own lanes
        const unsigned lo = __shfl_sync(0xffffffffu, words[p], 16 * mt + g);
        const unsigned hi = __shfl_sync(0xffffffffu, words[p], 16 * mt + g + 8);
        if (p == q) { a[mt][0] = lo; a[mt][1] = hi; }
        if (p == q + 4) { a[mt][2] = lo; a[mt][3] = hi; }
      }
    }
    // ldmatrix.x4: lanes 8m .. 8m + 7 address matrix m = rows k = 8 (m & 1)
    // + (lane & 7) of column group (m >> 1) (first load: det, u*det; second:
    // v*det, t*det); rows k >= 10 read the zero row at every n-tile
    const int kk = 8 * ((lane >> 3) & 1) + (lane & 7), grp_hi = lane >> 4;
    addr_a = addr_b = step = 0;
    if (kk < kLiveRows) {
      addr_a = static_cast<unsigned>(kk * tensor_row_bytes(w) + grp_hi * tensor_cols(w) * 2);
      addr_b = addr_a + static_cast<unsigned>(2 * tensor_cols(w) * 2);
      step = 16;
    }
  }

  __device__ __forceinline__ B load(const unsigned char* buf, const unsigned char* zero_row, int j) const {
    const unsigned base = step ? smem_addr(buf) : smem_addr(zero_row);
    B b;
    ldmatrix_x4_trans(base + addr_a + j * step, b.d0, b.d1, b.u0, b.u1);
    ldmatrix_x4_trans(base + addr_b + j * step, b.v0, b.v1, b.t0, b.t1);
    return b;
  }

  __device__ __forceinline__ void sums(int mt, const B& b, float (&det)[4], float (&ua)[4], float (&vb)[4],
                                       float (&tcd)[4]) const {
    mma_bf16(det, a[mt], b.d0, b.d1);
    mma_bf16(ua, a[mt], b.u0, b.u1);
    mma_bf16(vb, a[mt], b.v0, b.v1);
    mma_bf16(tcd, a[mt], b.t0, b.t1);
  }
};

// f32 planes: 3xTF32.  Each operand x = hi + lo (split_tf32), and each
// column group sums lo*hi, then hi*lo, then hi*hi (the small terms first)
// in the fp32 accumulator, one mma.sync.m16n8k8 each: 12 per n-tile and
// m-tile.  Each group fits one k-step: det, u*det and v*det take the
// features d, m at k 0-5 (A1), t*det takes o, 1 at k 0-3 (A2); the staged
// rows of each group sit at those k, and B is zero at every other k.
template <>
struct TensorOps<kMxuF32> {
  unsigned a1h[2][4], a1l[2][4], a2h[2][2], a2l[2][2];
  int rw;                                 // floats per staged row
  int r_det, r_u0, r_u1, r_v0, r_v1, r_t;  // staged rows of B(k = q) and B(k = q + 4); -1: zero
  struct B {
    unsigned dh, dl, uh0, ul0, uh1, ul1, vh0, vl0, vh1, vl1, th, tl;
  };

  __device__ __forceinline__ void init(const float (&f)[10], int w) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    unsigned h[10], l[10];
#pragma unroll
    for (int p = 0; p < 10; ++p) split_tf32(f[p], h[p], l[p]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a1h[mt][r] = a1l[mt][r] = 0u;
#pragma unroll
      for (int p = 0; p < 10; ++p) {  // A1: features 0-5 at k 0-5; A2: features 6-9 at k 0-3
        const unsigned xh = __shfl_sync(0xffffffffu, h[p], 16 * mt + g);
        const unsigned yh = __shfl_sync(0xffffffffu, h[p], 16 * mt + g + 8);
        const unsigned xl = __shfl_sync(0xffffffffu, l[p], 16 * mt + g);
        const unsigned yl = __shfl_sync(0xffffffffu, l[p], 16 * mt + g + 8);
        if (p == q) { a1h[mt][0] = xh; a1h[mt][1] = yh; a1l[mt][0] = xl; a1l[mt][1] = yl; }
        if (p < 6 && p == q + 4) { a1h[mt][2] = xh; a1h[mt][3] = yh; a1l[mt][2] = xl; a1l[mt][3] = yl; }
        if (p == q + 6) { a2h[mt][0] = xh; a2h[mt][1] = yh; a2l[mt][0] = xl; a2l[mt][1] = yl; }
      }
    }
    // staging rows (mxu_source): det 0-2, u*det 3-8, v*det 9-14, t*det 15-18
    rw = f32_row_words(w);
    r_det = q < 3 ? q : -1;
    r_u0 = 3 + q;
    r_u1 = q < 2 ? 7 + q : -1;
    r_v0 = 9 + q;
    r_v1 = q < 2 ? 13 + q : -1;
    r_t = 15 + q;
  }

  __device__ __forceinline__ B load(const unsigned char* buf, const unsigned char*, int j) const {
    const float* p = reinterpret_cast<const float*>(buf) + 8 * j + ((threadIdx.x & 31) >> 2);
    B b;
    split_tf32(r_det >= 0 ? p[r_det * rw] : 0.0f, b.dh, b.dl);
    split_tf32(p[r_u0 * rw], b.uh0, b.ul0);
    split_tf32(r_u1 >= 0 ? p[r_u1 * rw] : 0.0f, b.uh1, b.ul1);
    split_tf32(p[r_v0 * rw], b.vh0, b.vl0);
    split_tf32(r_v1 >= 0 ? p[r_v1 * rw] : 0.0f, b.vh1, b.vl1);
    split_tf32(p[r_t * rw], b.th, b.tl);
    return b;
  }

  // one column group of A1 (k 0-7) or A2 (k 0-3): lo*hi + hi*lo + hi*hi
  __device__ __forceinline__ static void group(float (&d)[4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                               unsigned bh0, unsigned bl0, unsigned bh1, unsigned bl1) {
    const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1, zero);
    mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1, d);
    mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1, d);
  }

  __device__ __forceinline__ void sums(int mt, const B& b, float (&det)[4], float (&ua)[4], float (&vb)[4],
                                       float (&tcd)[4]) const {
    group(det, a1h[mt], a1l[mt], b.dh, b.dl, 0u, 0u);
    group(ua, a1h[mt], a1l[mt], b.uh0, b.ul0, b.uh1, b.ul1);
    group(vb, a1h[mt], a1l[mt], b.vh0, b.vl0, b.vh1, b.vl1);
    const unsigned a2h4[4] = {a2h[mt][0], a2h[mt][1], 0u, 0u};
    const unsigned a2l4[4] = {a2l[mt][0], a2l[mt][1], 0u, 0u};
    group(tcd, a2h4, a2l4, b.th, b.tl, 0u, 0u);
  }
};

}  // namespace
