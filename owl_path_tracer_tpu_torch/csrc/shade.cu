// One shading bounce per lane, for Hopper (sm_90a): the plain bounce and the
// deferred next-event-estimation bounce, each in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves render/integrator.py
// trace_bounce's shading to XLA, which fuses it into a few loops.  Eager
// PyTorch ran the same bounce (render/integrator.py _shade_bounce, the plain
// version the card tests hold this kernel to) as about 970 elementwise
// launches over [N] and [N,3] tensors, and the host's dispatch of those
// launches took most of every frame.  shade_kernel runs the whole bounce in
// one launch, one thread per lane, in _shade_bounce's order:
//   1. a miss: the environment (the nearest texel of the lat-long map, the
//      auto sky or the constant colour) times the intensity times the
//      throughput goes into the result, and the lane ends;
//   2. the surface: from the fused2 attribute blob [N,16] (the hit position
//      o + t d) or from the shade blob [T,24] and tri_mat [T] at the winning
//      triangle (the barycentric position); the shading normal (+z where the
//      blob's interpolated normal is degenerate), the material row of the
//      [M,17] table and the optional nearest atlas texel;
//   3. an emissive hit: emission times throughput, and the lane ends;
//   4. the tangent frame and the local outgoing direction;
//   5. ops/disney.py sample, parity or corrected: ONLY the selected lobe is
//      evaluated (the eager version evaluates all four on every lane and
//      picks one; the picked values are the same), with its draw accounting
//      (3 draws; glass 4 transmit, 5 TIR, 6 Fresnel reflect), the forced BTDF
//      when exiting glass and the sheen added to the picked direction;
//   6. the pdf kill and the retry on a non-finite f;
//   7. the throughput update and the glass-exempt, uncompensated Russian
//      roulette.
// A lane that is not alive after the hit and emission tests copies its state
// through.  The LCG runs in uint32 and is written back as the int64 values
// the port carries.
//
// shade_nee_kernel is _shade_bounce_nee's deferred form with area lights and
// no environment light (about 2,700 eager launches): the miss adds the
// environment; an emissive hit adds its emission under the power heuristic
// against the light sample's pdf (models/lights.py pdf_hit_light) and ends;
// otherwise three draws pick a light triangle and a point of it
// (sample_lights), ops/disney.py eval_all (every lobe) weighs it, and the
// untested contribution with its shadow ray is written out as pending for
// the next step's mixed sweep; then the BSDF sample as above, eval_all again
// for the mixture pdf the next hit's MIS reads, and the compensated Russian
// roulette on every lobe.  The two kernels share their __device__ helpers.
//
// Arithmetic.  Every operation follows the eager CUDA version operation for
// operation, so the two agree bit for bit in practice: built with
// --fmad=false and IEEE division and square root, the same libdevice
// transcendentals PyTorch's kernels call, NaN-propagating clamps, minima and
// maxima (torch.clamp, torch.minimum, torch.amax) and, where PyTorch's own
// CUDA kernels round otherwise than a plain left-to-right expression, their
// order: dot3 (torch.sum over 3 components, two lanes a row), cross3
// (torch.linalg.cross, whose products nvcc contracts into an FMA) and
// mul_inv (a division by a Python number, which PyTorch turns into a
// multiplication by its float reciprocal).  A Python number over a tensor
// is the tensor's reciprocal times the number (1 / x for the 1.0 used here).
//
// Bound.  About 180 bytes read and 80 written per lane (state, hit, blob or
// gathered shade row, material row) and under 1,000 fp32 operations, so the
// kernel is bound by memory traffic: 34 MB at 131,072 lanes, about 10 us at
// 3.35 TB/s.  The NEE bounce reads the prev_pdf and allow_nee columns and the
// light table besides and writes prev_pdf and the pending ray (41 bytes a
// lane more out), with some 2,000 fp32 operations a lane: still bound by
// memory traffic.  Every per-lane array is read and written once, by
// neighbouring threads at neighbouring rows; the material table, the light
// table, the textures and the environment map are read through the
// read-only cache.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

// a Python number as PyTorch hands it to a float32 kernel: the double, rounded
__host__ __device__ constexpr float f32(double x) { return static_cast<float>(x); }

constexpr float kPi = f32(3.14159265358979323);
constexpr float kTwoPi = f32(6.28318530717958648);
constexpr float kPiOverTwo = f32(1.57079632679489661);
constexpr float kPiOverFour = f32(0.78539816339744830);
constexpr float kInvPi = f32(0.31830988618379067);
constexpr float kAlphaMin = f32(1e-3);
constexpr int kMatCols = 17;
constexpr int kBlobCols = 16;
constexpr int kShadeCols = 24;

// ops/disney.py LOBE_*
enum Lobe : long long { kDiffuse = 0, kClearcoat = 1, kMetallic = 2, kGlass = 3 };
enum Env : int { kEnvMap = 0, kEnvAuto = 1, kEnvColor = 2 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 vdiv(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ float sqr(float x) { return x * x; }

// torch.sum(a * b, dim=-1) on CUDA over a row of 3: two lanes reduce a row,
// lane 0 the components 0 and 2, lane 1 the component 1, each from a zero
// accumulator (the trailing + 0 gives the reduction's +0 for a zero sum)
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return ((p0 + p2) + p1) + 0.0f;
}

// torch.linalg.cross on CUDA: a1 b2 - a2 b1 per component, the first product
// contracted into an FMA
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}

// x / c for a Python number c: PyTorch multiplies by the float reciprocal
__device__ __forceinline__ float mul_inv(float x, float c) { return x * (1.0f / c); }

// torch.clamp / clamp(min=) / torch.minimum / torch.amax: NaN propagates
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ long long clamp_min_ll(long long x, long long lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float amax3(V3 a) {
  if (isnan(a.x) || isnan(a.y) || isnan(a.z)) return NAN;
  return fmaxf(fmaxf(a.x, a.y), a.z);
}

__device__ __forceinline__ float sin_theta(V3 w) { return sqrtf(clamp_min(1.0f - sqr(w.z), 0.0f)); }
__device__ __forceinline__ float tan_theta(V3 w) { return sin_theta(w) / w.z; }
__device__ __forceinline__ float cos_phi(V3 w) {
  const float st = sin_theta(w);
  return st == 0.0f ? 1.0f : clampf(w.x / st, -1.0f, 1.0f);
}
__device__ __forceinline__ float sin_phi(V3 w) {
  const float st = sin_theta(w);
  return st == 0.0f ? 1.0f : clampf(w.y / st, -1.0f, 1.0f);
}
__device__ __forceinline__ bool same_hemisphere(V3 a, V3 b) { return a.z * b.z > 0.0f; }
__device__ __forceinline__ V3 normalized(V3 v) { return vdiv(v, sqrtf(dot3(v, v))); }
__device__ __forceinline__ V3 sph_sincos(float sin_t, float cos_t, float phi) {
  return v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
}
__device__ __forceinline__ V3 reflect(V3 w, V3 n) { return sub(scale(n, 2.0f * dot3(w, n)), w); }
__device__ __forceinline__ float luminance(V3 c) {
  return ((f32(0.2126) * c.x) + (f32(0.7152) * c.y)) + (f32(0.0722) * c.z);
}
__device__ __forceinline__ float schlick(float c) {
  const float w = clampf(1.0f - c, 0.0f, 1.0f);
  return (((w * w) * w) * w) * w;
}

// ── the LCG (ops/rng.py) ─────────────────────────────────────────────────
__device__ __forceinline__ uint32_t lcg(uint32_t s) { return 16807u * s + 1013904223u; }
__device__ __forceinline__ float to_unit(uint32_t s) { return static_cast<float>(s) * 0x1p-32f; }

// ── materials ────────────────────────────────────────────────────────────
struct Mat {
  V3 base;
  float metallic, specular, specular_tint, roughness, anisotropic, sheen, sheen_tint, clearcoat,
      clearcoat_gloss, ior, transmission, transmission_roughness, emission;
};

__device__ __forceinline__ Mat load_mat(const float* __restrict__ table, long long id) {
  const float* r = table + id * kMatCols;
  Mat m;
  m.base = v3(__ldg(r + 0), __ldg(r + 1), __ldg(r + 2));
  // r[3] is subsurface (parsed, unused)
  m.metallic = __ldg(r + 4);
  m.specular = __ldg(r + 5);
  m.specular_tint = __ldg(r + 6);
  m.roughness = __ldg(r + 7);
  m.anisotropic = __ldg(r + 8);
  m.sheen = __ldg(r + 9);
  m.sheen_tint = __ldg(r + 10);
  m.clearcoat = __ldg(r + 11);
  m.clearcoat_gloss = __ldg(r + 12);
  m.ior = __ldg(r + 13);
  m.transmission = __ldg(r + 14);
  m.transmission_roughness = __ldg(r + 15);
  m.emission = __ldg(r + 16);
  return m;
}

struct Alpha {
  float ax, ay;
};

__device__ __forceinline__ Alpha alpha_aniso(const Mat& m) {
  const float aspect = sqrtf(1.0f - f32(0.9) * m.anisotropic);
  return Alpha{clamp_min(sqr(m.roughness) / aspect, kAlphaMin), clamp_min(sqr(m.roughness) * aspect, kAlphaMin)};
}

// the clearcoat's GTR1 alpha: m.lerp(0.1, 0.001, gloss), (b - a) taken in double
__device__ __forceinline__ float clearcoat_alpha(float gloss) {
  return f32(0.1) + f32(0.001 - 0.1) * gloss;
}

// ── microfacet terms (ops/disney.py) ─────────────────────────────────────
__device__ float smith_lambda(V3 w, float ax, float ay) {
  const float tan_t = tan_theta(w);
  const bool inf = isinf(tan_t);
  const float tan_safe = inf ? 1.0f : tan_t;
  const float alpha0 = sqrtf(sqr(cos_phi(w) * ax) + sqr(sin_phi(w) * ay));
  const float inv_a2 = sqr(alpha0 * tan_safe);
  const float lam = mul_inv(-1.0f + sqrtf(1.0f + inv_a2), 2.0f);
  return inf ? 0.0f : lam;
}

__device__ __forceinline__ float g1_smith(V3 w, float ax, float ay) { return 1.0f / (1.0f + smith_lambda(w, ax, ay)); }

__device__ float d_gtr2(V3 wm, float ax, float ay) {
  const float tan2 = sqr(tan_theta(wm));
  const bool inf = isinf(tan2);
  const float tan2_safe = inf ? 0.0f : tan2;
  const float cos4 = sqr(sqr(wm.z));
  const float e = 1.0f + tan2_safe * ((sqr(cos_phi(wm)) / sqr(ax)) + (sqr(sin_phi(wm)) / sqr(ay)));
  const float denom = (((kPi * ax) * ay) * cos4) * sqr(e);
  const float d = 1.0f / (denom == 0.0f ? 1.0f : denom);
  return (inf || denom == 0.0f) ? 0.0f : d;
}

__device__ float d_gtr1(V3 wh, float alpha) {
  const float a2 = sqr(alpha);
  const float val = (a2 - 1.0f) / ((kPi * logf(a2)) * (1.0f + (a2 - 1.0f) * sqr(wh.z)));
  return alpha >= 1.0f ? kInvPi : val;
}

__device__ V3 sample_gtr2_ndf(float ax, float ay, float u0, float u1) {
  float phi = atanf((ay / ax) * tanf(kTwoPi * u1 + kInvPi));
  if (u1 > 0.5f) phi = phi + kPi;
  const float sp = sinf(phi), cp = cosf(phi);
  const float alpha2 = 1.0f / ((sqr(cp) / sqr(ax)) + (sqr(sp) / sqr(ay)));
  const float tan_theta2 = (alpha2 * u0) / clamp_min(1.0f - u0, f32(1e-20));
  const float cos_t = 1.0f / sqrtf(1.0f + tan_theta2);
  const float sin_t = sqrtf(clamp_min(1.0f - sqr(cos_t), 0.0f));
  const V3 wh = sph_sincos(sin_t, cos_t, phi);
  return normalized(wh);
}

__device__ V3 sample_gtr2_vndf(V3 wo, float ax, float ay, float u0, float u1) {
  V3 n = v3(ax * wo.x, ay * wo.y, wo.z);
  n = normalized(n);
  const float len_sq = sqr(n.x) + sqr(n.y);
  const float inv = 1.0f / sqrtf(len_sq > 0.0f ? len_sq : 1.0f);
  const V3 t = len_sq > 0.0f ? v3(-n.y * inv, n.x * inv, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 b = cross3(n, t);
  const float r = sqrtf(u0);
  const float phi = kTwoPi * u1;
  const float t1 = r * cosf(phi);
  float b1 = r * sinf(phi);
  const float s = 0.5f * (1.0f + n.z);
  b1 = (1.0f - s) * sqrtf(clamp_min(1.0f - sqr(t1), 0.0f)) + s * b1;
  const float c = sqrtf(clamp_min((1.0f - sqr(t1)) - sqr(b1), 0.0f));
  const V3 nh = add(add(scale(t, t1), scale(b, b1)), scale(n, c));
  const V3 wh = v3(ax * nh.x, ay * nh.y, clamp_min(nh.z, 0.0f));
  return vdiv(wh, sqrtf(clamp_min(dot3(wh, wh), f32(1e-20))));
}

__device__ V3 sample_gtr1_ndf(V3 wo, float alpha, float u0, float u1) {
  const float a2 = sqr(alpha);
  const float num = 1.0f - powf(a2, 1.0f - u0);
  const float den = a2 == 1.0f ? 1.0f : 1.0f - a2;
  const float cos_t = sqrtf(clamp_min(num / den, 0.0f));
  const float sin_t = sqrtf(clamp_min(1.0f - sqr(cos_t), 0.0f));
  const V3 wh = sph_sincos(sin_t, cos_t, kTwoPi * u1);
  return same_hemisphere(wo, wh) ? wh : neg(wh);
}

// ── lobes: f (sheen not yet added) and pdf ───────────────────────────────
struct Lobe3 {
  V3 wi, f;
  float pdf;
};

__device__ V3 tint(V3 base) {
  const float lum = luminance(base);
  const float safe = lum > 0.0f ? lum : 1.0f;
  return lum > 0.0f ? vdiv(base, safe) : v3(1.0f, 1.0f, 1.0f);
}

__device__ void eval_specular_brdf(const Mat& m, V3 wo, V3 wh, V3 wi, bool corrected, V3* f_out, float* pdf_out) {
  const V3 ct = tint(m.base);
  const V3 inner = add(v3(1.0f, 1.0f, 1.0f), scale(sub(ct, v3(1.0f, 1.0f, 1.0f)), m.specular_tint));
  const V3 a = scale(inner, f32(0.08) * m.specular);
  const V3 c_spec = add(a, scale(sub(m.base, a), m.metallic));
  const Alpha al = alpha_aniso(m);
  const float d = d_gtr2(wh, al.ax, al.ay);
  const float g = 1.0f / ((1.0f + smith_lambda(wo, al.ax, al.ay)) + smith_lambda(wi, al.ax, al.ay));
  const float sw = schlick(dot3(wi, wh));
  const V3 f = add(c_spec, scale(sub(v3(1.0f, 1.0f, 1.0f), c_spec), sw));
  const float cos_o = wo.z;
  const float cos_safe = cos_o == 0.0f ? 1.0f : cos_o;
  float pdf;
  if (corrected)
    pdf = (d * g1_smith(wo, al.ax, al.ay)) / (4.0f * fabsf(cos_safe));
  else
    pdf = ((d * g1_smith(wo, al.ax, al.ay)) * clamp_min(dot3(wo, wh), 0.0f)) / (4.0f * cos_safe);
  if (cos_o == 0.0f) pdf = 0.0f;
  float val = (d * g) / (4.0f * fabsf(cos_safe));
  if (cos_o == 0.0f) val = 0.0f;
  *f_out = scale(f, val);
  *pdf_out = pdf;
}

__device__ Lobe3 sample_specular_brdf(const Mat& m, V3 wo, float u0, float u1, bool corrected) {
  const Alpha al = alpha_aniso(m);
  V3 wh = corrected ? sample_gtr2_vndf(wo, al.ax, al.ay, u0, u1) : sample_gtr2_ndf(al.ax, al.ay, u0, u1);
  if (dot3(wo, wh) < 0.0f) wh = neg(wh);
  const V3 wi = reflect(wo, wh);
  Lobe3 out;
  out.wi = wi;
  eval_specular_brdf(m, wo, wh, wi, corrected, &out.f, &out.pdf);
  if (wi.z <= 0.0f) {
    out.f = v3(0.0f, 0.0f, 0.0f);
    out.pdf = 0.0f;
  }
  return out;
}

// eval_clearcoat: f (grey) and pdf at the half vector wh; 0 without a clearcoat
__device__ Lobe3 eval_clearcoat(const Mat& m, V3 wo, V3 wh, V3 wi, bool corrected) {
  const float alpha = clearcoat_alpha(m.clearcoat_gloss);
  const float d = d_gtr1(wh, alpha);
  const float f = 1.0f + (schlick(wi.z) - 1.0f) * f32(0.04);
  const float g = g1_smith(wo, 0.25f, 0.25f) * g1_smith(wi, 0.25f, 0.25f);
  const float dwh_wi = dot3(wh, wi);
  const float num = corrected ? d * fabsf(wh.z) : d;
  float pdf = num / (dwh_wi == 0.0f ? 1.0f : 4.0f * dwh_wi);
  if (dwh_wi == 0.0f) pdf = 0.0f;
  const float denom = (4.0f * fabsf(wo.z)) * fabsf(wi.z);
  float val = ((d * g) * f) / (denom == 0.0f ? 1.0f : denom);
  if (denom == 0.0f) val = 0.0f;
  const bool active = m.clearcoat > 0.0f;
  Lobe3 out;
  out.wi = wi;
  out.f = active ? v3(val, val, val) : v3(0.0f, 0.0f, 0.0f);
  out.pdf = active ? pdf : 0.0f;
  return out;
}

__device__ Lobe3 sample_clearcoat(const Mat& m, V3 wo, float u0, float u1, bool corrected) {
  const float alpha = clearcoat_alpha(m.clearcoat_gloss);
  V3 wh = sample_gtr1_ndf(wo, alpha, u0, u1);
  if (dot3(wh, wo) < 0.0f) wh = neg(wh);
  wh = normalized(wh);
  Lobe3 out = eval_clearcoat(m, wo, wh, reflect(wo, wh), corrected);
  if (!same_hemisphere(wo, out.wi)) {
    out.f = v3(0.0f, 0.0f, 0.0f);
    out.pdf = 0.0f;
  }
  return out;
}

__device__ Lobe3 eval_diffuse(const Mat& m, V3 wo, V3 wi) {
  const float f_o = schlick(wo.z);
  const float f_i = schlick(wi.z);
  const V3 lambert = scale(m.base, kInvPi);
  const float fd = (1.0f - 0.5f * f_o) * (1.0f - 0.5f * f_i);
  const float rr = m.roughness * (dot3(wo, wi) + 1.0f);
  const float fr = rr * ((f_i + f_o) + (f_o * f_i) * (rr - 1.0f));
  Lobe3 out;
  out.wi = wi;
  out.f = scale(lambert, fd + fr);
  out.pdf = fabsf(wi.z) * kInvPi;
  return out;
}

__device__ Lobe3 sample_diffuse(const Mat& m, V3 wo, float u0, float u1) {
  // sampling.py sample_concentric_disk, then the cosine hemisphere
  const float dx = 2.0f * u0 - 1.0f;
  const float dy = 2.0f * u1 - 1.0f;
  const bool use_x = fabsf(dx) > fabsf(dy);
  const float safe_dx = dx == 0.0f ? 1.0f : dx;
  const float safe_dy = dy == 0.0f ? 1.0f : dy;
  const float r = use_x ? dx : dy;
  const float phi = use_x ? kPiOverFour * (dy / safe_dx) : kPiOverTwo - kPiOverFour * (dx / safe_dy);
  float px = r * cosf(phi), py = r * sinf(phi);
  if (dx == 0.0f && dy == 0.0f) px = py = 0.0f;
  const float z = sqrtf(clamp_min((1.0f - px * px) - py * py, 0.0f));
  return eval_diffuse(m, wo, v3(px, py, z));
}

__device__ float fresnel_dielectric(V3 i, V3 mfn, float eta_i, float eta_t) {
  const float c = fabsf(dot3(i, mfn));
  const float denom = (sqr(eta_t / eta_i) - 1.0f) + sqr(c);
  const float g = sqrtf(clamp_min(denom, 0.0f));
  const float sq = sqr(c * (g - c) + 1.0f);
  const float gpc = g + c;
  const float r = (0.5f * sqr((g - c) / (gpc == 0.0f ? 1.0f : gpc))) *
                  (1.0f + sqr(c * gpc - 1.0f) / (sq == 0.0f ? 1.0f : sq));
  return denom < 0.0f ? 1.0f : r;
}

// eval_specular_bsdf: the glass lobe's f and pdf at the half vector wh
__device__ Lobe3 eval_glass(const Mat& m, V3 wo, V3 wh, V3 wi) {
  const bool entering = wo.z > 0.0f;
  const float eta_i = entering ? 1.0f : m.ior;
  const float eta_t = entering ? m.ior : 1.0f;
  const float eta = eta_i / eta_t;
  const float r = fresnel_dielectric(wo, wh, eta_i, eta_t);
  const float t = 1.0f - r;
  const float cos_w = fabsf(wi.z);
  const float cos_safe = cos_w == 0.0f ? 1.0f : cos_w;
  const bool refl = same_hemisphere(wo, wi);
  Lobe3 out;
  out.wi = wi;
  out.pdf = refl ? r / (r + t) : t / (r + t);
  if (refl) {
    out.f = scale(m.base, r / cos_safe);
  } else {
    const V3 root = v3(sqrtf(clamp_min(m.base.x, 0.0f)), sqrtf(clamp_min(m.base.y, 0.0f)),
                       sqrtf(clamp_min(m.base.z, 0.0f)));
    out.f = scale(root, (t / cos_safe) / sqr(eta));
  }
  if (cos_w == 0.0f) out.f = v3(0.0f, 0.0f, 0.0f);
  return out;
}

// glass with its draw count: 4 transmit, 5 TIR (reflect), 6 Fresnel reflect
__device__ Lobe3 sample_glass(const Mat& m, V3 wo, const float* u, int* consumed) {
  const float a_t = clamp_min(clampf(sqr(m.transmission_roughness), 0.0f, 1.0f), kAlphaMin);
  // sample_gtr2_walter
  const float theta = atanf((a_t * sqrtf(u[1])) / sqrtf(clamp_min(1.0f - u[1], f32(1e-20))));
  const float phi_w = kTwoPi * u[2];
  const float st = sinf(theta), ctt = cosf(theta);
  V3 wh = v3(st * cosf(phi_w), st * sinf(phi_w), ctt);
  if (wo.z < 0.0f && !same_hemisphere(wo, wh)) wh = neg(wh);

  const bool entering = wo.z > 0.0f;
  const float eta_i = entering ? 1.0f : m.ior;
  const float eta_t = entering ? m.ior : 1.0f;
  const float eta = eta_i / eta_t;
  const float r = fresnel_dielectric(wo, wh, eta_i, eta_t);
  const float t = 1.0f - r;
  // math.py refract
  const float cos_i = dot3(wo, wh);
  const float sin2_i = clamp_min(1.0f - sqr(cos_i), 0.0f);
  const float sin2_t = sqr(eta) * sin2_i;
  const bool straight = eta == 1.0f;
  const bool ok = (sin2_t <= 1.0f) || straight;
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const V3 wi_refr = straight ? neg(wo) : add(scale(neg(wo), eta), scale(wh, eta * cos_i - cos_t));
  const bool choose_reflect = !ok || (u[3] < r / (r + t));

  V3 wi, wh_used;
  if (choose_reflect) {
    const Alpha al = alpha_aniso(m);
    const V3 wh_r = ok ? sample_gtr2_ndf(al.ax, al.ay, u[4], u[5]) : sample_gtr2_ndf(al.ax, al.ay, u[3], u[4]);
    wi = normalized(reflect(wo, wh_r));
    wh_used = wh_r;
  } else {
    wi = wi_refr;
    wh_used = wh;
  }
  *consumed = !ok ? 5 : (choose_reflect ? 6 : 4);
  return eval_glass(m, wo, wh_used, wi);
}

__device__ V3 eval_sheen(const Mat& m, V3 wo, V3 wi) {
  if (m.sheen <= 0.0f) return v3(0.0f, 0.0f, 0.0f);
  const V3 wh = add(wi, wo);
  const float len2 = dot3(wh, wh);
  if (len2 == 0.0f) return v3(0.0f, 0.0f, 0.0f);
  const V3 wh_n = vdiv(wh, sqrtf(len2));
  const V3 lin = v3(powf(clamp_min(m.base.x, 0.0f), f32(2.2)), powf(clamp_min(m.base.y, 0.0f), f32(2.2)),
                    powf(clamp_min(m.base.z, 0.0f), f32(2.2)));
  const float lum = luminance(lin);
  const V3 tnt = lum > 0.0f ? vdiv(m.base, lum) : v3(1.0f, 1.0f, 1.0f);
  const float sw = schlick(dot3(wi, wh_n));
  const V3 lerp = add(v3(1.0f, 1.0f, 1.0f), scale(sub(tnt, v3(1.0f, 1.0f, 1.0f)), m.sheen_tint));
  return scale(scale(lerp, m.sheen), sw);
}

struct LobeP {
  float metal, diff, cc, glass;
};

__device__ __forceinline__ LobeP lobe_probabilities(const Mat& m) {
  const float dw = (1.0f - m.transmission) * (1.0f - m.metallic);
  const float mw = m.metallic;
  const float cw = 0.25f * m.clearcoat;
  const float gw = (1.0f - m.metallic) * m.transmission;
  const float factor = 1.0f / (((mw + gw) + dw) + cw);
  return LobeP{mw * factor, dw * factor, cw * factor, gw * factor};
}

struct Sample {
  V3 f, wi;
  float pdf;
  long long lobe;
  uint32_t state;
};

__device__ Sample disney_sample(const Mat& m, V3 wo, uint32_t state, long long prev_lobe, bool corrected) {
  float u[6];
  uint32_t states[6];
  uint32_t s = state;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    s = lcg(s);
    states[k] = s;
    u[k] = to_unit(s);
  }
  const LobeP lp = lobe_probabilities(m);
  const float p_metal = lp.metal, p_diff = lp.diff, p_cc = lp.cc, p_glass = lp.glass;

  const float p = u[0];
  const bool force_btdf = wo.z < 0.0f && prev_lobe == kGlass;
  const float c1 = p_metal;
  const float c2 = p_metal + p_cc;
  const float c3 = (p_metal + p_cc) + p_diff;
  Sample out;
  Lobe3 l;
  float p_sel;
  int consumed = 3;
  if (!force_btdf && p <= c1) {
    l = sample_specular_brdf(m, wo, u[1], u[2], corrected);
    out.lobe = kMetallic;
    p_sel = p_metal;
  } else if (!force_btdf && p > c1 && p <= c2) {
    l = sample_clearcoat(m, wo, u[1], u[2], corrected);
    out.lobe = kClearcoat;
    p_sel = p_cc;
  } else if (!force_btdf && p > c2 && p <= c3) {
    l = sample_diffuse(m, wo, u[1], u[2]);
    out.lobe = kDiffuse;
    p_sel = p_diff;
  } else {
    l = sample_glass(m, wo, u, &consumed);
    out.lobe = kGlass;
    p_sel = p_glass;
  }
  out.wi = l.wi;
  out.pdf = corrected ? l.pdf * p_sel : l.pdf;
  out.state = consumed == 3 ? states[2] : consumed == 4 ? states[3] : consumed == 5 ? states[4] : states[5];
  out.f = add(l.f, eval_sheen(m, wo, l.wi));
  return out;
}

// ── environment and textures (ops/texture.py) ────────────────────────────
struct EnvArgs {
  const float* map;  // [EH,EW,3]
  int h, w, kind;
  float r, g, b, intensity;
};

__device__ V3 environment(const EnvArgs& env, V3 d) {
  V3 e;
  if (env.kind == kEnvMap) {
    const float u = 0.5f + mul_inv(atan2f(d.x, d.z), f32(2.0 * 3.14159265358979323));
    const float v = 0.5f + mul_inv(asinf(clampf(d.y, -1.0f, 1.0f)), kPi);
    long long x = static_cast<long long>(floorf(u * static_cast<float>(env.w)));
    long long y = static_cast<long long>(floorf(v * static_cast<float>(env.h)));
    x = x < 0 ? 0 : (x > env.w - 1 ? env.w - 1 : x);
    y = y < 0 ? 0 : (y > env.h - 1 ? env.h - 1 : y);
    const float* px = env.map + (y * env.w + x) * 3;
    e = v3(__ldg(px), __ldg(px + 1), __ldg(px + 2));
  } else if (env.kind == kEnvAuto) {
    const float t = 0.5f * (d.y + 1.0f);
    e = v3(1.0f + (0.5f - 1.0f) * t, 1.0f + (f32(0.7) - 1.0f) * t, 1.0f + (1.0f - 1.0f) * t);
  } else {
    e = v3(env.r, env.g, env.b);
  }
  return scale(e, env.intensity);
}

struct TexArgs {
  const int* mat_tex;   // [M]
  const float* atlas;   // [K,TH,TW,3]
  const float* tex_hw;  // [K,2]
  int th, tw;
};

// _tex_lookup: the nearest texel of the material's texture, else base_color
__device__ V3 tex_lookup(const TexArgs& tx, long long mat_id, float tcu, float tcv, V3 base) {
  const int tex_id = __ldg(tx.mat_tex + mat_id);
  if (tex_id < 0) return base;
  const long long k = tex_id;
  const float h = __ldg(tx.tex_hw + 2 * k), w = __ldg(tx.tex_hw + 2 * k + 1);
  long long x = clamp_min_ll(static_cast<long long>(floorf(tcu * w)), 0);
  long long y = clamp_min_ll(static_cast<long long>(floorf(tcv * h)), 0);
  const long long wl = static_cast<long long>(w - 1.0f), hl = static_cast<long long>(h - 1.0f);
  x = x < wl ? x : wl;
  y = y < hl ? y : hl;
  const float* px = tx.atlas + ((k * tx.th + y) * tx.tw + x) * 3;
  return v3(__ldg(px), __ldg(px + 1), __ldg(px + 2));
}

struct StateIn {
  const float *ray_o, *ray_d, *result, *throughput;
  const long long *rng, *prev_lobe, *depth;
  const bool* alive;
  const float* hit_t;
  const long long* hit_tri;
  const float* hit_uv;
};

struct StateOut {
  float *ray_o, *ray_d, *result, *throughput;
  long long *rng, *prev_lobe, *depth;
  bool* alive;
};

// where a bounce reads its surface: the fused2 attribute blob [N,16]
// (normals, texcoords, material id as float) when `blob` is not null, else
// shade_blob [T,24] and tri_mat [T]; the material table [M,17]; textures
struct SurfaceArgs {
  const float* blob;
  const float* shade_blob;
  const int* tri_mat;
  const float* mat_table;
  TexArgs tx;
  bool textures;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) { return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]); }
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

struct Surface {
  V3 pos, n;  // position, unit shading normal
  Mat m;
};

// render/integrator.py _fetch_surface_blob (kBlob) or _fetch_surface on a
// live lane that hit triangle tri_hit
template <bool kBlob>
__device__ __forceinline__ Surface fetch_surface(const SurfaceArgs& sa, const StateIn& in, long long i,
                                                 long long tri_hit, V3 ray_o, V3 ray_d) {
  const float hu = in.hit_uv[2 * i], hv = in.hit_uv[2 * i + 1];
  const float w = (1.0f - hu) - hv;
  Surface s;
  long long mat_id;
  float tcu = 0.0f, tcv = 0.0f;
  if (kBlob) {
    const float* b = sa.blob + i * kBlobCols;
    const float t = in.hit_t[i];
    s.pos = add(ray_o, scale(ray_d, t));
    const V3 n = add(add(scale(v3(b[0], b[1], b[2]), w), scale(v3(b[3], b[4], b[5]), hu)),
                     scale(v3(b[6], b[7], b[8]), hv));
    const float len2 = dot3(n, n);
    s.n = len2 > f32(1e-12) ? vdiv(n, sqrtf(clamp_min(len2, f32(1e-20)))) : v3(0.0f, 0.0f, 1.0f);
    mat_id = static_cast<long long>(b[15]);
    if (sa.textures) {
      tcu = ((w * b[9]) + (hu * b[11])) + (hv * b[13]);
      tcv = ((w * b[10]) + (hu * b[12])) + (hv * b[14]);
    }
  } else {
    const float* b = sa.shade_blob + tri_hit * kShadeCols;
    s.pos = add(add(scale(v3(__ldg(b), __ldg(b + 1), __ldg(b + 2)), w),
                    scale(v3(__ldg(b + 3), __ldg(b + 4), __ldg(b + 5)), hu)),
                scale(v3(__ldg(b + 6), __ldg(b + 7), __ldg(b + 8)), hv));
    const V3 n = add(add(scale(v3(__ldg(b + 9), __ldg(b + 10), __ldg(b + 11)), w),
                         scale(v3(__ldg(b + 12), __ldg(b + 13), __ldg(b + 14)), hu)),
                     scale(v3(__ldg(b + 15), __ldg(b + 16), __ldg(b + 17)), hv));
    s.n = vdiv(n, sqrtf(clamp_min(dot3(n, n), f32(1e-20))));
    mat_id = __ldg(sa.tri_mat + tri_hit);
    if (sa.textures) {
      tcu = ((w * __ldg(b + 18)) + (hu * __ldg(b + 20))) + (hv * __ldg(b + 22));
      tcv = ((w * __ldg(b + 19)) + (hu * __ldg(b + 21))) + (hv * __ldg(b + 23));
    }
  }
  s.m = load_mat(sa.mat_table, mat_id);
  if (sa.textures) s.m.base = tex_lookup(sa.tx, mat_id, tcu, tcv, s.m.base);
  return s;
}

// the tangent frame (math.py onb) and its to_local / to_world
struct Frame {
  V3 t, b, n;
};

__device__ __forceinline__ Frame make_frame(V3 n) {
  const V3 t_a = v3(n.z - n.y, n.x - n.z, n.y - n.x);
  const V3 t_b = v3(n.z - n.y, n.x + n.z, -n.y - n.x);
  const bool use_a = (n.x != n.y) || (n.x != n.z);
  const V3 t = normalized(use_a ? t_a : t_b);
  return Frame{t, cross3(n, t), n};
}

__device__ __forceinline__ V3 to_local(const Frame& f, V3 w) {
  return normalized(v3(dot3(w, f.t), dot3(w, f.b), dot3(w, f.n)));
}

__device__ __forceinline__ V3 to_world(const Frame& f, V3 w) {
  return normalized(add(add(scale(f.t, w.x), scale(f.b, w.y)), scale(f.n, w.z)));
}

template <bool kBlob>
__global__ void __launch_bounds__(128) shade_kernel(StateIn in, StateOut out, SurfaceArgs sa, EnvArgs env,
                                                    bool corrected, long long rr_start_depth, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 ray_o = load3(in.ray_o, i), ray_d = load3(in.ray_d, i);
  V3 result = load3(in.result, i), thr = load3(in.throughput, i);
  uint32_t rng = static_cast<uint32_t>(in.rng[i]);
  long long prev_lobe = in.prev_lobe[i], depth = in.depth[i];
  const long long tri_hit = in.hit_tri[i];
  bool alive = in.alive[i];

  // 1. miss -> environment, terminate
  if (alive && tri_hit < 0) result = mul(environment(env, ray_d), thr);
  alive = alive && tri_hit >= 0;

  if (alive) {
    // 2. the surface
    const Surface sf = fetch_surface<kBlob>(sa, in, i, tri_hit, ray_o, ray_d);
    const Mat& m = sf.m;

    // 3. emissive -> monochrome radiance, terminate
    if (m.emission > 0.0f) {
      result = scale(thr, m.emission);
      alive = false;
    } else {
      // 4. local frame (math.py onb, to_local)
      const Frame fr = make_frame(sf.n);
      const V3 wo = to_local(fr, neg(ray_d));

      // 5. the BSDF sample
      const Sample bs = disney_sample(m, wo, rng, prev_lobe, corrected);
      rng = bs.state;
      const V3 wi_world = to_world(fr, bs.wi);

      // 6. degenerate pdf -> kill; non-finite f -> retry
      alive = !(bs.pdf < f32(1e-5));
      const bool bad_f = !(isfinite(bs.f.x) && isfinite(bs.f.y) && isfinite(bs.f.z));
      const bool ok = alive && !bad_f;

      // 7. throughput, then Russian roulette (no 1/q, glass-exempt)
      if (ok) {
        const float k = fabsf(bs.wi.z) / bs.pdf;
        thr = scale(mul(thr, bs.f), k);
        ray_o = sf.pos;
        ray_d = wi_world;
        prev_lobe = bs.lobe;
      }
      const bool rr_active = ok && bs.lobe != kGlass && depth > rr_start_depth;
      if (rr_active) {
        const float q = clamp_min(1.0f - amax3(thr), f32(0.05));
        const uint32_t s = lcg(rng);
        rng = s;
        if (to_unit(s) > q) alive = false;
      }
      if (ok) depth = depth + 1;
    }
  }

  store3(out.ray_o, i, ray_o);
  store3(out.ray_d, i, ray_d);
  store3(out.result, i, result);
  store3(out.throughput, i, thr);
  out.rng[i] = static_cast<long long>(rng);
  out.alive[i] = alive;
  out.prev_lobe[i] = prev_lobe;
  out.depth[i] = depth;
}

// ── the deferred next-event-estimation bounce ───────────────────────────
// ops/disney.py eval_all: every lobe at wi, each f weighted by its selection
// probability, the mixture pdf; the parity forms of the metal and clearcoat
// lobes whatever the sampler's mode; sheen on reflection only
struct Eval {
  V3 f;
  float pdf;
};

__device__ Eval eval_all(const Mat& m, V3 wo, V3 wi) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const LobeP p = lobe_probabilities(m);
  const bool refl = same_hemisphere(wo, wi);

  // the reflection half vector, oriented towards wo's hemisphere
  V3 wh_r = add(wo, wi);
  wh_r = vdiv(wh_r, sqrtf(clamp_min(dot3(wh_r, wh_r), f32(1e-20))));
  if (dot3(wh_r, wo) < 0.0f) wh_r = neg(wh_r);

  const Lobe3 d = eval_diffuse(m, wo, wi);
  V3 f_m;
  float pdf_m;
  eval_specular_brdf(m, wo, wh_r, wi, false, &f_m, &pdf_m);
  const Lobe3 c = eval_clearcoat(m, wo, wh_r, wi, false);
  const bool both_up = refl && wo.z > 0.0f && wi.z > 0.0f;

  // glass: the transmission half vector -(eta_i wo + eta_t wi)
  const bool entering = wo.z > 0.0f;
  const float eta_i = entering ? 1.0f : m.ior;
  const float eta_t = entering ? m.ior : 1.0f;
  V3 wh_t = neg(add(scale(wo, eta_i), scale(wi, eta_t)));
  wh_t = vdiv(wh_t, sqrtf(clamp_min(dot3(wh_t, wh_t), f32(1e-20))));
  const Lobe3 g = eval_glass(m, wo, refl ? wh_r : wh_t, wi);

  const bool glass = p.glass > 0.0f;
  Eval out;
  out.f = add(add(add(scale(both_up ? d.f : zero, p.diff), scale(both_up ? f_m : zero, p.metal)),
                  scale(both_up ? c.f : zero, p.cc)),
              glass ? scale(g.f, p.glass) : zero);
  out.pdf = ((p.diff * (both_up ? d.pdf : 0.0f) + p.metal * (both_up ? pdf_m : 0.0f)) +
             p.cc * (both_up ? c.pdf : 0.0f)) +
            p.glass * (glass ? g.pdf : 0.0f);
  out.f = add(out.f, refl ? eval_sheen(m, wo, wi) : zero);
  return out;
}

struct LightArgs {
  const float *p0, *p1, *p2, *n0, *n1, *n2;  // [L,3]
  const float *emission, *area;              // [L]
  const int* tri_id;                         // [L]
  long long count;
};

// models/lights.py pdf_area_to_solid_angle: 0 at grazing angles
__device__ __forceinline__ float area_to_solid_angle(float pdf_area, float dist_sqr, float cos_t) {
  const float a = fabsf(cos_t);
  return a < f32(1e-4) ? 0.0f : (pdf_area * dist_sqr) / a;
}

// models/lights.py power_heuristic with one sample each: 0 where both pdfs are 0
__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float denom = f * f + g * g;
  return denom > 0.0f ? (f * f) / denom : 0.0f;
}

// models/lights.py pdf_hit_light: the solid-angle pdf NEE gives a hit of
// triangle `tri` at distance t (0 where it is no light)
__device__ float pdf_hit_light(const LightArgs& lt, long long tri, V3 ray_d, float t, V3 light_n) {
  bool is_light = false;
  float area = 0.0f;
  for (long long k = 0; k < lt.count; ++k) {
    const bool eq = static_cast<long long>(__ldg(lt.tri_id + k)) == tri;
    is_light = is_light || eq;
    area = area + (eq ? __ldg(lt.area + k) : 0.0f);
  }
  const float pdf_area = 1.0f / (static_cast<float>(lt.count) * clamp_min(is_light ? area : 1.0f, f32(1e-12)));
  const float pdf = area_to_solid_angle(pdf_area, t * t, dot3(neg(ray_d), light_n));
  return is_light ? pdf : 0.0f;
}

__device__ __forceinline__ V3 ldg3(const float* p, long long i) {
  return v3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}

struct LightSample {
  V3 dir;
  float dist, pdf, emission;
};

// models/lights.py sample_lights: a uniform light pick, a uniform point of it
__device__ LightSample sample_light(const LightArgs& lt, V3 target, float u0, float u1, float u2) {
  long long li = static_cast<long long>(u0 * static_cast<float>(lt.count));
  li = li < 0 ? 0 : (li > lt.count - 1 ? lt.count - 1 : li);
  // sampling.py sample_uniform_triangle
  const float su0 = sqrtf(u1);
  const float b1 = 1.0f - su0, b2 = u2 * su0;
  const float b0 = (1.0f - b1) - b2;
  const V3 pos = add(add(scale(ldg3(lt.p0, li), b0), scale(ldg3(lt.p1, li), b1)), scale(ldg3(lt.p2, li), b2));
  V3 nrm = add(add(scale(ldg3(lt.n0, li), b0), scale(ldg3(lt.n1, li), b1)), scale(ldg3(lt.n2, li), b2));
  nrm = vdiv(nrm, sqrtf(clamp_min(dot3(nrm, nrm), f32(1e-20))));
  const V3 d = sub(pos, target);
  const float dist_sqr = dot3(d, d);
  LightSample out;
  out.dist = sqrtf(clamp_min(dist_sqr, f32(1e-20)));
  out.dir = vdiv(d, out.dist);
  const float pdf_area = 1.0f / (static_cast<float>(lt.count) * clamp_min(__ldg(lt.area + li), f32(1e-12)));
  out.pdf = area_to_solid_angle(pdf_area, dist_sqr, dot3(neg(out.dir), nrm));
  out.emission = __ldg(lt.emission + li);
  return out;
}

// torch.nan_to_num(x, nan=0, posinf=0): -inf becomes the lowest float
__device__ __forceinline__ float nan_to_num(float x) {
  return isnan(x) ? 0.0f : (x == INFINITY ? 0.0f : (x == -INFINITY ? -FLT_MAX : x));
}

struct NeeOut {
  StateOut st;
  float* prev_pdf;
  float *pend_o, *pend_d, *pend_dist, *pend_c;  // [N,3], [N,3], [N], [N,3]
  bool* pend_on;
};

template <bool kBlob>
__global__ void __launch_bounds__(128)
    shade_nee_kernel(StateIn in, const float* __restrict__ prev_pdf_in, NeeOut out, SurfaceArgs sa, EnvArgs env,
                     LightArgs lt, const bool* __restrict__ allow_nee, bool allow_all, bool corrected,
                     long long rr_start_depth, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 ray_o = load3(in.ray_o, i), ray_d = load3(in.ray_d, i);
  V3 result = load3(in.result, i), thr = load3(in.throughput, i);
  uint32_t rng = static_cast<uint32_t>(in.rng[i]);
  long long prev_lobe = in.prev_lobe[i], depth = in.depth[i];
  float prev_pdf = prev_pdf_in[i];
  const long long tri_hit = in.hit_tri[i];
  bool alive = in.alive[i];

  // 1. miss -> the environment, added (weight 1: no environment light)
  result = add(result, alive && tri_hit < 0 ? mul(environment(env, ray_d), thr) : zero);
  alive = alive && tri_hit >= 0;

  V3 pend_o = zero, pend_d = zero, pend_c = mul(thr, zero);
  float pend_dist = 0.0f;
  bool pend_on = false;
  V3 emitted = zero;
  if (alive) {
    // 2. the surface
    const Surface sf = fetch_surface<kBlob>(sa, in, i, tri_hit, ray_o, ray_d);
    const Mat& m = sf.m;

    if (m.emission > 0.0f) {
      // 3. emissive -> the emission, MIS-weighted against the light sample
      const bool first = depth == 0 || prev_pdf <= 0.0f;
      const float w_b =
          first ? 1.0f : power_heuristic(prev_pdf, pdf_hit_light(lt, tri_hit, ray_d, in.hit_t[i], sf.n));
      emitted = scale(thr, w_b * m.emission);
      alive = false;
    } else {
      // 4. local frame
      const Frame fr = make_frame(sf.n);
      const V3 wo = to_local(fr, neg(ray_d));

      // 5. the area-light sample, its MIS weight, the pending shadow ray
      const uint32_t s1 = lcg(rng), s2 = lcg(s1), s3 = lcg(s2);
      rng = s3;
      const LightSample ls = sample_light(lt, sf.pos, to_unit(s1), to_unit(s2), to_unit(s3));
      const V3 wl = to_local(fr, ls.dir);
      const Eval el = eval_all(m, wo, wl);
      const bool allow = allow_nee == nullptr ? allow_all : allow_nee[i];
      const bool can_light = ls.pdf > 0.0f && ls.emission > 0.0f && allow;
      const float w_l = power_heuristic(ls.pdf, el.pdf);
      const float k_l = ((fabsf(wl.z) * ls.emission) * w_l) / (ls.pdf > 0.0f ? ls.pdf : 1.0f);
      const V3 contrib = can_light ? scale(el.f, k_l) : zero;
      pend_c = mul(thr, v3(nan_to_num(contrib.x), nan_to_num(contrib.y), nan_to_num(contrib.z)));
      pend_on = can_light && (pend_c.x != 0.0f || pend_c.y != 0.0f || pend_c.z != 0.0f);
      pend_o = sf.pos;
      pend_d = ls.dir;
      pend_dist = ls.dist - f32(1e-3);

      // 6. the BSDF sample; its mixture pdf is kept for the next hit's MIS
      const Sample bs = disney_sample(m, wo, rng, prev_lobe, corrected);
      rng = bs.state;
      const V3 wi_world = to_world(fr, bs.wi);
      const Eval em = eval_all(m, wo, bs.wi);

      // 7. degenerate pdf -> kill; non-finite f -> retry; the throughput
      alive = !(bs.pdf < f32(1e-5));
      const bool bad_f = !(isfinite(bs.f.x) && isfinite(bs.f.y) && isfinite(bs.f.z));
      const bool ok = alive && !bad_f;
      if (ok) {
        thr = scale(mul(thr, bs.f), fabsf(bs.wi.z) / bs.pdf);
        ray_o = sf.pos;
        ray_d = wi_world;
        prev_lobe = bs.lobe;
        prev_pdf = em.pdf;
      }

      // 8. compensated Russian roulette (every lobe)
      if (ok && depth > rr_start_depth) {
        const float q = clampf(amax3(thr), f32(0.05), 1.0f);
        const uint32_t s = lcg(rng);
        rng = s;
        if (to_unit(s) < q)
          thr = vdiv(thr, q);
        else
          alive = false;
      }
      if (ok) depth = depth + 1;
    }
  }
  result = add(result, emitted);

  store3(out.st.ray_o, i, ray_o);
  store3(out.st.ray_d, i, ray_d);
  store3(out.st.result, i, result);
  store3(out.st.throughput, i, thr);
  out.st.rng[i] = static_cast<long long>(rng);
  out.st.alive[i] = alive;
  out.st.prev_lobe[i] = prev_lobe;
  out.st.depth[i] = depth;
  out.prev_pdf[i] = prev_pdf;
  store3(out.pend_o, i, pend_o);
  store3(out.pend_d, i, pend_d);
  out.pend_dist[i] = pend_dist;
  store3(out.pend_c, i, pend_c);
  out.pend_on[i] = pend_on;
}

constexpr int kBlock = 128;

}  // namespace

// One shading bounce of n lanes on `stream`.  State in [N,3] f32 (ray_o,
// ray_d, result, throughput), [N] int64 (rng, prev_lobe, depth), [N] bool
// alive; hit [N] f32 t, [N] int64 tri, [N,2] f32 uv; the surface from blob
// [N,16] when it is not null, else from shade_blob [T,24] and tri_mat [T];
// mat_table [M,17]; textures (when `textures`) mat_tex [M] int32, atlas
// [K,TH,TW,3], tex_hw [K,2]; the environment env_kind 0 (map [EH,EW,3]), 1
// (auto sky), 2 (the colour r, g, b), times intensity; corrected = not
// parity.  The same state out.  Returns the launch's CUDA error.
extern "C" int owlpt_shade_bounce(const float* ray_o, const float* ray_d, const float* result, const float* throughput,
                                  const long long* rng, const bool* alive, const long long* prev_lobe,
                                  const long long* depth, const float* hit_t, const long long* hit_tri,
                                  const float* hit_uv, const float* blob, const float* shade_blob,
                                  const int* tri_mat, const float* mat_table, int textures, const int* mat_tex,
                                  const float* atlas, const float* tex_hw, int tex_h, int tex_w, int env_kind,
                                  const float* env_map, int env_h, int env_w, float env_r, float env_g, float env_b,
                                  float intensity, int corrected, long long rr_start_depth, long long n,
                                  float* o_ray_o, float* o_ray_d, float* o_result, float* o_throughput,
                                  long long* o_rng, bool* o_alive, long long* o_prev_lobe, long long* o_depth,
                                  void* stream) {
  if (n <= 0) return 0;
  if (env_kind < kEnvMap || env_kind > kEnvColor) return static_cast<int>(cudaErrorInvalidValue);
  const StateIn in{ray_o, ray_d, result, throughput, rng, prev_lobe, depth, alive, hit_t, hit_tri, hit_uv};
  const StateOut out{o_ray_o, o_ray_d, o_result, o_throughput, o_rng, o_prev_lobe, o_depth, o_alive};
  const SurfaceArgs sa{blob, shade_blob, tri_mat, mat_table, TexArgs{mat_tex, atlas, tex_hw, tex_h, tex_w},
                       textures != 0};
  const EnvArgs env{env_map, env_h, env_w, env_kind, env_r, env_g, env_b, intensity};
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blob != nullptr)
    shade_kernel<true><<<grid, kBlock, 0, st>>>(in, out, sa, env, corrected != 0, rr_start_depth, n);
  else
    shade_kernel<false><<<grid, kBlock, 0, st>>>(in, out, sa, env, corrected != 0, rr_start_depth, n);
  return static_cast<int>(cudaGetLastError());
}

// One deferred next-event-estimation bounce of n lanes on `stream`
// (render/integrator.py _shade_bounce_nee with deferred=True, area lights,
// no environment light).  The arguments of owlpt_shade_bounce, with the
// state's prev_pdf [N] f32 beside it; the light table [L] (p0, p1, p2, n0,
// n1, n2 [L,3] f32, emission and area [L] f32, tri_id [L] int32);
// allow_nee [N] bool, or null for `allow_all` on every lane.  Out: the
// state with prev_pdf, then the pending shadow ray: origin [N,3], direction
// [N,3], distance less T_MIN [N], contribution [N,3] and whether it is
// pending [N] bool (zeros where no light was sampled).  Returns the
// launch's CUDA error.
extern "C" int owlpt_shade_bounce_nee(
    const float* ray_o, const float* ray_d, const float* result, const float* throughput, const long long* rng,
    const bool* alive, const long long* prev_lobe, const long long* depth, const float* prev_pdf,
    const float* hit_t, const long long* hit_tri, const float* hit_uv, const float* blob, const float* shade_blob,
    const int* tri_mat, const float* mat_table, int textures, const int* mat_tex, const float* atlas,
    const float* tex_hw, int tex_h, int tex_w, int env_kind, const float* env_map, int env_h, int env_w,
    float env_r, float env_g, float env_b, float intensity, const float* l_p0, const float* l_p1,
    const float* l_p2, const float* l_n0, const float* l_n1, const float* l_n2, const float* l_emission,
    const float* l_area, const int* l_tri_id, long long l_count, const bool* allow_nee, int allow_all,
    int corrected, long long rr_start_depth, long long n, float* o_ray_o, float* o_ray_d, float* o_result,
    float* o_throughput, long long* o_rng, bool* o_alive, long long* o_prev_lobe, long long* o_depth,
    float* o_prev_pdf, float* o_pend_o, float* o_pend_d, float* o_pend_dist, float* o_pend_c, bool* o_pend_on,
    void* stream) {
  if (n <= 0) return 0;
  if (env_kind < kEnvMap || env_kind > kEnvColor || l_count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const StateIn in{ray_o, ray_d, result, throughput, rng, prev_lobe, depth, alive, hit_t, hit_tri, hit_uv};
  const NeeOut out{StateOut{o_ray_o, o_ray_d, o_result, o_throughput, o_rng, o_prev_lobe, o_depth, o_alive},
                   o_prev_pdf, o_pend_o, o_pend_d, o_pend_dist, o_pend_c, o_pend_on};
  const SurfaceArgs sa{blob, shade_blob, tri_mat, mat_table, TexArgs{mat_tex, atlas, tex_hw, tex_h, tex_w},
                       textures != 0};
  const EnvArgs env{env_map, env_h, env_w, env_kind, env_r, env_g, env_b, intensity};
  const LightArgs lt{l_p0, l_p1, l_p2, l_n0, l_n1, l_n2, l_emission, l_area, l_tri_id, l_count};
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blob != nullptr)
    shade_nee_kernel<true><<<grid, kBlock, 0, st>>>(in, prev_pdf, out, sa, env, lt, allow_nee, allow_all != 0,
                                                    corrected != 0, rr_start_depth, n);
  else
    shade_nee_kernel<false><<<grid, kBlock, 0, st>>>(in, prev_pdf, out, sa, env, lt, allow_nee, allow_all != 0,
                                                     corrected != 0, rr_start_depth, n);
  return static_cast<int>(cudaGetLastError());
}
