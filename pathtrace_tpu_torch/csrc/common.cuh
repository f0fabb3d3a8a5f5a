// What the forward kernel (trace_kernel.cu) and the gradient kernels
// (grad_kernel.cu; nee_grad_kernel.cu and ad_grad_kernel.cu through
// sweep.cuh) share: the parameter block, the random lattice, the sphere
// test, one forward path segment (with an optional tape of what a reverse
// sweep cannot recompute) and the fixed-order sum of per-block partials.
//
// The gradient kernels retrace the forward kernel's paths sample for
// sample, so both must run this code with the same arithmetic: every file
// that includes it is built with -fmad=false and without --use_fast_math
// (ops/build.py), and the arithmetic follows pallas_trace.py's
// trace_tile_sample term for term (NDC as 2*c*(1/W)-1, rsqrt only for the
// primary ray, T_BIG = 1e6, the +1e-20 guards).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr int kMaxSpheres = 16;
constexpr int kMaxBlock = 16;  // largest block edge, in pixels
constexpr int kMaxThreads = 256;  // a K1 or K2 block: its pixels x sample lanes
constexpr int kMaxLanes = 4;  // sample lanes a pixel in K1 and K2
constexpr int kReduceThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
constexpr float kTBig = 1.0e6f;
constexpr float kTwoPi = 6.283185307179586f;

constexpr uint32_t kMix1 = 0x7FEB352Du;
constexpr uint32_t kMix2 = 0x846CA68Bu;
constexpr uint32_t kGold = 0x9E3779B1u;
constexpr uint32_t kRow = 0x85EBCA77u;
constexpr uint32_t kFrame = 0xC2B2AE3Du;

struct Sphere {
  float rad, px, py, pz, er, eg, eb, cr, cg, cb;
};

struct TraceParams {
  Sphere sph[kMaxSpheres];
  float eye[3];
  float basis[4][3];  // corner rays 00, 10, 01, 11
  uint32_t seed, frame, sample_offset, row_offset, col_offset;
  int num_spheres, spp, max_bounces, jitter, local_h, width, light_index;
  float inv_width, inv_height, inv_spp, push;
};

// Fills p from the host arrays of the C entry points: scene [num_spheres,
// 10] (radius, pos xyz, emission rgb, colour rgb), cam [5, 3] (eye, corner
// rays 00, 10, 01, 11), seed [5] (seed, frame, sample/row/col offsets).
inline void fill_params(TraceParams& p, const float* scene, int num_spheres,
                        const float* cam, const uint32_t* seed) {
  for (int i = 0; i < kMaxSpheres; ++i) {
    const float* r = scene + 10 * i;
    p.sph[i] = i < num_spheres
                   ? Sphere{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9]}
                   : Sphere{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  for (int k = 0; k < 3; ++k) p.eye[k] = cam[k];
  for (int j = 0; j < 4; ++j)
    for (int k = 0; k < 3; ++k) p.basis[j][k] = cam[3 + 3 * j + k];
  p.seed = seed[0];
  p.frame = seed[1];
  p.sample_offset = seed[2];
  p.row_offset = seed[3];
  p.col_offset = seed[4];
  p.num_spheres = num_spheres;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMix1;
  x ^= x >> 15;
  x *= kMix2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

struct Rng {
  uint32_t pix_key, base_key, n_slots, sample;
  __device__ __forceinline__ float draw(uint32_t slot) const {
    const uint32_t dk = mix32(base_key ^ ((sample * n_slots + slot) * kGold));
    return (float)(mix32(pix_key ^ dk) >> 8) * (1.0f / 16777216.0f);
  }
};

// The lattice position of local pixel (row, col): keys from ABSOLUTE pixel
// coordinates, so a slab at a row offset draws its slice of the global
// lattice. rows/cols are the absolute coordinates as floats.
template <bool GLOSSY>
__device__ __forceinline__ Rng pixel_rng(const TraceParams& p, int row, int col,
                                         float& rows, float& cols) {
  const uint32_t row_i = (uint32_t)row + p.row_offset;
  const uint32_t col_i = (uint32_t)col + p.col_offset;
  rows = (float)(int32_t)row_i;
  cols = (float)(int32_t)col_i;
  Rng rng;
  rng.pix_key = mix32(row_i * kGold ^ col_i * kRow);
  rng.base_key = mix32((p.seed & 0x7FFFFFFFu) ^ mix32(p.frame * kFrame));
  rng.n_slots = 2u + (GLOSSY ? 5u : 2u) * (uint32_t)p.max_bounces;
  rng.sample = 0u;
  return rng;
}

struct Sample {
  float cr, cg, cb, nx, ny, nz, ar, ag, ab, d;
  bool hit0, active;
};

// The bilinear coordinates (u, v) of one sample on the image plane: jitter
// (slots 0, 1) and NDC.
__device__ __forceinline__ void primary_uv(const TraceParams& p, const Rng& rng,
                                           float rows, float cols, float& u,
                                           float& v) {
  float r = rows, c = cols;
  if (p.jitter) {
    r = rows + (rng.draw(0u) - 0.5f);
    c = cols + (rng.draw(1u) - 0.5f);
  }
  const float ndc_x = 2.0f * c * p.inv_width - 1.0f;
  const float ndc_y = 1.0f - 2.0f * r * p.inv_height;
  u = (ndc_x + 1.0f) * 0.5f;
  v = (ndc_y + 1.0f) * 0.5f;
}

// The unnormalized primary ray of one sample: the bilinear blend of the
// four corner rays at primary_uv.
__device__ __forceinline__ void primary_ray(const TraceParams& p, const Rng& rng,
                                            float rows, float cols, float& dx,
                                            float& dy, float& dz) {
  float u, v;
  primary_uv(p, rng, rows, cols, u, v);
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float bottom = p.basis[0][k] * (1.0f - u) + p.basis[1][k] * u;
    const float top = p.basis[2][k] * (1.0f - u) + p.basis[3][k] * u;
    d[k] = bottom * (1.0f - v) + top * v;
  }
  dx = d[0];
  dy = d[1];
  dz = d[2];
}

// Perpendicular-foot test of the ray (ox, oy, oz) + t (dnx, dny, dnz), dn
// unit, against sphere s: det = r^2 - (distance of the centre from the
// ray)^2 (no intersection when negative), tca = distance to the foot,
// thc = sqrt(max(det, 0)).
__device__ __forceinline__ void sphere_hit(const Sphere& s, float ox, float oy,
                                           float oz, float dnx, float dny,
                                           float dnz, float& det, float& tca,
                                           float& thc) {
  const float rel_x = s.px - ox, rel_y = s.py - oy, rel_z = s.pz - oz;
  tca = dot3(rel_x, rel_y, rel_z, dnx, dny, dnz);
  const float qx = rel_x - tca * dnx;
  const float qy = rel_y - tca * dny;
  const float qz = rel_z - tca * dnz;
  const float d2 = dot3(qx, qy, qz, qx, qy, qz);
  det = s.rad * s.rad - d2;
  thc = det > 0.0f ? sqrtf(det) : 0.0f;
}

// What a reverse sweep over a hit bounce cannot recompute: the ray as it
// came in, the winner's distance, and the detached decisions (which sphere,
// its near or far root, the shadow ray's visibility). Everything else of
// the bounce follows from these with the segment's own expressions. What it
// could recompute only by drawing again, for a bounce that goes on: the
// cosine sample (cs, ss, zc) and, under GLOSSY, the jitter terms
// 0.01 * draw (jx, jy, jz).
struct BounceTape {
  float ox, oy, oz, dx, dy, dz, t;
  float cs, ss, zc, jx, jy, jz;
  int flags;  // sphere index | far root << 4 | visible << 5
  __device__ __forceinline__ int index() const { return flags & 15; }
  __device__ __forceinline__ bool far_root() const { return (flags & 16) != 0; }
  __device__ __forceinline__ bool visible() const { return (flags & 32) != 0; }
};

// One segment of the path: closest hit, shading, and (unless it is the
// last bounce) the next ray. Returns false when the ray escapes; else
// hit_index is the sphere hit. The colour gathers the throughput-weighted
// emission (clamped to [0, 1] at the first bounce) and the throughput
// (mr, mg, mb) takes the hit sphere's albedo. With TAPED, a hit also fills
// tape; the arithmetic is the same either way.
//
// The sphere tests read p.sph[i], the same row in every lane: the constant
// bank broadcasts it. The rows read by a per-lane index (the winner's, and
// under NEE the light's) come from `table`: the block's copy in shared
// memory, where any index a lane holds reads a field in one wavefront
// (K2), or p.sph itself (K1, and the sweep's forward in K3 and K4).
template <bool FIRST, bool GLOSSY, bool NEE, bool TAPED>
__device__ __forceinline__ bool segment_taped(const TraceParams& p, const Sphere* table,
                                              const Rng& rng, int bounce, float& ox,
                                              float& oy, float& oz, float& dx, float& dy,
                                              float& dz, float& mr, float& mg, float& mb,
                                              Sample& out, int& hit_index,
                                              BounceTape& tape) {
  float dnx = dx, dny = dy, dnz = dz, inv_len = 1.0f;
  if (FIRST) {
    // Primary rays are unnormalized (reference depth convention).
    inv_len = rsqrtf(dot3(dx, dy, dz, dx, dy, dz));
    dnx = dx * inv_len;
    dny = dy * inv_len;
    dnz = dz * inv_len;
  }
  float t_best = kTBig;
  int sel = -1;
  bool far_root = false;
  for (int i = 0; i < p.num_spheres; ++i) {
    float det, tca, thc;
    sphere_hit(p.sph[i], ox, oy, oz, dnx, dny, dnz, det, tca, thc);
    // inv_len is 1 after the first bounce: the product is then exact.
    const float t_near = (tca - thc) * inv_len;
    const float t_far = (tca + thc) * inv_len;
    const float t = t_near > 0.0f ? t_near : t_far;
    if (det >= 0.0f && t > 0.0f && t < kTBig && t < t_best) {
      t_best = t;
      sel = i;
      if (TAPED) far_root = !(t_near > 0.0f);
    }
  }
  if (sel < 0) return false;
  hit_index = sel;
  const Sphere& s = table[sel];
  if (TAPED) {
    tape.ox = ox;
    tape.oy = oy;
    tape.oz = oz;
    tape.dx = dx;
    tape.dy = dy;
    tape.dz = dz;
    tape.t = t_best;
    tape.flags = sel | (far_root ? 16 : 0) | 32;
  }

  // Hit position and normal, flipped toward the incoming ray.
  const float hx = ox + dx * t_best;
  const float hy = oy + dy * t_best;
  const float hz = oz + dz * t_best;
  float nx = hx - s.px, ny = hy - s.py, nz = hz - s.pz;
  const float n_inv = rsqrtf(dot3(nx, ny, nz, nx, ny, nz) + 1e-20f);
  nx *= n_inv;
  ny *= n_inv;
  nz *= n_inv;
  const float flip = dot3(nx, ny, nz, dx, dy, dz) < 0.0f ? 1.0f : -1.0f;
  nx *= flip;
  ny *= flip;
  nz *= flip;

  float er = mr * s.er, eg = mg * s.eg, eb = mb * s.eb;
  if (FIRST) {  // first-bounce emission clamp (pathtrace.cu:170-174)
    er = fminf(fmaxf(er, 0.0f), 1.0f);
    eg = fminf(fmaxf(eg, 0.0f), 1.0f);
    eb = fminf(fmaxf(eb, 0.0f), 1.0f);
  }
  if (NEE) {
    // getDirectLighting (pathtrace.cu:109-148): light direction from the
    // unpushed hit, shadow ray and its range from the pushed origin.
    const int li = p.light_index;
    const Sphere& l = table[li];
    const float lb_x = l.px, lb_y = l.py - l.rad, lb_z = l.pz;
    const float sox = hx + nx * p.push;
    const float soy = hy + ny * p.push;
    const float soz = hz + nz * p.push;
    const float lvx = lb_x - hx, lvy = lb_y - hy, lvz = lb_z - hz;
    const float l_inv = rsqrtf(dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20f);
    const float ldx = lvx * l_inv, ldy = lvy * l_inv, ldz = lvz * l_inv;
    const float svx = lb_x - sox, svy = lb_y - soy, svz = lb_z - soz;
    const float t_light = sqrtf(dot3(svx, svy, svz, svx, svy, svz));
    const float diffuse =
        fminf(fmaxf(dot3(ldx, ldy, ldz, nx, ny, nz), 0.0f), 1.0f);
    bool vis = true;
    for (int i = 0; i < p.num_spheres; ++i) {
      if (i == li) continue;
      float det, tca, thc;
      sphere_hit(p.sph[i], sox, soy, soz, ldx, ldy, ldz, det, tca, thc);
      const float t_near = tca - thc, t_far = tca + thc;
      const float t = t_near > 0.0f ? t_near : t_far;
      if (det >= 0.0f && t > 0.0f && t < t_light) vis = false;
    }
    if (TAPED && !vis) tape.flags &= ~32;
    const float dl = diffuse * (vis ? 1.0f : 0.0f) * 0.5f;
    er = er + mr * dl * l.er * s.cr;
    eg = eg + mg * dl * l.eg * s.cg;
    eb = eb + mb * dl * l.eb * s.cb;
  }
  out.cr += er;
  out.cg += eg;
  out.cb += eb;
  mr *= s.cr;
  mg *= s.cg;
  mb *= s.cb;

  if (FIRST) {
    out.nx = nx;
    out.ny = ny;
    out.nz = nz;
    out.ar = s.cr;
    out.ag = s.cg;
    out.ab = s.cb;
    out.d = t_best;
    out.hit0 = true;
  }

  if (bounce + 1 < p.max_bounces) {
    constexpr uint32_t spb = GLOSSY ? 5u : 2u;
    const uint32_t slot = 2u + spb * (uint32_t)bounce;
    const float u1 = rng.draw(slot);
    const float u2 = rng.draw(slot + 1u);
    // Ortho basis ("combing coconuts", pathtrace.cu:121-124).
    const bool use_a = fabsf(nx) > fabsf(nz);
    float o1x = use_a ? -ny : 0.0f;
    float o1y = use_a ? nx : -nz;
    float o1z = use_a ? 0.0f : ny;
    const float o1_inv = rsqrtf(dot3(o1x, o1y, o1z, o1x, o1y, o1z) + 1e-20f);
    o1x *= o1_inv;
    o1y *= o1_inv;
    o1z *= o1_inv;
    const float o2x = ny * o1z - nz * o1y;
    const float o2y = nz * o1x - nx * o1z;
    const float o2z = nx * o1y - ny * o1x;
    const float phi = u1 * kTwoPi;
    const float zc = sqrtf(u2);  // power=1 cosine weighting
    const float sin_t = sqrtf(fmaxf(1.0f - zc * zc, 0.0f));
    const float cs = cosf(phi) * sin_t, ss = sinf(phi) * sin_t;
    if (TAPED) {
      tape.cs = cs;
      tape.ss = ss;
      tape.zc = zc;
    }
    float bdx = cs * o1x + ss * o2x + zc * nx;
    float bdy = cs * o1y + ss * o2y + zc * ny;
    float bdz = cs * o1z + ss * o2z + zc * nz;
    if (GLOSSY) {
      // The reference's makeshift glossy BRDF (pathtrace.cu:181-184).
      const float b_inv = rsqrtf(dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20f);
      bdx *= b_inv;
      bdy *= b_inv;
      bdz *= b_inv;
      const float dn2 = 2.0f * dot3(bdx, bdy, bdz, nx, ny, nz);
      bdx = bdx - dn2 * nx;
      bdy = bdy - dn2 * ny;
      bdz = bdz - dn2 * nz;
      const float jx = 0.01f * rng.draw(slot + 2u);
      const float jy = 0.01f * rng.draw(slot + 3u);
      const float jz = 0.01f * rng.draw(slot + 4u);
      if (TAPED) {
        tape.jx = jx;
        tape.jy = jy;
        tape.jz = jz;
      }
      bdx = bdx + jx - 0.005f;
      bdy = bdy + jy - 0.005f;
      bdz = bdz + jz - 0.005f;
      const float g_inv = rsqrtf(dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20f);
      bdx *= g_inv;
      bdy *= g_inv;
      bdz *= g_inv;
    }
    ox = hx + nx * p.push;
    oy = hy + ny * p.push;
    oz = hz + nz * p.push;
    dx = bdx;
    dy = bdy;
    dz = bdz;
  }
  return true;
}

// The same segment with its rows read from the kernel parameter.
template <bool FIRST, bool GLOSSY, bool NEE, bool TAPED>
__device__ __forceinline__ bool segment_taped(const TraceParams& p, const Rng& rng,
                                              int bounce, float& ox, float& oy,
                                              float& oz, float& dx, float& dy,
                                              float& dz, float& mr, float& mg,
                                              float& mb, Sample& out,
                                              int& hit_index, BounceTape& tape) {
  return segment_taped<FIRST, GLOSSY, NEE, TAPED>(p, p.sph, rng, bounce, ox, oy, oz, dx, dy,
                                                  dz, mr, mg, mb, out, hit_index, tape);
}

// Untaped, with the rows read by index from the block's `table`.
template <bool FIRST, bool GLOSSY, bool NEE>
__device__ __forceinline__ bool segment(const TraceParams& p, const Sphere* table,
                                        const Rng& rng, int bounce, float& ox, float& oy,
                                        float& oz, float& dx, float& dy, float& dz,
                                        float& mr, float& mg, float& mb, Sample& out,
                                        int& hit_index) {
  BounceTape unused;
  return segment_taped<FIRST, GLOSSY, NEE, false>(p, table, rng, bounce, ox, oy, oz, dx, dy,
                                                  dz, mr, mg, mb, out, hit_index, unused);
}

// Copies the N rows of p.sph into a block's shared `table` (10 floats a row:
// row i, field f at word 10 i + f; gcd(10, 32) = 2, so one field of the 16
// rows lies in 16 distinct banks). Every thread of the block calls it; the
// caller synchronises before the first read.
__device__ __forceinline__ void copy_sphere_table(const TraceParams& p, float* table, int tid,
                                                  int threads) {
  const float* src = &p.sph[0].rad;
  for (int k = tid; k < 10 * p.num_spheres; k += threads) table[k] = src[k];
}

// d clip(v, 0, 1) / dv with jnp.clip's tie-split at the boundary: 1 inside,
// 0 outside, 1/2 at 0 and at 1.
__device__ __forceinline__ float clip_grad(float v) {
  const float inside = (v >= 0.0f && v <= 1.0f) ? 1.0f : 0.0f;
  const float edge = (v == 0.0f || v == 1.0f) ? 1.0f : 0.0f;
  return inside - 0.5f * edge;
}

// out[k] = sum over blocks of partial[b][k], one block an output, in a
// fixed order: strided sums, then a shared-memory tree. T is the type the
// partials were summed in (float, or double where the sums cancel).
template <class T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ partial, int num_blocks, int n_out,
                float* __restrict__ out) {
  __shared__ T buf[kReduceThreads];
  const int k = blockIdx.x;
  T v = 0;
  for (int b = threadIdx.x; b < num_blocks; b += kReduceThreads) {
    v += partial[(size_t)b * n_out + k];
  }
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = (float)buf[0];
}

// Lane j's `v` within this thread's group of `lanes` neighbouring lanes
// (K1, K2: the sample lanes of a pixel); every lane of `mask` calls it. One
// lane is its own group: no shuffle.
template <class T>
__device__ __forceinline__ T lane_value(unsigned mask, T v, int j, int lanes) {
  return lanes == 1 ? v : __shfl_sync(mask, v, j, lanes);
}

// log2 of `lanes` if a K1 or K2 block of block x block pixels may take that
// many sample lanes (1, 2 or 4, at most kMaxThreads threads), else -1.
inline int lane_bits_of(int block, int lanes) {
  for (int b = 0; (1 << b) <= kMaxLanes; ++b) {
    if (lanes == (1 << b)) return (block * block) << b <= kMaxThreads ? b : -1;
  }
  return -1;
}

// What the card gives a launch of `fn` with `threads` threads and `smem`
// dynamic shared bytes a block: out[0] resident blocks an SM, out[1]
// registers a thread, out[2] = smem, out[3] local (stack) bytes a thread.
inline cudaError_t kernel_occupancy(const void* fn, int threads, int smem, int* out) {
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, threads, smem);
  out[1] = attr.numRegs;
  out[2] = smem;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace pt
