// Forward path-trace kernel for NVIDIA Hopper (sm_90a).
//
// Replaces pathtrace_tpu/ops/pallas_trace.py::_pathtrace_kernel (per-sample
// body trace_tile_sample): the forward megakernel that turns a sphere scene
// and a camera into the 14-channel AOV buffer (colour, normal, albedo,
// depth means and four luminance variances), or into the 22 channels of
// mergeable partials (10 raw sums + Welford n/mean/M2 of four features), or
// into 3 channels of raw colour sums.
//
// What bounds it: compute. Each path segment costs about 500 f32 operations
// plus sin/cos/sqrt (9 sphere tests, the normal, the cosine bounce; NEE
// adds a shadow ray against 8 more spheres), and a pixel writes only 56
// bytes (14 channels) once, after all its samples. Nothing is read from
// device memory but the parameters.
//
// What the design does about it:
//   * One thread per pixel on a 2-D grid of square 2-D blocks, the layout
//     of the CUDA reference's pixel_kernel (pathtrace.cu:203-257). The spp
//     loop and the bounce loop run inside the thread and every running sum
//     stays in registers; the only store is the final channel vector,
//     channels-last [h, W, C]. The ragged edge is bounds-checked, nothing
//     is padded.
//   * Scene (N <= 16 spheres x 10 floats), camera (15 floats) and the seed
//     block travel in one by-value parameter struct: every thread of a warp
//     reads the same sphere at the same time, which the constant bank
//     broadcasts.
//   * A path stops at its first escape: from there on the Pallas kernel
//     only carried masked no-ops, so every sum is unchanged.
//   * Output mode, BRDF and NEE are template parameters, so each of the 12
//     variants compiles without the code it does not run.
//   * The first bounce (unnormalized primary ray, emission clamp, AOVs) is
//     peeled at compile time; the later bounces are one loop, because the
//     depth is a run-time flag.
//
// Random numbers: the counter-based lattice of pathtrace_tpu/rng.py, in
// uint32 arithmetic, so the kernel draws exactly the reference's uniforms.
// The arithmetic follows trace_tile_sample term for term (NDC as
// 2*c*(1/W)-1, rsqrt only for the primary ray, T_BIG = 1e6, the +1e-20
// guards) so that its results differ from the plain version only by
// rounding.
//
// Build (pathtrace_tpu_torch/ops/trace_kernel.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libtrace_kernel.so trace_kernel.cu
// No --use_fast_math: sqrtf and division stay IEEE-rounded and sinf/cosf
// stay full-range. -fmad=false: with nvcc's default FMA contraction, 1.1%
// of the pixels of a 4-spp NEE frame flipped a hit decision against the
// plain PyTorch version on an H100 (0.2% diffuse, 0.04% glossy); without
// contraction the kernel matched it bit for bit in all nine
// configuration x mode cases.
//
// Registers: the variants take up to 80-87 registers a thread, so a 32x32
// block would need more than an SM's 65,536 registers and fail to launch.
// The kernel is compiled with __launch_bounds__(kMaxBlock * kMaxBlock, 1):
// every block edge up to kMaxBlock = 16 then launches, and the entry point
// refuses larger ones (config.MAX_BLOCK on the Python side). The minimum of
// one block an SM matters: without it ptxas held four variants to 64
// registers and spilled 16-24 bytes; with it, 44-80 registers, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSpheres = 16;
constexpr int kMaxBlock = 16;  // largest block edge
constexpr float kTBig = 1.0e6f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kLumaR = 0.2126f, kLumaG = 0.7152f, kLumaB = 0.0722f;

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

struct Sample {
  float cr, cg, cb, nx, ny, nz, ar, ag, ab, d;
  bool hit0, active;
};

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

// One segment of the path: closest hit, shading, and (unless it is the
// last bounce) the next ray. Returns false when the ray escapes.
template <bool FIRST, bool GLOSSY, bool NEE>
__device__ __forceinline__ bool segment(const TraceParams& p, const Rng& rng,
                                        int bounce, float& ox, float& oy,
                                        float& oz, float& dx, float& dy,
                                        float& dz, float& mr, float& mg,
                                        float& mb, Sample& out) {
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
    }
  }
  if (sel < 0) return false;
  const Sphere& s = p.sph[sel];

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
    const Sphere& l = p.sph[li];
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
      bdx = bdx + 0.01f * rng.draw(slot + 2u) - 0.005f;
      bdy = bdy + 0.01f * rng.draw(slot + 3u) - 0.005f;
      bdz = bdz + 0.01f * rng.draw(slot + 4u) - 0.005f;
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

template <bool GLOSSY, bool NEE>
__device__ __forceinline__ Sample trace_sample(const TraceParams& p, const Rng& rng,
                               float rows, float cols) {
  Sample out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
  float r = rows, c = cols;
  if (p.jitter) {
    r = rows + (rng.draw(0u) - 0.5f);
    c = cols + (rng.draw(1u) - 0.5f);
  }
  const float ndc_x = 2.0f * c * p.inv_width - 1.0f;
  const float ndc_y = 1.0f - 2.0f * r * p.inv_height;
  const float u = (ndc_x + 1.0f) * 0.5f;
  const float v = (ndc_y + 1.0f) * 0.5f;
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float bottom = p.basis[0][k] * (1.0f - u) + p.basis[1][k] * u;
    const float top = p.basis[2][k] * (1.0f - u) + p.basis[3][k] * u;
    d[k] = bottom * (1.0f - v) + top * v;
  }
  float dx = d[0], dy = d[1], dz = d[2];
  float ox = p.eye[0], oy = p.eye[1], oz = p.eye[2];
  float mr = 1.0f, mg = 1.0f, mb = 1.0f;

  if (p.max_bounces >= 1) {
    // An escaped path only carried masked no-ops in the Pallas kernel:
    // stopping here leaves every sum unchanged.
    if (!segment<true, GLOSSY, NEE>(p, rng, 0, ox, oy, oz, dx, dy, dz, mr, mg,
                                    mb, out))
      return out;
    for (int bounce = 1; bounce < p.max_bounces; ++bounce) {
      if (!segment<false, GLOSSY, NEE>(p, rng, bounce, ox, oy, oz, dx, dy, dz,
                                       mr, mg, mb, out))
        return out;
    }
  }
  out.active = true;  // never escaped: counts in the colour variance
  return out;
}

struct Welford {
  float n, mean, m2;
  __device__ __forceinline__ void add(float x, bool include) {
    const float inc = include ? 1.0f : 0.0f;
    const float n_new = n + inc;
    const float delta = x - mean;
    mean = mean + (n_new > 0.0f ? inc * delta / fmaxf(n_new, 1.0f) : 0.0f);
    const float delta2 = x - mean;
    m2 = m2 + inc * delta * delta2;
    n = n_new;
  }
  __device__ __forceinline__ float var() const {
    return n >= 2.0f ? m2 / fmaxf(n - 1.0f, 1.0f) : 0.0f;
  }
};

template <int NCH, bool GLOSSY, bool NEE>
__global__ void __launch_bounds__(kMaxBlock * kMaxBlock, 1)
pathtrace_kernel(const TraceParams p, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= p.local_h || col >= p.width) return;

  // Keys from ABSOLUTE pixel coordinates: a slab at a row offset draws its
  // slice of the global lattice.
  const uint32_t row_i = (uint32_t)row + p.row_offset;
  const uint32_t col_i = (uint32_t)col + p.col_offset;
  const float rows = (float)(int32_t)row_i;
  const float cols = (float)(int32_t)col_i;
  Rng rng;
  rng.pix_key = mix32(row_i * kGold ^ col_i * kRow);
  rng.base_key = mix32((p.seed & 0x7FFFFFFFu) ^ mix32(p.frame * kFrame));
  rng.n_slots = 2u + (GLOSSY ? 5u : 2u) * (uint32_t)p.max_bounces;

  float sum[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  Welford w_c = {0.f, 0.f, 0.f}, w_n = {0.f, 0.f, 0.f};
  Welford w_a = {0.f, 0.f, 0.f}, w_d = {0.f, 0.f, 0.f};
  for (int s = 0; s < p.spp; ++s) {
    rng.sample = p.sample_offset + (uint32_t)s;
    const Sample o = trace_sample<GLOSSY, NEE>(p, rng, rows, cols);
    sum[0] += o.cr;
    sum[1] += o.cg;
    sum[2] += o.cb;
    if (NCH == 3) continue;
    sum[3] += o.nx;
    sum[4] += o.ny;
    sum[5] += o.nz;
    sum[6] += o.ar;
    sum[7] += o.ag;
    sum[8] += o.ab;
    sum[9] += o.d;
    w_c.add(kLumaR * o.cr + kLumaG * o.cg + kLumaB * o.cb, o.active);
    w_n.add(kLumaR * o.nx + kLumaG * o.ny + kLumaB * o.nz, o.hit0);
    w_a.add(kLumaR * o.ar + kLumaG * o.ag + kLumaB * o.ab, o.hit0);
    w_d.add(o.d, o.hit0);
  }

  float* px = out + ((size_t)row * p.width + col) * NCH;
  if (NCH == 3) {
    px[0] = sum[0];
    px[1] = sum[1];
    px[2] = sum[2];
  } else if (NCH == 22) {
#pragma unroll
    for (int k = 0; k < 10; ++k) px[k] = sum[k];
    px[10] = w_c.n;
    px[11] = w_c.mean;
    px[12] = w_c.m2;
    px[13] = w_n.n;
    px[14] = w_n.mean;
    px[15] = w_n.m2;
    px[16] = w_a.n;
    px[17] = w_a.mean;
    px[18] = w_a.m2;
    px[19] = w_d.n;
    px[20] = w_d.mean;
    px[21] = w_d.m2;
  } else {
#pragma unroll
    for (int k = 0; k < 10; ++k) px[k] = sum[k] * p.inv_spp;
    px[10] = w_c.var();
    px[11] = w_n.var();
    px[12] = w_a.var();
    px[13] = w_d.var();
  }
}

template <int NCH, bool GLOSSY, bool NEE>
cudaError_t launch(const TraceParams& p, int block, float* out,
                   cudaStream_t stream) {
  const dim3 threads(block, block);
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  pathtrace_kernel<NCH, GLOSSY, NEE><<<grid, threads, 0, stream>>>(p, out);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_mode(const TraceParams& p, bool glossy, bool nee, int block,
                        float* out, cudaStream_t stream) {
  if (glossy) {
    return nee ? launch<NCH, true, true>(p, block, out, stream)
               : launch<NCH, true, false>(p, block, out, stream);
  }
  return nee ? launch<NCH, false, true>(p, block, out, stream)
             : launch<NCH, false, false>(p, block, out, stream);
}

}  // namespace

// C entry point, bound with ctypes. scene [num_spheres, 10] (radius, pos
// xyz, emission rgb, colour rgb), cam [5, 3] (eye, corner rays 00, 10, 01,
// 11) and seed [5] (seed, frame, sample/row/col offsets) are HOST arrays;
// out is a device buffer of local_h * width * n_channels floats. Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for bad arguments.
// block is the edge of the square thread block, 1..kMaxBlock.
extern "C" int pt_trace_launch(const float* scene, int num_spheres,
                               const float* cam, const uint32_t* seed,
                               int local_h, int width, float inv_width,
                               float inv_height, int spp, float inv_spp,
                               int max_bounces, int jitter, float push,
                               int light_index, int glossy, int n_channels,
                               int block, float* out, void* stream) {
  const bool nee = light_index >= 0;
  if (num_spheres < 1 || num_spheres > kMaxSpheres || local_h < 1 ||
      width < 1 || spp < 1 || max_bounces < 0 || block < 1 || block > kMaxBlock ||
      (nee && light_index >= num_spheres) || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  TraceParams p;
  for (int i = 0; i < num_spheres; ++i) {
    const float* r = scene + 10 * i;
    p.sph[i] = Sphere{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9]};
  }
  for (int i = num_spheres; i < kMaxSpheres; ++i) {
    p.sph[i] = Sphere{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
  p.spp = spp;
  p.max_bounces = max_bounces;
  p.jitter = jitter;
  p.local_h = local_h;
  p.width = width;
  p.light_index = light_index;
  p.inv_width = inv_width;
  p.inv_height = inv_height;
  p.inv_spp = inv_spp;
  p.push = push;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_channels) {
    case 14: return (int)launch_mode<14>(p, glossy != 0, nee, block, out, s);
    case 22: return (int)launch_mode<22>(p, glossy != 0, nee, block, out, s);
    case 3: return (int)launch_mode<3>(p, glossy != 0, nee, block, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
