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
// The parameter block, the lattice and the path segment live in common.cuh,
// which the gradient kernels (grad_kernel.cu) share.
//
// Build (pathtrace_tpu_torch/ops/build.py does this at first use):
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

#include "common.cuh"

using namespace pt;

namespace {

constexpr float kLumaR = 0.2126f, kLumaG = 0.7152f, kLumaB = 0.0722f;

template <bool GLOSSY, bool NEE>
__device__ __forceinline__ Sample trace_sample(const TraceParams& p, const Rng& rng,
                               float rows, float cols) {
  Sample out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
  float dx, dy, dz;
  primary_ray(p, rng, rows, cols, dx, dy, dz);
  float ox = p.eye[0], oy = p.eye[1], oz = p.eye[2];
  float mr = 1.0f, mg = 1.0f, mb = 1.0f;
  int sel;

  if (p.max_bounces >= 1) {
    // An escaped path only carried masked no-ops in the Pallas kernel:
    // stopping here leaves every sum unchanged.
    if (!segment<true, GLOSSY, NEE>(p, rng, 0, ox, oy, oz, dx, dy, dz, mr, mg,
                                    mb, out, sel))
      return out;
    for (int bounce = 1; bounce < p.max_bounces; ++bounce) {
      if (!segment<false, GLOSSY, NEE>(p, rng, bounce, ox, oy, oz, dx, dy, dz,
                                       mr, mg, mb, out, sel))
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

  float rows, cols;
  Rng rng = pixel_rng<GLOSSY>(p, row, col, rows, cols);

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
  fill_params(p, scene, num_spheres, cam, seed);
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
