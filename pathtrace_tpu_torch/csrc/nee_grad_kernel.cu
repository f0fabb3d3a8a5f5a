// Hand-derived NEE diffuse gradient kernel for NVIDIA Hopper (sm_90a).
//
// Replaces pathtrace_tpu/ops/pallas_nee_grad.py::_nee_grad_kernel (K3): the
// gradient of a per-pixel colour loss with respect to ALL parameters of the
// NEE diffuse estimator: every sphere's radius, position, emission and
// albedo, the eye, and the four corner rays of the camera. Two modes:
//   FUSED:  loss + gradients of sum((mean - target)^2) and the mean colour
//           in one launch, in two loops over the samples of the thread's
//           own pixel: colour first, then the REPLAY sweep against
//           2 (mean - target) / spp. A thread owns its pixel, so it can do
//           this where a TPU tile, which carries the geometry cotangents as
//           coefficients of the unknown pixel cotangent through one
//           trajectory pass, could not;
//   REPLAY: gradients of sum(cotangent * colour sum) for a given per-pixel
//           cotangent.
//
// The estimator, the tape, the reverse sweep, the accumulators in shared
// memory and the fixed-order double-precision block sums are sweep.cuh's,
// shared with ad_grad_kernel.cu; this kernel is its <diffuse, NEE, colour
// cotangent only> instance with the two modes above.
//
// What bounds it: compute (scalar f32 chains, about 2,000 counted
// operations a segment), and occupancy through shared memory: with N = 9
// a thread holds 156 accumulator floats (39 KB at 64 threads: five blocks
// an SM).
//
// Built with the forward kernel's flags (-fmad=false, no fast math): the
// paths are the forward's, and the compiler may not simplify the Kahan
// term (t - s) - y.

#include "sweep.cuh"

using namespace pt;

namespace {

enum Mode { kFused = 0, kReplay = 1 };

// in_px: FUSED the target, REPLAY the cotangent (1/spp folded in), both
// [local_h, W, 3]. color: [local_h, W, 3] mean colour (FUSED only).
// partial: [blocks, 10N + 16] block sums.
template <int MODE>
__global__ void __launch_bounds__(kMaxBlock * kMaxBlock, 1)
nee_grad_kernel(const TraceParams p, const float* __restrict__ in_px,
                float* __restrict__ color, double* __restrict__ partial) {
  extern __shared__ float smem[];
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = row < p.local_h && col < p.width;
  const int n = p.num_spheres;
  const int n_geom = 4 * n + 15;
  const int n_slots = acc_slots(n);
  const Acc acc = {smem + tid, threads, 6 * n, n_geom};
  for (int k = 0; k < n_slots; ++k) acc.base[k * threads] = 0.0f;

  const size_t px = (size_t)row * p.width + col;
  float sum[3] = {0.0f, 0.0f, 0.0f};
  float g[3] = {0.0f, 0.0f, 0.0f};
  float loss = 0.0f;
  const float no_aov[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (inside) {
    float rows, cols;
    Rng rng = pixel_rng<false>(p, row, col, rows, cols);
    Sample out;
    BounceTape tape[kMaxBounces];
    int n_hit;
    if (MODE == kReplay) {
      g[0] = in_px[px * 3 + 0];
      g[1] = in_px[px * 3 + 1];
      g[2] = in_px[px * 3 + 2];
    }
    if (MODE == kFused) {
      // Pixel cotangent of sum((mean - target)^2); 1/denom is the caller's,
      // the spp average rides in g.
      for (int s = 0; s < p.spp; ++s) {
        rng.sample = p.sample_offset + (uint32_t)s;
        forward<false, true, false>(p, rng, rows, cols, out, tape, n_hit);
        sum[0] += out.cr;
        sum[1] += out.cg;
        sum[2] += out.cb;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float mean = sum[ch] * p.inv_spp;
        color[px * 3 + ch] = mean;
        const float res = mean - in_px[px * 3 + ch];
        loss += res * res;
        g[ch] = 2.0f * res * p.inv_spp;
      }
    }
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = p.sample_offset + (uint32_t)s;
      forward<false, true, true>(p, rng, rows, cols, out, tape, n_hit);
      reverse_sweep<false, true, false>(p, rng, rows, cols, tape, n_hit, g, no_aov, acc);
    }
  }
  // The compensation terms are spent: the first of their slots carries the loss.
  acc.base[(6 * n + n_geom) * threads] = loss;

  block_sums(smem, tid, threads, n, partial);
}

template <int MODE>
cudaError_t launch(const TraceParams& p, int block, const float* in_px,
                   float* color, double* partial, float* out, cudaStream_t stream) {
  const dim3 threads(block, block);
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  const int n_out = 10 * p.num_spheres + 16;
  const int smem = acc_slots(p.num_spheres) * block * block * (int)sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nee_grad_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  nee_grad_kernel<MODE><<<grid, threads, smem, stream>>>(p, in_px, color, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<double><<<n_out, kReduceThreads, 0, stream>>>(
      partial, (int)(grid.x * grid.y), n_out, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. scene [num_spheres, 10], cam [5, 3] and
// seed [5] are HOST arrays, as for pt_trace_launch. mode 0 FUSED (in_px the
// target; writes color, partial and out), 1 REPLAY (in_px the cotangent;
// writes partial and out). partial is a device buffer
// of ceil(W / block) * ceil(local_h / block) * (10N + 16) DOUBLES; out holds
// 10N + 16 floats: sphere i at 10 i (radius, position xyz, emission rgb,
// albedo rgb), the eye at 10N, the corner rays 00, 10, 01, 11 at 10N + 3,
// the loss (0 for REPLAY) at 10N + 15. Returns a cudaError_t: the launches', or
// cudaErrorInvalidValue for bad arguments (a block whose accumulators
// exceed 227 KB of shared memory among them).
extern "C" int pt_nee_grad_launch(const float* scene, int num_spheres,
                                  const float* cam, const uint32_t* seed,
                                  int local_h, int width, float inv_width,
                                  float inv_height, int spp, float inv_spp,
                                  int max_bounces, int jitter, float push,
                                  int light_index, int mode, int block,
                                  const float* in_px, float* color,
                                  double* partial, float* out, void* stream) {
  if (num_spheres < 1 || num_spheres > kMaxSpheres || local_h < 1 || width < 1 ||
      spp < 1 || max_bounces < 0 || max_bounces > kMaxBounces || block < 1 ||
      block > kMaxBlock || mode < kFused || mode > kReplay ||
      light_index < 0 || light_index >= num_spheres || in_px == nullptr ||
      (mode != kReplay && color == nullptr) || partial == nullptr ||
      out == nullptr) {
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
  if (mode == kFused) return (int)launch<kFused>(p, block, in_px, color, partial, out, s);
  return (int)launch<kReplay>(p, block, in_px, color, partial, out, s);
}
