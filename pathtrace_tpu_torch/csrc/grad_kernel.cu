// Diffuse product-chain gradient kernels for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of pathtrace_tpu/ops/pallas_grad.py:
//   * _fused_loss_grad_kernel (K2), in its two modes:
//       FUSED: loss + d emission + d albedo of the mean-squared pixel loss
//              against a target, and the mean colour, in ONE trajectory pass;
//       DUMP:  the mean colour and the per-pixel, cotangent-free 6N
//              accumulators, contracted against any cotangent outside;
//   * _color_grad_kernel (K5), REPLAY: d emission + d albedo of
//     sum(cotangent * mean colour) for a given per-pixel cotangent.
//
// Under the diffuse, no-NEE estimator a path's radiance is a product chain
//     L = sum_n mask_n * e_{idx_n},   mask_{n+1} = mask_n * c_{idx_n}
// (e clamped to [0, 1] at bounce 0), so its gradient needs only the hit
// sphere of every bounce. Each sample's trajectory is retraced from the
// lattice with the forward kernel's own segment (common.cuh), the sphere
// index of every bounce is kept in a 64-bit tape (4 bits a bounce), and the
// reverse recurrence of pallas_grad.py:8-23 runs over it:
//     h_n = clamp'_n * e_n + c_n * h_{n+1}          (FUSED, DUMP)
//     A_e[idx_n] += mask_n * clamp'_n,  A_c[idx_n] += mask_n * h_{n+1}
//     gbar_n = g * clamp'_n * e_n + c_n * gbar_{n+1}   (REPLAY)
//     d e[idx_n] += mask_n * g * clamp'_n,  d c[idx_n] += mask_n * gbar_{n+1}
// clamp' is jnp.clip's subgradient: 1 inside, 0 outside, 0.5 on the
// boundary (pallas_grad.py:200-210); it is 1 after bounce 0. mask_n is
// rebuilt from the tape as the product of the albedos before bounce n, in
// the forward's order, so it has the forward's bits.
//
// What bounds it: compute, like the forward kernel (about 500 f32
// operations a segment plus sin/cos/sqrt; the reverse sweep adds ~40 a
// bounce). DUMP writes 6N + 3 floats a pixel once.
//
// What the design does about it:
//   * One thread per pixel on 2-D blocks, as the forward kernel; the spp
//     and bounce loops run in the thread, the trajectory in registers.
//   * The accumulators are indexed by a run-time sphere index, which would
//     put a 6N-float register array in local memory. They live in dynamic
//     shared memory instead, laid out [6N + 1][threads of the block], so
//     thread t's accumulator k sits at k * threads + t: the threads of a
//     warp touch 32 consecutive words whatever their spheres, with no bank
//     conflicts. 9 spheres and 256 threads take 56 KB.
//   * No f32 atomics: on the TPU the sequential grid added every tile into
//     one block; here blocks run in no order, so each block writes its
//     partial [6N + 1] (the loss in the last slot) to its own row of a
//     [num_blocks, 6N + 1] buffer, and reduce_partials (common.cuh) sums the
//     rows in a fixed order. Two runs give the same bits.
//   * Pixels outside the image trace nothing and count for nothing.
//
// Build (pathtrace_tpu_torch/ops/build.py does this at first use), with the
// forward kernel's flags, so that both retrace the same paths bit for bit:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libgrad_kernel.so grad_kernel.cu

#include "common.cuh"

using namespace pt;

namespace {

constexpr int kMaxBounces = 16;  // 4 bits a bounce in a 64-bit tape

enum Mode { kFused = 0, kDump = 1, kReplay = 2 };

__device__ __forceinline__ int tape_index(uint64_t tape, int n) {
  return (int)((tape >> (4 * n)) & 15u);
}

// in_px: FUSED the target, REPLAY the cotangent (1/spp folded in), both
// [local_h, W, 3]. color: [local_h, W, 3] mean colour (FUSED, DUMP). acc:
// [local_h, W, 6N] spp-averaged accumulators (DUMP). partial: [blocks, 6N+1]
// block sums (FUSED, REPLAY).
template <int MODE>
__global__ void __launch_bounds__(kMaxBlock * kMaxBlock, 1)
grad_kernel(const TraceParams p, const float* __restrict__ in_px,
            float* __restrict__ color, float* __restrict__ acc_out,
            float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = row < p.local_h && col < p.width;
  const int n6 = 6 * p.num_spheres;
  float* acc = smem + tid;  // this thread's accumulator k is acc[k * threads]
  for (int k = 0; k <= n6; ++k) acc[k * threads] = 0.0f;

  const size_t px = (size_t)row * p.width + col;
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;  // REPLAY: the pixel's cotangent
  if (inside) {
    if (MODE == kReplay) {
      g_r = in_px[px * 3 + 0];
      g_g = in_px[px * 3 + 1];
      g_b = in_px[px * 3 + 2];
    }
    float rows, cols;
    Rng rng = pixel_rng<false>(p, row, col, rows, cols);
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = p.sample_offset + (uint32_t)s;
      // -- forward: the forward kernel's trajectory, its sphere indices taped
      Sample out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
      float dx, dy, dz;
      primary_ray(p, rng, rows, cols, dx, dy, dz);
      float ox = p.eye[0], oy = p.eye[1], oz = p.eye[2];
      float mr = 1.0f, mg = 1.0f, mb = 1.0f;
      uint64_t tape = 0;
      int n_hit = 0;
      int sel;
      if (p.max_bounces >= 1 &&
          segment<true, false, false>(p, rng, 0, ox, oy, oz, dx, dy, dz, mr, mg,
                                      mb, out, sel)) {
        tape = (uint64_t)sel;
        n_hit = 1;
        for (int b = 1; b < p.max_bounces; ++b) {
          if (!segment<false, false, false>(p, rng, b, ox, oy, oz, dx, dy, dz, mr,
                                            mg, mb, out, sel))
            break;
          tape |= (uint64_t)sel << (4 * b);
          n_hit = b + 1;
        }
      }
      sum_r += out.cr;
      sum_g += out.cg;
      sum_b += out.cb;

      // -- reverse sweep over the hit bounces (an escaped bounce and all
      //    after it add nothing and leave h / gbar as they are)
      float h_r = 0.0f, h_g = 0.0f, h_b = 0.0f;
      for (int n = n_hit - 1; n >= 0; --n) {
        const Sphere& s = p.sph[tape_index(tape, n)];
        float m_r = 1.0f, m_g = 1.0f, m_b = 1.0f;
        for (int k = 0; k < n; ++k) {
          const Sphere& sk = p.sph[tape_index(tape, k)];
          m_r *= sk.cr;
          m_g *= sk.cg;
          m_b *= sk.cb;
        }
        float cm_r = 1.0f, cm_g = 1.0f, cm_b = 1.0f;
        if (n == 0) {
          cm_r = clip_grad(m_r * s.er);
          cm_g = clip_grad(m_g * s.eg);
          cm_b = clip_grad(m_b * s.eb);
        }
        float* a = acc + 6 * tape_index(tape, n) * threads;
        if (MODE == kReplay) {
          a[0 * threads] += m_r * g_r * cm_r;
          a[1 * threads] += m_g * g_g * cm_g;
          a[2 * threads] += m_b * g_b * cm_b;
          a[3 * threads] += m_r * h_r;
          a[4 * threads] += m_g * h_g;
          a[5 * threads] += m_b * h_b;
          h_r = g_r * cm_r * s.er + s.cr * h_r;
          h_g = g_g * cm_g * s.eg + s.cg * h_g;
          h_b = g_b * cm_b * s.eb + s.cb * h_b;
        } else {
          a[0 * threads] += m_r * cm_r;
          a[1 * threads] += m_g * cm_g;
          a[2 * threads] += m_b * cm_b;
          a[3 * threads] += m_r * h_r;
          a[4 * threads] += m_g * h_g;
          a[5 * threads] += m_b * h_b;
          h_r = cm_r * s.er + s.cr * h_r;
          h_g = cm_g * s.eg + s.cg * h_g;
          h_b = cm_b * s.eb + s.cb * h_b;
        }
      }
    }
  }

  const float inv_spp = p.inv_spp;
  const float mean_r = sum_r * inv_spp, mean_g = sum_g * inv_spp, mean_b = sum_b * inv_spp;
  if (MODE != kReplay && inside) {
    color[px * 3 + 0] = mean_r;
    color[px * 3 + 1] = mean_g;
    color[px * 3 + 2] = mean_b;
  }
  if (MODE == kDump) {
    if (inside) {
      float* o = acc_out + px * n6;
      for (int k = 0; k < n6; ++k) o[k] = acc[k * threads] * inv_spp;
    }
    return;
  }
  if (MODE == kFused) {
    // Pixel cotangent of sum((mean - target)^2); the 1/denom is applied by
    // the caller, and the spp average rides in g (pallas_grad.py:611-629).
    float loss = 0.0f;
    if (inside) {
      const float res_r = mean_r - in_px[px * 3 + 0];
      const float res_g = mean_g - in_px[px * 3 + 1];
      const float res_b = mean_b - in_px[px * 3 + 2];
      loss = res_r * res_r + res_g * res_g + res_b * res_b;
      g_r = 2.0f * res_r * inv_spp;
      g_g = 2.0f * res_g * inv_spp;
      g_b = 2.0f * res_b * inv_spp;
    }
    for (int k = 0; k < n6; k += 3) {
      acc[(k + 0) * threads] = g_r * acc[(k + 0) * threads];
      acc[(k + 1) * threads] = g_g * acc[(k + 1) * threads];
      acc[(k + 2) * threads] = g_b * acc[(k + 2) * threads];
    }
    acc[n6 * threads] = loss;
  }

  // Block sums in a fixed order: thread k adds row k of the accumulators,
  // starting at column k so that the threads read distinct banks.
  __syncthreads();
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int k = tid; k <= n6; k += threads) {
    const float* r = smem + k * threads;
    float v = 0.0f;
    for (int j = 0; j < threads; ++j) {
      int t = j + k % threads;
      if (t >= threads) t -= threads;
      v += r[t];
    }
    partial[block * (n6 + 1) + k] = v;
  }
}

template <int MODE>
cudaError_t launch(const TraceParams& p, int block, const float* in_px,
                   float* color, float* acc, float* partial, float* out,
                   cudaStream_t stream) {
  const dim3 threads(block, block);
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  const int n_out = 6 * p.num_spheres + 1;
  const int smem = n_out * block * block * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grad_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  grad_kernel<MODE><<<grid, threads, smem, stream>>>(p, in_px, color, acc, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == kDump) return err;
  reduce_partials<float><<<n_out, kReduceThreads, 0, stream>>>(
      partial, (int)(grid.x * grid.y), n_out, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. scene [num_spheres, 10], cam [5, 3] and
// seed [5] are HOST arrays, as for pt_trace_launch. mode 0 FUSED (in_px the
// target; writes color, partial and out), 1 DUMP (writes color and acc), 2
// REPLAY (in_px the cotangent; writes partial and out). partial is a device
// buffer of ceil(W / block) * ceil(local_h / block) * (6N + 1) floats; out
// holds 6N + 1 floats: d emission and d albedo of sphere i at 6i..6i+5, the
// loss (FUSED) at 6N. Returns a cudaError_t: the launches', or
// cudaErrorInvalidValue for bad arguments.
extern "C" int pt_grad_launch(const float* scene, int num_spheres,
                              const float* cam, const uint32_t* seed,
                              int local_h, int width, float inv_width,
                              float inv_height, int spp, float inv_spp,
                              int max_bounces, int jitter, float push, int mode,
                              int block, const float* in_px, float* color,
                              float* acc, float* partial, float* out,
                              void* stream) {
  const bool needs_in = mode == kFused || mode == kReplay;
  const bool needs_color = mode == kFused || mode == kDump;
  const bool needs_sums = mode == kFused || mode == kReplay;
  if (num_spheres < 1 || num_spheres > kMaxSpheres || local_h < 1 || width < 1 ||
      spp < 1 || max_bounces < 0 || max_bounces > kMaxBounces || block < 1 ||
      block > kMaxBlock || mode < kFused || mode > kReplay ||
      (needs_in && in_px == nullptr) || (needs_color && color == nullptr) ||
      (mode == kDump && acc == nullptr) ||
      (needs_sums && (partial == nullptr || out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  TraceParams p;
  fill_params(p, scene, num_spheres, cam, seed);
  p.spp = spp;
  p.max_bounces = max_bounces;
  p.jitter = jitter;
  p.local_h = local_h;
  p.width = width;
  p.light_index = -1;
  p.inv_width = inv_width;
  p.inv_height = inv_height;
  p.inv_spp = inv_spp;
  p.push = push;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFused: return (int)launch<kFused>(p, block, in_px, color, acc, partial, out, s);
    case kDump: return (int)launch<kDump>(p, block, in_px, color, acc, partial, out, s);
    default: return (int)launch<kReplay>(p, block, in_px, color, acc, partial, out, s);
  }
}
