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
// the forward's order, so it has the forward's bits. (Keeping each bounce's
// mask from the forward would hold 3 floats a bounce, up to 16 bounces, in
// local memory; the rebuild is 10 products a channel at 5 bounces, about 1%
// of a sample's operations.)
//
// What bounds it: compute, like the forward kernel (about 560 f32
// operations a segment plus sin/cos/sqrt; the reverse sweep adds ~40 a
// bounce). DUMP writes 6N + 3 floats a pixel once.
//
// What the design does about it:
//   * A pixel's samples are spread over L sample lanes, neighbouring threads
//     of one warp, as in the forward kernel (trace_kernel.cu; L from
//     trace_kernel.sample_lanes, at most grad_kernel.MAX_LANES = 2, as four
//     lanes' turns serialise more than they fill): the lanes run
//     their samples' forward passes side by side, take the round's colours
//     in sample order (__shfl_sync), then add their reverse sweeps into the
//     pixel's accumulators in turns, lowest sample first, a __syncwarp
//     between turns, every lane reaching every turn. Each accumulator takes
//     its adds in the thread-a-pixel order, so every output keeps its bits;
//     no atomics.
//   * The accumulators are indexed by a run-time sphere index, which would
//     put a 6N-float register array in local memory. They live in dynamic
//     shared memory instead, laid out [6N + 1][pixels of the block], so
//     pixel q's accumulator k sits at k * pixels + q: the lanes of a turn
//     touch consecutive words whatever their spheres, with no bank
//     conflicts. 9 spheres and 64 pixels take 14 KB.
//   * The sphere rows the sweep and the segment read by a per-lane index
//     (the winner's) are a copy in the same shared memory (common.cuh).
//   * The scene, camera and seed blocks are device arrays, as the TPU
//     kernels' scalar-prefetch operands are SMEM arrays (pallas_grad.py:
//     704-706, the same three for K5): the C entry point queues their copy
//     into this library's constant memory on the launch's stream
//     (common.cuh::c_blocks, stage_blocks), where the kernel reads them as
//     it read its by-value parameters. The launch never waits for the card,
//     and a captured launch reads new block contents when it is replayed.
//   * DUMP: the pixel's lanes split its 6N stores, lane j writing the
//     accumulators k = j, j + L, ... of its row of [h, W, 6N]. Staging the
//     block's accumulators as [pixels][6N + 1] and writing each pixel row
//     of the block as one contiguous run was measured and lost (0.1192 ms
//     against 0.1116 at 256x256x8, PERF.md PR 6): the 14 MB the dump writes
//     take ~4 us at the card's memory rate, and the staged copy doubled the
//     block's shared memory and added two barriers.
//   * No f32 atomics: on the TPU the sequential grid added every tile into
//     one block; here blocks run in no order, so each block writes its
//     partial [6N + 1] (the loss in the last slot) to its own row of a
//     [num_blocks, 6N + 1] buffer, and reduce_partials (common.cuh) sums the
//     rows in a fixed order. Two runs give the same bits.
//   * Pixels outside the image trace nothing and count for nothing.
//   * The dynamic shared memory is allowed once a process for each mode
//     (cudaFuncSetAttribute is a host call), not at every launch.
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

// Where a block's arrays lie in its dynamic shared memory, in floats: the
// accumulators [6N + 1][pixels] (pixel q's accumulator k at k * pixels + q;
// the loss in row 6N), then the sphere table [N][10].
struct GradLayout {
  int pixels, table_off, words;
  __host__ __device__ GradLayout(int n, int pixels_) : pixels(pixels_) {
    table_off = (6 * n + 1) * pixels;
    words = table_off + 10 * n;
  }
  __host__ __device__ int bytes() const { return 4 * words; }
};

// in_px: FUSED the target, REPLAY the cotangent (1/spp folded in), both
// [local_h, W, 3]. color: [local_h, W, 3] mean colour (FUSED, DUMP). acc:
// [local_h, W, 6N] spp-averaged accumulators (DUMP). partial: [blocks, 6N+1]
// block sums (FUSED, REPLAY). block: the block's edge in pixels; lane_bits:
// log2 of the sample lanes a pixel.
template <int MODE>
__global__ void __launch_bounds__(kMaxThreads, 1)
grad_kernel(const TraceParams p, int block, int lane_bits, const float* __restrict__ in_px,
            float* __restrict__ color, float* __restrict__ acc_out,
            float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const GradLayout lay(p.num_spheres, block * block);
  const int pixels = lay.pixels;
  const int lanes = 1 << lane_bits;
  const int lane = tid & (lanes - 1);
  const int q = tid >> lane_bits;
  const int col = blockIdx.x * block + q % block;
  const int row = blockIdx.y * block + q / block;
  const bool inside = row < p.local_h && col < p.width;
  const int n6 = 6 * p.num_spheres;
  float* acc = smem + q;  // this pixel's accumulator k is acc[k * pixels]
  for (int k = tid; k < lay.table_off; k += threads) smem[k] = 0.0f;
  copy_sphere_table(p, smem + lay.table_off, tid, threads);
  const Sphere* table = reinterpret_cast<const Sphere*>(smem + lay.table_off);
  __syncthreads();
  const unsigned mask = __activemask();  // the warp's threads, all of them here

  const size_t px = (size_t)row * p.width + col;
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;  // REPLAY: the pixel's cotangent
  if (MODE == kReplay && inside) {
    g_r = in_px[px * 3 + 0];
    g_g = in_px[px * 3 + 1];
    g_b = in_px[px * 3 + 2];
  }
  float rows, cols;
  Rng rng = pixel_rng<false>(p, row, col, rows, cols);
  for (int base = 0; base < p.spp; base += lanes) {
    // -- forward: the forward kernel's trajectory, its sphere indices taped
    Sample out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
    uint64_t tape = 0;
    int n_hit = 0;
    if (inside && base + lane < p.spp) {
      rng.sample = c_blocks.sample_offset + (uint32_t)(base + lane);
      float dx, dy, dz;
      primary_ray(p, rng, rows, cols, dx, dy, dz);
      float ox = c_blocks.eye[0], oy = c_blocks.eye[1], oz = c_blocks.eye[2];
      float mr = 1.0f, mg = 1.0f, mb = 1.0f;
      int sel;
      if (p.max_bounces >= 1 &&
          segment<true, false, false>(p, table, rng, 0, ox, oy, oz, dx, dy, dz, mr, mg, mb,
                                      out, sel)) {
        tape = (uint64_t)sel;
        n_hit = 1;
        for (int b = 1; b < p.max_bounces; ++b) {
          if (!segment<false, false, false>(p, table, rng, b, ox, oy, oz, dx, dy, dz, mr, mg,
                                            mb, out, sel))
            break;
          tape |= (uint64_t)sel << (4 * b);
          n_hit = b + 1;
        }
      }
    }
    // The round's colours in sample order, from the lanes that traced them.
    for (int j = 0; j < lanes && base + j < p.spp; ++j) {
      sum_r += lane_value(mask, out.cr, j, lanes);
      sum_g += lane_value(mask, out.cg, j, lanes);
      sum_b += lane_value(mask, out.cb, j, lanes);
    }

    // -- reverse sweeps over the hit bounces, one lane of each pixel at a
    //    time, lowest sample first (an escaped bounce and all after it add
    //    nothing and leave h / gbar as they are)
    for (int turn = 0; turn < lanes; ++turn) {
      if (lane == turn) {
        float h_r = 0.0f, h_g = 0.0f, h_b = 0.0f;
        for (int n = n_hit - 1; n >= 0; --n) {
          const Sphere& s = table[tape_index(tape, n)];
          float m_r = 1.0f, m_g = 1.0f, m_b = 1.0f;
          for (int k = 0; k < n; ++k) {
            const Sphere& sk = table[tape_index(tape, k)];
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
          float* a = acc + 6 * tape_index(tape, n) * pixels;
          if (MODE == kReplay) {
            a[0 * pixels] += m_r * g_r * cm_r;
            a[1 * pixels] += m_g * g_g * cm_g;
            a[2 * pixels] += m_b * g_b * cm_b;
            a[3 * pixels] += m_r * h_r;
            a[4 * pixels] += m_g * h_g;
            a[5 * pixels] += m_b * h_b;
            h_r = g_r * cm_r * s.er + s.cr * h_r;
            h_g = g_g * cm_g * s.eg + s.cg * h_g;
            h_b = g_b * cm_b * s.eb + s.cb * h_b;
          } else {
            a[0 * pixels] += m_r * cm_r;
            a[1 * pixels] += m_g * cm_g;
            a[2 * pixels] += m_b * cm_b;
            a[3 * pixels] += m_r * h_r;
            a[4 * pixels] += m_g * h_g;
            a[5 * pixels] += m_b * h_b;
            h_r = cm_r * s.er + s.cr * h_r;
            h_g = cm_g * s.eg + s.cg * h_g;
            h_b = cm_b * s.eb + s.cb * h_b;
          }
        }
      }
      __syncwarp(mask);
    }
  }

  const float inv_spp = p.inv_spp;
  const float mean[3] = {sum_r * inv_spp, sum_g * inv_spp, sum_b * inv_spp};
  if (MODE != kReplay && inside) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if ((c & (lanes - 1)) == lane) color[px * 3 + c] = mean[c];
    }
  }
  if (MODE == kDump) {
    // The last turn's __syncwarp made every lane's adds visible: the
    // pixel's lanes split its row of [local_h, W, 6N].
    if (inside) {
      float* o = acc_out + px * n6;
      for (int k = lane; k < n6; k += lanes) o[k] = acc[k * pixels] * inv_spp;
    }
    return;
  }
  if (MODE == kFused) {
    // Pixel cotangent of sum((mean - target)^2); the 1/denom is applied by
    // the caller, and the spp average rides in g (pallas_grad.py:611-629).
    float loss = 0.0f;
    if (inside) {
      const float res_r = mean[0] - in_px[px * 3 + 0];
      const float res_g = mean[1] - in_px[px * 3 + 1];
      const float res_b = mean[2] - in_px[px * 3 + 2];
      loss = res_r * res_r + res_g * res_g + res_b * res_b;
      g_r = 2.0f * res_r * inv_spp;
      g_g = 2.0f * res_g * inv_spp;
      g_b = 2.0f * res_b * inv_spp;
    }
    // The pixel's lanes share its column: lane j scales the triples j, j + L, ...
    for (int k = 3 * lane; k < n6; k += 3 * lanes) {
      acc[(k + 0) * pixels] = g_r * acc[(k + 0) * pixels];
      acc[(k + 1) * pixels] = g_g * acc[(k + 1) * pixels];
      acc[(k + 2) * pixels] = g_b * acc[(k + 2) * pixels];
    }
    if (lane == 0) acc[n6 * pixels] = loss;
  }

  // Block sums in a fixed order: thread k adds row k of the accumulators,
  // starting at column k so that the threads read distinct banks.
  __syncthreads();
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int k = tid; k <= n6; k += threads) {
    const float* r = smem + k * pixels;
    float v = 0.0f;
    for (int j = 0; j < pixels; ++j) {
      int t = j + k % pixels;
      if (t >= pixels) t -= pixels;
      v += r[t];
    }
    partial[blk * (n6 + 1) + k] = v;
  }
}

// The dynamic shared bytes a launch of each mode may take on each device,
// as last set: cudaFuncSetAttribute is a host call that costs as much as a
// small launch, so it is made once a process for each mode and device, and
// again only for a larger block (the occupancy hook sets it too).
constexpr int kMaxDevices = 64;
int g_allowed_bytes[kMaxDevices][3];

template <int MODE>
cudaError_t allow_shared(int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* allowed = dev < kMaxDevices ? &g_allowed_bytes[dev][MODE] : nullptr;
  if (allowed != nullptr && smem <= *allowed) return cudaSuccess;
  err = cudaFuncSetAttribute(grad_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && allowed != nullptr) *allowed = smem;
  return err;
}

template <int MODE>
cudaError_t launch(const TraceParams& p, int block, int lane_bits, int pad_shared,
                   const float* in_px, float* color, float* acc, float* partial, float* out,
                   cudaStream_t stream) {
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  const int n_out = 6 * p.num_spheres + 1;
  const int smem = GradLayout(p.num_spheres, block * block).bytes() + pad_shared;
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = allow_shared<MODE>(smem);
  if (err != cudaSuccess) return err;
  grad_kernel<MODE><<<grid, (block * block) << lane_bits, smem, stream>>>(
      p, block, lane_bits, in_px, color, acc, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == kDump) return err;
  reduce_partials<float><<<n_out, kReduceThreads, 0, stream>>>(
      partial, (int)(grid.x * grid.y), n_out, out);
  return cudaGetLastError();
}


const void* kernel_of(int mode) {
  return mode == kFused  ? (const void*)grad_kernel<kFused>
         : mode == kDump ? (const void*)grad_kernel<kDump>
                         : (const void*)grad_kernel<kReplay>;
}

}  // namespace

// A measurement hook: out[0] resident blocks an SM of a launch of `mode`
// with block x block pixels, `lanes` sample lanes and num_spheres spheres
// that asks for pad_shared dynamic shared bytes beyond its own, out[1]
// registers a thread, out[2] dynamic shared bytes a block, out[3] local
// (stack) bytes a thread.
extern "C" int pt_grad_occupancy(int mode, int block, int lanes, int num_spheres,
                                 int pad_shared, int* out) {
  const int lane_bits = lane_bits_of(block, lanes);
  if (mode < kFused || mode > kReplay || block < 1 || block > kMaxBlock || lane_bits < 0 ||
      num_spheres < 1 || num_spheres > kMaxSpheres || pad_shared < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = GradLayout(num_spheres, block * block).bytes() + pad_shared;
  const cudaError_t err =
      kernel_occupancy(kernel_of(mode), (block * block) << lane_bits, smem, out);
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices) g_allowed_bytes[dev][mode] = smem;
  return (int)err;
}

// C entry point, bound with ctypes. scene [num_spheres, 10], cam [5, 3] and
// seed [5] are DEVICE arrays, as for pt_trace_launch. mode 0 FUSED (in_px the
// target; writes color, partial and out), 1 DUMP (writes color and acc), 2
// REPLAY (in_px the cotangent; writes partial and out). partial is a device
// buffer of ceil(W / block) * ceil(local_h / block) * (6N + 1) floats; out
// holds 6N + 1 floats: d emission and d albedo of sphere i at 6i..6i+5, the
// loss (FUSED) at 6N. block is the edge of the block in pixels, lanes the
// sample lanes a pixel (1, 2 or 4, block^2 x lanes <= kMaxThreads). Returns a
// cudaError_t: the launches', or cudaErrorInvalidValue for bad arguments.
//
// pt_grad_launch_padded is the same launch asking for pad_shared dynamic
// shared bytes it does not use, so that fewer blocks fit an SM: the
// measurement behind the occupancy curve, and nothing else passes a pad.
extern "C" int pt_grad_launch_padded(const float* scene, int num_spheres,
                                     const float* cam, const uint32_t* seed,
                                     int local_h, int width, float inv_width,
                                     float inv_height, int spp, float inv_spp,
                                     int max_bounces, int jitter, float push, int mode,
                                     int block, int lanes, const float* in_px, float* color,
                                     float* acc, float* partial, float* out,
                                     void* stream, int pad_shared) {
  const bool needs_in = mode == kFused || mode == kReplay;
  const bool needs_color = mode == kFused || mode == kDump;
  const bool needs_sums = mode == kFused || mode == kReplay;
  const int lane_bits = lane_bits_of(block, lanes);
  TraceParams p;
  p.num_spheres = num_spheres;
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
  if (!valid_launch(scene, cam, seed, p) || max_bounces > kMaxBounces || block < 1 ||
      block > kMaxBlock || lane_bits < 0 || mode < kFused || mode > kReplay ||
      (needs_in && in_px == nullptr) || (needs_color && color == nullptr) ||
      (mode == kDump && acc == nullptr) ||
      (needs_sums && (partial == nullptr || out == nullptr)) || pad_shared < 0) {
    return (int)cudaErrorInvalidValue;
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(launch_lock());
  const cudaError_t err = stage_blocks(scene, num_spheres, cam, seed, s);
  if (err != cudaSuccess) return (int)err;
  switch (mode) {
    case kFused:
      return (int)launch<kFused>(p, block, lane_bits, pad_shared, in_px, color, acc, partial,
                                 out, s);
    case kDump:
      return (int)launch<kDump>(p, block, lane_bits, pad_shared, in_px, color, acc, partial,
                                out, s);
    default:
      return (int)launch<kReplay>(p, block, lane_bits, pad_shared, in_px, color, acc, partial,
                                  out, s);
  }
}

extern "C" int pt_grad_launch(const float* scene, int num_spheres, const float* cam,
                              const uint32_t* seed, int local_h, int width, float inv_width,
                              float inv_height, int spp, float inv_spp, int max_bounces,
                              int jitter, float push, int mode, int block, int lanes,
                              const float* in_px, float* color, float* acc, float* partial,
                              float* out, void* stream) {
  return pt_grad_launch_padded(scene, num_spheres, cam, seed, local_h, width, inv_width,
                               inv_height, spp, inv_spp, max_bounces, jitter, push, mode,
                               block, lanes, in_px, color, acc, partial, out, stream, 0);
}
