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
// Under NEE a sample's radiance is
//     C_ch = sum_n [ clamp_0?(mask_n e_n) + mask_n dl_n le_ch c_n ],
//     dl_n = 0.5 vis_n clamp(dot(ld_n, n_n), 0, 1),
// and the only continuous dependence on geometry is through dl_n. The
// argmin (which sphere, near or far root), the shadow visibility and the
// normal flip are detached decisions; the square-root chain of t is gated
// on det > 0; clamps use jnp.clip's subgradient (1/2 on the boundary).
//
// Per sample: the forward kernel's own segment (common.cuh, NEE on) traces
// the path and tapes, for each hit bounce, the incoming ray, t, and the
// decisions (32 bytes a bounce, at most kMaxBounces = 16: 512 bytes of
// local memory a thread). The reverse sweep recomputes everything else of a
// bounce (hit point, normal, flip, light direction, dl, the cosine frame,
// redrawing its uniforms from the counter-based lattice) with the
// segment's expressions, so it has the forward's bits, and runs
//   * the geometric chain: next ray (o', d') -> cosine frame -> normal;
//     NEE Lambert source -> normal, light direction -> hit point and the
//     light's bottom point (px, py - r, pz); normal -> hit point, centre;
//     h = o + d t -> o, d, t; the closed-form t chain (k_p, k_d, k_r) ->
//     centre, radius, o, d; at bounce 0 the inv_len chain of the
//     unnormalized primary ray; at the end o -> eye, d -> corner rays;
//   * the shading chain: the product-chain recurrence of grad_kernel.cu
//     plus the NEE terms; the light's emission gradient rides in the light
//     sphere's emission slot.
//
// Primary ray: the forward uses common.cuh's primary_ray (bottom/top
// lerps), so the paths are the forward kernel's bit for bit; the corner
// rays' cotangent weights are the lerps' exact derivatives (1-u)(1-v),
// u(1-v), (1-u)v, uv, which is how the TPU kernel blends the corners.
//
// What bounds it: compute (scalar f32 chains, about 2,000 counted
// operations a segment), and occupancy through shared memory.
//
// What the design does about it:
//   * One thread per pixel; spp and bounce loops in the thread.
//   * Accumulators are indexed by a run-time sphere index, so they live in
//     dynamic shared memory laid out [slot][thread] (no bank conflicts):
//     6N shading sums, then 4N + 15 geometry sums and as many Kahan
//     compensation terms. With N = 9 that is 156 floats a thread (39 KB at
//     64 threads: five blocks an SM).
//   * The geometry sums cancel heavily (walls of radius 1e5), so every
//     contribution is added with Kahan compensation across all samples of
//     the pixel.
//   * No f32 atomics. Each block sums its threads' values in a fixed order
//     in double precision into its own row of a [blocks, 10N + 16] buffer
//     and reduce_partials<double> sums the rows in a fixed order: the sums
//     over pixels cancel too, and the card has double-precision units.
//     Two launches give the same bits.
//
// Built with the forward kernel's flags (-fmad=false, no fast math): the
// paths are the forward's, and the compiler may not simplify the Kahan
// term (t - s) - y.

#include "common.cuh"

using namespace pt;

namespace {

constexpr int kMaxBounces = 16;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

enum Mode { kFused = 0, kReplay = 1 };

// This thread's accumulators in shared memory: slot k at base[k * threads].
struct Acc {
  float* base;
  int threads, n_shade, n_geom;
  __device__ __forceinline__ void shade(int k, float v) const {
    base[k * threads] += v;
  }
  // Geometry slot j: sphere i, parameter q (0 radius, 1..3 position) at
  // 4 i + q; eye axis a at 4N + a; corner c axis a at 4N + 3 + 3 c + a.
  // Kahan: the compensation term of slot j lies n_geom slots further on.
  __device__ __forceinline__ void geom(int j, float v) const {
    float* s = base + (n_shade + j) * threads;
    float* c = s + n_geom * threads;
    const float y = v - *c;
    const float t = *s + y;
    *c = (t - *s) - y;
    *s = t;
  }
};

// The reverse sweep of one sample over its n_hit taped bounces, against the
// sample's colour cotangent g.
__device__ __forceinline__ void reverse_sweep(const TraceParams& p, const Rng& rng,
                                              float rows, float cols,
                                              const BounceTape* tape, int n_hit,
                                              const float (&g)[3],
                                              const Acc& acc) {
  const int n4 = 4 * p.num_spheres;
  const int li = p.light_index;
  const Sphere& l = p.sph[li];
  const float lb_x = l.px, lb_y = l.py - l.rad, lb_z = l.pz;
  const float le[3] = {l.er, l.eg, l.eb};

  // cotangents of the NEXT ray's origin and direction
  float oh[3] = {0.0f, 0.0f, 0.0f}, dh[3] = {0.0f, 0.0f, 0.0f};
  float hb[3] = {0.0f, 0.0f, 0.0f};  // suffix derivative by the throughput

  for (int b = n_hit - 1; b >= 0; --b) {
    const BounceTape tp = tape[b];
    const int idx = tp.index();
    const Sphere& s = p.sph[idx];
    const bool first = b == 0;
    const float ox = tp.ox, oy = tp.oy, oz = tp.oz;
    const float dx = tp.dx, dy = tp.dy, dz = tp.dz;
    const float t_best = tp.t;

    // The throughput before this bounce, rebuilt in the forward's order.
    float m[3] = {1.0f, 1.0f, 1.0f};
    for (int k = 0; k < b; ++k) {
      const Sphere& sk = p.sph[tape[k].index()];
      m[0] *= sk.cr;
      m[1] *= sk.cg;
      m[2] *= sk.cb;
    }
    const float e[3] = {s.er, s.eg, s.eb};
    const float cc[3] = {s.cr, s.cg, s.cb};

    // -- the bounce again, with the segment's expressions (common.cuh)
    float dnx = dx, dny = dy, dnz = dz, inv_len = 1.0f;
    if (first) {
      inv_len = rsqrtf(dot3(dx, dy, dz, dx, dy, dz));
      dnx = dx * inv_len;
      dny = dy * inv_len;
      dnz = dz * inv_len;
    }
    const float hx = ox + dx * t_best;
    const float hy = oy + dy * t_best;
    const float hz = oz + dz * t_best;
    float nux = hx - s.px, nuy = hy - s.py, nuz = hz - s.pz;
    const float n_inv = rsqrtf(dot3(nux, nuy, nuz, nux, nuy, nuz) + 1e-20f);
    nux *= n_inv;
    nuy *= n_inv;
    nuz *= n_inv;
    const float flip = dot3(nux, nuy, nuz, dx, dy, dz) < 0.0f ? 1.0f : -1.0f;
    const float nx = nux * flip, ny = nuy * flip, nz = nuz * flip;
    const float lvx = lb_x - hx, lvy = lb_y - hy, lvz = lb_z - hz;
    const float l_inv = rsqrtf(dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20f);
    const float ldx = lvx * l_inv, ldy = lvy * l_inv, ldz = lvz * l_inv;
    const float dr = dot3(ldx, ldy, ldz, nx, ny, nz);
    const float diffuse = fminf(fmaxf(dr, 0.0f), 1.0f);
    const bool vis = tp.visible();
    const float dl = diffuse * (vis ? 1.0f : 0.0f) * 0.5f;
    // The detached factor of d(dl)/d(dr): vis * 0.5 * clamp'.
    const float dlw = (vis ? 0.5f : 0.0f) * clip_grad(dr);

    // cotangents of the hit point and the normal
    float hh[3] = {0.0f, 0.0f, 0.0f}, nh[3] = {0.0f, 0.0f, 0.0f};

    if (b + 1 < p.max_bounces) {
      // o' = h + n push; d' = cs o1 + ss o2 + zc n, o2 = n x o1,
      // o1 = normalize(use_a ? (-ny, nx, 0) : (0, -nz, ny)).
      const uint32_t slot = 2u + 2u * (uint32_t)b;
      const float u1 = rng.draw(slot);
      const float u2 = rng.draw(slot + 1u);
      const bool use_a = fabsf(nx) > fabsf(nz);
      float o1x = use_a ? -ny : 0.0f;
      float o1y = use_a ? nx : -nz;
      float o1z = use_a ? 0.0f : ny;
      const float o1_inv = rsqrtf(dot3(o1x, o1y, o1z, o1x, o1y, o1z) + 1e-20f);
      o1x *= o1_inv;
      o1y *= o1_inv;
      o1z *= o1_inv;
      const float phi = u1 * kTwoPi;
      const float zc = sqrtf(u2);
      const float sin_t = sqrtf(fmaxf(1.0f - zc * zc, 0.0f));
      const float cs = cosf(phi) * sin_t, ss = sinf(phi) * sin_t;
      const float ohx = oh[0], ohy = oh[1], ohz = oh[2];
      const float dhx = dh[0], dhy = dh[1], dhz = dh[2];
      hh[0] = ohx;
      hh[1] = ohy;
      hh[2] = ohz;
      nh[0] = p.push * ohx + zc * dhx;
      nh[1] = p.push * ohy + zc * dhy;
      nh[2] = p.push * ohz + zc * dhz;
      float t1x = cs * dhx, t1y = cs * dhy, t1z = cs * dhz;        // o1-hat
      const float t2x = ss * dhx, t2y = ss * dhy, t2z = ss * dhz;  // o2-hat
      // o2 = n x o1: n-hat += o1 x o2-hat; o1-hat += o2-hat x n.
      nh[0] += o1y * t2z - o1z * t2y;
      nh[1] += o1z * t2x - o1x * t2z;
      nh[2] += o1x * t2y - o1y * t2x;
      t1x += t2y * nz - t2z * ny;
      t1y += t2z * nx - t2x * nz;
      t1z += t2x * ny - t2y * nx;
      const float sd = o1x * t1x + o1y * t1y + o1z * t1z;
      const float p1x = o1_inv * (t1x - o1x * sd);
      const float p1y = o1_inv * (t1y - o1y * sd);
      const float p1z = o1_inv * (t1z - o1z * sd);
      nh[0] += use_a ? p1y : 0.0f;
      nh[1] += use_a ? -p1x : p1z;
      nh[2] += use_a ? 0.0f : -p1y;
    }

    // NEE Lambert source: wdr = dC/d(dr). dr = dot(ld, n), ld = lv l_inv,
    // lv = lb - h: the normalize pullback of wdr n collapses to wdr bv.
    const float wdr = dlw * (g[0] * m[0] * le[0] * cc[0] + g[1] * m[1] * le[1] * cc[1] +
                             g[2] * m[2] * le[2] * cc[2]);
    const float bvx = l_inv * (nx - ldx * dr);
    const float bvy = l_inv * (ny - ldy * dr);
    const float bvz = l_inv * (nz - ldz * dr);

    // The t chain of the winner: t_u = tca + sig sqrt(r^2 - |q|^2),
    // q = rel - tca dn; k_p = corr dn - a q (= -k_o), k_d = corr rel +
    // tca a q, k_r = a r, a = sig / thc (gated on det > 0), corr = 1 + a q.dn.
    const float relx = s.px - ox, rely = s.py - oy, relz = s.pz - oz;
    const float tca = dot3(relx, rely, relz, dnx, dny, dnz);
    const float qx = relx - tca * dnx;
    const float qy = rely - tca * dny;
    const float qz = relz - tca * dnz;
    const float det = s.rad * s.rad - dot3(qx, qy, qz, qx, qy, qz);
    const float inv_thc = det > 0.0f ? rsqrtf(det) : 0.0f;
    const float a_ = (tp.far_root() ? 1.0f : -1.0f) * inv_thc;
    const float ux = a_ * qx, uy = a_ * qy, uz = a_ * qz;
    const float corr = 1.0f + dot3(ux, uy, uz, dnx, dny, dnz);
    const float kpx = corr * dnx - ux;
    const float kpy = corr * dny - uy;
    const float kpz = corr * dnz - uz;
    const float kdx = corr * relx + tca * ux;
    const float kdy = corr * rely + tca * uy;
    const float kdz = corr * relz + tca * uz;
    const float kr = a_ * s.rad;
    const float t_u = first ? t_best / inv_len : t_best;
    const float il3 = inv_len * inv_len * inv_len;

    nh[0] += wdr * ldx;
    nh[1] += wdr * ldy;
    nh[2] += wdr * ldz;
    const float lhx = wdr * bvx, lhy = wdr * bvy, lhz = wdr * bvz;
    hh[0] -= lhx;
    hh[1] -= lhy;
    hh[2] -= lhz;
    // lb = (l.px, l.py - l.rad, l.pz)
    acc.geom(4 * li + 1, lhx);
    acc.geom(4 * li + 2, lhy);
    acc.geom(4 * li + 3, lhz);
    acc.geom(4 * li + 0, -lhy);

    // normal: n = flip (n_pre n_inv), n_pre = h - centre
    const float ax = flip * nh[0], ay = flip * nh[1], az = flip * nh[2];
    const float sd = nux * ax + nuy * ay + nuz * az;
    const float ppx = n_inv * (ax - nux * sd);
    const float ppy = n_inv * (ay - nuy * sd);
    const float ppz = n_inv * (az - nuz * sd);
    hh[0] += ppx;
    hh[1] += ppy;
    hh[2] += ppz;
    float phx = -ppx, phy = -ppy, phz = -ppz;  // the winner's centre

    // h = o + d t
    oh[0] = hh[0];
    oh[1] = hh[1];
    oh[2] = hh[2];
    dh[0] = t_best * hh[0];
    dh[1] = t_best * hh[1];
    dh[2] = t_best * hh[2];
    const float t_hat = dx * hh[0] + dy * hh[1] + dz * hh[2];

    // t = t_u inv_len (inv_len is 1 after the first bounce)
    const float tu_hat = first ? t_hat * inv_len : t_hat;
    const float r_hat = tu_hat * kr;
    phx += tu_hat * kpx;
    phy += tu_hat * kpy;
    phz += tu_hat * kpz;
    oh[0] -= tu_hat * kpx;
    oh[1] -= tu_hat * kpy;
    oh[2] -= tu_hat * kpz;
    const float nhx = tu_hat * kdx, nhy = tu_hat * kdy, nhz = tu_hat * kdz;
    if (first) {
      // dn = d inv_len; inv_len = rsqrt(d.d)
      float il_hat = t_hat * t_u;
      il_hat += dx * nhx + dy * nhy + dz * nhz;
      const float sdot = -il3 * il_hat;
      dh[0] += inv_len * nhx + sdot * dx;
      dh[1] += inv_len * nhy + sdot * dy;
      dh[2] += inv_len * nhz + sdot * dz;
    } else {
      dh[0] += nhx;
      dh[1] += nhy;
      dh[2] += nhz;
    }
    acc.geom(4 * idx + 0, r_hat);
    acc.geom(4 * idx + 1, phx);
    acc.geom(4 * idx + 2, phy);
    acc.geom(4 * idx + 3, phz);

    // -- shading: the product chain plus the NEE terms
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float cmv = first ? clip_grad(m[ch] * e[ch]) : 1.0f;
      const float src = dl * le[ch] + hb[ch];
      acc.shade(6 * idx + ch, g[ch] * (m[ch] * cmv));
      acc.shade(6 * idx + 3 + ch, g[ch] * (m[ch] * src));
      acc.shade(6 * li + ch, g[ch] * (m[ch] * dl * cc[ch]));  // the light's emission
      hb[ch] = cmv * e[ch] + src * cc[ch];
    }
  }

  // camera: o_0 is the eye; d_0 the bilinear blend of the corner rays
  float u, v;
  primary_uv(p, rng, rows, cols, u, v);
  const float w[4] = {(1.0f - u) * (1.0f - v), u * (1.0f - v), (1.0f - u) * v, u * v};
#pragma unroll
  for (int a = 0; a < 3; ++a) acc.geom(n4 + a, oh[a]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int a = 0; a < 3; ++a) acc.geom(n4 + 3 + 3 * c + a, w[c] * dh[a]);
  }
}

// One sample's forward path with NEE. TAPED: the hit bounces are taped and
// counted in n_hit. -> the sample's colour in out.
template <bool TAPED>
__device__ __forceinline__ void forward(const TraceParams& p, const Rng& rng,
                                        float rows, float cols, Sample& out,
                                        BounceTape* tape, int& n_hit) {
  out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
  float dx, dy, dz;
  primary_ray(p, rng, rows, cols, dx, dy, dz);
  float ox = p.eye[0], oy = p.eye[1], oz = p.eye[2];
  float mr = 1.0f, mg = 1.0f, mb = 1.0f;
  int sel;
  n_hit = 0;
  BounceTape unused;
  if (p.max_bounces >= 1 &&
      segment_taped<true, false, true, TAPED>(p, rng, 0, ox, oy, oz, dx, dy, dz, mr,
                                              mg, mb, out, sel,
                                              TAPED ? tape[0] : unused)) {
    n_hit = 1;
    for (int b = 1; b < p.max_bounces; ++b) {
      if (!segment_taped<false, false, true, TAPED>(p, rng, b, ox, oy, oz, dx, dy,
                                                    dz, mr, mg, mb, out, sel,
                                                    TAPED ? tape[b] : unused))
        break;
      n_hit = b + 1;
    }
  }
}

// The slot of output k (sphere i at 10 i: radius, position, emission,
// albedo; eye at 10N; corner rays at 10N + 3; loss at 10N + 15) among the
// accumulators after the epilogue.
__device__ __forceinline__ int output_slot(int k, int n) {
  const int n_shade = 6 * n;
  if (k < 10 * n) {
    const int i = k / 10, c = k % 10;
    return c < 4 ? n_shade + 4 * i + c : 6 * i + (c - 4);
  }
  if (k < 10 * n + 15) return n_shade + 4 * n + (k - 10 * n);
  return n_shade + 4 * n + 15;  // the first compensation slot
}

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
  const int n_slots = 6 * n + 2 * n_geom;
  const Acc acc = {smem + tid, threads, 6 * n, n_geom};
  for (int k = 0; k < n_slots; ++k) acc.base[k * threads] = 0.0f;

  const size_t px = (size_t)row * p.width + col;
  float sum[3] = {0.0f, 0.0f, 0.0f};
  float g[3] = {0.0f, 0.0f, 0.0f};
  float loss = 0.0f;
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
        forward<false>(p, rng, rows, cols, out, tape, n_hit);
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
      forward<true>(p, rng, rows, cols, out, tape, n_hit);
      reverse_sweep(p, rng, rows, cols, tape, n_hit, g, acc);
    }
  }
  // The compensation terms are spent: the first of their slots carries the loss.
  acc.base[(6 * n + n_geom) * threads] = loss;

  // Block sums in a fixed order, in double: thread k adds the row of output
  // k, starting at column k so that the threads read distinct banks.
  __syncthreads();
  const int n_out = 10 * n + 16;
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int k = tid; k < n_out; k += threads) {
    const float* r = smem + output_slot(k, n) * threads;
    double v = 0.0;
    for (int j = 0; j < threads; ++j) {
      int t = j + k % threads;
      if (t >= threads) t -= threads;
      v += (double)r[t];
    }
    partial[block * n_out + k] = v;
  }
}

template <int MODE>
cudaError_t launch(const TraceParams& p, int block, const float* in_px,
                   float* color, double* partial, float* out, cudaStream_t stream) {
  const dim3 threads(block, block);
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  const int n_out = 10 * p.num_spheres + 16;
  const int n_slots = 6 * p.num_spheres + 2 * (4 * p.num_spheres + 15);
  const int smem = n_slots * block * block * (int)sizeof(float);
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
