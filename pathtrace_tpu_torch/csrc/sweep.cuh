// The hand-derived reverse sweep that the all-parameter gradient kernels
// share: nee_grad_kernel.cu (NEE diffuse against a colour cotangent, fused
// or replay) and ad_grad_kernel.cu (any configuration against a 10-channel
// colour + bounce-0 AOV cotangent). One template, so that where the two
// kernels compute the same sums they compute them with the same bits.
//
// A sample's radiance is
//     C_ch = sum_n [ clamp_0?(mask_n e_n) + mask_n dl_n le_ch c_n ],
//     dl_n = 0.5 vis_n clamp(dot(ld_n, n_n), 0, 1)          (NEE only),
// and the bounce-0 AOVs are the flipped normal, the albedo and t of the
// first hit. The argmin (which sphere, near or far root), the shadow
// visibility, the normal flip and every random draw are detached decisions;
// the square-root chain of t is gated on det > 0; clamps use jnp.clip's
// subgradient (1/2 on the boundary).
//
// forward traces one sample with the forward kernel's own segment
// (common.cuh) and tapes, for each hit bounce, the incoming ray, t and the
// decisions (32 bytes a bounce, at most kMaxBounces = 16: 512 bytes of
// local memory a thread). reverse_sweep recomputes everything else of a
// bounce (hit point, normal, flip, light direction, dl, the cosine frame
// and, under GLOSSY, the reflection chain, redrawing its uniforms from the
// counter-based lattice) with the segment's expressions, so it has the
// forward's bits, and runs
//   * the geometric chain: next ray (o', d') -> [GLOSSY: renormalisation ->
//     jitter -> reflection about the normal -> renormalisation ->] cosine
//     frame -> normal; [NEE: Lambert source -> normal, light direction ->
//     hit point and the light's bottom point (px, py - r, pz);] [AOV, at
//     bounce 0: the normal's and the depth's own cotangents;] normal -> hit
//     point, centre; h = o + d t -> o, d, t; the closed-form t chain (k_p,
//     k_d, k_r) -> centre, radius, o, d; at bounce 0 the inv_len chain of
//     the unnormalized primary ray; at the end o -> eye, d -> corner rays;
//   * the shading chain: the product-chain recurrence of grad_kernel.cu
//     plus, under NEE, the light terms (the light's emission gradient rides
//     in the light sphere's emission slot) and, with AOV, the first hit's
//     albedo cotangent.
//
// Accumulators are indexed by a run-time sphere index, so they live in
// dynamic shared memory laid out [slot][thread] (no bank conflicts): 6N
// shading sums, then 4N + 15 geometry sums and as many Kahan compensation
// terms (the geometry sums cancel heavily: walls of radius 1e5). block_sums
// adds a block's threads in a fixed order in double precision into the
// block's row of a [blocks, 10N + 16] buffer, and reduce_partials<double>
// (common.cuh) sums the rows in a fixed order: no atomics, and two launches
// give the same bits.
//
// Built with the forward kernel's flags (-fmad=false, no fast math): the
// paths are the forward's, and the compiler may not simplify the Kahan
// term (t - s) - y.

#pragma once

#include "common.cuh"

namespace pt {

constexpr int kMaxBounces = 16;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

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

// Accumulator floats a thread for n spheres.
__host__ __device__ __forceinline__ int acc_slots(int n) {
  return 6 * n + 2 * (4 * n + 15);
}

// The reverse sweep of one sample over its n_hit taped bounces, against the
// sample's colour cotangent g and, with AOV, the cotangents of its bounce-0
// AOVs: aov[0..2] the (flipped) normal, aov[3..5] the albedo, aov[6] the
// depth. Without NEE p.light_index is not read.
template <bool GLOSSY, bool NEE, bool AOV>
__device__ __forceinline__ void reverse_sweep(const TraceParams& p, const Rng& rng,
                                              float rows, float cols,
                                              const BounceTape* tape, int n_hit,
                                              const float (&g)[3],
                                              const float (&aov)[7],
                                              const Acc& acc) {
  const int n4 = 4 * p.num_spheres;
  const int li = NEE ? p.light_index : 0;
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
    float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f, l_inv = 0.0f, dr = 0.0f, dl = 0.0f,
          dlw = 0.0f;
    if (NEE) {
      const float lvx = lb_x - hx, lvy = lb_y - hy, lvz = lb_z - hz;
      l_inv = rsqrtf(dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20f);
      ldx = lvx * l_inv;
      ldy = lvy * l_inv;
      ldz = lvz * l_inv;
      dr = dot3(ldx, ldy, ldz, nx, ny, nz);
      const float diffuse = fminf(fmaxf(dr, 0.0f), 1.0f);
      const bool vis = tp.visible();
      dl = diffuse * (vis ? 1.0f : 0.0f) * 0.5f;
      // The detached factor of d(dl)/d(dr): vis * 0.5 * clamp'.
      dlw = (vis ? 0.5f : 0.0f) * clip_grad(dr);
    }

    // cotangents of the hit point and the normal
    float hh[3] = {0.0f, 0.0f, 0.0f}, nh[3] = {0.0f, 0.0f, 0.0f};

    if (b + 1 < p.max_bounces) {
      // o' = h + n push; c = cs o1 + ss o2 + zc n, o2 = n x o1,
      // o1 = normalize(use_a ? (-ny, nx, 0) : (0, -nz, ny)); d' = c, or
      // under GLOSSY d' = normalize(reflect(normalize(c), n) + jitter).
      constexpr uint32_t spb = GLOSSY ? 5u : 2u;
      const uint32_t slot = 2u + spb * (uint32_t)b;
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
      // the cotangent of c
      float dhx = dh[0], dhy = dh[1], dhz = dh[2];
      hh[0] = ohx;
      hh[1] = ohy;
      hh[2] = ohz;
      nh[0] = p.push * ohx;
      nh[1] = p.push * ohy;
      nh[2] = p.push * ohz;
      if (GLOSSY) {
        const float o2x = ny * o1z - nz * o1y;
        const float o2y = nz * o1x - nx * o1z;
        const float o2z = nx * o1y - ny * o1x;
        const float cx = cs * o1x + ss * o2x + zc * nx;
        const float cy = cs * o1y + ss * o2y + zc * ny;
        const float cz = cs * o1z + ss * o2z + zc * nz;
        const float b_inv = rsqrtf(dot3(cx, cy, cz, cx, cy, cz) + 1e-20f);
        const float bx = cx * b_inv, by = cy * b_inv, bz = cz * b_inv;
        const float dn2 = 2.0f * dot3(bx, by, bz, nx, ny, nz);
        const float qx = bx - dn2 * nx + 0.01f * rng.draw(slot + 2u) - 0.005f;
        const float qy = by - dn2 * ny + 0.01f * rng.draw(slot + 3u) - 0.005f;
        const float qz = bz - dn2 * nz + 0.01f * rng.draw(slot + 4u) - 0.005f;
        const float g_inv = rsqrtf(dot3(qx, qy, qz, qx, qy, qz) + 1e-20f);
        // d' = q g_inv: q-hat = g_inv d'-hat - g_inv^3 (q . d'-hat) q; the
        // jitter is a constant, so this is the reflected ray's cotangent.
        const float qd = g_inv * g_inv * g_inv * dot3(qx, qy, qz, dhx, dhy, dhz);
        const float rhx = g_inv * dhx - qd * qx;
        const float rhy = g_inv * dhy - qd * qy;
        const float rhz = g_inv * dhz - qd * qz;
        // r = b - 2 (b . n) n: b-hat = r-hat - 2 (n . r-hat) n;
        // n-hat += -2 [(b . n) r-hat + (n . r-hat) b].
        const float nr2 = 2.0f * dot3(nx, ny, nz, rhx, rhy, rhz);
        const float bhx = rhx - nr2 * nx;
        const float bhy = rhy - nr2 * ny;
        const float bhz = rhz - nr2 * nz;
        nh[0] -= dn2 * rhx + nr2 * bx;
        nh[1] -= dn2 * rhy + nr2 * by;
        nh[2] -= dn2 * rhz + nr2 * bz;
        // b = c b_inv, as d' = q g_inv (the AD of the reference keeps this
        // projection of the already-unit c too).
        const float cd = b_inv * b_inv * b_inv * dot3(cx, cy, cz, bhx, bhy, bhz);
        dhx = b_inv * bhx - cd * cx;
        dhy = b_inv * bhy - cd * cy;
        dhz = b_inv * bhz - cd * cz;
      }
      nh[0] += zc * dhx;
      nh[1] += zc * dhy;
      nh[2] += zc * dhz;
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

    if (NEE) {
      // Lambert source: wdr = dC/d(dr). dr = dot(ld, n), ld = lv l_inv,
      // lv = lb - h: the normalize pullback of wdr n collapses to wdr bv.
      const float wdr = dlw * (g[0] * m[0] * le[0] * cc[0] + g[1] * m[1] * le[1] * cc[1] +
                               g[2] * m[2] * le[2] * cc[2]);
      const float bvx = l_inv * (nx - ldx * dr);
      const float bvy = l_inv * (ny - ldy * dr);
      const float bvz = l_inv * (nz - ldz * dr);
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
    }
    if (AOV && first) {  // the stored normal is the flipped one
      nh[0] += aov[0];
      nh[1] += aov[1];
      nh[2] += aov[2];
    }

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
    float t_hat = dx * hh[0] + dy * hh[1] + dz * hh[2];
    if (AOV && first) t_hat += aov[6];  // depth0 is t itself

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
      const float src = NEE ? dl * le[ch] + hb[ch] : hb[ch];
      acc.shade(6 * idx + ch, g[ch] * (m[ch] * cmv));
      acc.shade(6 * idx + 3 + ch, g[ch] * (m[ch] * src));
      if (NEE) acc.shade(6 * li + ch, g[ch] * (m[ch] * dl * cc[ch]));  // the light's emission
      if (AOV && first) acc.shade(6 * idx + 3 + ch, aov[3 + ch]);
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

// One sample's forward path. TAPED: the hit bounces are taped and counted
// in n_hit. -> the sample's colour in out.
template <bool GLOSSY, bool NEE, bool TAPED>
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
      segment_taped<true, GLOSSY, NEE, TAPED>(p, rng, 0, ox, oy, oz, dx, dy, dz, mr,
                                              mg, mb, out, sel,
                                              TAPED ? tape[0] : unused)) {
    n_hit = 1;
    for (int b = 1; b < p.max_bounces; ++b) {
      if (!segment_taped<false, GLOSSY, NEE, TAPED>(p, rng, b, ox, oy, oz, dx, dy,
                                                    dz, mr, mg, mb, out, sel,
                                                    TAPED ? tape[b] : unused))
        break;
      n_hit = b + 1;
    }
  }
}

// The slot of output k (sphere i at 10 i: radius, position, emission,
// albedo; eye at 10N; corner rays at 10N + 3; loss at 10N + 15) among the
// accumulators after the sweep.
__device__ __forceinline__ int output_slot(int k, int n) {
  const int n_shade = 6 * n;
  if (k < 10 * n) {
    const int i = k / 10, c = k % 10;
    return c < 4 ? n_shade + 4 * i + c : 6 * i + (c - 4);
  }
  if (k < 10 * n + 15) return n_shade + 4 * n + (k - 10 * n);
  return n_shade + 4 * n + 15;  // the first compensation slot
}

// After the last sweep of a block (the compensation terms are spent, and
// the first of their slots carries the thread's loss): the block's sums in
// a fixed order, in double, into its row of partial [blocks, 10N + 16].
// Thread k adds the row of output k, starting at column k so that the
// threads read distinct banks.
__device__ __forceinline__ void block_sums(const float* smem, int tid, int threads,
                                           int n, double* __restrict__ partial) {
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

}  // namespace pt
