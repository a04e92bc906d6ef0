// Batched cartpole++ rigid-body physics: kernels K1 and K2 for sm_90a.
//
// Replaces the Pallas TPU kernels of cartpoleplusplus_tpu/physics/pallas_step.py:
//   K1  step_repeats_pallas  (_phys_repeats_kernel): repeats x substeps of
//       soa._substep with a pose snapshot after each repeat;
//   K2  step_substeps_pallas (_phys_kernel): num_substeps substeps, final
//       state only (the reset push).
// Both are one template here: K2 is K1 with one repeat and no pose output.
//
// What bounds it on this card: the latency of dependent float32 arithmetic.
// One substep is ~5.3 k float ops per env (contact manifold, 3 Jacobi sweeps
// over 16 slots, pose integration) against ~400 bytes per env step, so the
// bytes never bound it; and with one thread per env a 4096-env batch is 128
// warps on 132 SMs (one warp for every four schedulers), each thread running
// the whole chain with 255 registers and spills.
//
// Design: LANES = 4 lanes per env (eight envs per warp, 32 per block of
// 128), lane l owning contact slots l, l + 4, l + 8 and l + 12.  The
// manifold and each solver sweep are per slot: the sweeps are Jacobi sweeps
// (every slot reads the velocities from before the sweep; the bodies are
// updated after it), so a lane computes its slots' lever arms, effective
// masses, impulses and torques on its own, and the chain a lane runs per
// substep is the body algebra, four slots and the sums.  Slot q of every
// lane is of one kind (q = 0 cart on ground, 1-2 pole on ground, 3 pole on
// cart), so no warp diverges.  The body algebra (rotation matrices, world
// inertia, velocity updates, pose integration) is the same warp instruction
// for every lane of an env: each lane keeps the whole body state and
// computes it redundantly, which costs no more issue slots than one lane
// computing it and needs no broadcast.  Slot arrays shrink from 16 entries
// to 4 per thread: ptxas keeps everything in registers (about 128) with no
// spill.  A 4096-env batch is 512 warps, one per scheduler, each with about
// a quarter of the old chain.  With 8 or 16 lanes per env a warp serves
// fewer envs, and the body algebra's issue slots per env grew more than the
// shorter chains saved (PERF.md §6; scripts/compare_kernels_torch.py --lanes).
//
// Bit-equality with the one-thread kernel and with physics/soa.py:
// - every slot term is computed by the same expression as before, in the
//   same order, and the file is compiled with -fmad=false (kernels.py): the
//   pole's angular velocity about its long axis (inverse inertia 6e3)
//   amplifies one-ulp differences, and with contracted multiply-adds it
//   drifted past 1e-5 of the plain version within 30 substeps;
// - the sums over slots (imp_c0, imp_c1, imp_p, tau_c0, tau_c1, tau_p) are
//   gathered term by term with __shfl_sync and added by every lane as a left
//   fold in slot order 0..15, starting from 0.0f, as soa.py adds them; no
//   shuffle tree, which would reassociate;
// - the active-slot counts are popcounts of a ballot: they are sums of 0.0f
//   and 1.0f, integers below 2^24 that float32 adds exactly in any order.
// Ragged tails: a lane whose env index is past the batch takes the last env's
// state and runs every instruction with the rest of its warp, so each
// __shfl_sync and __ballot_sync sees all 32 lanes of the full mask; it stores
// nothing.  There is no early return.

#include <cuda_runtime.h>
#include <stdint.h>

struct PhysParams {
  float dt;
  float dt_inv_m0;   // dt * inv_mass[0]
  float inv_m0;
  float inv_m1;
  float g2;
  float dt_g0;       // dt * gravity[k]
  float dt_g1;
  float dt_g2;
  int tilted_gravity;
  int lin_damp;
  float lin_damp_factor;  // 1 - linear_damping
  int ang_damp;
  float ang_damp_factor;
  float cart_he[3];
  float pole_he[3];
  float top_x;       // cart half extent x + top-face margin
  float top_y;
  float top_band;    // band fraction * cart half extent z
  float iib_c[3];    // body-frame inverse inertia diagonals
  float iib_p[3];
  float mu_cg;
  float mu_pg;
  float mu_pc;
  float bias_scale;  // baumgarte / dt
  float slop;
  float half_dt;     // 0.5 * dt
  int solver_iterations;
};

struct Body {
  float pos[3];
  float quat[4];
  float vel[3];
  float ang[3];
};

__device__ __forceinline__ void q_to_mat(const float q[4], float m[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  m[0][0] = 1.0f - 2.0f * (yy + zz);
  m[0][1] = 2.0f * (xy - wz);
  m[0][2] = 2.0f * (xz + wy);
  m[1][0] = 2.0f * (xy + wz);
  m[1][1] = 1.0f - 2.0f * (xx + zz);
  m[1][2] = 2.0f * (yz - wx);
  m[2][0] = 2.0f * (xz - wy);
  m[2][1] = 2.0f * (yz + wx);
  m[2][2] = 1.0f - 2.0f * (xx + yy);
}

__device__ __forceinline__ void cross(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void m_vec(const float m[3][3], const float v[3], float o[3]) {
  o[0] = m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2];
  o[1] = m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2];
  o[2] = m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2];
}

// R diag(d) R^T.
__device__ __forceinline__ void inv_inertia_world(const float r[3][3], const float d[3],
                                                  float o[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[i][j] = r[i][0] * d[0] * r[j][0] + r[i][1] * d[1] * r[j][1] +
                r[i][2] * d[2] * r[j][2];
}

// Corner of a box: pos + sum over axes of +-(R column * half extent),
// accumulated axis by axis like soa.corners_world_mat.  Corner index bits:
// bit 1 -> +x, bit 0 -> +y, bit 2 -> +z (the reference's bottom-first order).
__device__ __forceinline__ void corner(const float pos[3], const float cols[3][3], int idx,
                                       float o[3]) {
  const bool sx = idx & 2, sy = idx & 1, sz = idx & 4;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float e = pos[j];
    e = sx ? e + cols[0][j] : e - cols[0][j];
    e = sy ? e + cols[1][j] : e - cols[1][j];
    e = sz ? e + cols[2][j] : e - cols[2][j];
    o[j] = e;
  }
}

__device__ __forceinline__ void q_integrate(float q[4], const float om[3], float half_dt) {
  const float ox = om[0], oy = om[1], oz = om[2];
  const float dw = 0.0f * q[0] - ox * q[1] - oy * q[2] - oz * q[3];
  const float dx = 0.0f * q[1] + ox * q[0] + oy * q[3] - oz * q[2];
  const float dy = 0.0f * q[2] - ox * q[3] + oy * q[0] + oz * q[1];
  const float dz = 0.0f * q[3] + ox * q[2] - oy * q[1] + oz * q[0];
  const float n0 = q[0] + half_dt * dw, n1 = q[1] + half_dt * dx;
  const float n2 = q[2] + half_dt * dy, n3 = q[3] + half_dt * dz;
  const float inv = 1.0f / sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3 + 1e-12f);
  q[0] = n0 * inv;
  q[1] = n1 * inv;
  q[2] = n2 * inv;
  q[3] = n3 * inv;
}

// Effective inverse mass of a pole-on-cart slot along direction d
// (body a = pole, body b = cart).
__device__ __forceinline__ float eff_inv_mass_p(const float d[3], const float r_p[3],
                                                const float r_b[3], const float iip[3][3],
                                                const float iic[3][3], float invm_p,
                                                float invm_c) {
  float rxd[3], ird[3], c[3];
  cross(r_p, d, rxd);
  m_vec(iip, rxd, ird);
  cross(ird, r_p, c);
  float k = invm_p + dot(d, c);
  cross(r_b, d, rxd);
  m_vec(iic, rxd, ird);
  cross(ird, r_b, c);
  k = k + (invm_c + dot(d, c));
  return 1.0f / k;
}

#define THREADS 128
#define LANES 4                 // lanes per env
#define SPL (16 / LANES)        // contact slots per lane: lane + q * LANES
#define FULL_MASK 0xffffffffu

// One lane's contact slot: lever arms from the pole or cart (ra) and from
// the cart (rb, pole-on-cart slots only), inverse effective masses, bias and
// accumulated impulses.
struct Slot {
  float ra[3], rb[3];
  float inv_kn, inv_kt1, inv_kt2, bias;
  float jn, jt1, jt2;
};

// One substep of one env; `lane` in [0, LANES) of the env's lanes.
__device__ void substep(const PhysParams& p, Body& cart, Body& pole, const float f[3], int lane) {
  // 1. integrate external forces into velocities
  float cv[3], pv[3], ca[3], pa[3];
  cv[0] = cart.vel[0] + p.dt_inv_m0 * f[0];
  cv[1] = cart.vel[1] + p.dt_inv_m0 * f[1];
  cv[2] = cart.vel[2] + p.dt * (p.g2 + p.inv_m0 * f[2]);
  pv[0] = pole.vel[0];
  pv[1] = pole.vel[1];
  pv[2] = pole.vel[2] + p.dt_g2;
  if (p.tilted_gravity) {
    cv[0] = cv[0] + p.dt_g0;
    cv[1] = cv[1] + p.dt_g1;
    pv[0] = pv[0] + p.dt_g0;
    pv[1] = pv[1] + p.dt_g1;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ca[k] = cart.ang[k];
    pa[k] = pole.ang[k];
  }
  if (p.lin_damp) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cv[k] = cv[k] * p.lin_damp_factor;
      pv[k] = pv[k] * p.lin_damp_factor;
    }
  }
  if (p.ang_damp) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ca[k] = ca[k] * p.ang_damp_factor;
      pa[k] = pa[k] * p.ang_damp_factor;
    }
  }

  // 2. contact manifold, this lane's slots: 0-3 cart corners vs ground,
  // 4-11 pole corners vs ground (world-axis frame), 12-15 pole bottom on
  // cart top.
  float rc[3][3], rp[3][3];
  q_to_mat(cart.quat, rc);
  q_to_mat(pole.quat, rp);
  float ccols[3][3], pcols[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ccols[k][j] = rc[j][k] * p.cart_he[k];
      pcols[k][j] = rp[j][k] * p.pole_he[k];
    }

  Slot sl[SPL];
  float act[SPL];
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = lane + q * LANES;
    float w[3], pen;
    if (s < 12) {
      const bool on_cart = s < 4;
      float bp[3], cols[3][3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        bp[j] = on_cart ? cart.pos[j] : pole.pos[j];
#pragma unroll
        for (int k = 0; k < 3; ++k) cols[k][j] = on_cart ? ccols[k][j] : pcols[k][j];
      }
      corner(bp, cols, on_cart ? s : s - 4, w);
      pen = -w[2];
      act[q] = pen > 0.0f ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sl[q].ra[j] = w[j] - bp[j];
        sl[q].rb[j] = 0.0f;
      }
    } else {
      float rel[3], ic[3];
      corner(pole.pos, pcols, s - 12, w);
#pragma unroll
      for (int j = 0; j < 3; ++j) rel[j] = w[j] - cart.pos[j];
#pragma unroll
      for (int k = 0; k < 3; ++k) ic[k] = rc[0][k] * rel[0] + rc[1][k] * rel[1] + rc[2][k] * rel[2];
      pen = p.cart_he[2] - ic[2];
      act[q] = (fabsf(ic[0]) <= p.top_x && fabsf(ic[1]) <= p.top_y && pen > 0.0f &&
                pen < p.top_band) ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sl[q].ra[j] = w[j] - pole.pos[j];
        sl[q].rb[j] = w[j] - cart.pos[j];
      }
    }
    sl[q].bias = p.bias_scale * fmaxf(pen - p.slop, 0.0f);
  }
  // Cart top-face normal (third column of R) and its tangent basis.
  const float n[3] = {rc[0][2], rc[1][2], rc[2][2]};
  float t1[3], t2[3];
  {
    const float s = 2.0f * (n[2] >= 0.0f ? 1.0f : 0.0f) - 1.0f;
    const float a = -1.0f / (s + n[2]);
    const float b = n[0] * n[1] * a;
    t1[0] = 1.0f + s * n[0] * n[0] * a;
    t1[1] = s * b;
    t1[2] = -s * n[0];
    t2[0] = b;
    t2[1] = s + n[1] * n[1] * a;
    t2[2] = -n[1];
  }

  // 3. mass-splitting Jacobi solve.  The active-slot counts: bit s of
  // `active` is slot s of this env.
  float iiw_c[3][3], iiw_p[3][3];
  inv_inertia_world(rc, p.iib_c, iiw_c);
  inv_inertia_world(rp, p.iib_p, iiw_p);
  const int group = (threadIdx.x & 31) & ~(LANES - 1);  // this env's first lane in the warp
  unsigned active = 0;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const unsigned vote = __ballot_sync(FULL_MASK, act[q] > 0.0f);
    active |= ((vote >> group) & ((1u << LANES) - 1)) << (q * LANES);
  }
  const float sum_cg = static_cast<float>(__popc(active & 0x000fu));
  const float sum_pg = static_cast<float>(__popc(active & 0x0ff0u));
  const float sum_pc = static_cast<float>(__popc(active & 0xf000u));
  const float cnt_cart = fmaxf(sum_cg + sum_pc, 1.0f);
  const float cnt_pole = fmaxf(sum_pg + sum_pc, 1.0f);
  const float invm_c = p.inv_m0 * cnt_cart;
  const float invm_p = p.inv_m1 * cnt_pole;
  float iic[3][3], iip[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      iic[i][j] = iiw_c[i][j] * cnt_cart;
      iip[i][j] = iiw_p[i][j] * cnt_pole;
    }

#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = lane + q * LANES;
    Slot& c = sl[q];
    if (s < 12) {
      const bool on_cart = s < 4;
      float ii[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) ii[i][j] = on_cart ? iic[i][j] : iip[i][j];
      const float invm = on_cart ? invm_c : invm_p;
      const float gx = c.ra[0], gy = c.ra[1], gz = c.ra[2];
      const float a0 = ii[0][0] * gy - ii[0][1] * gx;
      const float a1 = ii[1][0] * gy - ii[1][1] * gx;
      c.inv_kn = 1.0f / (invm + (a0 * gy - a1 * gx)) * act[q];
      const float b1 = ii[1][1] * gz - ii[1][2] * gy;
      const float b2 = ii[2][1] * gz - ii[2][2] * gy;
      c.inv_kt1 = 1.0f / (invm + (b1 * gz - b2 * gy)) * act[q];
      const float c2 = ii[2][2] * gx - ii[2][0] * gz;
      const float c0 = ii[0][2] * gx - ii[0][0] * gz;
      c.inv_kt2 = 1.0f / (invm + (c2 * gx - c0 * gz)) * act[q];
    } else {
      c.inv_kn = eff_inv_mass_p(n, c.ra, c.rb, iip, iic, invm_p, invm_c) * act[q];
      c.inv_kt1 = eff_inv_mass_p(t1, c.ra, c.rb, iip, iic, invm_p, invm_c) * act[q];
      c.inv_kt2 = eff_inv_mass_p(t2, c.ra, c.rb, iip, iic, invm_p, invm_c) * act[q];
    }
    c.jn = c.jt1 = c.jt2 = 0.0f;
  }

#pragma unroll 1
  for (int it = 0; it < p.solver_iterations; ++it) {
    // This lane's slots: impulse and torques from the velocities before the
    // sweep.
    float imp[SPL][3], tau[SPL][3], tb[SPL][3];
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int s = lane + q * LANES;
      Slot& c = sl[q];
      float w[3], v[3], vn, vt1, vt2, mu;
      if (s < 12) {
        const bool on_cart = s < 4;
        float va_lin[3], va_ang[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          va_lin[k] = on_cart ? cv[k] : pv[k];
          va_ang[k] = on_cart ? ca[k] : pa[k];
        }
        cross(va_ang, c.ra, w);
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = va_lin[k] + w[k];
        vn = v[2];
        vt1 = v[0];
        vt2 = v[1];
        mu = on_cart ? p.mu_cg : p.mu_pg;
      } else {
        float wb[3];
        cross(pa, c.ra, w);
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = pv[k] + w[k];
        cross(ca, c.rb, wb);
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = v[k] - (cv[k] + wb[k]);
        vn = dot(v, n);
        vt1 = dot(v, t1);
        vt2 = dot(v, t2);
        mu = p.mu_pc;
      }
      const float jn_new = fmaxf(c.jn + (c.bias - vn) * c.inv_kn, 0.0f);
      const float dn = jn_new - c.jn;
      const float bound = mu * jn_new;
      const float jt1_new = fminf(fmaxf(c.jt1 - vt1 * c.inv_kt1, -bound), bound);
      const float jt2_new = fminf(fmaxf(c.jt2 - vt2 * c.inv_kt2, -bound), bound);
      const float d1 = jt1_new - c.jt1;
      const float d2 = jt2_new - c.jt2;
      c.jn = jn_new;
      c.jt1 = jt1_new;
      c.jt2 = jt2_new;
      if (s < 12) {
        imp[q][0] = d1;
        imp[q][1] = d2;
        imp[q][2] = dn;
#pragma unroll
        for (int k = 0; k < 3; ++k) tb[q][k] = 0.0f;
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) imp[q][k] = dn * n[k] + d1 * t1[k] + d2 * t2[k];
        cross(c.rb, imp[q], tb[q]);
      }
      cross(c.ra, imp[q], tau[q]);
    }
    // The sums over slots, as a left fold in slot order 0..15: slot s lives
    // in lane s % LANES of this env, entry s / LANES.
    float imp_c0[3] = {0.0f, 0.0f, 0.0f};  // sum over slots 0-3
    float imp_c1[3] = {0.0f, 0.0f, 0.0f};  // sum over slots 12-15
    float imp_p[3] = {0.0f, 0.0f, 0.0f};   // sum over slots 4-15
    float tau_c0[3] = {0.0f, 0.0f, 0.0f};
    float tau_c1[3] = {0.0f, 0.0f, 0.0f};
    float tau_p[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int q = s / LANES, src = s % LANES;
      float im[3], ta[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        im[k] = __shfl_sync(FULL_MASK, imp[q][k], src, LANES);
        ta[k] = __shfl_sync(FULL_MASK, tau[q][k], src, LANES);
      }
      if (s < 4) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          imp_c0[k] = imp_c0[k] + im[k];
          tau_c0[k] = tau_c0[k] + ta[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          imp_p[k] = imp_p[k] + im[k];
          tau_p[k] = tau_p[k] + ta[k];
        }
      }
      if (s >= 12) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          imp_c1[k] = imp_c1[k] + im[k];
          tau_c1[k] = tau_c1[k] + __shfl_sync(FULL_MASK, tb[q][k], src, LANES);
        }
      }
    }
    float tc[3], dcv[3], dpv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cv[k] = cv[k] + (imp_c0[k] - imp_c1[k]) * p.inv_m0;
      pv[k] = pv[k] + imp_p[k] * p.inv_m1;
      tc[k] = tau_c0[k] - tau_c1[k];
    }
    m_vec(iiw_c, tc, dcv);
    m_vec(iiw_p, tau_p, dpv);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ca[k] = ca[k] + dcv[k];
      pa[k] = pa[k] + dpv[k];
    }
  }

  // 4. integrate pose
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cart.pos[k] = cart.pos[k] + cv[k] * p.dt;
    pole.pos[k] = pole.pos[k] + pv[k] * p.dt;
    cart.vel[k] = cv[k];
    pole.vel[k] = pv[k];
    cart.ang[k] = ca[k];
    pole.ang[k] = pa[k];
  }
  q_integrate(cart.quat, ca, p.half_dt);
  q_integrate(pole.quat, pa, p.half_dt);
}

__device__ __forceinline__ void load_body(Body& b, const float* __restrict__ s, int row0,
                                          int e, int E) {
#pragma unroll
  for (int k = 0; k < 3; ++k) b.pos[k] = s[(row0 + k) * E + e];
#pragma unroll
  for (int k = 0; k < 4; ++k) b.quat[k] = s[(row0 + 3 + k) * E + e];
#pragma unroll
  for (int k = 0; k < 3; ++k) b.vel[k] = s[(row0 + 7 + k) * E + e];
#pragma unroll
  for (int k = 0; k < 3; ++k) b.ang[k] = s[(row0 + 10 + k) * E + e];
}

__device__ __forceinline__ void store_body(const Body& b, float* __restrict__ s, int row0,
                                           int e, int E) {
#pragma unroll
  for (int k = 0; k < 3; ++k) s[(row0 + k) * E + e] = b.pos[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[(row0 + 3 + k) * E + e] = b.quat[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[(row0 + 7 + k) * E + e] = b.vel[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[(row0 + 10 + k) * E + e] = b.ang[k];
}

// state_in/state_out: (26, E) rows [cart pos quat vel ang | pole ...];
// force: (3, E); poses: (repeats, E, 16) or unused.  LANES threads per env;
// the env's first lane stores.
template <bool kPoses>
__global__ void __launch_bounds__(THREADS) phys_kernel(PhysParams p,
                                                      const float* __restrict__ state_in,
                                                      const float* __restrict__ force,
                                                      float* __restrict__ state_out,
                                                      float* __restrict__ poses, int E,
                                                      int repeats, int substeps) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  const bool store = g < E && lane == 0;
  const int e = g < E ? g : E - 1;  // past the batch: run the last env, store nothing
  Body cart, pole;
  load_body(cart, state_in, 0, e, E);
  load_body(pole, state_in, 13, e, E);
  const float f[3] = {force[e], force[E + e], force[2 * E + e]};
#pragma unroll 1
  for (int r = 0; r < repeats; ++r) {
#pragma unroll 1
    for (int k = 0; k < substeps; ++k) substep(p, cart, pole, f, lane);
    if (kPoses && store) {
      float4* o = reinterpret_cast<float4*>(poses + ((size_t)r * E + e) * 16);
      o[0] = make_float4(cart.pos[0], cart.pos[1], cart.pos[2], cart.quat[0]);
      o[1] = make_float4(cart.quat[1], cart.quat[2], cart.quat[3], pole.pos[0]);
      o[2] = make_float4(pole.pos[1], pole.pos[2], pole.quat[0], pole.quat[1]);
      o[3] = make_float4(pole.quat[2], pole.quat[3], 0.0f, 0.0f);
    }
  }
  if (store) {
    store_body(cart, state_out, 0, e, E);
    store_body(pole, state_out, 13, e, E);
  }
}

// Launches on `stream`; poses == nullptr selects the K2 form (no snapshots).
// poses must be 16-byte aligned (rows of 16 floats are stored as float4).
// Returns cudaGetLastError() as an int.
extern "C" int cp_physics_step(const PhysParams* params, const float* state_in,
                               const float* force, float* state_out, float* poses, int E,
                               int repeats, int substeps, void* stream) {
  const long long threads = (long long)E * LANES;
  const int blocks = static_cast<int>((threads + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (poses != nullptr) {
    phys_kernel<true><<<blocks, THREADS, 0, s>>>(*params, state_in, force, state_out, poses,
                                                 E, repeats, substeps);
  } else {
    phys_kernel<false><<<blocks, THREADS, 0, s>>>(*params, state_in, force, state_out,
                                                  nullptr, E, repeats, substeps);
  }
  return static_cast<int>(cudaGetLastError());
}
