// Batched cartpole++ rigid-body physics: kernels K1 and K2 for sm_90a.
//
// Replaces the Pallas TPU kernels of cartpoleplusplus_tpu/physics/pallas_step.py:
//   K1  step_repeats_pallas  (_phys_repeats_kernel): repeats x substeps of
//       soa._substep with a pose snapshot after each repeat;
//   K2  step_substeps_pallas (_phys_kernel): num_substeps substeps, final
//       state only (the reset push).
// Both are one template here: K2 is K1 with one repeat and no pose output.
//
// What bounds it on this card: dependent float32 arithmetic per env.  One
// substep is a few thousand float ops (contact manifold, 3 Jacobi sweeps
// over 16 slots, pose integration), all in a chain that cannot be split
// across threads, while the bytes moved per env step are ~400 (26 state
// floats in and out, 3 force floats, 16 pose floats per repeat).  At 4096
// envs the whole batch is 32 blocks of 128 threads: a quarter of the 132
// SMs, so the kernel is bound by the latency of one thread's chain, not by
// the card's float rate.  That is accepted for this first port.
//
// Design: one thread per env with the whole state in registers, read from
// and written to a plain (26, E) SoA layout so neighbouring threads touch
// neighbouring addresses (the TPU's (8, L) sublane tiling is not carried
// over).  Scene constants arrive by value in PhysParams, computed on the
// host in float32 exactly as the plain PyTorch version computes them.  The
// substep, repeat and solver loops are kept rolled (#pragma unroll 1) to
// bound compile time and code size; the 16-slot loops inside a sweep are
// unrolled so slot arrays can live in registers.  The expression order of
// every term follows physics/soa.py so results agree with it to rounding,
// and the file is compiled with -fmad=false (kernels.py): the pole's
// angular velocity about its long axis (inverse inertia 6e3) amplifies
// one-ulp differences, and with contracted multiply-adds it drifted past
// 1e-5 of the plain version within 30 substeps.

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

__device__ void substep(const PhysParams& p, Body& cart, Body& pole, const float f[3]) {
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

  // 2. contact manifold: slots 0-3 cart corners vs ground, 4-11 pole
  // corners vs ground (world-axis frame), 12-15 pole bottom on cart top.
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

  float r_a[16][3], pen[16], act[16];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float w[3];
    if (i < 4) {
      corner(cart.pos, ccols, i, w);
    } else {
      corner(pole.pos, pcols, i - 4, w);
    }
    const float* bp = i < 4 ? cart.pos : pole.pos;
    pen[i] = -w[2];
    act[i] = pen[i] > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) r_a[i][j] = w[j] - bp[j];
  }
  float r_b[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float w[3], rel[3], ic[3];
    corner(pole.pos, pcols, i, w);
#pragma unroll
    for (int j = 0; j < 3; ++j) rel[j] = w[j] - cart.pos[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) ic[k] = rc[0][k] * rel[0] + rc[1][k] * rel[1] + rc[2][k] * rel[2];
    const float pp = p.cart_he[2] - ic[2];
    pen[12 + i] = pp;
    act[12 + i] = (fabsf(ic[0]) <= p.top_x && fabsf(ic[1]) <= p.top_y && pp > 0.0f &&
                   pp < p.top_band) ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r_a[12 + i][j] = w[j] - pole.pos[j];
      r_b[i][j] = w[j] - cart.pos[j];
    }
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

  // 3. mass-splitting Jacobi solve.
  float iiw_c[3][3], iiw_p[3][3];
  inv_inertia_world(rc, p.iib_c, iiw_c);
  inv_inertia_world(rp, p.iib_p, iiw_p);
  float sum_cg = act[0] + act[1] + act[2] + act[3];
  float sum_pg = act[4];
#pragma unroll
  for (int i = 5; i < 12; ++i) sum_pg = sum_pg + act[i];
  const float sum_pc = act[12] + act[13] + act[14] + act[15];
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

  float inv_kn[16], inv_kt1[16], inv_kt2[16], bias[16];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const float(*ii)[3] = i < 4 ? iic : iip;
    const float invm = i < 4 ? invm_c : invm_p;
    const float gx = r_a[i][0], gy = r_a[i][1], gz = r_a[i][2];
    const float a0 = ii[0][0] * gy - ii[0][1] * gx;
    const float a1 = ii[1][0] * gy - ii[1][1] * gx;
    inv_kn[i] = 1.0f / (invm + (a0 * gy - a1 * gx)) * act[i];
    const float b1 = ii[1][1] * gz - ii[1][2] * gy;
    const float b2 = ii[2][1] * gz - ii[2][2] * gy;
    inv_kt1[i] = 1.0f / (invm + (b1 * gz - b2 * gy)) * act[i];
    const float c2 = ii[2][2] * gx - ii[2][0] * gz;
    const float c0 = ii[0][2] * gx - ii[0][0] * gz;
    inv_kt2[i] = 1.0f / (invm + (c2 * gx - c0 * gz)) * act[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 12 + i;
    inv_kn[s] = eff_inv_mass_p(n, r_a[s], r_b[i], iip, iic, invm_p, invm_c) * act[s];
    inv_kt1[s] = eff_inv_mass_p(t1, r_a[s], r_b[i], iip, iic, invm_p, invm_c) * act[s];
    inv_kt2[s] = eff_inv_mass_p(t2, r_a[s], r_b[i], iip, iic, invm_p, invm_c) * act[s];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) bias[i] = p.bias_scale * fmaxf(pen[i] - p.slop, 0.0f);

  float jn[16], jt1[16], jt2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) jn[i] = jt1[i] = jt2[i] = 0.0f;

#pragma unroll 1
  for (int it = 0; it < p.solver_iterations; ++it) {
    float imp_c0[3] = {0.0f, 0.0f, 0.0f};  // sum over slots 0-3
    float imp_c1[3] = {0.0f, 0.0f, 0.0f};  // sum over slots 12-15
    float imp_p[3] = {0.0f, 0.0f, 0.0f};   // sum over slots 4-15
    float tau_c0[3] = {0.0f, 0.0f, 0.0f};
    float tau_c1[3] = {0.0f, 0.0f, 0.0f};
    float tau_p[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool on_cart = i < 4;
      const float* va_lin = on_cart ? cv : pv;
      const float* va_ang = on_cart ? ca : pa;
      float w[3], v[3];
      cross(va_ang, r_a[i], w);
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = va_lin[k] + w[k];
      float vn, vt1, vt2;
      if (i < 12) {
        vn = v[2];
        vt1 = v[0];
        vt2 = v[1];
      } else {
        float wb[3];
        cross(ca, r_b[i - 12], wb);
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = v[k] - (cv[k] + wb[k]);
        vn = dot(v, n);
        vt1 = dot(v, t1);
        vt2 = dot(v, t2);
      }
      const float mu = i < 4 ? p.mu_cg : (i < 12 ? p.mu_pg : p.mu_pc);
      const float jn_new = fmaxf(jn[i] + (bias[i] - vn) * inv_kn[i], 0.0f);
      const float dn = jn_new - jn[i];
      const float bound = mu * jn_new;
      const float jt1_new = fminf(fmaxf(jt1[i] - vt1 * inv_kt1[i], -bound), bound);
      const float jt2_new = fminf(fmaxf(jt2[i] - vt2 * inv_kt2[i], -bound), bound);
      const float d1 = jt1_new - jt1[i];
      const float d2 = jt2_new - jt2[i];
      jn[i] = jn_new;
      jt1[i] = jt1_new;
      jt2[i] = jt2_new;
      float imp[3];
      if (i < 12) {
        imp[0] = d1;
        imp[1] = d2;
        imp[2] = dn;
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) imp[k] = dn * n[k] + d1 * t1[k] + d2 * t2[k];
      }
      float tau[3];
      cross(r_a[i], imp, tau);
      if (on_cart) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          imp_c0[k] = imp_c0[k] + imp[k];
          tau_c0[k] = tau_c0[k] + tau[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          imp_p[k] = imp_p[k] + imp[k];
          tau_p[k] = tau_p[k] + tau[k];
        }
      }
      if (i >= 12) {
        float tb[3];
        cross(r_b[i - 12], imp, tb);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          imp_c1[k] = imp_c1[k] + imp[k];
          tau_c1[k] = tau_c1[k] + tb[k];
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
// force: (3, E); poses: (repeats, E, 16) or unused.
template <bool kPoses>
__global__ void __launch_bounds__(128) phys_kernel(PhysParams p,
                                                  const float* __restrict__ state_in,
                                                  const float* __restrict__ force,
                                                  float* __restrict__ state_out,
                                                  float* __restrict__ poses, int E,
                                                  int repeats, int substeps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  Body cart, pole;
  load_body(cart, state_in, 0, e, E);
  load_body(pole, state_in, 13, e, E);
  const float f[3] = {force[e], force[E + e], force[2 * E + e]};
#pragma unroll 1
  for (int r = 0; r < repeats; ++r) {
#pragma unroll 1
    for (int k = 0; k < substeps; ++k) substep(p, cart, pole, f);
    if (kPoses) {
      float* o = poses + ((size_t)r * E + e) * 16;
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = cart.pos[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[3 + k] = cart.quat[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) o[7 + k] = pole.pos[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[10 + k] = pole.quat[k];
      o[14] = 0.0f;
      o[15] = 0.0f;
    }
  }
  store_body(cart, state_out, 0, e, E);
  store_body(pole, state_out, 13, e, E);
}

// Launches on `stream`; poses == nullptr selects the K2 form (no snapshots).
// Returns cudaGetLastError() as an int.
extern "C" int cp_physics_step(const PhysParams* params, const float* state_in,
                               const float* force, float* state_out, float* poses, int E,
                               int repeats, int substeps, void* stream) {
  const int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (poses != nullptr) {
    phys_kernel<true><<<blocks, threads, 0, s>>>(*params, state_in, force, state_out, poses,
                                                 E, repeats, substeps);
  } else {
    phys_kernel<false><<<blocks, threads, 0, s>>>(*params, state_in, force, state_out,
                                                  nullptr, E, repeats, substeps);
  }
  return static_cast<int>(cudaGetLastError());
}
