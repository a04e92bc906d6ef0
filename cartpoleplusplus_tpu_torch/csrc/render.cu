// Batched camera rendering of the cartpole++ scene: kernels K3, K4 and K5a
// for sm_90a.
//
// Replaces the Pallas TPU kernel _render_kernel of
// cartpoleplusplus_tpu/render/pallas_kernel.py in its two main-path cast
// modes, through both of its launches:
//   K3  make_render_repeats: every action repeat's frame from the pose
//       snapshots (R, E, 16) of the physics kernel, into (E, R, C*3*n);
//   K4  make_render_batched: one frame per env from its state, R = 1.
// The slab mode (RASTER = false) is the slab cascade with an approximate
// reciprocal, what the sampled configs (config 5) use; the raster mode
// (RASTER = true, K5a) is the projective inverse-depth rasterizer the exact
// configs use (render.prefer_raster).  One template serves both modes and
// both launches.
//
// What bounds it on this card: float32 operations per ray.  Each ray is
// cast against two oriented boxes, depth-ordered, shaded and pooled: on the
// order of a hundred float ops for the 5 bytes of output it contributes, so
// the kernel is far above the card's bytes-per-op ridge and bound by the
// float rate (config 5: 2 cameras x 2 sub-samples x 625 pooled pixels x 3
// repeats x 4096 envs = 30.7 M rays per step; 1-camera exact: 1 camera x 4
// sub-rays x 625 x 3 x 4096, the same 30.7 M).
//
// Design: one block per (env, repeat).  The per-env algebra of each box
// seen from each camera is computed once per block into shared memory by
// 2*C threads.  Threads then run over the pooled pixels of all cameras;
// each thread casts its pixel's p2 sub-rays, sums their four colour fields
// (cart shade, pole shade, ground value, sky mask) in registers, and writes
// three uint8 channels straight into the obs slab at width n: the TPU's
// 128-lane padding does not exist here.  Static per-ray rows (px, py,
// ground value, sky mask) are read coalesced from a (4, C, p2, n) table.
//
// Slab mode: the setup is the box-local eye, the direction coefficients
// A/B/C and the Lambert dots (15 floats per box and camera); per ray, three
// slab reciprocals with Hopper's rcp.approx (not Mosaic's), so it is held
// to the plain float32 version at the pixel tolerance, not bit for bit.
//
// Raster mode (K5a, the raster=True branch without hoist or mxu:
// pallas_kernel.py:240-247 setup, :296-297 casts, :311-312 ordering; math of
// raycast._obb_q_setup/_obb_q_cast).  The setup holds A, B, C, 1/U, 1/L,
// ahead, the Lambert candidates (3 each) and the eye-inside flag: 22 floats
// per box and camera.  1/U and 1/L are exact IEEE divisions (no rcp.approx,
// no fast math) after the sign-preserving clamp of L at 1e-7, and the
// near-plane bound is routed per env by `ahead` to the upper or the lower
// cascade, which keeps the eye-inside-slab case right.  Per ray the work is
// three affine plane evaluations, two scalings and min/max cascades: no
// division.  The raster setup and cast round every product and sum as
// written (__fmul_rn/__fadd_rn, which nvcc never contracts into an FMA), so
// the hit tests and depths follow the plain version's float32 arithmetic
// operation for operation; the shading epilogue, shared with the slab mode,
// keeps nvcc's FMA contraction and is held at the pixel tolerance.  The work is the same per
// ray as the slab mode's but cheaper (no reciprocals); p2 = 4 at obs_pool 2
// doubles the sub-rays a thread sums per pooled pixel.  Nothing is tuned
// yet: 256 threads over 625 pooled pixels leave the third pass of each
// block two-fifths full.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CAMS 2
#define SLAB_W 15    // o_l(3) A(3) B(3) C(3) ldot(3)
#define RASTER_W 22  // A(3) B(3) C(3) inv_u(3) inv_l(3) ahead(3) cand(3) inside(1)
#define BIG 1e9f

struct RenderParams {
  float basis[MAX_CAMS][9];  // fwd(3) right(3) up(3) per camera
  float eye[MAX_CAMS][3];
  float he[2][3];            // cart, pole half extents
  float light[3];
  float ambient;
  float diffuse;             // 1 - ambient
  float inv_p2;
  float cart_color[3];
  float pole_color[3];
  float sky_color[3];
  int num_cams;
  int p2;                    // sub-rays per pooled pixel
  int n;                     // pooled pixels per camera
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Per-env setup of one box seen from one camera for the slab mode
// (raycast._ray_obb_affine's scalar algebra).  pose: [pos(3) quat(4)] of the box.
__device__ void box_setup(const RenderParams& p, int cam, const float* pose, float* out) {
  const float w = pose[3], x = pose[4], y = pose[5], z = pose[6];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  float r[3][3];
  r[0][0] = 1.0f - 2.0f * (yy + zz);
  r[0][1] = 2.0f * (xy - wz);
  r[0][2] = 2.0f * (xz + wy);
  r[1][0] = 2.0f * (xy + wz);
  r[1][1] = 1.0f - 2.0f * (xx + zz);
  r[1][2] = 2.0f * (yz - wx);
  r[2][0] = 2.0f * (xz - wy);
  r[2][1] = 2.0f * (yz + wx);
  r[2][2] = 1.0f - 2.0f * (xx + yy);
  const float* fwd = p.basis[cam];
  const float* right = p.basis[cam] + 3;
  const float* up = p.basis[cam] + 6;
  float rel[3];
  for (int i = 0; i < 3; ++i) rel[i] = p.eye[cam][i] - pose[i];
  for (int k = 0; k < 3; ++k) {
    out[k] = r[0][k] * rel[0] + r[1][k] * rel[1] + r[2][k] * rel[2];
    out[3 + k] = r[0][k] * fwd[0] + r[1][k] * fwd[1] + r[2][k] * fwd[2];
    out[6 + k] = r[0][k] * right[0] + r[1][k] * right[1] + r[2][k] * right[2];
    out[9 + k] = r[0][k] * up[0] + r[1][k] * up[1] + r[2][k] * up[2];
    out[12 + k] = p.light[0] * r[0][k] + p.light[1] * r[1][k] + p.light[2] * r[2][k];
  }
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sign(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// Per-env setup of one box seen from one camera for the raster mode
// (raycast._obb_q_setup, rounded as the plain version rounds it).
// pose: [pos(3) quat(4)] of the box; he: its half extents.
__device__ void raster_setup(const RenderParams& p, int cam, const float* pose,
                             const float he[3], float* out) {
  const float w = pose[3], x = pose[4], y = pose[5], z = pose[6];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  float r[3][3];
  r[0][0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  r[0][1] = mul(2.0f, sub(xy, wz));
  r[0][2] = mul(2.0f, add(xz, wy));
  r[1][0] = mul(2.0f, add(xy, wz));
  r[1][1] = sub(1.0f, mul(2.0f, add(xx, zz)));
  r[1][2] = mul(2.0f, sub(yz, wx));
  r[2][0] = mul(2.0f, sub(xz, wy));
  r[2][1] = mul(2.0f, add(yz, wx));
  r[2][2] = sub(1.0f, mul(2.0f, add(xx, yy)));
  const float* fwd = p.basis[cam];
  const float* right = p.basis[cam] + 3;
  const float* up = p.basis[cam] + 6;
  float rel[3];
  for (int i = 0; i < 3; ++i) rel[i] = sub(pose[i], p.eye[cam][i]);
  bool any_ahead = false;
  for (int k = 0; k < 3; ++k) {
    const float g = add(add(mul(r[0][k], rel[0]), mul(r[1][k], rel[1])), mul(r[2][k], rel[2]));
    const float sg = sign(g);
    const float ga = mul(sg, g);
    float lo = sub(ga, he[k]);
    const float hi = add(ga, he[k]);
    const float sl = sign(lo);
    lo = mul(sl, fmaxf(mul(sl, lo), 1e-7f));
    const bool ahead = lo > 0.0f;
    any_ahead = any_ahead || ahead;
    out[k] = mul(sg, add(add(mul(r[0][k], fwd[0]), mul(r[1][k], fwd[1])), mul(r[2][k], fwd[2])));
    out[3 + k] =
        mul(sg, add(add(mul(r[0][k], right[0]), mul(r[1][k], right[1])), mul(r[2][k], right[2])));
    out[6 + k] = mul(sg, add(add(mul(r[0][k], up[0]), mul(r[1][k], up[1])), mul(r[2][k], up[2])));
    out[9 + k] = 1.0f / hi;   // exact division (nvcc's default -prec-div=true)
    out[12 + k] = 1.0f / lo;
    out[15 + k] = ahead ? 1.0f : 0.0f;
    out[18 + k] = mul(-sg, add(add(mul(p.light[0], r[0][k]), mul(p.light[1], r[1][k])),
                               mul(p.light[2], r[2][k])));
  }
  out[21] = any_ahead ? 0.0f : 1.0f;
}

// Raster cast of one ray (screen coords px, py) against one box: inverse
// depth q (larger is nearer, -BIG on a miss), Lambert value of the entry
// face, hit flag (raycast._obb_q_cast).
__device__ __forceinline__ void raster_cast(const float* su, float px, float py, float& q,
                                            float& lam, bool& hit) {
  float a[3], ub[3], lb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = add(add(su[k], mul(su[3 + k], px)), mul(su[6 + k], py));
    a[k] = mul(w, su[9 + k]);
    const float b = mul(w, su[12 + k]);
    const bool ahead = su[15 + k] > 0.5f;
    ub[k] = ahead ? b : BIG;
    lb[k] = ahead ? -BIG : b;
  }
  const float q_lo = fmaxf(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], lb[0])), fmaxf(lb[1], lb[2]));
  float q_hi = ub[0];
  lam = su[18];
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    lam = ub[k] < q_hi ? su[18 + k] : lam;
    q_hi = fminf(q_hi, ub[k]);
  }
  hit = q_hi >= fmaxf(q_lo, 1e-30f);
  q = hit ? (su[21] > 0.5f ? q_lo : q_hi) : -BIG;
}

// Slab cast of one ray (screen coords px, py) against one box: depth t
// (1e9 on a miss), Lambert value of the entry face, hit flag.
__device__ __forceinline__ void cast(const float* su, const float he[3], float px, float py,
                                     float& t, float& lam, bool& hit) {
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = su[3 + k] + su[6 + k] * px + su[9 + k] * py;
    const float s = 2.0f * (d >= 0.0f ? 1.0f : 0.0f) - 1.0f;
    const float inv = rcp_approx(d + s * 1e-9f);
    const float a = (-he[k] - su[k]) * inv;
    const float b = (he[k] - su[k]) * inv;
    const float lo = fminf(a, b), hi = fmaxf(a, b);
    const float cand = -s * su[12 + k];
    if (k == 0) {
      tmin = lo;
      tmax = hi;
      lam = cand;
    } else {
      lam = lo > tmin ? cand : lam;
      tmin = fmaxf(tmin, lo);
      tmax = fminf(tmax, hi);
    }
  }
  hit = (tmax >= tmin) && (tmax > 0.0f);
  t = hit ? (tmin > 0.0f ? tmin : tmax) : 1e9f;
}

// poses: (R, E, 16) [cart pos quat | pole pos quat | 0 0];
// rays: (4, C, p2, n) rows px, py, ground value, sky mask;
// out: (E, R, C*3*n) uint8.  Grid (E, R).
template <bool RASTER>
__global__ void __launch_bounds__(256) render_kernel(RenderParams p,
                                                    const float* __restrict__ poses,
                                                    const float* __restrict__ rays,
                                                    uint8_t* __restrict__ out, int E, int R) {
  constexpr int W = RASTER ? RASTER_W : SLAB_W;
  const int e = blockIdx.x, rep = blockIdx.y;
  __shared__ float setup[MAX_CAMS][2][W];
  const float* pose = poses + ((size_t)rep * E + e) * 16;
  if (threadIdx.x < 2 * p.num_cams) {
    const int cam = threadIdx.x >> 1, box = threadIdx.x & 1;
    if (RASTER) {
      raster_setup(p, cam, pose + 7 * box, p.he[box], setup[cam][box]);
    } else {
      box_setup(p, cam, pose + 7 * box, setup[cam][box]);
    }
  }
  __syncthreads();

  const int n = p.n, p2 = p.p2, cams = p.num_cams;
  const size_t plane = (size_t)cams * p2 * n;
  const int frame_w = cams * 3 * n;
  uint8_t* o = out + ((size_t)e * R + rep) * frame_w;
  for (int idx = threadIdx.x; idx < cams * n; idx += blockDim.x) {
    const int cam = idx / n, j = idx - cam * n;
    float fa = 0.0f, fb = 0.0f, fg = 0.0f, fs = 0.0f;
    for (int sidx = 0; sidx < p2; ++sidx) {
      const size_t off = ((size_t)cam * p2 + sidx) * n + j;
      const float px = rays[off], py = rays[plane + off];
      const float gval = rays[2 * plane + off], smask = rays[3 * plane + off];
      float dc, dp, lam_c, lam_p;
      bool hit_c, hit_p, sel_c;
      if (RASTER) {
        raster_cast(setup[cam][0], px, py, dc, lam_c, hit_c);
        raster_cast(setup[cam][1], px, py, dp, lam_p, hit_p);
        sel_c = hit_c && (dc >= dp);  // inverse depth: larger is nearer
      } else {
        cast(setup[cam][0], p.he[0], px, py, dc, lam_c, hit_c);
        cast(setup[cam][1], p.he[1], px, py, dp, lam_p, hit_p);
        sel_c = hit_c && (dc <= dp);
      }
      const bool sel_p = hit_p && !sel_c;
      const float lambert = fmaxf(sel_c ? lam_c : lam_p, 0.0f);
      const float shade = p.ambient + p.diffuse * lambert;
      const bool bg = !(sel_c || sel_p);
      fa = fa + (sel_c ? shade : 0.0f);
      fb = fb + (sel_p ? shade : 0.0f);
      fg = fg + (bg ? gval : 0.0f);
      fs = fs + (bg ? smask : 0.0f);
    }
    fa = fa * p.inv_p2;
    fb = fb * p.inv_p2;
    fg = fg * p.inv_p2;
    fs = fs * p.inv_p2;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c = p.cart_color[k] * fa + p.pole_color[k] * fb + fg + p.sky_color[k] * fs;
      const float q = floorf(fminf(fmaxf(c * 255.0f + 0.5f, 0.0f), 255.0f));
      o[(cam * 3 + k) * n + j] = static_cast<uint8_t>(q);
    }
  }
}

// Launches the slab (raster = 0) or raster (raster = 1) mode on `stream`;
// returns cudaGetLastError() as an int.
extern "C" int cp_render(const RenderParams* params, const float* poses, const float* rays,
                         uint8_t* out, int E, int R, int raster, void* stream) {
  if (params->num_cams < 1 || params->num_cams > MAX_CAMS) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(E, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (raster) {
    render_kernel<true><<<grid, 256, 0, st>>>(*params, poses, rays, out, E, R);
  } else {
    render_kernel<false><<<grid, 256, 0, st>>>(*params, poses, rays, out, E, R);
  }
  return static_cast<int>(cudaGetLastError());
}
