// Batched camera rendering of the cartpole++ scene: kernels K3, K4 and
// K5a-K5d for sm_90a.
//
// Replaces the Pallas TPU kernel _render_kernel of
// cartpoleplusplus_tpu/render/pallas_kernel.py in each of its cast modes,
// through both of its launches:
//   K3  make_render_repeats: every action repeat's frame from the pose
//       snapshots (R, E, 16) of the physics kernel, into (E, R, C*3*n);
//   K4  make_render_batched: one frame per env from its state, R = 1.
// The slab mode (SLAB) is the slab cascade with an approximate reciprocal,
// what the sampled configs (config 5) use; the raster mode (RASTER, K5a) is
// the projective inverse-depth rasterizer the exact configs use
// (render.prefer_raster).  The other three modes are the JAX make_venv's
// flags: RATIO (K5b, render_recip=False), RASTER_HOIST (K5c,
// render_hoist=True) and MXU / MXU_HOIST (K5d, render_mxu=True).  One
// template serves SLAB, RASTER, RATIO and RASTER_HOIST; render_mxu_kernel
// serves K5d; pack_setups_kernel is K5c's setup pass.
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
//
// Ratio mode (K5b, recip=False: pallas_kernel.py:210,313-316; math of
// raycast._ray_obb_affine's division-free branch, raycast.py:260-285).  The
// slab bounds stay ratios n/p with p > 0 and are compared by
// cross-multiplying; the boxes are ordered by nc*dp <= np*dc.  Its setup
// (ratio_setup) and cast round every step as written, like the raster's, so
// the cross-multiplied compares flip no tie against the plain version: the
// mode is exact and free of division.  The slab setup box_setup and K3's
// instructions are left as they were.
//
// Hoisted raster (K5c, raster + hoist: pallas_kernel.py:111-161 packing,
// :226-237 reading, :393-409 and :489-499 launches).  pack_setups_kernel
// runs raster_setup once per (repeat, env, camera, box), one thread each,
// into a packed (R, E, C*2*22) table; the raster kernel then copies its
// env's row into shared memory in place of computing it.  Same function,
// same rounding: the frames are byte-equal to K5a's.  A render is two
// launches.
//
// Bound planes on the tensor cores (K5d, raster + mxu:
// pallas_kernel.py:248-295).  The 18 routed bound planes of both boxes
// (a, ub, lb for 3 axes) are affine in (px, py, 1) with per-env
// coefficients; the `ahead` routing folds into them (a scale on the px/py
// columns, a +-BIG bias on the ones column).  Per camera the block builds
// that (18, 8) left-hand side in shared memory, padded to two m16 tiles of
// 32 rows; each warp takes 32 pooled pixels, and per sub-ray multiplies it
// by four n8 tiles of rays (rows px, py, gval, smask, 1, 0, 0, 0; the ones
// row is built in registers) with mma.sync m16n8k8 TF32.  TF32 keeps ~10
// mantissa bits, so each operand is split into a TF32 high part and a TF32
// residual, and hi*hi + hi*lo + lo*hi is accumulated in f32 (3xTF32, what
// Precision.HIGHEST means on the TPU); lo*lo is dropped.  The accumulator's
// rows and rays are spread over the lanes, so each 32x8 tile is staged in
// shared memory before a lane reads its ray's 18 bounds, then runs K5a's
// min/max cascade.  The bounds differ from K5a's by a few ulp (another
// rounding order), so frames may differ on silhouette ties.  Where `ahead`
// is 0 the bias 1e9 splits exactly (its residual fits in TF32), so ub is
// exactly BIG there, as in K5a.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CAMS 2
#define SLAB_W 15    // o_l(3) A(3) B(3) C(3) ldot(3)
#define RASTER_W 22  // A(3) B(3) C(3) inv_u(3) inv_l(3) ahead(3) cand(3) inside(1)
#define BIG 1e9f
#define MXU_ROWS 32  // 18 bound planes padded to two m16 tiles
#define STAGE_LD 40  // row stride (floats) of a warp's staged 18 x 32 bounds
#define THREADS 256

enum Mode { SLAB = 0, RASTER = 1, RATIO = 2, RASTER_HOIST = 3, MXU = 4, MXU_HOIST = 5 };

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

// Rotation matrix of the quaternion pose[3..6] (soa.q_to_mat), rounded as
// the plain version rounds it.
__device__ __forceinline__ void rot_rn(const float* pose, float r[3][3]) {
  const float w = pose[3], x = pose[4], y = pose[5], z = pose[6];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  r[0][0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  r[0][1] = mul(2.0f, sub(xy, wz));
  r[0][2] = mul(2.0f, add(xz, wy));
  r[1][0] = mul(2.0f, add(xy, wz));
  r[1][1] = sub(1.0f, mul(2.0f, add(xx, zz)));
  r[1][2] = mul(2.0f, sub(yz, wx));
  r[2][0] = mul(2.0f, sub(xz, wy));
  r[2][1] = mul(2.0f, add(yz, wx));
  r[2][2] = sub(1.0f, mul(2.0f, add(xx, yy)));
}

// Column k of r dotted with v: r[0][k]*v[0] + r[1][k]*v[1] + r[2][k]*v[2],
// rounded as written.
__device__ __forceinline__ float dot_col(const float r[3][3], int k, const float* v) {
  return add(add(mul(r[0][k], v[0]), mul(r[1][k], v[1])), mul(r[2][k], v[2]));
}

// Per-env setup of one box seen from one camera for the raster mode
// (raycast._obb_q_setup, rounded as the plain version rounds it).
// pose: [pos(3) quat(4)] of the box; he: its half extents.
__device__ void raster_setup(const RenderParams& p, int cam, const float* pose,
                             const float he[3], float* out) {
  float r[3][3];
  rot_rn(pose, r);
  const float* fwd = p.basis[cam];
  const float* right = p.basis[cam] + 3;
  const float* up = p.basis[cam] + 6;
  float rel[3];
  for (int i = 0; i < 3; ++i) rel[i] = sub(pose[i], p.eye[cam][i]);
  bool any_ahead = false;
  for (int k = 0; k < 3; ++k) {
    const float g = dot_col(r, k, rel);
    const float sg = sign(g);
    const float ga = mul(sg, g);
    float lo = sub(ga, he[k]);
    const float hi = add(ga, he[k]);
    const float sl = sign(lo);
    lo = mul(sl, fmaxf(mul(sl, lo), 1e-7f));
    const bool ahead = lo > 0.0f;
    any_ahead = any_ahead || ahead;
    out[k] = mul(sg, dot_col(r, k, fwd));
    out[3 + k] = mul(sg, dot_col(r, k, right));
    out[6 + k] = mul(sg, dot_col(r, k, up));
    out[9 + k] = 1.0f / hi;   // exact division (nvcc's default -prec-div=true)
    out[12 + k] = 1.0f / lo;
    out[15 + k] = ahead ? 1.0f : 0.0f;
    out[18 + k] = mul(-sg, add(add(mul(p.light[0], r[0][k]), mul(p.light[1], r[1][k])),
                               mul(p.light[2], r[2][k])));
  }
  out[21] = any_ahead ? 0.0f : 1.0f;
}

// Per-env setup of one box seen from one camera for the ratio mode: the
// slab setup's 15 floats (box-local eye, A, B, C, Lambert dots), rounded as
// the plain version rounds them.
__device__ void ratio_setup(const RenderParams& p, int cam, const float* pose, float* out) {
  float r[3][3];
  rot_rn(pose, r);
  float rel[3];
  for (int i = 0; i < 3; ++i) rel[i] = sub(p.eye[cam][i], pose[i]);
  for (int k = 0; k < 3; ++k) {
    out[k] = dot_col(r, k, rel);
    out[3 + k] = dot_col(r, k, p.basis[cam]);
    out[6 + k] = dot_col(r, k, p.basis[cam] + 3);
    out[9 + k] = dot_col(r, k, p.basis[cam] + 6);
    out[12 + k] = add(add(mul(p.light[0], r[0][k]), mul(p.light[1], r[1][k])),
                      mul(p.light[2], r[2][k]));
  }
}

// The raster's min/max cascade over routed bound planes a (far, lower),
// ub (near ahead, upper) and lb (near behind, lower): inverse depth q
// (larger is nearer, -BIG on a miss), Lambert value of the entry face, hit
// flag.  su: the box's raster setup (Lambert candidates, inside flag).
__device__ __forceinline__ void raster_cascade(const float* su, const float a[3],
                                               const float ub[3], const float lb[3], float& q,
                                               float& lam, bool& hit) {
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

// Raster cast of one ray (screen coords px, py) against one box
// (raycast._obb_q_cast): the bound planes, then the cascade.
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
  raster_cascade(su, a, ub, lb, q, lam, hit);
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

// Division-free ratio cast of one ray against one box
// (raycast._ray_obb_affine with recip=False): depth num/den (num = BIG,
// den = 1 on a miss), Lambert value of the entry face, hit flag.
__device__ __forceinline__ void ratio_cast(const float* su, const float he[3], float px,
                                           float py, float& num, float& den, float& lam,
                                           bool& hit) {
  float p[3], n_lo[3], n_hi[3], cand[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = add(add(su[3 + k], mul(su[6 + k], px)), mul(su[9 + k], py));
    const float s = sign(d);
    p[k] = fmaxf(mul(s, d), 1e-9f);
    const float so = mul(s, su[k]);
    n_lo[k] = sub(-he[k], so);
    n_hi[k] = sub(he[k], so);
    cand[k] = mul(-s, su[12 + k]);
  }
  float n = n_lo[0], pd = p[0];
  lam = cand[0];
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const bool take = mul(n_lo[k], pd) > mul(n, p[k]);
    n = take ? n_lo[k] : n;
    lam = take ? cand[k] : lam;
    pd = take ? p[k] : pd;
  }
  float m = n_hi[0], q = p[0];
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const bool take = mul(n_hi[k], q) < mul(m, p[k]);
    m = take ? n_hi[k] : m;
    q = take ? p[k] : q;
  }
  hit = mul(m, pd) >= mul(n, q) && m > 0.0f;
  const bool inside = n <= 0.0f;
  num = hit ? (inside ? m : n) : BIG;
  den = hit ? (inside ? q : pd) : 1.0f;
}

// Adds one sub-ray's four colour fields to a pooled pixel's sums.
__device__ __forceinline__ void shade_fields(const RenderParams& p, bool sel_c, bool hit_p,
                                             float lam_c, float lam_p, float gval, float smask,
                                             float& fa, float& fb, float& fg, float& fs) {
  const bool sel_p = hit_p && !sel_c;
  const float lambert = fmaxf(sel_c ? lam_c : lam_p, 0.0f);
  const float shade = p.ambient + p.diffuse * lambert;
  const bool bg = !(sel_c || sel_p);
  fa = fa + (sel_c ? shade : 0.0f);
  fb = fb + (sel_p ? shade : 0.0f);
  fg = fg + (bg ? gval : 0.0f);
  fs = fs + (bg ? smask : 0.0f);
}

// Averages a pooled pixel's field sums and writes its three uint8
// channels (plane-major per camera) into the frame o.
__device__ __forceinline__ void store_pixel(const RenderParams& p, float fa, float fb, float fg,
                                            float fs, uint8_t* o, int cam, int j) {
  const int n = p.n;
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

// Fills the block's per-box setup table: copied from the packed table
// (the hoisted modes) or computed by 2*C threads.
template <int MODE>
__device__ __forceinline__ void block_setup(const RenderParams& p, const float* pose,
                                            const float* setups, float* setup, int W, int E,
                                            int rep, int e) {
  if (MODE == RASTER_HOIST || MODE == MXU_HOIST) {
    const int w = 2 * RASTER_W * p.num_cams;
    const float* src = setups + ((size_t)rep * E + e) * w;
    for (int i = threadIdx.x; i < w; i += blockDim.x) setup[i] = src[i];
  } else if (threadIdx.x < 2 * p.num_cams) {
    const int cam = threadIdx.x >> 1, box = threadIdx.x & 1;
    float* su = setup + (cam * 2 + box) * W;
    if (MODE == RASTER || MODE == MXU) {
      raster_setup(p, cam, pose + 7 * box, p.he[box], su);
    } else if (MODE == RATIO) {
      ratio_setup(p, cam, pose + 7 * box, su);
    } else {
      box_setup(p, cam, pose + 7 * box, su);
    }
  }
}

// poses: (R, E, 16) [cart pos quat | pole pos quat | 0 0];
// rays: (4, C, p2, n) rows px, py, ground value, sky mask;
// setups: (R, E, C*2*22) packed raster setups (RASTER_HOIST only);
// out: (E, R, C*3*n) uint8.  Grid (E, R).  Modes SLAB, RASTER, RATIO and
// RASTER_HOIST.
template <int MODE>
__global__ void __launch_bounds__(THREADS) render_kernel(RenderParams p,
                                                        const float* __restrict__ poses,
                                                        const float* __restrict__ rays,
                                                        const float* __restrict__ setups,
                                                        uint8_t* __restrict__ out, int E, int R) {
  constexpr bool RAS = MODE == RASTER || MODE == RASTER_HOIST;
  constexpr int W = RAS ? RASTER_W : SLAB_W;
  const int e = blockIdx.x, rep = blockIdx.y;
  __shared__ float setup[MAX_CAMS][2][W];
  const float* pose = poses + ((size_t)rep * E + e) * 16;
  block_setup<MODE>(p, pose, setups, &setup[0][0][0], W, E, rep, e);
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
      if (RAS) {
        raster_cast(setup[cam][0], px, py, dc, lam_c, hit_c);
        raster_cast(setup[cam][1], px, py, dp, lam_p, hit_p);
        sel_c = hit_c && (dc >= dp);  // inverse depth: larger is nearer
      } else if (MODE == RATIO) {
        float den_c, den_p;
        ratio_cast(setup[cam][0], p.he[0], px, py, dc, den_c, lam_c, hit_c);
        ratio_cast(setup[cam][1], p.he[1], px, py, dp, den_p, lam_p, hit_p);
        sel_c = hit_c && (mul(dc, den_p) <= mul(dp, den_c));
      } else {
        cast(setup[cam][0], p.he[0], px, py, dc, lam_c, hit_c);
        cast(setup[cam][1], p.he[1], px, py, dp, lam_p, hit_p);
        sel_c = hit_c && (dc <= dp);
      }
      shade_fields(p, sel_c, hit_p, lam_c, lam_p, gval, smask, fa, fb, fg, fs);
    }
    store_pixel(p, fa, fb, fg, fs, o, cam, j);
  }
}

// K5c's setup pass: raster_setup of every (repeat, env, camera, box), one
// thread each → setups (R, E, C*2*22), per camera the cart then the pole
// (raycast.pack_setups' layout).
__global__ void pack_setups_kernel(RenderParams p, const float* __restrict__ poses,
                                   float* __restrict__ setups, int E, int R) {
  const int cams = p.num_cams;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * E * cams * 2) return;
  const int box = idx & 1, cam = (idx >> 1) % cams, re = (idx >> 1) / cams;
  raster_setup(p, cam, poses + (size_t)re * 16 + 7 * box, p.he[box],
               setups + ((size_t)re * cams + cam) * 2 * RASTER_W + box * RASTER_W);
}

// Round to TF32 (round to nearest, ties away), as a .b32 operand of mma.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + (what TF32 cannot hold of the residual): the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b on the tensor cores: one m16n8k8 TF32 product, f32 accumulator.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (k = t + 4, n = g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One bound plane as a left-hand-side row over the rays' rows (px, py,
// gval, smask, 1, 0, 0, 0) (raycast.bound_rows): row = 3*kind + k of a box,
// kind 0 the far plane a = w*inv_u, 1 the upper bound ub = ahead ? w*inv_l
// : BIG, 2 the lower bound lb = ahead ? -BIG : w*inv_l.
__device__ void bound_row(const float* su, int row, float* out) {
  const int kind = row / 3, k = row - 3 * kind;
  const float fa = su[15 + k];
  float scale, bias = 0.0f;
  if (kind == 0) {
    scale = su[9 + k];
  } else if (kind == 1) {
    scale = mul(fa, su[12 + k]);
    bias = mul(sub(1.0f, fa), BIG);
  } else {
    scale = mul(sub(1.0f, fa), su[12 + k]);
    bias = -mul(fa, BIG);
  }
  for (int c = 0; c < 8; ++c) out[c] = 0.0f;
  out[0] = mul(su[3 + k], scale);
  out[1] = mul(su[6 + k], scale);
  out[4] = kind == 0 ? mul(su[k], scale) : add(mul(su[k], scale), bias);
}

// K5d: the raster mode with its 18 routed bound planes per ray from
// tensor-core products.  Arguments as render_kernel's; HOIST reads the
// packed setups (K5c's table).  Grid (E, R), THREADS threads.
template <bool HOIST>
__global__ void __launch_bounds__(THREADS) render_mxu_kernel(RenderParams p,
                                                            const float* __restrict__ poses,
                                                            const float* __restrict__ rays,
                                                            const float* __restrict__ setups,
                                                            uint8_t* __restrict__ out, int E,
                                                            int R) {
  const int e = blockIdx.x, rep = blockIdx.y;
  __shared__ float setup[MAX_CAMS][2][RASTER_W];
  __shared__ float lhs[MAX_CAMS][MXU_ROWS][8];
  __shared__ float stage[THREADS / 32][18 * STAGE_LD];
  const float* pose = poses + ((size_t)rep * E + e) * 16;
  block_setup<HOIST ? MXU_HOIST : MXU>(p, pose, setups, &setup[0][0][0], RASTER_W, E, rep, e);
  __syncthreads();
  const int n = p.n, p2 = p.p2, cams = p.num_cams;
  for (int i = threadIdx.x; i < cams * MXU_ROWS; i += blockDim.x) {
    const int cam = i / MXU_ROWS, row = i - cam * MXU_ROWS;
    if (row < 18) {
      bound_row(setup[cam][row / 9], row % 9, lhs[cam][row]);
    } else {
      for (int c = 0; c < 8; ++c) lhs[cam][row][c] = 0.0f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const size_t plane = (size_t)cams * p2 * n;
  uint8_t* o = out + ((size_t)e * R + rep) * (cams * 3 * n);
  float* st = stage[warp];
  for (int cam = 0; cam < cams; ++cam) {
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* l = &lhs[cam][mt * 16][0];
      split_tf32(l[g * 8 + t], a_hi[mt][0], a_lo[mt][0]);
      split_tf32(l[(g + 8) * 8 + t], a_hi[mt][1], a_lo[mt][1]);
      split_tf32(l[g * 8 + t + 4], a_hi[mt][2], a_lo[mt][2]);
      split_tf32(l[(g + 8) * 8 + t + 4], a_hi[mt][3], a_lo[mt][3]);
    }
    const float* su_c = setup[cam][0];
    const float* su_p = setup[cam][1];
    // Warp-uniform loop: every lane takes part in each mma; lanes past
    // the last pixel cast a clamped ray and store nothing.
    for (int base = warp * 32; base < n; base += nwarps * 32) {
      const int j = base + lane;
      const int jj = j < n ? j : n - 1;
      float fa = 0.0f, fb = 0.0f, fg = 0.0f, fs = 0.0f;
      for (int sidx = 0; sidx < p2; ++sidx) {
        const size_t row0 = ((size_t)cam * p2 + sidx) * n;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // B fragment: row t of ray (base + 8 nt + g); rows 4-7 are
          // (1, 0, 0, 0), built here.
          const int jc = min(base + 8 * nt + g, n - 1);
          uint32_t b_hi[2], b_lo[2];
          split_tf32(rays[t * plane + row0 + jc], b_hi[0], b_lo[0]);
          b_hi[1] = t == 0 ? __float_as_uint(1.0f) : 0u;
          b_lo[1] = 0u;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(d, a_lo[mt], b_hi);
            mma_tf32(d, a_hi[mt], b_lo);
            mma_tf32(d, a_hi[mt], b_hi);
            const int r0 = mt * 16 + g, col = 8 * nt + 2 * t;
            if (r0 < 18) {
              st[r0 * STAGE_LD + col] = d[0];
              st[r0 * STAGE_LD + col + 1] = d[1];
            }
            if (r0 + 8 < 18) {
              st[(r0 + 8) * STAGE_LD + col] = d[2];
              st[(r0 + 8) * STAGE_LD + col + 1] = d[3];
            }
          }
        }
        __syncwarp();
        float b[18];
#pragma unroll
        for (int r = 0; r < 18; ++r) b[r] = st[r * STAGE_LD + lane];
        __syncwarp();
        float qc, qp, lam_c, lam_p;
        bool hit_c, hit_p;
        raster_cascade(su_c, b, b + 3, b + 6, qc, lam_c, hit_c);
        raster_cascade(su_p, b + 9, b + 12, b + 15, qp, lam_p, hit_p);
        const bool sel_c = hit_c && (qc >= qp);
        const size_t off = row0 + jj;
        shade_fields(p, sel_c, hit_p, lam_c, lam_p, rays[2 * plane + off],
                     rays[3 * plane + off], fa, fb, fg, fs);
      }
      if (j < n) store_pixel(p, fa, fb, fg, fs, o, cam, j);
    }
  }
}

// Launches the render kernel of `mode` (enum Mode) on `stream`; `setups`
// is read by the hoisted modes only.  Returns cudaGetLastError() as an int.
extern "C" int cp_render(const RenderParams* params, const float* poses, const float* rays,
                         const float* setups, uint8_t* out, int E, int R, int mode,
                         void* stream) {
  if (params->num_cams < 1 || params->num_cams > MAX_CAMS) return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == RASTER_HOIST || mode == MXU_HOIST) && setups == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(E, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case SLAB:
      render_kernel<SLAB><<<grid, THREADS, 0, st>>>(*params, poses, rays, setups, out, E, R);
      break;
    case RASTER:
      render_kernel<RASTER><<<grid, THREADS, 0, st>>>(*params, poses, rays, setups, out, E, R);
      break;
    case RATIO:
      render_kernel<RATIO><<<grid, THREADS, 0, st>>>(*params, poses, rays, setups, out, E, R);
      break;
    case RASTER_HOIST:
      render_kernel<RASTER_HOIST><<<grid, THREADS, 0, st>>>(*params, poses, rays, setups, out,
                                                            E, R);
      break;
    case MXU:
      render_mxu_kernel<false><<<grid, THREADS, 0, st>>>(*params, poses, rays, setups, out, E, R);
      break;
    case MXU_HOIST:
      render_mxu_kernel<true><<<grid, THREADS, 0, st>>>(*params, poses, rays, setups, out, E, R);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K5c's setup pass on `stream`: poses (R, E, 16) → setups
// (R, E, C*2*22).  Returns cudaGetLastError() as an int.
extern "C" int cp_pack_setups(const RenderParams* params, const float* poses, float* setups,
                              int E, int R, void* stream) {
  if (params->num_cams < 1 || params->num_cams > MAX_CAMS) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = R * E * params->num_cams * 2;
  pack_setups_kernel<<<(threads + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, poses, setups, E, R);
  return static_cast<int>(cudaGetLastError());
}
