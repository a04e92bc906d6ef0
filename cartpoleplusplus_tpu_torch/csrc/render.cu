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
// render_hoist=True) and MXU / MXU_HOIST (K5d, render_mxu=True).
// render_slab_kernel serves SLAB; one template, render_kernel, serves RASTER,
// RATIO and RASTER_HOIST; render_mxu_kernel serves K5d; pack_setups_kernel
// is K5c's setup pass.
//
// What bounds it on this card: float32 operations per ray.  Each ray is
// cast against two oriented boxes, depth-ordered, shaded and pooled: on the
// order of a hundred float ops for the 5 bytes of output it contributes, so
// the kernel is far above the card's bytes-per-op ridge and bound by the
// float rate (config 5: 2 cameras x 2 sub-samples x 625 pooled pixels x 3
// repeats x 4096 envs = 30.7 M rays per step; 1-camera exact: 1 camera x 4
// sub-rays x 625 x 3 x 4096, the same 30.7 M).
//
// Common layout of the first port, which the raster and ratio modes keep:
// one block per (env, repeat).  The per-env algebra of each box seen from
// each camera is computed once per block into shared memory by 2*C threads.
// Threads then run over the pooled pixels of all cameras; each thread casts
// its pixel's p2 sub-rays, sums their four colour fields (cart shade, pole
// shade, ground value, sky mask) in registers, and writes three uint8
// channels straight into the obs slab at width n: the TPU's 128-lane padding
// does not exist here.  Static per-ray rows (px, py, ground value, sky mask)
// are read coalesced from a (4, C, p2, n) table.
//
// Slab mode (K3/K4, render_slab_kernel): the setup is the box-local eye o,
// the direction coefficients A/B/C and the Lambert dots (15 floats per box
// and camera); per ray, three slab reciprocals with Hopper's rcp.approx (not
// Mosaic's), so it is held to the plain float32 version at the pixel
// tolerance, not bit for bit.  The cast, the setup and the shading are the
// first port's code, unchanged, and so are the frames, byte for byte.  On
// the main path's poses the two boxes cover a small part of each frame, so
// most casts of the first port missed; what bounds this kernel is the casts
// it still makes and, per pixel, loading its rays and writing its bytes.
// - A block renders up to SLAB_THREADS / (16 C) repeats of one env (all 3 on
//   the main path): 16 lanes per (repeat, camera) compute the setups and,
//   one corner each in double, each box's cull rectangle (cull_rect): the
//   screen rectangle outside which its slab cast is a miss.
// - A warp holds 32 pooled pixels of one camera, taken column by column (the
//   kernel's own order of a camera's pixels, raycast.slab_order): about 1.3
//   columns of a 25 x 25 frame, where an upright pole is thin.  Per pixel a
//   static table gives the rectangle of its sub-rays; the warp casts a box
//   for all its sub-rays only where one lane's rectangle meets the box's
//   (two __any_sync per pixel, over the lanes that hold a pixel: 625 = 19 *
//   32 + 17, and a lane past the end has left the loop before the votes).
//   The decision is uniform in the warp, so the casts it makes are straight
//   runs, both boxes' casts interleaved where both are cast.  A skipped cast
//   takes the cast's miss values (t = 1e9, hit false; the Lambert value of a
//   miss is never read).  Where a warp casts neither box, every sub-ray
//   misses and the shading adds up the ground values and sky masks: the
//   table holds those float32 sums (0.0f + the first + ...), so the pixel
//   costs one load.
// - The static rows are kept in that order as one float4 per sub-ray, and
//   the block's frames are written into shared memory, then out in order
//   (a warp's pixels lie in different rows of the frame).  A block stages as
//   many repeats as fit in the shared memory left for them
//   (SLAB_FRAME_BYTES, 46720 bytes); a frame larger than that (two cameras
//   unpooled at 89 x 89 and over, one at 125 x 125) is written straight to
//   global memory instead, the same bytes.

// Why the rectangle is conservative (the plain version is
// raycast.slab_cull_rect; tests/test_torch_cull.py holds it against the
// cast on poses chosen to break it).  Write eps = 2^-24.
// 1. The cast in float32.  Per axis k it forms d = A + B px + C py (at most
//    four roundings, with or without contracted FMAs), d' = d + s 1e-9 and
//    the slab ends (+-he - o) * rcp.approx(d').  rcp.approx is within 1 ulp
//    (2 eps relative), so each end is the exact ratio (+-he - o)(1 + delta)
//    / d' with |delta| <= 4 eps (+ O(eps^2)): it lies inside the exact slab
//    interval of direction d' for the box grown to he_k + 4 eps (he_k +
//    |o_k|).  min/max are exact, so a reported hit (tmax >= tmin, tmax > 0)
//    means the exact ray o + t d', t = tmax > 0, meets that grown box.  The
//    1e-9 sign bias and the roundings of d make d' = d_exact + e with
//    |e_k| <= 6 eps S + 1.01e-9, S = |A| + P (|B| + |C|), P the largest
//    |px|, |py| of the ray table (RenderParams.ray_abs).
// 2. Screen space.  With the dual basis (A^, B^, C^) of (A, B, C), a point v
//    (relative to o) has depth z = v.A^ and screen coordinates X = v.B^ / z,
//    Y = v.C^ / z; the exact ray (px, py) is the set z > 0, X = px, Y = py.
//    The point o + t d' has X = (px + e.B^) / (1 + e.A^), so px = X (1 +
//    e.A^) - e.B^ and |px - X| <= |X| |e| |A^| + |e| |B^|.
// 3. Boxes not wholly in front of the eye.  If every corner of the grown
//    box has z >= 1 mm (CULL_ZMIN), the box lies in z > 0 and its screen
//    image is the convex hull of its corners' images, inside their bounding
//    rectangle; X of the hit point is inside it.  A box with a corner nearer
//    than that (eye inside or near a slab, the pole crossing the camera
//    plane) has an unbounded image and is never culled: its rectangle is
//    (-inf, inf).  Likewise where |e| |A^| > 1/4 or anything is not finite.
// 4. Margin.  The rectangle of the corners is widened by the bound of 2 on
//    each side, and both the growth of 1 and that margin are taken
//    CULL_SAFETY = 16 times over, plus 1e-6 screen units.  It is computed in
//    double (relative error ~1e-16, far inside the margin) and rounded
//    outward to float32, so the test px < xlo (etc.) in float32 is exact.
// 5. Sub-rays and warps.  The bound holds per sub-ray.  A pixel's table
//    rectangle is the exact min/max of its p2 sub-rays' px and py, so a
//    sub-ray inside the box's rectangle makes its pixel's rectangle meet
//    it; a warp skips a box only where no pixel's rectangle meets it, that
//    is where every sub-ray of every pixel it holds misses the box.

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
// ray as the slab mode's before culling but cheaper (no reciprocals); p2 = 4
// at obs_pool 2 doubles the sub-rays a thread sums per pooled pixel.  The
// raster modes are not tuned yet: they cast every ray against both boxes,
// and 256 threads over 625 pooled pixels leave the third pass of each block
// two-fifths full.
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
#include <math_constants.h>
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
  float ray_abs;             // largest |px|, |py| of the ray table (slab culling;
                             // +inf widens every cull rectangle to the plane)
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

// Fills the block's per-box setup table of a raster or ratio mode: copied
// from the packed table (the hoisted modes) or computed by 2*C threads.
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
    } else {
      ratio_setup(p, cam, pose + 7 * box, su);
    }
  }
}

// poses: (R, E, 16) [cart pos quat | pole pos quat | 0 0];
// rays: (4, C, p2, n) rows px, py, ground value, sky mask;
// setups: (R, E, C*2*22) packed raster setups (RASTER_HOIST only);
// out: (E, R, C*3*n) uint8.  Grid (E, R).  Modes RASTER, RATIO and
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
      } else {
        float den_c, den_p;
        ratio_cast(setup[cam][0], p.he[0], px, py, dc, den_c, lam_c, hit_c);
        ratio_cast(setup[cam][1], p.he[1], px, py, dp, den_p, lam_p, hit_p);
        sel_c = hit_c && (mul(dc, den_p) <= mul(dp, den_c));
      }
      shade_fields(p, sel_c, hit_p, lam_c, lam_p, gval, smask, fa, fb, fg, fs);
    }
    store_pixel(p, fa, fb, fg, fs, o, cam, j);
  }
}

#define CULL_EPS 5.9604644775390625e-8  // 2^-24, float32's unit roundoff
#define CULL_SAFETY 16.0
#define CULL_ZMIN 1e-3   // metres: nearest corner depth for which a box is culled
#define CULL_FLOOR 1e-6  // screen units added to the margin

__device__ __forceinline__ void cross_d(const double a[3], const double b[3], double o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double dot_d(const double a[3], const double b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ double norm_d(const double a[3]) { return sqrt(dot_d(a, a)); }

// The screen rectangle (xlo, xhi, ylo, yhi) of one box seen from one camera
// outside which its slab cast is a miss (the argument is in the header;
// raycast.slab_cull_rect is the plain version).  su: box_setup's floats
// (o, A, B, C); he: the box's half extents.  Called by 8 lanes of a group
// aligned to 8 lanes, `corner` = the lane's index in it; every lane of the
// warp must call it (the reductions shuffle over the full mask).
__device__ void cull_rect(const float* su, const float he[3], float ray_abs, int corner,
                          float out[4]) {
  double o[3], a[3], b[3], c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = su[k];
    a[k] = su[3 + k];
    b[k] = su[6 + k];
    c[k] = su[9 + k];
  }
  double bxc[3], cxa[3], axb[3];
  cross_d(b, c, bxc);
  cross_d(c, a, cxa);
  cross_d(a, b, axb);
  const double inv_det = 1.0 / dot_d(a, bxc);
  double ah[3], bh[3], ch[3];  // the dual basis
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ah[k] = bxc[k] * inv_det;
    bh[k] = cxa[k] * inv_det;
    ch[k] = axb[k] * inv_det;
  }
  const double s = norm_d(a) + (double)ray_abs * (norm_d(b) + norm_d(c));
  const double e = 1.7320508075688772 * (6.0 * CULL_EPS * s + 1.01e-9);  // sqrt(3) max |e_k|
  const double ea = e * norm_d(ah), eb = e * norm_d(bh), ec = e * norm_d(ch);
  double v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double h = (double)he[k];
    const double grown = h + CULL_SAFETY * 4.0 * CULL_EPS * (h + fabs(o[k]));
    const bool plus = (corner >> k) & 1;
    v[k] = (plus ? grown : -grown) - o[k];
  }
  const double z = dot_d(v, ah);
  const double x = dot_d(v, bh) / z, y = dot_d(v, ch) / z;
  bool ok = z >= CULL_ZMIN && ea <= 0.25 && isfinite(x) && isfinite(y);
  double xlo = x, xhi = x, ylo = y, yhi = y;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) {
    xlo = fmin(xlo, __shfl_xor_sync(0xffffffffu, xlo, m, 8));
    xhi = fmax(xhi, __shfl_xor_sync(0xffffffffu, xhi, m, 8));
    ylo = fmin(ylo, __shfl_xor_sync(0xffffffffu, ylo, m, 8));
    yhi = fmax(yhi, __shfl_xor_sync(0xffffffffu, yhi, m, 8));
    ok = __shfl_xor_sync(0xffffffffu, (int)ok, m, 8) && ok;
  }
  const double mx = CULL_SAFETY * (ea * fmax(fabs(xlo), fabs(xhi)) + eb) + CULL_FLOOR;
  const double my = CULL_SAFETY * (ea * fmax(fabs(ylo), fabs(yhi)) + ec) + CULL_FLOOR;
  out[0] = ok ? __double2float_rd(xlo - mx) : -CUDART_INF_F;
  out[1] = ok ? __double2float_ru(xhi + mx) : CUDART_INF_F;
  out[2] = ok ? __double2float_rd(ylo - my) : -CUDART_INF_F;
  out[3] = ok ? __double2float_ru(yhi + my) : CUDART_INF_F;
}

// Whether two screen rectangles (xlo, xhi, ylo, yhi) meet.  A NaN bound
// compares false: they meet.
__device__ __forceinline__ bool meets(const float a[4], const float b[4]) {
  return !(a[1] < b[0] || a[0] > b[1] || a[3] < b[2] || a[2] > b[3]);
}

// The sub-rays of one pooled pixel: cast against the boxes the warp keeps
// (the others keep the cast's miss values), shaded and summed.  rays: the
// pixel's first sub-ray in the (C, p2, n) table of (px, py, ground value,
// sky mask).
template <bool CART, bool POLE>
__device__ __forceinline__ void slab_pixel(const RenderParams& p, const float* su_c,
                                           const float* su_p, const float4* __restrict__ rays,
                                           float& fa, float& fb, float& fg, float& fs) {
  for (int sidx = 0; sidx < p.p2; ++sidx) {
    const float4 ray = rays[sidx * p.n];
    const float px = ray.x, py = ray.y, gval = ray.z, smask = ray.w;
    float dc = 1e9f, dp = 1e9f, lam_c = 0.0f, lam_p = 0.0f;
    bool hit_c = false, hit_p = false;
    if (CART) cast(su_c, p.he[0], px, py, dc, lam_c, hit_c);
    if (POLE) cast(su_p, p.he[1], px, py, dp, lam_p, hit_p);
    const bool sel_c = hit_c && (dc <= dp);
    shade_fields(p, sel_c, hit_p, lam_c, lam_p, gval, smask, fa, fb, fg, fs);
  }
}

#define SLAB_THREADS 128
#define SLAB_MAX_REPS (SLAB_THREADS / 16)  // repeats per block: SLAB_THREADS / (16 * cameras)
// Static shared memory of render_slab_kernel (its setup and rect arrays),
// and the dynamic shared memory left for a block's frames under the default
// 48 KiB a block may use without opting in.  cuda_render.slab_blocking
// holds the same numbers.
#define SLAB_STATIC_BYTES (SLAB_MAX_REPS * MAX_CAMS * 2 * (SLAB_W + 4) * 4)
#define SLAB_FRAME_BYTES (48 * 1024 - SLAB_STATIC_BYTES)

// K3/K4, the slab mode with culling.  poses: (R, E, 16); rays: (C, p2, n)
// float4 (px, py, ground value, sky mask); pixels: (C, n, 2) float4, per
// pooled pixel the screen rectangle (xlo, xhi, ylo, yhi) of its sub-rays,
// the sums over its sub-rays of the ground value and of the sky mask (0.0f
// + the first + the second ..., in float32), its index j in the frame and
// a zero.  Both tables hold the pixels of a camera in the kernel's order
// (column by column), not the frame's (row by row).  out: (E, R, C*3*n)
// uint8.  Grid (E, ceil(R / reps)), SLAB_THREADS threads; a block renders
// `reps` repeats of one env.  STAGED: the block's frames are written into
// reps * C*3*n bytes of dynamic shared memory, then out in order; else (a
// frame too large for SLAB_FRAME_BYTES) each pixel's bytes go straight to
// out.  The values are the same either way.  (A template, not a runtime
// flag: through a pointer that may be either, the pixel stores lose their
// shared-memory instructions and the kernel 8 % of its speed.)
template <bool STAGED>
__global__ void __launch_bounds__(SLAB_THREADS) render_slab_kernel(
    RenderParams p, const float* __restrict__ poses, const float4* __restrict__ rays,
    const float4* __restrict__ pixels, uint8_t* __restrict__ out, int E, int R, int reps) {
  const int e = blockIdx.x, rep0 = blockIdx.y * reps;
  const int nrep = min(reps, R - rep0), cams = p.num_cams;
  __shared__ float setup[SLAB_MAX_REPS][MAX_CAMS][2][SLAB_W];
  __shared__ float rect[SLAB_MAX_REPS][MAX_CAMS][2][4];
  static_assert(sizeof(setup) + sizeof(rect) == SLAB_STATIC_BYTES, "SLAB_STATIC_BYTES");
  extern __shared__ uint8_t frames[];  // nrep frames, as in out, where staged
  // Setup: 16 lanes per (repeat, camera), lane = 8 * box + corner.  The 8
  // lanes of a box compute its setup alike (the same bits) and one corner
  // each of its cull rectangle.  Whole warps enter (cull_rect shuffles over
  // the full mask); a lane past the last (repeat, camera) repeats it and
  // stores nothing.
  const int nsetup = nrep * cams * 16;
  if (threadIdx.x < ((nsetup + 31) & ~31)) {
    const int t = min((int)threadIdx.x, nsetup - 1);
    const int corner = t & 7, box = (t >> 3) & 1, cam = (t >> 4) % cams, rl = (t >> 4) / cams;
    const float* pose = poses + ((size_t)(rep0 + rl) * E + e) * 16;
    float su[SLAB_W], r[4];
    box_setup(p, cam, pose + 7 * box, su);
    cull_rect(su, p.he[box], p.ray_abs, corner, r);
    if (threadIdx.x < nsetup && corner == 0) {
#pragma unroll
      for (int i = 0; i < SLAB_W; ++i) setup[rl][cam][box][i] = su[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) rect[rl][cam][box][i] = r[i];
    }
  }
  __syncthreads();

  // A camera's n pooled pixels, in the tables' order, are laid out over
  // n_pad = 32 * ceil(n / 32) lanes, so a warp holds a run of up to 32
  // pixels of one camera: about 1.3 columns of a 25 x 25 frame, where an
  // upright pole is thin.
  const int n = p.n, p2 = p.p2, n_pad = (n + 31) & ~31, frame_w = cams * 3 * n;
  uint8_t* o = out + ((size_t)e * R + rep0) * frame_w;
  for (int rl = 0; rl < nrep; ++rl) {
    uint8_t* dst = (STAGED ? frames : o) + rl * frame_w;
    for (int cam = 0; cam < cams; ++cam) {
      const float* su_c = setup[rl][cam][0];
      const float* su_p = setup[rl][cam][1];
      for (int q = threadIdx.x; q < n_pad; q += blockDim.x) {
        // The lanes of this warp that hold a pixel: all 32 but in the last
        // run of a camera (625 = 19 * 32 + 17).  The votes are taken over
        // them; an idle lane takes part in none.
        const unsigned active = __ballot_sync(0xffffffffu, q < n);
        if (q >= n) continue;
        // The warp casts a box for all its sub-rays where the rectangle of
        // one of its pixels' sub-rays meets the box's: the same decision
        // in every lane, and the cast's own values in every lane.
        const float4 r4 = pixels[2 * (cam * n + q)];
        const float4 bg = pixels[2 * (cam * n + q) + 1];
        const float pr[4] = {r4.x, r4.y, r4.z, r4.w};
        const bool cart = __any_sync(active, meets(pr, rect[rl][cam][0]));
        const bool pole = __any_sync(active, meets(pr, rect[rl][cam][1]));
        const float4* ray = rays + cam * p2 * n + q;
        float fa = 0.0f, fb = 0.0f, fg = 0.0f, fs = 0.0f;
        if (cart && pole) {
          slab_pixel<true, true>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else if (cart) {
          slab_pixel<true, false>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else if (pole) {
          slab_pixel<false, true>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else {
          // Every sub-ray misses both boxes: the fields are the background
          // sums, the values the loop would add up.
          fg = bg.x;
          fs = bg.y;
        }
        store_pixel(p, fa, fb, fg, fs, dst, cam, static_cast<int>(bg.z));
      }
    }
  }
  if (!STAGED) return;
  // The frames are written out whole, byte by byte in order: the pixels of
  // a warp lie in different rows of the frame.
  __syncthreads();
  for (int i = threadIdx.x; i < nrep * frame_w; i += blockDim.x) o[i] = frames[i];
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

// Launches the render kernel of `mode` (enum Mode) on `stream`.  `rays` is
// the (4, C, p2, n) table, in the slab mode the (C, p2, n, 4) one; `setups`
// is read by the hoisted modes only, `pixels` by the slab mode only.  The
// slab mode renders `reps` repeats per block, staging its frames in shared
// memory where `staged` (cuda_render.slab_blocking chooses both; a choice
// the kernel cannot run is refused).  Returns cudaGetLastError() as an int.
extern "C" int cp_render(const RenderParams* params, const float* poses, const float* rays,
                         const float* setups, const float* pixels, uint8_t* out, int E, int R,
                         int mode, int reps, int staged, void* stream) {
  if (params->num_cams < 1 || params->num_cams > MAX_CAMS) return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == RASTER_HOIST || mode == MXU_HOIST) && setups == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == SLAB && pixels == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(E, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case SLAB: {
      const long frame_w = (long)params->num_cams * 3 * params->n;
      if (reps < 1 || reps > min(R, SLAB_THREADS / (16 * params->num_cams)) ||
          (staged && reps * frame_w > SLAB_FRAME_BYTES)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const dim3 slab_grid(E, (R + reps - 1) / reps);
      const float4* rays4 = reinterpret_cast<const float4*>(rays);
      const float4* pixels4 = reinterpret_cast<const float4*>(pixels);
      if (staged) {
        render_slab_kernel<true><<<slab_grid, SLAB_THREADS, reps * frame_w, st>>>(
            *params, poses, rays4, pixels4, out, E, R, reps);
      } else {
        render_slab_kernel<false><<<slab_grid, SLAB_THREADS, 0, st>>>(
            *params, poses, rays4, pixels4, out, E, R, reps);
      }
      break;
    }
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
