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
// render_hoist=True) and MXU / MXU_HOIST (K5d, render_mxu=True).  Three
// column-run kernels serve them all: render_slab_kernel SLAB and RATIO,
// render_raster_kernel RASTER and RASTER_HOIST, render_raster_mxu_kernel MXU
// and MXU_HOIST; pack_setups_kernel is K5c's setup pass.
//
// What bounds it on this card: float32 operations per ray.  Each ray is
// cast against two oriented boxes, depth-ordered, shaded and pooled: on the
// order of a hundred float ops for the 5 bytes of output it contributes, so
// the kernel is far above the card's bytes-per-op ridge and bound by the
// float rate (config 5: 2 cameras x 2 sub-samples x 625 pooled pixels x 3
// repeats x 4096 envs = 30.7 M rays per step; 1-camera exact: 1 camera x 4
// sub-rays x 625 x 3 x 4096, the same 30.7 M).
//
// Common to every mode: the per-env algebra of each box seen from each
// camera (its setup) is computed once per block into shared memory; a
// thread casts its pooled pixel's p2 sub-rays, sums their four colour fields
// (cart shade, pole shade, ground value, sky mask) in registers, and writes
// three uint8 channels into the frame at width n: the TPU's 128-lane
// padding does not exist here.  The layout around that (blocks, warps,
// tables, cull, staging) is the slab mode's, below; the other kernels take
// it over.
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
//    (-inf, inf).  Likewise where |e| |A^| > 1/4, anything is not finite,
//    or S or some he_k + |o_k| exceeds CULL_BIG = 1e18 (so that no product
//    of the ratio cast's compares, below, can overflow).
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
// keeps nvcc's FMA contraction.  K5a's frames equal the plain version's.
// - render_raster_kernel takes K3's layout: a block per env holding its
//   repeats (SLAB_THREADS threads; 2*C*R of them compute raster_setup, with
//   its exact divisions, into shared memory), warps of 32 pooled pixels
//   taken column by column, the float4 ray table and the pixel table
//   (rectangle, background sums, frame index), background sums for a warp
//   that casts neither box, frames staged in shared memory where they fit
//   (RASTER_FRAME_BYTES), else written straight to global memory, as K3's
//   (cuda_render.slab_blocking chooses for both).  With HOIST (K5c) the
//   block copies its rows of the packed setup table instead (below).
// - The cull replaces K3's rectangle by a raster-native interval test,
//   raster_may_hit, over the screen rectangle of a warp's whole run of
//   pixels (a static table).  The warp tests 16 runs at once, one (run,
//   box) per lane, then keeps the ballot: the test costs a lane one
//   evaluation per 16 runs.  A test per pixel and a vote of the warp's
//   lanes skips more casts (73 % / 88 % of cart / pole casts on main-path
//   poses, against 67 % / 82 %) but costs each pixel about two fifths of
//   its casts' work, and was slower (PERF.md).  A skipped box takes the
//   cast's miss values (q = -BIG, hit false; the Lambert value of a miss is
//   never read).  RenderParams.cull = 0 turns the cull off (every box is
//   cast); the wrapper always sets 1.

// Why the interval test is conservative (the plain version is
// raycast.raster_may_hit; tests/test_torch_raster_cull.py holds it against
// the cast).  For a sub-ray (px, py) inside a rectangle [xlo, xhi] x [ylo,
// yhi] the cast computes, per axis k, w = (A + B px) + C py, a = w inv_u and
// b = w inv_l, each product and sum rounded to nearest in float32, then
// q_lo = max(a_k, lb_k) and q_hi = min(ub_k) with ub_k = ahead ? b : BIG,
// lb_k = ahead ? -BIG : b, and reports a hit iff q_hi >= max(q_lo, 1e-30).
// 1. Round-to-nearest is monotone: x <= y gives rn(x) <= rn(y); and rd(x)
//    <= rn(x) <= ru(x).  So if the exact result of an operation lies in
//    [lo, hi] for every input in the input intervals, its rounded value
//    lies in [rd(lo), ru(hi)].
// 2. B px over px in [xlo, xhi] is monotone in px: its least value is at
//    xlo where B >= 0, at xhi where B < 0, so rd(B x_corner) bounds every
//    rn(B px) from below, and likewise from above, and for C py.  A sum is
//    monotone in both terms.  Carried through w's order of rounding, this
//    bounds every float32 value of w the cast can compute in the rectangle
//    by [w_lo, w_hi].
// 3. inv_u = 1/U > 0 (U = |g| + he): a >= rd(w_lo inv_u).  inv_l > 0
//    exactly where the near plane is ahead (L > 0 after the clamp; L = 0
//    clamps to +1e-7), so then ub = b <= ru(w_hi inv_l), and elsewhere
//    inv_l < 0 and lb = b >= rd(w_hi inv_l) = -ru(w_hi |inv_l|).  The ±BIG
//    routes are constants.
// 4. max and min of finite floats are exact: max(q_lo, 1e-30) >= q_lo_lo =
//    max(1e-30, the lower bounds) and q_hi <= q_hi_hi = min(the upper
//    bounds).  Where q_hi_hi < q_lo_lo, no sub-ray in the rectangle hits.
//    A box whose A, B, C, 1/U or 1/L is not finite is never culled, and
//    neither is one whose bounds hold a NaN (from an overflow of w; fminf
//    and fmaxf would drop it, so it is tested for explicitly).
// No margin enters: the bounds are those of the float32 values themselves,
// whether or not the eye is inside a slab (K3's CULL_ZMIN rule has no
// counterpart).  A pixel's table rectangle is the exact min/max of its
// sub-rays' px and py, a run's the min/max over its pixels, so the warp
// skips a box only where every sub-ray of every pixel it holds misses it.

// Ratio mode (K5b, recip=False: pallas_kernel.py:210,313-316; math of
// raycast._ray_obb_affine's division-free branch).  The slab bounds stay
// ratios n/p with p > 0 and are compared by cross-multiplying; the boxes are
// ordered by nc*dp <= np*dc.  Its setup (ratio_setup) and cast (ratio_cast)
// round every step as written, like the raster's, so the cross-multiplied
// compares flip no tie against the plain version: the mode is exact and
// free of division.  It runs in render_slab_kernel<RATIO>: K3's block, warps,
// tables, staging and cull rectangle, with ratio_setup in place of box_setup
// (the 16 setup lanes compute it; the rectangle is cull_rect of its floats)
// and ratio_cast in place of cast.  A skipped cast takes the ratio cast's
// miss values (num = BIG, den = 1, hit false), so the order compare and the
// shading see what they see on a miss.
//
// Why K3's rectangle is conservative for the ratio cast.  Per axis k the
// cast forms d = (A + B px) + C py rounded as written (|d - d_exact| <= 3
// eps S + O(eps^2), S as in K3's step 1), s = sign(d), p = max(|d|, 1e-9)
// and the sums n_lo = rn(-he - s o), n_hi = rn(he - s o) (s o is exact).
// Write D_k = s p_k, N_k = he_k + |o_k|, and L_k = n_lo/p, H_k = n_hi/p
// (exact ratios of the floats).
// 1. Direction.  |D_k - d_exact,k| <= 3 eps S + 1e-9: within K3's bound on
//    |e_k| (6 eps S + 1.01e-9); the 1e-9 floor plays the part of K3's
//    s*1e-9 bias.
// 2. Slabs.  For p > 0 the slab interval of direction component D_k for
//    half extent h is exactly [(-h - s o)/p, (h - s o)/p], and n_lo, n_hi
//    lie within eps N_k of -he - s o and he - s o.
// 3. Compares.  Every product the cascade compares is 0 or a normal float
//    (while he_k >= 1e-20; none overflows, by K3's step 3), so |rn(z) - z|
//    <= eps |z|, and rn(x) > rn(y) decides as x > y wherever |x - y| > eps
//    (|x| + |y|).  Divided by its positive denominators, a compare errs only
//    between ratios a, b with |a - b| <= eps (|a| + |b|), which share their
//    sign and agree to 2.01 eps |a|; a chain of two compares to 4.04 eps.
//    So the entry the cascade keeps, t_e = n/pd, has L_k <= t_e + 4.04 eps
//    |L_k| for every k, and the exit t_x = m/q has H_k >= t_x - 4.04 eps
//    |H_k|.
// 4. Hit.  A reported hit is rn(m pd) >= rn(n q) and m > 0: t_x > 0, t_e
//    <= t_x + 2.01 eps t_x, and (by 3) H_k > 0 with t_x <= H_k (1 + 4.04
//    eps).  Take t = t_x.  Since |n_lo|, |n_hi| <= N_k (1 + eps), t_x p_k
//    <= (1 + 6 eps) N_k, so (L_k - t) p_k <= (4.05 + 2.02) eps N_k and (t -
//    H_k) p_k <= 4.05 eps N_k.  With step 2, the exact ray o + t D, t > 0,
//    lies in the box grown by 7.1 eps N_k < 8 eps N_k on every axis.
// K3's steps 2-5 then hold as they stand: cull_rect grows the box by
// CULL_SAFETY x 4 eps N_k = 64 eps N_k, eight times the 8 eps needed here,
// and widens the rectangle for K3's bound on the direction, which covers
// step 1 twice over.  ratio_setup's floats are raycast._slab_setup's bit
// for bit, so raycast.slab_cull_rect and slab_cast_mask are K5b's plain
// predicate; tests/test_torch_cull.py holds them against the ratio cast.
//
// Hoisted raster (K5c, raster + hoist: pallas_kernel.py:111-161 packing,
// :226-237 reading, :393-409 and :489-499 launches).  A render is two
// launches.  pack_setups_kernel computes raster_setup for every (repeat,
// env, camera, box) into a packed (R, E, C*2*22) table, per camera the cart
// then the pole; render_raster_kernel<HOIST> is K5a's kernel with the setup
// copied from that table, coalesced, in place of computed: the cull, run
// votes, tables and staging are K5a's, and so are the bits of the setup, so
// the frames are K5a's byte for byte.
// - The setup pass is bound by latency, not work (each box runs six exact
//   divisions in a serial chain; the table is 88 bytes per box), and at the
//   main path's size by little more than a launch's fixed cost.  Four
//   lanes per box: lanes 0-2 compute axes 0-2 of raster_setup (the rotation
//   and the eye offset in each, then the axis's terms, raster_setup_axis:
//   the same operations, so the same bits), lane 3 the inside flag from the
//   three axes' `ahead` by one ballot.  A block of PACK_THREADS takes 64
//   consecutive rows of the table, so its poses and its output are each one
//   contiguous range: the poses are read as float4s into shared memory, the
//   rows written into shared memory and out as float4s.
//
// Bound planes on the tensor cores (K5d, raster + mxu:
// pallas_kernel.py:248-295).  The 18 routed bound planes of both boxes (a,
// ub, lb for 3 axes) are affine in (px, py, 1) with per-env coefficients;
// the `ahead` routing folds into them (a scale on the px/py columns, a ±BIG
// bias on the ones column).  The TPU design moved 24 of 110 VPU operations
// per ray to an idle matrix unit.  That premise does not hold here: the 18
// planes of a ray cost about 36 FP32 operations, against 18 x 3 x 2 x 3 =
// 324 TF32 flops of 3xTF32 products, and at 495 against 67 TFLOP/s the
// tensor cores are no cheaper per ray even at their peak.  The aim is a
// mode that costs about what K5a costs, its products beside the FP32 work.
// - render_raster_mxu_kernel takes K5a's block, warp layout, tables and
//   cull (the cull's bounds widened, below).  Per warp and sub-ray, the 32
//   rays sit on the M side of mma.sync m16n8k4 TF32 products (two m-tiles,
//   depth (px, py, 1, 0): no wasted depth), the planes on the N side (three
//   n8 tiles: the cart's lower planes a_0..2, lb_0..2 and two copies of a_0;
//   the pole's; the upper planes ub_0..2 and a copy of ub_2 of each box).
//   TF32 keeps ~10 mantissa bits, so each operand is split into a TF32 high
//   part and residual and lo*hi + hi*lo + hi*hi is accumulated in f32
//   (3xTF32, Precision.HIGHEST on the TPU; lo*lo dropped): 2 x 3 x 3 = 18
//   products per warp and sub-ray.  The plane operand is built and split
//   once per (block, repeat, camera) and kept in registers; the rays' A
//   operands come split from a static table.  The accumulator then holds
//   each ray's 24 columns within one lane quad: each lane folds its share
//   (the max over its lower planes, the first min over its upper ones with
//   its Lambert value, ties to the lower column as in raster_cascade) and
//   two __shfl_xor rounds finish the cascade, each halving the rays a lane
//   holds, with no staging through shared memory.  A copied plane changes
//   no max and no first min.  A warp that casts one box skips the other's
//   lower-plane tile.
// - wgmma is not the tool: its 64-row tiles, read from shared memory, do
//   not fit the 32 rays a warp holds per sub-ray.
// - The bounds differ from K5a's by a few ulp (another rounding order), so
//   frames may differ on silhouette ties.  Where `ahead` is 0 the bias 1e9
//   splits exactly (its residual fits in TF32), so ub is exactly BIG there.
// - Why the widened cull is conservative.  Write u = 2^-24, S_k = |s|(|A| +
//   |B| |px| + |C| |py|) for plane k (s = inv_u or inv_l) and T its exact
//   value s (A + B px + C py) from the float32 setup.  (i) K5a's rounded
//   value lies within 5u S of T (four roundings of w, one of the product).
//   (ii) The product's value: each coefficient is one float32 rounding
//   from exact (u S); the split leaves x = hi + lo + r with |r| <= 2^-22
//   |x|, and dropping lo*lo and the residuals costs at most 3 x 2^-22 S;
//   the f32 accumulation of 9 exact TF32 products through three mma.sync,
//   whose rounding the hardware does not specify (truncation after
//   aligning to the largest term is the worst found), at most 8 x 2^-22 S.
//   So the product is within 12.5 x 2^-22 S < 2^-18 S of K5a's interval
//   bounds.  Each plane's bound is widened by MXU_WIDEN = CULL_SAFETY x
//   2^-18 = 2^-14 times S_k, S_k bounded with ray_abs >= |px|, |py|, rounded
//   up (raster_block_setup).  The ±BIG routes have zero scale and split
//   exactly: they need no widening.  tests/test_torch_raster_cull.py holds
//   the widening against an emulation of the product under seven
//   accumulation orders and roundings.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define MAX_CAMS 2
#define SLAB_W 15    // o_l(3) A(3) B(3) C(3) ldot(3)
#define RASTER_W 22  // A(3) B(3) C(3) inv_u(3) inv_l(3) ahead(3) cand(3) inside(1)
#define BIG 1e9f

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
  int cull;                  // the raster kernels' cull: 1 on, 0 off (every box cast)
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

// Axis k of the raster setup of one box seen from camera `cam`
// (raycast._obb_q_setup, rounded as the plain version rounds it): writes
// out[k], out[3 + k], ..., out[18 + k] and returns whether the near plane
// lies ahead.  col: column k of the box's rotation (rot_rn); rel: the box's
// centre less the eye; he_k: its half extent on the axis.
__device__ __forceinline__ bool raster_setup_axis(const RenderParams& p, int cam,
                                                  const float col[3], const float rel[3],
                                                  float he_k, int k, float* out) {
  const float* fwd = p.basis[cam];
  const float* right = p.basis[cam] + 3;
  const float* up = p.basis[cam] + 6;
  const auto dot = [&](const float* v) {
    return add(add(mul(col[0], v[0]), mul(col[1], v[1])), mul(col[2], v[2]));
  };
  const float g = dot(rel);
  const float sg = sign(g);
  const float ga = mul(sg, g);
  float lo = sub(ga, he_k);
  const float hi = add(ga, he_k);
  const float sl = sign(lo);
  lo = mul(sl, fmaxf(mul(sl, lo), 1e-7f));
  const bool ahead = lo > 0.0f;
  out[k] = mul(sg, dot(fwd));
  out[3 + k] = mul(sg, dot(right));
  out[6 + k] = mul(sg, dot(up));
  out[9 + k] = 1.0f / hi;   // exact division (nvcc's default -prec-div=true)
  out[12 + k] = 1.0f / lo;
  out[15 + k] = ahead ? 1.0f : 0.0f;
  out[18 + k] = mul(-sg, dot(p.light));
  return ahead;
}

// The box's centre less the eye of camera `cam`, rounded as written.
__device__ __forceinline__ void eye_offset(const RenderParams& p, int cam, const float* pose,
                                           float rel[3]) {
  for (int i = 0; i < 3; ++i) rel[i] = sub(pose[i], p.eye[cam][i]);
}

// Per-env setup of one box seen from one camera for the raster mode: its
// three axes (raster_setup_axis), then the eye-inside flag.  pose: [pos(3)
// quat(4)] of the box; he: its half extents.
__device__ void raster_setup(const RenderParams& p, int cam, const float* pose,
                             const float he[3], float* out) {
  float r[3][3], rel[3];
  rot_rn(pose, r);
  eye_offset(p, cam, pose, rel);
  bool any_ahead = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float col[3] = {r[0][k], r[1][k], r[2][k]};
    any_ahead = raster_setup_axis(p, cam, col, rel, he[k], k, out) || any_ahead;
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

#define CULL_EPS 5.9604644775390625e-8  // 2^-24, float32's unit roundoff
#define CULL_SAFETY 16.0
#define CULL_ZMIN 1e-3   // metres: nearest corner depth for which a box is culled
#define CULL_FLOOR 1e-6  // screen units added to the margin
#define CULL_BIG 1e18    // largest S and he_k + |o_k| for which a box is culled

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
// outside which its slab cast, reciprocal or ratio, is a miss (the argument
// is in the header; raycast.slab_cull_rect is the plain version).  su:
// box_setup's or ratio_setup's floats (o, A, B, C); he: the box's half
// extents.  Called by 8 lanes of a group
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
  bool small = s <= CULL_BIG;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double h = (double)he[k];
    const double grown = h + CULL_SAFETY * 4.0 * CULL_EPS * (h + fabs(o[k]));
    const bool plus = (corner >> k) & 1;
    v[k] = (plus ? grown : -grown) - o[k];
    small = small && h + fabs(o[k]) <= CULL_BIG;
  }
  const double z = dot_d(v, ah);
  const double x = dot_d(v, bh) / z, y = dot_d(v, ch) / z;
  bool ok = z >= CULL_ZMIN && ea <= 0.25 && small && isfinite(x) && isfinite(y);
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
// (the others keep the cast's miss values), shaded and summed.  MODE: SLAB
// (the reciprocal cast, ordered by depth) or RATIO (the ratio cast, ordered
// by nc*dp <= np*dc).  rays: the pixel's first sub-ray in the (C, p2, n)
// table of (px, py, ground value, sky mask).
template <int MODE, bool CART, bool POLE>
__device__ __forceinline__ void slab_pixel(const RenderParams& p, const float* su_c,
                                           const float* su_p, const float4* __restrict__ rays,
                                           float& fa, float& fb, float& fg, float& fs) {
  for (int sidx = 0; sidx < p.p2; ++sidx) {
    const float4 ray = rays[sidx * p.n];
    const float px = ray.x, py = ray.y, gval = ray.z, smask = ray.w;
    float dc = 1e9f, dp = 1e9f, lam_c = 0.0f, lam_p = 0.0f;
    bool hit_c = false, hit_p = false, sel_c;
    if (MODE == RATIO) {
      float den_c = 1.0f, den_p = 1.0f;
      if (CART) ratio_cast(su_c, p.he[0], px, py, dc, den_c, lam_c, hit_c);
      if (POLE) ratio_cast(su_p, p.he[1], px, py, dp, den_p, lam_p, hit_p);
      sel_c = hit_c && (mul(dc, den_p) <= mul(dp, den_c));
    } else {
      if (CART) cast(su_c, p.he[0], px, py, dc, lam_c, hit_c);
      if (POLE) cast(su_p, p.he[1], px, py, dp, lam_p, hit_p);
      sel_c = hit_c && (dc <= dp);
    }
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
// shared-memory instructions and the kernel 8 % of its speed.)  MODE: SLAB
// (K3/K4: box_setup, the reciprocal cast) or RATIO (K5b: ratio_setup, the
// ratio cast); the cull rectangle is cull_rect of the setup's floats in both.
template <int MODE, bool STAGED>
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
    if (MODE == RATIO) {
      ratio_setup(p, cam, pose + 7 * box, su);
    } else {
      box_setup(p, cam, pose + 7 * box, su);
    }
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
          slab_pixel<MODE, true, true>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else if (cart) {
          slab_pixel<MODE, true, false>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else if (pole) {
          slab_pixel<MODE, false, true>(p, su_c, su_p, ray, fa, fb, fg, fs);
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

#define PACK_THREADS 256
#define PACK_ROWS (PACK_THREADS / 4)  // rows of the setup table per block, 4 lanes each

// K5c's setup pass: poses (R, E, 16) → setups (R, E, C*2*22), row (re * C +
// cam) * 2 + box the raster setup of box `box` seen from camera `cam` at
// (repeat, env) re (raycast.pack_setups' layout).  A block takes PACK_ROWS
// consecutive rows; PACK_ROWS is a multiple of 2 * C, so they are whole
// (repeat, env) pose rows.  Lane 4b + k of the block computes axis k of row
// b (k < 3) or its inside flag (k = 3).  `rows` = R * E * C * 2; both
// arrays are contiguous (16-byte aligned rows).
__global__ void __launch_bounds__(PACK_THREADS) pack_setups_kernel(
    RenderParams p, const float4* __restrict__ poses, float4* __restrict__ setups, int rows) {
  __shared__ float4 pose_s[PACK_ROWS / 2 * 4];          // at C = 1: 32 pose rows of 16 floats
  __shared__ float4 out_s[PACK_ROWS * RASTER_W / 4];    // the block's rows of the table
  const int cams = p.num_cams, per_pose = 2 * cams;
  const int row0 = blockIdx.x * PACK_ROWS, nrows = min(PACK_ROWS, rows - row0);
  const int pose0 = row0 / per_pose;
  for (int i = threadIdx.x; i < nrows / per_pose * 4; i += PACK_THREADS) {
    pose_s[i] = poses[(size_t)pose0 * 4 + i];
  }
  __syncthreads();
  const int b = threadIdx.x >> 2, k = threadIdx.x & 3;
  float* out = reinterpret_cast<float*>(out_s) + b * RASTER_W;
  bool ahead = false;
  if (b < nrows && k < 3) {
    const int row = row0 + b, box = row & 1, cam = (row >> 1) % cams;
    const float* pose = reinterpret_cast<const float*>(pose_s) + (row / per_pose - pose0) * 16 +
                        7 * box;
    float r[3][3], rel[3];
    rot_rn(pose, r);
    eye_offset(p, cam, pose, rel);
    // Column k of the rotation, picked without indexing a register array.
    float col[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) col[i] = k == 0 ? r[i][0] : k == 1 ? r[i][1] : r[i][2];
    ahead = raster_setup_axis(p, cam, col, rel, p.he[box][k], k, out);
  }
  // The row's three axes vote: its lanes are bits 4b'..4b'+2 of the ballot
  // (b' the row's place in the warp).
  const unsigned votes = __ballot_sync(0xffffffffu, ahead);
  if (b < nrows && k == 3) out[21] = (votes >> (threadIdx.x & 28)) & 7u ? 0.0f : 1.0f;
  __syncthreads();
  float4* dst = setups + (size_t)row0 * RASTER_W / 4;
  for (int i = threadIdx.x; i < nrows * RASTER_W / 4; i += PACK_THREADS) dst[i] = out_s[i];
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

// d += a * b on the tensor cores: one m16n8k4 TF32 product, f32 accumulator.
// Fragments (g = lane / 4, t = lane % 4): a0 (row g, depth t), a1 (row g + 8,
// depth t); b (depth t, column g); d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_k4(float d[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// One bound plane as a row of coefficients over the rays' components (px,
// py, gval, smask, 1, 0, 0, 0) (raycast.bound_rows): row = 3*kind + k of a
// box, kind 0 the far plane a = w*inv_u, 1 the upper bound ub = ahead ?
// w*inv_l : BIG, 2 the lower bound lb = ahead ? -BIG : w*inv_l.
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

#define RASTER_SW 32  // floats per box of the raster kernels' setup: raster_setup's 22,
                      // the cull flag [22], K5d's widenings [24..29]
#define MXU_WIDEN 6.103515625e-05f  // 2^-14: CULL_SAFETY x the header's bound 2^-18
// Static shared memory of the raster kernels (a block's repeats x cameras,
// at most SLAB_MAX_REPS, x 2 boxes) and what is left of the default 48 KiB
// for a block's frames (cuda_render.RASTER_FRAME_BYTES).
#define RASTER_STATIC_BYTES (SLAB_MAX_REPS * 2 * RASTER_SW * 4)
#define RASTER_FRAME_BYTES (48 * 1024 - RASTER_STATIC_BYTES)

// The raster kernels' setup, into setup[rl * C + cam][box] for repeat rl,
// camera cam and box: computed by thread t = (rl * C + cam) * 2 + box (t <
// nrep*C*2), or, HOIST, copied from K5c's packed table by the whole block,
// coalesced (a repeat's C*2*22 floats are contiguous there), with a barrier
// after.  Then thread t computes the box's cull flag (the cull on and A, B,
// C, 1/U, 1/L finite) and, for K5d (WIDEN), the widening of each plane's
// bound, rounded up: MXU_WIDEN |s| (|A| + ray_abs (|B| + |C|)), s = inv_u
// (far) or inv_l (near).  Every thread of the block must call it.
template <bool HOIST, bool WIDEN>
__device__ void raster_block_setup(const RenderParams& p, const float* __restrict__ poses,
                                   const float* __restrict__ setups,
                                   float (*setup)[2][RASTER_SW], int E, int e, int rep0,
                                   int nrep) {
  const int cams = p.num_cams, t = threadIdx.x;
  if (HOIST) {
    const int w = 2 * RASTER_W * cams;
    for (int i = t; i < nrep * w; i += blockDim.x) {
      const int rl = i / w, j = i - rl * w, row = j / RASTER_W;
      setup[rl * cams + (row >> 1)][row & 1][j - row * RASTER_W] =
          setups[((size_t)(rep0 + rl) * E + e) * w + j];
    }
    __syncthreads();
  }
  if (t >= nrep * cams * 2) return;
  const int box = t & 1, cam = (t >> 1) % cams, rl = (t >> 1) / cams;
  float* su = setup[rl * cams + cam][box];
  if (!HOIST) {
    raster_setup(p, cam, poses + ((size_t)(rep0 + rl) * E + e) * 16 + 7 * box, p.he[box], su);
  }
  bool finite = true;
  for (int i = 0; i < 15; ++i) finite = finite && isfinite(su[i]);
  su[22] = p.cull && finite ? 1.0f : 0.0f;
  if (WIDEN) {
    for (int k = 0; k < 3; ++k) {
      const float s = __fadd_ru(fabsf(su[k]),
                                __fmul_ru(p.ray_abs, __fadd_ru(fabsf(su[3 + k]), fabsf(su[6 + k]))));
      su[24 + k] = __fmul_ru(MXU_WIDEN, __fmul_ru(fabsf(su[9 + k]), s));
      su[27 + k] = __fmul_ru(MXU_WIDEN, __fmul_ru(fabsf(su[12 + k]), s));
    }
  }
}

// Whether the raster cast of a box (su: its setup in the raster kernels'
// layout) can hit a sub-ray in the screen rectangle r = (xlo, xhi, ylo,
// yhi): false only where the interval argument of the header proves a miss
// (a NaN bound casts: fminf/fmaxf drop a NaN operand, so it is caught
// before them).  WIDEN: K5d's bounds, widened for its product.
// raycast.raster_may_hit is the plain version.
template <bool WIDEN>
__device__ __forceinline__ bool raster_may_hit(const float* su, float4 r) {
  if (su[22] < 0.5f) return true;
  float q_lo = 1e-30f, q_hi = 0.0f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = su[k], b = su[3 + k], c = su[6 + k];
    const bool bp = b >= 0.0f, cp = c >= 0.0f;
    const float w_lo = __fadd_rd(__fadd_rd(a, __fmul_rd(b, bp ? r.x : r.y)),
                                 __fmul_rd(c, cp ? r.z : r.w));
    const float w_hi = __fadd_ru(__fadd_ru(a, __fmul_ru(b, bp ? r.y : r.x)),
                                 __fmul_ru(c, cp ? r.w : r.z));
    float far = __fmul_rd(w_lo, su[9 + k]);            // a = w inv_u, inv_u > 0: from below
    float near = __fmul_ru(w_hi, fabsf(su[12 + k]));   // |b| side of b = w inv_l: from above
    if (WIDEN) {
      far = __fsub_rd(far, su[24 + k]);
      near = __fadd_ru(near, su[27 + k]);
    }
    nan = nan || isnan(far) || isnan(near);
    const bool ahead = su[15 + k] > 0.5f;  // inv_l > 0: b bounds q from above, else from below
    const float ub = ahead ? near : BIG;
    q_hi = k == 0 ? ub : fminf(q_hi, ub);
    q_lo = fmaxf(q_lo, fmaxf(far, ahead ? -BIG : -near));
  }
  return nan || !(q_hi < q_lo);
}

// The sub-rays of one pooled pixel in K5a: cast against the boxes the warp
// keeps (the others keep the cast's miss values), shaded and summed; as
// slab_pixel.
template <bool CART, bool POLE>
__device__ __forceinline__ void raster_pixel(const RenderParams& p, const float* su_c,
                                             const float* su_p, const float4* __restrict__ rays,
                                             float& fa, float& fb, float& fg, float& fs) {
  for (int sidx = 0; sidx < p.p2; ++sidx) {
    const float4 ray = rays[sidx * p.n];
    float qc = -BIG, qp = -BIG, lam_c = 0.0f, lam_p = 0.0f;
    bool hit_c = false, hit_p = false;
    if (CART) raster_cast(su_c, ray.x, ray.y, qc, lam_c, hit_c);
    if (POLE) raster_cast(su_p, ray.x, ray.y, qp, lam_p, hit_p);
    const bool sel_c = hit_c && (qc >= qp);  // inverse depth: larger is nearer
    shade_fields(p, sel_c, hit_p, lam_c, lam_p, ray.z, ray.w, fa, fb, fg, fs);
  }
}

// The warp's decision to cast the cart and the pole for the pixels of its
// i-th run (run = warp + i * nwarps of ceil(n / 32), in the tables'
// order): every 16 runs the warp tests the next 16 at once, lane l the box
// l & 1 of run warp + (i + l / 2) * nwarps, against the rectangle of the
// run's sub-rays (runs_c: the camera's row of the run table), and keeps
// the ballot in `votes`.  Warp-uniform; every lane must call it.
template <bool WIDEN>
__device__ __forceinline__ void warp_votes(const float* su_c, const float* su_p,
                                           const float4* __restrict__ runs_c, int nruns, int i,
                                           unsigned& votes, bool& cart, bool& pole) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  if ((i & 15) == 0) {
    const int run = (threadIdx.x >> 5) + (i + (lane >> 1)) * nwarps;
    votes = __ballot_sync(0xffffffffu, run < nruns && raster_may_hit<WIDEN>(
                                                          lane & 1 ? su_p : su_c, runs_c[run]));
  }
  cart = (votes >> (2 * (i & 15))) & 1u;
  pole = (votes >> (2 * (i & 15) + 1)) & 1u;
}

// K5a (HOIST false) and K5c (HOIST), the raster mode with culling.  poses:
// (R, E, 16); setups: K5c's packed table (R, E, C*2*22), read where HOIST
// in place of the poses; rays and pixels: render_slab_kernel's tables;
// runs: (C, ceil(n / 32)) float4, per run of 32 pixels in the tables' order
// (the last run of a camera shorter) the rectangle (xlo, xhi, ylo, yhi) of
// its pixels' sub-rays; out: (E, R, C*3*n) uint8.  Grid (E, ceil(R /
// reps)), SLAB_THREADS threads; a block renders `reps` repeats of one env,
// its frames staged in shared memory where STAGED (as render_slab_kernel's).
// Each warp tests its run's rectangle (warp_votes) unless p.cull is 0.
template <bool HOIST, bool STAGED>
__global__ void __launch_bounds__(SLAB_THREADS) render_raster_kernel(
    RenderParams p, const float* __restrict__ poses, const float* __restrict__ setups,
    const float4* __restrict__ rays, const float4* __restrict__ pixels,
    const float4* __restrict__ runs, uint8_t* __restrict__ out, int E, int R, int reps) {
  const int e = blockIdx.x, rep0 = blockIdx.y * reps;
  const int nrep = min(reps, R - rep0), cams = p.num_cams;
  __shared__ float setup[SLAB_MAX_REPS][2][RASTER_SW];
  static_assert(sizeof(setup) == RASTER_STATIC_BYTES, "RASTER_STATIC_BYTES");
  extern __shared__ uint8_t frames[];  // nrep frames, as in out, where staged
  raster_block_setup<HOIST, false>(p, poses, setups, setup, E, e, rep0, nrep);
  __syncthreads();

  const int n = p.n, p2 = p.p2, n_pad = (n + 31) & ~31, nruns = n_pad >> 5;
  const int frame_w = cams * 3 * n;
  uint8_t* o = out + ((size_t)e * R + rep0) * frame_w;
  for (int rl = 0; rl < nrep; ++rl) {
    uint8_t* dst = (STAGED ? frames : o) + rl * frame_w;
    for (int cam = 0; cam < cams; ++cam) {
      const float* su_c = setup[rl * cams + cam][0];
      const float* su_p = setup[rl * cams + cam][1];
      unsigned votes = 0;
      for (int q = threadIdx.x, i = 0; q < n_pad; q += blockDim.x, ++i) {
        bool cart, pole;
        warp_votes<false>(su_c, su_p, runs + cam * nruns, nruns, i, votes, cart, pole);
        if (q >= n) continue;
        const float4 bg = pixels[2 * (cam * n + q) + 1];
        const float4* ray = rays + cam * p2 * n + q;
        float fa = 0.0f, fb = 0.0f, fg = 0.0f, fs = 0.0f;
        if (cart && pole) {
          raster_pixel<true, true>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else if (cart) {
          raster_pixel<true, false>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else if (pole) {
          raster_pixel<false, true>(p, su_c, su_p, ray, fa, fb, fg, fs);
        } else {
          fg = bg.x;
          fs = bg.y;
        }
        store_pixel(p, fa, fb, fg, fs, dst, cam, static_cast<int>(bg.z));
      }
    }
  }
  if (!STAGED) return;
  __syncthreads();
  for (int i = threadIdx.x; i < nrep * frame_w; i += blockDim.x) o[i] = frames[i];
}

// This lane's B operand of K5d's product for one (repeat, camera): column
// g of each n-tile at depth t of (px, py, 1, 0), split into TF32 parts, and
// the Lambert candidates of its two columns of n-tile 2.  The columns:
// n-tiles 0 and 1 the cart's and the pole's lower planes a_0..2, lb_0..2
// and two copies of a_0; n-tile 2 the cart's upper planes ub_0..2 and a
// copy of ub_2, then the pole's.  A copy changes no max or first min.
__device__ void mxu_operand(const float* su_c, const float* su_p, uint32_t bh[3],
                            uint32_t bl[3], float& cand_a, float& cand_b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
    const int box = nt < 2 ? nt : g >> 2;
    const int row = nt < 2 ? (g < 3 ? g : g < 6 ? g + 3 : 0) : 3 + min(g & 3, 2);
    float coef[8];
    bound_row(box ? su_p : su_c, row, coef);
    split_tf32(t == 0 ? coef[0] : t == 1 ? coef[1] : t == 2 ? coef[4] : 0.0f, bh[nt], bl[nt]);
  }
  const float* su = t & 2 ? su_p : su_c;
  cand_a = su[18 + 2 * (t & 1)];
  cand_b = su[18 + min(2 * (t & 1) + 1, 2)];
}

// The p2 sub-rays of a warp's 32 pooled pixels through K5d's product.  Per
// sub-ray: 2 m-tiles of 16 rays x 3 n-tiles of 8 planes, each three
// m16n8k4 products (lo*hi, hi*lo, hi*hi, the 3xTF32 sum); lane (g, t) then
// holds columns 2t, 2t+1 of every n-tile for rays j = 0..3 (pixels g + 8j).
// It folds them (the max over its lower planes, the first min over its
// upper ones with its Lambert value), two __shfl_xor rounds finish the
// cascade (t ^ 1: the same box's upper planes, the even lane's columns
// first; t ^ 2: the other box's), each round halving the rays a lane holds,
// and lane (g, t) shades pixel g + 8t.  Skipped boxes take the cast's miss
// values, and their lower planes are not multiplied.  frag: the lane's A
// operand of sub-ray 0; ray: its pixel's first sub-ray.
template <bool CART, bool POLE>
__device__ __forceinline__ void mxu_pixel(const RenderParams& p, const float* su_c,
                                          const float* su_p, const uint32_t bh[3],
                                          const uint32_t bl[3], float cand_a, float cand_b,
                                          const float4* __restrict__ ray,
                                          const float4* __restrict__ frag, int frag_stride,
                                          float& fa, float& fb, float& fg, float& fs) {
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x & 3;
  const bool odd = t & 1, upper = t & 2;
  for (int sidx = 0; sidx < p.p2; ++sidx) {
    const float4 hi4 = frag[sidx * frag_stride], lo4 = frag[sidx * frag_stride + 1];
    const float4 own = ray[sidx * p.n];
    const uint32_t ah[4] = {__float_as_uint(hi4.x), __float_as_uint(hi4.y),
                            __float_as_uint(hi4.z), __float_as_uint(hi4.w)};
    const uint32_t al[4] = {__float_as_uint(lo4.x), __float_as_uint(lo4.y),
                            __float_as_uint(lo4.z), __float_as_uint(lo4.w)};
    float d[2][3][4] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        if ((nt == 0 && !CART) || (nt == 1 && !POLE)) continue;
        mma_k4(d[mt][nt], al[2 * mt], al[2 * mt + 1], bh[nt]);
        mma_k4(d[mt][nt], ah[2 * mt], ah[2 * mt + 1], bl[nt]);
        mma_k4(d[mt][nt], ah[2 * mt], ah[2 * mt + 1], bh[nt]);
      }
    }
    // The lane's share, per ray j (m-tile j / 2, row half j % 2).
    float lc[4], lp[4], hq[4], hl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mt = j >> 1, h = 2 * (j & 1);
      lc[j] = fmaxf(d[mt][0][h], d[mt][0][h + 1]);
      lp[j] = fmaxf(d[mt][1][h], d[mt][1][h + 1]);
      hl[j] = d[mt][2][h + 1] < d[mt][2][h] ? cand_b : cand_a;
      hq[j] = fminf(d[mt][2][h], d[mt][2][h + 1]);
    }
    // Round 1, with lane t ^ 1: keep rays 2i + odd, send rays 2i + !odd.
    float lc2[2], lp2[2], hq2[2], hl2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int a = 2 * i, b = 2 * i + 1;
      if (CART) lc2[i] = fmaxf(odd ? lc[b] : lc[a], __shfl_xor_sync(full, odd ? lc[a] : lc[b], 1));
      if (POLE) lp2[i] = fmaxf(odd ? lp[b] : lp[a], __shfl_xor_sync(full, odd ? lp[a] : lp[b], 1));
      const float kq = odd ? hq[b] : hq[a], kl = odd ? hl[b] : hl[a];
      const float rq = __shfl_xor_sync(full, odd ? hq[a] : hq[b], 1);
      const float rl = __shfl_xor_sync(full, odd ? hl[a] : hl[b], 1);
      hl2[i] = (odd ? rq <= kq : rq < kq) ? rl : kl;
      hq2[i] = fminf(kq, rq);
    }
    // Round 2, with lane t ^ 2: keep ray t.
    float q_lo_c = 0.0f, q_lo_p = 0.0f;
    if (CART) q_lo_c = fmaxf(upper ? lc2[1] : lc2[0],
                             __shfl_xor_sync(full, upper ? lc2[0] : lc2[1], 2));
    if (POLE) q_lo_p = fmaxf(upper ? lp2[1] : lp2[0],
                             __shfl_xor_sync(full, upper ? lp2[0] : lp2[1], 2));
    const float kq = upper ? hq2[1] : hq2[0], kl = upper ? hl2[1] : hl2[0];
    const float rq = __shfl_xor_sync(full, upper ? hq2[0] : hq2[1], 2);
    const float rl = __shfl_xor_sync(full, upper ? hl2[0] : hl2[1], 2);
    const float q_hi_c = upper ? rq : kq, lam_c = upper ? rl : kl;
    const float q_hi_p = upper ? kq : rq, lam_p = upper ? kl : rl;
    const bool hit_c = CART && q_hi_c >= fmaxf(q_lo_c, 1e-30f);
    const bool hit_p = POLE && q_hi_p >= fmaxf(q_lo_p, 1e-30f);
    const float qc = hit_c ? (su_c[21] > 0.5f ? q_lo_c : q_hi_c) : -BIG;
    const float qp = hit_p ? (su_p[21] > 0.5f ? q_lo_p : q_hi_p) : -BIG;
    const bool sel_c = hit_c && (qc >= qp);
    shade_fields(p, sel_c, hit_p, lam_c, lam_p, own.z, own.w, fa, fb, fg, fs);
  }
}

// K5d, the raster mode with its bound planes from tensor-core products:
// K5a's block, tables and cull (its bounds widened).  frags: (C, p2,
// ceil(n / 32), 32, 8) float32, per run, sub-ray and lane (g, t) the A
// operand: the TF32 high parts, then the residuals, of component t of (px,
// py, 1, 0) of the run's rays g, g + 8, g + 16, g + 24
// (cuda_render.mxu_fragment_table).  Lane 4g + t renders the run's pixel
// g + 8t.  HOIST reads the setups from K5c's packed table.  Other
// arguments as render_raster_kernel's.
template <bool HOIST, bool STAGED>
__global__ void __launch_bounds__(SLAB_THREADS) render_raster_mxu_kernel(
    RenderParams p, const float* __restrict__ poses, const float* __restrict__ setups,
    const float4* __restrict__ rays, const float4* __restrict__ pixels,
    const float4* __restrict__ runs, const float4* __restrict__ frags,
    uint8_t* __restrict__ out, int E, int R, int reps) {
  const int e = blockIdx.x, rep0 = blockIdx.y * reps;
  const int nrep = min(reps, R - rep0), cams = p.num_cams;
  __shared__ float setup[SLAB_MAX_REPS][2][RASTER_SW];
  extern __shared__ uint8_t frames[];
  raster_block_setup<HOIST, true>(p, poses, setups, setup, E, e, rep0, nrep);
  __syncthreads();

  const int n = p.n, p2 = p.p2, n_pad = (n + 31) & ~31, nruns = n_pad >> 5;
  const int frame_w = cams * 3 * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int slot = (lane >> 2) + 8 * (lane & 3);  // this lane's pixel in its run
  const int frag_stride = 2 * nruns * 32;         // float4s from one sub-ray to the next
  uint8_t* o = out + ((size_t)e * R + rep0) * frame_w;
  for (int rl = 0; rl < nrep; ++rl) {
    uint8_t* dst = (STAGED ? frames : o) + rl * frame_w;
    for (int cam = 0; cam < cams; ++cam) {
      const float* su_c = setup[rl * cams + cam][0];
      const float* su_p = setup[rl * cams + cam][1];
      uint32_t bh[3], bl[3];
      float cand_a, cand_b;
      mxu_operand(su_c, su_p, bh, bl, cand_a, cand_b);
      unsigned votes = 0;
      // Warp-uniform: every lane takes part in each product; a lane past
      // the camera's last pixel renders the last one and stores nothing.
      for (int run = warp, i = 0; run < nruns; run += nwarps, ++i) {
        const int q = run * 32 + slot, qq = min(q, n - 1);
        const float4 bg = pixels[2 * (cam * n + qq) + 1];
        bool cart, pole;
        warp_votes<true>(su_c, su_p, runs + cam * nruns, nruns, i, votes, cart, pole);
        const float4* ray = rays + cam * p2 * n + qq;
        const float4* frag = frags + 2 * (((size_t)cam * p2 * nruns + run) * 32 + lane);
        float fa = 0.0f, fb = 0.0f, fg = 0.0f, fs = 0.0f;
        if (cart && pole) {
          mxu_pixel<true, true>(p, su_c, su_p, bh, bl, cand_a, cand_b, ray, frag, frag_stride,
                                fa, fb, fg, fs);
        } else if (cart) {
          mxu_pixel<true, false>(p, su_c, su_p, bh, bl, cand_a, cand_b, ray, frag, frag_stride,
                                 fa, fb, fg, fs);
        } else if (pole) {
          mxu_pixel<false, true>(p, su_c, su_p, bh, bl, cand_a, cand_b, ray, frag, frag_stride,
                                 fa, fb, fg, fs);
        } else {
          fg = bg.x;
          fs = bg.y;
        }
        if (q < n) store_pixel(p, fa, fb, fg, fs, dst, cam, static_cast<int>(bg.z));
      }
    }
  }
  if (!STAGED) return;
  __syncthreads();
  for (int i = threadIdx.x; i < nrep * frame_w; i += blockDim.x) o[i] = frames[i];
}

// Launches the render kernel of `mode` (enum Mode) on `stream`.  Every mode
// reads `rays`, the (C, p2, n, 4) table in the tables' order, and `pixels`;
// the raster ones (K5a, K5c, K5d) read `runs`, K5d `frags`, the hoisted
// modes `setups`.  The kernels render `reps` repeats per block, staging
// their frames in shared memory where `staged` (cuda_render.slab_blocking
// chooses both; a choice the kernel cannot run is refused).  Returns
// cudaGetLastError() as an int.
extern "C" int cp_render(const RenderParams* params, const float* poses, const float* rays,
                         const float* setups, const float* pixels, const float* runs,
                         const float* frags, uint8_t* out, int E, int R, int mode, int reps,
                         int staged, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (params->num_cams < 1 || params->num_cams > MAX_CAMS) return bad;
  if (params->cull != 0 && params->cull != 1) return bad;
  if (mode < SLAB || mode > MXU_HOIST) return bad;
  const bool slab = mode == SLAB || mode == RATIO;
  const bool hoist = mode == RASTER_HOIST || mode == MXU_HOIST;
  const bool mxu = mode == MXU || mode == MXU_HOIST;
  if (hoist && setups == nullptr) return bad;
  if (rays == nullptr || pixels == nullptr) return bad;
  if (!slab && runs == nullptr) return bad;
  if (mxu && frags == nullptr) return bad;
  const long frame_w = (long)params->num_cams * 3 * params->n;
  const long budget = slab ? SLAB_FRAME_BYTES : RASTER_FRAME_BYTES;
  if (reps < 1 || reps > min(R, SLAB_THREADS / (16 * params->num_cams)) ||
      (staged && reps * frame_w > budget)) {
    return bad;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(E, (R + reps - 1) / reps);
  const size_t smem = staged ? reps * frame_w : 0;
  const float4* rays4 = reinterpret_cast<const float4*>(rays);
  const float4* pixels4 = reinterpret_cast<const float4*>(pixels);
  const float4* runs4 = reinterpret_cast<const float4*>(runs);
  const float4* frags4 = reinterpret_cast<const float4*>(frags);
  const RenderParams& p = *params;
#define SLAB_LAUNCH(M, S)                                                                   \
  render_slab_kernel<M, S><<<grid, SLAB_THREADS, smem, st>>>(p, poses, rays4, pixels4, out, E, \
                                                             R, reps)
#define RASTER_LAUNCH(H, S)                                                                 \
  render_raster_kernel<H, S><<<grid, SLAB_THREADS, smem, st>>>(p, poses, setups, rays4,    \
                                                               pixels4, runs4, out, E, R, reps)
#define MXU_LAUNCH(H, S)                                                                    \
  render_raster_mxu_kernel<H, S><<<grid, SLAB_THREADS, smem, st>>>(                         \
      p, poses, setups, rays4, pixels4, runs4, frags4, out, E, R, reps)
#define BY_STAGING(LAUNCH, A) \
  if (staged) {               \
    LAUNCH(A, true);          \
  } else {                    \
    LAUNCH(A, false);         \
  }
  switch (mode) {
    case SLAB: BY_STAGING(SLAB_LAUNCH, SLAB) break;
    case RATIO: BY_STAGING(SLAB_LAUNCH, RATIO) break;
    case RASTER: BY_STAGING(RASTER_LAUNCH, false) break;
    case RASTER_HOIST: BY_STAGING(RASTER_LAUNCH, true) break;
    case MXU: BY_STAGING(MXU_LAUNCH, false) break;
    default: BY_STAGING(MXU_LAUNCH, true) break;
  }
#undef BY_STAGING
#undef MXU_LAUNCH
#undef RASTER_LAUNCH
#undef SLAB_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Launches K5c's setup pass on `stream`: poses (R, E, 16) → setups
// (R, E, C*2*22), both contiguous.  Returns cudaGetLastError() as an int.
extern "C" int cp_pack_setups(const RenderParams* params, const float* poses, float* setups,
                              int E, int R, void* stream) {
  if (params->num_cams < 1 || params->num_cams > MAX_CAMS || E < 1 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = R * E * params->num_cams * 2;
  pack_setups_kernel<<<(rows + PACK_ROWS - 1) / PACK_ROWS, PACK_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *params, reinterpret_cast<const float4*>(poses), reinterpret_cast<float4*>(setups), rows);
  return static_cast<int>(cudaGetLastError());
}
