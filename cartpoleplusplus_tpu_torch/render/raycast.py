"""Ray-cast renderer in plain PyTorch: the plain version of kernels K3/K4
(slab mode), K5a (raster mode) and K5b-K5d (the modes below).

Port of cartpoleplusplus_tpu.render.raycast's two main-path cast modes,
computed in float32: the reciprocal slab cascade (``_ray_obb_affine``
with ``recip``, here with an exact reciprocal) for sampled configs, and
the projective inverse-depth raster (``_obb_q_setup`` + ``_obb_q_cast``)
for exact ones (``prefer_raster``).  Rays are screen-affine
(``d = fwd + px·right + py·up``); the static background (ground checker,
sky) is baked host-side; each frame decomposes into four fields (cart
shade, pole shade, ground value, sky mask) that are average-pooled over
the ``p2`` sub-rays of each pooled pixel and combined into plane-major RGB
per camera: ``[cam0 R | cam0 G | cam0 B | cam1 R | …]``.

The other three modes of the JAX package's render kernel are here too, as
``render_frames`` options: the division-free ratio slab cascade
(``recip=False``), the raster with its per-env setup hoisted into a packed
table (``hoist``, :func:`pack_setups`) and the raster with its 18 routed
bound planes computed as one float32 product (``mxu``, :func:`bound_planes`).
"""

from __future__ import annotations

import numpy as np
import torch

from cartpoleplusplus_tpu_torch.physics import soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, SceneParams
from cartpoleplusplus_tpu_torch.render.camera import DEFAULT_CAMERAS, ray_coords, ray_grid

_BIG = 1e9

GROUND_A = (0.82, 0.82, 0.82)
GROUND_B = (0.62, 0.62, 0.62)
CART_COLOR = (0.15, 0.35, 0.9)
POLE_COLOR = (0.9, 0.15, 0.15)
SKY_COLOR = (0.7, 0.85, 1.0)

_L = np.array([0.45, 0.3, 0.84])
_L = _L / np.linalg.norm(_L)
LIGHT_DIR = (float(_L[0]), float(_L[1]), float(_L[2]))
_AMBIENT = 0.35


def pool_ray_layout(pool: int, height: int, width: int, samples: int = 0):
    """Static ray permutation for epilogue pooling → ``(sel, (p2, n, stride))``.

    ``sel`` reorders a row-major H·W ray grid into ``p2`` blocks — block
    ``s`` holds, in pooled-row-major order, every pixel at intra-window
    offset ``s`` — each tail-padded to a 128-aligned ``stride``.
    ``samples`` (0 = all pool²) keeps that many offsets spread along the
    window diagonal.
    """
    n = (height // pool) * (width // pool)
    stride = -(-n // 128) * 128
    idx = np.arange(height * width).reshape(height, width)
    offsets = [(r, c) for r in range(pool) for c in range(pool)]
    if samples and samples < len(offsets):
        pick = np.linspace(0, len(offsets) - 1, samples).round().astype(int)
        offsets = [offsets[i] for i in pick]
    blocks = [idx[r::pool, c::pool].reshape(-1) for r, c in offsets]
    sel = np.concatenate([np.pad(b, (0, stride - n), mode="edge") for b in blocks])
    return sel, (len(offsets), n, stride)


def static_background(dirs, eye):
    """Host-side static background planes: (ground_value, sky_mask), (P,) f32."""
    ndx, ndy, ndz = (np.asarray(d, np.float32) for d in dirs)
    e = (float(eye[0]), float(eye[1]), float(eye[2]))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = np.where(np.abs(ndz) > 1e-9, -e[2] / ndz, _BIG)
    t_g = np.where(t_g > 0.0, t_g, _BIG).astype(np.float32)
    gx = e[0] + t_g * ndx
    gy = e[1] + t_g * ndy
    checker = np.mod(np.floor(gx) + np.floor(gy), 2.0) > 0.5
    gvalid = t_g < _BIG * 0.5
    shade_g = _AMBIENT + (1.0 - _AMBIENT) * max(LIGHT_DIR[2], 0.0)
    ground_val = np.where(
        gvalid, np.where(checker, GROUND_B[0], GROUND_A[0]) * shade_g, 0.0
    ).astype(np.float32)
    sky_mask = (~gvalid).astype(np.float32)
    return ground_val, sky_mask


def ray_planes(config):
    """Static per-ray rows for the config's cameras (the first
    ``num_cameras`` of ``DEFAULT_CAMERAS``).

    Returns ``(planes, cam_meta, (p2, n))``: ``planes`` float32
    (4, C, p2, n) with rows px, py, ground value, sky mask, rays in
    :func:`pool_ray_layout` order without the lane padding; ``cam_meta``
    the per-camera ``(basis, eye)`` float tuples.
    """
    cams = DEFAULT_CAMERAS[: config.num_cameras]
    h, w = config.render_height, config.render_width
    if config.obs_pool > 1:
        sel, (p2, n, stride) = pool_ray_layout(config.obs_pool, h, w, config.obs_samples)
        sel = sel.reshape(p2, stride)[:, :n]
    else:
        p2, n = 1, h * w
        sel = np.arange(n)[None]
    planes = np.zeros((4, len(cams), p2, n), np.float32)
    cam_meta = []
    for c, cam in enumerate(cams):
        dirs, _ = ray_grid(cam, h, w)
        px, py, basis, eye = ray_coords(cam, h, w)
        gval, smask = static_background((dirs[:, 0], dirs[:, 1], dirs[:, 2]), eye)
        for row, values in enumerate((px, py, gval, smask)):
            planes[row, c] = values[sel]
        cam_meta.append((basis, eye))
    return planes, cam_meta, (p2, n)


def pooled_width(config) -> int:
    """Width of the config's pooled frame (``ray_planes``' n = its height ×
    this)."""
    return config.render_width // config.obs_pool if config.obs_pool > 1 else config.render_width


def poses_from_rigid(rigid: RigidState) -> torch.Tensor:
    """RigidState (E, …) → (E, 16) [cart pos quat | pole pos quat | 0 0]."""
    e = rigid.pos.shape[0]
    return torch.cat(
        [rigid.pos[:, 0], rigid.quat[:, 0], rigid.pos[:, 1], rigid.quat[:, 1],
         torch.zeros((e, 2), dtype=rigid.pos.dtype, device=rigid.pos.device)],
        dim=-1,
    )


def _slab_setup(basis, eye, center, quat, light):
    """Per-env scalar algebra of the slab cascade.

    ``center``/``quat``: (E, 1) columns.  Returns ``(o_l, A, B, C, ldot)``,
    3-tuples of (E, 1) columns: the eye in the box frame, the box-frame
    coefficients of the screen-affine direction ``A + B·px + C·py`` and the
    box axes' n·L."""
    fwd, right, up = basis
    r = soa.q_to_mat(quat)
    rel = tuple(eye[i] - center[i] for i in range(3))
    o_l = tuple(r[0][k] * rel[0] + r[1][k] * rel[1] + r[2][k] * rel[2] for k in range(3))
    A = tuple(r[0][k] * fwd[0] + r[1][k] * fwd[1] + r[2][k] * fwd[2] for k in range(3))
    B = tuple(r[0][k] * right[0] + r[1][k] * right[1] + r[2][k] * right[2] for k in range(3))
    C = tuple(r[0][k] * up[0] + r[1][k] * up[1] + r[2][k] * up[2] for k in range(3))
    ldot = tuple(light[0] * r[0][k] + light[1] * r[1][k] + light[2] * r[2][k] for k in range(3))
    return o_l, A, B, C, ldot


def _ray_obb_affine(px, py, basis, eye, center, quat, half_extents, light, recip: bool = True):
    """Screen-affine ray vs oriented box, slab cascade: :func:`_slab_cast`
    of :func:`_slab_setup`."""
    return _slab_cast(px, py, _slab_setup(basis, eye, center, quat, light), half_extents, recip)


def _slab_cast(px, py, setup, half_extents, recip: bool = True):
    """Per-ray work of the slab cascade.

    ``px``/``py``: screen rows, broadcastable against the ``setup`` columns
    of :func:`_slab_setup` ((1, P) against (E, 1), or equal shapes).
    Returns ``(num, den, lambert, hit)`` of the broadcast shape; the depth
    is ``num / den``: entry depth (exit depth when the eye is inside the
    box, ``_BIG`` on a miss), the entry face's n·L and the hit mask.

    ``recip``: slab times through an exact reciprocal, ``num`` the depth
    itself and ``den`` 1.  Else the division-free ratio cascade: the slab
    bounds stay ratios ``n / p`` with ``p > 0`` and are compared by
    cross-multiplying; ``den`` is 1 on a miss.
    """
    o_l, A, B, C, ldot = setup
    d_l = tuple(A[k] + B[k] * px + C[k] * py for k in range(3))
    one = torch.ones_like(d_l[0])

    if recip:
        t_lo, t_hi, cand = [], [], []
        for k in range(3):
            s = 2.0 * (d_l[k] >= 0.0).to(d_l[k].dtype) - 1.0
            inv = torch.reciprocal(d_l[k] + s * 1e-9)
            a = (-float(half_extents[k]) - o_l[k]) * inv
            b = (float(half_extents[k]) - o_l[k]) * inv
            t_lo.append(torch.minimum(a, b))
            t_hi.append(torch.maximum(a, b))
            cand.append(-s * ldot[k])
        tmin, lam = t_lo[0], cand[0]
        for k in (1, 2):
            take = t_lo[k] > tmin
            tmin = torch.maximum(tmin, t_lo[k])
            lam = torch.where(take, cand[k], lam)
        tmax = torch.minimum(torch.minimum(t_hi[0], t_hi[1]), t_hi[2])
        hit = (tmax >= tmin) & (tmax > 0.0)
        t = torch.where(tmin > 0.0, tmin, tmax)
        t = torch.where(hit, t, torch.full_like(t, _BIG))
        return t, one, lam, hit

    s = tuple(2.0 * (d_l[k] >= 0.0).to(d_l[k].dtype) - 1.0 for k in range(3))
    p = tuple(torch.clamp(s[k] * d_l[k], min=1e-9) for k in range(3))
    so = tuple(s[k] * o_l[k] for k in range(3))
    n_lo = tuple(-float(half_extents[k]) - so[k] for k in range(3))
    n_hi = tuple(float(half_extents[k]) - so[k] for k in range(3))
    cand = tuple(-s[k] * ldot[k] for k in range(3))
    n, pd, lam = n_lo[0], p[0], cand[0]
    for k in (1, 2):
        take = n_lo[k] * pd > n * p[k]
        n = torch.where(take, n_lo[k], n)
        lam = torch.where(take, cand[k], lam)
        pd = torch.where(take, p[k], pd)
    m, q = n_hi[0], p[0]
    for k in (1, 2):
        take = n_hi[k] * q < m * p[k]
        m = torch.where(take, n_hi[k], m)
        q = torch.where(take, p[k], q)
    hit = (m * pd >= n * q) & (m > 0.0)
    inside = n <= 0.0
    num = torch.where(hit, torch.where(inside, m, n), torch.full_like(n, _BIG))
    den = torch.where(hit, torch.where(inside, q, pd), one)
    return num, den, lam, hit


# The slab cull (csrc/render.cu, whose header gives the argument): a cast
# is skipped only where its ray lies outside the box's cull rectangle.
CULL_EPS = 2.0**-24   # float32's unit roundoff
CULL_SAFETY = 16.0    # how many times over the rounding bounds are taken
CULL_ZMIN = 1e-3      # metres: nearest corner depth for which a box is culled
CULL_FLOOR = 1e-6     # screen units added to the margin
CULL_BIG = 1e18       # largest S and he_k + |o_k| for which a box is culled


def _round_f32(x: torch.Tensor, up: bool) -> torch.Tensor:
    """float64 → the nearest float32 at or above (``up``) or below ``x``."""
    y = x.to(torch.float32)
    past = y.to(torch.float64) < x if up else y.to(torch.float64) > x
    toward = torch.full_like(y, float("inf") if up else -float("inf"))
    return torch.where(past, torch.nextafter(y, toward), y)


def slab_cull_rect(setup, half_extents, ray_abs: float):
    """The screen rectangle outside which the slab cast of a ray against
    one box is a miss, in the kernels' float32 arithmetic (K3's rcp.approx
    and contracted FMAs; K5b's ratio cascade, rounded as written) as well
    as exactly.

    ``setup``: :func:`_slab_setup`'s tuple for one box and camera (E, 1)
    columns; ``ray_abs``: the largest |px|, |py| of the ray table.  Returns
    ``(xlo, xhi, ylo, yhi)``, float32 (E, 1) each, rounded outward; (-inf,
    inf) for a box that is not wholly in front of the eye.  Computed in
    float64 as render.cu's ``cull_rect`` computes it: the box grown by
    ``CULL_SAFETY`` times the cast's rounding, its eight corners projected
    through the dual basis of (A, B, C), their bounding rectangle widened
    by ``CULL_SAFETY`` times the bound of the direction's rounding plus
    ``CULL_FLOOR``; (-inf, inf) too where S or some he_k + |o_k| exceeds
    ``CULL_BIG``."""
    o, a, b, c = (tuple(x.to(torch.float64) for x in v) for v in setup[:4])
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    norm = lambda u: torch.sqrt(dot(u, u))
    bxc, cxa, axb = soa.v_cross(b, c), soa.v_cross(c, a), soa.v_cross(a, b)
    inv_det = 1.0 / dot(a, bxc)
    ah, bh, ch = (tuple(x * inv_det for x in v) for v in (bxc, cxa, axb))
    s = norm(a) + ray_abs * (norm(b) + norm(c))
    small = s <= CULL_BIG
    for k in range(3):
        small = small & (float(half_extents[k]) + o[k].abs() <= CULL_BIG)
    e = 1.7320508075688772 * (6.0 * CULL_EPS * s + 1.01e-9)
    ea, eb, ec = e * norm(ah), e * norm(bh), e * norm(ch)
    grown = tuple(float(half_extents[k]) + CULL_SAFETY * 4.0 * CULL_EPS
                  * (float(half_extents[k]) + o[k].abs()) for k in range(3))
    zs, xs, ys = [], [], []
    for corner in range(8):  # bit k: + on axis k, as cull_rect's lanes
        v = tuple((grown[k] if corner >> k & 1 else -grown[k]) - o[k] for k in range(3))
        z = dot(v, ah)
        zs.append(z)
        xs.append(dot(v, bh) / z)
        ys.append(dot(v, ch) / z)
    z, x, y = (torch.cat(t, dim=1) for t in (zs, xs, ys))
    ok = ((z >= CULL_ZMIN).all(1, keepdim=True) & (ea <= 0.25) & small
          & torch.isfinite(x).all(1, keepdim=True) & torch.isfinite(y).all(1, keepdim=True))
    xlo, xhi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    ylo, yhi = y.amin(1, keepdim=True), y.amax(1, keepdim=True)
    mx = CULL_SAFETY * (ea * torch.maximum(xlo.abs(), xhi.abs()) + eb) + CULL_FLOOR
    my = CULL_SAFETY * (ea * torch.maximum(ylo.abs(), yhi.abs()) + ec) + CULL_FLOOR
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=z.device)
    return (torch.where(ok, _round_f32(xlo - mx, False), -inf),
            torch.where(ok, _round_f32(xhi + mx, True), inf),
            torch.where(ok, _round_f32(ylo - my, False), -inf),
            torch.where(ok, _round_f32(yhi + my, True), inf))


WARP = 32  # pooled pixels per warp of the slab kernel


def slab_pixel_rects(planes: np.ndarray) -> np.ndarray:
    """The screen rectangle of each pooled pixel's sub-rays: planes (4, C,
    p2, n) → float32 (C, n, 4), the min/max of px and of py over the p2
    sub-rays, as (xlo, xhi, ylo, yhi)."""
    px, py = planes[0], planes[1]
    return np.stack([px.min(1), px.max(1), py.min(1), py.max(1)], -1).astype(np.float32)


def run_rects(planes: np.ndarray, order: np.ndarray) -> np.ndarray:
    """The raster kernels' run table: planes (4, C, p2, n) → float32
    (C, ceil(n / 32), 4), per run of 32 pooled pixels in ``order`` (a
    warp's pixels; the last run of a camera shorter) the rectangle (xlo,
    xhi, ylo, yhi) of its pixels' sub-rays."""
    n = planes.shape[-1]
    rects = slab_pixel_rects(planes)[:, order]  # (C, n, 4)
    runs = -(-n // WARP)
    padded = np.concatenate([rects, np.repeat(rects[:, -1:], runs * WARP - n, 1)], 1)
    padded = padded.reshape(rects.shape[0], runs, WARP, 4)
    return np.ascontiguousarray(np.stack(
        [padded[..., 0].min(2), padded[..., 1].max(2), padded[..., 2].min(2),
         padded[..., 3].max(2)], -1), np.float32)


def slab_order(n: int, width: int) -> np.ndarray:
    """The slab kernel's order of a camera's pooled pixels: column by
    column of the row-major (n / width, width) frame, so that a warp's run
    of 32 is about 1.3 columns.  Position q holds pixel ``order[q]``."""
    return np.arange(n).reshape(n // width, width).T.reshape(-1)


def pose_boxes(scene: SceneParams, poses: torch.Tensor):
    """Poses (E, 16) → the cart's and the pole's (center, quat, half
    extents), the center and quat as float32 (E, 1) columns."""
    col = lambda j: poses[:, j : j + 1].to(torch.float32)
    return (((col(0), col(1), col(2)), (col(3), col(4), col(5), col(6)), scene.cart_half_extents),
            ((col(7), col(8), col(9)), (col(10), col(11), col(12), col(13)),
             scene.pole_half_extents))


def slab_cast_mask(scene: SceneParams, poses: torch.Tensor, planes: torch.Tensor, cam_meta,
                   p2: int, n: int, width: int) -> torch.Tensor:
    """The casts the slab kernel makes, in either of its cast modes (K3/K4
    with the reciprocal, K5b with the ratio cascade: one rectangle serves
    both): poses (E, 16) → bool (E, C, p2·n, 2).

    A warp of the kernel holds a run of 32 pooled pixels of one camera in
    :func:`slab_order` (the last run of a camera shorter).  It casts the
    cart (0) or the pole (1) for every sub-ray of its pixels where the
    rectangle of one pixel's sub-rays (:func:`slab_pixel_rects`) meets the
    box's cull rectangle, and for none of them elsewhere; the mask holds
    that decision per sub-ray, in the ray table's order.  ``width``: the
    pooled frame's width."""
    boxes = pose_boxes(scene, poses)
    ray_abs = float(planes[:2].abs().max())
    rects = torch.from_numpy(slab_pixel_rects(planes.cpu().numpy())).to(poses.device)
    order = torch.from_numpy(slab_order(n, width)).to(poses.device)
    run = torch.empty_like(order)
    run[order] = torch.arange(n, device=poses.device) // WARP  # pixel → its warp's run
    masks = []
    for c, (basis, eye) in enumerate(cam_meta):
        r = rects[c]  # (n, 4)
        per_box = []
        for center, quat, he in boxes:
            xlo, xhi, ylo, yhi = slab_cull_rect(
                _slab_setup(basis, eye, center, quat, LIGHT_DIR), he, ray_abs)
            meets = ~((r[:, 1] < xlo) | (r[:, 0] > xhi) | (r[:, 3] < ylo) | (r[:, 2] > yhi))
            in_order = torch.nn.functional.pad(meets[:, order], (0, -n % WARP))
            runs = in_order.reshape(meets.shape[0], -1, WARP).any(-1)
            per_box.append(runs[:, run].repeat(1, p2))  # (E, p2·n): the p2 blocks of n
        masks.append(torch.stack(per_box, dim=-1))
    return torch.stack(masks, dim=1)


def slab_cull_violations(scene: SceneParams, poses: torch.Tensor, planes: torch.Tensor,
                         cam_meta, p2: int, n: int, width: int, recip: bool = True) -> int:
    """How many (sub-ray, box) casts that :func:`slab_cast_mask` skips on
    poses (E, 16) the slab cast hits, in float32 (:func:`_slab_cast`'s
    arithmetic: with the exact reciprocal, or with ``recip=False`` the
    ratio cascade, K5b's) or in float64 from the same setup: 0 where the
    cull is conservative on these poses."""
    mask = slab_cast_mask(scene, poses, planes, cam_meta, p2, n, width)
    count = 0
    for c, (basis, eye) in enumerate(cam_meta):
        rows = planes[:, c].reshape(4, 1, p2 * n)
        for b, (center, quat, he) in enumerate(pose_boxes(scene, poses)):
            setup = _slab_setup(basis, eye, center, quat, LIGHT_DIR)
            setup64 = tuple(tuple(x.double() for x in v) for v in setup)
            hit = (_slab_cast(rows[0], rows[1], setup, he, recip)[3]
                   | _slab_cast(rows[0].double(), rows[1].double(), setup64, he, recip)[3])
            count += int((hit & ~mask[:, c, :, b]).sum())
    return count


# The raster cull (csrc/render.cu, whose header gives the argument): per
# warp's run of pooled pixels, interval bounds with directed rounding of
# every value the raster cast computes for a sub-ray in the run's
# rectangle; a box is skipped where the bounds show that its cast misses.  The kernel rounds
# down and up in float32 (__fmul_rd, __fadd_ru, ...); here that is done
# from float64, where the product of two float32 values is exact.
MXU_WIDEN = 2.0**-14  # K5d: CULL_SAFETY x 2^-18, relative to |s|·S (render.cu's header)


def _mul_dir(a: torch.Tensor, b: torch.Tensor, up: bool) -> torch.Tensor:
    """float32 a·b rounded down or up (the float64 product is exact)."""
    return _round_f32(a.double() * b.double(), up)


def _add_dir(a: torch.Tensor, b: torch.Tensor, up: bool) -> torch.Tensor:
    """float32 a + b rounded down or up.  The float64 sum s is exact where
    the exponents lie within 29 bits of each other.  Elsewhere TwoSum gives
    its residual, and the result moves one more float32 ulp outward where
    s is itself a float32 value and the exact sum lies beyond it; where s
    is not, the exact sum and s round alike (they lie within half a
    float64 ulp of each other, and s at least one from any float32)."""
    a, b = a.double(), b.double()
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    r = _round_f32(s, up)
    beyond = (err > 0 if up else err < 0) & (r.double() == s)
    toward = torch.full_like(r, float("inf") if up else -float("inf"))
    return torch.where(beyond, torch.nextafter(r, toward), r)


def mxu_widening(setup, ray_abs: float):
    """K5d's widening of each bound plane of one box, rounded up as the
    kernel computes it: ``MXU_WIDEN · |s| · (|A| + ray_abs·(|B| + |C|))``
    with s = inv_u (far planes) and s = inv_l (near planes) → two
    3-tuples of float32 (E, 1) columns."""
    A, B, C, inv_u, inv_l = setup[:5]
    ra = torch.tensor(ray_abs, dtype=torch.float32, device=A[0].device)
    widen = torch.tensor(MXU_WIDEN, dtype=torch.float32, device=A[0].device)
    far, near = [], []
    for k in range(3):
        s = _add_dir(A[k].abs(), _mul_dir(ra, _add_dir(B[k].abs(), C[k].abs(), True), True), True)
        far.append(_mul_dir(widen, _mul_dir(inv_u[k].abs(), s, True), True))
        near.append(_mul_dir(widen, _mul_dir(inv_l[k].abs(), s, True), True))
    return tuple(far), tuple(near)


def raster_may_hit(setup, rects, widen=None) -> torch.Tensor:
    """Whether the raster cast of one box can hit a sub-ray in each screen
    rectangle: False only where interval bounds of the cast's values prove
    a miss (render.cu's ``raster_may_hit``).

    ``setup``: :func:`_obb_q_setup`'s tuple of float32 (E, 1) columns;
    ``rects``: (xlo, xhi, ylo, yhi), float32 (m,) each (a warp's run of
    pixels, :func:`run_rects`, or any rectangle of sub-rays); ``widen``:
    K5d's widening (:func:`mxu_widening`), or None for K5a.  Returns bool
    (E, m): False where the least upper bound of q lies below max(the
    greatest lower bound, 1e-30) (:func:`raster_q_bounds`), the cast's hit
    test.  A setup that is not finite, or a bound that is NaN, is never
    skipped."""
    A, B, C, inv_u, inv_l = setup[:5]
    q_lo, q_hi = raster_q_bounds(setup, rects, widen)
    finite = torch.stack([torch.isfinite(x) for x in (*A, *B, *C, *inv_u, *inv_l)]).all(0)
    return ~finite | ~(q_hi < q_lo)


def raster_q_bounds(setup, rects, widen=None):
    """Bounds of the raster cast's inverse-depth cascade over each
    rectangle, as the kernels compute them → float32 (q_lo, q_hi), (E, m)
    each (NaN where a bound is): q_lo at most max(1e-30, the cast's q_lo) and q_hi at least its
    q_hi, for every sub-ray in the rectangle (arguments as
    :func:`raster_may_hit`'s).  Per axis k, with the rectangle's corner
    picked by the signs of B and C, ``w = (A + B·px) + C·py`` is bounded
    below and above in the cast's order of rounding; the far plane ``a =
    w·inv_u`` from below, the near plane ``b = w·inv_l`` from above where
    it is an upper bound (ahead) and from below where it is a lower one."""
    A, B, C, inv_u, inv_l, ahead, _, _ = setup
    xlo, xhi, ylo, yhi = rects
    big = torch.tensor(_BIG, dtype=torch.float32, device=xlo.device)
    q_lo = torch.tensor(1e-30, dtype=torch.float32, device=xlo.device)
    for k in range(3):
        bp, cp = B[k] >= 0.0, C[k] >= 0.0
        w_lo = _add_dir(_add_dir(A[k], _mul_dir(B[k], torch.where(bp, xlo, xhi), False), False),
                        _mul_dir(C[k], torch.where(cp, ylo, yhi), False), False)
        w_hi = _add_dir(_add_dir(A[k], _mul_dir(B[k], torch.where(bp, xhi, xlo), True), True),
                        _mul_dir(C[k], torch.where(cp, yhi, ylo), True), True)
        far = _mul_dir(w_lo, inv_u[k], False)
        near = _mul_dir(w_hi, inv_l[k].abs(), True)
        if widen is not None:
            far = _add_dir(far, -widen[0][k], False)
            near = _add_dir(near, widen[1][k], True)
        ub = torch.where(ahead[k], near, big)
        q_hi = ub if k == 0 else torch.minimum(q_hi, ub)
        q_lo = torch.maximum(q_lo, torch.maximum(far, torch.where(ahead[k], -big, -near)))
    return q_lo, q_hi


def raster_cast_mask(scene: SceneParams, poses: torch.Tensor, planes: torch.Tensor, cam_meta,
                     p2: int, n: int, order: np.ndarray, mxu: bool = False) -> torch.Tensor:
    """The casts the raster kernels make (K5a; K5d with ``mxu``): poses
    (E, 16) → bool (E, C, p2·n, 2), the layout of :func:`slab_cast_mask`.
    A warp holds a run of 32 pooled pixels in ``order`` (:func:`slab_order`)
    and casts a box for every sub-ray of its pixels where
    :func:`raster_may_hit` holds for the rectangle of its run
    (:func:`run_rects`), else for none of them."""
    ray_abs = float(planes[:2].abs().max())
    rects = torch.from_numpy(run_rects(planes.cpu().numpy(), order)).to(poses.device)
    run = torch.empty(n, dtype=torch.long, device=poses.device)
    run[torch.from_numpy(order).to(poses.device)] = torch.arange(n, device=poses.device) // WARP
    masks = []
    for c, (basis, eye) in enumerate(cam_meta):
        r = rects[c]
        per_box = []
        for center, quat, he in pose_boxes(scene, poses):
            setup = _obb_q_setup(basis, eye, center, quat, he, LIGHT_DIR)
            widen = mxu_widening(setup, ray_abs) if mxu else None
            may = raster_may_hit(setup, (r[:, 0], r[:, 1], r[:, 2], r[:, 3]), widen)
            per_box.append(may[:, run].repeat(1, p2))  # (E, p2·n): the p2 blocks of n
        masks.append(torch.stack(per_box, dim=-1))
    return torch.stack(masks, dim=1)


def raster_cull_violations(scene: SceneParams, poses: torch.Tensor, planes: torch.Tensor,
                           cam_meta, p2: int, n: int, order: np.ndarray,
                           mxu: bool = False) -> int:
    """How many (sub-ray, box) casts that :func:`raster_cast_mask` skips on
    poses (E, 16) the raster cast hits, in float32 or in float64 from the
    same setup (:func:`_obb_q_cast`), or, with ``mxu``, from the bound
    planes as one float32 product (:func:`bound_planes`): 0 where the cull
    is conservative on these poses."""
    mask = raster_cast_mask(scene, poses, planes, cam_meta, p2, n, order, mxu)
    count = 0
    for c, (basis, eye) in enumerate(cam_meta):
        rows = planes[:, c].reshape(4, 1, p2 * n)
        setups = [_obb_q_setup(basis, eye, center, quat, he, LIGHT_DIR)
                  for center, quat, he in pose_boxes(scene, poses)]
        products = bound_planes(planes[:, c].reshape(4, p2 * n), *setups) if mxu else (None, None)
        for b, setup in enumerate(setups):
            setup64 = tuple(tuple(x.double() if x.is_floating_point() else x for x in v)
                            if isinstance(v, tuple) else v for v in setup)
            hit = (_obb_q_cast(rows[0], rows[1], setup)[2]
                   | _obb_q_cast(rows[0].double(), rows[1].double(), setup64)[2])
            if mxu:
                hit = hit | _obb_q_cast(rows[0], rows[1], setup, products[b])[2]
            count += int((hit & ~mask[:, c, :, b]).sum())
    return count


def cull_probe_poses(e: int, seed: int) -> torch.Tensor:
    """Poses chosen to break the slab cull, (e, 16) float32 from ``seed``,
    in five families of about e/5: a pole lying at eye height beside a
    camera, the eye inside its slabs; a pole lying flat on the ground; a
    cart (tilted, any yaw) near or past the frame's border; a pole whose
    tip lies near the camera plane of one camera, in front or behind; and
    both boxes anywhere with any orientation."""
    rng = np.random.default_rng(seed)
    fam = np.arange(e) % 5
    pos = np.zeros((e, 2, 3))
    quat = np.zeros((e, 2, 4))
    pos[:, 0] = (0.0, 0.0, 0.1)
    quat[:, :, 0] = 1.0

    def axis_angle(axis, angle):
        axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
        return np.concatenate([np.cos(angle / 2)[:, None], axis * np.sin(angle / 2)[:, None]], -1)

    def random_quat(k):
        q = rng.normal(size=(k, 4))
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    cams = [(np.asarray(c.eye), np.asarray(c.target) - np.asarray(c.eye)) for c in DEFAULT_CAMERAS]
    for f in range(5):
        idx = np.nonzero(fam == f)[0]
        k = len(idx)
        cam = rng.integers(0, 2, k)
        eye = np.stack([cams[c][0] for c in cam])
        if f == 0:  # pole along the camera's view axis line at eye height, offset sideways
            side = rng.choice((-1.0, 1.0), k) * rng.uniform(0.06, 1.0, k)
            along = rng.uniform(-0.4, 0.6, k)
            lift = rng.uniform(-0.04, 0.04, k)
            axis = np.where(cam[:, None] == 0, [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]])
            off = np.where(cam[:, None] == 0, np.stack([side, along, lift], -1),
                           np.stack([along, side, lift], -1))
            pos[idx, 1] = eye + off
            quat[idx, 1] = axis_angle(axis, np.full(k, np.pi / 2) + rng.normal(0, 0.05, k))
        elif f == 1:  # pole flat on the ground, any yaw
            pos[idx, 1] = np.stack([rng.uniform(-2, 2, k), rng.uniform(-2, 2, k),
                                    np.full(k, 0.05)], -1)
            yaw = axis_angle(np.tile([0.0, 0.0, 1.0], (k, 1)), rng.uniform(0, 2 * np.pi, k))
            tip = axis_angle(np.tile([1.0, 0.0, 0.0], (k, 1)), np.full(k, np.pi / 2))
            quat[idx, 1] = _q_mul(yaw, tip)
            pos[idx, 0] = np.stack([rng.uniform(-1.5, 1.5, k), rng.uniform(-1.5, 1.5, k),
                                    np.full(k, 0.1)], -1)
        elif f == 2:  # cart near or past the frame's border
            pos[idx, 0] = np.stack([rng.uniform(-2.5, 2.5, k), rng.uniform(-1.8, 2.5, k),
                                    rng.uniform(0.0, 0.6, k)], -1)
            quat[idx, 0] = _q_mul(axis_angle(np.tile([0.0, 0.0, 1.0], (k, 1)),
                                             rng.uniform(0, 2 * np.pi, k)),
                                  axis_angle(rng.normal(size=(k, 3)), rng.uniform(0, 0.6, k)))
            pos[idx, 1] = pos[idx, 0] + (0.0, 0.0, 0.7)
        elif f == 3:  # pole tip near the camera plane
            fwd = np.stack([cams[c][1] / np.linalg.norm(cams[c][1]) for c in cam])
            depth = np.where(rng.random(k) < 0.25, 0.0, rng.uniform(-0.3, 0.3, k))
            lateral = rng.normal(size=(k, 3)) * rng.uniform(0.0, 0.3, k)[:, None]
            lateral -= (lateral * fwd).sum(-1, keepdims=True) * fwd
            tip = eye + depth[:, None] * fwd + lateral
            q = random_quat(k)
            w, x, y, z = q.T
            long_axis = np.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                                  1 - 2 * (x * x + y * y)], -1)
            pos[idx, 1] = tip - 0.5 * long_axis
            quat[idx, 1] = q
        else:  # anywhere
            pos[idx] = np.stack([rng.uniform(-3, 3, (k, 2)), rng.uniform(-3, 3, (k, 2)),
                                 rng.uniform(-0.5, 2.0, (k, 2))], -1)
            quat[idx, 0], quat[idx, 1] = random_quat(k), random_quat(k)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    out = np.zeros((e, 16), np.float32)
    out[:, 0:3], out[:, 3:7] = pos[:, 0], quat[:, 0]
    out[:, 7:10], out[:, 10:14] = pos[:, 1], quat[:, 1]
    return torch.from_numpy(out)


def _q_mul(a, b):
    """Hamilton product of (k, 4) numpy quaternions (w, x, y, z)."""
    aw, ax, ay, az = a.T
    bw, bx, by, bz = b.T
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def _slab_cast_where(px, py, setup, half_extents, mask, recip: bool = True):
    """:func:`_slab_cast` of the (env, ray) pairs of ``mask`` (E, P) only,
    the others a miss (num = _BIG, den = 1, hit false, lambert 0): the same
    values where it casts, so the same frames, and the operations of only
    those casts."""
    ie, ip = mask.nonzero(as_tuple=True)
    sub = tuple(tuple(col[ie, 0] for col in v) for v in setup)
    num, den, lam, hit = _slab_cast(px[0, ip], py[0, ip], sub, half_extents, recip)
    num_all = torch.full(mask.shape, _BIG, dtype=torch.float32, device=mask.device)
    den_all = torch.ones(mask.shape, dtype=torch.float32, device=mask.device)
    lam_all = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    hit_all = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    num_all[ie, ip], den_all[ie, ip], lam_all[ie, ip], hit_all[ie, ip] = num, den, lam, hit
    return num_all, den_all, lam_all, hit_all


def _obb_q_setup(basis, eye, center, quat, half_extents, light):
    """Per-env scalar algebra of the projective rasterizer.

    ``center``/``quat``: (E, 1) columns.  Returns ``(A, B, C, inv_u, inv_l,
    ahead, cand, inside)``, each a 3-tuple of (E, 1) columns except
    ``inside`` (E, 1): box axis k oriented so ``g_k = û_k·(c − eye) ≥ 0``,
    its affine ray coefficients, the inverse far (``U = g + he``) and near
    (``L = g − he``, sign-preserving clamp at 1e-7) plane distances, whether
    the near plane lies ahead of the eye, the Lambert candidate −û_k·L and
    whether the eye is inside the box.
    """
    fwd, right, up = basis
    r = soa.q_to_mat(quat)
    rel = tuple(center[i] - eye[i] for i in range(3))
    g = tuple(r[0][k] * rel[0] + r[1][k] * rel[1] + r[2][k] * rel[2] for k in range(3))
    sign = lambda x: 2.0 * (x >= 0.0).to(x.dtype) - 1.0
    sg = tuple(sign(g[k]) for k in range(3))
    ga = tuple(sg[k] * g[k] for k in range(3))
    lo = tuple(ga[k] - float(half_extents[k]) for k in range(3))
    hi = tuple(ga[k] + float(half_extents[k]) for k in range(3))
    sl = tuple(sign(lo[k]) for k in range(3))
    lo = tuple(sl[k] * torch.clamp(sl[k] * lo[k], min=1e-7) for k in range(3))
    inv_u = tuple(1.0 / hi[k] for k in range(3))
    inv_l = tuple(1.0 / lo[k] for k in range(3))
    ahead = tuple(lo[k] > 0.0 for k in range(3))

    def dot_axis(k, v):
        return r[0][k] * v[0] + r[1][k] * v[1] + r[2][k] * v[2]

    A = tuple(sg[k] * dot_axis(k, fwd) for k in range(3))
    B = tuple(sg[k] * dot_axis(k, right) for k in range(3))
    C = tuple(sg[k] * dot_axis(k, up) for k in range(3))
    cand = tuple(
        -sg[k] * (light[0] * r[0][k] + light[1] * r[1][k] + light[2] * r[2][k])
        for k in range(3)
    )
    inside = ~(ahead[0] | ahead[1] | ahead[2])
    return A, B, C, inv_u, inv_l, ahead, cand, inside


def _obb_q_cast(px, py, setup, bounds=None):
    """Per-ray work of the projective rasterizer → ``(q, lambert, hit)``,
    (E, P) each: the entry inverse depth (larger is nearer; the exit one
    when the eye is inside the box, ``-_BIG`` on a miss), the entry face's
    n·L and the hit mask.

    ``bounds``: optionally the routed bound planes ``(a, ub, lb)`` (3-tuples
    of (E, P)) evaluated elsewhere, as :func:`bound_planes` does with one
    product; else they are evaluated here."""
    A, B, C, inv_u, inv_l, ahead, cand, inside = setup
    big = torch.tensor(_BIG, dtype=px.dtype, device=px.device)
    if bounds is None:
        w = tuple(A[k] + B[k] * px + C[k] * py for k in range(3))
        a = tuple(w[k] * inv_u[k] for k in range(3))  # far plane: lower bound
        b = tuple(w[k] * inv_l[k] for k in range(3))  # near plane, routed
        ub = tuple(torch.where(ahead[k], b[k], big) for k in range(3))
        lb = tuple(torch.where(ahead[k], -big, b[k]) for k in range(3))
    else:
        a, ub, lb = bounds
    q_lo = torch.maximum(
        torch.maximum(torch.maximum(a[0], a[1]), torch.maximum(a[2], lb[0])),
        torch.maximum(lb[1], lb[2]),
    )
    q_hi, lam = ub[0], cand[0]
    for k in (1, 2):
        take = ub[k] < q_hi
        q_hi = torch.minimum(q_hi, ub[k])
        lam = torch.where(take, cand[k], lam)
    hit = q_hi >= torch.clamp(q_lo, min=1e-30)
    q = torch.where(inside, q_lo, q_hi)
    q = torch.where(hit, q, -big)
    return q, lam, hit


def _obb_q_cast_where(px, py, setup, mask):
    """:func:`_obb_q_cast` of the (env, ray) pairs of ``mask`` (E, P) only,
    the others a miss (q = -_BIG, hit false, lambert 0): the same values
    where it casts, so the same frames, and the operations of only those
    casts."""
    ie, ip = mask.nonzero(as_tuple=True)
    sub = tuple(tuple(col[ie, 0] for col in v) if isinstance(v, tuple) else v[ie, 0]
                for v in setup)
    q, lam, hit = _obb_q_cast(px[0, ip], py[0, ip], sub)
    q_all = torch.full(mask.shape, -_BIG, dtype=torch.float32, device=mask.device)
    lam_all = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    hit_all = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    q_all[ie, ip], lam_all[ie, ip], hit_all[ie, ip] = q, lam, hit
    return q_all, lam_all, hit_all


SETUP_W = 22  # per box: A(3) B(3) C(3) inv_u(3) inv_l(3) ahead(3) cand(3) inside


def pack_setups(scene: SceneParams, cam_meta, poses: torch.Tensor) -> torch.Tensor:
    """The raster setup of every box seen from every camera, hoisted out of
    the cast: poses (..., 16) → float32 (..., C·2·SETUP_W).

    Per camera the cart box then the pole box, each the
    :func:`_obb_q_setup` tuple flattened in order, the bool fields as
    0.0/1.0 (the JAX package's ``pallas_kernel._pack_setups``)."""
    col = lambda j: poses[..., j].to(torch.float32)
    boxes = (
        ((col(0), col(1), col(2)), (col(3), col(4), col(5), col(6)), scene.cart_half_extents),
        ((col(7), col(8), col(9)), (col(10), col(11), col(12), col(13)), scene.pole_half_extents),
    )
    cols = []
    for basis, eye in cam_meta:
        for center, quat, he in boxes:
            a3, b3, c3, iu, il, ahead, cand, inside = _obb_q_setup(
                basis, eye, center, quat, he, LIGHT_DIR)
            cols += [*a3, *b3, *c3, *iu, *il, *(a.to(torch.float32) for a in ahead),
                     *cand, inside.to(torch.float32)]
    return torch.stack(cols, dim=-1)


def unpack_setup(packed: torch.Tensor):
    """One box's packed setup (E, SETUP_W) → the :func:`_obb_q_setup`
    tuple of (E, 1) columns."""
    g = lambda j: packed[:, j : j + 1]
    return ((g(0), g(1), g(2)), (g(3), g(4), g(5)), (g(6), g(7), g(8)),
            (g(9), g(10), g(11)), (g(12), g(13), g(14)),
            tuple(g(15 + k) > 0.5 for k in range(3)), (g(18), g(19), g(20)), g(21) > 0.5)


def bound_rows(setup) -> list[torch.Tensor]:
    """The nine routed bound planes of one box as rows of the product's
    left-hand side: [a_0..2, ub_0..2, lb_0..2], each (E, 8) over the ray
    rows (px, py, gval, smask, 1, 0, 0, 0).  The ``ahead`` routing folds
    into the coefficients: a scale on the px/py/ones columns and a ±``_BIG``
    bias on the ones column (``pallas_kernel._render_kernel``'s
    ``bound_rows``)."""
    A3, B3, C3, iu, il, ahead, _, _ = setup
    z = torch.zeros_like(A3[0])
    row = lambda b, c, a: torch.cat([b, c, z, z, a, z, z, z], dim=1)
    fa = tuple(ahead[k].to(A3[0].dtype) for k in range(3))
    rows = [row(B3[k] * iu[k], C3[k] * iu[k], A3[k] * iu[k]) for k in range(3)]
    for k in range(3):  # ub: ahead ? w·il : BIG
        c1 = fa[k] * il[k]
        rows.append(row(B3[k] * c1, C3[k] * c1, A3[k] * c1 + (1.0 - fa[k]) * _BIG))
    for k in range(3):  # lb: ahead ? -BIG : w·il
        c2 = (1.0 - fa[k]) * il[k]
        rows.append(row(B3[k] * c2, C3[k] * c2, A3[k] * c2 - fa[k] * _BIG))
    return rows


def bound_planes(rays: torch.Tensor, su_c, su_p):
    """All 18 routed bound planes of both boxes as one float32 product:
    (18·E, 8) left-hand side from :func:`bound_rows` times the (8, P) ray
    rows → the ``bounds`` of :func:`_obb_q_cast` for the cart and the pole.

    ``rays``: (4, P) rows px, py, gval, smask; the ones row and three zero
    rows are appended here.  On the card the product must stay in float32:
    this sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (TF32 keeps
    ~10 mantissa bits, far too coarse for silhouettes)."""
    if rays.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    e = su_c[0][0].shape[0]
    rhs = torch.cat([rays, torch.ones_like(rays[:1]), torch.zeros_like(rays[:3])], dim=0)
    lhs = torch.cat(bound_rows(su_c) + bound_rows(su_p), dim=0)
    w = torch.matmul(lhs, rhs)
    p = [w[i * e : (i + 1) * e] for i in range(18)]
    return ((tuple(p[0:3]), tuple(p[3:6]), tuple(p[6:9])),
            (tuple(p[9:12]), tuple(p[12:15]), tuple(p[15:18])))


def render_frames(
    scene: SceneParams, poses: torch.Tensor, planes: torch.Tensor, cam_meta, p2: int, n: int,
    quantize: bool = True, raster: bool = False, recip: bool = True, hoist: bool = False,
    mxu: bool = False, cast_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Render one frame per env from poses (E, 16) → (E, C·3·n).

    ``planes``: (4, C, p2, n) from :func:`ray_planes`, on the poses' device.
    ``quantize``: uint8 ``floor(clip(c·255 + 0.5, 0, 255))``; else float32
    colours in [0, 1].  All geometry and shading run in float32.  The cast
    mode, as the JAX package's ``make_venv`` flags select it:

    - ``raster``: the projective raster, ordered by inverse depth (ties →
      cart); with ``hoist`` its setup comes from the packed table of
      :func:`pack_setups`, with ``mxu`` its bound planes from one product
      (:func:`bound_planes`).  ``recip`` is ignored.
    - else the slab cascade: with ``recip`` an exact reciprocal, else the
      division-free ratio cascade ordered by ``nc·dp ≤ np·dc``.  ``hoist``
      and ``mxu`` are ignored.

    ``cast_mask`` (E, C, p2·n, 2), from :func:`slab_cast_mask` (slab) or
    :func:`raster_cast_mask` (raster), casts only the (ray, box) pairs it
    holds and takes a miss elsewhere, as the kernels cull.
    """
    col = lambda j: poses[:, j : j + 1].to(torch.float32)
    cart_c, cart_q = (col(0), col(1), col(2)), (col(3), col(4), col(5), col(6))
    pole_c, pole_q = (col(7), col(8), col(9)), (col(10), col(11), col(12), col(13))
    setups = pack_setups(scene, cam_meta, poses) if raster and hoist else None
    out = []
    for c, (basis, eye) in enumerate(cam_meta):
        rows = planes[:, c].reshape(4, 1, p2 * n)
        px, py, gval, smask = rows[0], rows[1], rows[2], rows[3]
        if raster:
            if setups is not None:
                base = c * 2 * SETUP_W
                su_c = unpack_setup(setups[:, base : base + SETUP_W])
                su_p = unpack_setup(setups[:, base + SETUP_W : base + 2 * SETUP_W])
            else:
                su_c = _obb_q_setup(basis, eye, cart_c, cart_q, scene.cart_half_extents, LIGHT_DIR)
                su_p = _obb_q_setup(basis, eye, pole_c, pole_q, scene.pole_half_extents, LIGHT_DIR)
            if cast_mask is not None and not mxu:
                qc, lam_c, hit_c = _obb_q_cast_where(px, py, su_c, cast_mask[:, c, :, 0])
                qp, lam_p, hit_p = _obb_q_cast_where(px, py, su_p, cast_mask[:, c, :, 1])
            else:
                b_c = b_p = None
                if mxu:
                    b_c, b_p = bound_planes(planes[:, c].reshape(4, p2 * n), su_c, su_p)
                qc, lam_c, hit_c = _obb_q_cast(px, py, su_c, b_c)
                qp, lam_p, hit_p = _obb_q_cast(px, py, su_p, b_p)
                if cast_mask is not None:  # the product's casts, the skipped ones taken as misses
                    big = torch.tensor(-_BIG, dtype=torch.float32, device=qc.device)
                    mc, mp = cast_mask[:, c, :, 0], cast_mask[:, c, :, 1]
                    qc, hit_c = torch.where(mc, qc, big), hit_c & mc
                    qp, hit_p = torch.where(mp, qp, big), hit_p & mp
            sel_c = hit_c & (qc >= qp)
        elif cast_mask is not None:
            nc, dc, lam_c, hit_c = _slab_cast_where(
                px, py, _slab_setup(basis, eye, cart_c, cart_q, LIGHT_DIR),
                scene.cart_half_extents, cast_mask[:, c, :, 0], recip)
            np_, dp, lam_p, hit_p = _slab_cast_where(
                px, py, _slab_setup(basis, eye, pole_c, pole_q, LIGHT_DIR),
                scene.pole_half_extents, cast_mask[:, c, :, 1], recip)
            sel_c = hit_c & ((nc <= np_) if recip else (nc * dp <= np_ * dc))
        else:
            nc, dc, lam_c, hit_c = _ray_obb_affine(
                px, py, basis, eye, cart_c, cart_q, scene.cart_half_extents, LIGHT_DIR, recip)
            np_, dp, lam_p, hit_p = _ray_obb_affine(
                px, py, basis, eye, pole_c, pole_q, scene.pole_half_extents, LIGHT_DIR, recip)
            sel_c = hit_c & ((nc <= np_) if recip else (nc * dp <= np_ * dc))
        out.extend(shade_pool(sel_c, hit_p, lam_c, lam_p, gval, smask, p2, n, quantize))
    return torch.cat(out, dim=-1)


def shade_pool(sel_c, hit_p, lam_c, lam_p, gval, smask, p2: int, n: int, quantize: bool = True):
    """Shade each sub-ray (the cart where ``sel_c``, else the pole where
    ``hit_p``, else the background) and pool: (…, p2·n) sub-ray rows, the
    p2 blocks of n pooled pixels → the three colour planes, (…, n) each."""
    zero = torch.zeros((), dtype=torch.float32, device=sel_c.device)
    sel_p = hit_p & ~sel_c
    lambert = torch.clamp(torch.where(sel_c, lam_c, lam_p), min=0.0)
    shade = _AMBIENT + (1.0 - _AMBIENT) * lambert
    bgm = ~(sel_c | sel_p)
    fields = (
        torch.where(sel_c, shade, zero),
        torch.where(sel_p, shade, zero),
        torch.where(bgm, gval, zero),
        torch.where(bgm, smask, zero),
    )
    # Pool: sum the p2 sub-ray blocks of each pooled pixel.
    inv_p2 = 1.0 / p2
    a, b, g, s = (sum(f[..., i * n : (i + 1) * n] for i in range(p2)) * inv_p2 for f in fields)
    out = []
    for k in range(3):
        color = CART_COLOR[k] * a + POLE_COLOR[k] * b + g + SKY_COLOR[k] * s
        if quantize:
            color = torch.floor(torch.clamp(color * 255.0 + 0.5, 0.0, 255.0)).to(torch.uint8)
        out.append(color)
    return out


def make_observe_pixels(config, dtype=torch.uint8, raster: bool = False):
    """Batched observe fn: (scene, rigid[E]) → flat frames (E, C·3·n), on
    the rigid state's device.

    ``dtype=torch.uint8`` quantizes as the kernels do; ``torch.float32``
    returns [0, 1] colours (the golden-image convention).  ``raster``
    selects the cast mode (see :func:`render_frames`).
    """
    planes, cam_meta, (p2, n) = ray_planes(config)
    planes_t = torch.from_numpy(planes)
    quantize = dtype == torch.uint8

    def observe(scene: SceneParams, rigid: RigidState) -> torch.Tensor:
        poses = poses_from_rigid(rigid)
        return render_frames(scene, poses, planes_t.to(poses.device), cam_meta, p2, n,
                             quantize, raster)

    return observe
