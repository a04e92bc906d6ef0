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


def poses_from_rigid(rigid: RigidState) -> torch.Tensor:
    """RigidState (E, …) → (E, 16) [cart pos quat | pole pos quat | 0 0]."""
    e = rigid.pos.shape[0]
    return torch.cat(
        [rigid.pos[:, 0], rigid.quat[:, 0], rigid.pos[:, 1], rigid.quat[:, 1],
         torch.zeros((e, 2), dtype=rigid.pos.dtype, device=rigid.pos.device)],
        dim=-1,
    )


def _ray_obb_affine(px, py, basis, eye, center, quat, half_extents, light, recip: bool = True):
    """Screen-affine ray vs oriented box, slab cascade.

    ``px``/``py``: (1, P) screen rows; ``center``/``quat``: (E, 1) columns.
    Returns ``(num, den, lambert, hit)``, (E, P) each; the depth is
    ``num / den``: entry depth (exit depth when the eye is inside the box,
    ``_BIG`` on a miss), the entry face's n·L and the hit mask.

    ``recip``: slab times through an exact reciprocal, ``num`` the depth
    itself and ``den`` 1.  Else the division-free ratio cascade: the slab
    bounds stay ratios ``n / p`` with ``p > 0`` and are compared by
    cross-multiplying; ``den`` is 1 on a miss.
    """
    fwd, right, up = basis
    r = soa.q_to_mat(quat)
    rel = tuple(eye[i] - center[i] for i in range(3))
    o_l = tuple(r[0][k] * rel[0] + r[1][k] * rel[1] + r[2][k] * rel[2] for k in range(3))
    A = tuple(r[0][k] * fwd[0] + r[1][k] * fwd[1] + r[2][k] * fwd[2] for k in range(3))
    B = tuple(r[0][k] * right[0] + r[1][k] * right[1] + r[2][k] * right[2] for k in range(3))
    C = tuple(r[0][k] * up[0] + r[1][k] * up[1] + r[2][k] * up[2] for k in range(3))
    ldot = tuple(light[0] * r[0][k] + light[1] * r[1][k] + light[2] * r[2][k] for k in range(3))
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
    mxu: bool = False,
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
    """
    col = lambda j: poses[:, j : j + 1].to(torch.float32)
    cart_c, cart_q = (col(0), col(1), col(2)), (col(3), col(4), col(5), col(6))
    pole_c, pole_q = (col(7), col(8), col(9)), (col(10), col(11), col(12), col(13))
    setups = pack_setups(scene, cam_meta, poses) if raster and hoist else None
    inv_p2 = 1.0 / p2
    zero = torch.zeros((), dtype=torch.float32, device=poses.device)
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
            b_c = b_p = None
            if mxu:
                b_c, b_p = bound_planes(planes[:, c].reshape(4, p2 * n), su_c, su_p)
            qc, lam_c, hit_c = _obb_q_cast(px, py, su_c, b_c)
            qp, lam_p, hit_p = _obb_q_cast(px, py, su_p, b_p)
            sel_c = hit_c & (qc >= qp)
        else:
            nc, dc, lam_c, hit_c = _ray_obb_affine(
                px, py, basis, eye, cart_c, cart_q, scene.cart_half_extents, LIGHT_DIR, recip)
            np_, dp, lam_p, hit_p = _ray_obb_affine(
                px, py, basis, eye, pole_c, pole_q, scene.pole_half_extents, LIGHT_DIR, recip)
            sel_c = hit_c & ((nc <= np_) if recip else (nc * dp <= np_ * dc))
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
        a, b, g, s = (sum(f[:, i * n : (i + 1) * n] for i in range(p2)) * inv_p2 for f in fields)
        for k in range(3):
            color = CART_COLOR[k] * a + POLE_COLOR[k] * b + g + SKY_COLOR[k] * s
            if quantize:
                color = torch.floor(torch.clamp(color * 255.0 + 0.5, 0.0, 255.0)).to(torch.uint8)
            out.append(color)
    return torch.cat(out, dim=-1)


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
