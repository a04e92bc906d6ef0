"""The slab render kernel's cull (K3/K4 and K5b, csrc/render.cu) on the CPU.

The kernel skips the cast of a box for a sub-ray that lies outside the
box's cull rectangle, and takes the cast's miss values there, in both its
cast modes: the reciprocal slab (K3/K4) and the division-free ratio slab
(K5b, ``recip=False``).  ``raycast.slab_cull_rect`` is the plain version of
that rectangle, the same formula as the kernel's ``cull_rect``.  These
tests hold it against the slab cast of each mode on poses chosen to break
it (``raycast.cull_probe_poses``: the eye inside a slab, a pole lying flat,
a cart at the frame's border, a pole tip at the camera plane, anything
anywhere) plus reset poses, at ``obs_pool`` 1 and 2 and 1 and 2 cameras:

- no sub-ray that the slab cast hits, in float32 (with the exact
  reciprocal, ``_ray_obb_affine``'s arithmetic, or the ratio cascade) or in
  float64 from the same setup, is culled (zero violations; K3's rcp.approx
  and contracted FMAs, and the ratio cascade's rounded compares, are
  covered by the margin argued in render.cu's header);
- frames rendered with the culled casts taken as misses are byte-equal to
  frames that cast every ray, in both modes;
- the rectangle holds the box's corners projected independently, in world
  space, and stays within 1e-3 screen units of them (so the cull skips);
  a box with a corner at or behind the camera plane is never culled;
- ``raycast.slab_cull_violations``, the count the card's smoke run holds
  at 0, sees a rectangle shrunk below the box, in both modes;
- the kernel's launch shape stages as many repeats' frames in shared
  memory as fit, and writes a frame too large for it straight out, and the
  renderer's tables are in the kernel's layout in both modes;
- ``chip_smoke.needed_plain``, whose op census bounds K3/K4 and K5b, gives
  the plain version's frames with a fraction of its work.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.physics import soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import (
    SLAB_FRAME_BYTES, Renderer, slab_blocking, slab_pixel_table)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE_POSES = 1024  # per case; five cases
RESET_POSES = 128
CHUNK = 256
CASES = [(1, 1, 0), (2, 1, 0), (1, 2, 0), (2, 2, 0), (2, 2, 2)]  # cameras, obs_pool, obs_samples
IDS = [f"cams{c}_pool{p}_samples{s}" for c, p, s in CASES]
# Each case in both cast modes: the reciprocal slab (K3/K4), then the ratio
# slab (K5b, recip False).
MODE_CASES = [(i, True) for i in range(len(CASES))] + [(i, False) for i in range(len(CASES))]
MODE_IDS = IDS + [f"{i}_ratio" for i in IDS]


def _config(cams, pool, samples):
    return CartpoleConfig(num_cameras=cams, obs_samples=samples, obs_pool=pool,
                          discrete_actions=False, use_raw_pixels=True, render_width=50,
                          render_height=50, action_repeats=3, steps_per_repeat=5,
                          solver_iterations=3)


def _reset_poses(cfg, scene, e=RESET_POSES, seed=0):
    g = torch.Generator().manual_seed(seed)
    state, _ = cartpole.reset_batched(cfg, scene, e, soa.step_substeps_batched,
                                      lambda s, r: torch.zeros((e, 1)), "cpu", generator=g)
    return raycast.poses_from_rigid(state.rigid)


def _poses(case_idx, cfg, scene):
    return torch.cat([raycast.cull_probe_poses(PROBE_POSES, seed=case_idx),
                      _reset_poses(cfg, scene, seed=case_idx)])


def _outside(px, py, rect):
    """Whether each sub-ray lies outside its box's cull rectangle."""
    xlo, xhi, ylo, yhi = rect
    return (px < xlo) | (px > xhi) | (py < ylo) | (py > yhi)


@pytest.mark.parametrize("case, recip", MODE_CASES, ids=MODE_IDS)
def test_cull_never_skips_a_hit(case, recip):
    cfg = _config(*CASES[case])
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    ray_abs = float(planes[:2].abs().max())
    poses = _poses(case, cfg, scene)
    violations, ray_violations, hits, culled, unbounded, total = 0, 0, 0, 0, 0, 0
    for start in range(0, poses.shape[0], CHUNK):
        chunk = poses[start : start + CHUNK]
        mask = raycast.slab_cast_mask(scene, chunk, planes, meta, p2, n, raycast.pooled_width(cfg))
        for c, (basis, eye) in enumerate(meta):
            rows = planes[:, c].reshape(4, 1, p2 * n)
            for b, (center, quat, he) in enumerate(raycast.pose_boxes(scene, chunk)):
                setup = raycast._slab_setup(basis, eye, center, quat, raycast.LIGHT_DIR)
                rect = raycast.slab_cull_rect(setup, he, ray_abs)
                hit32 = raycast._slab_cast(rows[0], rows[1], setup, he, recip)[3]
                setup64 = tuple(tuple(x.double() for x in v) for v in setup)
                hit64 = raycast._slab_cast(rows[0].double(), rows[1].double(), setup64, he,
                                           recip)[3]
                hit = hit32 | hit64
                # per (warp, box): the kernel's decision, on every sub-ray of the warp
                violations += int((hit & ~mask[:, c, :, b]).sum())
                # per sub-ray: the rectangle alone
                ray_violations += int((hit & _outside(rows[0], rows[1], rect)).sum())
                hits += int(hit32.sum())
                culled += int((~mask[:, c, :, b]).sum())
                unbounded += int(torch.isinf(rect[0]).sum())
                total += hit.numel()
    assert violations == 0, f"{violations} sub-rays of culled (warp, box) pairs hit their box"
    assert ray_violations == 0, f"{ray_violations} sub-rays outside their rectangle hit the box"
    # The probe reaches both branches of the predicate.
    assert hits > 0 and culled > total // 2 and unbounded > 0, (hits, culled, unbounded)


@pytest.mark.parametrize("case, recip", MODE_CASES, ids=MODE_IDS)
def test_culled_frames_are_byte_equal(case, recip):
    cfg = _config(*CASES[case])
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    poses = _poses(case, cfg, scene)[::2]
    mask = raycast.slab_cast_mask(scene, poses, planes, meta, p2, n, raycast.pooled_width(cfg))
    assert mask.shape == (poses.shape[0], len(meta), p2 * n, 2)
    want = raycast.render_frames(scene, poses, planes, meta, p2, n, recip=recip)
    got = raycast.render_frames(scene, poses, planes, meta, p2, n, recip=recip, cast_mask=mask)
    assert torch.equal(got, want)
    assert not bool(mask.all())


def _world_corners(center, quat, he):
    """(E, 8, 3) float64 corners of boxes from numpy poses."""
    w, x, y, z = quat.T
    r = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)  # (E, 3, 3)
    signs = np.array([[(i >> k & 1) * 2 - 1 for k in range(3)] for i in range(8)], np.float64)
    return center[:, None] + np.einsum("eij,cj->eci", r, signs * np.asarray(he, np.float64))


@pytest.mark.parametrize("cams", [1, 2])
def test_rect_holds_the_box_image(cams):
    cfg = _config(cams, 2, 0)
    scene = cartpole.scene_for(cfg)
    planes, meta, _ = raycast.ray_planes(cfg)
    ray_abs = float(np.abs(planes[:2]).max())
    poses = _poses(10 + cams, cfg, scene)
    p = poses.double().numpy()
    in_front = behind = 0
    for basis, eye in meta:
        fwd, right, up = (np.asarray(v, np.float64) for v in basis)
        for b, (center, quat, he) in enumerate(raycast.pose_boxes(scene, poses)):
            corners = _world_corners(p[:, 7 * b : 7 * b + 3], p[:, 7 * b + 3 : 7 * b + 7], he)
            rel = corners - np.asarray(eye, np.float64)
            depth = rel @ fwd
            xs, ys = (rel @ right) / depth, (rel @ up) / depth
            setup = raycast._slab_setup(basis, eye, center, quat, raycast.LIGHT_DIR)
            xlo, xhi, ylo, yhi = (t[:, 0].double().numpy()
                                  for t in raycast.slab_cull_rect(setup, he, ray_abs))
            f = (depth > 1e-2).all(1)  # wholly in front
            never = (depth <= 0.0).any(1)
            assert np.isinf(xlo[never]).all() and np.isinf(yhi[never]).all()
            assert (xlo[f] <= xs[f].min(1)).all() and (xs[f].max(1) <= xhi[f]).all()
            assert (ylo[f] <= ys[f].min(1)).all() and (ys[f].max(1) <= yhi[f]).all()
            # Tight where the box is in view at a working distance (its
            # image within twice the frame; the margin grows with the image).
            t = f & (depth > 0.3).all(1) & (np.abs(xs) < 2 * ray_abs).all(1) \
                & (np.abs(ys) < 2 * ray_abs).all(1)
            slack = max((xs[t].min(1) - xlo[t]).max(), (xhi[t] - xs[t].max(1)).max(),
                        (ys[t].min(1) - ylo[t]).max(), (yhi[t] - ys[t].max(1)).max())
            assert t.sum() > 0 and slack < 1e-3, slack
            in_front += int(f.sum())
            behind += int(never.sum())
    assert in_front > 0 and behind > 0, (in_front, behind)


def test_cull_skips_most_casts_at_reset():
    """At config 5's reset poses both boxes are small in the frame: the
    rectangles rule out most sub-rays, and the warps (32 pooled pixels,
    about 1.3 columns of the 25x25 frame) skip most of their casts, or the
    kernel gains nothing."""
    cfg = _config(2, 2, 2)
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    poses = _reset_poses(cfg, scene)
    mask = raycast.slab_cast_mask(scene, poses, planes, meta, p2, n, raycast.pooled_width(cfg))
    assert float(mask.float().mean()) < 0.3
    rows = planes[:, 0].reshape(4, 1, p2 * n)
    for center, quat, he in raycast.pose_boxes(scene, poses):
        setup = raycast._slab_setup(*meta[0], center, quat, raycast.LIGHT_DIR)
        rect = raycast.slab_cull_rect(setup, he, float(planes[:2].abs().max()))
        assert float(_outside(rows[0], rows[1], rect).float().mean()) > 0.9


def test_renderer_passes_the_ray_bound():
    cfg = _config(2, 2, 2)
    rnd = Renderer(cfg, "cpu")
    params = rnd.kernel_params(cartpole.scene_for(cfg))
    assert params.ray_abs == pytest.approx(float(rnd.planes[:2].abs().max()), rel=1e-7)
    assert params.ray_abs > 0.4


def test_probe_poses_are_seeded_unit_quaternions():
    a, b = raycast.cull_probe_poses(50, 3), raycast.cull_probe_poses(50, 3)
    assert torch.equal(a, b) and not torch.equal(a, raycast.cull_probe_poses(50, 4))
    for q in (a[:, 3:7], a[:, 10:14]):
        assert torch.allclose(q.norm(dim=1), torch.ones(50), atol=1e-6)
    rigid = RigidState(pos=torch.stack([a[:, 0:3], a[:, 7:10]], 1),
                       quat=torch.stack([a[:, 3:7], a[:, 10:14]], 1),
                       vel=torch.zeros(50, 2, 3), ang=torch.zeros(50, 2, 3))
    assert torch.equal(raycast.poses_from_rigid(rigid), a)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_pixel_table_holds_the_background_sums(case):
    """Where a warp casts no box, the kernel takes each pooled pixel's
    ground and sky fields from its table: they must be the sums the
    shading adds up when every sub-ray misses (0.0 + first + second ...,
    in float32), the pixel's rectangle the min/max of its sub-rays, its
    index the frame's, all in the kernel's column-by-column order."""
    cfg = _config(*CASES[case])
    planes, _, (p2, n) = raycast.ray_planes(cfg)
    width = raycast.pooled_width(cfg)
    order = raycast.slab_order(n, width)
    assert sorted(order) == list(range(n)) and order[1] == width
    table = slab_pixel_table(planes, order)
    assert table.shape == (cfg.num_cameras, n, 8) and table.dtype == np.float32
    px, py = planes[0][..., order], planes[1][..., order]
    assert np.array_equal(table[..., 0], px.min(1)) and np.array_equal(table[..., 1], px.max(1))
    assert np.array_equal(table[..., 2], py.min(1)) and np.array_equal(table[..., 3], py.max(1))
    g = s = torch.zeros((cfg.num_cameras, n), dtype=torch.float32)
    for i in range(p2):  # the order of raycast.render_frames' pooling sum
        g, s = g + torch.from_numpy(planes[2, :, i]), s + torch.from_numpy(planes[3, :, i])
    assert torch.equal(torch.from_numpy(table[..., 4]), g[:, order])
    assert torch.equal(torch.from_numpy(table[..., 5]), s[:, order])
    assert np.array_equal(table[..., 6], np.broadcast_to(order, (cfg.num_cameras, n)))
    assert not table[..., 7].any()


@pytest.mark.parametrize("cams, recip", [(1, True), (2, True), (1, False), (2, False)],
                         ids=["1", "2", "1_ratio", "2_ratio"])
def test_renderer_slab_tables_are_in_the_kernels_layout(cams, recip):
    """The slab kernel, in both its cast modes, indexes its two tables as
    flat C-order arrays: the ray table (C, p2, n, 4) and the pixel table
    (C, n, 8), rows in ``slab_order``.  A strided table (numpy's fancy
    indexing can return one, and ``.to`` keeps strides) would feed camera
    0's rows to camera 1."""
    cfg = _config(cams, 2, 2)
    rnd = Renderer(cfg, "cpu", recip=recip)
    assert rnd.runs is None and rnd.mxu_frags is None
    order = raycast.slab_order(rnd.n, rnd.width)
    assert rnd.slab_rays.is_contiguous() and rnd.slab_pixels.is_contiguous()
    assert tuple(rnd.slab_rays.shape) == (cams, rnd.p2, rnd.n, 4)
    flat = rnd.slab_pixels.reshape(-1, 8)
    planes = rnd.planes
    for c in range(cams):
        rows = flat[c * rnd.n : (c + 1) * rnd.n]
        assert torch.equal(rows[:, 6], torch.from_numpy(order).float())
        assert torch.equal(rows[:, 0], planes[0, c].min(0).values[order])
        rays = rnd.slab_rays.reshape(-1, 4)[c * rnd.p2 * rnd.n : (c + 1) * rnd.p2 * rnd.n]
        want = planes[:, c][..., order].permute(1, 2, 0)
        assert torch.equal(rays.reshape(rnd.p2, rnd.n, 4), want)


def _shrunk_rectangle_counts(monkeypatch, recip):
    """The violation count of ``recip``'s cast on 16 reset poses as the cull
    stands, then with every rectangle shrunk by 0.02 screen units."""
    cfg = _config(2, 2, 2)
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    poses = _reset_poses(cfg, scene, e=16)
    count = lambda: raycast.slab_cull_violations(scene, poses, planes, meta, p2, n,
                                                 raycast.pooled_width(cfg), recip)
    before = count()
    monkeypatch.setattr(raycast, "CULL_FLOOR", -0.02)
    return before, count()


def test_violation_count_sees_a_shrunk_rectangle(monkeypatch):
    """The count is 0 on these poses as the cull stands, and not 0 once
    every rectangle is shrunk by 0.02 screen units (a cull that drops
    silhouette edges)."""
    before, shrunk = _shrunk_rectangle_counts(monkeypatch, True)
    assert before == 0
    assert shrunk > 0


def test_ratio_violation_count_sees_a_shrunk_rectangle(monkeypatch):
    """As above, counted against K5b's ratio cast."""
    before, shrunk = _shrunk_rectangle_counts(monkeypatch, False)
    assert before == 0
    assert shrunk > 0


@pytest.mark.parametrize("cams, n, r, want", [
    (2, 625, 3, (3, True)),        # config 5: the main path's 3 repeats per block
    (2, 625, 1, (1, True)),        # K4
    (1, 625, 3, (3, True)),
    (1, 50 * 50, 3, (3, True)),    # 1 camera unpooled at 50 x 50
    (1, 124 * 124, 3, (1, True)),  # one frame fits, not three
    (2, 96 * 96, 3, (3, False)),   # config 5 at 192 x 192: a frame over the limit
    (1, 126 * 126, 3, (3, False)),
])
def test_slab_blocking(cams, n, r, want):
    reps, staged = slab_blocking(cams, n, r)
    assert (reps, staged) == want
    assert reps * 16 * cams <= 128 and (not staged or reps * cams * 3 * n <= SLAB_FRAME_BYTES)
    # render.cu: 48 KiB less 8 repeats x 2 cameras x 2 boxes x 19 floats
    assert SLAB_FRAME_BYTES == 46720


@pytest.mark.parametrize("samples, recip", [(1, True), (2, True), (1, False), (2, False)],
                         ids=["1", "2", "1_ratio", "2_ratio"])
def test_needed_work_census(samples, recip):
    """chip_smoke's bound for K3/K4 and K5b: a plain version that casts a
    box only where it hits and shades only the pixels a box hits gives the
    plain frames, and on reset poses does a small part of the full work."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = _config(2, 2, samples)
    scene = cartpole.scene_for(cfg)
    rnd = Renderer(cfg, "cpu", recip=recip)
    poses = torch.cat([_reset_poses(cfg, scene, e=30),
                       raycast.cull_probe_poses(30, 5)]).reshape(3, 20, 16)
    needed = chip_smoke.needed_plain(scene, rnd, poses)
    plain = lambda: rnd.plain(scene, poses)
    assert torch.equal(needed(), plain())
    assert 0 < chip_smoke.census(needed) < 0.2 * chip_smoke.census(plain)
