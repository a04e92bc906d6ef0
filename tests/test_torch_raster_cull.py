"""The raster render kernels' cull (K5a, K5d; csrc/render.cu) on the CPU.

The kernels skip the cast of a box for a warp's pooled pixels where
interval bounds of the raster cast's values, rounded down and up in
float32, prove that no sub-ray in the rectangle of the warp's run of
pixels hits it; the skipped casts take the cast's miss values.  K5d's
bounds are widened for its tensor-core product.  ``raycast.raster_may_hit`` is the plain
version of the test, ``raster_cast_mask`` of the kernels' decisions.
These tests hold them, on poses chosen to break them
(``raycast.cull_probe_poses``), reset poses and the poses of one step from
there, at ``obs_pool`` 1 and 2 and 1 and 2 cameras:

- no sub-ray that the raster cast hits, in float32 or in float64 from the
  same setup (or, for K5d, from the float32 product of its bound planes),
  is skipped (zero violations);
- frames rendered with the skipped casts taken as misses are byte-equal to
  frames that cast every ray;
- ``raycast.raster_cull_violations`` sees rectangles shrunk inside the
  pixels they bound;
- the directed rounding, emulated from float64, brackets float32's
  round-to-nearest result and is one ulp wide at most, also where the
  float64 sum is inexact;
- the raster kernels' tables are in the layout the kernels index;
- K5d's widening holds against a CPU emulation of its 3xTF32 product,
  accumulated in several orders, rounding or truncating;
- ``chip_smoke.needed_plain``, whose op census bounds K5a and K5d, gives
  the plain raster's frames with a fraction of its work.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.physics import soa
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import (
    RASTER_FRAME_BYTES, Renderer, slab_blocking, slab_pixel_table, tf32_split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

PROBE_POSES = 640  # per case
RESET_POSES = 64   # per case, and as many stepped once
CHUNK = 256
CASES = [(1, 1), (2, 1), (1, 2), (2, 2)]  # cameras, obs_pool; obs_samples 0 (exact)
IDS = [f"cams{c}_pool{p}" for c, p in CASES]


def _config(cams, pool):
    return CartpoleConfig(num_cameras=cams, obs_samples=0, obs_pool=pool, discrete_actions=False,
                          use_raw_pixels=True, render_width=50, render_height=50,
                          action_repeats=3, steps_per_repeat=5, solver_iterations=3)


def _poses(case_idx, cfg, scene):
    """Probe poses, reset poses and the poses of one step from the reset
    under a seeded force (the main path's), (E, 16)."""
    g = torch.Generator().manual_seed(case_idx)
    state, _ = cartpole.reset_batched(cfg, scene, RESET_POSES, soa.step_substeps_batched,
                                      lambda s, r: torch.zeros((RESET_POSES, 1)), "cpu",
                                      generator=g)
    force = 20.0 * (2.0 * torch.rand((RESET_POSES, 2), generator=g) - 1.0)
    force = torch.cat([force, torch.zeros((RESET_POSES, 1))], -1)
    _, stepped = soa.step_repeats_batched(scene, state.rigid, force, cfg.steps_per_repeat, 1)
    return torch.cat([raycast.cull_probe_poses(PROBE_POSES, seed=20 + case_idx),
                      raycast.poses_from_rigid(state.rigid), stepped[0]])


def _setup(meta, c, center, quat, he):
    return raycast._obb_q_setup(*meta[c], center, quat, he, raycast.LIGHT_DIR)


@pytest.mark.parametrize("mxu", [False, True], ids=["k5a", "k5d"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_raster_cull_never_skips_a_hit(case, mxu):
    cfg = _config(*CASES[case])
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    order = raycast.slab_order(n, raycast.pooled_width(cfg))  # the kernels' order here
    poses = _poses(case, cfg, scene)
    violations, skipped, total = 0, 0, 0
    for start in range(0, poses.shape[0], CHUNK):
        chunk = poses[start : start + CHUNK]
        violations += raycast.raster_cull_violations(scene, chunk, planes, meta, p2, n, order,
                                                     mxu)
        mask = raycast.raster_cast_mask(scene, chunk, planes, meta, p2, n, order, mxu)
        skipped += int((~mask).sum())
        total += mask.numel()
    assert violations == 0, f"{violations} skipped (sub-ray, box) casts hit their box"
    assert skipped > total // 2, (skipped, total)  # the cull skips most casts on these poses


@pytest.mark.parametrize("mxu", [False, True], ids=["k5a", "k5d"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_raster_culled_frames_are_byte_equal(case, mxu):
    cfg = _config(*CASES[case])
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    poses = _poses(case, cfg, scene)[::3]
    mask = raycast.raster_cast_mask(scene, poses, planes, meta, p2, n,
                                    raycast.slab_order(n, raycast.pooled_width(cfg)), mxu)
    assert mask.shape == (poses.shape[0], len(meta), p2 * n, 2)
    want = raycast.render_frames(scene, poses, planes, meta, p2, n, raster=True, mxu=mxu)
    got = raycast.render_frames(scene, poses, planes, meta, p2, n, raster=True, mxu=mxu,
                                cast_mask=mask)
    assert torch.equal(got, want)
    assert not bool(mask.all())


def test_violation_count_sees_a_shrunk_interval(monkeypatch):
    """The count is 0 on these poses as the cull stands, and not 0 once the
    rectangles the bounds are taken over are shrunk by 0.02 screen units on
    every side (bounds that miss silhouette edges)."""
    cfg = _config(2, 2)
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    planes = torch.from_numpy(planes)
    poses = _poses(0, cfg, scene)[PROBE_POSES:]
    order = raycast.slab_order(n, raycast.pooled_width(cfg))
    count = lambda: raycast.raster_cull_violations(scene, poses, planes, meta, p2, n, order)
    assert count() == 0
    q_bounds = raycast.raster_q_bounds

    def shrunk(setup, rects, widen=None):
        xlo, xhi, ylo, yhi = rects
        return q_bounds(setup, (xlo + 0.02, xhi - 0.02, ylo + 0.02, yhi - 0.02), widen)

    monkeypatch.setattr(raycast, "raster_q_bounds", shrunk)
    assert count() > 0


def _f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_directed_rounding_brackets_round_to_nearest():
    """On seeded float32 triples (a, b, c) spanning 80 binades, zeros and
    exponent gaps past float64's reach: rd ≤ float32's rn ≤ ru, for a·b,
    a + b and (a + b·c) + c·a evaluated as the cast evaluates w; ru is at
    most one ulp above rd, and rd = ru exactly where the result is exact."""
    rng = np.random.default_rng(7)
    k = 200_000
    mant = rng.uniform(1.0, 2.0, (3, k)) * rng.choice((-1.0, 1.0), (3, k))
    a, b, c = (_f32(m * 2.0 ** rng.integers(-40, 40, k)) for m in mant)
    a[:500], b[500:1000] = 0.0, -0.0
    b[1000:2000] = a[1000:2000] * 2.0**-35  # exponent gaps past 29 bits
    for up in (False, True):
        assert raycast._mul_dir(a, b, up).dtype == torch.float32
    cases = {
        "mul": (lambda up: raycast._mul_dir(a, b, up), a * b),
        "add": (lambda up: raycast._add_dir(a, b, up), a + b),
        "w": (lambda up: raycast._add_dir(raycast._add_dir(a, raycast._mul_dir(b, c, up), up),
                                          raycast._mul_dir(c, a, up), up),
              (a + b * c) + c * a),
    }
    for name, (bound, rn) in cases.items():
        lo, hi = bound(False), bound(True)
        assert bool((lo <= rn).all()) and bool((rn <= hi).all()), name
        if name != "w":  # one rounding: at most one ulp apart
            assert bool((hi <= torch.nextafter(lo, torch.full_like(lo, float("inf")))).all()), name
    exact = (a.double() * b.double()) == (a * b).double()
    assert torch.equal(raycast._mul_dir(a, b, False)[exact], raycast._mul_dir(a, b, True)[exact])
    # A sum whose float64 value is inexact (a gap past 53 bits) still rounds
    # each way exactly.
    one, tiny = _f32([1.0]), _f32([2.0**-60])
    assert float(raycast._add_dir(one, tiny, True)) == float(np.nextafter(np.float32(1),
                                                                         np.float32(2)))
    assert float(raycast._add_dir(one, tiny, False)) == 1.0


@pytest.mark.parametrize("mode", [dict(), dict(mxu=True), dict(hoist=True)],
                         ids=["k5a", "k5d", "k5c"])
@pytest.mark.parametrize("cams, size, pool, staged", [
    (1, 50, 2, True), (2, 50, 2, True),
    (2, 200, 1, False),  # a frame over RASTER_FRAME_BYTES: written to global memory
], ids=["1cam", "2cam", "2cam_unpooled_200"])
def test_raster_tables_are_in_the_kernels_layout(cams, size, pool, staged, mode):
    """The raster kernels (K5a, K5c from its packed setups, K5d) index the
    slab kernel's ray and pixel tables (C, p2, n, 4) and (C, n, 8) in their
    order of the pixels (column by column, whether or not the frames are
    staged), a run table (C, ceil(n / 32), 4) of the rectangles of each
    warp's run of pixels and, K5d, its A operands (C, p2, ceil(n / 32), 32,
    8), all flat C-order arrays; K5c's setup table is (R, E, C·2·22)."""
    cfg = dataclasses.replace(_config(cams, pool), render_width=size, render_height=size)
    rnd = Renderer(cfg, "cpu", raster=True, **mode)
    mxu = rnd.mxu
    assert rnd.hoist == bool(mode.get("hoist")) and rnd.setup_width == cams * 2 * 22
    planes = rnd.planes.numpy()
    assert (rnd.frame_width <= RASTER_FRAME_BYTES) == staged
    order = raycast.slab_order(rnd.n, rnd.width)
    assert np.array_equal(rnd.order, order)
    runs = -(-rnd.n // 32)
    assert rnd.slab_rays.is_contiguous() and rnd.slab_pixels.is_contiguous()
    assert torch.equal(rnd.slab_rays, torch.from_numpy(
        np.ascontiguousarray(planes[..., order].transpose(1, 2, 3, 0))))
    assert torch.equal(rnd.slab_pixels, torch.from_numpy(slab_pixel_table(planes, order)))
    assert rnd.runs.is_contiguous() and tuple(rnd.runs.shape) == (cams, runs, 4)
    rects = raycast.slab_pixel_rects(planes)[:, order]
    for r in range(runs):
        part = rects[:, 32 * r : 32 * (r + 1)]  # the last run: its own pixels only
        want = np.stack([part[..., 0].min(1), part[..., 1].max(1), part[..., 2].min(1),
                         part[..., 3].max(1)], -1)
        assert np.array_equal(rnd.runs[:, r].numpy(), want)
    assert (rnd.mxu_frags is not None) == mxu
    if not mxu:
        return
    frags = rnd.mxu_frags
    assert frags.is_contiguous() and tuple(frags.shape) == (cams, rnd.p2, runs, 32, 8)
    flat = frags.reshape(-1, 8)  # (camera, sub-ray, run, lane) in C order
    for c in range(cams):
        for s in range(rnd.p2):
            for r in (0, runs - 1):
                for lane in (0, 5, 14, 31):
                    g, t = lane // 4, lane % 4
                    row = flat[((c * rnd.p2 + s) * runs + r) * 32 + lane].numpy()
                    for j in range(4):
                        q = min(32 * r + g + 8 * j, rnd.n - 1)
                        want = (planes[0, c, s, order[q]], planes[1, c, s, order[q]], 1.0,
                                0.0)[t]
                        hi, lo = row[j], row[4 + j]
                        assert abs(float(hi) + float(lo) - float(want)) <= 2.0**-21 * abs(want)
    bits = frags.numpy().view(np.uint32)
    assert not (bits & 0x1FFF).any()  # every part is a TF32 value


def test_tf32_split():
    """hi is x rounded to TF32 (ties away from zero), lo the residual
    rounded alike: hi + lo within 2^-21 |x| of x, both TF32 values."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=10_000) * 10.0 ** rng.integers(-8, 9, 10_000)).astype(np.float32)
    x[:3] = (1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1e9)  # two ties and the ±BIG bias
    hi, lo = tf32_split(x)
    assert hi.dtype == np.float32 and lo.dtype == np.float32
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert hi[0] == np.float32(1.0 + 2.0**-10) and hi[1] == -hi[0]
    assert float(hi[2]) + float(lo[2]) == 1e9  # BIG splits exactly
    err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert (err <= 2.0**-21 * np.abs(x)).all()
    assert (np.abs(x.astype(np.float64) - hi) <= 2.0**-11 * np.abs(x)).all()


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 → float32: to nearest, or toward zero."""
    if mode == "rn":
        return x.to(torch.float32)
    return torch.where(x < 0, raycast._round_f32(x, True), raycast._round_f32(x, False))


def _mma(acc, terms, model):
    """One m16n8k4 accumulation in float32, emulated: the float32
    accumulator plus four exact products (float64), summed left to right,
    right to left or in pairs, each sum rounded to nearest or toward zero;
    or ("aligned") every addend truncated to 24 bits below the largest
    one's leading bit, summed exactly, the sum truncated."""
    if model == "aligned":
        vals = [acc.double(), *terms]
        _, e = torch.frexp(torch.stack(vals).abs().amax(0))
        quantum = torch.ldexp(torch.ones_like(vals[0]), (e - 24).to(torch.int32))
        total = sum(torch.trunc(v / quantum) * quantum for v in vals)
        return _round(total, "rz")
    order, mode = model.split("_")
    r = lambda x: _round(x, mode).double()
    if order == "pairs":
        return _round((r(r(terms[0] + terms[1]) + r(terms[2] + terms[3]))) + acc.double(), mode)
    seq = [acc.double(), *terms] if order == "fwd" else [*terms[::-1], acc.double()]
    total = seq[0]
    for v in seq[1:]:
        total = r(total + v)
    return total.to(torch.float32)


MODELS = ["fwd_rn", "rev_rn", "pairs_rn", "fwd_rz", "rev_rz", "pairs_rz", "aligned"]


@pytest.mark.parametrize("model", MODELS)
def test_mxu_widening_holds_for_the_3xtf32_product(model):
    """K5d's planes come from three m16n8k4 products per sub-ray (residual
    rays x high coefficients, high rays x residual coefficients, high x
    high) over depth (px, py, 1, 0).  Emulated here for every bound plane
    and sub-ray under several accumulation models, the cascade's q_lo and
    q_hi stay inside the widened bounds of ``raster_q_bounds`` taken over
    each sub-ray alone (the narrowest rectangle a pixel can have)."""
    cfg = _config(2, 2)
    scene = cartpole.scene_for(cfg)
    planes, meta, (p2, n) = raycast.ray_planes(cfg)
    ray_abs = float(np.abs(planes[:2]).max())
    poses = torch.cat([raycast.cull_probe_poses(160, 9), _poses(3, cfg, scene)[PROBE_POSES:]])
    poses = poses[::2]
    worst = 0.0
    for c in range(len(meta)):
        px, py = planes[0, c].reshape(-1)[::3], planes[1, c].reshape(-1)[::3]
        x_parts = [tf32_split(v) for v in (px, py, np.ones_like(px))]  # (hi, lo) per depth
        for center, quat, he in raycast.pose_boxes(scene, poses):
            setup = _setup(meta, c, center, quat, he)
            rows = raycast.bound_rows(setup)  # 9 × (E, 8) float32
            vals = []
            for row in rows:
                coef = [row[:, j].numpy() for j in (0, 1, 4)]
                c_parts = [tf32_split(v) for v in coef]
                prod = lambda xs, cs: [torch.from_numpy(
                    xs[j][None, :].astype(np.float64) * cs[j][:, None].astype(np.float64))
                    for j in range(3)] + [torch.zeros((len(coef[0]), len(px)),
                                                      dtype=torch.float64)]
                acc = torch.zeros((len(coef[0]), len(px)), dtype=torch.float32)
                for xi, ci in ((1, 0), (0, 1), (0, 0)):  # lo·hi, hi·lo, hi·hi
                    acc = _mma(acc, prod([p[xi] for p in x_parts], [q[ci] for q in c_parts]),
                               model)
                vals.append(acc)
            q_lo = torch.stack(vals[0:3] + vals[6:9]).amax(0)
            q_hi = torch.stack(vals[3:6]).amin(0)
            rect = (_f32(px), _f32(px), _f32(py), _f32(py))
            lo_b, hi_b = raycast.raster_q_bounds(setup, rect, raycast.mxu_widening(setup,
                                                                                   ray_abs))
            q_lo = torch.maximum(q_lo, lo_b.new_tensor(1e-30))
            assert bool((q_lo >= lo_b).all()), model
            assert bool((q_hi <= hi_b).all()), model
            # How much of the widening the product used, on each side, where
            # the widening is finite and not zero.
            unwidened = raycast.raster_q_bounds(setup, rect)
            for used, gap in (((unwidened[0] - q_lo).double(), (unwidened[0] - lo_b).double()),
                              ((q_hi - unwidened[1]).double(), (hi_b - unwidened[1]).double())):
                ok = (gap > 0) & torch.isfinite(gap)
                if bool(ok.any()):
                    worst = max(worst, float((used[ok] / gap[ok]).max()))
    print(f"{model}: worst share of the widening used {worst:.6g}")
    # The header's bound on the product's error, 12.5 x 2^-22 S, is under
    # 1/16 of the widening 2^-14 S: the emulation must stay within it.
    assert worst <= 1 / 16, worst


@pytest.mark.parametrize("cams, n, r, want", [
    (1, 625, 3, (3, True)),         # 1cam_exact: the main path's 3 repeats per block
    (2, 625, 1, (1, True)),         # the batched launch
    (1, 124 * 124, 3, (1, True)),   # one frame fits the default budget, not three
    (2, 96 * 96, 3, (3, False)),    # 2 cameras at 192 x 192: global stores
    (2, 200 * 200, 3, (3, False)),  # 2 cameras unpooled at 200 x 200: global stores
])
def test_raster_blocking(cams, n, r, want):
    """The raster kernels block as the slab kernel does
    (``slab_blocking``), with the shared memory left beside their static
    setup (8 repeat-cameras x 2 boxes x 32 floats): as many repeats'
    frames as fit in the default 48 KiB, staged, and a frame larger than
    that written straight to global memory."""
    assert RASTER_FRAME_BYTES == 48 * 1024 - 2048
    assert slab_blocking(cams, n, r, RASTER_FRAME_BYTES) == want
    # The slab kernel's own budget is the default.
    assert slab_blocking(2, 96 * 96, 3) == (3, False)


@pytest.mark.parametrize("cams", [1, 2])
def test_raster_needed_work_census(cams):
    """chip_smoke's bound for K5a and K5d: a plain raster that casts a box
    only where it hits and shades only the pixels a box hits gives the
    plain frames, and on these poses does a small part of the full work."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = _config(cams, 2)
    scene = cartpole.scene_for(cfg)
    rnd = Renderer(cfg, "cpu", raster=True)
    poses = torch.cat([raycast.cull_probe_poses(30, 6),
                       _poses(4, cfg, scene)[PROBE_POSES:][:30]]).reshape(3, 20, 16)
    needed = chip_smoke.needed_plain(scene, rnd, poses)
    plain = lambda: rnd.plain(scene, poses)
    assert torch.equal(needed(), plain())
    assert 0 < chip_smoke.census(needed) < 0.2 * chip_smoke.census(plain)
