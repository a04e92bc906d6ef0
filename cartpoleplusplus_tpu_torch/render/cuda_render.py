"""Wrappers of the CUDA render kernels (csrc/render.cu): K3/K4 in the slab
mode and K5b in the division-free ratio slab mode (both skip the box casts
their cull rectangles rule out), K5a in the raster mode (which skips the box
casts its interval bounds rule out), K5c (the raster from a hoisted setup
table, culled as K5a) and K5d (raster with its bound planes on the tensor
cores, culled as K5a).

Counterparts of cartpoleplusplus_tpu.render.pallas_kernel's
``make_render_repeats`` (K3's launch) and ``make_render_batched`` (K4's
launch) in every mode their flags select.  For CUDA tensors they launch the
kernel or raise; for CPU tensors they run the plain PyTorch version in
render/raycast.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, SceneParams
from cartpoleplusplus_tpu_torch.render import raycast

MAX_CAMS = 2
# The kernel's cast modes (enum Mode in csrc/render.cu).
SLAB, RASTER, RATIO, RASTER_HOIST, MXU, MXU_HOIST = range(6)


class RenderParams(ctypes.Structure):
    """Mirror of ``struct RenderParams`` in csrc/render.cu."""

    _fields_ = [
        ("basis", (ctypes.c_float * 9) * MAX_CAMS),
        ("eye", (ctypes.c_float * 3) * MAX_CAMS),
        ("he", (ctypes.c_float * 3) * 2),
        ("light", ctypes.c_float * 3),
        ("ambient", ctypes.c_float),
        ("diffuse", ctypes.c_float),
        ("inv_p2", ctypes.c_float),
        ("cart_color", ctypes.c_float * 3),
        ("pole_color", ctypes.c_float * 3),
        ("sky_color", ctypes.c_float * 3),
        ("num_cams", ctypes.c_int),
        ("p2", ctypes.c_int),
        ("n", ctypes.c_int),
        ("ray_abs", ctypes.c_float),
        ("cull", ctypes.c_int),  # the raster kernels' cull: 1 on (always, here), 0 off
    ]


def slab_pixel_table(planes: np.ndarray, order: np.ndarray) -> np.ndarray:
    """The slab kernel's per-pixel table: planes (4, C, p2, n) → float32
    (C, n, 8), per pooled pixel the screen rectangle of its sub-rays
    (``raycast.slab_pixel_rects``), the float32 sums over its sub-rays, in
    order from 0.0, of the ground value and of the sky mask (what the
    kernel's shading adds up where every sub-ray misses both boxes), its
    index in the frame and a zero; row q holds pixel ``order[q]``."""
    _, c, p2, n = planes.shape
    table = np.zeros((c, n, 8), np.float32)
    table[..., :4] = raycast.slab_pixel_rects(planes)
    for s in range(p2):
        table[..., 4] = table[..., 4] + planes[2, :, s]
        table[..., 5] = table[..., 5] + planes[3, :, s]
    table[..., 6] = np.arange(n)
    return np.ascontiguousarray(table[:, order])


def tf32_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float32 x → (hi, lo), float32 values that TF32 holds: hi = x rounded
    to TF32 (nearest, ties away from zero: ``cvt.rna.tf32.f32``), lo = the
    float32 residual x - hi (exact) rounded the same way (the 3xTF32
    split)."""

    def rna(v):
        bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
        return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)

    x = np.asarray(x, np.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def mxu_fragment_table(planes: np.ndarray, order: np.ndarray) -> np.ndarray:
    """K5d's A operands: planes (4, C, p2, n) → float32 (C, p2, ceil(n /
    32), 32, 8).  Per run of 32 pixels in ``order`` (the last padded with
    the last pixel), sub-ray and lane (g = lane // 4, t = lane % 4): the
    TF32 high parts of component t of (px, py, 1, 0) of the run's pixels
    g, g + 8, g + 16, g + 24, then their residuals (:func:`tf32_split`)."""
    _, c, p2, n = planes.shape
    runs = -(-n // raycast.WARP)
    idx = np.minimum(np.arange(runs * raycast.WARP), n - 1)
    px, py = planes[0][..., order][..., idx], planes[1][..., order][..., idx]
    comps = np.stack([px, py, np.ones_like(px), np.zeros_like(px)])  # (4, C, p2, runs*32)
    comps = comps.reshape(4, c, p2, runs, raycast.WARP)
    lane = np.arange(raycast.WARP)
    g, t = lane // 4, lane % 4
    vals = np.stack([comps[t, :, :, :, g + 8 * j] for j in range(4)], -1)  # (32, C, p2, runs, 4)
    hi, lo = tf32_split(np.moveaxis(vals, 0, -2))  # (C, p2, runs, 32, 4)
    return np.ascontiguousarray(np.concatenate([hi, lo], -1))


SLAB_THREADS = 128  # the render kernels' block (csrc/render.cu)
# Shared memory for a block's frames in the slab kernel (K3/K4, K5b): the
# default 48 KiB a block may use, less its setups and cull rectangles
# (SLAB_THREADS / 16 repeats x MAX_CAMS cameras x 2 boxes x (15 + 4)
# floats); render.cu's SLAB_FRAME_BYTES.  The raster kernels (K5a, K5c,
# K5d) keep 32 floats per (repeat x camera, at most SLAB_THREADS / 16, and
# box): RASTER_FRAME_BYTES.
SLAB_FRAME_BYTES = 48 * 1024 - SLAB_THREADS // 16 * MAX_CAMS * 2 * (15 + 4) * 4
RASTER_FRAME_BYTES = 48 * 1024 - SLAB_THREADS // 16 * 2 * 32 * 4


def slab_blocking(num_cams: int, n: int, r: int,
                  frame_bytes: int = SLAB_FRAME_BYTES) -> tuple[int, bool]:
    """A render kernel's repeats per block and whether it stages them
    in shared memory, for ``r`` repeats of ``num_cams`` frames of ``n``
    pooled pixels: as many repeats as 16 setup lanes per (repeat, camera)
    allow, cut to those whose frames fit in ``frame_bytes`` (the slab
    kernel's ``SLAB_FRAME_BYTES``, the raster kernels'
    ``RASTER_FRAME_BYTES``); where one frame does not fit, the kernel
    writes its pixels straight to global memory."""
    reps = min(r, SLAB_THREADS // (16 * num_cams))
    frame_w = num_cams * 3 * n
    if frame_w > frame_bytes:
        return reps, False
    return min(reps, frame_bytes // frame_w), True


class Renderer:
    """Renders a config's camera frames in one of the render kernel's modes.

    ``raster=False``: the slab cascade, with a reciprocal (K3/K4) or, with
    ``recip=False``, the division-free ratio cascade (K5b).  ``raster``:
    the projective raster (K5a); with ``hoist`` its setup is packed by a
    kernel of its own first (K5c), with ``mxu`` its bound planes come from
    a tensor-core product (K5d); the two may be combined.  As in the JAX
    package, ``recip`` acts only in the slab mode, ``hoist`` and ``mxu``
    only in the raster mode.

    Holds the static ray table (4, C, p2, n) for the plain version and the
    kernels' tables (``slab_rays``, ``slab_pixels``, in ``order``; the
    raster modes' ``runs``, K5d's ``mxu_frags``) on ``device``.  Frames are
    uint8, plane-major per camera, ``n`` pooled pixels per plane.  Launches
    count under ``render_repeats``/``render_batched`` plus the mode's
    suffix (``_ratio``, ``_raster``, ``_raster_hoist``, ``_raster_mxu``,
    ``_raster_hoist_mxu``), and each setup pass under ``pack_setups``.
    """

    def __init__(self, config, device, raster: bool = False, recip: bool = True,
                 hoist: bool = False, mxu: bool = False):
        self.raster = bool(raster)
        self.recip = bool(recip) or self.raster
        self.hoist = bool(hoist) and self.raster
        self.mxu = bool(mxu) and self.raster
        if not self.raster:
            self.mode, self.suffix = (SLAB, "") if self.recip else (RATIO, "_ratio")
        else:
            if self.mxu:
                self.mode = MXU_HOIST if self.hoist else MXU
            else:
                self.mode = RASTER_HOIST if self.hoist else RASTER
            self.suffix = "_raster" + "_hoist" * self.hoist + "_mxu" * self.mxu
        planes, self.cam_meta, (self.p2, self.n) = raycast.ray_planes(config)
        self.planes = torch.from_numpy(planes).to(device)
        self.ray_abs = float(np.abs(planes[:2]).max())
        self.width = raycast.pooled_width(config)
        self.num_cams = len(self.cam_meta)
        self.frame_width = self.num_cams * 3 * self.n
        self.setup_width = self.num_cams * 2 * raycast.SETUP_W
        # The kernels read the static rows in their own order and layouts
        # (``planes`` serves the plain version); the raster ones a run table
        # too, K5d its A operands.
        self.order = raycast.slab_order(self.n, self.width)
        self.slab_rays = torch.from_numpy(np.ascontiguousarray(
            planes[..., self.order].transpose(1, 2, 3, 0))).to(device)
        self.slab_pixels = torch.from_numpy(slab_pixel_table(planes, self.order)).to(device)
        self.runs = self.mxu_frags = None
        if self.raster:
            self.runs = torch.from_numpy(raycast.run_rects(planes, self.order)).to(device)
        if self.mxu:
            self.mxu_frags = torch.from_numpy(mxu_fragment_table(planes, self.order)).to(device)

    def plain(self, scene: SceneParams, poses: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version: poses (R, E, 16) → uint8 (E, R, C·3·n)."""
        frames = [
            raycast.render_frames(scene, poses[r], self.planes, self.cam_meta, self.p2, self.n,
                                  raster=self.raster, recip=self.recip, hoist=self.hoist,
                                  mxu=self.mxu)
            for r in range(poses.shape[0])
        ]
        return torch.stack(frames, dim=1)

    def kernel_params(self, scene: SceneParams) -> RenderParams:
        """The kernel's parameter struct for ``scene``."""
        p = RenderParams()
        for c, ((fwd, right, up), eye) in enumerate(self.cam_meta):
            p.basis[c][:] = [*fwd, *right, *up]
            p.eye[c][:] = list(eye)
        p.he[0][:] = [float(v) for v in scene.cart_half_extents]
        p.he[1][:] = [float(v) for v in scene.pole_half_extents]
        p.light[:] = list(raycast.LIGHT_DIR)
        p.ambient = raycast._AMBIENT
        p.diffuse = 1.0 - raycast._AMBIENT
        p.inv_p2 = 1.0 / self.p2
        p.cart_color[:] = list(raycast.CART_COLOR)
        p.pole_color[:] = list(raycast.POLE_COLOR)
        p.sky_color[:] = list(raycast.SKY_COLOR)
        p.num_cams, p.p2, p.n = self.num_cams, self.p2, self.n
        p.ray_abs = self.ray_abs
        p.cull = 1
        return p

    def _launch(self, name: str, scene: SceneParams, poses: torch.Tensor) -> torch.Tensor:
        if poses.dtype != torch.float32 or poses.dim() != 3 or poses.shape[-1] != 16:
            raise ValueError(f"poses: expected float32 (R, E, 16), got {poses.dtype} "
                             f"{tuple(poses.shape)}")
        if poses.device != self.planes.device:
            raise ValueError(f"poses on {poses.device}, renderer on {self.planes.device}")
        r, e = poses.shape[0], poses.shape[1]
        if r == 0 or e == 0:
            raise ValueError("empty pose batch")
        params, poses = self.kernel_params(scene), poses.contiguous()
        setups = None
        if self.hoist:
            setups = torch.empty((r, e, self.setup_width), dtype=torch.float32,
                                 device=poses.device)
            self.launch_pack(params, poses, setups)
            kernels.LAUNCHES["pack_setups"] += 1
        out = torch.empty((e, r, self.frame_width), dtype=torch.uint8, device=poses.device)
        self.launch(params, poses, out, setups)
        kernels.LAUNCHES[name + self.suffix] += 1
        return out

    def launch_pack(self, params: RenderParams, poses: torch.Tensor,
                    setups: torch.Tensor) -> None:
        """Launch the setup pass of the hoisted raster on prepared CUDA
        buffers: contiguous float32 ``poses`` (R, E, 16) → float32
        ``setups`` (R, E, C·2·22), the layout of ``raycast.pack_setups``.
        Both 16-byte aligned (the kernel moves float4s).  Counts nothing:
        the wrappers count."""
        if poses.data_ptr() % 16 or setups.data_ptr() % 16:
            raise ValueError("pack_setups: poses and setups must be 16-byte aligned")
        r, e = poses.shape[0], poses.shape[1]
        err = kernels.library().cp_pack_setups(
            ctypes.addressof(params), poses.data_ptr(), setups.data_ptr(), e, r,
            torch.cuda.current_stream(poses.device).cuda_stream,
        )
        kernels.check(err, "pack_setups")

    def launch(self, params: RenderParams, poses: torch.Tensor, out: torch.Tensor,
               setups: torch.Tensor | None = None) -> None:
        """Launch the render kernel of this mode on prepared CUDA buffers:
        contiguous float32 ``poses`` (R, E, 16) → uint8 ``out``
        (E, R, C·3·n); the hoisted modes read ``setups`` (R, E, C·2·22)
        from :meth:`launch_pack` instead of computing the setup.  Every
        mode culls: ``params.ray_abs`` = inf turns the slab modes' cull off,
        ``params.cull`` = 0 the raster modes'.  Counts nothing: the wrappers
        count."""
        if self.hoist and setups is None:
            raise ValueError("the hoisted raster reads a setup table")
        r, e = poses.shape[0], poses.shape[1]
        reps, staged = slab_blocking(self.num_cams, self.n, r,
                                     RASTER_FRAME_BYTES if self.raster else SLAB_FRAME_BYTES)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = kernels.library().cp_render(
            ctypes.addressof(params), poses.data_ptr(), self.slab_rays.data_ptr(),
            ptr(setups if self.hoist else None), ptr(self.slab_pixels), ptr(self.runs),
            ptr(self.mxu_frags), out.data_ptr(), e, r, self.mode, reps, int(staged),
            torch.cuda.current_stream(poses.device).cuda_stream,
        )
        kernels.check(err, "render")

    def render_repeats(self, scene: SceneParams, poses: torch.Tensor) -> torch.Tensor:
        """K3's launch in this mode: every repeat's frame, poses (R, E, 16)
        → uint8 (E, R, C·3·n)."""
        if poses.device.type == "cpu":
            return self.plain(scene, poses)
        if poses.device.type != "cuda":
            raise ValueError(f"unsupported device {poses.device}")
        return self._launch("render_repeats", scene, poses)

    def render_batched(self, scene: SceneParams, rigid: RigidState) -> torch.Tensor:
        """K4's launch in this mode: one frame per env from its state →
        uint8 (E, C·3·n)."""
        poses = raycast.poses_from_rigid(rigid)[None]
        if poses.device.type == "cpu":
            return self.plain(scene, poses)[:, 0]
        if poses.device.type != "cuda":
            raise ValueError(f"unsupported device {poses.device}")
        return self._launch("render_batched", scene, poses)[:, 0]
