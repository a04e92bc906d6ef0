"""Wrappers of the CUDA render kernels (csrc/render.cu): K3/K4 in the slab
mode (which skips the box casts its cull rectangles rule out), K5a in the
raster mode, and the three other modes of the JAX render
kernel: K5b (division-free ratio slab), K5c (raster from a hoisted setup
table) and K5d (raster with its bound planes on the tensor cores).

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


SLAB_THREADS = 128  # the slab kernel's block (csrc/render.cu)
# Shared memory for a block's frames in the slab kernel: the default 48 KiB
# a block may use, less its setups and cull rectangles (SLAB_THREADS / 16
# repeats x MAX_CAMS cameras x 2 boxes x (15 + 4) floats); render.cu's
# SLAB_FRAME_BYTES.
SLAB_FRAME_BYTES = 48 * 1024 - SLAB_THREADS // 16 * MAX_CAMS * 2 * (15 + 4) * 4


def slab_blocking(num_cams: int, n: int, r: int) -> tuple[int, bool]:
    """The slab kernel's repeats per block and whether it stages them in
    shared memory, for ``r`` repeats of ``num_cams`` frames of ``n`` pooled
    pixels: as many repeats as 16 setup lanes per (repeat, camera) allow,
    cut to those whose frames fit in ``SLAB_FRAME_BYTES``; where one frame
    does not fit, the kernel writes its pixels straight to global memory."""
    reps = min(r, SLAB_THREADS // (16 * num_cams))
    frame_w = num_cams * 3 * n
    if frame_w > SLAB_FRAME_BYTES:
        return reps, False
    return min(reps, SLAB_FRAME_BYTES // frame_w), True


class Renderer:
    """Renders a config's camera frames in one of the render kernel's modes.

    ``raster=False``: the slab cascade, with a reciprocal (K3/K4) or, with
    ``recip=False``, the division-free ratio cascade (K5b).  ``raster``:
    the projective raster (K5a); with ``hoist`` its setup is packed by a
    kernel of its own first (K5c), with ``mxu`` its bound planes come from
    a tensor-core product (K5d); the two may be combined.  As in the JAX
    package, ``recip`` acts only in the slab mode, ``hoist`` and ``mxu``
    only in the raster mode.

    Holds the static ray table (4, C, p2, n) on ``device``.  Frames are
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
        if self.mode == SLAB:  # the slab kernel's own layouts of the static rows
            order = raycast.slab_order(self.n, self.width)
            self.slab_rays = torch.from_numpy(
                np.ascontiguousarray(planes[..., order].transpose(1, 2, 3, 0))).to(device)
            self.slab_pixels = torch.from_numpy(slab_pixel_table(planes, order)).to(device)

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
        Counts nothing: the wrappers count."""
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
        from :meth:`launch_pack` instead of computing the setup.  Counts
        nothing: the wrappers count."""
        if self.hoist and setups is None:
            raise ValueError("the hoisted raster reads a setup table")
        r, e = poses.shape[0], poses.shape[1]
        slab = self.mode == SLAB
        reps, staged = slab_blocking(self.num_cams, self.n, r) if slab else (0, False)
        err = kernels.library().cp_render(
            ctypes.addressof(params), poses.data_ptr(),
            (self.slab_rays if slab else self.planes).data_ptr(),
            setups.data_ptr() if self.hoist else None,
            self.slab_pixels.data_ptr() if slab else None, out.data_ptr(), e, r, self.mode,
            reps, int(staged), torch.cuda.current_stream(poses.device).cuda_stream,
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
