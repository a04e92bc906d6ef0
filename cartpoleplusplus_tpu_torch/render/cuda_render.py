"""Wrappers of the CUDA render kernel (csrc/render.cu): K3/K4 in the slab
mode, K5a in the raster mode.

Counterparts of cartpoleplusplus_tpu.render.pallas_kernel's
``make_render_repeats`` (K3) and ``make_render_batched`` (K4), in the slab
+ reciprocal mode of the sampled configs and the raster mode of the exact
ones.  For CUDA tensors they launch the kernel or raise; for CPU tensors
they run the plain PyTorch version in render/raycast.py.
"""

from __future__ import annotations

import ctypes

import torch

from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, SceneParams
from cartpoleplusplus_tpu_torch.render import raycast

MAX_CAMS = 2


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
    ]


class Renderer:
    """Renders a config's camera frames with the slab cascade or, with
    ``raster``, the projective raster (K5a).

    Holds the static ray table (4, C, p2, n) on ``device``.  Frames are
    uint8, plane-major per camera, ``n`` pooled pixels per plane.  Launches
    count under ``render_repeats``/``render_batched`` in the slab mode and
    under the same names with ``_raster`` in the raster mode.
    """

    def __init__(self, config, device, raster: bool = False):
        self.raster = bool(raster)
        self._suffix = "_raster" if self.raster else ""
        planes, self.cam_meta, (self.p2, self.n) = raycast.ray_planes(config)
        self.planes = torch.from_numpy(planes).to(device)
        self.num_cams = len(self.cam_meta)
        self.frame_width = self.num_cams * 3 * self.n

    def plain(self, scene: SceneParams, poses: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version: poses (R, E, 16) → uint8 (E, R, C·3·n)."""
        frames = [
            raycast.render_frames(scene, poses[r], self.planes, self.cam_meta, self.p2, self.n,
                                  raster=self.raster)
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
        out = torch.empty((e, r, self.frame_width), dtype=torch.uint8, device=poses.device)
        self.launch(self.kernel_params(scene), poses.contiguous(), out)
        kernels.LAUNCHES[name + self._suffix] += 1
        return out

    def launch(self, params: RenderParams, poses: torch.Tensor, out: torch.Tensor) -> None:
        """Launch the render kernel on prepared CUDA buffers: contiguous
        float32 ``poses`` (R, E, 16) → uint8 ``out`` (E, R, C·3·n).  Counts
        nothing: the wrappers count."""
        r, e = poses.shape[0], poses.shape[1]
        err = kernels.library().cp_render(
            ctypes.addressof(params), poses.data_ptr(), self.planes.data_ptr(),
            out.data_ptr(), e, r, int(self.raster),
            torch.cuda.current_stream(poses.device).cuda_stream,
        )
        kernels.check(err, "render")

    def render_repeats(self, scene: SceneParams, poses: torch.Tensor) -> torch.Tensor:
        """K3 (K5a when raster): every repeat's frame, poses (R, E, 16) →
        uint8 (E, R, C·3·n)."""
        if poses.device.type == "cpu":
            return self.plain(scene, poses)
        if poses.device.type != "cuda":
            raise ValueError(f"unsupported device {poses.device}")
        return self._launch("render_repeats", scene, poses)

    def render_batched(self, scene: SceneParams, rigid: RigidState) -> torch.Tensor:
        """K4 (K5a when raster): one frame per env from its state → uint8
        (E, C·3·n)."""
        poses = raycast.poses_from_rigid(rigid)[None]
        if poses.device.type == "cpu":
            return self.plain(scene, poses)[:, 0]
        if poses.device.type != "cuda":
            raise ValueError(f"unsupported device {poses.device}")
        return self._launch("render_batched", scene, poses)[:, 0]
