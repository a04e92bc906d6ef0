"""Camera model: a numpy copy of cartpoleplusplus_tpu.render.camera.

The renderer ray-casts, so a camera's job is to produce a static grid of
world-space rays, computed once on the host.  Copied rather than imported
because the JAX package's ``render`` package imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: eye/target/up + vertical FOV (degrees)."""

    eye: tuple[float, float, float]
    target: tuple[float, float, float]
    up: tuple[float, float, float] = (0.0, 0.0, 1.0)
    fov_deg: float = 50.0


# Two fixed views of the cart area, ~90° apart (reference uses 1 or 2 fixed
# cameras so the agent can resolve 3D motion; exact poses are not recoverable
# from the empty mount — these frame the cart/pole workspace equivalently).
DEFAULT_CAMERAS = (
    Camera(eye=(0.0, -2.4, 1.1), target=(0.0, 0.0, 0.4)),
    Camera(eye=(-2.4, 0.0, 1.1), target=(0.0, 0.0, 0.4)),
)


def ray_coords(camera: Camera, height: int, width: int):
    """Screen-affine ray parametrization: ``d(px, py) = fwd + px·right + py·up``.

    Returns ``(px, py, basis, eye)`` with ``px``/``py`` static (H·W,) float32
    screen coords (tan-scaled NDC, row-major, row 0 at the top), ``basis`` the
    ``(fwd, right, up)`` unit triples as python float tuples, and ``eye`` the
    float3 origin.  Generates the SAME rays as :func:`ray_grid` up to length
    normalization — which every consumer treats as irrelevant scale (depths
    are compared as ratios; see raycast._ray_obb_affine).  The affine form is
    the renderer's round-3 hot path: two static rows (px, py) replace three
    normalized direction rows, and the box-frame direction becomes
    ``A + B·px + C·py`` with per-env scalar coefficients.
    """
    gx, gy, (fwd, right, cam_up), eye = _basis_and_coords(
        camera, height, width
    )
    basis = (tuple(float(v) for v in fwd), tuple(float(v) for v in right),
             tuple(float(v) for v in cam_up))
    return (
        gx.astype(np.float32),
        gy.astype(np.float32),
        basis,
        tuple(float(v) for v in eye),
    )


def _basis_and_coords(camera: Camera, height: int, width: int):
    """Shared camera-basis derivation (the ONE owner of this math).

    Returns ``(px, py, (fwd, right, cam_up), eye)`` with ``px``/``py``
    float64 flattened tan-scaled screen coords and the basis rows float32
    (matching the historical per-function derivations bit-for-bit: the
    basis was always computed in f32, the screen coords in f64).
    """
    eye = np.asarray(camera.eye, np.float32)
    target = np.asarray(camera.target, np.float32)
    up = np.asarray(camera.up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(right, fwd)

    tan_half = np.tan(np.radians(camera.fov_deg) * 0.5)
    aspect = width / height
    ys = (1.0 - 2.0 * (np.arange(height) + 0.5) / height) * tan_half
    xs = (2.0 * (np.arange(width) + 0.5) / width - 1.0) * tan_half * aspect
    gx, gy = np.meshgrid(xs, ys)
    return gx.reshape(-1), gy.reshape(-1), (fwd, right, cam_up), eye


def ray_grid(camera: Camera, height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (H*W, 3) ray directions + (3,) origin, host-side numpy.

    Rays pass through pixel centers; the image is row-major with row 0 at the
    TOP of the image (matching PNG/Bullet conventions).  Derived from
    :func:`_basis_and_coords` (the one owner of the camera-basis math) by
    expanding the affine form ``d = fwd + px·right + py·up`` in float64 —
    the historical accumulation precision, so baked rays stay bit-identical
    to previously recorded goldens — and normalizing.
    """
    px, py, (fwd, right, cam_up), eye = _basis_and_coords(
        camera, height, width
    )
    dirs = (
        fwd[None]
        + px[:, None] * right[None]
        + py[:, None] * cam_up[None]
    )
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32), eye
