"""Render layer: the ray caster in its slab and raster modes (raycast.py,
plain PyTorch) and its CUDA kernel (cuda_render.py, csrc/render.cu)."""


def prefer_raster(num_cameras: int, obs_pool: int, obs_samples: int) -> bool:
    """Per-config cast mode, as in the JAX package: the projective raster
    for exact configs (``obs_samples == 0``), the slab cascade for sampled
    ones."""
    return obs_samples == 0
