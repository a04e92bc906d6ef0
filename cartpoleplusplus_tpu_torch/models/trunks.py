"""Shared network trunks: port of cartpoleplusplus_tpu.models.trunks.

Dense and pixel layers compute in bfloat16 with float32 parameters, as the
flax modules do (``dtype``/``param_dtype`` split): inputs, weights and
biases are cast to bfloat16, the product is rounded to bfloat16, then the
bias is added in bfloat16.  Only the dense pixel encoder is ported; the
conv encoder and batch norm are not.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

DEFAULT_HIDDEN = (100, 50)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` semantics on a float32 ``nn.Linear``."""
    x = x.to(dtype)
    y = x @ layer.weight.to(dtype).t()
    return y + layer.bias.to(dtype)


def flatten_obs(obs: torch.Tensor) -> torch.Tensor:
    """(B, …) → (B, features)."""
    return obs.reshape(obs.shape[0], -1)


class MLPTrunk(nn.Module):
    """Hidden FC stack with ReLU; float32 out."""

    def __init__(self, in_features: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = (in_features, *hidden)
        self.hidden = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(hidden))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.hidden:
            x = torch.relu(dense(layer, x, self.dtype))
        return x.to(torch.float32)


class ObsEncoder(nn.Module):
    """Input processing: low-dim flatten, or the dense pixel embedding of
    the flat frame stack, then the MLP trunk.

    ``in_features``: flattened observation width (repeats × frame width).
    uint8 pixel observations are decoded to [0, 1] in ``dtype``.
    """

    def __init__(self, in_features: int, use_raw_pixels: bool = False,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_embed: int = 256,
                 pixel_pool: int = 1, height: int = 50, width: int = 50,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.use_raw_pixels = use_raw_pixels
        self.pixel_pool = pixel_pool
        self.height, self.width = height, width
        self.dtype = dtype
        trunk_in = in_features
        if use_raw_pixels:
            embed_in = in_features // (pixel_pool * pixel_pool)
            self.pixel_embed = nn.Linear(embed_in, pixel_embed)
            trunk_in = pixel_embed
        self.trunk = MLPTrunk(trunk_in, hidden, dtype)

    def _pool(self, obs: torch.Tensor) -> torch.Tensor:
        """k×k average-pool each (height, width) plane of the flat frames."""
        k, h, w = self.pixel_pool, self.height, self.width
        if h % k or w % k:
            raise ValueError(f"pixel_pool {k} must divide {h}x{w}")
        lead = obs.shape[:-1]
        if obs.shape[-1] % (h * w):
            raise ValueError(
                f"pixel_pool expects flat {h}x{w} planes, got frame width {obs.shape[-1]}"
            )
        planes = obs.shape[-1] // (h * w)
        x = obs.reshape(lead + (planes, h // k, k, w // k, k))
        return x.mean(dim=(-3, -1)).reshape(lead + (-1,))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        if self.use_raw_pixels:
            if obs.dtype == torch.uint8:
                scale = torch.tensor(1.0 / 255.0, dtype=self.dtype, device=obs.device)
                obs = obs.to(self.dtype) * scale
            if self.pixel_pool > 1:
                obs = self._pool(obs.to(self.dtype))
            x = flatten_obs(obs)
            x = torch.relu(dense(self.pixel_embed, x, self.dtype)).to(torch.float32)
        else:
            x = flatten_obs(obs)
        return self.trunk(x)
