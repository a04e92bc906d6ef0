"""Shared network trunks: port of cartpoleplusplus_tpu.models.trunks.

Dense and pixel layers compute in bfloat16 with float32 parameters, as the
flax modules do (``dtype``/``param_dtype`` split): inputs, weights and
biases are cast to bfloat16, the product is rounded to bfloat16, then the
bias is added in bfloat16.  Both pixel encoders are ported: the dense
embedding of the flat frames and the conv stack (``ConvTrunk``, flax
``SAME`` padding, NHWC flatten order).  Batch norm (``use_batch_norm``) is
flax ``nn.BatchNorm``'s: :class:`BatchNorm`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_HIDDEN = (100, 50)
CONV_FEATURES = (16, 32, 32)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` semantics on a float32 ``nn.Linear``."""
    x = x.to(dtype)
    y = x @ layer.weight.to(dtype).t()
    return y + layer.bias.to(dtype)


def flatten_obs(obs: torch.Tensor) -> torch.Tensor:
    """(B, …) → (B, features)."""
    return obs.reshape(obs.shape[0], -1)


def _frame_planes(obs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Flat frames (B, repeats, cams·3·H·W), plane-major per camera →
    (B, repeats·cams·3, H, W): the NCHW view of the stacked frames."""
    b, r, f = obs.shape
    return obs.reshape(b, r * (f // (height * width)), height, width)


def pixels_to_nhwc(obs: torch.Tensor, height: int = 50, width: int = 50) -> torch.Tensor:
    """Flat pixel obs (B, repeats, cams·H·W·3) → (B, H, W, repeats·cams·3),
    repeat and camera frames stacked in the channel axis (JAX
    ``pixels_to_nhwc``; the conv trunk reads the NCHW view of the same
    channels)."""
    return _frame_planes(obs, height, width).permute(0, 2, 3, 1)


def same_padding(size: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """flax ``padding="SAME"``: the output is ceil(size / stride) and the
    padding (total // 2, total − total // 2), so 25 pads 1/1 and 50 pads 0/1."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvTrunk(nn.Module):
    """Three 3×3 stride-2 convs with ReLU (``features`` (16, 32, 32)) at
    flax ``SAME`` padding, in ``dtype`` with float32 parameters; the output
    is flattened in NHWC order (as flax flattens) and returned in float32.

    Input: (B, channels, height, width).  The convs are ``F.conv2d``: the
    JAX convs are XLA's, outside any Pallas kernel.
    """

    def __init__(self, channels: int, height: int, width: int,
                 features: Sequence[int] = CONV_FEATURES, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = (channels, *features)
        self.convs = nn.ModuleList(nn.Conv2d(widths[i], widths[i + 1], 3, stride=2)
                                   for i in range(len(features)))
        self.pads = []
        for _ in features:
            (top, bottom), (left, right) = same_padding(height), same_padding(width)
            self.pads.append((left, right, top, bottom))
            height, width = -(-height // 2), -(-width // 2)
        self.out_features = height * width * widths[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv, pad in zip(self.convs, self.pads):
            x = F.conv2d(F.pad(x, pad), conv.weight.to(self.dtype), stride=2)
            x = torch.relu(x + conv.bias.to(self.dtype)[:, None, None])
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)


FLAX_BN_MOMENTUM = 0.99
FLAX_BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=not train, dtype=float32)``
    over the features of a (B, F) batch: parameters ``weight`` and ``bias``
    (flax ``scale`` and ``bias``, init 1 and 0), float32 buffers ``mean``
    and ``var`` (flax's ``batch_stats``, init 0 and 1).

    ``forward(x, train)``: in float32, ``(x − m)·rsqrt(v + FLAX_BN_EPS)·weight
    + bias``.  In train mode ``m`` and ``v`` are the batch's mean and biased
    variance, ``E[x²] − E[x]²`` clipped at 0 (flax's fast variance), the
    gradient flowing through both, and the buffers move in place to
    ``FLAX_BN_MOMENTUM·buffer + (1 − FLAX_BN_MOMENTUM)·batch stat``; in eval
    mode they are the buffers.  Not ``nn.BatchNorm1d``: its running variance is the
    unbiased one and it carries an int64 ``num_batches_tracked``, which the
    Polyak target update cannot average.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                for buf, stat in ((self.mean, mean), (self.var, var)):
                    buf.mul_(FLAX_BN_MOMENTUM).add_(stat, alpha=1.0 - FLAX_BN_MOMENTUM)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + FLAX_BN_EPS) * self.weight) + self.bias


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
    """Input processing: low-dim flatten, or a pixel encoder of the frame
    stack (``pixel_encoder`` "dense": one dense embedding of the flat
    frames; "conv": :class:`ConvTrunk` over the frames stacked in the
    channel axis), then with ``use_batch_norm`` a :class:`BatchNorm` of
    those features in float32, then the MLP trunk.  ``forward(obs,
    train=False)``: ``train`` selects the batch norm's mode, as flax's
    ``__call__(obs, train)`` does (``nn.Module.training`` is not read).

    ``in_features``: flattened observation width (repeats × frame width).
    uint8 pixel observations are decoded to [0, 1] in ``dtype``; either
    pixel encoder average-pools them ``pixel_pool``×``pixel_pool`` first.
    """

    def __init__(self, in_features: int, use_raw_pixels: bool = False,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_embed: int = 256,
                 pixel_pool: int = 1, height: int = 50, width: int = 50,
                 dtype: torch.dtype = torch.bfloat16, pixel_encoder: str = "dense",
                 use_batch_norm: bool = False):
        super().__init__()
        if pixel_encoder not in ("dense", "conv"):
            raise ValueError(f"pixel_encoder must be 'dense' or 'conv', got {pixel_encoder!r}")
        self.use_raw_pixels = use_raw_pixels
        self.pixel_encoder = pixel_encoder
        self.pixel_pool = pixel_pool
        self.height, self.width = height, width
        self.dtype = dtype
        trunk_in = in_features
        if use_raw_pixels and pixel_encoder == "conv":
            k = pixel_pool
            self.conv_trunk = ConvTrunk(in_features // (height * width), height // k,
                                        width // k, dtype=dtype)
            trunk_in = self.conv_trunk.out_features
        elif use_raw_pixels:
            embed_in = in_features // (pixel_pool * pixel_pool)
            self.pixel_embed = nn.Linear(embed_in, pixel_embed)
            trunk_in = pixel_embed
        self.batch_norm = BatchNorm(trunk_in) if use_batch_norm else None
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

    def forward(self, obs: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.use_raw_pixels:
            if obs.dtype == torch.uint8:
                scale = torch.tensor(1.0 / 255.0, dtype=self.dtype, device=obs.device)
                obs = obs.to(self.dtype) * scale
            if self.pixel_pool > 1:
                obs = self._pool(obs.to(self.dtype))
            if self.pixel_encoder == "conv":
                k = self.pixel_pool
                x = self.conv_trunk(_frame_planes(obs, self.height // k, self.width // k))
            else:
                x = flatten_obs(obs)
                x = torch.relu(dense(self.pixel_embed, x, self.dtype)).to(torch.float32)
        else:
            x = flatten_obs(obs)
        if self.batch_norm is not None:
            x = self.batch_norm(x, train)
        return self.trunk(x)
