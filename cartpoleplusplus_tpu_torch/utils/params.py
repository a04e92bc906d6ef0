"""Parameter conversion from the JAX package's flax trees.

Takes plain numpy (a flax params tree converted with ``np.asarray``), so
neither the port nor the card needs flax.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(tree, prefix: str) -> dict[str, torch.Tensor]:
    """flax Dense {kernel (in, out), bias (out,)} → Linear {weight (out, in), bias}."""
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(np.asarray(tree["kernel"], np.float32).T)),
        f"{prefix}.bias": torch.from_numpy(np.asarray(tree["bias"], np.float32).copy()),
    }


def actor_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``Actor`` params (with or without the top-level ``"params"``)
    → a state_dict for :class:`cartpoleplusplus_tpu_torch.models.networks.Actor`.

    Maps ``ObsEncoder_0/pixel_embed`` → ``encoder.pixel_embed``,
    ``ObsEncoder_0/MLPTrunk_0/hidden{i}`` → ``encoder.trunk.hidden.{i}`` and
    ``mu`` → ``mu``.
    """
    if "params" in tree:
        tree = tree["params"]
    enc = tree["ObsEncoder_0"]
    out = {}
    if "pixel_embed" in enc:
        out.update(_linear(enc["pixel_embed"], "encoder.pixel_embed"))
    trunk = enc["MLPTrunk_0"]
    for i in range(len(trunk)):
        out.update(_linear(trunk[f"hidden{i}"], f"encoder.trunk.hidden.{i}"))
    out.update(_linear(tree["mu"], "mu"))
    return out
