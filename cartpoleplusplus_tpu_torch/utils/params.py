"""Parameter conversion from the JAX package's flax trees.

Takes plain numpy (a flax params tree converted with ``np.asarray``), so
neither the port nor the card needs flax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _linear(tree, prefix: str) -> dict[str, torch.Tensor]:
    """flax Dense {kernel (in, out), bias (out,)} → Linear {weight (out, in), bias}."""
    return {
        f"{prefix}.weight": torch.from_numpy(np.array(np.asarray(tree["kernel"], np.float32).T,
                                                       order="C")),
        f"{prefix}.bias": torch.from_numpy(np.asarray(tree["bias"], np.float32).copy()),
    }


def _encoder(enc, prefix: str) -> dict[str, torch.Tensor]:
    """flax ``ObsEncoder_0`` → ``{prefix}encoder.*``."""
    out = {}
    if "pixel_embed" in enc:
        out.update(_linear(enc["pixel_embed"], f"{prefix}encoder.pixel_embed"))
    trunk = enc["MLPTrunk_0"]
    for i in range(len(trunk)):
        out.update(_linear(trunk[f"hidden{i}"], f"{prefix}encoder.trunk.hidden.{i}"))
    return out


def actor_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``Actor`` params (with or without the top-level ``"params"``)
    → a state_dict for :class:`cartpoleplusplus_tpu_torch.models.networks.Actor`.

    Maps ``ObsEncoder_0/pixel_embed`` → ``encoder.pixel_embed``,
    ``ObsEncoder_0/MLPTrunk_0/hidden{i}`` → ``encoder.trunk.hidden.{i}`` and
    ``mu`` → ``mu``.
    """
    if "params" in tree:
        tree = tree["params"]
    return {**_encoder(tree["ObsEncoder_0"], ""), **_linear(tree["mu"], "mu")}


def _critic_tree(tree, prefix: str) -> dict[str, torch.Tensor]:
    return {**_encoder(tree["ObsEncoder_0"], prefix),
            **_linear(tree["MLPTrunk_0"]["hidden0"], f"{prefix}head.hidden.0"),
            **_linear(tree["q"], f"{prefix}q")}


def critic_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``Critic`` params (with or without the top-level ``"params"``)
    → a state_dict for :class:`~cartpoleplusplus_tpu_torch.models.networks.Critic`,
    or, for TD3's twin-stacked params (every leaf with a leading axis of
    2), for :class:`~cartpoleplusplus_tpu_torch.models.networks.TwinCritic`.

    Maps ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` does,
    ``MLPTrunk_0/hidden0`` (the layer after the action is joined) →
    ``head.hidden.0`` and ``q`` → ``q``.
    """
    if "params" in tree:
        tree = tree["params"]
    if np.ndim(tree["q"]["kernel"]) == 3:
        out = {}
        for i in range(2):
            out.update(_critic_tree(_index_tree(tree, i), f"critics.{i}."))
        return out
    return _critic_tree(tree, "")


def _index_tree(tree, i: int):
    """Leaf ``[i]`` of every array in a nested dict."""
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
