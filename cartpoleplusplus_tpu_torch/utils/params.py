"""Parameter conversion from the JAX package's flax trees, and the readers
of a JAX DDPG, SAC, PPO, LRPG, DQN or NAF checkpoint.

A flax variables dict (``{"params": …, "batch_stats": …}``) carries its
batch norm's running statistics in ``batch_stats``; they become the
encoder's ``batch_norm.mean``/``batch_norm.var`` buffers.

Takes plain numpy (a flax params tree converted with ``np.asarray``, or
read by :mod:`~cartpoleplusplus_tpu_torch.utils.flax_msgpack`), so neither
the port nor the card needs flax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from cartpoleplusplus_tpu_torch.utils import flax_msgpack


def _linear(tree, prefix: str) -> dict[str, torch.Tensor]:
    """flax Dense {kernel (in, out), bias (out,)} → Linear {weight (out, in), bias}."""
    return {
        f"{prefix}.weight": torch.from_numpy(np.array(np.asarray(tree["kernel"], np.float32).T,
                                                       order="C")),
        f"{prefix}.bias": torch.from_numpy(np.asarray(tree["bias"], np.float32).copy()),
    }


def _conv(tree, prefix: str) -> dict[str, torch.Tensor]:
    """flax Conv {kernel (H, W, in, out), bias (out,)} → Conv2d {weight
    (out, in, H, W), bias}."""
    kernel = np.asarray(tree["kernel"], np.float32).transpose(3, 2, 0, 1)
    return {
        f"{prefix}.weight": torch.from_numpy(np.array(kernel, order="C")),
        f"{prefix}.bias": torch.from_numpy(np.asarray(tree["bias"], np.float32).copy()),
    }


def _vector(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _variables(tree):
    """A flax params tree or variables dict → (params, batch_stats or None)."""
    if "params" in tree:
        return tree["params"], tree.get("batch_stats")
    return tree, None


def _encoder(enc, prefix: str, stats=None) -> dict[str, torch.Tensor]:
    """flax ``ObsEncoder_0`` params (and its ``batch_stats``, ``stats``) →
    ``{prefix}encoder.*``; ``BatchNorm_0``'s ``scale``/``bias`` and
    ``mean``/``var`` → ``encoder.batch_norm.{weight,bias,mean,var}``."""
    out = {}
    if "BatchNorm_0" in enc:
        bn = f"{prefix}encoder.batch_norm"
        out[f"{bn}.weight"] = _vector(enc["BatchNorm_0"]["scale"])
        out[f"{bn}.bias"] = _vector(enc["BatchNorm_0"]["bias"])
        if stats is not None:
            out[f"{bn}.mean"] = _vector(stats["BatchNorm_0"]["mean"])
            out[f"{bn}.var"] = _vector(stats["BatchNorm_0"]["var"])
    if "pixel_embed" in enc:
        out.update(_linear(enc["pixel_embed"], f"{prefix}encoder.pixel_embed"))
    if "ConvTrunk_0" in enc:
        convs = enc["ConvTrunk_0"]
        for i in range(len(convs)):
            out.update(_conv(convs[f"conv{i}"], f"{prefix}encoder.conv_trunk.convs.{i}"))
    trunk = enc["MLPTrunk_0"]
    for i in range(len(trunk)):
        out.update(_linear(trunk[f"hidden{i}"], f"{prefix}encoder.trunk.hidden.{i}"))
    return out


def _encoder_and_heads(tree, *heads: str) -> dict[str, torch.Tensor]:
    """flax params of an ``ObsEncoder_0`` and Dense heads (or a variables
    dict, whose ``batch_stats`` are read too) → a state_dict of
    ``encoder.*`` and the heads under their flax names."""
    tree, stats = _variables(tree)
    out = _encoder(tree["ObsEncoder_0"], "", None if stats is None else stats["ObsEncoder_0"])
    for head in heads:
        out.update(_linear(tree[head], head))
    return out


def actor_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``Actor`` params (with or without the top-level ``"params"``)
    → a state_dict for :class:`cartpoleplusplus_tpu_torch.models.networks.Actor`.

    Maps ``ObsEncoder_0/pixel_embed`` → ``encoder.pixel_embed`` (dense
    pixel encoder), ``ObsEncoder_0/ConvTrunk_0/conv{i}`` →
    ``encoder.conv_trunk.convs.{i}`` (conv pixel encoder; HWIO kernels become
    OIHW), ``ObsEncoder_0/MLPTrunk_0/hidden{i}`` →
    ``encoder.trunk.hidden.{i}`` and ``mu`` → ``mu``; with batch norm,
    ``ObsEncoder_0/BatchNorm_0`` → ``encoder.batch_norm`` (its running
    statistics from a variables dict's ``batch_stats``).
    """
    return _encoder_and_heads(tree, "mu")


def gaussian_actor_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``GaussianActor`` params → a state_dict for
    :class:`~cartpoleplusplus_tpu_torch.models.networks.GaussianActor`:
    ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` maps it, and the
    heads ``mu`` and ``log_std``."""
    return _encoder_and_heads(tree, "mu", "log_std")


def value_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``ValueNetwork`` params → a state_dict for
    :class:`~cartpoleplusplus_tpu_torch.models.networks.ValueNetwork`:
    ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` maps it, and the
    head ``v``."""
    return _encoder_and_heads(tree, "v")


def discrete_policy_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``DiscretePolicy`` params → a state_dict for
    :class:`~cartpoleplusplus_tpu_torch.models.networks.DiscretePolicy`:
    ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` maps it, and the
    head ``logits``."""
    return _encoder_and_heads(tree, "logits")


def naf_network_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``NAFNetwork`` params or variables → a state_dict for
    :class:`~cartpoleplusplus_tpu_torch.models.networks.NAFNetwork`:
    ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` maps it (batch
    norm included), and the heads ``value``, ``mu`` and ``l_entries``."""
    return _encoder_and_heads(tree, "value", "mu", "l_entries")


def q_network_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``QNetwork`` params (with or without the top-level ``"params"``)
    → a state_dict for
    :class:`~cartpoleplusplus_tpu_torch.models.networks.QNetwork`:
    ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` maps it, and each
    head present (``q``, ``value``, ``advantage``) under its flax name;
    a NoisyNet head's ``kernel_sigma``/``bias_sigma`` become
    ``weight_sigma`` (transposed) and ``bias_sigma``."""
    if "params" in tree:
        tree = tree["params"]
    out = _encoder(tree["ObsEncoder_0"], "")
    for head in ("q", "value", "advantage"):
        if head not in tree:
            continue
        out.update(_linear(tree[head], head))
        if "kernel_sigma" in tree[head]:
            sigma = {"kernel": tree[head]["kernel_sigma"], "bias": tree[head]["bias_sigma"]}
            for k, v in _linear(sigma, head).items():
                out[k.replace(".weight", ".weight_sigma").replace(".bias", ".bias_sigma")] = v
    return out


def _critic_tree(tree, prefix: str, stats=None) -> dict[str, torch.Tensor]:
    enc_stats = None if stats is None else stats["ObsEncoder_0"]
    return {**_encoder(tree["ObsEncoder_0"], prefix, enc_stats),
            **_linear(tree["MLPTrunk_0"]["hidden0"], f"{prefix}head.hidden.0"),
            **_linear(tree["q"], f"{prefix}q")}


def critic_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ``Critic`` params (with or without the top-level ``"params"``)
    → a state_dict for :class:`~cartpoleplusplus_tpu_torch.models.networks.Critic`,
    or, for TD3's twin-stacked params (every leaf with a leading axis of
    2), for :class:`~cartpoleplusplus_tpu_torch.models.networks.TwinCritic`.

    Maps ``ObsEncoder_0/…`` as :func:`actor_params_from_flax` does (a
    variables dict's ``batch_stats`` too, stacked as the params are),
    ``MLPTrunk_0/hidden0`` (the layer after the action is joined) →
    ``head.hidden.0`` and ``q`` → ``q``.
    """
    tree, stats = _variables(tree)
    if np.ndim(tree["q"]["kernel"]) == 3:
        out = {}
        for i in range(2):
            out.update(_critic_tree(_index_tree(tree, i), f"critics.{i}.",
                                    None if stats is None else _index_tree(stats, i)))
        return out
    return _critic_tree(tree, "", stats)


def _index_tree(tree, i: int):
    """Leaf ``[i]`` of every array in a nested dict."""
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _env(raw) -> dict:
    """The env states and observations a JAX training state carries, as CPU
    tensors."""
    env = raw["env_states"]
    tensor = lambda a: torch.from_numpy(np.array(a))
    return {
        "env_states": {**{k: tensor(v) for k, v in env["rigid"].items()},
                       "steps": tensor(env["steps"]), "done": tensor(env["done"])},
        "obs": tensor(raw["obs"]),
    }


def _carried(raw) -> dict:
    """The env states, observations and step counter a JAX off-policy
    training state carries, as CPU tensors and an int."""
    return {**_env(raw), "env_steps": int(raw["env_steps"])}


def ddpg_params_from_jax_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX DDPG trainer (``ckpt_<step>.msgpack``, flax
    msgpack of its ``DDPGState``) → the port's pieces, on the CPU:

    - ``actor``, ``critic``, ``target_actor``, ``target_critic``:
      ``state_dict``s for :class:`Actor` and :class:`Critic` (or
      :class:`TwinCritic`, for twin-stacked critic trees) built with the
      checkpoint's encoder, trunk widths and observation shape;
    - ``env_states``: ``{"pos", "quat", "vel", "ang"}`` (E, 2, ·) float32,
      ``"steps"`` (E,) int32 and ``"done"`` (E,) bool tensors;
    - ``obs``: the carried observations (E, *obs_shape) as stored (uint8
      frames for pixel runs);
    - ``env_steps``: the vectorized step counter, an int.

    With ``--use-batch-norm`` each network's ``batch_stats`` come with it
    (twin critics' stacked on axis 0, as their params).  Read with
    :mod:`~cartpoleplusplus_tpu_torch.utils.flax_msgpack`, so neither flax
    nor msgpack is needed.  The optimizer states, the replay and the RNG key
    are not carried over.
    """
    raw = flax_msgpack.load(path)
    return {
        "actor": actor_params_from_flax(raw["actor_params"]),
        "critic": critic_params_from_flax(raw["critic_params"]),
        "target_actor": actor_params_from_flax(raw["target_actor_params"]),
        "target_critic": critic_params_from_flax(raw["target_critic_params"]),
        **_carried(raw),
    }


def sac_params_from_jax_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX SAC trainer (flax msgpack of its
    ``SACState``) → the port's pieces, on the CPU: ``actor`` (a
    :class:`GaussianActor` state_dict), ``critic`` and ``target_critic``
    (:class:`TwinCritic` state_dicts, split from the stacked leading axis
    of 2), ``log_alpha`` (a 0-d float32 tensor), and ``env_states``,
    ``obs`` and ``env_steps`` as :func:`ddpg_params_from_jax_checkpoint`
    gives them.  The optimizer states, the replay and the RNG key are not
    carried over."""
    raw = flax_msgpack.load(path)
    return {
        "actor": gaussian_actor_params_from_flax(raw["actor_params"]),
        "critic": critic_params_from_flax(raw["critic_params"]),
        "target_critic": critic_params_from_flax(raw["target_critic_params"]),
        "log_alpha": torch.from_numpy(np.array(raw["log_alpha"], dtype=np.float32)),
        **_carried(raw),
    }


def ppo_params_from_jax_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX PPO trainer (flax msgpack of its
    ``PPOState``, whose ``params`` are ``{"actor", "value"}``) → the port's
    pieces, on the CPU: ``actor`` (a :class:`GaussianActor` state_dict),
    ``value`` (a :class:`ValueNetwork` state_dict), ``env_states`` and
    ``obs`` as :func:`ddpg_params_from_jax_checkpoint` gives them, and
    ``update``, the update counter, an int.  The optimizer state and the
    RNG key are not carried over."""
    raw = flax_msgpack.load(path)
    return {
        "actor": gaussian_actor_params_from_flax(raw["params"]["actor"]),
        "value": value_params_from_flax(raw["params"]["value"]),
        **_env(raw), "update": int(raw["update"]),
    }


def lrpg_params_from_jax_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX LRPG trainer (flax msgpack of its
    ``TrainState``) → ``policy`` (a :class:`DiscretePolicy` state_dict, on
    the CPU) and ``update``, an int.  The optimizer state and the RNG key
    are not carried over."""
    raw = flax_msgpack.load(path)
    return {"policy": discrete_policy_params_from_flax(raw["params"]),
            "update": int(raw["update"])}


def dqn_params_from_jax_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX DQN trainer (flax msgpack of its
    ``DQNState``) → the port's pieces, on the CPU: ``params`` and
    ``target_params`` (:class:`QNetwork` state_dicts), and ``env_states``,
    ``obs`` and ``env_steps`` as :func:`ddpg_params_from_jax_checkpoint`
    gives them.  The optimizer state, the replay (empty in a
    ``--ckpt-skip-replay`` file) and the RNG key are not carried over."""
    raw = flax_msgpack.load(path)
    return {"params": q_network_params_from_flax(raw["params"]),
            "target_params": q_network_params_from_flax(raw["target_params"]),
            **_carried(raw)}


def naf_params_from_jax_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX NAF trainer (flax msgpack of its
    ``NAFState``) → the port's pieces, on the CPU: ``net`` and
    ``target_net`` (:class:`NAFNetwork` state_dicts from its ``variables``
    and ``target_variables``, batch statistics included), and
    ``env_states``, ``obs`` and ``env_steps`` as
    :func:`ddpg_params_from_jax_checkpoint` gives them.  The optimizer
    state, the replay, the OU noise and the RNG key are not carried over."""
    raw = flax_msgpack.load(path)
    return {"net": naf_network_params_from_flax(raw["variables"]),
            "target_net": naf_network_params_from_flax(raw["target_variables"]),
            **_carried(raw)}


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict of arrays → ``{"a/b/c": array}`` by flax path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """Inverse of :func:`flatten_tree`."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
