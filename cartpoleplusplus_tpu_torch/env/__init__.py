"""Environment layer: the functional cartpole++ env (per env and batched),
the vector env and the gym-style env."""

from cartpoleplusplus_tpu_torch.env.cartpole import (
    EnvState,
    action_to_force,
    observe_lowdim,
    reset,
    scene_for,
    step,
)
from cartpoleplusplus_tpu_torch.env.config import (
    DISCRETE_ACTIONS,
    NUM_DISCRETE_ACTIONS,
    CartpoleConfig,
    add_opts,
    config_from_opts,
)
from cartpoleplusplus_tpu_torch.env.gym_env import BulletCartpole, Cartpole
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole

__all__ = [
    "EnvState",
    "action_to_force",
    "observe_lowdim",
    "reset",
    "scene_for",
    "step",
    "DISCRETE_ACTIONS",
    "NUM_DISCRETE_ACTIONS",
    "CartpoleConfig",
    "add_opts",
    "config_from_opts",
    "BulletCartpole",
    "Cartpole",
    "VectorCartpole",
]
