"""Gym-style stateful env: port of cartpoleplusplus_tpu.env.gym_env.

``Cartpole`` (alias ``BulletCartpole``) gives the functional per-env
``reset``/``step`` of env/cartpole.py the face third-party agents drive:
``reset() → obs``, ``step(a) → (obs, reward, done, info)`` with
``info["done_reason"]``, ``observation_space``/``action_space``, ``seed``
and ``render()``.  When ``gym`` imports, the class subclasses ``gym.Env``
and builds gym's spaces; otherwise light stand-ins keep the same
attributes.

Pixel observations come from :func:`pixel_observers`: the render kernels
through ``cuda_render.Renderer`` on the card (K4/K5a batched for the reset
frame, K3/K5a over the repeats of a step, each at one env), their plain
versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import NUM_DISCRETE_ACTIONS, CartpoleConfig
from cartpoleplusplus_tpu_torch.env.config import add_opts as add_opts  # re-export
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.physics.bodies import SceneParams
from cartpoleplusplus_tpu_torch.render import prefer_raster, raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer

try:  # gym is optional, as in the JAX package
    import gym as _gym
    from gym import spaces as _spaces

    _GymBase = _gym.Env
except Exception:
    _gym = None
    _spaces = None
    _GymBase = object


def pixel_observers(config, device, raster: Optional[bool] = None):
    """The per-env env's pixel observers for ``config`` on ``device`` →
    ``(reset_observe, step_observe)``, or ``(None, None)`` (low-dim poses)
    for a low-dim config.

    ``reset_observe(scene, rigid (N, …)) → (N, C·3·n)``: one frame per state
    (``Renderer.render_batched``: K4, or K5a batched).
    ``step_observe(scene, rigids (R, …)) → (R, C·3·n)``: one env's R repeat
    states in one launch (``Renderer.render_repeats`` at E = 1: K3, or K5a).
    ``raster``: the raster mode, or the slab one; None picks by
    :func:`prefer_raster`, as ``make_venv`` does.
    """
    if not config.use_raw_pixels:
        return None, None
    if raster is None:
        raster = prefer_raster(config.num_cameras, config.obs_pool, config.obs_samples)
    renderer = Renderer(config, device, raster=raster)

    def step_observe(scene, rigids):
        return renderer.render_repeats(scene, raycast.poses_from_rigid(rigids)[:, None])[0]

    return renderer.render_batched, step_observe


class _DiscreteSpace:
    def __init__(self, n):
        self.n = n
        self.shape = ()
        self.dtype = np.int32

    def sample(self, rng=np.random):
        return int(rng.randint(self.n))


class _BoxSpace:
    def __init__(self, low, high, shape):
        self.low, self.high, self.shape = low, high, shape
        self.dtype = np.float32

    def sample(self, rng=np.random):
        return rng.uniform(self.low, self.high, self.shape).astype(np.float32)


class Cartpole(_GymBase):
    """Stateful single env over the functional per-env step.

    * ``reset() → obs``: np.ndarray, (repeats, 2, 7) float32 low-dim or
      (repeats, C·3·H·W) uint8 pixels;
    * ``step(a) → (obs, reward, done, info)``, ``info["done_reason"]`` on
      the last step;
    * ``observation_space`` / ``action_space``.

    ``config``: a ``CartpoleConfig``, or an ``add_opts`` argparse
    namespace (``--continuous`` picks continuous actions).  ``seed`` seeds
    the generator every reset draws from.  ``device``: the card unless the
    caller passes ``"cpu"``; without a card it raises.  Pixel observations
    take the cast mode :func:`prefer_raster` picks for the config.
    """

    metadata = {"render.modes": ["rgb_array", "human"]}

    def __init__(self, config=None, scene: Optional[SceneParams] = None, observe_fn=None,
                 seed: int = 0, device=None):
        if config is not None and not isinstance(config, CartpoleConfig):
            config = config_from_opts(config,
                                      discrete_actions=not getattr(config, "continuous", False))
        self.config = config or CartpoleConfig()
        self.device = resolve_device(device)
        self.scene = scene if scene is not None else cartpole.scene_for(self.config)
        if observe_fn is not None:
            self._reset_observe = self._step_observe = observe_fn
        else:
            self._reset_observe, self._step_observe = pixel_observers(self.config, self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = None
        self._renderer = None  # built on the first render()
        self._render_cfg = None

        if self.config.use_raw_pixels:
            obs_lo, obs_hi, obs_dtype = 0, 255, np.uint8
        else:
            obs_lo, obs_hi, obs_dtype = -np.inf, np.inf, np.float32
        if _spaces is not None:
            if self.config.discrete_actions:
                self.action_space = _spaces.Discrete(NUM_DISCRETE_ACTIONS)
            else:
                self.action_space = _spaces.Box(-1.0, 1.0, shape=(2,), dtype=np.float32)
            self.observation_space = _spaces.Box(obs_lo, obs_hi, shape=self.config.obs_shape,
                                                 dtype=obs_dtype)
        else:
            if self.config.discrete_actions:
                self.action_space = _DiscreteSpace(NUM_DISCRETE_ACTIONS)
            else:
                self.action_space = _BoxSpace(-1.0, 1.0, (2,))
            self.observation_space = _BoxSpace(obs_lo, obs_hi, self.config.obs_shape)
            self.observation_space.dtype = obs_dtype

    def seed(self, seed: int):
        self._generator.manual_seed(seed)
        return [seed]

    def reset(self) -> np.ndarray:
        self._state, obs = cartpole.reset(self.config, self.scene, self._generator,
                                          self._reset_observe, device=self.device)
        return obs.cpu().numpy()

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        if self.config.discrete_actions:
            action = torch.tensor(int(action), dtype=torch.int64, device=self.device)
        else:
            action = torch.as_tensor(np.asarray(action, np.float32), device=self.device)
        self._state, obs, reward, done = cartpole.step(self.config, self.scene, self._state,
                                                       action, self._step_observe)
        done = bool(done)
        info = {}
        if done:
            timeout = int(self._state.steps) >= self.config.max_episode_len
            info["done_reason"] = "max_episode_len" if timeout else "out_of_bounds"
        return obs.cpu().numpy(), float(reward), done, info

    def render(self, mode="rgb_array"):
        """The current state seen by camera 0, unpooled at the render size
        → (H, W, 3) uint8, by the slab cast as in the JAX package: the
        render kernel K4 at one env on the card, its plain version on the
        CPU, whatever the observation.  ``mode="human"`` returns the same
        array (there is no window)."""
        if self._state is None:
            raise RuntimeError("call reset() before render()")
        if self._renderer is None:
            cfg = dataclasses.replace(self.config, use_raw_pixels=True, num_cameras=1,
                                      obs_pool=1, obs_samples=0)
            self._render_cfg = cfg
            self._renderer = Renderer(cfg, self.device)
        rigid = self._state.rigid.map(lambda x: x[None])
        frame = self._renderer.render_batched(self.scene, rigid)[0]
        return raycast.frame_to_images(self._render_cfg, frame)[0]


# The reference's class name, so ported scripts read naturally.
BulletCartpole = Cartpole
