"""Functional cartpole++ environment: reset and step on tensors.

Port of cartpoleplusplus_tpu.env.cartpole: the per-env ``reset``/``step``
over the AoS engine (physics/engine.py), which the gym env, the random
agent and the event log roll, and the batched ``reset_batched``/
``step_batched`` over the kernels' hooks.  Semantics:

  * reset: cart at origin, pole upright with a small random tilt, then a
    random planar push of ``initial_force`` N for ``initial_force_steps``
    substeps; the first frame is repeated over ``action_repeats``.
  * step: action → planar cart force held over ``action_repeats ×
    steps_per_repeat`` substeps, one frame per repeat.
  * termination: pole (x, y) beyond ``pos_threshold``, pole roll/pitch
    beyond ``angle_threshold``, or the episode length cap.
  * reward: +1 per surviving step, or a ``reward_calc`` shaped variant.

Randomness comes from an explicit ``torch.Generator``; both resets also
take pre-drawn ``theta``/``jitter`` so a test can feed the JAX and PyTorch
versions the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from cartpoleplusplus_tpu_torch.env.config import (
    DISCRETE_ACTIONS,
    REWARD_ACTION,
    REWARD_ANGLE,
    REWARD_ANGLE_ACTION,
    CartpoleConfig,
)
from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.physics import engine, math3d
from cartpoleplusplus_tpu_torch.physics.bodies import (
    POLE,
    RigidState,
    SceneParams,
    make_scene,
    rest_state,
)
from cartpoleplusplus_tpu_torch.physics.contacts import scene_consts

# Batched substepper (scene, rigid, force (E, 3), n) → rigid.
PhysicsFn = Callable[[SceneParams, RigidState, torch.Tensor, int], RigidState]
# Batched observation (scene, rigid[E]) → one frame per env (E, …).
ObserveFn = Callable[[SceneParams, RigidState], torch.Tensor]
# Simulate+observe over all repeats (scene, rigid, force) → (rigid, obs[E, R, …]).
SimFn = Callable[[SceneParams, RigidState, torch.Tensor], tuple]


@dataclasses.dataclass
class EnvState:
    """Env state: rigid bodies, step counter and done flag; batched (E, …)
    or, for the per-env ``reset``/``step``, one env (``steps``/``done`` of
    shape ())."""

    rigid: RigidState
    steps: torch.Tensor  # (E,) or () int32
    done: torch.Tensor  # (E,) or () bool


def scene_for(config: CartpoleConfig) -> SceneParams:
    """Scene constants matching the config's physics cadence."""
    return make_scene(dt=config.dt, solver_iterations=config.solver_iterations)


def observe_lowdim(scene: SceneParams, rigid: RigidState) -> torch.Tensor:
    """Low-dim frames (E, 2 bodies, 7) = pos(3) + quat(4) per body, cart
    first."""
    del scene
    return torch.cat([rigid.pos, rigid.quat], dim=-1)


def action_to_force(config: CartpoleConfig, action: torch.Tensor) -> torch.Tensor:
    """Batched actions → world-frame cart forces (E, 3).

    Discrete: index into the 5-way nop/±x/±y table × action_force.
    Continuous: clip (fx, fy) to [-1, 1] and scale.
    """
    if config.discrete_actions:
        table = torch.tensor(DISCRETE_ACTIONS, dtype=torch.float32, device=action.device)
        dir_xy = table[action.long()]
    else:
        dir_xy = torch.clamp(action.to(torch.float32).reshape(-1, 2), -1.0, 1.0)
    force_xy = config.action_force * dir_xy
    return torch.cat([force_xy, torch.zeros_like(force_xy[:, :1])], dim=-1)


def pole_roll_pitch(rigid: RigidState) -> tuple[torch.Tensor, torch.Tensor]:
    """Pole orientation as (roll, pitch) Euler angles."""
    q = rigid.quat[..., POLE, :]
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    return roll, pitch


def _violation(config: CartpoleConfig, rigid: RigidState) -> torch.Tensor:
    """True where the pole is out of position or orientation bounds."""
    px, py = rigid.pos[..., POLE, 0], rigid.pos[..., POLE, 1]
    roll, pitch = pole_roll_pitch(rigid)
    out_pos = (torch.abs(px) > config.pos_threshold) | (torch.abs(py) > config.pos_threshold)
    out_ang = (torch.abs(roll) > config.angle_threshold) | (
        torch.abs(pitch) > config.angle_threshold
    )
    return out_pos | out_ang


def _reward(
    config: CartpoleConfig, rigid: RigidState, action: torch.Tensor, violated: torch.Tensor
) -> torch.Tensor:
    """Per-step reward (E,) under ``config.reward_calc``; 0 on a violation."""
    base = torch.ones(violated.shape, dtype=torch.float32, device=violated.device)
    if config.reward_calc in (REWARD_ANGLE, REWARD_ANGLE_ACTION):
        tilt = math3d.quat_tilt_angle(rigid.quat[..., POLE, :])
        base = base * torch.clamp(torch.cos(tilt), min=0.0)
    if config.reward_calc in (REWARD_ACTION, REWARD_ANGLE_ACTION):
        if config.discrete_actions:
            mag = (action != 0).to(torch.float32)
        else:
            a = torch.clamp(action.to(torch.float32).reshape(-1, 2), -1.0, 1.0)
            mag = 0.5 * torch.sum(a * a, dim=-1)
        base = base - 0.1 * mag
    return torch.where(violated, torch.zeros_like(base), base)


def _draw(shape, generator, theta, jitter, device):
    """The reset's draws, ``jitter`` of ``shape + (2,)`` standard normals
    then ``theta`` of ``shape`` in [0, 2π), each from ``generator`` unless
    given."""
    if (theta is None or jitter is None) and generator is None:
        raise ValueError("a reset needs a generator or pre-drawn theta and jitter")
    if jitter is None:
        jitter = torch.randn(shape + (2,), generator=generator, device=device)
    if theta is None:
        theta = 2.0 * math.pi * torch.rand(shape, generator=generator, device=device)
    return (theta.to(device=device, dtype=torch.float32),
            jitter.to(device=device, dtype=torch.float32))


def _jittered_rest(config: CartpoleConfig, scene: SceneParams, theta: torch.Tensor,
                   jitter: torch.Tensor) -> tuple[RigidState, torch.Tensor]:
    """Rest states with the pole tilted by ``jitter`` (E, 2), and the reset
    pushes (E, 3) in directions ``theta`` (E,)."""
    rigid = rest_state(scene, theta.shape[0], theta.device)
    jit_ang = config.random_theta_jitter * jitter
    zero = torch.zeros_like(jit_ang[:, :1])
    axis = torch.cat([jit_ang, zero], dim=-1)
    angle = torch.linalg.norm(jit_ang, dim=-1) + 1e-12
    rigid.quat[:, POLE] = math3d.quat_from_axis_angle(axis, angle)
    push = config.initial_force * torch.stack(
        [torch.cos(theta), torch.sin(theta), torch.zeros_like(theta)], dim=-1
    )
    return rigid, push


def reset_batched(
    config: CartpoleConfig,
    scene: SceneParams,
    num_envs: int,
    physics_fn: PhysicsFn,
    observe_fn: ObserveFn,
    device,
    generator: Optional[torch.Generator] = None,
    theta: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
) -> tuple[EnvState, torch.Tensor]:
    """Batched reset → (EnvState[E], obs[E, repeats, …]).

    ``theta`` (E,): push directions in [0, 2π); ``jitter`` (E, 2): standard
    normal draws scaled by ``random_theta_jitter`` into the pole's tilt.
    Whichever is not given is drawn from ``generator``.
    """
    theta, jitter = _draw((num_envs,), generator, theta, jitter, device)
    rigid, push = _jittered_rest(config, scene, theta, jitter)
    rigid = physics_fn(scene, rigid, push, config.initial_force_steps)

    frame = observe_fn(scene, rigid)
    obs = frame[:, None].expand((num_envs, config.action_repeats) + frame.shape[1:])
    state = EnvState(
        rigid=rigid,
        steps=torch.zeros((num_envs,), dtype=torch.int32, device=device),
        done=torch.zeros((num_envs,), dtype=torch.bool, device=device),
    )
    return state, obs


def reset(
    config: CartpoleConfig,
    scene: SceneParams,
    generator: Optional[torch.Generator] = None,
    observe_fn: Optional[ObserveFn] = None,
    theta: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
    device=None,
) -> tuple[EnvState, torch.Tensor]:
    """Reset one env → (EnvState, obs (repeats, *frame)), the JAX ``reset``.

    The pole's jitter and the push direction are ``jitter`` (2,) and
    ``theta`` (), or drawn from ``generator`` in that order; the
    ``initial_force_steps`` push runs on the AoS engine.  ``observe_fn``
    (scene, rigid (N, …)) → (N, *frame) renders the frame, repeated over
    the repeats (default :func:`observe_lowdim`).  ``device``: CUDA unless
    the caller asks for the CPU (default: the generator's device, else
    CUDA).
    """
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    theta, jitter = _draw((), generator, theta, jitter, device)
    rigid, push = _jittered_rest(config, scene, theta[None], jitter[None])
    rigid = engine.step_substeps(scene, rigid, push, config.initial_force_steps)

    frame = (observe_fn or observe_lowdim)(scene, rigid)[0]
    obs = frame[None].expand((config.action_repeats,) + frame.shape)
    state = EnvState(
        rigid=rigid.map(lambda x: x[0]),
        steps=torch.zeros((), dtype=torch.int32, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
    )
    return state, obs


def step(
    config: CartpoleConfig,
    scene: SceneParams,
    state: EnvState,
    action: torch.Tensor,
    observe_fn: Optional[ObserveFn] = None,
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance one env → (EnvState, obs (repeats, *frame), reward (), done ()),
    the JAX ``step``.

    ``action_repeats`` repeats of ``steps_per_repeat`` AoS substeps under
    the action's force; the R post-repeat states go through one
    ``observe_fn`` call (scene, rigid (R, …)) → (R, *frame) (default
    :func:`observe_lowdim`).  Termination and reward are the batched ones
    applied to this env.
    """
    action = torch.as_tensor(action, device=state.steps.device)
    force = action_to_force(config, action[None])[0]
    rigid, rigids = state.rigid, []
    consts = scene_consts(scene, force.device)
    for _ in range(config.action_repeats):
        rigid = engine.step_substeps(scene, rigid, force, config.steps_per_repeat, consts)
        rigids.append(rigid)
    obs = (observe_fn or observe_lowdim)(scene, rigids[0].map(
        lambda *xs: torch.stack(xs), *rigids[1:]))

    steps = state.steps + 1
    one = rigid.map(lambda x: x[None])
    violated = _violation(config, one)[0]
    done = state.done | violated | (steps >= config.max_episode_len)
    reward = _reward(config, one, action[None], violated[None])[0]
    reward = torch.where(state.done, torch.zeros_like(reward), reward)
    return EnvState(rigid=rigid, steps=steps, done=done), obs, reward, done


def simulate_repeats(
    config: CartpoleConfig,
    scene: SceneParams,
    rigid: RigidState,
    force: torch.Tensor,
    physics_fn: PhysicsFn,
    observe_fn: ObserveFn,
) -> tuple[RigidState, torch.Tensor]:
    """The per-repeat composition of the JAX ``step_batched`` (its path
    without a ``sim_fn``): ``steps_per_repeat`` substeps by ``physics_fn``
    then one frame by ``observe_fn``, for each repeat →
    (rigid, obs[E, repeats, …])."""
    frames = []
    for _ in range(config.action_repeats):
        rigid = physics_fn(scene, rigid, force, config.steps_per_repeat)
        frames.append(observe_fn(scene, rigid))
    return rigid, torch.stack(frames, dim=1)


def step_batched(
    config: CartpoleConfig,
    scene: SceneParams,
    state: EnvState,
    action: torch.Tensor,
    sim_fn: SimFn,
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched step → (EnvState[E], obs[E, repeats, …], reward[E], done[E]).

    ``sim_fn`` runs every repeat's physics and frame (``make_venv`` wires
    one physics launch, and for pixel configs one render launch, per
    step).  The JAX version's per-repeat composition, which it runs when
    no ``sim_fn`` is given, is :func:`simulate_repeats`.
    """
    force = action_to_force(config, action)
    rigid, obs = sim_fn(scene, state.rigid, force)

    steps = state.steps + 1
    violated = _violation(config, rigid)
    timeout = steps >= config.max_episode_len
    done = state.done | violated | timeout
    reward = _reward(config, rigid, action, violated)
    reward = torch.where(state.done, torch.zeros_like(reward), reward)
    return EnvState(rigid=rigid, steps=steps, done=done), obs, reward, done
