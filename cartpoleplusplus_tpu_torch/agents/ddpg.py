"""DDPG: port of cartpoleplusplus_tpu.agents.ddpg's acting and its fused
training segment (uniform replay; the TD3 stabilizers included).

Per env step the segment acts with µ(s) + OU noise, steps the env through
the kernels, writes the transition into the on-device replay and, once
the train gate is open, runs one update: critic MSE on
``reward_scale·r + γ·(1 − terminal)·Q'(s2, µ'(s2))``, actor ascent through
the critic, soft target updates.  The JAX version compiles the whole
segment into one ``lax.scan``; here it is a Python loop of PyTorch calls
and kernel launches on the current stream.  The step counter, the replay
cursor and its fill level are host ints, so the train gate (a ``lax.cond``
in JAX) is a Python branch and the loop never waits for the card: losses
and metrics are summed on the device and read once per segment.  Each
update runs inside a ``torch.profiler.record_function`` span named
``LEARNER_SPAN``, so a profiler trace can tell the learner's device time
from the env's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole, resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic, TwinCritic
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.replay.buffer import ReplayState
from cartpoleplusplus_tpu_torch.utils.noise import ou_init, ou_step

LearningRate = float | Callable[[int], float]
LEARNER_SPAN = "ddpg.train_once"


@dataclasses.dataclass
class DDPGState:
    """Everything the training loop carries.  The networks and optimizers
    are updated in place; ``env_steps`` is a host int."""

    actor: Actor
    critic: Critic | TwinCritic
    target_actor: Actor
    target_critic: Critic | TwinCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    actor_sched: Optional[torch.optim.lr_scheduler.LambdaLR]
    critic_sched: Optional[torch.optim.lr_scheduler.LambdaLR]
    replay: ReplayState
    env_states: EnvState
    obs: torch.Tensor        # (E, *obs_shape): the previous step's raw obs
    ou_noise: torch.Tensor   # (E, 2)
    generator: torch.Generator
    env_steps: int = 0


def greedy_act(actor: Actor):
    """obs (E, …) → greedy actions µ(obs) (E, 2).  The JAX version takes
    ``(params, obs)``; here the parameters live in the module."""

    @torch.no_grad()
    def act(obs: torch.Tensor) -> torch.Tensor:
        return actor(obs)

    return act


def aug_random_shift(obs: torch.Tensor, pad: int, height: int, width: int,
                     generator: Optional[torch.Generator] = None,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DrQ random shift of a float (B, repeats, planes·H·W) batch: edge-pad
    every plane by ``pad`` and crop back at a per-sample offset, the same
    for all of a sample's planes.  ``offsets``: pre-drawn (B, 2) ints in
    [0, 2·pad] (row, column); drawn from ``generator`` when not given.

    The JAX version crops with two one-hot bf16 matmuls, which rounds the
    values to bf16; the encoder rounds them to bf16 anyway, so both feed
    the networks the same numbers.
    """
    b, r, f = obs.shape
    x = obs.reshape(b, r * (f // (height * width)), height, width)
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    if offsets is None:
        offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=generator, device=obs.device)
    offsets = offsets.to(obs.device)
    rows = offsets[:, 0, None] + torch.arange(height, device=obs.device)
    cols = offsets[:, 1, None] + torch.arange(width, device=obs.device)
    c = x.shape[1]
    x = torch.gather(x, 2, rows[:, None, :, None].expand(b, c, height, x.shape[3]))
    x = torch.gather(x, 3, cols[:, None, None, :].expand(b, c, height, width))
    return x.reshape(b, r, f)


def _step(opt, sched, params, grad_clip: float) -> None:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr)) on one network."""
    if grad_clip > 0:
        torch.nn.utils.clip_grad_norm_(params, grad_clip)
    opt.step()
    if sched is not None:
        sched.step()


def make_train_once(config, *, gamma: float, tau: float, warmup_steps: int,
                    reward_scale: float = 1.0, aug_shift: int = 0,
                    twin_critic: bool = False, policy_delay: int = 1,
                    target_noise: float = 0.0, target_noise_clip: float = 0.5,
                    grad_clip: float = 0.0):
    """One learner update → ``train_once(st, batch, step, aug_offsets=None,
    target_eps=None) -> (critic_loss, actor_loss)``, device scalars.

    ``batch``: ``(s1, action, reward, s2, terminal)`` as stored;
    ``step``: the env-step counter after this step's increment (it drives
    ``policy_delay``).  ``aug_offsets`` (a pair of (B, 2), for s1 and s2)
    and ``target_eps`` (standard normals of the action batch's shape) are
    the update's random draws, from ``st.generator`` when not given.
    Gradients stay in each parameter's ``.grad`` until the next update.
    """

    def train_once(st: DDPGState, batch, step: int, aug_offsets=None, target_eps=None):
        if twin_critic != isinstance(st.critic, TwinCritic):
            raise ValueError("twin_critic does not match the state's critic")
        g = st.generator
        s1, a, r, s2, term = batch
        s1, s2 = replay_mod.decode_obs(s1), replay_mod.decode_obs(s2)
        if aug_shift > 0 and config.use_raw_pixels:
            h, w = config.obs_height, config.obs_width
            off1, off2 = aug_offsets if aug_offsets is not None else (None, None)
            s1 = aug_random_shift(s1, aug_shift, h, w, g, off1)
            s2 = aug_random_shift(s2, aug_shift, h, w, g, off2)
        with torch.no_grad():
            a2 = st.target_actor(s2)
            if target_noise > 0.0:
                if target_eps is None:
                    target_eps = torch.randn(a2.shape, generator=g, device=a2.device)
                eps = torch.clamp(target_noise * target_eps.to(a2.device),
                                  -target_noise_clip, target_noise_clip)
                a2 = torch.clamp(a2 + eps, -1.0, 1.0)
            q2 = st.target_critic(s2, a2)
            if twin_critic:
                q2 = torch.min(q2, dim=0).values
            y = reward_scale * r + gamma * (1.0 - term.to(torch.float32)) * q2

        # Twin: both critics regress the same target; the loss is the mean
        # over both axes, as in the JAX package.
        q = st.critic(s1, a)
        closs = torch.mean((q - y) ** 2)
        st.critic_opt.zero_grad(set_to_none=True)
        closs.backward()
        _step(st.critic_opt, st.critic_sched, st.critic.parameters(), grad_clip)

        if policy_delay > 1 and (step - warmup_steps - 1) % policy_delay != 0:
            return closs.detach(), torch.zeros((), device=closs.device)
        # The actor ascends Q1 of the updated critic.
        mu = st.actor(s1)
        qa = st.critic.q1(s1, mu) if twin_critic else st.critic(s1, mu)
        aloss = -torch.mean(qa)
        st.actor_opt.zero_grad(set_to_none=True)
        actor_params = list(st.actor.parameters())
        aloss.backward(inputs=actor_params)
        _step(st.actor_opt, st.actor_sched, actor_params, grad_clip)
        soft_target_update(st.target_actor, st.actor, tau)
        soft_target_update(st.target_critic, st.critic, tau)
        return closs.detach(), aloss.detach()

    return train_once


def make_segment(
    venv: VectorCartpole,
    *,
    gamma: float,
    tau: float,
    batch_size: int,
    warmup_steps: int,
    steps_per_segment: int,
    ou_theta: float,
    ou_sigma: float,
    ou_sigma_min: float | None = None,
    ou_decay_steps: int = 0,
    reward_scale: float = 1.0,
    aug_shift: int = 0,
    twin_critic: bool = False,
    policy_delay: int = 1,
    target_noise: float = 0.0,
    target_noise_clip: float = 0.5,
    grad_clip: float = 0.0,
):
    """The K-step training segment: ``segment(st) -> metrics``, updating
    ``st`` in place.

    Per segment one reset pool is drawn; per step the auto-reset obs
    substitution is applied lazily where the obs is consumed (actor input,
    replay s1) and materialized once at the segment's end; OU noise resets
    where an episode ended; ``env_steps`` is incremented before the train
    gate, which opens once ``env_steps > warmup_steps`` and the replay
    holds :func:`common.replay_min_fill` transitions.

    ``metrics``: device scalars averaged over the segment's steps
    (``critic_loss``, ``actor_loss``, zero on steps without an update;
    ``reward``, ``done_frac``; ``double_reset_frac``, the share of resets
    that reused the pool's state for an env already reset in this
    segment) and the host int ``updates``.
    """
    resolve_device(venv.device)
    config = venv.config
    train_once = make_train_once(
        config, gamma=gamma, tau=tau, warmup_steps=warmup_steps, reward_scale=reward_scale,
        aug_shift=aug_shift, twin_critic=twin_critic, policy_delay=policy_delay,
        target_noise=target_noise, target_noise_clip=target_noise_clip, grad_clip=grad_clip)
    e = venv.num_envs

    def segment(st: DDPGState) -> dict:
        g, dev = st.generator, venv.device
        reset_pool = venv.reset(g)
        reset_obs = reset_pool[1]
        min_fill = common.replay_min_fill(warmup_steps, e, st.replay.capacity)
        store = st.replay.s1.dtype
        zero = torch.zeros((), device=dev)
        closs_sum, aloss_sum, reward_sum, done_sum = zero, zero, zero, zero
        done_counts = torch.zeros((e,), device=dev)
        prev_done = torch.zeros((e,), dtype=torch.bool, device=dev)
        updates = 0
        for _ in range(steps_per_segment):
            with torch.no_grad():
                obs_in = resolve_obs(prev_done, reset_obs, st.obs)
                sigma = common.ou_sigma_at(st.env_steps, ou_sigma, ou_sigma_min, ou_decay_steps)
                ou = ou_step(st.ou_noise, theta=ou_theta, sigma=sigma, generator=g)
                action = torch.clamp(st.actor(obs_in) + ou, -1.0, 1.0)
                env_states, obs2, reward, done = venv.step_lazy(st.env_states, action, reset_pool)
                s2 = None if st.replay.block else replay_mod.encode_obs(obs2, store)
                replay_mod.add_batch(st.replay, replay_mod.encode_obs(obs_in, store), action,
                                     reward, s2, done)
                st.ou_noise = torch.where(done[:, None], 0.0, ou)
                st.env_states, st.obs = env_states, obs2
            st.env_steps += 1
            if st.env_steps > warmup_steps and st.replay.size >= min_fill:
                with torch.profiler.record_function(LEARNER_SPAN):
                    batch = replay_mod.sample(st.replay, batch_size, g)
                    closs, aloss = train_once(st, batch, st.env_steps)
                closs_sum, aloss_sum = closs_sum + closs, aloss_sum + aloss
                updates += 1
            reward_sum = reward_sum + reward.mean()
            done_f = done.to(torch.float32)
            done_sum = done_sum + done_f.mean()
            done_counts += done_f
            prev_done = done
        with torch.no_grad():
            st.obs = resolve_obs(prev_done, reset_obs, st.obs)
        total = torch.clamp(done_counts.sum(), min=1.0)
        k = float(steps_per_segment)
        return {
            "critic_loss": closs_sum / k, "actor_loss": aloss_sum / k,
            "reward": reward_sum / k, "done_frac": done_sum / k,
            "double_reset_frac": torch.clamp(done_counts - 1.0, min=0.0).sum() / total,
            "updates": updates,
        }

    return segment


def adam(module: torch.nn.Module, lr: LearningRate):
    """optax.adam: torch's Adam at its defaults (β 0.9/0.999, ε 1e-8 outside
    the square root, bias correction); a schedule from ``common.make_lr``
    becomes a LambdaLR stepped after every update."""
    if not callable(lr):
        return torch.optim.Adam(module.parameters(), lr=lr), None
    opt = torch.optim.Adam(module.parameters(), lr=1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr)


def init_state(opts, config, venv: VectorCartpole, actor_lr: LearningRate = 1e-4,
               critic_lr: LearningRate = 1e-3,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1) -> DDPGState:
    """Fresh training state on ``venv``'s device: networks initialised from
    ``opts.seed`` (twin critics with ``opts.twin_critic``; pixel encoders
    average-pooling their frames ``pixel_pool``×``pixel_pool``), targets as
    copies, Adam optimizers, an empty replay of ``opts.replay_capacity``
    (uint8 frames for pixel configs; s2-free when it holds two blocks, and
    then it must be a multiple of the env count) and
    the env reset from a device generator seeded with ``opts.seed``."""
    dev = venv.device
    init_gen = torch.Generator().manual_seed(opts.seed)
    kw = dict(use_raw_pixels=config.use_raw_pixels, height=config.obs_height,
              width=config.obs_width, hidden=tuple(hidden), pixel_pool=pixel_pool, device=dev,
              generator=init_gen)
    actor = Actor(config.obs_shape, **kw)
    critic = (TwinCritic if getattr(opts, "twin_critic", False) else Critic)(
        config.obs_shape, **kw)
    actor_opt, actor_sched = adam(actor, actor_lr)
    critic_opt, critic_sched = adam(critic, critic_lr)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    env_states, obs = venv.reset(gen)
    obs_dtype = torch.uint8 if config.use_raw_pixels else torch.float32
    replay = replay_mod.create(
        opts.replay_capacity, config.obs_shape, (2,), obs_dtype=obs_dtype,
        block=common.replay_block(opts, venv.num_envs), device=dev)
    return DDPGState(
        actor=actor, critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=actor_opt, critic_opt=critic_opt,
        actor_sched=actor_sched, critic_sched=critic_sched,
        replay=replay, env_states=env_states, obs=obs,
        ou_noise=ou_init((venv.num_envs, 2), device=dev), generator=gen,
    )
