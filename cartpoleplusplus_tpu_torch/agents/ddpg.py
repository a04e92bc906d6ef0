"""DDPG: port of cartpoleplusplus_tpu.agents.ddpg — its acting, its fused
training segment (the TD3 stabilizers, prioritized replay and n-step
returns included) and its program: the JAX CLI (``add_ddpg_opts``),
``train`` with jsonl metrics, periodic greedy evals and checkpoints
(resume, ``--ckpt-best``, ``--ckpt-skip-replay``, ``--eval-only``), and
``main``::

    python -m cartpoleplusplus_tpu_torch.agents.ddpg --use-raw-pixels ...

Per env step the segment acts with µ(s) + OU noise, steps the env through
the kernels, writes the transition into the on-device replay and, once
the train gate is open, runs one update: critic MSE on
``reward_scale·r + γ·(1 − terminal)·Q'(s2, µ'(s2))``, actor ascent through
the critic, soft target updates.  With ``--use-batch-norm`` each forward
runs in the JAX update's mode: the critic's loss and the actor's own
forward in train mode (moving their running statistics), the critic under
the actor's loss, the targets and acting in eval mode.  The JAX version compiles the whole
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
import sys
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole, resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic, TwinCritic
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.replay.buffer import ReplayState
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger
from cartpoleplusplus_tpu_torch.utils.noise import ou_init, ou_step
from cartpoleplusplus_tpu_torch.utils.optim import Adam, Schedule

LearningRate = float | Callable[[int], float]
LEARNER_SPAN = "ddpg.train_once"
# The fields a data-parallel run splits over its ranks, and the metrics it
# averages (the JAX package's DDPG_SHARDED_FIELDS / DDPG_METRIC_KEYS).
SHARDED_FIELDS = distributed.DDPG_SHARDED_FIELDS
METRIC_KEYS = distributed.DDPG_METRIC_KEYS


@dataclasses.dataclass
class DDPGState:
    """Everything the training loop carries.  The networks and optimizers
    are updated in place; ``env_steps`` is a host int."""

    actor: Actor
    critic: Critic | TwinCritic
    target_actor: Actor
    target_critic: Critic | TwinCritic
    actor_opt: Adam
    critic_opt: Adam
    actor_sched: Optional[Schedule]
    critic_sched: Optional[Schedule]
    replay: ReplayState
    env_states: EnvState
    obs: torch.Tensor        # (E, *obs_shape): the previous step's raw obs
    ou_noise: torch.Tensor   # (E, 2)
    generator: torch.Generator
    env_steps: int = 0

    _NETS = ("actor", "critic", "target_actor", "target_critic")
    _OPTS = ("actor_opt", "critic_opt", "actor_sched", "critic_sched")

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, as tensors (live references) and
        host ints: the four networks', both optimizers' and schedules'
        ``state_dict``s, the replay with its cursor and fill, the env
        states, ``obs``, the OU noise, the generator's state and
        ``env_steps``."""
        return {
            **{k: getattr(self, k).state_dict() for k in self._NETS},
            **{k: None if getattr(self, k) is None else getattr(self, k).state_dict()
               for k in self._OPTS},
            **common.carried_state_dict(self), "ou_noise": self.ou_noise,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents in place, onto this state's
        device."""
        for k in self._NETS:
            getattr(self, k).load_state_dict(sd[k])
        for k in self._OPTS:
            if getattr(self, k) is not None and sd[k] is not None:
                getattr(self, k).load_state_dict(sd[k])
        common.load_carried_state(self, sd)
        self.ou_noise = sd["ou_noise"].to(self.obs.device)


def greedy_act(actor: Actor) -> common.GreedyPolicy:
    """obs (E, …) → greedy actions µ(obs) (E, 2), batch norm in eval mode.
    The JAX version takes ``(params, obs)``; here the parameters live in
    the module."""
    return common.GreedyPolicy(actor, lambda net, obs: net(obs))


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


def _step(opt, sched, params, grad_clip: float, group=None) -> None:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr)) on one network;
    with a process ``group`` the gradients are first averaged over its ranks
    (the JAX update's ``pmean`` before its optax chain)."""
    params = list(params)
    if group is not None:
        distributed.allreduce_mean_([p.grad for p in params], group)
    if grad_clip > 0:
        torch.nn.utils.clip_grad_norm_(params, grad_clip)
    opt.step()
    if sched is not None:
        sched.step()


def make_train_once(config, *, gamma: float, tau: float, warmup_steps: int,
                    reward_scale: float = 1.0, aug_shift: int = 0,
                    twin_critic: bool = False, policy_delay: int = 1,
                    target_noise: float = 0.0, target_noise_clip: float = 0.5,
                    grad_clip: float = 0.0, n_step: int = 1, group=None):
    """One learner update → ``train_once(st, batch, step, aug_offsets=None,
    target_eps=None, iw=None) -> (critic_loss, actor_loss)``, device
    scalars, or with ``iw`` ``(critic_loss, actor_loss, td_abs)``.

    ``batch``: ``(s1, action, reward, s2, terminal)`` as stored, or an
    n-step batch (n-step reward, any-terminal flag) bootstrapped with
    ``gamma ** n_step``; ``step``: the env-step counter after this step's
    increment (it drives ``policy_delay``).  ``aug_offsets`` (a pair of
    (B, 2), for s1 and s2) and ``target_eps`` (standard normals of the
    action batch's shape) are the update's random draws, from
    ``st.generator`` when not given.  ``iw``: prioritized replay's (B,)
    importance weights; the critic loss is then ``mean(iw·td²)`` and
    ``td_abs`` the (B,) |TD error| (twin: its mean over the two critics)
    for the priority write-back.  Gradients stay in each parameter's
    ``.grad`` until the next update.  ``group``: the data-parallel process
    group whose ranks average each gradient before its step (None on one
    device).
    """

    def train_once(st: DDPGState, batch, step: int, aug_offsets=None, target_eps=None,
                   iw=None):
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
            y = reward_scale * r + gamma ** n_step * (1.0 - term.to(torch.float32)) * q2

        # Twin: both critics regress the same target; the loss is the mean
        # over both axes, as in the JAX package.
        td = st.critic(s1, a, train=True) - y
        closs = torch.mean(td ** 2 if iw is None else iw * td ** 2)
        st.critic_opt.zero_grad(set_to_none=True)
        closs.backward()
        _step(st.critic_opt, st.critic_sched, st.critic.parameters(), grad_clip, group)

        if policy_delay > 1 and (step - warmup_steps - 1) % policy_delay != 0:
            aloss = torch.zeros((), device=closs.device)
        else:
            # The actor ascends Q1 of the updated critic, which runs in eval
            # mode on its just-updated statistics.
            mu = st.actor(s1, train=True)
            qa = st.critic.q1(s1, mu) if twin_critic else st.critic(s1, mu)
            aloss = -torch.mean(qa)
            st.actor_opt.zero_grad(set_to_none=True)
            actor_params = list(st.actor.parameters())
            aloss.backward(inputs=actor_params)
            _step(st.actor_opt, st.actor_sched, actor_params, grad_clip, group)
            soft_target_update(st.target_actor, st.actor, tau)
            soft_target_update(st.target_critic, st.critic, tau)
        losses = (closs.detach(), aloss.detach())
        if iw is None:
            return losses
        td_abs = td.detach().abs()
        return (*losses, td_abs.mean(dim=0) if twin_critic else td_abs)

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
    per_alpha: float | None = None,
    per_beta0: float = 0.4,
    per_total_steps: int = 1,
    per_eps: float = 1e-2,
    n_step: int = 1,
    group=None,
):
    """The K-step training segment: ``segment(st) -> metrics``, updating
    ``st`` in place; with ``group`` one rank's segment of a data-parallel
    run (its gradients averaged over the group's ranks, its metrics its
    own: ``parallel.make_distributed`` averages them).

    Per segment one reset pool is drawn; per step the auto-reset obs
    substitution is applied lazily where the obs is consumed (actor input,
    replay s1) and materialized once at the segment's end; OU noise resets
    where an episode ended; ``env_steps`` is incremented before the train
    gate, which opens once ``env_steps > warmup_steps`` and the replay
    holds :func:`common.replay_min_fill` transitions.  ``per_alpha`` (None
    = uniform) samples by priority (:func:`replay_mod.sample_prioritized`)
    with the importance exponent annealed from ``per_beta0`` to 1 over
    ``per_total_steps`` env steps, and writes each update's ``|TD| +
    per_eps`` back; ``n_step`` > 1 trains on n-step returns.

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
        target_noise=target_noise, target_noise_clip=target_noise_clip, grad_clip=grad_clip,
        n_step=n_step, group=group)
    e = venv.num_envs

    def segment(st: DDPGState) -> dict:
        g, dev = st.generator, venv.device
        reset_pool = venv.reset(g)
        reset_obs = reset_pool[1]
        min_fill = common.replay_min_fill(warmup_steps, e, st.replay.capacity, n_step)
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
                    if per_alpha is None:
                        batch = replay_mod.sample(st.replay, batch_size, g, n_step=n_step,
                                                  gamma=gamma)
                        closs, aloss = train_once(st, batch, st.env_steps)
                    else:
                        beta = per_beta0 + (1.0 - per_beta0) * min(
                            max(st.env_steps / per_total_steps, 0.0), 1.0)
                        batch, idx, iw = replay_mod.sample_prioritized(
                            st.replay, batch_size, per_alpha, beta, n_step=n_step, gamma=gamma,
                            generator=g)
                        closs, aloss, td_abs = train_once(st, batch, st.env_steps, iw=iw)
                        replay_mod.update_priorities(st.replay, idx, td_abs, per_eps)
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
    """optax.adam on the module's parameters: the port's :class:`Adam`
    (torch's Adam at its defaults, outside ``torch.optim``); a schedule
    from ``common.make_lr`` becomes a :class:`Schedule` stepped after every
    update."""
    if not callable(lr):
        return Adam(module.parameters(), lr=lr), None
    opt = Adam(module.parameters(), lr=1.0)
    return opt, Schedule(opt, lr)


def init_state(opts, config, venv: VectorCartpole, actor_lr: LearningRate = 1e-4,
               critic_lr: LearningRate = 1e-3,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1,
               pixel_encoder: str = "dense") -> DDPGState:
    """Fresh training state on ``venv``'s device: networks initialised from
    ``opts.seed`` (twin critics with ``opts.twin_critic``, batch norm with
    ``opts.use_batch_norm``; pixel encoders of kind ``pixel_encoder``,
    average-pooling their frames ``pixel_pool``×``pixel_pool``), targets as
    copies, Adam optimizers, an
    empty replay of ``opts.replay_capacity`` (uint8 frames for pixel
    configs; s2-free when it holds two blocks, and then trimmed to a
    multiple of the env count, :func:`common.replay_capacity`; with
    ``opts.num_devices`` > 1 a job-global replay of per-shard blocks,
    :func:`common.shard_capacity`) and the env reset from a device
    generator seeded with ``opts.seed``; the replay keeps priorities with
    ``opts.per``."""
    dev = venv.device
    init_gen = torch.Generator().manual_seed(opts.seed)
    kw = dict(use_raw_pixels=config.use_raw_pixels, height=config.obs_height,
              width=config.obs_width, hidden=tuple(hidden), pixel_pool=pixel_pool, device=dev,
              generator=init_gen, pixel_encoder=pixel_encoder,
              use_batch_norm=getattr(opts, "use_batch_norm", False))
    actor = Actor(config.obs_shape, **kw)
    critic = (TwinCritic if getattr(opts, "twin_critic", False) else Critic)(
        config.obs_shape, **kw)
    actor_opt, actor_sched = adam(actor, actor_lr)
    critic_opt, critic_sched = adam(critic, critic_lr)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    env_states, obs = venv.reset(gen)
    obs_dtype = torch.uint8 if config.use_raw_pixels else torch.float32
    block = common.replay_block(opts, venv.num_envs)
    replay = replay_mod.create(
        common.shard_capacity(opts, block), config.obs_shape, (2,),
        obs_dtype=obs_dtype, block=block, device=dev, prioritized=getattr(opts, "per", False))
    return DDPGState(
        actor=actor, critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=actor_opt, critic_opt=critic_opt,
        actor_sched=actor_sched, critic_sched=critic_sched,
        replay=replay, env_states=env_states, obs=obs,
        ou_noise=ou_init((venv.num_envs, 2), device=dev), generator=gen,
    )


def add_ddpg_opts(parser) -> None:
    """DDPG's flags (the JAX ``add_ddpg_opts``: same names, defaults and
    choices)."""
    common.add_per_opts(parser)
    parser.add_argument("--actor-learning-rate", type=float, default=1e-4)
    parser.add_argument("--critic-learning-rate", type=float, default=1e-3)
    parser.add_argument("--tau", type=float, default=0.005, help="target soft-update rate")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--replay-capacity", type=int, default=100000)
    parser.add_argument("--warmup-steps", type=int, default=20,
                        help="env steps before training starts")
    parser.add_argument("--steps-per-segment", type=int, default=25,
                        help="env steps per training segment")
    parser.add_argument("--ou-theta", type=float, default=0.15)
    parser.add_argument("--ou-sigma", type=float, default=0.2)
    common.add_ou_anneal_opts(parser)
    parser.add_argument("--use-batch-norm", action="store_true",
                        help="batch norm of the encoders' features (train mode in the "
                             "losses, eval mode for acting and the targets)")
    parser.add_argument("--reward-scale", type=float, default=1.0,
                        help="scale rewards in the TD target")
    parser.add_argument("--grad-clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 = off)")
    common.add_lr_schedule_opt(parser)
    parser.add_argument("--aug-shift", type=int, default=0,
                        help="pixel-only: DrQ random shift, edge-pad frames by N px "
                             "and crop at a random offset per replay sample")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks (one device each) to shard envs and replay over; "
                             "gradients are averaged across them")
    parser.add_argument("--twin-critic", action="store_true",
                        help="TD3 clipped double-Q: two critics, the TD target "
                             "bootstraps min(Q1', Q2')")
    parser.add_argument("--policy-delay", type=int, default=1,
                        help="update the actor and the targets every N critic updates")
    parser.add_argument("--target-noise", type=float, default=0.0,
                        help="target-policy smoothing: clipped N(0, sigma) on the "
                             "target action")
    parser.add_argument("--target-noise-clip", type=float, default=0.5)


def train(opts, stop_at: int | None = None) -> float:
    """The JAX ``train`` over the port's pieces → the last eval's mean
    episode length.

    Builds the training and eval vector envs (on the card unless
    ``--device cpu``), the networks and :func:`init_state`, restores the
    newest checkpoint of ``--ckpt-dir`` if there is one (and carries its
    segment count, so numbering stays monotonic), then runs segments
    ``start .. --num-train-batches`` with their evals, metrics and
    checkpoints (:func:`common.train_segments`).  ``--eval-only``
    evaluates the restored policy instead of training.  ``stop_at`` (not a
    flag): end after that segment, the learning-rate and PER schedules
    keeping ``--num-train-batches``'s length.  ``--per`` and
    ``--n-step`` select prioritized replay and n-step returns; an n-step
    run needs the s2-free replay with room for n + 1 blocks
    (:func:`common.check_nstep_capacity`).  The eval venv renders with the
    training venv's cast mode (the JAX CLI's eval venv takes the per-config
    pick whatever ``--render-raster`` says; the two agree unless that flag
    overrides the pick).

    ``--num-devices`` N > 1 (the JAX CLI's multi-device branch): this call
    starts the ranks (``parallel.launch``, which calls ``train`` on each)
    and returns rank 0's final eval.  Each rank holds ``--num-envs / N``
    envs and ``--replay-capacity / N`` rows, samples ``--batch-size // N``
    (at least 1), starts from its rows of the one-card run's reset, and
    averages its gradients and metrics over the ranks; rank 0 evaluates.
    ``--coordinator/--num-processes/--process-id`` spread the ranks over
    launchers (:func:`common.maybe_init_multihost`).  With
    ``--use-batch-norm`` each rank's running statistics move with its own
    batches and are never averaged, as chip 0's copy of the replicated
    statistics is the one the JAX package saves and evaluates: the
    checkpoints and the eval hold rank 0's."""
    mesh = common.maybe_init_multihost(opts)
    if common.launches_ranks(opts, mesh):
        return distributed.launch(opts, train, stop_at)
    dev = common.rank_device(opts, mesh)
    config = config_from_opts(opts, discrete_actions=False)
    raster = common.resolve_render_raster(config, opts)
    venv, init_venv = common.rank_venvs(config, opts, dev, raster, mesh)
    eval_venv = common.make_venv(config, opts.num_eval, device=dev, render_raster=raster)
    logger = MetricsLogger(opts.metrics_jsonl, tb_dir=opts.tb_dir)
    st = init_state(opts, config, init_venv,
                    actor_lr=common.make_lr(opts, opts.actor_learning_rate),
                    critic_lr=common.make_lr(opts, opts.critic_learning_rate),
                    hidden=opts.hidden, pixel_pool=opts.pixel_pool,
                    pixel_encoder=opts.pixel_encoder)
    common.shard_start(st, mesh, SHARDED_FIELDS)
    common.check_nstep_capacity(opts, st.replay)
    start_segment, restored = 0, None
    if opts.ckpt_dir:
        st, restored = common.restore_for_startup(opts, st, mesh)
        if restored is not None:
            start_segment = restored
            logger.log("restore", step=restored)
    act = greedy_act(st.actor)
    if opts.eval_only:
        return common.run_eval_only(opts, logger, restored, eval_venv, act)

    segment = make_segment(
        venv, gamma=opts.gamma, tau=opts.tau, batch_size=common.rank_batch(opts, mesh),
        warmup_steps=opts.warmup_steps, steps_per_segment=opts.steps_per_segment,
        ou_theta=opts.ou_theta, ou_sigma=opts.ou_sigma, ou_sigma_min=opts.ou_sigma_min,
        ou_decay_steps=opts.ou_decay_steps, reward_scale=opts.reward_scale,
        aug_shift=opts.aug_shift, twin_critic=opts.twin_critic,
        policy_delay=opts.policy_delay, target_noise=opts.target_noise,
        target_noise_clip=opts.target_noise_clip, grad_clip=opts.grad_clip,
        per_alpha=opts.per_alpha if opts.per else None, per_beta0=opts.per_beta0,
        per_eps=opts.per_eps, per_total_steps=opts.num_train_batches * opts.steps_per_segment,
        n_step=opts.n_step, group=mesh and mesh.group)
    end = opts.num_train_batches if stop_at is None else min(stop_at, opts.num_train_batches)
    return common.train_segments(opts, st, common.distribute(segment, mesh, SHARDED_FIELDS,
                                                             METRIC_KEYS),
                                 venv, eval_venv, act, logger,
                                 common.replay_fields(("critic_loss", "actor_loss")),
                                 start_segment, end, mesh, SHARDED_FIELDS)


def make_parser():
    parser = common.make_parser("DDPG agent on cartpole++ (PyTorch/CUDA port)")
    add_ddpg_opts(parser)
    return parser


def main(argv=None, stop_at: int | None = None) -> float:
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    return train(opts, stop_at=stop_at)


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports (as the JAX CLI does).
    from cartpoleplusplus_tpu_torch.agents.ddpg import main as _main

    _main()
