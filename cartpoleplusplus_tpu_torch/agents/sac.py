"""SAC: port of cartpoleplusplus_tpu.agents.sac — the maximum-entropy agent
with a learned temperature on the same training segment as DDPG, and its
program: the JAX CLI (``add_sac_opts``), ``train`` with jsonl metrics,
periodic greedy evals and checkpoints (resume, ``--ckpt-best``,
``--ckpt-skip-replay``, ``--eval-only``), and ``main``::

    python -m cartpoleplusplus_tpu_torch.agents.sac --use-raw-pixels ...

The algorithm is the JAX package's: a tanh-squashed Gaussian policy
(:class:`GaussianActor`), twin Q critics with a soft target, the soft TD
target ``reward_scale·r + γ·(1 − terminal)·(min_k Q'_k(s2, a2) − α·log
π(a2|s2))`` with ``a2`` sampled fresh from the current policy, the actor
descending ``α·log π(ã|s) − min_k Q_k(s, ã)``, and α = exp(log α) trained
toward a target entropy (−2, the action dimension, by default) with an
optional floor (``--alpha-min``).  Exploration samples the policy itself;
there is no OU process.  The segment is ``agents/ddpg.py``'s: a Python loop
of PyTorch calls and kernel launches with host-side step counter, replay
cursor and train gate, each update inside a ``torch.profiler`` span named
``LEARNER_SPAN``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import sys
from typing import Optional, Sequence

import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.agents.ddpg import LearningRate, _step, adam, aug_random_shift
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole, resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import GaussianActor, TwinCritic
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.replay.buffer import ReplayState
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger
from cartpoleplusplus_tpu_torch.utils.optim import Adam, Schedule

LEARNER_SPAN = "sac.train_once"
METRIC_KEYS = ("critic_loss", "actor_loss", "alpha", "entropy")
# A data-parallel run's sharded fields and averaged metrics (the JAX
# SAC_SHARDED_FIELDS / SAC_METRIC_KEYS).
SHARDED_FIELDS = ("replay", "env_states", "obs")
RANK_METRIC_KEYS = (*METRIC_KEYS, "reward", "done_frac", "double_reset_frac")
_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


@dataclasses.dataclass
class SACState:
    """Everything the training loop carries.  The networks, ``log_alpha``
    (a 0-d float32 leaf that requires grad) and the optimizers are updated
    in place; ``env_steps`` is a host int."""

    actor: GaussianActor
    critic: TwinCritic
    target_critic: TwinCritic
    actor_opt: Adam
    critic_opt: Adam
    actor_sched: Optional[Schedule]
    critic_sched: Optional[Schedule]
    log_alpha: torch.Tensor
    alpha_opt: Adam
    replay: ReplayState
    env_states: EnvState
    obs: torch.Tensor        # (E, *obs_shape): the previous step's raw obs
    generator: torch.Generator
    env_steps: int = 0

    _NETS = ("actor", "critic", "target_critic")
    _OPTS = ("actor_opt", "critic_opt", "alpha_opt", "actor_sched", "critic_sched")

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, as tensors (live references) and
        host ints: the three networks', the optimizers' and schedules'
        ``state_dict``s, ``log_alpha`` and ``alpha_opt`` under the JAX
        checkpoint's names, the replay with its cursor and fill, the env
        states, ``obs``, the generator's state and ``env_steps``."""
        return {
            **{k: getattr(self, k).state_dict() for k in self._NETS},
            **{k: None if getattr(self, k) is None else getattr(self, k).state_dict()
               for k in self._OPTS},
            "log_alpha": self.log_alpha, **common.carried_state_dict(self),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents in place, onto this state's
        device."""
        for k in self._NETS:
            getattr(self, k).load_state_dict(sd[k])
        for k in self._OPTS:
            if getattr(self, k) is not None and sd[k] is not None:
                getattr(self, k).load_state_dict(sd[k])
        with torch.no_grad():
            self.log_alpha.copy_(sd["log_alpha"])
        common.load_carried_state(self, sd)


def sample_action(actor: GaussianActor, obs: torch.Tensor, eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """Reparameterised tanh-Gaussian sample → ``(action in [-1, 1]², log
    π(a|s))``, with ``u = mu + exp(log_std)·eps`` and the tanh correction
    by the stable identity ``log(1 − tanh(u)²) = 2·(log 2 − u −
    softplus(−2u))``.  The softplus is ``logaddexp(x, 0)``, as
    ``jax.nn.softplus`` computes it (``F.softplus`` switches to the identity
    above its threshold).  ``eps``: standard normals of the action's shape,
    drawn from ``generator`` when not given."""
    mu, log_std = actor(obs)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    eps = eps.to(mu.device)
    u = mu + torch.exp(log_std) * eps
    a = torch.tanh(u)
    logp = -0.5 * (eps ** 2 + 2.0 * log_std + _LOG_2PI).sum(-1)
    softplus = torch.logaddexp(-2.0 * u, torch.zeros_like(u))
    logp = logp - (2.0 * (_LOG_2 - u - softplus)).sum(-1)
    return a, logp


def greedy_act(actor: GaussianActor) -> common.GreedyPolicy:
    """obs (E, …) → greedy actions tanh(mu(obs)) (E, 2)."""
    return common.GreedyPolicy(actor, lambda net, obs: torch.tanh(net(obs)[0]))


def make_train_once(config, *, gamma: float, tau: float, target_entropy: float,
                    log_alpha_min: float | None = None, reward_scale: float = 1.0,
                    aug_shift: int = 0, grad_clip: float = 0.0, group=None):
    """One learner update → ``train_once(st, batch, eps_next=None,
    eps_new=None, aug_offsets=None) -> metrics``, device scalars
    ``critic_loss``, ``actor_loss``, ``alpha`` (after the update) and
    ``entropy`` (``−mean log π`` of the actor's fresh sample).

    In the JAX order: the soft TD target from a fresh sample at s2
    (``eps_next``) with α before this update; the twin critics' MSE and
    their Adam step; the actor's loss against the updated critics
    (``eps_new``) and its step; the temperature's loss ``−log α·mean(log π
    + target_entropy)``, its plain Adam step and the floor
    ``log_alpha_min``; the target critic's soft update by τ.  ``eps_next``,
    ``eps_new`` (standard normals of the action batch's shape) and
    ``aug_offsets`` (a pair of (B, 2), for s1 and s2) are the update's
    random draws, from ``st.generator`` when not given.  ``group``: the
    data-parallel process group whose ranks average the critic's, the
    actor's and the temperature's gradients before each step.
    """

    def train_once(st: SACState, batch, eps_next=None, eps_new=None, aug_offsets=None) -> dict:
        g = st.generator
        s1, a, r, s2, term = batch
        s1, s2 = replay_mod.decode_obs(s1), replay_mod.decode_obs(s2)
        if aug_shift > 0 and config.use_raw_pixels:
            h, w = config.obs_height, config.obs_width
            off1, off2 = aug_offsets if aug_offsets is not None else (None, None)
            s1 = aug_random_shift(s1, aug_shift, h, w, g, off1)
            s2 = aug_random_shift(s2, aug_shift, h, w, g, off2)
        alpha = torch.exp(st.log_alpha).detach()
        with torch.no_grad():
            a2, logp2 = sample_action(st.actor, s2, eps_next, g)
            q2 = torch.min(st.target_critic(s2, a2), dim=0).values
            y = reward_scale * r + gamma * (1.0 - term.to(torch.float32)) * (q2 - alpha * logp2)

        closs = torch.mean((st.critic(s1, a) - y) ** 2)
        st.critic_opt.zero_grad(set_to_none=True)
        closs.backward()
        _step(st.critic_opt, st.critic_sched, st.critic.parameters(), grad_clip, group)

        a_new, logp = sample_action(st.actor, s1, eps_new, g)
        q = torch.min(st.critic(s1, a_new), dim=0).values
        aloss = torch.mean(alpha * logp - q)
        st.actor_opt.zero_grad(set_to_none=True)
        actor_params = list(st.actor.parameters())
        aloss.backward(inputs=actor_params)
        _step(st.actor_opt, st.actor_sched, actor_params, grad_clip, group)

        logp = logp.detach()
        alpha_loss = -st.log_alpha * torch.mean(logp + target_entropy)
        st.alpha_opt.zero_grad(set_to_none=True)
        alpha_loss.backward()
        _step(st.alpha_opt, None, [st.log_alpha], 0.0, group)
        if log_alpha_min is not None:
            with torch.no_grad():
                st.log_alpha.clamp_(min=log_alpha_min)
        soft_target_update(st.target_critic, st.critic, tau)
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
                "alpha": torch.exp(st.log_alpha).detach(), "entropy": -torch.mean(logp)}

    return train_once


def make_segment(
    venv: VectorCartpole,
    *,
    gamma: float,
    tau: float,
    batch_size: int,
    warmup_steps: int,
    steps_per_segment: int,
    target_entropy: float,
    log_alpha_min: float | None = None,
    reward_scale: float = 1.0,
    aug_shift: int = 0,
    grad_clip: float = 0.0,
    group=None,
):
    """The K-step training segment: ``segment(st) -> metrics``, updating
    ``st`` in place, on ``ddpg.make_segment``'s skeleton: one reset pool
    per segment, the auto-reset obs substitution applied lazily, actions
    sampled from the policy, ``env_steps`` incremented before the train
    gate (``env_steps > warmup_steps`` and :func:`common.replay_min_fill`).

    ``metrics``: device scalars averaged over the segment's steps
    (:data:`METRIC_KEYS`, zero on steps without an update, so ``alpha``
    reads 0 before the gate opens; ``reward``, ``done_frac``,
    ``double_reset_frac``) and the host int ``updates``.  ``group``: as
    ``ddpg.make_segment`` takes it.
    """
    resolve_device(venv.device)
    config = venv.config
    train_once = make_train_once(
        config, gamma=gamma, tau=tau, target_entropy=target_entropy,
        log_alpha_min=log_alpha_min, reward_scale=reward_scale, aug_shift=aug_shift,
        grad_clip=grad_clip, group=group)
    e = venv.num_envs

    def segment(st: SACState) -> dict:
        g, dev = st.generator, venv.device
        reset_pool = venv.reset(g)
        reset_obs = reset_pool[1]
        min_fill = common.replay_min_fill(warmup_steps, e, st.replay.capacity)
        store = st.replay.s1.dtype
        zero = torch.zeros((), device=dev)
        sums = dict.fromkeys(METRIC_KEYS, zero)
        reward_sum, done_sum = zero, zero
        done_counts = torch.zeros((e,), device=dev)
        prev_done = torch.zeros((e,), dtype=torch.bool, device=dev)
        updates = 0
        for _ in range(steps_per_segment):
            with torch.no_grad():
                obs_in = resolve_obs(prev_done, reset_obs, st.obs)
                action, _ = sample_action(st.actor, obs_in, generator=g)
                env_states, obs2, reward, done = venv.step_lazy(st.env_states, action, reset_pool)
                s2 = None if st.replay.block else replay_mod.encode_obs(obs2, store)
                replay_mod.add_batch(st.replay, replay_mod.encode_obs(obs_in, store), action,
                                     reward, s2, done)
                st.env_states, st.obs = env_states, obs2
            st.env_steps += 1
            if st.env_steps > warmup_steps and st.replay.size >= min_fill:
                with torch.profiler.record_function(LEARNER_SPAN):
                    batch = replay_mod.sample(st.replay, batch_size, g)
                    m = train_once(st, batch)
                sums = {k: sums[k] + m[k] for k in METRIC_KEYS}
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
            **{name: v / k for name, v in sums.items()},
            "reward": reward_sum / k, "done_frac": done_sum / k,
            "double_reset_frac": torch.clamp(done_counts - 1.0, min=0.0).sum() / total,
            "updates": updates,
        }

    return segment


def init_state(opts, config, venv: VectorCartpole, actor_lr: LearningRate = 3e-4,
               critic_lr: LearningRate = 3e-4, alpha_lr: float = 3e-4,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1,
               pixel_encoder: str = "dense") -> SACState:
    """Fresh training state on ``venv``'s device: a :class:`GaussianActor`
    and a :class:`TwinCritic` initialised from ``opts.seed``, the target
    critic a copy, Adam for both networks (schedules from
    ``common.make_lr``), ``log_alpha`` = log(``opts.init_alpha``) in
    float32 with a plain Adam of ``alpha_lr``, and the replay and env reset
    exactly as ``ddpg.init_state`` builds them."""
    dev = venv.device
    init_gen = torch.Generator().manual_seed(opts.seed)
    kw = dict(use_raw_pixels=config.use_raw_pixels, height=config.obs_height,
              width=config.obs_width, hidden=tuple(hidden), pixel_pool=pixel_pool, device=dev,
              generator=init_gen, pixel_encoder=pixel_encoder)
    actor = GaussianActor(config.obs_shape, **kw)
    critic = TwinCritic(config.obs_shape, **kw)
    actor_opt, actor_sched = adam(actor, actor_lr)
    critic_opt, critic_sched = adam(critic, critic_lr)
    log_alpha = torch.log(torch.tensor(getattr(opts, "init_alpha", 0.1), dtype=torch.float32))
    log_alpha = log_alpha.to(dev).requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    env_states, obs = venv.reset(gen)
    obs_dtype = torch.uint8 if config.use_raw_pixels else torch.float32
    block = common.replay_block(opts, venv.num_envs)
    replay = replay_mod.create(
        common.shard_capacity(opts, block), config.obs_shape, (2,),
        obs_dtype=obs_dtype, block=block, device=dev)
    return SACState(
        actor=actor, critic=critic,
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=actor_opt, critic_opt=critic_opt,
        actor_sched=actor_sched, critic_sched=critic_sched,
        log_alpha=log_alpha, alpha_opt=Adam([log_alpha], lr=alpha_lr),
        replay=replay, env_states=env_states, obs=obs, generator=gen,
    )


def add_sac_opts(parser) -> None:
    """SAC's flags (the JAX ``add_sac_opts``: same names, defaults and
    choices)."""
    parser.add_argument("--actor-learning-rate", type=float, default=3e-4)
    parser.add_argument("--critic-learning-rate", type=float, default=3e-4)
    parser.add_argument("--alpha-learning-rate", type=float, default=3e-4)
    parser.add_argument("--init-alpha", type=float, default=0.1,
                        help="initial entropy temperature (learned from here toward "
                             "--target-entropy)")
    parser.add_argument("--target-entropy", type=float, default=None,
                        help="entropy target for the alpha update (default: -action_dim "
                             "= -2)")
    parser.add_argument("--alpha-min", type=float, default=0.0,
                        help="temperature floor: alpha is clamped above this after each "
                             "update (0 = off); keeps exploration from decaying to zero "
                             "late in training")
    parser.add_argument("--tau", type=float, default=0.005,
                        help="target critic soft-update rate")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--replay-capacity", type=int, default=100000)
    parser.add_argument("--warmup-steps", type=int, default=20,
                        help="env steps before training starts")
    parser.add_argument("--steps-per-segment", type=int, default=25,
                        help="env steps per training segment")
    parser.add_argument("--reward-scale", type=float, default=1.0,
                        help="scale rewards in the TD target")
    parser.add_argument("--grad-clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 = off)")
    parser.add_argument("--aug-shift", type=int, default=0,
                        help="pixel-only: DrQ random shift, edge-pad frames by N px and "
                             "crop at a random offset per replay sample")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks (one device each) to shard envs and replay over; "
                             "gradients are averaged across them")
    common.add_lr_schedule_opt(parser)


def train(opts, stop_at: int | None = None) -> float:
    """The JAX ``train`` over the port's pieces → the last eval's mean
    episode length; ``ddpg.train``'s shape with SAC's pieces.

    Builds the training and eval vector envs (on the card unless
    ``--device cpu``) and :func:`init_state`, restores the newest
    checkpoint of ``--ckpt-dir`` if there is one, then runs segments
    ``start .. --num-train-batches`` with their evals, metrics (SAC's
    :data:`METRIC_KEYS` among the JAX fields) and checkpoints
    (:func:`common.train_segments`).  ``--eval-only`` evaluates the
    restored policy instead.  ``stop_at`` (not a flag): end after that
    segment, the learning-rate schedules keeping ``--num-train-batches``'s
    length.

    ``--num-devices`` N > 1 and ``--coordinator/--num-processes/
    --process-id``: the data-parallel run of ``ddpg.train`` (the ranks'
    env and replay shards, the per-rank batch ``--batch-size // N``, the
    gradients and metrics averaged over the ranks, rank 0's eval)."""
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
                    alpha_lr=opts.alpha_learning_rate, hidden=opts.hidden,
                    pixel_pool=opts.pixel_pool, pixel_encoder=opts.pixel_encoder)
    common.shard_start(st, mesh, SHARDED_FIELDS)
    target_entropy = opts.target_entropy if opts.target_entropy is not None else -2.0
    log_alpha_min = math.log(opts.alpha_min) if opts.alpha_min > 0.0 else None
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
        target_entropy=target_entropy, log_alpha_min=log_alpha_min,
        reward_scale=opts.reward_scale, aug_shift=opts.aug_shift, grad_clip=opts.grad_clip,
        group=mesh and mesh.group)
    end = opts.num_train_batches if stop_at is None else min(stop_at, opts.num_train_batches)
    return common.train_segments(
        opts, st, common.distribute(segment, mesh, SHARDED_FIELDS, RANK_METRIC_KEYS), venv,
        eval_venv, act, logger, common.replay_fields(METRIC_KEYS), start_segment, end, mesh,
        SHARDED_FIELDS)


def make_parser():
    parser = common.make_parser("SAC agent on cartpole++ (PyTorch/CUDA port)")
    add_sac_opts(parser)
    return parser


def main(argv=None, stop_at: int | None = None) -> float:
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    return train(opts, stop_at=stop_at)


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports (as the JAX CLI does).
    from cartpoleplusplus_tpu_torch.agents.sac import main as _main

    _main()
