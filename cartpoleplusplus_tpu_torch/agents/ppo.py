"""PPO: port of cartpoleplusplus_tpu.agents.ppo — the clipped-surrogate
on-policy actor-critic with continuous actions, and its program: the JAX
CLI (``add_ppo_opts``), ``train`` with jsonl metrics, periodic greedy
evals and checkpoints (resume, ``--ckpt-best``, ``--eval-only``), and
``main``::

    python -m cartpoleplusplus_tpu_torch.agents.ppo --rollout-steps 128 ...

One update, in the JAX order: a reset pool (K2, and K4 for pixel
configs), a rollout of ``--rollout-steps`` auto-resetting vectorized steps
under the current tanh-squashed Gaussian policy (K1, and K3), GAE(λ) over
the scaled rewards, advantages whitened over the whole batch, then
``--ppo-epochs`` × ``--ppo-minibatches`` clipped-surrogate steps of one
Adam over the actor and the value network together, behind one global-norm
gradient clip.  The JAX version compiles the update into one program; here
it is a Python loop of PyTorch calls and kernel launches, and its metrics
stay on the card until an eval reads them.  Every random draw of an update
(the reset pool's push directions and tilts, the rollout's normals, each
epoch's permutation) can be given as an argument, so a test can feed the
JAX version's.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional, Sequence

import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.agents.ddpg import LearningRate, _step, adam
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole, resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import GaussianActor, ValueNetwork
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger
from cartpoleplusplus_tpu_torch.utils.optim import Adam, Schedule

METRIC_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "clip_frac", "approx_kl",
               "mean_reward", "done_frac")
# The fields a data-parallel run splits over its ranks (the JAX
# PPO_SHARDED_FIELDS); every metric is averaged.
SHARDED_FIELDS = ("env_states", "obs")
_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


@dataclasses.dataclass
class PPOState:
    """Everything the training loop carries.  The networks and the one
    optimizer over both are updated in place; ``update`` is a host int."""

    actor: GaussianActor
    value: ValueNetwork
    opt: Adam
    sched: Optional[Schedule]
    env_states: EnvState
    obs: torch.Tensor        # (E, *obs_shape): the observation to act on next
    generator: torch.Generator
    update: int = 0

    _NETS = ("actor", "value")

    def parameters(self) -> list[torch.Tensor]:
        """The actor's parameters, then the value network's: the joint
        parameters of the optimizer and of the gradient clip."""
        return [*self.actor.parameters(), *self.value.parameters()]

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, under the JAX state's names where
        it has them: ``params`` (``actor``, ``value``), ``opt_state`` and
        the schedule's, the env states, ``obs``, the generator's state and
        ``update``.  No replay."""
        return {
            "params": {k: getattr(self, k).state_dict() for k in self._NETS},
            "opt_state": self.opt.state_dict(),
            "sched": None if self.sched is None else self.sched.state_dict(),
            **common.env_state_dict(self), "update": self.update,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents in place, onto this state's
        device."""
        for k in self._NETS:
            getattr(self, k).load_state_dict(sd["params"][k])
        self.opt.load_state_dict(sd["opt_state"])
        if self.sched is not None and sd["sched"] is not None:
            self.sched.load_state_dict(sd["sched"])
        common.load_env_state(self, sd)
        self.update = int(sd["update"])


def add_ppo_opts(parser) -> None:
    """PPO's flags (the JAX ``add_ppo_opts``: same names, defaults and
    choices)."""
    parser.add_argument("--rollout-steps", type=int, default=128,
                        help="vectorized env steps per update (T); the on-policy batch is "
                             "T × num-envs transitions")
    parser.add_argument("--ppo-epochs", type=int, default=4)
    parser.add_argument("--ppo-minibatches", type=int, default=4,
                        help="minibatches per epoch (must divide T × E)")
    parser.add_argument("--ppo-clip", type=float, default=0.2, help="importance-ratio clip ε")
    parser.add_argument("--gae-lambda", type=float, default=0.95)
    parser.add_argument("--entropy-coef", type=float, default=0.003,
                        help="entropy bonus weight (sample estimate −log π)")
    parser.add_argument("--value-coef", type=float, default=0.5)
    parser.add_argument("--reward-scale", type=float, default=1.0,
                        help="scale rewards before GAE (advantages are whitened, so this "
                             "mainly conditions the value regression)")
    parser.add_argument("--grad-clip", type=float, default=0.5,
                        help="global-norm gradient clip (0 = off)")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks (one device each) to shard envs over; gradients are "
                             "averaged across them")
    common.add_lr_schedule_opt(parser)


def tanh_gaussian_logp(mu: torch.Tensor, log_std: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """log π(tanh(u)|s) of a tanh-squashed Gaussian from the pre-squash
    ``u`` (stored in the rollout, so the ratio's log-prob needs no atanh):
    ``eps = (u − mu)·exp(−log_std)`` and the tanh correction by the stable
    identity of ``sac.sample_action``, its softplus ``logaddexp(x, 0)``."""
    eps = (u - mu) * torch.exp(-log_std)
    logp = -0.5 * (eps ** 2 + 2.0 * log_std + _LOG_2PI).sum(-1)
    softplus = torch.logaddexp(-2.0 * u, torch.zeros_like(u))
    return logp - (2.0 * (_LOG_2 - u - softplus)).sum(-1)


def greedy_act(actor: GaussianActor) -> common.GreedyPolicy:
    """obs (E, …) → greedy actions tanh(mu(obs)) (E, 2)."""
    return common.GreedyPolicy(actor, lambda net, obs: torch.tanh(net(obs)[0]))


@torch.no_grad()
def rollout(venv: VectorCartpole, ps: PPOState, steps: int, reset_pool,
            eps: Optional[torch.Tensor] = None) -> dict:
    """``steps`` auto-resetting vectorized steps under the current policy
    from ``ps.env_states``/``ps.obs``, which it advances → the stacked
    (T, E, …) ``obs`` acted on (resolved), pre-squash ``u``, ``logp``,
    ``v``, ``reward`` and ``done``, and ``v_last`` (E,) of the obs to act on
    next.  ``eps`` (T, E, 2): the normals of ``u = mu + exp(log_std)·eps``,
    drawn from ``ps.generator`` when not given."""
    g, dev = ps.generator, venv.device
    states, obs = ps.env_states, ps.obs
    out = {k: [] for k in ("obs", "u", "logp", "v", "reward", "done")}
    for t in range(steps):
        mu, log_std = ps.actor(obs)
        e = eps[t].to(dev) if eps is not None else torch.randn(mu.shape, generator=g, device=dev)
        u = mu + torch.exp(log_std) * e
        v = ps.value(obs)
        states, nobs_raw, reward, done = venv.step_lazy(states, torch.tanh(u), reset_pool)
        for k, x in (("obs", obs), ("u", u), ("logp", tanh_gaussian_logp(mu, log_std, u)),
                     ("v", v), ("reward", reward), ("done", done)):
            out[k].append(x)
        obs = resolve_obs(done, reset_pool[1], nobs_raw)
    ps.env_states, ps.obs = states, obs
    return {**{k: torch.stack(v) for k, v in out.items()}, "v_last": ps.value(obs)}


def gae(reward: torch.Tensor, v: torch.Tensor, done: torch.Tensor, v_last: torch.Tensor,
        gamma: float, lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    """GAE(λ) over (T, E) rewards (already scaled) with termination masking
    (time-limit dones end the bootstrap too, as in JAX) → (advantages,
    returns = advantages + v), the JAX reverse scan as a reverse loop."""
    not_done = 1.0 - done.to(torch.float32)
    v_next = torch.cat([v[1:], v_last[None]], dim=0)
    adv = torch.empty_like(v)
    a = torch.zeros_like(v_last)
    for t in reversed(range(reward.shape[0])):
        delta = reward[t] + gamma * v_next[t] * not_done[t] - v[t]
        a = delta + gamma * lam * not_done[t] * a
        adv[t] = a
    return adv, adv + v


def whiten(adv: torch.Tensor, group=None) -> torch.Tensor:
    """Whiten over the whole batch by the population variance (ddof 0, as
    ``jnp.var``).  With a data-parallel ``group``, JAX's sharded form: the
    mean of the ranks' means, then the mean of each rank's squared deviation
    about that mean."""
    if group is not None:
        mean = adv.mean()
        distributed.allreduce_mean_([mean], group)
        var = ((adv - mean) ** 2).mean()
        distributed.allreduce_mean_([var], group)
        return (adv - mean) * torch.rsqrt(var + 1e-8)
    mean, var = adv.mean(), adv.var(correction=0)
    return (adv - mean) * torch.rsqrt(var + 1e-8)


def ppo_loss(actor: GaussianActor, value: ValueNetwork, obs, u, logp_old, adv, ret, *,
             clip: float, value_coef: float, entropy_coef: float) -> tuple[torch.Tensor, tuple]:
    """The clipped surrogate on one minibatch → (loss, (pg_loss, v_loss,
    entropy, clip_frac, approx_kl)): ``loss = pg + value_coef·v_loss −
    entropy_coef·entropy``, the entropy the sample estimate ``−mean log π``."""
    mu, log_std = actor(obs)
    logp = tanh_gaussian_logp(mu, log_std, u)
    ratio = torch.exp(logp - logp_old)
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    pg_loss = -torch.minimum(s1, s2).mean()
    v_loss = 0.5 * torch.mean((value(obs) - ret) ** 2)
    entropy = -logp.mean()
    loss = pg_loss + value_coef * v_loss - entropy_coef * entropy
    clip_frac = torch.mean((torch.abs(ratio - 1.0) > clip).to(torch.float32))
    approx_kl = torch.mean(logp_old - logp)
    return loss, (pg_loss, v_loss, entropy, clip_frac, approx_kl)


def make_train_step(venv: VectorCartpole, opts, group=None):
    """One PPO update → ``train_step(ps, eps=None, perms=None, reset=None)
    -> metrics``, updating ``ps`` in place and advancing ``ps.update``.

    ``eps`` (T, E, 2): the rollout's normals; ``perms`` (epochs, T·E): each
    epoch's permutation; ``reset``: the reset pool's ``(theta, jitter)``.
    Each one not given is drawn from ``ps.generator``.  ``metrics``: device
    scalars, :data:`METRIC_KEYS`, the loss terms of the last minibatch of
    the last epoch, ``mean_reward`` of the unscaled rewards and
    ``done_frac``.  ``--ppo-minibatches`` must divide ``T·E``.  With a
    data-parallel ``group`` the advantages are whitened over every rank's
    rollout (:func:`whiten`) and each minibatch's gradients averaged over
    the ranks before the clip and the step."""
    resolve_device(venv.device)
    T, E, M = opts.rollout_steps, venv.num_envs, opts.ppo_minibatches
    if (T * E) % M:
        raise SystemExit("--ppo-minibatches must divide rollout-steps × envs")
    mb = (T * E) // M
    rscale = opts.reward_scale
    loss_kw = dict(clip=opts.ppo_clip, value_coef=opts.value_coef,
                   entropy_coef=opts.entropy_coef)

    def train_step(ps: PPOState, eps=None, perms=None, reset=None) -> dict:
        g, dev = ps.generator, venv.device
        reset_pool = venv.reset(g, *(reset if reset is not None else (None, None)))
        r = rollout(venv, ps, T, reset_pool, eps)
        reward = r["reward"] * rscale
        adv, ret = gae(reward, r["v"], r["done"], r["v_last"], opts.gamma, opts.gae_lambda)
        flat = lambda x: x.reshape((T * E,) + x.shape[2:])
        batch = (flat(r["obs"]), flat(r["u"]), flat(r["logp"]), whiten(flat(adv), group),
                 flat(ret))
        params = ps.parameters()
        for k in range(opts.ppo_epochs):
            perm = perms[k].to(dev) if perms is not None else torch.randperm(
                T * E, generator=g, device=dev)
            for m in range(M):
                idx = perm[m * mb:(m + 1) * mb]
                loss, aux = ppo_loss(ps.actor, ps.value, *(x[idx] for x in batch), **loss_kw)
                ps.opt.zero_grad(set_to_none=True)
                loss.backward()
                _step(ps.opt, ps.sched, params, opts.grad_clip, group)
        ps.update += 1
        stats = (loss, *aux, (reward / rscale).mean(), r["done"].to(torch.float32).mean())
        return {k: x.detach() for k, x in zip(METRIC_KEYS, stats)}

    return train_step


def init_state(opts, config, venv: VectorCartpole, lr: LearningRate = 3e-4,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1,
               pixel_encoder: str = "dense") -> PPOState:
    """Fresh training state on ``venv``'s device: a :class:`GaussianActor`
    and a :class:`ValueNetwork` initialised from ``opts.seed``, one Adam
    over both (a schedule from ``common.make_lr``), and the env reset from
    a device generator seeded with ``opts.seed``."""
    dev = venv.device
    init_gen = torch.Generator().manual_seed(opts.seed)
    kw = dict(use_raw_pixels=config.use_raw_pixels, height=config.obs_height,
              width=config.obs_width, hidden=tuple(hidden), pixel_pool=pixel_pool, device=dev,
              generator=init_gen, pixel_encoder=pixel_encoder)
    actor = GaussianActor(config.obs_shape, **kw)
    value = ValueNetwork(config.obs_shape, **kw)
    opt, sched = adam(torch.nn.ModuleList([actor, value]), lr)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    env_states, obs = venv.reset(gen)
    return PPOState(actor=actor, value=value, opt=opt, sched=sched, env_states=env_states,
                    obs=obs, generator=gen)


def train(opts, stop_at: int | None = None) -> float:
    """The JAX ``train`` over the port's pieces → the last eval's mean
    episode length.

    Builds the training and eval vector envs (on the card unless
    ``--device cpu``) and :func:`init_state`, restores the newest
    checkpoint of ``--ckpt-dir`` if there is one, then runs updates from
    the restored ``update`` to ``--num-train-batches`` with their evals,
    metrics (``env_steps`` and :data:`METRIC_KEYS` among the JAX fields) and
    checkpoints (:func:`common.train_updates`).  ``--lr-schedule cosine``
    decays over every optimizer step of the run, updates × epochs ×
    minibatches.  ``--eval-only`` evaluates the restored policy instead.
    ``stop_at`` (not a flag): end after that update, the schedule keeping
    ``--num-train-batches``'s length.

    ``--num-devices`` N > 1 and ``--coordinator/--num-processes/
    --process-id``: each rank rolls out ``--num-envs / N`` envs, starting
    from its rows of the one-card run's reset; the advantages are whitened
    over all ranks, each minibatch's gradients and the metrics averaged
    over them; rank 0 evaluates."""
    mesh = common.maybe_init_multihost(opts)
    if common.launches_ranks(opts, mesh, replay=False):
        return distributed.launch(opts, train, stop_at)
    dev = common.rank_device(opts, mesh)
    config = config_from_opts(opts, discrete_actions=False)
    raster = common.resolve_render_raster(config, opts)
    venv, init_venv = common.rank_venvs(config, opts, dev, raster, mesh)
    eval_venv = common.make_venv(config, opts.num_eval, device=dev, render_raster=raster)
    logger = MetricsLogger(opts.metrics_jsonl, tb_dir=opts.tb_dir)
    total = opts.num_train_batches * opts.ppo_epochs * opts.ppo_minibatches
    st = init_state(opts, config, init_venv,
                    lr=common.make_lr(opts, opts.learning_rate, total), hidden=opts.hidden,
                    pixel_pool=opts.pixel_pool, pixel_encoder=opts.pixel_encoder)
    common.shard_start(st, mesh, SHARDED_FIELDS)
    restored = None
    if opts.ckpt_dir:
        st, restored = common.restore_for_startup(opts, st, mesh)
        if restored is not None:
            logger.log("restore", step=restored)
    act = greedy_act(st.actor)
    if opts.eval_only:
        return common.run_eval_only(opts, logger, restored, eval_venv, act)

    train_step = common.distribute(make_train_step(venv, opts, group=mesh and mesh.group),
                                   mesh, SHARDED_FIELDS, METRIC_KEYS)
    steps_per_update = opts.rollout_steps * opts.num_envs

    def fields(update: int, metrics: dict) -> dict:
        return {"env_steps": update * steps_per_update,
                **{k: float(metrics[k]) for k in METRIC_KEYS}}

    end = opts.num_train_batches if stop_at is None else min(stop_at, opts.num_train_batches)
    return common.train_updates(opts, st, train_step, eval_venv, act, logger, fields, st.update,
                                end, mesh, SHARDED_FIELDS)


def make_parser():
    parser = common.make_parser("PPO agent on cartpole++ (PyTorch/CUDA port)")
    add_ppo_opts(parser)
    return parser


def main(argv=None, stop_at: int | None = None) -> float:
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    return train(opts, stop_at=stop_at)


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports (as the JAX CLI does).
    from cartpoleplusplus_tpu_torch.agents.ppo import main as _main

    _main()
