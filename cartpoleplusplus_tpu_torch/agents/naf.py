"""NAF: port of cartpoleplusplus_tpu.agents.naf — Normalized Advantage
Functions over continuous actions, and its program: the JAX CLI
(``add_naf_opts``), ``train`` with jsonl metrics, periodic greedy evals and
checkpoints (resume, ``--ckpt-best``, ``--ckpt-skip-replay``,
``--eval-only``), and ``main``::

    python -m cartpoleplusplus_tpu_torch.agents.naf --use-batch-norm ...

One :class:`NAFNetwork` emits V(s), µ(s) and the lower triangle of L(s);
``Q(s, a) = V(s) − ½‖Lᵀ(a − µ)‖²``.  Per env step the segment acts with µ
(eval mode) plus OU noise, steps the env through the kernels, writes the
transition into the on-device replay and, once the train gate is open,
runs one update: the TD target ``reward_scale·r + γ·(1 − terminal)·V'(s2)``
from the target network's V in eval mode, the MSE of Q(s1, a) from a
train-mode forward (which moves the online batch statistics under
``--use-batch-norm``), one Adam step, and the soft update by τ of every
target parameter and statistic.  The segment is ``agents/ddpg.py``'s: a
Python loop of PyTorch calls and kernel launches with a host-side step
counter, replay cursor and train gate, each update inside a
``torch.profiler`` span named ``LEARNER_SPAN``.  Every random draw of a
segment (the reset pool's, the OU normals, the replay's sample offsets)
can be given as an argument, so a test can feed the JAX version's.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Optional, Sequence

import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.agents.ddpg import LearningRate, _step, adam
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole, resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import NAFNetwork
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.replay.buffer import ReplayState
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger
from cartpoleplusplus_tpu_torch.utils.noise import ou_init, ou_step
from cartpoleplusplus_tpu_torch.utils.optim import Adam, Schedule

LEARNER_SPAN = "naf.train_once"
# A data-parallel run's sharded fields and averaged metrics (the JAX
# NAF_SHARDED_FIELDS / NAF_METRIC_KEYS).
SHARDED_FIELDS = distributed.DDPG_SHARDED_FIELDS
METRIC_KEYS = ("loss", "reward", "done_frac", "double_reset_frac")


@dataclasses.dataclass
class NAFState:
    """Everything the training loop carries.  The networks and the optimizer
    are updated in place; ``env_steps`` is a host int."""

    net: NAFNetwork
    target_net: NAFNetwork
    opt: Adam
    sched: Optional[Schedule]
    replay: ReplayState
    env_states: EnvState
    obs: torch.Tensor        # (E, *obs_shape): the previous step's raw obs
    ou_noise: torch.Tensor   # (E, 2)
    generator: torch.Generator
    env_steps: int = 0

    _NETS = ("net", "target_net")

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, under the JAX state's names where it
        has them: ``variables`` and ``target_variables`` (the networks',
        batch statistics included), ``opt`` and ``sched``, the replay with
        its cursor and fill, the env states, ``obs``, ``ou_noise``, the
        generator's state and ``env_steps``."""
        return {"variables": self.net.state_dict(),
                "target_variables": self.target_net.state_dict(),
                "opt": self.opt.state_dict(),
                "sched": None if self.sched is None else self.sched.state_dict(),
                **common.carried_state_dict(self), "ou_noise": self.ou_noise}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents in place, onto this state's
        device."""
        self.net.load_state_dict(sd["variables"])
        self.target_net.load_state_dict(sd["target_variables"])
        self.opt.load_state_dict(sd["opt"])
        if self.sched is not None and sd["sched"] is not None:
            self.sched.load_state_dict(sd["sched"])
        common.load_carried_state(self, sd)
        self.ou_noise = sd["ou_noise"].to(self.obs.device)


def greedy_act(net: NAFNetwork) -> common.GreedyPolicy:
    """obs (E, …) → greedy actions µ(obs) (E, 2), batch norm in eval mode.
    The JAX version takes ``(variables, obs)``; here they live in the
    module."""
    return common.GreedyPolicy(net, lambda net, obs: net(obs)[1])


def make_train_once(*, gamma: float, tau: float, reward_scale: float = 1.0,
                    grad_clip: float = 0.0, group=None):
    """One learner update → ``train_once(st, batch) -> loss``, a device
    scalar.  ``batch``: ``(s1, action, reward, s2, terminal)`` as stored.

    In the JAX order: ``y = reward_scale·r + γ·(1 − term)·V'(s2)`` from the
    target network in eval mode; the loss ``mean((Q(s1, a) − y)²)`` from a
    train-mode forward of the online network (moving its batch statistics);
    one Adam step (after a global-norm clip when ``grad_clip`` > 0); the
    soft update by τ of every target parameter and buffer.  Gradients stay
    in each parameter's ``.grad`` until the next update.  ``group``: the
    data-parallel process group whose ranks average the gradient before the
    step (the batch statistics stay each rank's own).
    """

    def train_once(st: NAFState, batch) -> torch.Tensor:
        s1, a, r, s2, term = batch
        s1, s2 = replay_mod.decode_obs(s1), replay_mod.decode_obs(s2)
        with torch.no_grad():
            v2 = st.target_net(s2)[0]
            y = reward_scale * r + gamma * (1.0 - term.to(torch.float32)) * v2
        v, mu, l_flat = st.net(s1, train=True)
        loss = torch.mean((NAFNetwork.q_value(v, l_flat, mu, a) - y) ** 2)
        st.opt.zero_grad(set_to_none=True)
        loss.backward()
        _step(st.opt, st.sched, st.net.parameters(), grad_clip, group)
        soft_target_update(st.target_net, st.net, tau)
        return loss.detach()

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
    grad_clip: float = 0.0,
    group=None,
):
    """The K-step training segment: ``segment(st, draws=None) -> metrics``,
    updating ``st`` in place, on ``ddpg.make_segment``'s skeleton: one
    reset pool per segment, the auto-reset obs substitution applied lazily
    and materialized at the segment's end.

    Per step: µ of the online network in eval mode, the OU step at σ
    annealed by ``env_steps`` read BEFORE this step's increment
    (:func:`common.ou_sigma_at`), the action ``clip(µ + ou, −1, 1)``, the
    env step, the replay write (s2-free in block mode), the OU noise zeroed
    where an episode ended; then ``env_steps`` is incremented and, once
    ``env_steps > warmup_steps`` and the replay holds
    :func:`common.replay_min_fill` transitions, a uniform sample and one
    update (:func:`make_train_once`).

    ``draws``: an optional dict of ``pool`` (the reset pool's ``(theta,
    jitter)``) and ``steps`` (per step an optional dict of ``ou_eps``, the
    OU step's (E, 2) standard normals, and ``offsets``, the sample's
    (batch,) draws of :func:`replay_mod.sample_offsets`); each one not
    given is drawn from ``st.generator``.

    ``metrics``: device scalars averaged over the segment's steps (``loss``,
    zero on steps without an update, as the JAX mean counts them;
    ``reward``, ``done_frac``; ``double_reset_frac``) and the host int
    ``updates``.  ``group``: as ``ddpg.make_segment`` takes it.
    """
    resolve_device(venv.device)
    train_once = make_train_once(gamma=gamma, tau=tau, reward_scale=reward_scale,
                                 grad_clip=grad_clip, group=group)
    e = venv.num_envs

    def segment(st: NAFState, draws: Optional[dict] = None) -> dict:
        draws = draws or {}
        g, dev = st.generator, venv.device
        reset_pool = venv.reset(g, *draws.get("pool", (None, None)))
        reset_obs = reset_pool[1]
        min_fill = common.replay_min_fill(warmup_steps, e, st.replay.capacity)
        store = st.replay.s1.dtype
        zero = torch.zeros((), device=dev)
        loss_sum, reward_sum, done_sum = zero, zero, zero
        done_counts = torch.zeros((e,), device=dev)
        prev_done = torch.zeros((e,), dtype=torch.bool, device=dev)
        updates = 0
        for t in range(steps_per_segment):
            d = draws["steps"][t] if "steps" in draws else {}
            with torch.no_grad():
                obs_in = resolve_obs(prev_done, reset_obs, st.obs)
                mu = st.net(obs_in)[1]
                sigma = common.ou_sigma_at(st.env_steps, ou_sigma, ou_sigma_min, ou_decay_steps)
                eps = d.get("ou_eps")
                ou = ou_step(st.ou_noise, theta=ou_theta, sigma=sigma, generator=g,
                             eps=None if eps is None else eps.to(dev))
                action = torch.clamp(mu + ou, -1.0, 1.0)
                env_states, obs2, reward, done = venv.step_lazy(st.env_states, action, reset_pool)
                s2 = None if st.replay.block else replay_mod.encode_obs(obs2, store)
                replay_mod.add_batch(st.replay, replay_mod.encode_obs(obs_in, store), action,
                                     reward, s2, done)
                st.ou_noise = torch.where(done[:, None], 0.0, ou)
                st.env_states, st.obs = env_states, obs2
            st.env_steps += 1
            if st.env_steps > warmup_steps and st.replay.size >= min_fill:
                with torch.profiler.record_function(LEARNER_SPAN):
                    offsets = d.get("offsets")
                    batch = replay_mod.sample(st.replay, batch_size, g,
                                              offsets=None if offsets is None else offsets.to(dev))
                    loss_sum = loss_sum + train_once(st, batch)
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
            "loss": loss_sum / k, "reward": reward_sum / k, "done_frac": done_sum / k,
            "double_reset_frac": torch.clamp(done_counts - 1.0, min=0.0).sum() / total,
            "updates": updates,
        }

    return segment


def init_state(opts, config, venv: VectorCartpole, lr: LearningRate = 1e-3,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1,
               pixel_encoder: str = "dense") -> NAFState:
    """Fresh training state on ``venv``'s device: a :class:`NAFNetwork`
    (batch norm with ``opts.use_batch_norm``) initialised from
    ``opts.seed``, the target a copy, one Adam (a schedule from
    ``common.make_lr``), zero OU noise, and the replay and env reset as
    ``ddpg.init_state`` builds them."""
    dev = venv.device
    net = NAFNetwork(config.obs_shape, use_raw_pixels=config.use_raw_pixels,
                     height=config.obs_height, width=config.obs_width, hidden=tuple(hidden),
                     pixel_pool=pixel_pool, device=dev,
                     generator=torch.Generator().manual_seed(opts.seed),
                     pixel_encoder=pixel_encoder,
                     use_batch_norm=getattr(opts, "use_batch_norm", False))
    opt, sched = adam(net, lr)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    env_states, obs = venv.reset(gen)
    block = common.replay_block(opts, venv.num_envs)
    replay = replay_mod.create(
        common.shard_capacity(opts, block), config.obs_shape, (2,),
        obs_dtype=torch.uint8 if config.use_raw_pixels else torch.float32, block=block,
        device=dev)
    return NAFState(net=net, target_net=copy.deepcopy(net).requires_grad_(False), opt=opt,
                    sched=sched, replay=replay, env_states=env_states, obs=obs,
                    ou_noise=ou_init((venv.num_envs, 2), device=dev), generator=gen)


def add_naf_opts(parser) -> None:
    """NAF's flags (the JAX ``add_naf_opts``: same names, defaults and
    choices)."""
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
                        help="batch norm of the encoder's features (train mode in the "
                             "loss, eval mode for acting and the target)")
    parser.add_argument("--reward-scale", type=float, default=1.0,
                        help="scale rewards in the TD target")
    parser.add_argument("--grad-clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 = off)")
    common.add_lr_schedule_opt(parser)
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks (one device each) to shard envs and replay over; "
                             "gradients are averaged across them")


def train(opts, stop_at: int | None = None) -> float:
    """The JAX ``train`` over the port's pieces → the last eval's mean
    episode length; ``ddpg.train``'s shape with NAF's pieces.

    Builds the training and eval vector envs (on the card unless
    ``--device cpu``) and :func:`init_state` (Adam at ``--learning-rate``,
    or its cosine schedule), restores the newest checkpoint of
    ``--ckpt-dir`` if there is one, then runs segments ``start ..
    --num-train-batches`` with their evals, metrics (the ``train`` event's
    ``loss`` and ``mean_reward`` as in JAX) and checkpoints
    (:func:`common.train_segments`).  ``--eval-only`` evaluates the restored
    policy instead.  ``stop_at`` (not a flag): end after that segment, the
    learning-rate schedule keeping ``--num-train-batches``'s length.

    ``--num-devices`` N > 1 and ``--coordinator/--num-processes/
    --process-id``: the data-parallel run of ``ddpg.train`` (the ranks'
    env and replay shards, the per-rank batch ``--batch-size // N``, the
    gradients and metrics averaged over the ranks, rank 0's eval).  With
    ``--use-batch-norm`` each rank's running statistics move with its own
    batches and are never averaged, as in the JAX package, where chip 0's
    copy of the replicated statistics is the one saved and evaluated: the
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
    st = init_state(opts, config, init_venv, lr=common.make_lr(opts, opts.learning_rate),
                    hidden=opts.hidden, pixel_pool=opts.pixel_pool,
                    pixel_encoder=opts.pixel_encoder)
    common.shard_start(st, mesh, SHARDED_FIELDS)
    start_segment, restored = 0, None
    if opts.ckpt_dir:
        st, restored = common.restore_for_startup(opts, st, mesh)
        if restored is not None:
            start_segment = restored
            logger.log("restore", step=restored)
    act = greedy_act(st.net)
    if opts.eval_only:
        return common.run_eval_only(opts, logger, restored, eval_venv, act)

    segment = make_segment(
        venv, gamma=opts.gamma, tau=opts.tau, batch_size=common.rank_batch(opts, mesh),
        warmup_steps=opts.warmup_steps, steps_per_segment=opts.steps_per_segment,
        ou_theta=opts.ou_theta, ou_sigma=opts.ou_sigma, ou_sigma_min=opts.ou_sigma_min,
        ou_decay_steps=opts.ou_decay_steps, reward_scale=opts.reward_scale,
        grad_clip=opts.grad_clip, group=mesh and mesh.group)

    def fields(metrics: dict) -> dict:
        return {"loss": float(metrics["loss"]), "mean_reward": float(metrics["reward"])}

    end = opts.num_train_batches if stop_at is None else min(stop_at, opts.num_train_batches)
    return common.train_segments(
        opts, st, common.distribute(segment, mesh, SHARDED_FIELDS, METRIC_KEYS), venv,
        eval_venv, act, logger, fields, start_segment, end, mesh, SHARDED_FIELDS)


def make_parser():
    parser = common.make_parser("NAF agent on cartpole++ (PyTorch/CUDA port)")
    add_naf_opts(parser)
    return parser


def main(argv=None, stop_at: int | None = None) -> float:
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    return train(opts, stop_at=stop_at)


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports (as the JAX CLI does).
    from cartpoleplusplus_tpu_torch.agents.naf import main as _main

    _main()
