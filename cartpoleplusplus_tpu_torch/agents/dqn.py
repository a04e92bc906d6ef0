"""DQN: port of cartpoleplusplus_tpu.agents.dqn — ε-greedy Q-learning over the
5 discrete actions with a target network, on the same training segment as
DDPG, and its program: the JAX CLI (``add_dqn_opts``), ``train`` with jsonl
metrics, periodic greedy evals and checkpoints (resume, ``--ckpt-best``,
``--ckpt-skip-replay``, ``--eval-only``), and ``main``::

    python -m cartpoleplusplus_tpu_torch.agents.dqn --per --n-step 3 --dueling \\
        --c51 51 --c51-vmax 10 --noisy ...

The heads and their combination are the JAX package's: double-Q (on by
default), dueling, distributional C51 (a fixed support, targets projected
through the hat-function matrix) and NoisyNet exploration, which under
``--noisy`` replaces ε-greedy; with ``--per --n-step 3`` they make the full
Rainbow.  The segment is ``agents/ddpg.py``'s: a Python loop of PyTorch
calls and kernel launches with a host-side step counter, replay cursor and
train gate, each update inside a ``torch.profiler`` span named
``LEARNER_SPAN``.  Every random draw of a step and of an update can be
given as an argument, so a test can feed the JAX version's.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.agents.ddpg import LearningRate, _step, adam
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import NUM_DISCRETE_ACTIONS, config_from_opts
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole, resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import QNetwork
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.replay.buffer import ReplayState
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger
from cartpoleplusplus_tpu_torch.utils.optim import Adam, Schedule

LEARNER_SPAN = "dqn.train_once"
# A data-parallel run's sharded fields and averaged metrics (the JAX
# DQN_SHARDED_FIELDS / DQN_METRIC_KEYS; ``eps`` is a host float, equal on
# every rank).
SHARDED_FIELDS = ("replay", "env_states", "obs")
METRIC_KEYS = ("loss", "reward", "done_frac", "double_reset_frac")


@dataclasses.dataclass
class DQNState:
    """Everything the training loop carries.  The networks and the optimizer
    are updated in place; ``env_steps`` is a host int."""

    q: QNetwork
    target_q: QNetwork
    opt: Adam
    sched: Optional[Schedule]
    replay: ReplayState
    env_states: EnvState
    obs: torch.Tensor        # (E, *obs_shape): the previous step's raw obs
    generator: torch.Generator
    env_steps: int = 0

    _NETS = ("q", "target_q")

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, under the JAX state's names where it
        has them: ``params`` and ``target_params`` (the networks'), ``opt``
        and ``sched``, the replay with its cursor and fill (int actions;
        priorities under ``--per``), the env states, ``obs``, the
        generator's state and ``env_steps``."""
        return {"params": self.q.state_dict(), "target_params": self.target_q.state_dict(),
                "opt": self.opt.state_dict(),
                "sched": None if self.sched is None else self.sched.state_dict(),
                **common.carried_state_dict(self)}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents in place, onto this state's
        device."""
        self.q.load_state_dict(sd["params"])
        self.target_q.load_state_dict(sd["target_params"])
        self.opt.load_state_dict(sd["opt"])
        if self.sched is not None and sd["sched"] is not None:
            self.sched.load_state_dict(sd["sched"])
        common.load_carried_state(self, sd)


def support(vmin: float, vmax: float, atoms: int, device=None) -> torch.Tensor:
    """The C51 support, ``linspace(vmin, vmax, atoms)`` in float32, built on
    the host as the JAX version builds it."""
    return torch.from_numpy(np.linspace(vmin, vmax, atoms, dtype=np.float32)).to(device)


def categorical_projection(p_next: torch.Tensor, tz: torch.Tensor,
                           z: torch.Tensor) -> torch.Tensor:
    """C51 target projection: each Bellman-mapped atom ``tz_j`` (B, K),
    clipped to the support ``z`` (K,), splits its probability ``p_next``
    (B, K) between its two neighbouring atoms by the hat function
    ``clip(1 − |b_j − i|, 0, 1)``, ``b = (clip(tz) − z_0)/dz``; the result
    is one (B, K) × (B, K, K) contraction."""
    dz = z[1] - z[0]
    b = (torch.clamp(tz, z[0], z[-1]) - z[0]) / dz
    iota = torch.arange(z.shape[0], dtype=torch.float32, device=z.device)
    w = torch.clamp(1.0 - torch.abs(b[:, :, None] - iota), 0.0, 1.0)
    return torch.einsum("bj,bjk->bk", p_next, w)


def q_scalar(out: torch.Tensor, z: Optional[torch.Tensor]) -> torch.Tensor:
    """Scalar Q(s, ·) from a :class:`QNetwork`'s output: the distribution's
    mean Σ softmax·z under C51 (``z`` the support), the output otherwise."""
    if z is None:
        return out
    return torch.sum(torch.softmax(out, dim=-1) * z, dim=-1)


def greedy_act(qnet: QNetwork) -> common.GreedyPolicy:
    """obs (E, …) → greedy action indices (E,), the noisy heads at their mu
    weights.  Under C51 the argmax of the mean over a unit support
    ``linspace(0, 1, K)``: the argmax of a mean is invariant to an affine
    map of the support, so acting needs no vmin/vmax (as in JAX)."""
    if not qnet.num_atoms:
        return common.GreedyPolicy(qnet, lambda net, obs: torch.argmax(net(obs), dim=-1))
    z = support(0.0, 1.0, qnet.num_atoms, next(qnet.parameters()).device)
    return common.GreedyPolicy(
        qnet, lambda net, obs, z: torch.argmax(q_scalar(net(obs), z), dim=-1), z=z)


def make_train_once(*, gamma: float, tau: float, reward_scale: float = 1.0,
                    double_q: bool = False, n_step: int = 1, c51_atoms: int = 0,
                    c51_vmin: float = 0.0, c51_vmax: float = 12.0, noisy: bool = False,
                    grad_clip: float = 0.0, group=None):
    """One learner update → ``train_once(st, batch, iw=None, noise=None) ->
    (loss, priority)``: a device scalar and the (B,) priorities for the
    write-back, ``|td|``, or under C51 the cross-entropy (Rainbow's).

    ``batch``: ``(s1, action, reward, s2, terminal)`` as stored, or an
    n-step batch (n-step reward, any-terminal flag) bootstrapped with
    ``gamma ** n_step``.  Plain: ``y = reward_scale·r + γⁿ·(1 − term)·q2``,
    ``q2`` the target net's value at the online argmax (``double_q``) or its
    max; the loss ``mean(iw·td²)``.  C51: the target's distribution at that
    action, its support Bellman-mapped and projected
    (:func:`categorical_projection`); the loss ``mean(iw·ce)``.  ``iw``:
    prioritized replay's importance weights (ones when None).  Then one Adam
    step (after a global-norm clip when ``grad_clip`` > 0) and the soft
    update by τ of every target parameter, sigmas included.

    ``noise`` (``noisy`` only): ``{"target", "select", "loss"}``, each
    ``{head: (eps_in, eps_out)}`` — the three independent NoisyNet draws of
    the target on s2, the online selection on s2 and the online loss on s1,
    in JAX's order; each one not given is drawn from ``st.generator``.
    ``group``: the data-parallel process group whose ranks average the
    gradient before the step.
    """
    bootstrap = gamma ** n_step
    supports = {}  # the C51 support, built once per device

    def train_once(st: DQNState, batch, iw=None, noise=None):
        s1, a, r, s2, term = batch
        s1, s2 = replay_mod.decode_obs(s1), replay_mod.decode_obs(s2)
        a = a.to(torch.int64)
        live = 1.0 - term.to(torch.float32)
        rows = torch.arange(a.shape[0], device=a.device)
        z = None
        if c51_atoms:
            if s1.device not in supports:
                supports[s1.device] = support(c51_vmin, c51_vmax, c51_atoms, s1.device)
            z = supports[s1.device]
        draws = noise or {}

        def fwd(net: QNetwork, obs: torch.Tensor, which: str) -> torch.Tensor:
            if not noisy:
                return net(obs)
            return net(obs, draws.get(which), st.generator)

        with torch.no_grad():
            if c51_atoms:
                p2_all = torch.softmax(fwd(st.target_q, s2, "target"), dim=-1)
                if double_q:
                    a2 = torch.argmax(q_scalar(fwd(st.q, s2, "select"), z), dim=-1)
                else:
                    a2 = torch.argmax(torch.sum(p2_all * z, dim=-1), dim=-1)
                tz = reward_scale * r[:, None] + bootstrap * live[:, None] * z[None, :]
                m = categorical_projection(p2_all[rows, a2], tz, z)
            else:
                q2_t = fwd(st.target_q, s2, "target")
                if double_q:
                    a2 = torch.argmax(fwd(st.q, s2, "select"), dim=-1)
                    q2 = q2_t[rows, a2]
                else:
                    q2 = torch.max(q2_t, dim=-1).values
                y = reward_scale * r + bootstrap * live * q2
        out = fwd(st.q, s1, "loss")
        if c51_atoms:
            priority = -torch.sum(m * F.log_softmax(out, dim=-1)[rows, a], dim=-1)
            per_sample = priority
        else:
            td = out[rows, a] - y
            priority, per_sample = td.abs(), td ** 2
        loss = torch.mean(per_sample if iw is None else iw * per_sample)
        st.opt.zero_grad(set_to_none=True)
        loss.backward()
        _step(st.opt, st.sched, st.q.parameters(), grad_clip, group)
        soft_target_update(st.target_q, st.q, tau)
        return loss.detach(), priority.detach()

    return train_once


def make_segment(
    venv: VectorCartpole,
    *,
    gamma: float,
    tau: float,
    batch_size: int,
    warmup_steps: int,
    steps_per_segment: int,
    eps_start: float,
    eps_end: float,
    eps_decay_steps: int,
    reward_scale: float = 1.0,
    double_q: bool = False,
    per_alpha: float | None = None,
    per_beta0: float = 0.4,
    per_total_steps: int = 1,
    per_eps: float = 1e-2,
    n_step: int = 1,
    c51_atoms: int = 0,
    c51_vmin: float = 0.0,
    c51_vmax: float = 12.0,
    noisy: bool = False,
    grad_clip: float = 0.0,
    group=None,
):
    """The K-step training segment: ``segment(st, draws=None) -> metrics``,
    updating ``st`` in place, on ``ddpg.make_segment``'s skeleton: one
    reset pool per segment, the auto-reset obs substitution applied lazily.

    Per step: act ε-greedy on :func:`q_scalar` of the online net with a
    fresh NoisyNet draw (``noisy``), ε = ``eps_start + (eps_end −
    eps_start)·clip(env_steps/eps_decay_steps, 0, 1)`` read BEFORE this
    step's increment; store the int actions; then increment ``env_steps``
    and, once ``env_steps > warmup_steps`` and the replay holds
    :func:`common.replay_min_fill` transitions, run one update.  Under
    prioritized replay (``per_alpha`` not None) β anneals from
    ``per_beta0`` to 1 over ``per_total_steps`` (read after the
    increment) and the priorities are written back only on steps that
    trained.

    ``draws``: per step an optional dict of ``random_action`` (E,) ints,
    ``explore_u`` (E,) uniforms (explore where u < ε), ``act_noise`` (the
    acting forward's ``{head: (eps_in, eps_out)}``) and ``update_noise``
    (:func:`make_train_once`'s ``noise``); each one not given is drawn from
    ``st.generator``.

    ``metrics``: ``loss`` (a device scalar averaged over the segment's
    steps, 0 on steps without an update, as the JAX mean counts them),
    ``reward``, ``done_frac``, ``double_reset_frac`` (device scalars),
    ``eps`` (a host float, its mean over the steps) and the host int
    ``updates``.  ``group``: as ``ddpg.make_segment`` takes it.
    """
    resolve_device(venv.device)
    train_once = make_train_once(
        gamma=gamma, tau=tau, reward_scale=reward_scale, double_q=double_q, n_step=n_step,
        c51_atoms=c51_atoms, c51_vmin=c51_vmin, c51_vmax=c51_vmax, noisy=noisy,
        grad_clip=grad_clip, group=group)
    e = venv.num_envs
    z = support(c51_vmin, c51_vmax, c51_atoms, venv.device) if c51_atoms else None

    def segment(st: DQNState, draws=None) -> dict:
        g, dev = st.generator, venv.device
        reset_pool = venv.reset(g)
        reset_obs = reset_pool[1]
        min_fill = common.replay_min_fill(warmup_steps, e, st.replay.capacity, n_step)
        store = st.replay.s1.dtype
        zero = torch.zeros((), device=dev)
        loss_sum, reward_sum, done_sum, eps_sum = zero, zero, zero, 0.0
        done_counts = torch.zeros((e,), device=dev)
        prev_done = torch.zeros((e,), dtype=torch.bool, device=dev)
        updates = 0
        for t in range(steps_per_segment):
            d = draws[t] if draws is not None else {}
            frac = min(st.env_steps / eps_decay_steps, 1.0) if eps_decay_steps > 0 else 1.0
            eps = eps_start + (eps_end - eps_start) * frac
            with torch.no_grad():
                obs_in = resolve_obs(prev_done, reset_obs, st.obs)
                out = st.q(obs_in, d.get("act_noise"), g) if noisy else st.q(obs_in)
                greedy = torch.argmax(q_scalar(out, z), dim=-1)
                random_a = d.get("random_action")
                if random_a is None:
                    random_a = torch.randint(0, NUM_DISCRETE_ACTIONS, (e,), generator=g,
                                             device=dev)
                u = d.get("explore_u")
                if u is None:
                    u = torch.rand((e,), generator=g, device=dev)
                action = torch.where(u.to(dev) < eps, random_a.to(dev, torch.int64), greedy)
                env_states, obs2, reward, done = venv.step_lazy(st.env_states, action, reset_pool)
                s2 = None if st.replay.block else replay_mod.encode_obs(obs2, store)
                replay_mod.add_batch(st.replay, replay_mod.encode_obs(obs_in, store),
                                     action.to(st.replay.action.dtype), reward, s2, done)
                st.env_states, st.obs = env_states, obs2
            st.env_steps += 1
            if st.env_steps > warmup_steps and st.replay.size >= min_fill:
                with torch.profiler.record_function(LEARNER_SPAN):
                    if per_alpha is None:
                        batch = replay_mod.sample(st.replay, batch_size, g, n_step=n_step,
                                                  gamma=gamma)
                        loss, _ = train_once(st, batch, noise=d.get("update_noise"))
                    else:
                        beta = per_beta0 + (1.0 - per_beta0) * min(
                            max(st.env_steps / per_total_steps, 0.0), 1.0)
                        batch, idx, iw = replay_mod.sample_prioritized(
                            st.replay, batch_size, per_alpha, beta, n_step=n_step, gamma=gamma,
                            generator=g)
                        loss, priority = train_once(st, batch, iw, d.get("update_noise"))
                        replay_mod.update_priorities(st.replay, idx, priority, per_eps)
                loss_sum = loss_sum + loss
                updates += 1
            eps_sum += eps
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
            "loss": loss_sum / k, "reward": reward_sum / k, "eps": eps_sum / k,
            "done_frac": done_sum / k,
            "double_reset_frac": torch.clamp(done_counts - 1.0, min=0.0).sum() / total,
            "updates": updates,
        }

    return segment


def init_state(opts, config, venv: VectorCartpole, lr: LearningRate = 1e-3,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1,
               pixel_encoder: str = "dense") -> DQNState:
    """Fresh training state on ``venv``'s device: a :class:`QNetwork` with
    ``opts``' heads (``dueling``, ``c51`` atoms, ``noisy``; the plain head
    when ``opts`` lacks them) initialised from ``opts.seed``, the target a
    copy, one Adam (a schedule from ``common.make_lr``), and the replay (int
    actions; priorities with ``opts.per``) and env reset as
    ``ddpg.init_state`` builds them."""
    dev = venv.device
    q = QNetwork(config.obs_shape, num_actions=NUM_DISCRETE_ACTIONS,
                 dueling=getattr(opts, "dueling", False), num_atoms=getattr(opts, "c51", 0),
                 noisy=getattr(opts, "noisy", False), use_raw_pixels=config.use_raw_pixels,
                 height=config.obs_height, width=config.obs_width, hidden=tuple(hidden),
                 pixel_pool=pixel_pool, device=dev,
                 generator=torch.Generator().manual_seed(opts.seed), pixel_encoder=pixel_encoder)
    opt, sched = adam(q, lr)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    env_states, obs = venv.reset(gen)
    block = common.replay_block(opts, venv.num_envs)
    replay = replay_mod.create(
        common.shard_capacity(opts, block), config.obs_shape, (),
        obs_dtype=torch.uint8 if config.use_raw_pixels else torch.float32,
        action_dtype=torch.int32, block=block, device=dev,
        prioritized=getattr(opts, "per", False))
    return DQNState(q=q, target_q=copy.deepcopy(q).requires_grad_(False), opt=opt, sched=sched,
                    replay=replay, env_states=env_states, obs=obs, generator=gen)


def add_dqn_opts(parser) -> None:
    """DQN's flags (the JAX ``add_dqn_opts``: same names, defaults and
    choices)."""
    common.add_lr_schedule_opt(parser)
    parser.add_argument("--grad-clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 = off)")
    parser.add_argument("--reward-scale", type=float, default=1.0,
                        help="scale rewards in the TD target")
    parser.add_argument("--double-q", action="store_true", default=True,
                        help="double DQN: bootstrap from the target net's value of the "
                             "online net's argmax action (default on)")
    parser.add_argument("--no-double-q", dest="double_q", action="store_false")
    parser.add_argument("--tau", type=float, default=0.01, help="target soft-update rate")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--replay-capacity", type=int, default=100000)
    parser.add_argument("--warmup-steps", type=int, default=20)
    parser.add_argument("--steps-per-segment", type=int, default=25)
    parser.add_argument("--eps-start", type=float, default=None,
                        help="default 1.0 (0 under --noisy)")
    parser.add_argument("--eps-end", type=float, default=None,
                        help="default 0.05 (0 under --noisy)")
    parser.add_argument("--eps-decay-steps", type=int, default=5000,
                        help="vectorized steps over which ε anneals linearly")
    common.add_per_opts(parser)
    parser.add_argument("--dueling", action="store_true",
                        help="dueling Q head: Q = V(s) + A(s, a) − mean A")
    parser.add_argument("--c51", type=int, default=0, metavar="ATOMS",
                        help="distributional RL (C51) with ATOMS atoms per action")
    parser.add_argument("--c51-vmin", type=float, default=0.0,
                        help="support lower edge (scaled-return units)")
    parser.add_argument("--c51-vmax", type=float, default=12.0,
                        help="support upper edge")
    parser.add_argument("--noisy", action="store_true",
                        help="NoisyNet heads; the eps flags left unset become 0")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks (one device each) to shard envs and replay over; "
                             "gradients are averaged across them")


def fill_eps_defaults(opts) -> None:
    """The JAX ``train``'s ε defaults, in place: under ``--noisy`` each
    ε flag left unset becomes 0 (NoisyNet is the exploration), with JAX's
    note on stderr; otherwise ``--eps-start`` 1.0 and ``--eps-end`` 0.05."""
    if opts.noisy:
        if opts.eps_start is None and opts.eps_end is None:
            print("# --noisy: eps schedule -> 0 (learned exploration)", file=sys.stderr)
        elif opts.eps_start is None or opts.eps_end is None:
            print("# --noisy: unset eps flag backfilled with 0.0", file=sys.stderr)
        opts.eps_start = 0.0 if opts.eps_start is None else opts.eps_start
        opts.eps_end = 0.0 if opts.eps_end is None else opts.eps_end
    if opts.eps_start is None:
        opts.eps_start = 1.0
    if opts.eps_end is None:
        opts.eps_end = 0.05


def train(opts, stop_at: int | None = None) -> float:
    """The JAX ``train`` over the port's pieces → the last eval's mean
    episode length; ``ddpg.train``'s shape with DQN's pieces.

    Builds the discrete-action config, the training and eval vector envs
    (on the card unless ``--device cpu``) and :func:`init_state` (after the
    ε defaults, :func:`fill_eps_defaults`), checks an n-step run's replay
    (:func:`common.check_nstep_capacity`), restores the newest checkpoint of
    ``--ckpt-dir`` if there is one, then runs segments ``start ..
    --num-train-batches`` with their evals, metrics (the ``train`` event's
    ``loss``, ``eps``, ``mean_reward`` as in JAX) and checkpoints
    (:func:`common.train_segments`).  ``--eval-only`` evaluates the restored
    policy instead.  ``stop_at`` (not a flag): end after that segment, the
    learning-rate schedule and PER's β keeping ``--num-train-batches``'s
    length.

    ``--num-devices`` N > 1 and ``--coordinator/--num-processes/
    --process-id``: the data-parallel run of ``ddpg.train`` (the ranks'
    env and replay shards, the per-rank batch ``--batch-size // N``, the
    gradients and metrics averaged over the ranks, rank 0's eval)."""
    mesh = common.maybe_init_multihost(opts)
    if common.launches_ranks(opts, mesh):
        return distributed.launch(opts, train, stop_at)
    dev = common.rank_device(opts, mesh)
    config = config_from_opts(opts, discrete_actions=True)
    raster = common.resolve_render_raster(config, opts)
    venv, init_venv = common.rank_venvs(config, opts, dev, raster, mesh)
    eval_venv = common.make_venv(config, opts.num_eval, device=dev, render_raster=raster)
    fill_eps_defaults(opts)
    logger = MetricsLogger(opts.metrics_jsonl, tb_dir=opts.tb_dir)
    st = init_state(opts, config, init_venv, lr=common.make_lr(opts, opts.learning_rate),
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
    act = greedy_act(st.q)
    if opts.eval_only:
        return common.run_eval_only(opts, logger, restored, eval_venv, act)

    segment = make_segment(
        venv, gamma=opts.gamma, tau=opts.tau, batch_size=common.rank_batch(opts, mesh),
        warmup_steps=opts.warmup_steps, steps_per_segment=opts.steps_per_segment,
        eps_start=opts.eps_start, eps_end=opts.eps_end, eps_decay_steps=opts.eps_decay_steps,
        reward_scale=opts.reward_scale, double_q=opts.double_q,
        per_alpha=opts.per_alpha if opts.per else None, per_beta0=opts.per_beta0,
        per_total_steps=opts.num_train_batches * opts.steps_per_segment, per_eps=opts.per_eps,
        n_step=opts.n_step, c51_atoms=opts.c51, c51_vmin=opts.c51_vmin,
        c51_vmax=opts.c51_vmax, noisy=opts.noisy, grad_clip=opts.grad_clip,
        group=mesh and mesh.group)

    def fields(metrics: dict) -> dict:
        return {"loss": float(metrics["loss"]), "eps": float(metrics["eps"]),
                "mean_reward": float(metrics["reward"])}

    end = opts.num_train_batches if stop_at is None else min(stop_at, opts.num_train_batches)
    return common.train_segments(
        opts, st, common.distribute(segment, mesh, SHARDED_FIELDS, METRIC_KEYS), venv,
        eval_venv, act, logger, fields, start_segment, end, mesh, SHARDED_FIELDS)


def make_parser():
    parser = common.make_parser("DQN agent on cartpole++ (PyTorch/CUDA port)")
    add_dqn_opts(parser)
    return parser


def main(argv=None, stop_at: int | None = None) -> float:
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    return train(opts, stop_at=stop_at)


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports (as the JAX CLI does).
    from cartpoleplusplus_tpu_torch.agents.dqn import main as _main

    _main()
