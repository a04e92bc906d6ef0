"""LRPG: port of cartpoleplusplus_tpu.agents.lrpg — likelihood-ratio policy
gradient (REINFORCE) over the 5 discrete actions, and its program: the JAX
CLI (``add_lrpg_opts``), ``train`` with jsonl metrics, periodic greedy
evals and checkpoints (resume, ``--ckpt-best``, ``--eval-only``), and
``main``::

    python -m cartpoleplusplus_tpu_torch.agents.lrpg --num-train-batches ...

One update, in the JAX order: a fresh reset of every env (K2, and K4 for
pixel configs), one episode per env of ``--max-episode-len`` steps with
no auto-reset under the current softmax policy (K1, and K3), each env's
steps after its episode ended masked out; reward-to-go returns whitened
over the valid steps; one plain Adam step on ``−Σ log π(a|s)·adv / Σ
valid``.  The JAX version compiles the update into one program; here it is
a Python loop of PyTorch calls and kernel launches.  Actions are sampled
as ``jax.random.categorical`` samples them, the argmax of the logits plus
Gumbel noise, and the noise can be given as an argument, so a test can
feed the JAX version's.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import NUM_DISCRETE_ACTIONS, config_from_opts
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
from cartpoleplusplus_tpu_torch.models.networks import DiscretePolicy
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger
from cartpoleplusplus_tpu_torch.utils.optim import Adam

METRIC_KEYS = ("loss", "ep_len", "ep_rew")
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass
class LRPGState:
    """Everything the training loop carries: the policy and its Adam,
    updated in place, the generator and ``update``, a host int.  No env
    state: every update resets every env."""

    policy: DiscretePolicy
    opt: Adam
    generator: torch.Generator
    update: int = 0

    _NETS = ("policy",)

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, under the JAX state's names where
        it has them: ``params`` (the policy's), ``opt_state``, the
        generator's state and ``update``."""
        return {"params": self.policy.state_dict(), "opt_state": self.opt.state_dict(),
                "generator": self.generator.get_state(), "update": self.update}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents in place."""
        self.policy.load_state_dict(sd["params"])
        self.opt.load_state_dict(sd["opt_state"])
        self.generator.set_state(sd["generator"])
        self.update = int(sd["update"])


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``−log(−log(u))``, ``u`` uniform on [tiny, 1)
    (``jax.random.gumbel``'s draw)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def rollout_batch(venv: VectorCartpole, policy: DiscretePolicy, generator: torch.Generator,
                  noise: Optional[torch.Tensor] = None, reset=None):
    """One episode per env slot under the stochastic policy → (obs, action,
    reward, valid), each stacked (T, E, …) over T = ``max_episode_len``;
    ``valid`` masks the steps after each env's episode ended (the shape
    stays static, the data masked).

    ``noise`` (T, E, actions): the Gumbel noise of the samples ``argmax(logits
    + noise)``; ``reset``: the reset's ``(theta, jitter)``.  Each one not
    given is drawn from ``generator``."""
    config, dev = venv.config, venv.device
    states, obs = venv.reset(generator, *(reset if reset is not None else (None, None)))
    alive = torch.ones((venv.num_envs,), dtype=torch.bool, device=dev)
    out = ([], [], [], [])
    for t in range(config.max_episode_len):
        logits = policy(obs)
        n = noise[t].to(dev) if noise is not None else gumbel(logits.shape, generator, dev)
        action = torch.argmax(logits + n, dim=-1)
        states, nobs, reward, done = cartpole.step_batched(config, venv.scene, states, action,
                                                           venv.sim_fn)
        for buf, x in zip(out, (obs, action, reward, alive)):
            buf.append(x)
        obs, alive = nobs, alive & ~done
    return tuple(torch.stack(buf) for buf in out)


def discounted_returns(rewards: torch.Tensor, valid: torch.Tensor, gamma: float) -> torch.Tensor:
    """Reward-to-go per step, Rₜ = Σ_{k≥t} γ^{k−t} r_k, over (T, E) rewards
    masked by ``valid``."""
    rewards = rewards * valid
    out = torch.empty_like(rewards)
    g = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        g = rewards[t] + gamma * g
        out[t] = g
    return out


def loss_fn(policy: DiscretePolicy, obs: torch.Tensor, action: torch.Tensor,
            ret: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``−Σ log π(a|s)·adv·w / max(Σw, 1)`` over the (T, E) batch, ``adv``
    the returns whitened over the valid steps (mean and variance weighted
    by ``w`` = ``valid``, ``rsqrt(var + 1e-6)``)."""
    t, e = action.shape
    logits = policy(obs.reshape((t * e,) + obs.shape[2:]))
    logp = F.log_softmax(logits, dim=-1).gather(1, action.reshape(-1, 1))[:, 0]
    w = valid.reshape(-1).to(torch.float32)
    r = ret.reshape(-1)
    total = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(r * w) / total
    var = torch.sum(w * (r - mean) ** 2) / total
    adv = (r - mean) * torch.rsqrt(var + 1e-6)
    return -torch.sum(logp * adv * w) / total


def make_train_step(venv: VectorCartpole, gamma: float, group=None):
    """One LRPG update → ``train_step(st, noise=None, reset=None) ->
    metrics``, updating ``st`` in place and advancing ``st.update``
    (``noise`` and ``reset`` as :func:`rollout_batch` takes them).
    ``metrics``: device scalars ``loss``, ``ep_len`` (valid steps per env)
    and ``ep_rew`` (valid reward per env).  With a data-parallel ``group``
    the gradients are averaged over its ranks before the step."""
    resolve_device(venv.device)

    def train_step(st: LRPGState, noise=None, reset=None) -> dict:
        obs, action, reward, valid = rollout_batch(venv, st.policy, st.generator, noise, reset)
        valid_f = valid.to(torch.float32)
        ret = discounted_returns(reward, valid_f, gamma)
        loss = loss_fn(st.policy, obs, action, ret, valid)
        st.opt.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            distributed.allreduce_mean_([p.grad for p in st.policy.parameters()], group)
        st.opt.step()
        st.update += 1
        e = valid.shape[1]
        return {"loss": loss.detach(), "ep_len": valid_f.sum() / e,
                "ep_rew": torch.sum(reward * valid_f) / e}

    return train_step


def greedy_act(policy: DiscretePolicy) -> common.GreedyPolicy:
    """obs (E, …) → greedy action indices argmax(logits) (E,)."""
    return common.GreedyPolicy(policy, lambda net, obs: torch.argmax(net(obs), dim=-1))


def init_state(opts, config, venv: VectorCartpole, lr: float = 1e-3,
               hidden: Sequence[int] = DEFAULT_HIDDEN, pixel_pool: int = 1,
               pixel_encoder: str = "dense") -> LRPGState:
    """Fresh training state on ``venv``'s device: a :class:`DiscretePolicy`
    initialised from ``opts.seed``, a plain Adam (no clip, no schedule, as
    in JAX) and a device generator seeded with ``opts.seed``."""
    dev = venv.device
    policy = DiscretePolicy(config.obs_shape, num_actions=NUM_DISCRETE_ACTIONS,
                            use_raw_pixels=config.use_raw_pixels, height=config.obs_height,
                            width=config.obs_width, hidden=tuple(hidden), pixel_pool=pixel_pool,
                            device=dev, generator=torch.Generator().manual_seed(opts.seed),
                            pixel_encoder=pixel_encoder)
    return LRPGState(policy=policy, opt=Adam(policy.parameters(), lr=lr),
                     generator=torch.Generator(device=dev).manual_seed(opts.seed))


def add_lrpg_opts(parser) -> None:
    """LRPG's flags (the JAX ``add_lrpg_opts``)."""
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks (one device each) to roll out env shards on; gradients "
                             "are averaged across them")


def train(opts, stop_at: int | None = None) -> float:
    """The JAX ``train`` over the port's pieces → the last eval's mean
    episode length: the discrete-action config, the vector envs (on the
    card unless ``--device cpu``) and :func:`init_state`, restore-if-present,
    then updates from the restored ``update`` to ``--num-train-batches``
    (:func:`common.train_updates`; the ``train`` event's fields ``loss``,
    ``train_ep_len``, ``train_ep_rew`` as in JAX).  ``--eval-only``
    evaluates the restored policy instead.  ``stop_at`` (not a flag): end
    after that update.

    ``--num-devices`` N > 1 and ``--coordinator/--num-processes/
    --process-id``: each rank rolls out ``--num-envs / N`` episodes from
    its own generator (nothing else is sharded: every update resets every
    env); the gradients and metrics are averaged over the ranks; rank 0
    evaluates."""
    mesh = common.maybe_init_multihost(opts)
    if common.launches_ranks(opts, mesh, replay=False):
        return distributed.launch(opts, train, stop_at)
    dev = common.rank_device(opts, mesh)
    config = config_from_opts(opts, discrete_actions=True)
    raster = common.resolve_render_raster(config, opts)
    world = 1 if mesh is None else mesh.world
    venv = common.make_venv(config, opts.num_envs // world, device=dev, render_raster=raster)
    eval_venv = common.make_venv(config, opts.num_eval, device=dev, render_raster=raster)
    logger = MetricsLogger(opts.metrics_jsonl, tb_dir=opts.tb_dir)
    st = init_state(opts, config, venv, lr=opts.learning_rate, hidden=opts.hidden,
                    pixel_pool=opts.pixel_pool, pixel_encoder=opts.pixel_encoder)
    common.shard_start(st, mesh, ())
    restored = None
    if opts.ckpt_dir:
        st, restored = common.restore_for_startup(opts, st, mesh)
        if restored is not None:
            logger.log("restore", step=restored)
    act = greedy_act(st.policy)
    if opts.eval_only:
        return common.run_eval_only(opts, logger, restored, eval_venv, act)

    def fields(update: int, metrics: dict) -> dict:
        return {"loss": float(metrics["loss"]), "train_ep_len": float(metrics["ep_len"]),
                "train_ep_rew": float(metrics["ep_rew"])}

    end = opts.num_train_batches if stop_at is None else min(stop_at, opts.num_train_batches)
    train_step = common.distribute(make_train_step(venv, opts.gamma, group=mesh and mesh.group),
                                   mesh, (), METRIC_KEYS)
    return common.train_updates(opts, st, train_step, eval_venv, act, logger, fields,
                                st.update, end, mesh)


def make_parser():
    parser = common.make_parser("LRPG (REINFORCE) agent on cartpole++ (PyTorch/CUDA port)")
    add_lrpg_opts(parser)
    return parser


def main(argv=None, stop_at: int | None = None) -> float:
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    return train(opts, stop_at=stop_at)


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports (as the JAX CLI does).
    from cartpoleplusplus_tpu_torch.agents.lrpg import main as _main

    _main()
