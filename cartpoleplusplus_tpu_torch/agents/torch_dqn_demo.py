"""Third-party agent demo: a plain PyTorch DQN driven through the gym env.
Port of the JAX package's agents/torch_dqn_demo.py.

A self-contained DQN that touches the port only through
``env.gym_env.Cartpole``'s reset/step/spaces surface, as an external
agent library would: if it trains against the env unchanged, any
gym-convention library will.  The env runs on ``--device`` (the card
unless ``cpu`` is asked for); the learner takes its numpy observations on
the CPU.

Usage:
  python -m cartpoleplusplus_tpu_torch.agents.torch_dqn_demo --episodes 300 [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import random
import sys

import numpy as np


def build_env(opts):
    """The env as an external user builds it: through gym_env."""
    from cartpoleplusplus_tpu_torch.env.config import config_from_opts
    from cartpoleplusplus_tpu_torch.env.gym_env import Cartpole

    config = config_from_opts(opts, discrete_actions=True)
    return Cartpole(config, seed=opts.seed, device=getattr(opts, "device", None))


def main(argv=None) -> float:
    import torch
    import torch.nn as nn

    from cartpoleplusplus_tpu_torch.env import config as env_config

    parser = argparse.ArgumentParser(
        description="PyTorch DQN over the cartpole++ gym env (third-party-agent "
                    "interop demo, PyTorch/CUDA port)"
    )
    env_config.add_opts(parser)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--episodes", type=int, default=300)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--replay-capacity", type=int, default=20000)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--eps-start", type=float, default=1.0)
    parser.add_argument("--eps-end", type=float, default=0.05)
    parser.add_argument("--eps-decay-episodes", type=int, default=150)
    parser.add_argument("--target-sync-steps", type=int, default=200)
    parser.add_argument("--metrics-jsonl", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="the env's torch device: CUDA unless 'cpu' is asked for")
    opts = parser.parse_args(argv)

    torch.manual_seed(opts.seed)
    random.seed(opts.seed)
    np.random.seed(opts.seed)

    env = build_env(opts)
    obs_dim = int(np.prod(env.observation_space.shape))
    num_actions = env.action_space.n

    def mlp():
        return nn.Sequential(
            nn.Linear(obs_dim, 100), nn.ReLU(),
            nn.Linear(100, 50), nn.ReLU(),
            nn.Linear(50, num_actions),
        )

    qnet, target = mlp(), mlp()
    target.load_state_dict(qnet.state_dict())
    opt = torch.optim.Adam(qnet.parameters(), lr=opts.learning_rate)
    replay = collections.deque(maxlen=opts.replay_capacity)

    logger = None
    if opts.metrics_jsonl:
        from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger

        logger = MetricsLogger(opts.metrics_jsonl)

    global_step = 0
    recent = collections.deque(maxlen=20)
    for ep in range(opts.episodes):
        eps = opts.eps_end + (opts.eps_start - opts.eps_end) * max(
            0.0, 1.0 - ep / max(opts.eps_decay_episodes, 1)
        )
        obs = env.reset().reshape(-1).astype(np.float32)
        ep_len, ep_rew, done = 0, 0.0, False
        while not done:
            if random.random() < eps:
                action = env.action_space.sample()
            else:
                with torch.no_grad():
                    q = qnet(torch.from_numpy(obs))
                action = int(q.argmax().item())
            obs2, reward, done, _ = env.step(action)
            obs2 = obs2.reshape(-1).astype(np.float32)
            replay.append((obs, action, reward, obs2, float(done)))
            obs = obs2
            ep_len += 1
            ep_rew += reward
            global_step += 1

            if len(replay) >= opts.batch_size:
                batch = random.sample(replay, opts.batch_size)
                s, a, r, s2, t = map(np.stack, zip(*batch))
                s = torch.from_numpy(s)
                s2 = torch.from_numpy(s2)
                a = torch.from_numpy(a.astype(np.int64))
                r = torch.from_numpy(r.astype(np.float32))
                t = torch.from_numpy(t.astype(np.float32))
                with torch.no_grad():
                    y = r + opts.gamma * (1.0 - t) * target(s2).max(dim=1).values
                q = qnet(s).gather(1, a[:, None]).squeeze(1)
                loss = nn.functional.smooth_l1_loss(q, y)
                opt.zero_grad()
                loss.backward()
                opt.step()
            if global_step % opts.target_sync_steps == 0:
                target.load_state_dict(qnet.state_dict())

        recent.append(ep_len)
        mean20 = sum(recent) / len(recent)
        if logger:
            logger.log("train", episode=ep, ep_len=ep_len, ep_rew=ep_rew,
                       eps=round(eps, 3), mean20=round(mean20, 2))
        if (ep + 1) % 10 == 0:
            print(
                f"episode {ep + 1}/{opts.episodes} len={ep_len} "
                f"eps={eps:.2f} mean20={mean20:.1f}",
                file=sys.stderr,
            )
    if logger:
        logger.close()
    return sum(recent) / len(recent)


if __name__ == "__main__":
    main()
