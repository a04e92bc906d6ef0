"""Random-action agent: the env's smoke runner and event-log generator.
Port of cartpoleplusplus_tpu.agents.random_agent.

Rolls uniformly random actions through the per-env step, prints episode
stats as jsonl metrics, and with ``--event-log-out`` records every episode
(``--record-renders`` attaches each step's camera frames as PNGs)::

    python -m cartpoleplusplus_tpu_torch.agents.random_agent --num-episodes 10 \\
        --event-log-out /tmp/random.events [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env import config as env_config
from cartpoleplusplus_tpu_torch.env.config import NUM_DISCRETE_ACTIONS, config_from_opts
from cartpoleplusplus_tpu_torch.utils import event_log as event_log_mod
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger


def run_episode(config, scene, step_fn, reset_fn, generator: torch.Generator,
                collect: bool = False, render_fn=None, policy=None):
    """Roll one episode on the host loop → (steps, total_reward, events).

    ``reset_fn(generator) → (state, obs)`` and ``step_fn(state, action) →
    (state, obs, reward, done)`` are the per-env env's.  Actions are
    uniform draws from ``generator`` (discrete indices, or (2,) in
    [-1, 1)), or ``policy(obs) → action``.  With ``collect`` each step
    becomes an event: the post-step poses, the (2, 6) velocity rows
    [linear | angular] per body, the action, reward and done flag, and
    ``render_fn(rigid) → [(H, W, 3) images]`` when given.  This is the one
    owner of that convention; ``common.record_eval_episodes`` rolls its
    greedy episodes through here.
    """
    events = []
    state, obs = reset_fn(generator)
    dev = state.steps.device
    total_reward, steps, done = 0.0, 0, False
    while not done and steps < config.max_episode_len:
        if policy is not None:
            action = policy(obs)
        elif config.discrete_actions:
            action = torch.randint(0, NUM_DISCRETE_ACTIONS, (), generator=generator, device=dev)
        else:
            action = 2.0 * torch.rand((2,), generator=generator, device=dev) - 1.0
        state, obs, reward, done_t = step_fn(state, action)
        done = bool(done_t)
        total_reward += float(reward)
        steps += 1
        if collect:
            r = state.rigid
            pose = torch.cat([r.pos, r.quat], dim=-1).cpu().numpy()
            vels = torch.cat([r.vel, r.ang], dim=-1).cpu().numpy()
            renders = render_fn(r) if render_fn else None
            events.append(event_log_mod.make_event(
                pose[0], pose[1], action.cpu().numpy(), float(reward), done,
                velocities=vels, renders=renders))
    return steps, total_reward, events


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="random-action smoke agent (PyTorch/CUDA port)")
    env_config.add_opts(parser)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-episodes", type=int, default=10)
    parser.add_argument("--continuous", action="store_true",
                        help="sample continuous 2D actions instead of discrete")
    parser.add_argument("--event-log-out", type=str, default=None)
    parser.add_argument("--record-renders", action="store_true",
                        help="attach per-camera PNG renders to logged events")
    parser.add_argument("--metrics-jsonl", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device: CUDA unless 'cpu' is asked for")
    return parser


def main(argv=None) -> list[int]:
    """Run ``--num-episodes`` random episodes → their lengths.  Logs an
    ``episode`` event per episode and a ``summary``; ``--record-renders``
    renders each step's state (the config's cameras, pooled as configured)
    by the slab cast, as the JAX agent does: K4 at one env on the card, its
    plain version on the CPU."""
    opts = make_parser().parse_args(argv)
    print(f"OPTS {vars(opts)}", file=sys.stderr)
    dev = resolve_device(opts.device)
    config = config_from_opts(opts, discrete_actions=not opts.continuous)
    scene = cartpole.scene_for(config)
    reset_fn = lambda g: cartpole.reset(config, scene, g, device=dev)
    step_fn = lambda s, a: cartpole.step(config, scene, s, a)

    render_fn = None
    if opts.record_renders:
        from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer
        from cartpoleplusplus_tpu_torch.render.raycast import frame_to_images

        renderer = Renderer(config, dev)

        def render_fn(rigid):
            frame = renderer.render_batched(scene, rigid.map(lambda x: x[None]))[0]
            return list(frame_to_images(config, frame))

    log = event_log_mod.EventLog(opts.event_log_out) if opts.event_log_out else None
    metrics = MetricsLogger(opts.metrics_jsonl, tb_dir=getattr(opts, "tb_dir", None))
    generator = torch.Generator(device=dev).manual_seed(opts.seed)
    lengths = []
    for ep in range(opts.num_episodes):
        steps, total_reward, events = run_episode(
            config, scene, step_fn, reset_fn, generator, collect=log is not None,
            render_fn=render_fn)
        lengths.append(steps)
        metrics.log("episode", idx=ep, steps=steps, total_reward=total_reward)
        if log:
            log.add_episode(events)
    metrics.log("summary", episodes=opts.num_episodes, mean_len=float(np.mean(lengths)),
                max_len=int(np.max(lengths)))
    if log:
        log.close()
    metrics.close()
    return lengths


if __name__ == "__main__":
    # Re-enter through the canonical module, so this run's classes are the
    # ones every other module imports.
    from cartpoleplusplus_tpu_torch.agents.random_agent import main as _main

    _main()
