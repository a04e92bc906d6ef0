"""Fidelity harness: replay a recorded trajectory through the physics and
diff; port of cartpoleplusplus_tpu.utils.fidelity.

Given an event log with velocity rows (written by either package's random
agent or ``--event-log-out``), the recorded dynamic state of step 0 is
restored, the recorded actions are applied again through the per-env step
(``env/cartpole.step`` on the AoS engine, on the device asked for), and
the per-step pose divergence is reported.

    python -m cartpoleplusplus_tpu_torch.utils.fidelity --log-file traj.events \\
        [--action-repeats 3 --steps-per-repeat 5] [--episode 0] [--json] \\
        [--tolerance 1e-4] [--device cpu]

Exit code 1 if the largest divergence exceeds ``--tolerance``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.utils import event_log


def restore_state(ev, device=None) -> RigidState:
    """Event → one env's RigidState (2, …) on ``device`` (CUDA unless the
    caller asks for the CPU); the log must hold velocity rows."""
    if not ev.cart.linear_velocity:
        raise ValueError(
            "event log lacks velocity fields; re-record with this framework "
            "(make_event velocities=...) to enable re-simulation"
        )
    dev = resolve_device(device)
    rows = lambda cart, pole: torch.tensor([list(cart), list(pole)], dtype=torch.float32,
                                           device=dev)
    return RigidState(pos=rows(ev.cart.position, ev.pole.position),
                      quat=rows(ev.cart.orientation, ev.pole.orientation),
                      vel=rows(ev.cart.linear_velocity, ev.pole.linear_velocity),
                      ang=rows(ev.cart.angular_velocity, ev.pole.angular_velocity))


def resim_episode(episode, config: CartpoleConfig, device=None) -> tuple[np.ndarray, np.ndarray]:
    """Re-simulate from step 0's state on ``device`` → (recorded, resimmed)
    poses (T, 2, 7), cart first."""
    dev = resolve_device(device)
    scene = cartpole.scene_for(config)
    recorded = event_log.episode_poses(episode)
    state = EnvState(rigid=restore_state(episode.event[0], dev),
                     steps=torch.zeros((), dtype=torch.int32, device=dev),
                     done=torch.zeros((), dtype=torch.bool, device=dev))
    out = [recorded[0]]
    for ev in episode.event[1:]:
        action = np.asarray(list(ev.action), np.float32)
        action = (torch.tensor(int(action[0]), dtype=torch.int32, device=dev)
                  if config.discrete_actions else torch.from_numpy(action).to(dev))
        state, _, _, _ = cartpole.step(config, scene, state, action)
        out.append(torch.cat([state.rigid.pos, state.rigid.quat], dim=-1).cpu().numpy())
    return recorded, np.stack(out)


def divergence_report(recorded: np.ndarray, resim: np.ndarray) -> dict:
    pos_err = np.linalg.norm(recorded[:, :, :3] - resim[:, :, :3], axis=-1)
    quat_err = np.abs(recorded[:, :, 3:] - resim[:, :, 3:]).max(axis=-1)
    return {
        "steps": int(recorded.shape[0]),
        "max_pos_err": float(pos_err.max()),
        "mean_pos_err": float(pos_err.mean()),
        "max_quat_err": float(quat_err.max()),
        "final_pos_err": float(pos_err[-1].max()),
    }


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="trajectory fidelity check (PyTorch/CUDA port)")
    parser.add_argument("--log-file", required=True)
    parser.add_argument("--episode", type=int, default=None,
                        help="episode index (default: all)")
    parser.add_argument("--action-repeats", type=int, default=3)
    parser.add_argument("--steps-per-repeat", type=int, default=5)
    parser.add_argument("--action-force", type=float, default=50.0)
    parser.add_argument("--continuous", action="store_true")
    parser.add_argument("--tolerance", type=float, default=None,
                        help="fail (exit 1) if max_pos_err exceeds this")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device: CUDA unless 'cpu' is asked for")
    return parser


def main(argv=None) -> float:
    """Re-simulate the log's episodes (or ``--episode``'s alone) and print
    one report each → the largest ``max_pos_err``."""
    opts = make_parser().parse_args(argv)
    dev = resolve_device(opts.device)
    config = CartpoleConfig(
        discrete_actions=not opts.continuous,
        action_repeats=opts.action_repeats,
        steps_per_repeat=opts.steps_per_repeat,
        action_force=opts.action_force,
        max_episode_len=10**9,  # never truncate a replay
    )
    if opts.episode is not None:
        # One episode by the header scan: the others are never decoded.
        offsets = event_log.index_event_log(opts.log_file)
        episodes = [(opts.episode,
                     event_log.read_episode_at(opts.log_file, offsets[opts.episode]))]
    else:
        episodes = enumerate(event_log.read_event_log(opts.log_file))

    worst = 0.0
    for i, ep in episodes:
        if len(ep.event) < 2:
            continue
        recorded, resim = resim_episode(ep, config, dev)
        report = {"episode": i, **divergence_report(recorded, resim)}
        worst = max(worst, report["max_pos_err"])
        if opts.json:
            print(json.dumps(report))
        else:
            print(
                f"episode {i}: steps={report['steps']} "
                f"max_pos_err={report['max_pos_err']:.2e} "
                f"mean_pos_err={report['mean_pos_err']:.2e} "
                f"final_pos_err={report['final_pos_err']:.2e}"
            )
    if opts.tolerance is not None and worst > opts.tolerance:
        print(f"FAIL: max divergence {worst:.3e} > {opts.tolerance}", file=sys.stderr)
        sys.exit(1)
    return worst


if __name__ == "__main__":
    from cartpoleplusplus_tpu_torch.utils.fidelity import main as _main

    _main()
