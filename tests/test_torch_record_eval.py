"""``agents.common.record_eval_episodes`` (``--event-log-out``) against the
JAX package: JAX tests/test_record_eval.py's two cases.  Greedy episodes
land in an event log of the recorded lengths, which JAX's fidelity
harness (``utils/fidelity.resim_episode``) re-simulates from each log's
first event on JAX's own engine: within 1e-5 in position and 1e-4 in the
quaternion, low-dim and pixel configs (raster frames) alike; the pixel
policy acts on the frames of the render kernels' plain versions.  Then
``--event-log-out`` in each of the six agent CLIs, after a toy ``train``
and under ``--eval-only``.
"""

import json
import shlex

import pytest
import torch

from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.utils import event_log as jevent_log
from cartpoleplusplus_tpu.utils import fidelity
from cartpoleplusplus_tpu_torch.agents import common, ddpg, dqn, lrpg, naf, ppo, sac
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.utils.event_log import read_event_log

torch.set_num_threads(2)


def _drive(tmp_path, kw, act_fn):
    config = CartpoleConfig(**kw)
    path = str(tmp_path / "eval.events")
    seen = []

    def act(obs):
        seen.append((tuple(obs.shape), obs.dtype))
        return act_fn(obs)

    lengths = common.record_eval_episodes(config, act, path, num_episodes=2, seed=3,
                                          raster=config.use_raw_pixels, device="cpu")
    assert len(lengths) == 2 and all(1 <= n <= config.max_episode_len for n in lengths)
    assert seen[0] == ((1,) + tuple(config.obs_shape),
                       torch.uint8 if config.use_raw_pixels else torch.float32)
    episodes = list(jevent_log.read_event_log(path))
    assert [len(ep.event) for ep in episodes] == lengths
    for ep in episodes:
        recorded, resim = fidelity.resim_episode(ep, JConfig(**kw))
        report = fidelity.divergence_report(recorded, resim)
        assert report["max_pos_err"] <= 1e-5 and report["max_quat_err"] <= 1e-4, report
    return episodes


def test_record_lowdim_resimulates(tmp_path):
    """A discrete greedy policy (argmax of a bias the act function holds,
    as JAX's test reads its params) over low-dim poses."""
    bias = torch.zeros(5)
    _drive(tmp_path, dict(discrete_actions=True, max_episode_len=20),
           lambda obs: torch.argmax(bias[None] + torch.zeros((obs.shape[0], 5)), dim=-1))


def test_record_pixels_raster(tmp_path):
    """A continuous policy over raster pixel frames (20×20)."""
    w = torch.zeros(2)
    episodes = _drive(tmp_path, dict(discrete_actions=False, use_raw_pixels=True,
                                     max_episode_len=8, render_width=20, render_height=20),
                      lambda obs: torch.tanh(w).expand(obs.shape[0], 2))
    assert len(episodes[0].event) >= 1
    assert list(episodes[0].event[0].action) == [0.0, 0.0]


_TOY = "--num-envs 4 --num-eval 4 --action-repeats 2 --steps-per-repeat 2 --max-episode-len 6"
_OFF_POLICY = ("--num-train-batches 1 --steps-per-segment 2 --batch-size 4 "
               "--replay-capacity 16 --warmup-steps 0")
# agent → (module, its toy argv beside _TOY)
AGENTS = {
    "ddpg": (ddpg, _OFF_POLICY), "sac": (sac, _OFF_POLICY), "dqn": (dqn, _OFF_POLICY),
    "naf": (naf, _OFF_POLICY),
    "ppo": (ppo, "--num-train-batches 1 --rollout-steps 4 --ppo-minibatches 2 --ppo-epochs 1 "
                 "--hidden 16 16"),
    "lrpg": (lrpg, "--num-train-batches 1 --hidden 16 16"),
}


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_event_log_out_in_every_cli(agent, tmp_path):
    """``--event-log-out`` after a toy ``train`` and under ``--eval-only``
    of its checkpoint: each log holds 3 greedy episodes, logged as an
    ``event_log`` event of their count and lengths, each ending done within
    ``--max-episode-len``; the eval-only run replays the same episodes."""
    module, extra = AGENTS[agent]
    jsonl = tmp_path / "m.jsonl"
    argv = shlex.split(f"{_TOY} {extra}") + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--metrics-jsonl", str(jsonl)]
    logs = [str(tmp_path / "train.events"), str(tmp_path / "eval.events")]
    module.main(argv + ["--event-log-out", logs[0]])
    module.main(argv + ["--eval-only", "--event-log-out", logs[1]])
    events = [json.loads(line) for line in jsonl.read_text().splitlines()]
    logged = [e for e in events if e["event"] == "event_log"]
    assert len(logged) == 2
    assert [e["event"] for e in events][-4:] == ["event_log", "restore", "eval_only", "event_log"]
    runs = [list(read_event_log(path)) for path in logs]
    for line, episodes in zip(logged, runs):
        assert line["episodes"] == len(episodes) == 3
        assert line["lengths"] == [len(ep.event) for ep in episodes]
        assert all(1 <= len(ep.event) <= 6 and ep.event[-1].done for ep in episodes)
    assert [ep.SerializeToString() for ep in runs[1]] == [
        ep.SerializeToString() for ep in runs[0]]
