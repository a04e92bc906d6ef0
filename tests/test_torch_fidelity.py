"""The port's fidelity harness (``utils/fidelity.py``) against the JAX
package's: on event logs written by either package's random agent
(discrete and continuous actions), the port's ``resim_episode`` on the CPU
lands on JAX's re-simulation within the AoS engine's bounds against JAX
(tests/test_torch_aos.py): the first 5 steps within the one-substep bound
1e-5, every step within tests/test_soa.py's long-horizon bounds (position
2e-3, quaternion 5e-3); ``divergence_report`` equals JAX's on the same
arrays; the CLI's ``--tolerance`` exit codes and ``--episode``."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.agents import random_agent as jrandom_agent
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.utils import event_log as jevent_log
from cartpoleplusplus_tpu.utils import fidelity as jfidelity
from cartpoleplusplus_tpu_torch.agents import random_agent
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.utils import event_log, fidelity

torch.set_num_threads(2)

EARLY_STEPS, EARLY_ATOL = 5, 1e-5
POS_ATOL, QUAT_ATOL = 2e-3, 5e-3
AGENT_ARGV = ["--num-episodes", "3", "--max-episode-len", "20", "--seed", "1"]


def _log(tmp_path, writer, continuous):
    path = str(tmp_path / f"{writer}.events")
    argv = AGENT_ARGV + ["--event-log-out", path] + (["--continuous"] if continuous else [])
    if writer == "port":
        random_agent.main(argv + ["--device", "cpu"])
    else:
        jrandom_agent.main(argv)
    return path


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resim_matches_jax(writer, continuous, tmp_path):
    path = _log(tmp_path, writer, continuous)
    kw = dict(discrete_actions=not continuous, max_episode_len=10**9)
    episodes = list(event_log.read_event_log(path))
    assert len(episodes) == 3 and max(len(ep.event) for ep in episodes) > EARLY_STEPS
    for ep in episodes:
        recorded, resim = fidelity.resim_episode(ep, CartpoleConfig(**kw), "cpu")
        jrecorded, jresim = jfidelity.resim_episode(ep, JConfig(**kw))
        np.testing.assert_array_equal(recorded, jrecorded)
        assert resim.shape == jresim.shape == (len(ep.event), 2, 7)
        err = np.abs(resim - jresim)
        assert err[:EARLY_STEPS].max() <= EARLY_ATOL, err[:EARLY_STEPS].max()
        assert err[..., :3].max() <= POS_ATOL and err[..., 3:].max() <= QUAT_ATOL
        # The writer's own engine re-simulates its log exactly; the other
        # package's within the same bounds.
        own = resim if writer == "port" else jresim
        np.testing.assert_array_equal(own, recorded)


def test_divergence_report_equals_jax():
    rng = np.random.default_rng(0)
    recorded = rng.normal(size=(9, 2, 7)).astype(np.float32)
    resim = recorded + rng.normal(scale=1e-3, size=recorded.shape).astype(np.float32)
    got = fidelity.divergence_report(recorded, resim)
    assert got == jfidelity.divergence_report(recorded, resim)
    assert got["steps"] == 9 and got["max_pos_err"] > 0


def _main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        worst = fidelity.main(argv + ["--device", "cpu"])
    return worst, out.getvalue()


def _perturbed(tmp_path):
    """The port's log with episode 1's third event moved by 1 cm in x."""
    path = _log(tmp_path, "port", False)
    episodes = list(event_log.read_event_log(path))
    episodes[1].event[2].cart.position[0] += 0.01
    out = str(tmp_path / "perturbed.events")
    log = event_log.EventLog(out)
    for ep in episodes:
        log.add_episode(ep.event)
    log.close()
    return out


def test_cli_tolerance_exit_codes(tmp_path, capsys):
    path = _perturbed(tmp_path)
    worst, text = _main(["--log-file", path, "--tolerance", "0.02"])
    assert 0.009 < worst < 0.011 and text.count("episode ") == 3
    with pytest.raises(SystemExit) as e:
        _main(["--log-file", path, "--tolerance", "1e-3"])
    assert e.value.code == 1
    assert "FAIL: max divergence" in capsys.readouterr().err
    # The JAX CLI on the same log reads the same divergence.
    jout = io.StringIO()
    with redirect_stdout(jout):
        jfidelity.main(["--log-file", path, "--json"])
    jworst = max(json.loads(line)["max_pos_err"] for line in jout.getvalue().splitlines())
    assert abs(jworst - worst) <= EARLY_ATOL


def test_cli_episode_selects_one(tmp_path):
    path = _perturbed(tmp_path)
    _, every = _main(["--log-file", path, "--json"])
    reports = [json.loads(line) for line in every.splitlines()]
    assert [r["episode"] for r in reports] == [0, 1, 2]
    worst, one = _main(["--log-file", path, "--json", "--episode", "1"])
    assert [json.loads(line) for line in one.splitlines()] == [reports[1]]
    assert worst == reports[1]["max_pos_err"] == max(r["max_pos_err"] for r in reports)
    assert len(jevent_log.index_event_log(path)) == 3
