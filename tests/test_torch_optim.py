"""The port's optimizer (``utils/optim.py``) against ``torch.optim``: its
Adam equals ``torch.optim.Adam`` bit for bit over several updates, with a
constant rate and under a schedule (``LambdaLR`` beside the port's
``Schedule``); the state dicts keep torch's layout both ways; and building
it imports no ``torch._dynamo``."""

import copy
import os
import subprocess
import sys

import pytest
import torch

from cartpoleplusplus_tpu_torch.agents.common import make_lr
from cartpoleplusplus_tpu_torch.utils.optim import Adam, Schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def _net(seed: int = 0) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(7, 16), torch.nn.Tanh(), torch.nn.Linear(16, 3))


def _grads(net, step: int) -> None:
    g = torch.Generator().manual_seed(100 + step)
    x = torch.randn((32, 7), generator=g)
    loss = (net(x) ** 2).mean() * (step + 1.0)
    loss.backward()


def _pair(schedule):
    """(torch's optimizer and scheduler, the port's) on two copies of one
    network."""
    ref, port = _net(), _net()
    if schedule is None:
        return (ref, torch.optim.Adam(ref.parameters(), lr=3e-3), None), \
            (port, Adam(port.parameters(), lr=3e-3), None)
    ropt = torch.optim.Adam(ref.parameters(), lr=1.0)
    popt = Adam(port.parameters(), lr=1.0)
    return (ref, ropt, torch.optim.lr_scheduler.LambdaLR(ropt, schedule)), \
        (port, popt, Schedule(popt, schedule))


def _run(side, steps, start=0):
    net, opt, sched = side
    for i in range(start, start + steps):
        opt.zero_grad(set_to_none=True)
        _grads(net, i)
        opt.step()
        if sched is not None:
            sched.step()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("scheduled", [False, True])
def test_adam_equals_torch_adam_bit_for_bit(scheduled):
    schedule = make_lr(type("O", (), {"lr_schedule": "cosine"})(), 2e-3, STEPS) \
        if scheduled else None
    ref, port = _pair(schedule)
    for i in range(STEPS):
        _run(ref, 1, i)
        _run(port, 1, i)
        for p, q in zip(ref[0].parameters(), port[0].parameters()):
            assert _bits_equal(p.detach(), q.detach()), i
        assert ref[1].param_groups[0]["lr"] == port[1].param_groups[0]["lr"]
    rsd, psd = ref[1].state_dict(), port[1].state_dict()
    assert rsd["param_groups"] == psd["param_groups"]
    assert rsd["state"].keys() == psd["state"].keys()
    for k in rsd["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert _bits_equal(rsd["state"][k][name], psd["state"][k][name]), (k, name)
            assert psd["state"][k][name].device == rsd["state"][k][name].device
    if scheduled:
        assert ref[2].state_dict() == port[2].state_dict()


@pytest.mark.parametrize("direction", ["torch_to_port", "port_to_torch"])
def test_state_dicts_restore_across(direction):
    """A checkpoint of either optimizer (and schedule) restores into the
    other, and the two then update bit for bit alike."""
    schedule = make_lr(type("O", (), {"lr_schedule": "cosine"})(), 2e-3, 2 * STEPS)
    ref, port = _pair(schedule)
    src, dst = (ref, port) if direction == "torch_to_port" else (port, ref)
    _run(src, STEPS)
    dst[0].load_state_dict(copy.deepcopy(src[0].state_dict()))
    dst[1].load_state_dict(copy.deepcopy(src[1].state_dict()))
    dst[2].load_state_dict(copy.deepcopy(src[2].state_dict()))
    assert dst[1].param_groups[0]["lr"] == src[1].param_groups[0]["lr"]
    _run(src, 3, STEPS)
    _run(dst, 3, STEPS)
    for p, q in zip(src[0].parameters(), dst[0].parameters()):
        assert _bits_equal(p.detach(), q.detach())


def test_parameters_without_gradient_keep_no_state():
    net = _net()
    opt = Adam(net.parameters(), lr=1e-3)
    head = list(net.parameters())[-2:]
    before = [p.detach().clone() for p in net.parameters()]
    opt.zero_grad()
    loss = net[2](torch.ones((1, 16))).sum()
    loss.backward(inputs=head)
    opt.step()
    assert sorted(opt.state_dict()["state"]) == [2, 3]
    assert all(torch.equal(a, b.detach()) for a, b in zip(before[:2], list(net.parameters())[:2]))


def test_adam_imports_no_dynamo():
    """Building and stepping the port's Adam and Schedule in a fresh
    process leaves ``torch._dynamo`` unimported (torch.optim.Adam's first
    ``add_param_group`` imports it)."""
    code = (
        "import sys, torch\n"
        "from cartpoleplusplus_tpu_torch.agents import ddpg\n"
        "net = torch.nn.Linear(3, 2)\n"
        "opt, sched = ddpg.adam(net, lambda c: 1e-3)\n"
        "net(torch.ones(1, 3)).sum().backward(); opt.step(); sched.step()\n"
        "print('torch._dynamo' in sys.modules)\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"
