"""The port stands alone: it never imports JAX or the JAX package (nor do
chip_smoke.py and bench_torch.py), and its entry points refuse to fall back
to the CPU quietly."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cartpoleplusplus_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import cartpoleplusplus_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import bench_torch
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 28  # every module was walked, utils.benchmark too


_EXACT = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, obs_pool=2,
              obs_samples=0)


@pytest.mark.parametrize("entry", ["make_venv", "VectorCartpole", "Actor", "resolve_device",
                                   "make_venv_exact", "Critic", "init_state", "make_segment"])
def test_entry_points_need_cuda_or_explicit_cpu(entry, monkeypatch):
    """Without CUDA, entry points raise unless the caller passes device='cpu'.
    ``init_state`` and ``make_segment`` run on their vector env's device."""
    from types import SimpleNamespace

    from cartpoleplusplus_tpu_torch import resolve_device
    from cartpoleplusplus_tpu_torch.agents import ddpg
    from cartpoleplusplus_tpu_torch.agents.common import make_venv
    from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
    from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
    from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic

    cfg = CartpoleConfig(discrete_actions=False, use_raw_pixels=True, num_cameras=2,
                         obs_pool=2, obs_samples=2)
    exact = CartpoleConfig(**_EXACT)

    def venv_on(device=None):
        """A vector env on ``device``; one named for CUDA is built while
        CUDA is reported present, then used while it is not."""
        if device == "cpu":
            return make_venv(exact, 4, device="cpu")
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            return VectorCartpole(exact, 4, None, None, None, device=device)

    opts = SimpleNamespace(seed=0, replay_capacity=16)
    seg_kw = dict(gamma=0.99, tau=0.005, batch_size=4, warmup_steps=0, steps_per_segment=1,
                  ou_theta=0.15, ou_sigma=0.2)
    net_kw = dict(use_raw_pixels=True, height=25, width=25)
    build = {
        "make_venv": lambda **kw: make_venv(cfg, 4, **kw),
        "VectorCartpole": lambda **kw: VectorCartpole(cfg, 4, None, None, None, **kw),
        "Actor": lambda **kw: Actor(cfg.obs_shape, **net_kw, **kw),
        "resolve_device": lambda **kw: resolve_device(kw.get("device")),
        "make_venv_exact": lambda **kw: make_venv(exact, 4, **kw),
        "Critic": lambda **kw: Critic(cfg.obs_shape, **net_kw, **kw),
        "init_state": lambda **kw: ddpg.init_state(opts, exact, venv_on(**kw), hidden=(8, 4)),
        "make_segment": lambda **kw: ddpg.make_segment(venv_on(**kw), **seg_kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(device="cuda")
    build(device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(use_raw_pixels=False), "low-dim"),
])
def test_unported_configs_are_refused(kw, match):
    """Low-dim configs are ported (tests/test_torch_lowdim.py) and render
    nothing: a render option away from its default is refused there rather
    than ignored, and the defaults build."""
    from cartpoleplusplus_tpu_torch.agents.common import make_venv
    from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig

    cfg = CartpoleConfig(**kw)
    for render in (dict(render_raster=True), dict(render_recip=False),
                   dict(render_hoist=True), dict(render_mxu=True)):
        with pytest.raises(ValueError, match=match):
            make_venv(cfg, 4, device="cpu", **render)
    assert make_venv(cfg, 4, device="cpu", render_raster=False).sim_fn is not None


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_port(where, tmp_path):
    """chip_smoke exits nonzero and prints no result here (no CUDA), and in
    a directory holding nothing of the repo but itself."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
