"""The port stands alone: it never imports JAX, flax, optax, msgpack or the
JAX package (nor do chip_smoke.py, bench_torch.py, scripts/torch_ddpg_it3.py,
scripts/torch_{sac,ppo,lrpg}_lowdim.py, scripts/torch_dqn_rainbow.py,
scripts/torch_naf_anneal.py, scripts/torch_ddpg_pixels_ab2k.py,
scripts/torch_sac_pixels.py, scripts/torch_parallel_scaling.py,
scripts/chip_smoke_parallel.py and scripts/export_{sac_actor,dqn_q}_npz.py), its
CLIs (DDPG, SAC, PPO, LRPG, DQN and NAF, the random agent and the torch DQN
demo) answer ``--help`` where JAX is not importable, its data-parallel
layer (``parallel/``) imports and reduces over a gloo group where JAX is
not importable, and its entry points refuse to fall back to the CPU
quietly."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFUSE = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "cartpoleplusplus_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
"""
_IMPORT_ALL = _REFUSE + r"""
import cartpoleplusplus_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import bench_torch
import runpy
runpy.run_path("scripts/torch_ddpg_it3.py", run_name="not_main")
runpy.run_path("scripts/torch_sac_lowdim.py", run_name="not_main")
runpy.run_path("scripts/torch_ppo_lowdim.py", run_name="not_main")
runpy.run_path("scripts/torch_lrpg_lowdim.py", run_name="not_main")
runpy.run_path("scripts/export_sac_actor_npz.py", run_name="not_main")
runpy.run_path("scripts/torch_dqn_rainbow.py", run_name="not_main")
runpy.run_path("scripts/export_dqn_q_npz.py", run_name="not_main")
runpy.run_path("scripts/torch_naf_anneal.py", run_name="not_main")
runpy.run_path("scripts/torch_ddpg_pixels_ab2k.py", run_name="not_main")
runpy.run_path("scripts/torch_sac_pixels.py", run_name="not_main")
runpy.run_path("scripts/torch_parallel_scaling.py", run_name="not_main")
runpy.run_path("scripts/chip_smoke_parallel.py", run_name="not_main")
for name in ("cartpoleplusplus_tpu_torch.agents.sac", "cartpoleplusplus_tpu_torch.replay.buffer",
             "cartpoleplusplus_tpu_torch.agents.ppo", "cartpoleplusplus_tpu_torch.agents.lrpg",
             "cartpoleplusplus_tpu_torch.utils.learning_run",
             "cartpoleplusplus_tpu_torch.agents.dqn", "cartpoleplusplus_tpu_torch.agents.naf",
             "cartpoleplusplus_tpu_torch.physics.engine",
             "cartpoleplusplus_tpu_torch.physics.contacts",
             "cartpoleplusplus_tpu_torch.physics.solver", "cartpoleplusplus_tpu_torch.physics.urdf",
             "cartpoleplusplus_tpu_torch.env.gym_env", "cartpoleplusplus_tpu_torch.utils.event_log",
             "cartpoleplusplus_tpu_torch.utils.event_pb2", "cartpoleplusplus_tpu_torch.utils.records",
             "cartpoleplusplus_tpu_torch.utils.optim",
             "cartpoleplusplus_tpu_torch.agents.random_agent",
             "cartpoleplusplus_tpu_torch.agents.torch_dqn_demo",
             "cartpoleplusplus_tpu_torch.utils.native", "cartpoleplusplus_tpu_torch.utils.plots",
             "cartpoleplusplus_tpu_torch.utils.fidelity",
             "cartpoleplusplus_tpu_torch.utils.export", "cartpoleplusplus_tpu_torch.parallel",
             "cartpoleplusplus_tpu_torch.parallel.mesh",
             "cartpoleplusplus_tpu_torch.parallel.distributed"):
    assert name in sys.modules, name
from cartpoleplusplus_tpu_torch.replay import buffer
for fn in ("sample_prioritized", "update_priorities", "nstep_batch", "valid_mask"):
    assert callable(getattr(buffer, fn)), fn
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""
_HELP = _REFUSE + r"""
import runpy
agent = sys.argv[1]
sys.argv = [agent, "--help"]
runpy.run_module(f"cartpoleplusplus_tpu_torch.agents.{agent}", run_name="__main__",
                 alter_sys=True)
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module was walked: utils.{benchmark,checkpoint,flax_msgpack,metrics} too,
    # agents.{ppo,lrpg,dqn,naf}, utils.learning_run, and the per-env surface's
    # physics.{contacts,solver,engine,urdf}, env.gym_env, utils.{event_log,
    # event_pb2,records,optim}, agents.{random_agent,torch_dqn_demo}, and the
    # tools utils.{native,plots,fidelity,export}, and parallel.{mesh,distributed}
    assert int(out.stdout.split()[-1]) >= 54


_PARALLEL = _REFUSE + r"""
import torch
from cartpoleplusplus_tpu_torch import parallel
from cartpoleplusplus_tpu_torch.parallel.mesh import free_port
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
mesh = parallel.init_process_group(f"localhost:{free_port()}", 0, 1, device="cpu")
x = torch.tensor([1.5, -2.0])
parallel.allreduce_mean_([x], mesh.group)
parallel.destroy()
assert x.tolist() == [1.5, -2.0] and mesh.backend == "gloo"
print("reduced")
"""


def test_parallel_imports_without_jax():
    """``cartpoleplusplus_tpu_torch.parallel`` imports where jax, flax,
    optax, msgpack and the JAX package cannot be imported, leaves none of
    them in ``sys.modules``, and averages over a 1-rank gloo group."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[-1] == "reduced"


_NO_DYNAMO = _IMPORT_ALL.replace("print(len(names))", "") + r"""
from cartpoleplusplus_tpu_torch.agents import ddpg
assert "torch._dynamo" not in sys.modules, "imported by an import"
ddpg.main("--device cpu --num-train-batches 1 --num-envs 4 --num-eval 4 --action-repeats 2 "
          "--steps-per-repeat 2 --max-episode-len 5 --steps-per-segment 2 --batch-size 8 "
          "--replay-capacity 64 --warmup-steps 1".split())
assert "torch._dynamo" not in sys.modules, "imported by a low-dim CLI run"
print("no dynamo")
"""


def test_no_dynamo_without_export():
    """``torch.export`` imports ``torch._dynamo``, seconds on a card's host:
    importing every module of the port (and chip_smoke.py, bench_torch.py
    and the scripts), then a low-dim DDPG run without ``--export-policy``,
    leaves it unimported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _NO_DYNAMO], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[-2:] == ["no", "dynamo"]


_NATIVE_BUILD = _REFUSE + r"""
import os, sys
from cartpoleplusplus_tpu_torch.utils import native
native_dir = os.path.dirname(native.SOURCE)
before = {n: os.stat(os.path.join(native_dir, n)).st_mtime_ns for n in os.listdir(native_dir)}
assert native.lib_dir().startswith(os.path.join(native.BUILD_ROOT, "trajlog-"))
pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
assert native.BUILD_ROOT == os.path.join(pkg, "_build")
native.BUILD_ROOT = sys.argv[1]
info = native.build()
assert info["built"] and info["path"].startswith(sys.argv[1] + os.sep), info
assert native.build() == {"path": info["path"], "built": False, "cxx_s": 0.0}
made = sorted(os.path.relpath(os.path.join(d, f), sys.argv[1])
              for d, _, fs in os.walk(sys.argv[1]) for f in fs)
assert made == [os.path.relpath(info["path"], sys.argv[1])], made
after = {n: os.stat(os.path.join(native_dir, n)).st_mtime_ns for n in os.listdir(native_dir)}
assert after == before
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("built", info["cxx_s"])
"""


def test_native_builds_only_under_build(tmp_path):
    """``utils/native.py`` imports nothing of JAX or the JAX package, its
    build directory is the port's ``_build/``, and a build writes the one
    library there (here into a fresh root) and nothing into ``native/``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    root = str(tmp_path / "_build")
    out = subprocess.run([sys.executable, "-c", _NATIVE_BUILD, root], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[0] == "built"


@pytest.mark.parametrize("agent,flags", [
    ("ddpg", ("--pixel-encoder", "--ckpt-skip-replay", "--twin-critic", "--device",
              "--solver-iters", "--obs-samples", "--per", "--n-step")),
    ("sac", ("--pixel-encoder", "--ckpt-skip-replay", "--alpha-min", "--init-alpha",
             "--target-entropy", "--device", "--obs-samples")),
    ("ppo", ("--rollout-steps", "--ppo-epochs", "--ppo-minibatches", "--ppo-clip",
             "--gae-lambda", "--entropy-coef", "--value-coef", "--lr-schedule", "--device")),
    ("lrpg", ("--num-devices", "--reward-calc", "--pixel-encoder", "--device")),
    ("dqn", ("--double-q", "--no-double-q", "--dueling", "--c51", "--c51-vmax", "--noisy",
             "--eps-start", "--per", "--n-step", "--num-devices", "--device")),
    ("naf", ("--use-batch-norm", "--ou-sigma-min", "--ou-decay-steps", "--reward-scale",
             "--grad-clip", "--lr-schedule", "--num-devices", "--device")),
    ("random_agent", ("--num-episodes", "--continuous", "--event-log-out", "--record-renders",
                      "--metrics-jsonl", "--device")),
    ("torch_dqn_demo", ("--episodes", "--eps-decay-episodes", "--target-sync-steps",
                        "--device")),
])
def test_cli_help_without_jax(agent, flags):
    """``python -m cartpoleplusplus_tpu_torch.agents.<agent> --help`` where
    jax, flax, optax and msgpack cannot be imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _HELP, agent], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in flags:
        assert flag in out.stdout


_EXACT = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, obs_pool=2,
              obs_samples=0)


@pytest.mark.parametrize("entry", ["make_venv", "VectorCartpole", "Actor", "resolve_device",
                                   "make_venv_exact", "Critic", "init_state", "make_segment",
                                   "train", "main", "GaussianActor", "sac_init_state",
                                   "sac_make_segment", "sac_main", "ValueNetwork",
                                   "DiscretePolicy", "ppo_init_state", "ppo_make_train_step",
                                   "ppo_main", "lrpg_init_state", "lrpg_make_train_step",
                                   "lrpg_main", "QNetwork", "dqn_init_state", "dqn_make_segment",
                                   "dqn_main", "NAFNetwork", "naf_init_state",
                                   "naf_make_segment", "naf_main", "Cartpole", "reset",
                                   "random_agent_main", "torch_dqn_demo_main",
                                   "record_eval_episodes", "resim_episode", "fidelity_main",
                                   "load_policy", "export_main"])
def test_entry_points_need_cuda_or_explicit_cpu(entry, monkeypatch, tmp_path):
    """Without CUDA, entry points raise unless the caller passes device='cpu'.
    ``init_state`` and ``make_segment`` run on their vector env's device;
    ``train`` and ``main`` take ``--device``."""
    from types import SimpleNamespace

    from cartpoleplusplus_tpu_torch import resolve_device
    from cartpoleplusplus_tpu_torch.agents import (
        common, ddpg, dqn, lrpg, naf, ppo, random_agent, sac, torch_dqn_demo)
    from cartpoleplusplus_tpu_torch.agents.common import make_venv
    from cartpoleplusplus_tpu_torch.env import cartpole
    from cartpoleplusplus_tpu_torch.env.gym_env import Cartpole
    from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
    from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
    from cartpoleplusplus_tpu_torch.models.networks import (
        Actor, Critic, DiscretePolicy, GaussianActor, NAFNetwork, QNetwork, ValueNetwork)
    from cartpoleplusplus_tpu_torch.utils import event_log, export, fidelity

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
    toy = ["--num-train-batches", "1", "--num-envs", "4", "--num-eval", "2", "--max-episode-len",
           "2", "--action-repeats", "1", "--steps-per-repeat", "1", "--steps-per-segment", "1",
           "--batch-size", "2", "--replay-capacity", "16", "--warmup-steps", "0",
           "--metrics-jsonl", str(tmp_path / "m.jsonl")]

    onpolicy_toy = [*toy[:toy.index("--steps-per-segment")], "--metrics-jsonl",
                    str(tmp_path / "m.jsonl")]
    ppo_opts = ppo.make_parser().parse_args(["--rollout-steps", "2", "--ppo-minibatches", "2"])

    def event_log_file():
        from cartpoleplusplus_tpu_torch.utils import event_log

        path = str(tmp_path / "r.events")
        pose = np.array([0.0, 0.0, 0.1, 1.0, 0.0, 0.0, 0.0], np.float32)
        ev = event_log.make_event(pose, pose, [0.0, 0.0], 1.0, False, velocities=np.zeros((2, 6)))
        log = event_log.EventLog(path)
        log.add_episode([ev, ev])
        log.close()
        return path

    def artifact():
        from cartpoleplusplus_tpu_torch.utils import export

        path = str(tmp_path / "a.pt2")
        export.save_policy(path, ddpg.greedy_act(Actor((1, 2, 7), hidden=(4,), device="cpu")),
                           (1, 2, 7))
        return path

    def cli(run, device=None):
        argv = (onpolicy_toy if run in (ppo.main, lrpg.main) else toy) + (
            [] if device is None else ["--device", device])
        return run(argv) if run in (ddpg.main, sac.main, ppo.main, lrpg.main, dqn.main,
                                    naf.main) else run(
            ddpg.make_parser().parse_args(argv))
    build = {
        "make_venv": lambda **kw: make_venv(cfg, 4, **kw),
        "VectorCartpole": lambda **kw: VectorCartpole(cfg, 4, None, None, None, **kw),
        "Actor": lambda **kw: Actor(cfg.obs_shape, **net_kw, **kw),
        "resolve_device": lambda **kw: resolve_device(kw.get("device")),
        "make_venv_exact": lambda **kw: make_venv(exact, 4, **kw),
        "Critic": lambda **kw: Critic(cfg.obs_shape, **net_kw, **kw),
        "init_state": lambda **kw: ddpg.init_state(opts, exact, venv_on(**kw), hidden=(8, 4)),
        "make_segment": lambda **kw: ddpg.make_segment(venv_on(**kw), **seg_kw),
        "train": lambda **kw: cli(ddpg.train, **kw),
        "main": lambda **kw: cli(ddpg.main, **kw),
        "GaussianActor": lambda **kw: GaussianActor(cfg.obs_shape, **net_kw, **kw),
        "sac_init_state": lambda **kw: sac.init_state(opts, exact, venv_on(**kw), hidden=(8, 4)),
        "sac_make_segment": lambda **kw: sac.make_segment(
            venv_on(**kw), target_entropy=-2.0,
            **{k: v for k, v in seg_kw.items() if not k.startswith("ou_")}),
        "sac_main": lambda **kw: cli(sac.main, **kw),
        "ValueNetwork": lambda **kw: ValueNetwork(cfg.obs_shape, **net_kw, **kw),
        "DiscretePolicy": lambda **kw: DiscretePolicy(cfg.obs_shape, **net_kw, **kw),
        "ppo_init_state": lambda **kw: ppo.init_state(opts, exact, venv_on(**kw), hidden=(8, 4)),
        "ppo_make_train_step": lambda **kw: ppo.make_train_step(venv_on(**kw), ppo_opts),
        "ppo_main": lambda **kw: cli(ppo.main, **kw),
        "lrpg_init_state": lambda **kw: lrpg.init_state(opts, exact, venv_on(**kw),
                                                        hidden=(8, 4)),
        "lrpg_make_train_step": lambda **kw: lrpg.make_train_step(venv_on(**kw), 0.99),
        "lrpg_main": lambda **kw: cli(lrpg.main, **kw),
        "QNetwork": lambda **kw: QNetwork(cfg.obs_shape, dueling=True, num_atoms=11, noisy=True,
                                          **net_kw, **kw),
        "dqn_init_state": lambda **kw: dqn.init_state(opts, exact, venv_on(**kw), hidden=(8, 4)),
        "dqn_make_segment": lambda **kw: dqn.make_segment(
            venv_on(**kw), eps_start=1.0, eps_end=0.05, eps_decay_steps=10,
            **{k: v for k, v in seg_kw.items() if not k.startswith("ou_")}),
        "dqn_main": lambda **kw: cli(dqn.main, **kw),
        "NAFNetwork": lambda **kw: NAFNetwork(cfg.obs_shape, use_batch_norm=True, **net_kw, **kw),
        "naf_init_state": lambda **kw: naf.init_state(opts, exact, venv_on(**kw), hidden=(8, 4)),
        "naf_make_segment": lambda **kw: naf.make_segment(venv_on(**kw), **seg_kw),
        "naf_main": lambda **kw: cli(naf.main, **kw),
        "Cartpole": lambda **kw: Cartpole(exact, **kw),
        "reset": lambda **kw: cartpole.reset(exact, cartpole.scene_for(exact),
                                             theta=torch.tensor(0.0), jitter=torch.zeros(2),
                                             **kw),
        "random_agent_main": lambda **kw: random_agent.main(
            ["--num-episodes", "1", "--max-episode-len", "2"]
            + ([] if kw.get("device") is None else ["--device", kw["device"]])),
        "torch_dqn_demo_main": lambda **kw: torch_dqn_demo.main(
            ["--episodes", "1", "--max-episode-len", "2", "--batch-size", "2"]
            + ([] if kw.get("device") is None else ["--device", kw["device"]])),
        "resim_episode": lambda **kw: fidelity.resim_episode(
            next(event_log.read_event_log(event_log_file())), exact, **kw),
        "fidelity_main": lambda **kw: fidelity.main(
            ["--log-file", event_log_file()]
            + ([] if kw.get("device") is None else ["--device", kw["device"]])),
        "load_policy": lambda **kw: export.load_policy(artifact(), **kw),
        "export_main": lambda **kw: export.main(
            ["--load", artifact()]
            + ([] if kw.get("device") is None else ["--device", kw["device"]])),
        "record_eval_episodes": lambda **kw: common.record_eval_episodes(
            exact, lambda obs: torch.zeros((obs.shape[0], 2)), str(tmp_path / "e.events"),
            num_episodes=1, **kw),
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
