"""The port's serving artifact (``utils/export.py``) against the JAX
package's (``cartpoleplusplus_tpu.utils.export``).

- An exported greedy policy, saved and loaded on the CPU, equals direct
  apply bit for bit at batch sizes 1, 5 and 16 (the symbolic batch dim
  generalizes, batch 1 included), low-dim (float32 in) and pixels (uint8
  in); ``describe`` names the batch by its symbol; the CLI smoke-runs.
- ``--export-policy`` after training in all six agents, low-dim and
  pixels: the logged artifact is the one on disk, it takes the training
  pipeline's observation ABI and equals its policy module bit for bit;
  under ``--eval-only`` too, with and without ``--use-batch-norm`` (the
  running statistics, not a batch's).
- The same weights (flax's, carried by ``utils/params``) exported by JAX's
  ``save_policy`` (``platforms=("cpu",)``) and by the port: continuous
  actions within 2e-2 (both encoders compute in bfloat16 and round at
  different places, tests/test_torch_slice.py's bound), discrete actions
  equal wherever the top two values are more than that bound apart.
- An artifact loads onto another device: moved to ``meta`` (a device with
  no data, which a CPU tensor baked into the graph cannot meet), every
  agent's policy graph still runs.
"""

import json
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.agents import dqn as jdqn
from cartpoleplusplus_tpu.agents import sac as jsac
from cartpoleplusplus_tpu.models import Actor as JActor
from cartpoleplusplus_tpu.models import GaussianActor as JGaussianActor
from cartpoleplusplus_tpu.models import QNetwork as JQNetwork
from cartpoleplusplus_tpu.utils import export as jexport
from cartpoleplusplus_tpu_torch.agents import common, ddpg, dqn, lrpg, naf, ppo, sac
from cartpoleplusplus_tpu_torch.models.networks import (
    Actor, DiscretePolicy, GaussianActor, NAFNetwork, QNetwork)
from cartpoleplusplus_tpu_torch.utils import export
from cartpoleplusplus_tpu_torch.utils.params import (
    actor_params_from_flax, gaussian_actor_params_from_flax, q_network_params_from_flax)

torch.set_num_threads(2)

BATCHES = (1, 5, 16)
ATOL = 2e-2
LOWDIM = (2, 2, 7)
PIXELS = (2, 3 * 16 * 16)
PIX_NET = dict(use_raw_pixels=True, height=16, width=16)


def _obs(shape, batch, seed=0):
    rng = np.random.default_rng(seed)
    if len(shape) == 2:
        return torch.from_numpy(rng.integers(0, 256, (batch, *shape), dtype=np.uint8))
    return torch.from_numpy(rng.normal(0.0, 0.5, (batch, *shape)).astype(np.float32))


def _actor(shape, encoder="dense"):
    kw = dict(PIX_NET, pixel_encoder=encoder) if len(shape) == 2 else {}
    return Actor(shape, hidden=(16, 8), device="cpu",
                 generator=torch.Generator().manual_seed(0), **kw)


@pytest.mark.parametrize("shape,encoder", [(LOWDIM, "dense"), (PIXELS, "dense"),
                                           (PIXELS, "conv")], ids=["lowdim", "pixels", "conv"])
def test_roundtrip_equals_direct_apply(shape, encoder, tmp_path):
    policy = ddpg.greedy_act(_actor(shape, encoder))
    dtype = torch.uint8 if len(shape) == 2 else torch.float32
    path = str(tmp_path / "actor.pt2")
    nbytes = export.save_policy(path, policy, shape, dtype)
    assert nbytes == (tmp_path / "actor.pt2").stat().st_size > 0
    loaded = export.load_policy(path, "cpu")
    for batch in BATCHES:
        obs = _obs(shape, batch, seed=batch)
        got, want = loaded(obs), policy(obs)
        assert got.shape == (batch, 2) and torch.equal(got, want), batch
    # Numpy observations go in as they are.
    assert torch.equal(loaded(_obs(shape, 3).numpy()), policy(_obs(shape, 3)))


def test_describe_names_the_symbolic_batch(tmp_path):
    path = str(tmp_path / "q.pt2")
    q = QNetwork(PIXELS, dueling=True, num_atoms=11, noisy=True, hidden=(16, 8), device="cpu",
                 **PIX_NET)
    export.save_policy(path, dqn.greedy_act(q), PIXELS, torch.uint8)
    meta = export.describe(path)
    (inp,), (out,) = meta["inputs"], meta["outputs"]
    sym = meta["batch"]["symbol"]
    assert meta["batch"]["symbolic"] and meta["batch"]["min"] == 1 and meta["batch"]["max"] is None
    assert inp["shape"] == [sym, "2", "768"] and inp["dtype"] == meta["dtype"] == "uint8"
    assert out["shape"] == [sym] and out["dtype"] == "int64" and not sym.isdigit()
    assert meta["bytes"] == (tmp_path / "q.pt2").stat().st_size


def test_cli_smoke(tmp_path, capsys):
    path = str(tmp_path / "actor.pt2")
    export.save_policy(path, ddpg.greedy_act(_actor(LOWDIM)), LOWDIM)
    out = export.main(["--load", path, "--batch", "3", "--steps", "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "ARTIFACT" in err and "CALL ok" in err and "TIMING" in err
    assert out["out_shapes"] == [[3, 2]] and out["ms_per_call"] > 0


OFF_POLICY = """--num-train-batches 1 --num-envs 4 --num-eval 4 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 5 --steps-per-segment 2 --batch-size 8
  --replay-capacity 64 --warmup-steps 1 --eval-freq 1 --hidden 16 8"""
ON_POLICY = """--num-train-batches 1 --num-envs 4 --num-eval 4 --eval-freq 1 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 5 --hidden 16 8"""
AGENTS = {"ddpg": (ddpg, OFF_POLICY), "sac": (sac, OFF_POLICY),
          "ppo": (ppo, ON_POLICY + " --rollout-steps 4 --ppo-minibatches 2 --ppo-epochs 1"),
          "lrpg": (lrpg, ON_POLICY), "dqn": (dqn, OFF_POLICY + " --dueling --c51 11 --noisy"),
          "naf": (naf, OFF_POLICY + " --use-batch-norm")}
DISCRETE = ("lrpg", "dqn")


def _run_and_spy(agent, argv, monkeypatch):
    """``agent.main(argv)`` with ``maybe_export_policy`` spied on → (the
    policy module it exported, the metrics events)."""
    seen = []
    real = common.maybe_export_policy

    def spy(opts, config, act_module, logger):
        seen.append(act_module)
        return real(opts, config, act_module, logger)

    monkeypatch.setattr(common, "maybe_export_policy", spy)
    agent.main(argv)
    jsonl = argv[argv.index("--metrics-jsonl") + 1]
    with open(jsonl) as f:
        return seen[-1], [json.loads(line) for line in f]


def _check_artifact(path, policy, shape, discrete, events):
    logged = [e for e in events if e["event"] == "export_policy"]
    assert len(logged) == 1 and logged[0]["path"] == str(path)
    assert logged[0]["bytes"] == path.stat().st_size
    meta = export.describe(str(path))
    assert meta["dtype"] == ("uint8" if len(shape) == 2 else "float32")
    assert meta["inputs"][0]["shape"][1:] == [str(d) for d in shape]
    loaded = export.load_policy(str(path), "cpu")
    for batch in BATCHES:
        obs = _obs(shape, batch, seed=batch)
        got = loaded(obs)
        assert torch.equal(got, policy(obs)), batch
        if discrete:
            assert got.shape == (batch,) and int(got.min()) >= 0 and int(got.max()) < 5
        else:
            assert got.shape == (batch, 2) and bool((got.abs() <= 1.0).all())


@pytest.mark.parametrize("pixels", [False, True], ids=["lowdim", "pixels"])
@pytest.mark.parametrize("name", sorted(AGENTS))
def test_export_policy_after_training(name, pixels, tmp_path, monkeypatch):
    agent, toy = AGENTS[name]
    extra = "--use-raw-pixels --render-width 16 --render-height 16" if pixels else ""
    art = tmp_path / "policy.pt2"
    argv = shlex.split(f"{toy} {extra}") + [
        "--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl"),
        "--export-policy", str(art)]
    policy, events = _run_and_spy(agent, argv, monkeypatch)
    assert [e["event"] for e in events][-1] == "export_policy"
    _check_artifact(art, policy, PIXELS if pixels else LOWDIM, name in DISCRETE, events)


@pytest.mark.parametrize("name,batch_norm", [("ddpg", False), ("ddpg", True), ("naf", True)])
def test_eval_only_exports(name, batch_norm, tmp_path, monkeypatch):
    """A trained checkpoint, then ``--eval-only --export-policy``: nothing
    trains, and the artifact is the restored network in eval mode (with
    batch norm its running statistics, which training moved)."""
    agent, toy = AGENTS[name]
    toy = toy.replace(" --use-batch-norm", "") + (" --use-batch-norm" if batch_norm else "")
    argv = shlex.split(toy) + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                               "--metrics-jsonl", str(tmp_path / "m.jsonl")]
    agent.main(argv)
    art = tmp_path / "eval_only.pt2"
    policy, events = _run_and_spy(agent, argv + ["--eval-only", "--export-policy", str(art)],
                                  monkeypatch)
    assert [e["event"] for e in events][-3:] == ["restore", "eval_only", "export_policy"]
    _check_artifact(art, policy, LOWDIM, False, events)
    if batch_norm:
        bn = policy.net.encoder.batch_norm
        assert float(bn.mean.abs().max()) > 0 and float((bn.var - 1).abs().max()) > 0
        obs = _obs(LOWDIM, 16)
        with torch.no_grad():
            head = (lambda o, t: policy.net(o, train=t)) if name == "ddpg" else (
                lambda o, t: policy.net(o, train=t)[1])
            assert torch.equal(head(obs, False), policy(obs))
            assert not torch.equal(head(obs, True), policy(obs))


def _flax(net, obs_shape, seed):
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, *obs_shape), jnp.float32))
    return jax.tree.map(np.asarray, params)


def _both(tmp_path, jact, params, port_policy, shape, dtype):
    jpath, ppath = str(tmp_path / "j.stablehlo"), str(tmp_path / "p.pt2")
    jexport.save_policy(jpath, jact, params, shape, jnp.uint8 if dtype == torch.uint8
                        else jnp.float32, platforms=("cpu",))
    export.save_policy(ppath, port_policy, shape, dtype)
    return jexport.load_policy(jpath), export.load_policy(ppath, "cpu")


@pytest.mark.parametrize("kind", ["actor_conv", "gaussian_lowdim"])
def test_continuous_artifacts_agree_with_jax(kind, tmp_path):
    if kind == "actor_conv":
        shape, kw = PIXELS, dict(PIX_NET, pixel_encoder="conv", hidden=(16, 8))
        jnet = JActor(action_dim=2, **kw)
        params = _flax(jnet, shape, 1)
        rng = np.random.default_rng(5)  # widen the ±3e-3 head: actions span tanh's range
        params["params"]["mu"]["kernel"] = rng.normal(0.0, 4.0, (8, 2)).astype(np.float32)
        net = Actor(shape, device="cpu", **kw)
        net.load_state_dict(actor_params_from_flax(params))
        jact, port = (lambda p, o: jnet.apply(p, o)), ddpg.greedy_act(net)
    else:
        shape, kw = LOWDIM, dict(hidden=(16, 8))
        jnet = JGaussianActor(action_dim=2, **kw)
        params = _flax(jnet, shape, 2)
        rng = np.random.default_rng(6)
        params["params"]["mu"]["kernel"] = rng.normal(0.0, 0.5, (8, 2)).astype(np.float32)
        net = GaussianActor(shape, device="cpu", **kw)
        net.load_state_dict(gaussian_actor_params_from_flax(params))
        jact, port = jsac.greedy_act(jnet), sac.greedy_act(net)
    dtype = torch.uint8 if len(shape) == 2 else torch.float32
    jpol, ppol = _both(tmp_path, jact, params, port, shape, dtype)
    for batch in BATCHES:
        obs = _obs(shape, batch, seed=batch)
        want = np.asarray(jpol(obs.numpy()))
        got = ppol(obs).numpy()
        assert got.shape == want.shape == (batch, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 0.2  # actions are not all near zero


@pytest.mark.parametrize("shape", [LOWDIM, PIXELS], ids=["lowdim", "conv"])
def test_discrete_artifacts_agree_with_jax(shape, tmp_path):
    """The full Rainbow head (dueling, C51, NoisyNet at its mu weights):
    equal actions wherever the top two atom means are more than the bound
    apart.  The heads' kernels are widened (logits of std 10) so that many
    rows are."""
    kw = dict(hidden=(16, 8), dueling=True, num_atoms=11, noisy=True)
    if len(shape) == 2:
        kw.update(PIX_NET, pixel_encoder="conv")
    jnet = JQNetwork(num_actions=5, **kw)
    params = _flax(jnet, shape, 3)
    obs = _obs(shape, 64, seed=7)
    spread = np.asarray(jnet.apply(params, jnp.asarray(obs.numpy()))).std()
    for head in ("advantage", "value"):
        params["params"][head]["kernel"] = params["params"][head]["kernel"] * (10.0 / spread)
    net = QNetwork(shape, device="cpu", **kw)
    net.load_state_dict(q_network_params_from_flax(params))
    dtype = torch.uint8 if len(shape) == 2 else torch.float32
    jpol, ppol = _both(tmp_path, jdqn.greedy_act(jnet), params, dqn.greedy_act(net), shape, dtype)
    want, got = np.asarray(jpol(obs.numpy())), ppol(obs).numpy()
    with torch.no_grad():
        means = dqn.q_scalar(net(obs), dqn.support(0.0, 1.0, 11, "cpu")).numpy()
    top2 = np.sort(means, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > ATOL
    assert got.shape == want.shape == (64,) and clear.sum() >= 8
    np.testing.assert_array_equal(got[clear], want[clear])


NETS = {
    "ddpg": lambda: ddpg.greedy_act(Actor(PIXELS, device="cpu", pixel_encoder="conv",
                                          hidden=(16, 8), **PIX_NET)),
    "sac": lambda: sac.greedy_act(GaussianActor(PIXELS, device="cpu", hidden=(16, 8), **PIX_NET)),
    "lrpg": lambda: lrpg.greedy_act(DiscretePolicy(LOWDIM, device="cpu", hidden=(16, 8))),
    "dqn": lambda: dqn.greedy_act(QNetwork(PIXELS, device="cpu", dueling=True, num_atoms=11,
                                           noisy=True, hidden=(16, 8), pixel_encoder="conv",
                                           **PIX_NET)),
    "naf": lambda: naf.greedy_act(NAFNetwork(LOWDIM, device="cpu", use_batch_norm=True,
                                             hidden=(16, 8))),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_artifact_names_no_device(name, tmp_path):
    """Each policy graph loaded onto ``meta``: the weights and every device
    the graph names move, so the artifact runs where it is loaded (the
    card's run is chip_smoke.py's ``export`` line)."""
    from torch.export.passes import move_to_device_pass

    import torch.export as te

    policy = NETS[name]()
    shape = LOWDIM if name in ("lrpg", "naf") else PIXELS
    dtype = torch.uint8 if len(shape) == 2 else torch.float32
    path = str(tmp_path / "p.pt2")
    export.save_policy(path, policy, shape, dtype)
    moved = move_to_device_pass(te.load(path), "meta").module()
    out = moved(torch.zeros((3, *shape), dtype=dtype, device="meta"))
    assert out.device.type == "meta" and out.shape[0] == 3
