"""The port's conv pixel encoder and its JAX-checkpoint reader against the
JAX package on the CPU: ``pixels_to_nhwc``; the conv ``ObsEncoder``,
``Actor``, ``Critic`` and ``TwinCritic`` against flax from the same
numpy-seeded params at 25×25 (flax ``SAME`` pads 1/1 there) and 50×50
(pads 0/1), 1 and 2 cameras and ``pixel_pool`` 1 and 2; the flax-msgpack
reader against ``flax.serialization.msgpack_restore`` on the pixel-TD3
checkpoint; greedy actions, Q1 and Q2 of the weights it carries across
against flax on the checkpoint's own observations.

Tolerance: 2e-2 absolute on actions in [-1, 1] and on Q values (|Q| up to
~6 here), the bf16 bound of ``test_torch_slice.py``: both encoders compute
in bfloat16 (8-bit mantissa) and the two frameworks round the conv sums
and products at different places.
"""

import hashlib
import lzma
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cartpoleplusplus_tpu.models import Actor as JActor
from cartpoleplusplus_tpu.models import Critic as JCritic
from cartpoleplusplus_tpu.models.trunks import ObsEncoder as JObsEncoder
from cartpoleplusplus_tpu.models.trunks import pixels_to_nhwc as jpixels_to_nhwc
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic, TwinCritic
from cartpoleplusplus_tpu_torch.models.trunks import ObsEncoder, pixels_to_nhwc, same_padding
from cartpoleplusplus_tpu_torch.utils import flax_msgpack
from cartpoleplusplus_tpu_torch.utils.params import (
    actor_params_from_flax,
    critic_params_from_flax,
    ddpg_params_from_jax_checkpoint,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs", "ckpt_pixels_td3", "ckpt_15000.msgpack")
# chip_smoke.py's xz copy (runs/ stays out of chip copies).
CHIP_COPY = os.path.join(REPO, "chip_inputs", "ckpt_pixels_td3_15000.msgpack.xz")
CKPT_SHA256 = "b25b20ab53614cd00c8843cade2c73c29eaa59cdb02dd23ad84c5a77f5e28f78"
ATOL = 2e-2
HIDDEN = (32, 16)
REPEATS = 2
# (frame side, cameras, network-side pixel_pool)
SHAPES = [(25, 1, 1), (25, 2, 1), (50, 1, 1), (50, 2, 1), (50, 1, 2), (50, 2, 2)]


def _obs(side, cams, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, REPEATS, cams * 3 * side * side), dtype=np.uint8)


def _randomize(params, seed):
    """Draw every leaf from a seeded normal of std 1/√fan_in (biases 0.1):
    flax's zero biases would leave the bias adds untested."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "bias":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.normal(size=x.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("side,cams", [(25, 1), (25, 2), (50, 2)])
def test_pixels_to_nhwc_matches_jax(side, cams):
    obs = _obs(side, cams)
    want = np.asarray(jpixels_to_nhwc(jnp.asarray(obs), batched=True, height=side, width=side))
    got = pixels_to_nhwc(torch.from_numpy(obs), side, side).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,pads", [(25, (1, 1)), (13, (1, 1)), (7, (1, 1)), (50, (0, 1)),
                                       (4, (0, 1))])
def test_same_padding_is_flax_same(size, pads):
    assert same_padding(size) == pads


@pytest.mark.parametrize("side,cams,pool", SHAPES)
def test_conv_encoder_matches_flax(side, cams, pool):
    obs = _obs(side, cams)
    jenc = JObsEncoder(use_raw_pixels=True, hidden=HIDDEN, pixel_encoder="conv",
                       pixel_pool=pool, height=side, width=side)
    params = _randomize(jenc.init(jax.random.PRNGKey(0), jnp.zeros(obs.shape, jnp.float32)),
                        side + cams + pool)
    want = np.asarray(jenc.apply(params, jnp.asarray(obs)))
    enc = ObsEncoder(obs.shape[1] * obs.shape[2], True, HIDDEN, pixel_pool=pool, height=side,
                     width=side, pixel_encoder="conv")
    sd = {k.removeprefix("encoder."): v for k, v in
          actor_params_from_flax({"ObsEncoder_0": params["params"], "mu": {
              "kernel": np.zeros((HIDDEN[-1], 2), np.float32),
              "bias": np.zeros(2, np.float32)}}).items() if k.startswith("encoder.")}
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(obs)).numpy()
    assert got.shape == want.shape == (obs.shape[0], HIDDEN[-1])
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("side,cams,pool", SHAPES)
def test_conv_actor_matches_flax(side, cams, pool):
    obs = _obs(side, cams, seed=1)
    kw = dict(use_raw_pixels=True, hidden=HIDDEN, pixel_encoder="conv", pixel_pool=pool,
              height=side, width=side)
    jactor = JActor(action_dim=2, **kw)
    params = _randomize(jactor.init(jax.random.PRNGKey(1), jnp.zeros(obs.shape)), 7 + side)
    # A wide output head, so actions span the tanh range.
    params["params"]["mu"]["kernel"] = np.random.default_rng(side).normal(
        0.0, 1.0, (HIDDEN[-1], 2)).astype(np.float32)
    want = np.asarray(jactor.apply(params, jnp.asarray(obs)))
    actor = Actor(obs.shape[1:], device="cpu", **kw)
    actor.load_state_dict(actor_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = actor(torch.from_numpy(obs)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("side,cams,pool", SHAPES)
def test_conv_critic_matches_flax(side, cams, pool, twin):
    obs = _obs(side, cams, seed=2)
    action = np.random.default_rng(3).uniform(-1, 1, (obs.shape[0], 2)).astype(np.float32)
    kw = dict(use_raw_pixels=True, hidden=HIDDEN, pixel_encoder="conv", pixel_pool=pool,
              height=side, width=side)
    jcritic = JCritic(**kw)
    init = lambda k: jcritic.init(k, jnp.zeros(obs.shape), jnp.zeros(action.shape))
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    trees = [_randomize(init(k), 11 + i + side) for i, k in enumerate(keys)]
    if twin:
        params = jax.tree.map(lambda *x: np.stack(x), *trees)
        want = np.stack([np.asarray(jcritic.apply(t, jnp.asarray(obs), jnp.asarray(action)))
                         for t in trees])
        critic = TwinCritic(obs.shape[1:], device="cpu", **kw)
    else:
        params = trees[0]
        want = np.asarray(jcritic.apply(params, jnp.asarray(obs), jnp.asarray(action)))
        critic = Critic(obs.shape[1:], device="cpu", **kw)
    critic.load_state_dict(critic_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = critic(torch.from_numpy(obs), torch.from_numpy(action)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _walk_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _walk_equal(got[k], want[k], f"{path}/{k}")
        return 1
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path
    return 1


def test_chip_copy_of_checkpoint_is_byte_identical():
    """The checkpoint and chip_smoke.py's xz copy, decompressed, have one
    sha256, the one chip_smoke.py checks."""
    import chip_smoke

    with open(CKPT, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == CKPT_SHA256
    with lzma.open(CHIP_COPY) as f:
        assert hashlib.sha256(f.read()).hexdigest() == CKPT_SHA256
    assert chip_smoke.TD3_CKPT_SHA256 == CKPT_SHA256
    assert os.path.join(REPO, chip_smoke.TD3_CKPT) == CHIP_COPY


def test_msgpack_reader_equals_flax_on_checkpoint():
    with open(CKPT, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.loads(data)
    _walk_equal(got, want)
    n = sum(1 for _ in jax.tree.leaves(want))
    assert n == len(jax.tree.leaves(got)) == 125


def test_msgpack_reader_equals_flax_on_every_type():
    """Every msgpack type flax writes and numpy scalars (ext code 3); an
    unknown ext code raises."""
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129,
                 -32769, -2**31 - 1],
        "floats": [0.5, -1e300], "none": None, "flags": [True, False],
        "s": "x" * 40, "long": "y" * 300, "b": b"\x00\x01",
        "scalars": {"f": np.float32(2.5), "i": np.int64(-7), "u": np.uint8(9)},
        "arrays": {"e": np.zeros((0,), np.bool_), "m": np.arange(12, dtype=np.int16).reshape(3, 4),
                   "big": np.arange(70000, dtype=np.uint8)},
        "many": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    _walk_equal(flax_msgpack.loads(data), serialization.msgpack_restore(data))
    import msgpack

    with pytest.raises(ValueError, match="ext code 5"):
        flax_msgpack.loads(msgpack.packb(msgpack.ExtType(5, b"xx")))


@pytest.fixture(scope="module")
def checkpoint():
    raw = serialization.msgpack_restore(open(CKPT, "rb").read())
    return raw, ddpg_params_from_jax_checkpoint(CKPT)


TD3 = dict(use_raw_pixels=True, pixel_encoder="conv", height=25, width=25)


def test_checkpoint_actor_matches_flax(checkpoint):
    """Greedy actions of the cross-loaded TD3 actor on the checkpoint's own
    512 observations (2 cameras, obs_pool 2: 25×25×18 NHWC)."""
    raw, port = checkpoint
    obs = port["obs"]
    assert tuple(obs.shape) == (512, 3, 3750) and obs.dtype == torch.uint8
    want = np.asarray(JActor(action_dim=2, **TD3).apply(raw["actor_params"],
                                                        jnp.asarray(obs.numpy())))
    actor = Actor((3, 3750), device="cpu", **TD3)
    actor.load_state_dict(port["actor"], strict=True)
    with torch.no_grad():
        got = actor(obs).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 0.5


@pytest.mark.parametrize("which", ["critic", "target_critic"])
def test_checkpoint_twin_critic_matches_flax(checkpoint, which):
    """Q1 and Q2 of the cross-loaded twin critic at the checkpoint's obs and
    the flax actor's greedy actions."""
    raw, port = checkpoint
    obs = port["obs"]
    action = np.asarray(JActor(action_dim=2, **TD3).apply(raw["actor_params"],
                                                          jnp.asarray(obs.numpy())))
    jcritic = JCritic(**TD3)
    tree = raw[f"{which}_params"]
    want = np.stack([np.asarray(jcritic.apply(jax.tree.map(lambda x: x[i], tree),
                                              jnp.asarray(obs.numpy()), jnp.asarray(action)))
                     for i in range(2)])
    critic = TwinCritic((3, 3750), device="cpu", **TD3)
    critic.load_state_dict(port[which], strict=True)
    with torch.no_grad():
        got = critic(obs, torch.from_numpy(action)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_checkpoint_env_state_and_counters(checkpoint):
    raw, port = checkpoint
    for k in ("pos", "quat", "vel", "ang"):
        np.testing.assert_array_equal(port["env_states"][k].numpy(), raw["env_states"]["rigid"][k])
    np.testing.assert_array_equal(port["env_states"]["steps"].numpy(), raw["env_states"]["steps"])
    np.testing.assert_array_equal(port["env_states"]["done"].numpy(), raw["env_states"]["done"])
    assert port["env_steps"] == int(raw["env_steps"]) == 15000 * 25
    np.testing.assert_array_equal(port["target_actor"]["mu.weight"].numpy(),
                                  raw["target_actor_params"]["params"]["mu"]["kernel"].T)
