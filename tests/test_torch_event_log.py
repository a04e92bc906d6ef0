"""The port's event log (``utils/{event_log,records,event_pb2}.py``) and the
random agent that writes one (``agents/random_agent.py``) against the JAX
package: each package's reader reads the other's logs with equal protos
(the four ``runs/*.events`` the JAX agents recorded, and logs the port
writes); the framing's scan, seek and truncation errors; ``--echo``'s text
equal to JAX's CLI's; GIFs and PNGs out of the CLI; the pose renderer
against JAX's; and a port-written low-dim log resimulated by JAX's
``utils/fidelity.resim_episode``.

Tolerances: the resimulation within 1e-5 in position (the per-env engines
agree to a few 1e-6 over such episodes, tests/test_torch_gym_env.py) and
1e-4 in the quaternion; re-rendered frames by the pixel rule, |Δ| ≤ 2
levels on ≥ 99.9 % of pixels and mean |Δ| < 0.5.
"""

import glob
import io
import os
import struct
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.utils import event_log as jevent_log
from cartpoleplusplus_tpu.utils import event_pb2 as jevent_pb2
from cartpoleplusplus_tpu.utils import fidelity
from cartpoleplusplus_tpu.utils import native as jnative
from cartpoleplusplus_tpu_torch.agents import random_agent
from cartpoleplusplus_tpu_torch.utils import event_log, event_pb2, records

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOGS = sorted(glob.glob(os.path.join(REPO, "runs", "*.events")))


def test_event_pb2_is_the_jax_module_byte_for_byte():
    """One schema, one registration: the copy's bytes are the JAX module's,
    so both name the same message classes in one process."""
    here = os.path.join(REPO, "cartpoleplusplus_tpu_torch", "utils", "event_pb2.py")
    there = os.path.join(REPO, "cartpoleplusplus_tpu", "utils", "event_pb2.py")
    with open(here, "rb") as a, open(there, "rb") as b:
        assert a.read() == b.read()
    assert event_pb2.Episode is jevent_pb2.Episode and event_pb2.Event is jevent_pb2.Event


def test_jax_logs_are_there():
    names = [os.path.basename(p) for p in JAX_LOGS]
    assert "ddpg_pixels_td3_eval.events" in names and len(names) == 4


@pytest.mark.parametrize("path", JAX_LOGS, ids=os.path.basename)
def test_port_reads_jax_logs(path):
    """Every JAX-recorded log, read by the port's reader, by the JAX
    reader, and through the port's scan and seek: the same serialized
    protos, in order."""
    want = [ep.SerializeToString() for ep in jevent_log.read_event_log(path)]
    got = [ep.SerializeToString() for ep in event_log.read_event_log(path)]
    assert got == want and len(got) >= 1
    offsets = event_log.index_event_log(path)
    assert offsets == jnative.scan_records(path, force_python=True)
    assert [event_log.read_episode_at(path, o).SerializeToString() for o in offsets] == want
    ep = event_log.read_episode_at(path, offsets[-1])
    np.testing.assert_array_equal(event_log.episode_poses(ep), jevent_log.episode_poses(ep))


def _port_log(tmp_path, name="random.events", *extra):
    path = str(tmp_path / name)
    lengths = random_agent.main(["--device", "cpu", "--num-episodes", "3", "--max-episode-len",
                                 "20", "--event-log-out", path, "--metrics-jsonl",
                                 str(tmp_path / "m.jsonl"), *extra])
    return path, lengths


def test_jax_reads_port_logs(tmp_path):
    """A log the port's random agent writes (velocities, actions, rewards,
    done flags; renders with ``--record-renders``) reads back in JAX's
    reader, with its native codec and its pure-Python one, as the same
    protos the port's reader yields; a second run appends to it."""
    path, lengths = _port_log(tmp_path, "random.events", "--record-renders")
    got = [ep.SerializeToString() for ep in event_log.read_event_log(path)]
    want = [ep.SerializeToString() for ep in jevent_log.read_event_log(path)]
    assert got == want and [len(ep.event) for ep in event_log.read_event_log(path)] == lengths
    assert list(jnative.read_records(path, force_python=True)) == got
    eps = list(jevent_log.read_event_log(path))
    last = eps[0].event[-1]
    assert last.done and len(last.cart.linear_velocity) == 3 and len(last.render) == 1
    assert not any(ev.done for ev in eps[0].event[:-1])
    assert sum(ev.reward for ev in eps[0].event) == len(eps[0].event) - 1
    _port_log(tmp_path, "random.events")
    assert len(list(jevent_log.read_event_log(path))) == 6


def test_records_framing(tmp_path):
    """The record stream: magic once, a little-endian length per record;
    a JAX-native writer and the port's append to each other's file; a
    truncated tail raises on read and on scan."""
    path = str(tmp_path / "r.log")
    w = records.RecordWriter(path)
    w.write(b"abc")
    w.write(b"")
    w.close()
    jw = jnative.RecordWriter(path)
    jw.write(b"from jax")
    jw.close()
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == struct.pack("<I", records.MAGIC) and raw.count(raw[:4]) == 1
    assert list(records.read_records(path)) == [b"abc", b"", b"from jax"]
    offsets = records.scan_records(path)
    assert offsets == [4, 11, 15] == jnative.scan_records(path)
    assert records.read_record_at(path, offsets[2]) == b"from jax"
    with open(path, "ab") as f:
        f.write(struct.pack("<I", 10) + b"short")
    with pytest.raises(IOError, match="truncated"):
        list(records.read_records(path))
    with pytest.raises(IOError, match="truncated"):
        records.scan_records(path)
    (tmp_path / "bad.log").write_bytes(b"nope")
    with pytest.raises(IOError, match="not a trajlog"):
        list(records.read_records(str(tmp_path / "bad.log")))


def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_echo_prints_what_the_jax_cli_prints(tmp_path, which):
    if which == "port":
        path, _ = _port_log(tmp_path)
    else:
        path = os.path.join(REPO, "runs", "ddpg_pixels_td3_eval.events")
    for argv in (["--echo"], ["--echo", "--episode", "1"], ["--verify"]):
        got = _run(event_log.main, ["--log-file", path, *argv])
        assert got == _run(jevent_log.main, ["--log-file", path, *argv])
        assert got
    with pytest.raises(SystemExit, match="out of range"):
        event_log.main(["--log-file", path, "--episode", "99"])


def test_gif_from_a_pose_only_log(tmp_path):
    """A low-dim log holds no frames: ``--gif-out`` re-renders the poses by
    the ray caster; each frame within the pixel rule of JAX's
    re-rendering."""
    from PIL import Image

    path, lengths = _port_log(tmp_path)
    out = tmp_path / "gifs"
    event_log.main(["--log-file", path, "--gif-out", str(out), "--gif-size", "24",
                    "--gif-scale", "2", "--episode", "0"])
    gif = Image.open(out / "ep00000.gif")
    assert gif.n_frames == lengths[0] and gif.size == (48, 48)
    ep = next(event_log.read_event_log(path))
    got = list(event_log.episode_frames(ep, 24, 24, num_cameras=2))
    want = list(jevent_log.episode_frames(ep, 24, 24, num_cameras=2))
    assert len(got) == len(want) == lengths[0]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (24, 48, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert (d <= 2).mean() >= 0.999 and d.mean() < 0.5
    assert max(int(g.max()) - int(g.min()) for g in got) > 100


def test_stored_renders_to_pngs_and_gif(tmp_path):
    """``--record-renders`` stores each step's frame; ``--img-output-dir``
    writes them out as the JAX CLI names them and ``--gif-out`` animates
    them."""
    path, lengths = _port_log(tmp_path, "r.events", "--record-renders", "--num-cameras", "2")
    pngs = tmp_path / "png"
    event_log.main(["--log-file", path, "--img-output-dir", str(pngs)])
    names = sorted(os.listdir(pngs))
    assert len(names) == 2 * sum(lengths) and names[0] == "ep00000_t0000_cam0.png"
    gifs = tmp_path / "gif"
    event_log.main(["--log-file", path, "--gif-out", str(gifs)])
    assert sorted(os.listdir(gifs)) == [f"ep{i:05d}.gif" for i in range(3)]
    frames = list(event_log.episode_frames(next(event_log.read_event_log(path))))
    assert frames[0].shape == (50, 100, 3)


def test_stored_renders_match_the_jax_agents(tmp_path):
    """``--record-renders`` renders by the slab cast, as the JAX agent does:
    each stored frame within the pixel rule of the JAX agent's float32
    frame of the event's pose, rounded; against that frame as JAX's
    ``make_event`` stores it (truncated), 0 or 1 level above on 99.9 %."""
    import argparse

    import jax
    import jax.numpy as jnp

    from cartpoleplusplus_tpu.env import cartpole as jcartpole
    from cartpoleplusplus_tpu.env import config as jenv_config
    from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid
    from cartpoleplusplus_tpu.render import make_observe_pixels
    from cartpoleplusplus_tpu.render.raycast import frame_to_images as jframe_to_images

    path, lengths = _port_log(tmp_path, "r.events", "--record-renders")
    parser = argparse.ArgumentParser()
    jenv_config.add_opts(parser)
    jcfg = jenv_config.config_from_opts(parser.parse_args([]), discrete_actions=True)
    jscene = jcartpole.scene_for(jcfg)
    observe = jax.jit(lambda r: make_observe_pixels(jcfg, dtype=jnp.float32)(jscene, r))
    zeros = jnp.zeros((2, 3), jnp.float32)
    n = 0
    for ep in event_log.read_event_log(path):
        for ev, got in zip(ep.event, event_log.episode_frames(ep)):
            rigid = JRigid(
                pos=jnp.asarray([ev.cart.position, ev.pole.position], jnp.float32),
                quat=jnp.asarray([ev.cart.orientation, ev.pole.orientation], jnp.float32),
                vel=zeros, ang=zeros)
            (frame,) = jframe_to_images(jcfg, np.asarray(observe(rigid)))
            unit = np.clip(frame, 0.0, 1.0) * 255
            assert got.shape == frame.shape == (50, 50, 3)
            # The port stores its render's uint8 frame, floor(255·c + 0.5);
            # JAX's make_event stores floor(255·c) of the float32 frame.
            d = got.astype(np.int32) - np.round(unit).astype(np.int32)
            assert (np.abs(d) <= 2).mean() >= 0.999 and np.abs(d).mean() < 0.5
            above_jax = got.astype(np.int32) - unit.astype(np.uint8).astype(np.int32)
            assert ((above_jax >= 0) & (above_jax <= 1)).mean() >= 0.999
            n += 1
    assert n == sum(lengths)


def test_make_event_matches_jax():
    rng = np.random.default_rng(0)
    cart, pole = rng.normal(size=7), rng.normal(size=7)
    vel = rng.normal(size=(2, 6))
    img = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    for action in (np.int64(3), np.array([0.25, -1.0], np.float32)):
        got = event_log.make_event(cart, pole, action, 0.5, True, renders=[img], velocities=vel)
        want = jevent_log.make_event(cart, pole, action, 0.5, True, renders=[img],
                                     velocities=vel)
        assert got.SerializeToString() == want.SerializeToString()


def test_port_log_resimulates_in_jax(tmp_path):
    """A port-written low-dim log (``max_episode_len`` 20, the recorded
    velocities) restarted from its first event and stepped by JAX's engine
    on its actions (``fidelity.resim_episode``) lands on the logged poses."""
    path, lengths = _port_log(tmp_path)
    config = JConfig(max_episode_len=20)
    for ep in event_log.read_event_log(path):
        recorded, resim = fidelity.resim_episode(ep, config)
        report = fidelity.divergence_report(recorded, resim)
        assert report["steps"] == len(ep.event) >= 1
        assert report["max_pos_err"] <= 1e-5 and report["max_quat_err"] <= 1e-4, report
