"""Trajectory event log: length-prefixed protobuf episodes, and its CLI.

Port of cartpoleplusplus_tpu.utils.event_log.  ``EventLog(path)
.add_episode(events)`` appends one serialized ``Episode`` proto (schema
``event.proto``; ``event_pb2`` is a byte-for-byte copy of the JAX
package's generated module, so both register the same messages) to the
record stream of :mod:`utils.records`, through the C++ codec of
:mod:`utils.native` where it builds; :func:`read_event_log` streams them
back.  Logs written by either package read in both.

    python -m cartpoleplusplus_tpu_torch.utils.event_log --log-file X \\
        [--echo] [--img-output-dir D] [--gif-out D] [--episode N] [--verify]

Episodes recorded without frames (low-dim runs) are re-rendered from
their poses by the plain ray caster (:func:`raycast.render_rays`) on the
CPU.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from cartpoleplusplus_tpu_torch.utils import event_pb2
from cartpoleplusplus_tpu_torch.utils.native import (
    RecordWriter, read_record_at, read_records, scan_records)


def _png_encode(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8, or float in [0, 1], → PNG bytes."""
    from PIL import Image

    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def make_event(
    cart_pose: np.ndarray,
    pole_pose: np.ndarray,
    action,
    reward: float,
    done: bool,
    renders: Optional[Sequence[np.ndarray]] = None,
    velocities: Optional[np.ndarray] = None,
) -> event_pb2.Event:
    """One Event proto from (7,) poses [pos(3) + quat wxyz(4)].

    ``velocities``: optional (2, 6) [body, (linear(3), angular(3))], which
    lets a resimulator restart the physics exactly.  ``renders``: per-camera
    (H, W, 3) images, stored as PNG.
    """
    ev = event_pb2.Event()
    cart_pose = np.asarray(cart_pose, np.float32)
    pole_pose = np.asarray(pole_pose, np.float32)
    ev.cart.position.extend(cart_pose[:3].tolist())
    ev.cart.orientation.extend(cart_pose[3:7].tolist())
    ev.pole.position.extend(pole_pose[:3].tolist())
    ev.pole.orientation.extend(pole_pose[3:7].tolist())
    if velocities is not None:
        velocities = np.asarray(velocities, np.float32)
        ev.cart.linear_velocity.extend(velocities[0, :3].tolist())
        ev.cart.angular_velocity.extend(velocities[0, 3:6].tolist())
        ev.pole.linear_velocity.extend(velocities[1, :3].tolist())
        ev.pole.angular_velocity.extend(velocities[1, 3:6].tolist())
    ev.action.extend(np.atleast_1d(np.asarray(action, np.float32)).tolist())
    ev.reward = float(reward)
    ev.done = bool(done)
    for r in renders or ():
        ev.render.append(_png_encode(r))
    return ev


class EventLog:
    """Streaming episode writer; each episode is flushed as it is added."""

    def __init__(self, path: str):
        self._writer = RecordWriter(path)

    def add_episode(self, events: Iterable[event_pb2.Event]) -> None:
        ep = event_pb2.Episode()
        for ev in events:
            ep.event.append(ev)
        self._writer.write(ep.SerializeToString())
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def read_event_log(path: str) -> Iterator[event_pb2.Episode]:
    """Stream the log's episodes back."""
    for data in read_records(path):
        ep = event_pb2.Episode()
        ep.ParseFromString(data)
        yield ep


def index_event_log(path: str) -> list[int]:
    """Byte offset of every episode record (a header-only scan; raises on a
    truncated tail).  Feed an offset to :func:`read_episode_at`."""
    return scan_records(path)


def read_episode_at(path: str, offset: int) -> event_pb2.Episode:
    """Decode the one episode whose record starts at ``offset``."""
    ep = event_pb2.Episode()
    ep.ParseFromString(read_record_at(path, offset))
    return ep


def episode_poses(ep: event_pb2.Episode) -> np.ndarray:
    """Episode → (T, 2, 7) float32 poses, cart first."""
    out = np.zeros((len(ep.event), 2, 7), np.float32)
    for t, ev in enumerate(ep.event):
        out[t, 0] = list(ev.cart.position) + list(ev.cart.orientation)
        out[t, 1] = list(ev.pole.position) + list(ev.pole.orientation)
    return out


def episode_frames(ep: event_pb2.Episode, width: int = 120, height: int = 120,
                   num_cameras: int = 1) -> Iterator[np.ndarray]:
    """One (H, W·cams, 3) uint8 image per event: the stored PNG renders, or,
    for an event without any, the poses re-rendered by the ray caster at
    ``width`` × ``height`` from the first ``num_cameras`` cameras."""
    from PIL import Image

    renderer = None
    for ev in ep.event:
        if ev.render:
            imgs = [np.asarray(Image.open(io.BytesIO(png)).convert("RGB")) for png in ev.render]
        else:
            if renderer is None:
                renderer = _pose_renderer(width, height, num_cameras)
            imgs = renderer(list(ev.cart.position) + list(ev.cart.orientation),
                            list(ev.pole.position) + list(ev.pole.orientation))
        yield np.concatenate(imgs, axis=1) if len(imgs) > 1 else imgs[0]


def _pose_renderer(width: int, height: int, num_cameras: int):
    """(cart_pose7, pole_pose7) → [per-camera (H, W, 3) uint8], by
    :func:`raycast.render_rays` on the CPU."""
    import torch

    from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, make_scene
    from cartpoleplusplus_tpu_torch.render.camera import DEFAULT_CAMERAS, ray_grid
    from cartpoleplusplus_tpu_torch.render.raycast import render_rays

    scene = make_scene()
    grids = [ray_grid(cam, height, width) for cam in DEFAULT_CAMERAS[: max(num_cameras, 1)]]

    def render(cart_pose, pole_pose):
        cart = np.asarray(cart_pose, np.float32)
        pole = np.asarray(pole_pose, np.float32)
        zeros = torch.zeros((2, 3))
        rigid = RigidState(pos=torch.from_numpy(np.stack([cart[:3], pole[:3]])),
                           quat=torch.from_numpy(np.stack([cart[3:7], pole[3:7]])),
                           vel=zeros, ang=zeros)
        out = []
        for dirs, eye in grids:
            rgb = render_rays(scene, rigid, eye, dirs).numpy()
            img = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            out.append(img.reshape(height, width, 3))
        return out

    return render


def write_episode_gif(ep: event_pb2.Episode, path: str, fps: int = 10, scale: int = 4,
                      width: int = 120, height: int = 120, num_cameras: int = 1) -> int:
    """Render an episode to an animated GIF → the frame count."""
    from PIL import Image

    frames = []
    for img in episode_frames(ep, width, height, num_cameras):
        pil = Image.fromarray(img)
        if scale > 1:
            pil = pil.resize((pil.width * scale, pil.height * scale), Image.NEAREST)
        frames.append(pil)
    if not frames:
        return 0
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=max(int(1000 / max(fps, 1)), 1), loop=0)
    return len(frames)


def main(argv=None):
    """The JAX CLI's flags: ``--echo``, ``--img-output-dir``, ``--gif-out``
    (with ``--gif-fps/--gif-scale/--gif-size/--gif-cameras``),
    ``--episode`` and ``--verify``."""
    parser = argparse.ArgumentParser(description="inspect cartpole++ event logs")
    parser.add_argument("--log-file", required=True)
    parser.add_argument("--echo", action="store_true", help="print per-episode summaries")
    parser.add_argument("--img-output-dir", type=str, default=None,
                        help="decode renders to PNGs under this dir")
    parser.add_argument("--gif-out", type=str, default=None,
                        help="write one animated GIF per episode under this dir (re-renders "
                             "from poses when the log has no stored frames)")
    parser.add_argument("--gif-fps", type=int, default=10)
    parser.add_argument("--gif-scale", type=int, default=4, help="nearest-neighbor upscale factor")
    parser.add_argument("--gif-size", type=int, default=120,
                        help="re-render resolution (square) for logs without stored frames")
    parser.add_argument("--gif-cameras", type=int, default=1,
                        help="cameras for re-rendered GIFs (stored-frame GIFs show every "
                             "logged camera)")
    parser.add_argument("--episode", type=int, default=None,
                        help="operate on this episode only (seeks by the header scan, "
                             "decoding no earlier episode)")
    parser.add_argument("--verify", action="store_true",
                        help="scan the whole log's framing and report the episode count; "
                             "fails on a truncated tail")
    opts = parser.parse_args(argv)

    if opts.verify:
        offsets = index_event_log(opts.log_file)
        print(f"{opts.log_file}: {len(offsets)} episodes, framing OK")
        if not (opts.echo or opts.img_output_dir or opts.gif_out):
            return

    if opts.episode is not None:
        offsets = index_event_log(opts.log_file)
        if not 0 <= opts.episode < len(offsets):
            raise SystemExit(f"--episode {opts.episode} out of range (log has "
                             f"{len(offsets)} episodes)")
        episodes = [(opts.episode, read_episode_at(opts.log_file, offsets[opts.episode]))]
    else:
        episodes = enumerate(read_event_log(opts.log_file))

    for i, ep in episodes:
        total_r = sum(ev.reward for ev in ep.event)
        if opts.echo:
            print(f"episode {i}: {len(ep.event)} events, total_reward={total_r}")
            for t, ev in enumerate(ep.event):
                print(f"  t={t} cart={tuple(round(v, 3) for v in ev.cart.position)}"
                      f" pole={tuple(round(v, 3) for v in ev.pole.position)}"
                      f" action={tuple(ev.action)} r={ev.reward} done={ev.done}")
        if opts.img_output_dir:
            os.makedirs(opts.img_output_dir, exist_ok=True)
            for t, ev in enumerate(ep.event):
                for c, png in enumerate(ev.render):
                    with open(os.path.join(opts.img_output_dir,
                                           f"ep{i:05d}_t{t:04d}_cam{c}.png"), "wb") as f:
                        f.write(png)
        if opts.gif_out:
            os.makedirs(opts.gif_out, exist_ok=True)
            path = os.path.join(opts.gif_out, f"ep{i:05d}.gif")
            n = write_episode_gif(ep, path, fps=opts.gif_fps, scale=opts.gif_scale,
                                  width=opts.gif_size, height=opts.gif_size,
                                  num_cameras=opts.gif_cameras)
            print(f"wrote {path} ({n} frames)", file=sys.stderr)
    if not (opts.echo or opts.img_output_dir or opts.gif_out):
        print("nothing to do: pass --echo, --img-output-dir and/or --gif-out", file=sys.stderr)


if __name__ == "__main__":
    main()
