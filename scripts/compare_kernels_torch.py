#!/usr/bin/env python3
"""Compare the port's K1-K4, K5a-K5d and K6 kernels of two source trees on one GPU.

    python3 scripts/compare_kernels_torch.py --parent DIR [--out DIR]

``DIR`` holds another tree's ``cartpoleplusplus_tpu_torch`` package (for
example the parent commit, unpacked with ``git archive <commit>
cartpoleplusplus_tpu_torch | tar -x -C DIR``).  This tree's package makes
the inputs on the card and saves them; then each tree is run in a process
of its own, in the order parent, this tree, this tree, parent.  Each run
builds its tree's kernels, launches K1 (``step_repeats``), K2
(``step_substeps``), K3 (``render_repeats``) and K4 (``render_batched``) in
the slab mode and K5b (``render_*_ratio``) in the ratio slab mode through
the package's ``launch`` functions on every slab set, and K5a
(``render_*_raster``), K5c (``pack_setups``, whose table is compared too,
and ``render_*_raster_hoist`` from it; the setup pass is also timed by
its kernel's own device time in a profiler trace, ``device_ms``, since a
launch of it is shorter than the host's call) and K5d (``render_*_raster_mxu``,
and from K5c's packed setups ``render_*_raster_hoist_mxu``) on every
raster set; it keeps the outputs (states, poses, setup tables, frames) and
times each launch with CUDA events.  The script then checks that the two
trees' outputs are equal byte for byte on every set, K5d's excepted (its
product may round a bound otherwise: it reports how many bytes differ and
whether each lies on a silhouette edge, ``chip_smoke.silhouette_stats``),
that each tree repeats its own outputs, and that each tree's K5c frames
equal its K5a frames (``k5c_equals_k5a``).  Each tree also times K5b with
its cull rectangles widened to the plane (``ray_abs`` = inf) and, where its
render kernels have the switch (``RenderParams.cull``), K5a, K5c and K5d
with their cull on and off (``variants_ms``): the cull's form in the tree
that has one, the same kernel twice in one that has none.

Each tree also launches K6's six chains (``roofline.launch``) over the
probe's (512, 1280) block: from ``roofline.varied`` for
``chip_smoke.K6_PARITY_ITERS`` iterations and from ``roofline.initial`` for
``chip_smoke.K6_ROW_ITERS`` (the kernels line's count), whose outputs are
compared byte for byte and whose launch is timed (``k6/<chain>``), and
measures each chain's rate by its N/2N timing (``roofline.measure_chain``;
``k6_el_ops_per_s``, with the ratio of this tree's two runs to the
parent's).

Input sets (config 5 unless named; 50x50 renders, obs_pool 2, 3 repeats x
5 substeps, 3 solver iterations):

- ``main_path``: 4096 envs' reset state, a seeded greedy actor's force, the
  poses of one step of the plain physics;
- ``training_end``: the env states after a few DDPG training segments at
  4096 envs, stepped once under the same actor;
- ``seeded``: 1024 states from the reset push and three random steps;
- ``wide``: 8192 such states; ``ragged``: 4097 (K1/K2 only);
- ``p2_1``: the 1cam_samples1 row's reset state and one step under a zero
  force (one sample per pooled pixel; K3/K4 and K5b only);
- ``adversarial``: 4096 poses of ``raycast.cull_probe_poses`` (K3/K4 and
  K5b only), seen by 2 cameras.

Raster sets (K5a, K5c, K5d; 1 camera exact unless named, ``obs_samples``
0):

- ``raster_main_path``: the 1cam_exact row's reset state and one step
  under a seeded actor; ``raster_training_end``: its env states after a
  few DDPG training segments, stepped once;
- ``raster_seeded_2cam``: the 1024 seeded states seen by 2 cameras;
- ``raster_probe_1cam``, ``raster_probe_2cam``: the 4096 probe poses;
- ``raster_large``: 3 x 128 probe poses seen by 2 cameras at 192 x 192, a
  frame too large to stage in shared memory (written straight to global
  memory).

For each render set it prints the share of box casts that the culled
kernel skips, by the plain predicate (``chip_smoke.cast_shares``; K5b's is
K3's rectangle and K5c's is K5a's test, so they are not printed apart).  Prints
the result as one JSON line with the card's ``nvidia-smi`` name and power
limit, and writes it to ``result.json`` in ``--out`` when given.  Exits nonzero where the trees'
outputs differ or a tree does not repeat itself.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SEED = 0
ENVS = 4096
REPS = 50
TRAIN_SEGMENTS = 3
PHYS_SETS = ("main_path", "training_end", "seeded", "wide", "ragged")
RENDER_SETS = ("main_path", "training_end", "seeded", "p2_1", "adversarial")
# slab kernel suffix → Renderer options
SLAB_KERNELS = {"": dict(), "_ratio": dict(recip=False)}
# raster set → its config's key in _configs()
RASTER_SETS = {"raster_main_path": "exact1", "raster_training_end": "exact1",
               "raster_seeded_2cam": "exact2", "raster_probe_1cam": "exact1",
               "raster_probe_2cam": "exact2", "raster_large": "exact2_192"}
# kernel suffix → Renderer options
RASTER_KERNELS = {"_raster": dict(raster=True), "_raster_hoist": dict(raster=True, hoist=True),
                  "_raster_mxu": dict(raster=True, mxu=True),
                  "_raster_hoist_mxu": dict(raster=True, hoist=True, mxu=True)}
LARGE_ENVS = 128


def _configs():
    from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
    row = dict(discrete_actions=False, use_raw_pixels=True, render_width=50, render_height=50,
               obs_pool=2, action_repeats=3, steps_per_repeat=5, solver_iterations=3)
    return {"cfg5": CartpoleConfig(num_cameras=2, obs_samples=2, **row),
            "s1": CartpoleConfig(num_cameras=1, obs_samples=1, **row),
            "exact1": CartpoleConfig(num_cameras=1, obs_samples=0, **row),
            "exact2": CartpoleConfig(num_cameras=2, obs_samples=0, **row),
            "exact2_192": CartpoleConfig(num_cameras=2, obs_samples=0, **{
                **row, "render_width": 192, "render_height": 192})}


def k6_inputs(dev) -> dict:
    """K6's starting blocks: {chain: {"varied": ..., "initial": ...}}."""
    from cartpoleplusplus_tpu_torch.utils import roofline

    return {mix: {"varied": roofline.varied(mix, roofline.SHAPE, dev),
                  "initial": roofline.initial(mix, roofline.SHAPE, dev)}
            for mix in roofline.CHAINS}


def make_inputs(path: str) -> dict:
    """Every input set on the card, saved to ``path`` → cast shares."""
    from cartpoleplusplus_tpu_torch.agents import ddpg
    from cartpoleplusplus_tpu_torch.agents.common import make_venv
    from cartpoleplusplus_tpu_torch.env import cartpole
    from cartpoleplusplus_tpu_torch.models.networks import Actor
    from cartpoleplusplus_tpu_torch.physics import soa
    from cartpoleplusplus_tpu_torch.render import raycast
    from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer

    import chip_smoke

    cfgs = _configs()
    cfg5, cfg_s1 = cfgs["cfg5"], cfgs["s1"]
    dev = torch.device("cuda")
    scene = cartpole.scene_for(cfg5)
    spr, reps = cfg5.steps_per_repeat, cfg5.action_repeats
    actor = Actor(cfg5.obs_shape, use_raw_pixels=True, height=cfg5.obs_height,
                  width=cfg5.obs_width, generator=torch.Generator().manual_seed(SEED))
    act = ddpg.greedy_act(actor)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def stepped(rigid, force):
        return soa.step_repeats_batched(scene, rigid, force, spr, reps)[1]

    sets = {}
    venv = make_venv(cfg5, ENVS)
    state, obs = venv.reset(gen)
    with torch.no_grad():
        force = cartpole.action_to_force(cfg5, act(obs))
    sets["main_path"] = (state.rigid, force, stepped(state.rigid, force))

    opts = SimpleNamespace(seed=SEED, replay_capacity=8192, twin_critic=False)
    st = ddpg.init_state(opts, cfg5, venv)
    segment = ddpg.make_segment(venv, gamma=0.99, tau=0.005, batch_size=128, warmup_steps=0,
                                steps_per_segment=20, ou_theta=0.15, ou_sigma=0.2)
    for _ in range(TRAIN_SEGMENTS):
        segment(st)
    rigid = st.env_states.rigid
    with torch.no_grad():
        force = cartpole.action_to_force(cfg5, act(st.obs))
    sets["training_end"] = (rigid, force, stepped(rigid, force))
    for name, e in (("seeded", 1024), ("wide", 8192), ("ragged", 4097)):
        rigid, force = chip_smoke.parity_inputs(scene, dev, e)
        sets[name] = (rigid, force, stepped(rigid, force) if name == "seeded" else None)

    venv_s1 = make_venv(cfg_s1, ENVS)
    state, obs = venv_s1.reset(torch.Generator(device=dev).manual_seed(SEED))
    force = torch.zeros((ENVS, 3), device=dev)
    sets["p2_1"] = (state.rigid, force, stepped(state.rigid, force))
    adv = raycast.cull_probe_poses(ENVS, SEED).to(dev)
    sets["adversarial"] = (None, None, adv[None])

    exact1 = cfgs["exact1"]
    actor1 = Actor(exact1.obs_shape, use_raw_pixels=True, height=exact1.obs_height,
                   width=exact1.obs_width, generator=torch.Generator().manual_seed(SEED))
    venv1 = make_venv(exact1, ENVS)
    state, obs = venv1.reset(torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        force = cartpole.action_to_force(exact1, actor1(obs))
    sets["raster_main_path"] = (state.rigid, force, stepped(state.rigid, force))
    st = ddpg.init_state(opts, exact1, venv1)
    segment = ddpg.make_segment(venv1, gamma=0.99, tau=0.005, batch_size=128, warmup_steps=0,
                                steps_per_segment=20, ou_theta=0.15, ou_sigma=0.2)
    for _ in range(TRAIN_SEGMENTS):
        segment(st)
    with torch.no_grad():
        force = cartpole.action_to_force(exact1, actor1(st.obs))
    sets["raster_training_end"] = (st.env_states.rigid, force,
                                   stepped(st.env_states.rigid, force))
    sets["raster_seeded_2cam"] = (sets["seeded"][0], sets["seeded"][1], sets["seeded"][2])
    sets["raster_probe_1cam"] = sets["raster_probe_2cam"] = (None, None, adv[None])
    sets["raster_large"] = (None, None, adv[: 3 * LARGE_ENVS].reshape(3, LARGE_ENVS, 16))

    saved, shares = {}, {}
    for name, (rigid, force, poses) in sets.items():
        item = {}
        if rigid is not None:
            item["packed"] = soa.pack_state(rigid).contiguous()
            item["force"] = force.t().contiguous()
            item["poses_b"] = raycast.poses_from_rigid(rigid)[None].contiguous()
        if poses is not None:
            item["poses_r"] = poses.contiguous()
            if name in RASTER_SETS:
                cfg = cfgs[RASTER_SETS[name]]
                shares[name] = {k: chip_smoke.cast_shares(scene, Renderer(cfg, dev, **opt), poses)
                                for k, opt in RASTER_KERNELS.items() if "hoist" not in k}
            else:
                rnd = Renderer(cfg_s1 if name == "p2_1" else cfg5, dev)
                shares[name] = chip_smoke.cast_shares(scene, rnd, poses)
        saved[name] = item
    saved["k6"] = k6_inputs(dev)
    torch.save(saved, path)
    return shares


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def worker(tree: str, inputs: str, out: str) -> None:
    """One tree's run: build, launch every kernel on every set, time."""
    sys.path.insert(0, os.path.abspath(tree))
    from cartpoleplusplus_tpu_torch import kernels
    from cartpoleplusplus_tpu_torch.env import cartpole
    from cartpoleplusplus_tpu_torch.physics import cuda_step
    from cartpoleplusplus_tpu_torch.render import cuda_render
    from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer
    from cartpoleplusplus_tpu_torch.utils import roofline

    sys.path.insert(1, REPO)
    import chip_smoke  # this tree's timing helpers; the kernels are `tree`'s

    assert os.path.dirname(kernels.__file__).startswith(os.path.abspath(tree))
    info = kernels.build()
    cfgs = _configs()
    cfg5, cfg_s1 = cfgs["cfg5"], cfgs["s1"]
    dev = torch.device("cuda")
    scene = cartpole.scene_for(cfg5)
    spr, reps, n_push = cfg5.steps_per_repeat, cfg5.action_repeats, cfg5.initial_force_steps
    phys_p = cuda_step.phys_params(scene)
    sets = torch.load(inputs, map_location=dev)
    outputs, ms, variants, device = {}, {}, {}, {}
    for name, item in sets.items():
        if "packed" in item and name in PHYS_SETS:
            packed, force = item["packed"], item["force"]
            e = packed.shape[1]
            s1, s2 = torch.empty_like(packed), torch.empty_like(packed)
            poses = torch.empty((reps, e, 16), device=dev)
            k1 = lambda: cuda_step.launch(phys_p, packed, force, s1, poses, reps, spr)
            k2 = lambda: cuda_step.launch(phys_p, packed, force, s2, None, 1, n_push)
            k1()
            k2()
            torch.cuda.synchronize()
            outputs[f"{name}/step_repeats"] = (s1.cpu(), poses.cpu())
            outputs[f"{name}/step_substeps"] = (s2.cpu(),)
            ms[f"{name}/step_repeats"], ms[f"{name}/step_substeps"] = time_ms(k1), time_ms(k2)
        if name not in RENDER_SETS:
            continue
        for suffix, opts in SLAB_KERNELS.items():
            rnd = Renderer(cfg_s1 if name == "p2_1" else cfg5, dev, **opts)
            params = rnd.kernel_params(scene)
            for kernel, key in (("render_repeats", "poses_r"), ("render_batched", "poses_b")):
                if key not in item:
                    continue
                p = item[key]
                frames = torch.empty((p.shape[1], p.shape[0], rnd.frame_width), dtype=torch.uint8,
                                     device=dev)
                fn = lambda rnd=rnd, params=params, p=p, frames=frames: rnd.launch(
                    params, p, frames)
                fn()
                torch.cuda.synchronize()
                label = f"{name}/{kernel}{suffix}"
                outputs[label] = (frames.cpu(),)
                ms[label] = time_ms(fn)
                if suffix:  # K5b: its cull rectangles as they are, and widened to the plane
                    for form, ray_abs in (("on", rnd.ray_abs), ("off", float("inf"))):
                        vp = rnd.kernel_params(scene)
                        vp.ray_abs = ray_abs
                        variants[f"{label}@{form}"] = time_ms(
                            lambda rnd=rnd, vp=vp, p=p, frames=frames: rnd.launch(vp, p, frames))
    # The raster cull on and off, where this tree's kernels have the switch.
    culls = {}
    if "cull" in dict(cuda_render.RenderParams._fields_):
        culls = {"on": 1, "off": 0}
    shapes = {}
    for name, cfg_key in RASTER_SETS.items():
        item = sets[name]
        for suffix, opts in RASTER_KERNELS.items():
            rnd = Renderer(cfgs[cfg_key], dev, **opts)
            shapes[name] = (cfgs[cfg_key].obs_height, cfgs[cfg_key].obs_width)
            params = rnd.kernel_params(scene)
            for kernel, key in (("render_repeats", "poses_r"), ("render_batched", "poses_b")):
                if key not in item:
                    continue
                p = item[key]
                setups = None
                if rnd.hoist:  # the setup pass once, outside the render's timing
                    setups = torch.empty((*p.shape[:2], rnd.setup_width), device=dev)
                    pack = lambda params=params, p=p, setups=setups: rnd.launch_pack(
                        params, p, setups)
                    pack()
                    torch.cuda.synchronize()
                    if suffix == "_raster_hoist":  # K5c's setup pass: its table and times
                        label = f"{name}/pack_setups_{kernel}"
                        outputs[label] = (setups.cpu(),)
                        ms[label] = time_ms(pack)
                        device[label] = chip_smoke.kernel_device_ms(pack)
                frames = torch.empty((p.shape[1], p.shape[0], rnd.frame_width), dtype=torch.uint8,
                                     device=dev)
                fn = lambda params=params, p=p, frames=frames, setups=setups: rnd.launch(
                    params, p, frames, setups)
                fn()
                torch.cuda.synchronize()
                label = f"{name}/{kernel}{suffix}"
                outputs[label] = (frames.cpu(),)
                ms[label] = time_ms(fn)
                if suffix == "_raster_hoist_mxu":
                    continue
                for form, cull in culls.items():
                    vp = rnd.kernel_params(scene)
                    vp.cull = cull
                    variants[f"{label}@{form}"] = time_ms(
                        lambda vp=vp, p=p, frames=frames, setups=setups: rnd.launch(
                            vp, p, frames, setups))
    rates = {}
    for mix, item in sets["k6"].items():
        as_int = torch.int16 if item["varied"].dtype == torch.bfloat16 else torch.int32
        for start, iters in (("varied", chip_smoke.K6_PARITY_ITERS),
                             ("initial", chip_smoke.K6_ROW_ITERS)):
            x = item[start]
            y = torch.empty_like(x)
            fn = lambda mix=mix, x=x, y=y, iters=iters: roofline.launch(mix, x, y, iters)
            fn()
            torch.cuda.synchronize()
            outputs[f"k6/{mix}@{start}_{iters}"] = (y.view(as_int).cpu(),)
            if start == "initial":
                ms[f"k6/{mix}"] = time_ms(fn)
        rates[mix] = roofline.measure_chain(mix)["el_ops_per_s"]
    torch.save({"outputs": outputs, "ms": ms, "variants_ms": variants, "device_ms": device,
                "shapes": shapes, "k6_el_ops_per_s": rates,
                "ptxas": info["log"], "nvcc_s": info["nvcc_s"]}, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory holding the other tree's package")
    ap.add_argument("--out", help="directory to write result.json into")
    ap.add_argument("--worker", nargs=3, metavar=("TREE", "INPUTS", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        worker(*args.worker)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, REPO)
    import chip_smoke

    t0 = time.monotonic()
    trees = {"A": os.path.abspath(args.parent), "B": REPO}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:  # inputs and outputs: hundreds of MB
        inputs = os.path.join(tmp, "inputs.pt")
        shares = make_inputs(inputs)
        for i, tag in enumerate("ABBA"):
            out = os.path.join(tmp, f"run{i}_{tag}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[tag],
                            inputs, out], check=True, timeout=900)
            runs.append(torch.load(out))
    equal, mxu_vs_a, k5c_equals_k5a, ok = {}, {}, {}, True
    for key in runs[0]["outputs"]:
        same = lambda x, y: all(torch.equal(a, b) for a, b in zip(x["outputs"][key],
                                                                  y["outputs"][key]))
        equal[key] = {"a_vs_b": same(runs[0], runs[1]) and same(runs[3], runs[2]),
                      "repeatable": same(runs[0], runs[3]) and same(runs[1], runs[2])}
        if key.endswith("_mxu"):  # K5d: where its frames differ from the other tree's
            h, w = runs[1]["shapes"][key.split("/")[0]]
            got, want = runs[1]["outputs"][key][0], runs[0]["outputs"][key][0]
            mxu_vs_a[key] = {"bytes_differing": int((got != want).sum()),
                             **chip_smoke.silhouette_stats(got, want, h, w)}
            ok = ok and equal[key]["repeatable"]
        else:
            ok = ok and all(equal[key].values())
        if key.endswith("_raster_hoist"):  # each tree's K5c against its own K5a
            k5a = key.removesuffix("_hoist")
            k5c_equals_k5a[key] = {tag: torch.equal(runs[i]["outputs"][key][0],
                                                    runs[i]["outputs"][k5a][0])
                                   for tag, i in (("A", 0), ("B", 1))}
            ok = ok and all(k5c_equals_k5a[key].values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    ms = {k: [r["ms"][k] for r in runs] for k in runs[0]["ms"]}
    device = {k: [r["device_ms"][k] for r in runs] for k in runs[0]["device_ms"]}
    rates = {k: [r["k6_el_ops_per_s"][k] for r in runs] for k in runs[0]["k6_el_ops_per_s"]}
    result = {
        "trees": trees, "order": "ABBA", "card": smi, "reps": REPS,
        "ms": ms,
        "ratio_b_over_a": {k: (v[1] + v[2]) / (v[0] + v[3]) for k, v in ms.items()},
        "device_ms": device,
        "device_ratio_b_over_a": {k: (v[1] + v[2]) / (v[0] + v[3]) for k, v in device.items()
                                  if None not in v},
        "k6_el_ops_per_s": rates,
        "k6_rate_ratio_b_over_a": {k: (v[1] + v[2]) / (v[0] + v[3]) for k, v in rates.items()},
        "equal": equal, "k5d_b_vs_a": mxu_vs_a, "k5c_equals_k5a": k5c_equals_k5a,
        "skipped_cast_share": shares,
        "variants_ms": {tag: runs[i]["variants_ms"] for tag, i in (("A", 0), ("B", 1))},
        "ptxas": {tag: {k: v for k, v in chip_smoke.ptxas_usage(runs[i]["ptxas"]).items()
                        if re.search(r"phys_kernel|render_slab_kernel|render_kernel|"
                                     r"render_raster|pack_setups|chain_", k)}
                  for tag, i in (("A", 0), ("B", 1))},
        "nvcc_s": {"A": runs[0]["nvcc_s"], "B": runs[1]["nvcc_s"]},
        "seconds": time.monotonic() - t0, "ok": ok,
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
