#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cartpoleplusplus_tpu_torch/csrc`` with plain
nvcc, holds each kernel against its plain PyTorch version on the card, then
drives the port's paths at full width (4096 envs, 50×50 renders, obs_pool 2,
3 repeats × 5 substeps, 3 solver iterations), each with the launch counts
set to 0 just before it and read just after:

- acting at config 5 (2 cameras, obs_samples 2, slab render): a greedy DDPG
  actor with seeded random weights runs full evaluation rollouts, then
  windows of lazily auto-resetting steps, each over half a second;
- DDPG training as the bench trains (``utils/benchmark.py``: its
  ``build`` with its hyperparameters, replay 8192, batch 128, 20 steps per
  segment, Adam 1e-4/1e-3, γ 0.99, τ 0.005, warmup 0, OU θ 0.15 σ 0.2;
  one warm segment, then its timed windows and their best rate) at
  config 5 and at the 1-camera exact row (obs_samples 0, raster render,
  K5a), and at three rows of the render kernel's other modes, each a
  bench flag: config 5 with ``--no-render-recip`` (K5b), the 1-camera
  exact row with ``--raster-hoist`` (K5c) and with ``--render-mxu`` (K5d);
- one TD3 segment at the 1-camera exact row;
- the low-dim path at 8192 envs (the bench's fourth row, no renderer): K1's
  frames and states byte-equal to the JAX venv's per-repeat composition run
  through the port's kernels (K2 per repeat, then ``observe_lowdim``) on
  the main path's reset states and on seeded states, then a training row
  as above;
- the card's element-op rate probe (K6): six op chains timed at N and 2N
  iterations;
- the port's bench (``bench_torch.py``'s four-row suite, its parent run in
  this process, each row in a child process of its own): four row lines
  and the summary, every row on the card with its mix rate measured there
  and its child's seconds split by stage (``_split_s``), the low-dim row's
  metric without ``_pixel_render``;
- the conv pixel encoder (``conv``): the JAX pixel-TD3 checkpoint
  (an xz copy of ``runs/ckpt_pixels_td3/ckpt_15000.msgpack`` in
  ``chip_inputs/``, its bytes checked by sha256, read by
  ``utils/params.ddpg_params_from_jax_checkpoint``) in a conv actor and
  twin critic on the card against the same modules on the CPU, on the
  checkpoint's 512 observations (25×25×18 NHWC → 512 → (100, 50)), within
  the bf16 bound 2e-2, each timed;
- the cross-load (``crossload``): that actor's greedy eval on a 64-env
  venv of the recipe's config (2 cameras, exact: K5a) over 5 generator
  seeds, beside the JAX run's recorded final and the JAX package's own
  eval of the checkpoint on the CPU;
- the DDPG program (``ddpg_cli``): ``ddpg.main`` in-process at config 5
  with the TD3 stabilizers and the conv encoder, 4096 envs: 2 segments, a
  resume to 4, a ``--ckpt-skip-replay`` save and resume, ``--eval-only``
  on the latest and the best checkpoint; finite losses, the JAX jsonl
  fields, monotonic env steps and checkpoint numbers, restored networks
  and the whole restored state (replay, optimizers, env states,
  generator) byte-equal to the saved ones, the eval-only eval equal to a
  fresh eval of the in-memory actor; its first run with ``--tb-dir`` (the
  logdir's scalars those of the run's ``train`` events where tensorboard
  imports) and ``--export-policy``, its first ``--eval-only`` run with
  ``--export-policy``;
- the SAC cross-load (``sac_crossload``): the JAX config-5 SAC checkpoint's
  GaussianActor (its leaves in ``chip_inputs/sac_cfg5_15000_actor.npz``,
  sha256 checked) on the card against the CPU on the eval's first
  observations (bf16 bound), then its greedy eval on 64 envs of config 5
  (slab: K1-K4) over 5 generator seeds, beside the JAX run's recorded
  final and the JAX package's own eval of the checkpoint on the CPU;
- the SAC program (``sac_cli``): ``sac.main`` in-process with the config-5
  pixel recipe at full width (512 envs, conv encoder, replay 16384, batch
  256) through the runs of ``ddpg_cli``, with its checks and SAC's own
  (alpha at or above ``--alpha-min``, ``log_alpha`` and ``alpha_opt`` in
  the checkpoint);
- the replay extensions (``replay_ext``): ``ddpg.main`` at config 5 with
  ``--per --n-step 3`` (replay of 4 blocks of 4096 envs, the TD3 flags of
  ``ddpg_cli``), 2 segments; inserts carry the running max priority,
  write-backs ``|td| + per_eps``, and on the card's own replay
  ``sample_prioritized`` and ``nstep_batch`` equal the CPU's on the same
  uniforms, up to indices at CDF boundaries within the two cumsums'
  rounding gap;
- the on-policy programs (``ppo_cli``, ``lrpg_cli``): ``ppo.main`` and
  ``lrpg.main`` in-process at config 5 (slab: K1-K4), 512 envs, the conv
  encoder at the default widths; PPO with 32-step rollouts, 4 epochs × 4
  minibatches and the cosine schedule, LRPG with 40-step episodes: 2
  updates, a resume to 4 (both with ``--ckpt-best``), ``--eval-only`` on
  the latest and the best checkpoint; finite losses, the JAX jsonl fields,
  the update and env-step numbering, the restored state (networks,
  optimizer, env states, obs, generator, ``update``) byte-equal to the
  saved one (at updates 2 and 4, which the resume and the eval-only run
  restore), the eval-only eval equal to a fresh eval of the in-memory
  policy, K2 and K4 launched on every update (its reset), PPO's
  ``clip_frac`` in [0, 1], LRPG's sampled actions indices in [0, 5) and its
  episodes at most 40 steps;
- the JAX full Rainbow checkpoint's QNetwork card against CPU and its
  greedy eval on 64 low-dim envs (``dqn_crossload``), and the DQN program
  with the Rainbow flags at config 5 (``dqn_cli``), ``--export-policy`` on
  its first run and its first ``--eval-only`` run;
- the serving artifacts (``export``): ``ddpg_cli``'s and ``dqn_cli``'s
  ``torch.export`` programs, and one exported on the CPU here from the same
  weights, loaded on the card and run on 1, 64 and 4096 config-5 frames
  against the direct greedy act (actions within the bf16 bound 2e-2;
  discrete ones equal where the top two atom means are further apart), the
  card run's loaded on the CPU and equal to the CPU's greedy act bit for
  bit, with bytes, the export's seconds and ms per call at 4096 frames;
- the NAF program (``naf_cli``): ``naf.main`` in-process at config 5 with
  batch norm and the NAF recipe's optimiser flags (512 envs, conv encoder,
  replay 8192, batch 256) through the runs of ``ddpg_cli``, with its
  checks and NAF's own (the whole restored state byte-equal to the saved
  one, the batch statistics moved, the first update's target step the
  Polyak step of parameters and statistics), then three updates of its
  saved network card against CPU: V, µ and ``l_entries`` within the bf16
  bound, the running statistics within 1e-3 in norm; its first
  ``--eval-only`` run also records ``--event-log-out``, whose 3 episodes
  must match the ``event_log`` metrics line;
- the per-env surface (``per_env``): the AoS engine card against CPU (one
  substep within 1e-5, the reset's 30-substep push within 1e-4),
  ``gym_env.Cartpole`` at config 5
  (K4 and K3 at one env), 1cam_exact (K5a at one env) and low-dim on the
  card and the CPU (seconds per reset and per step; every frame the card
  renders held against its plain version on the same poses), one
  fresh-reset ``VectorCartpole.step`` at 4096 envs (K1-K4 once each), and
  ``random_agent.main`` low-dim with ``--event-log-out --record-renders``
  (K4 at one env, the slab cast as in the JAX agent; its frames held
  against the plain version too and the log's PNGs against its frames),
  read back and held to its metrics;
- the fidelity harness (``fidelity``): that log re-simulated by the
  fidelity CLI on the card (``--tolerance``, exit 0) and by
  ``resim_episode`` on the CPU, ``max_pos_err`` of each, and the CLI's exit
  1 on a copy with one pose moved by 1 cm;
- the trajlog codec (``native``): ``native/trajlog.cpp`` built by g++ under
  the port's ``_build/``, ``native_available()``, and the same records
  written by the native and the Python codec byte-equal and read back by
  each other;
- data parallelism on the one card (``parallel``): (a) ``ddpg.main`` with
  ``ddpg_cli``'s config-5 flags at full width and ``--num-devices 2``, one
  launcher whose two spawned ranks share the card over gloo (2048 envs,
  replay 4096 and batch 64 each), 2 segments of 5 steps (``ddpg_cli``'s
  take 20), the global ``ckpt_2.pt``;
  (b) two launchers (``--num-processes 2 --num-devices 2 --coordinator``,
  each a process of one rank, started with (a) and held, imported and with
  its CUDA context, until (a)'s file is written; then ``ddpg.main``) resume
  from it to segment 3:
  both restore at 2 and train segment 3 alone, their rank files hold
  byte-equal networks and optimizers and different env shards, and only
  rank 0 writes metrics; (c) a 1-rank NCCL group in this process runs one
  config-5 segment byte-equal to the plain segment from the same state,
  while (b)'s launchers start.
  K1-K4 launch on every rank; each rank's launches, backend and seconds per
  segment are printed beside ``ddpg_cli``'s.

Each kernel is held against its plain version on seeded states and on the
paths' own inputs and timed there (``parity_modes`` for K5b-K5d, with K5c
byte-equal to K5a and K5d within the silhouette rule of K5a;
``parity_owed`` for K3/K4 at one sample per pooled pixel, on poses chosen
to break the slab kernel's cull (``raycast.cull_probe_poses``) and at two
frame sizes too large to stage three repeats of in shared memory, and
K1/K2 at 8192 envs and at 4097, a count that is not a multiple of 32;
``parity_training_end`` for K3 on poses from the end of the config-5
training row, where it is also timed); torch.profiler traces of a few
acting steps and of one training segment of config 5 and of the low-dim
row give the card's busy share and the learner's share of it.  On every slab pose set the cull of
K3/K4 and of K5b is checked where it could fail (``cull_check``: no
skipped cast that the plain cast of the mode hits, frames byte-equal to
the kernel's own with culling off, and K5b's byte-equal to the plain ratio
version's) and the share of box casts it skips is printed; likewise K5a's,
K5c's and K5d's cull on every raster pose set (``raster_cull_check`` in
``parity_raster_cull`` and ``parity_training_end``: the 1cam_exact row's
main-path and training-end poses, seeded states and the probe's poses
seen by 2 cameras, the probe's seen by 1, and a frame too large to stage
in shared memory), where K5a and K5c must also equal the plain raster byte
for byte and K5d keep the silhouette rule against K5a and its plain
version.  K5c's setup pass is held byte-equal to ``raycast.pack_setups``.
Each phase prints one JSON line with the elapsed seconds and its own
(``phase_s``); the line before
the last two holds every kernel's launches, error, time, bound, registers
and spills (every render kernel culls: its bound counts the work these
inputs need, with the full-work bound beside it); the last line is
``{"ok": true, "device": {...}}``.

A watchdog turns a hang into a traceback and a nonzero exit after 300 s;
the ranks of ``parallel`` have a time limit of their own
(``PARALLEL_RANK_TIMEOUT_S``) and are killed at it.
Without CUDA, or without the port beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import faulthandler
import hashlib
import importlib.util
import io
import json
import lzma
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cartpoleplusplus_tpu_torch import kernels, parallel
from cartpoleplusplus_tpu_torch.agents import common, ddpg, dqn, lrpg, naf, ppo, random_agent, sac
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.agents.ddpg import greedy_act
from cartpoleplusplus_tpu_torch.env import cartpole, gym_env
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.env.vector import resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import (
    Actor, DiscretePolicy, GaussianActor, NAFNetwork, QNetwork, TwinCritic)
from cartpoleplusplus_tpu_torch.physics import cuda_step, engine, soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import (
    RASTER_FRAME_BYTES, Renderer, slab_blocking)
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.utils import (
    benchmark, checkpoint, event_log, export, fidelity, native, roofline)
from cartpoleplusplus_tpu_torch.utils.benchmark import device_events
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.parallel.mesh import free_port
from cartpoleplusplus_tpu_torch.utils.params import (
    ddpg_params_from_jax_checkpoint, gaussian_actor_params_from_flax, q_network_params_from_flax,
    unflatten_tree)

WATCHDOG_S = 300
SEED = 0
NUM_ENVS = 4096
PARITY_ENVS = 1024
OWED_PHYS_ENVS = 8192  # K1/K2 parity at twice the main path's width
RAGGED_ENVS = 4097     # K1/K2 parity at a count that is not a multiple of 32
PROBE_POSES = 4096     # raycast.cull_probe_poses: poses chosen to break K3's cull
# Acting at config 5: 2 eval rollouts and 2 sim-only windows (cut in depth
# from 3 each to make room for the on-policy phases under the watchdog).
SIM_ONLY_WINDOWS = 2
EVAL_ROLLOUTS = 2
SIM_ONLY_STEPS = 350  # per window: over half a second at 1.6-1.9 ms per step
PROFILE_STEPS = 20
# Training rows split by a profiled segment (profile phase): config 5 and the
# low-dim row.  The other rows are timed and checked in their train phases;
# profiling them too would take the script past its watchdog on a slow host
# (the 1-camera exact row, whose split is config 5's within 0.3 ms of
# device time per step, left the profile when the on-policy phases came).
PROFILE_ROWS = ("2cam_samples2", "lowdim")
# Runs of each plain version in the kernels line (after one warm-up run).
PLAIN_REPS = 1
# Published H100 SXM peaks: HBM bandwidth and float32 (non-tensor-core)
# rate; the non-tensor-core bfloat16 rate is twice the float32 one
# (NVIDIA's Hopper architecture whitepaper: 133.8 TFLOP/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 133.8e12
# Tolerances: physics atol, pixel levels (|Δ| ≤ 2 on ≥ 99.9%, mean < 0.5).
PHYS_ATOL = 1e-5
PIX_LEVEL, PIX_SHARE, PIX_MEAN = 2, 0.999, 0.5
# K5d against K5a and its plain version (tests/test_raster_render.py's rule
# for the product's rounding): under 1e-3 of bytes differ, and every
# differing pixel lies within one pixel of a silhouette edge of more than 4
# levels.
SIL_SHARE, SIL_EDGE = 1e-3, 4
# K6 against its fused plain chains (each multiply-add rounded once, as
# FFMA/HFMA2 do) after K6_PARITY_ITERS iterations from roofline.varied's
# distinct starts: float32 within 1e-6 (a few ulp; recip_f32's reciprocal
# is approximate in the kernel), bfloat16 within one ulp below 0.5 (2^-9),
# and either within K6_MOVE_SHARE of how far the plain chain moved.  The
# chains move 3e-5 (mix_f32) to 1.1 (recip_f32, div_f32) there.
K6_PARITY_ITERS = 256
K6_ATOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-9}
K6_MOVE_SHARE = 0.01
K6_ROW_ITERS = 1000  # the chains' iterations in the kernels line

_ROW = dict(discrete_actions=False, use_raw_pixels=True, render_width=50, render_height=50,
            obs_pool=2, action_repeats=3, steps_per_repeat=5, solver_iterations=3)
CONFIG5 = CartpoleConfig(num_cameras=2, obs_samples=2, **_ROW)        # 2cam_samples2
CONFIG1_EXACT = CartpoleConfig(num_cameras=1, obs_samples=0, **_ROW)  # 1cam_exact
CONFIG2_EXACT = CartpoleConfig(num_cameras=2, obs_samples=0, **_ROW)  # raster parity only
CONFIG1_S1 = CartpoleConfig(num_cameras=1, obs_samples=1, **_ROW)     # 1cam_samples1: p2 = 1
# Frames larger than the slab kernel stages in shared memory for 3 repeats:
# config 5 at 192 x 192 (a frame over SLAB_FRAME_BYTES: written straight to
# global memory) and one camera unpooled at 124 x 124 (one repeat per block).
CONFIG5_WIDE = CartpoleConfig(num_cameras=2, obs_samples=2,
                              **{**_ROW, "render_width": 192, "render_height": 192})
CONFIG1_UNPOOLED = CartpoleConfig(num_cameras=1, obs_samples=1, **{
    **_ROW, "render_width": 124, "render_height": 124, "obs_pool": 1})
# A raster frame over RASTER_FRAME_BYTES: 2 cameras exact at 192 x 192
# (written straight to global memory).
CONFIG2_EXACT_WIDE = CartpoleConfig(num_cameras=2, obs_samples=0,
                                    **{**_ROW, "render_width": 192, "render_height": 192})
LARGE_FRAME_ENVS = 256
# The bench's low-dim row: 8192 envs, no renderer.
LOWDIM_ENVS = 8192
# The bench phase runs bench_torch.py's suite parent in this process, which has
# torch imported and the kernels built (a child process would pay an
# interpreter's start and the imports again, about 10 s on an H100 host), and
# each of the suite's rows in a child of its own, as the suite does.  A row child is killed at its timeout: BENCH_ROW_TIMEOUT_S, or
# less where the four would not end BENCH_MARGIN_S before this script's own
# watchdog fires.
BENCH_ROW_TIMEOUT_S = 60
BENCH_MARGIN_S = 10

# The JAX package's pixel-TD3 checkpoint (scripts/pixel_td3_artifacts.sh: 2
# cameras, obs_pool 2, the conv encoder, twin critics; 512 envs' obs), read
# by the conv and crossload phases from an xz copy of
# runs/ckpt_pixels_td3/ckpt_15000.msgpack: runs/ stays out of chip copies, and
# a copy of 9 MiB would take the copy past its size limit.  Its decompressed
# bytes must have the checkpoint's sha256 (tests/test_torch_conv.py pins both).
# The recipe's config is CONFIG2_EXACT.
TD3_CKPT = os.path.join("chip_inputs", "ckpt_pixels_td3_15000.msgpack.xz")
TD3_CKPT_SHA256 = "b25b20ab53614cd00c8843cade2c73c29eaa59cdb02dd23ad84c5a77f5e28f78"
TD3_NET = dict(use_raw_pixels=True, height=25, width=25, pixel_encoder="conv")
CONV_ATOL = 2e-2  # bf16 bound of tests/test_torch_slice.py (actions and Q)
CROSSLOAD_ENVS = 64
CROSSLOAD_SEEDS = 5
# The JAX references for the cross-loaded policy's greedy eval: the TPU
# run's recorded final eval (runs/ddpg_pixels_td3_art.jsonl, segment 15000)
# and the JAX package's own greedy eval of the same checkpoint on the CPU,
# 5 keys × 64 envs, XLA raster (scripts/jax_td3_eval_cpu.py, kept in
# runs/jax_td3_eval_cpu.jsonl); the port's mean should lie in that range
# widened by CROSSLOAD_WIDEN steps.
JAX_RECORDED_TD3 = {"eval_ep_len": 162.578125, "eval_ep_rew": 162.25}
JAX_CPU_TD3_LENS = (171.59375, 180.328125, 185.453125, 162.671875, 182.671875)
CROSSLOAD_WIDEN = 10.0
# The CLI phases' episodes end at CLI_MAX_LEN steps, and SAC's, DQN's and
# NAF's segments take CLI_STEPS steps: cuts in depth from the recipes' 200 and
# 25 that keep the script inside its watchdog on a slow host.  A greedy eval
# runs max_episode_len steps whatever its envs do, and the policies of these
# few segments fall within about 10.
CLI_MAX_LEN = 50
CLI_STEPS = 10
CONFIG5_CLI = dataclasses.replace(CONFIG5, max_episode_len=CLI_MAX_LEN)
# The DDPG CLI at config 5, full width (ddpg_cli phase); the TD3 recipe's
# stabilizers and its conv encoder.
CLI_ARGV = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --num-envs 4096 "
            "--replay-capacity 8192 --batch-size 128 --steps-per-segment 20 --warmup-steps 1 "
            f"--num-eval 64 --eval-freq 2 --max-episode-len {CLI_MAX_LEN} --twin-critic "
            "--policy-delay 2 --target-noise 0.2 --aug-shift 2 --pixel-encoder conv "
            "--ckpt-freq 1").split()
TRAIN_FIELDS = ["ts", "elapsed_s", "event", "segment", "env_steps", "critic_loss", "actor_loss",
                "mean_reward", "double_reset_frac", "eval_ep_len", "eval_ep_rew"]
EVENT_FIELDS = {"train": TRAIN_FIELDS, "restore": ["ts", "elapsed_s", "event", "step"],
                "eval_only": ["ts", "elapsed_s", "event", "segment", "eval_ep_len", "eval_ep_rew"],
                "event_log": ["ts", "elapsed_s", "event", "episodes", "lengths"],
                "export_policy": ["ts", "elapsed_s", "event", "path", "bytes"]}

# The JAX package's config-5 SAC checkpoint (BASELINE.md "Round 5: SAC
# solves at the PRODUCTION bench config": 2 cameras, obs_pool 2, obs_samples
# 2, conv encoder, 512 envs), its GaussianActor's leaves by flax path in an
# npz (scripts/export_sac_actor_npz.py from
# runs/ckpt_sac_cfg5_s0/ckpt_15000.msgpack; tests/test_torch_sac.py holds
# it equal to the checkpoint).  Its eval config is CONFIG5 (slab: K1-K4).
SAC_ACTOR = os.path.join("chip_inputs", "sac_cfg5_15000_actor.npz")
SAC_ACTOR_SHA256 = "c5f49bdcee669b7a1b093a9e5c3223169089269c43f1d11f0b8cf4226c74194e"
# The JAX references: the TPU run's recorded final eval
# (runs/sac_cfg5_s0.jsonl, segment 15000) and the JAX package's own greedy
# eval of the checkpoint on the CPU, 5 keys × 64 envs, XLA slab
# (scripts/jax_sac_eval_cpu.py, kept in runs/jax_sac_eval_cpu.jsonl).
JAX_RECORDED_SAC = {"segment": 15000, "eval_ep_len": 200.0, "eval_ep_rew": 200.0}
JAX_CPU_SAC_LENS = (198.28125, 200.0, 197.9375, 198.59375, 198.0)
# The SAC program at config 5 (sac_cli phase): the pixel SAC recipe
# (scripts/chip_queue6.sh's sac_pixels_fix) at obs_samples 2, short runs, with
# the recipe's --ckpt-freq 5000, so each run writes its replay only at its end
# and at a new best; the replay holds 16384 (32 blocks of 512, 0.18 GB), a cut
# in depth from the recipe's 65536 that shortens each write and read.
SAC_ENVS = 512
SAC_REPLAY = 16384
SAC_ALPHA_MIN = 0.02
SAC_ARGV = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --pixel-encoder conv "
            f"--num-envs {SAC_ENVS} --replay-capacity {SAC_REPLAY} --batch-size 256 "
            f"--steps-per-segment {CLI_STEPS} --max-episode-len {CLI_MAX_LEN} "
            "--actor-learning-rate 1e-4 --critic-learning-rate 3e-4 "
            "--lr-schedule cosine --reward-scale 0.1 --grad-clip 10 --aug-shift 2 "
            f"--alpha-min {SAC_ALPHA_MIN} --warmup-steps 1 --num-eval 64 --eval-freq 2 "
            "--ckpt-freq 5000").split()
SAC_TRAIN_FIELDS = TRAIN_FIELDS[:7] + ["alpha", "entropy"] + TRAIN_FIELDS[7:]
SAC_EVENT_FIELDS = {**EVENT_FIELDS, "train": SAC_TRAIN_FIELDS}
# Prioritized replay and 3-step returns in DDPG at config 5 (replay_ext
# phase): ddpg_cli's TD3 flags, a replay of 4 blocks of 4096 envs, 2
# segments; the sampler held card against CPU on REPLAY_EXT_DRAWS draws.
REPLAY_EXT_ARGV = [*CLI_ARGV[:CLI_ARGV.index("--replay-capacity")],
                   "--replay-capacity", "16384",
                   *CLI_ARGV[CLI_ARGV.index("--replay-capacity") + 2:CLI_ARGV.index("--ckpt-freq")],
                   "--per", "--n-step", "3", "--num-train-batches", "2"]
REPLAY_EXT_DRAWS = 4096
# The on-policy programs at config 5 (ppo_cli, lrpg_cli phases): 512 envs
# (the pixel recipes' count), the conv encoder at the default widths [100,
# 50].  PPO's rollout is 32 steps (the recipe's is 128: a cut in depth that
# keeps the obs buffer near 0.2 GB), 4 epochs × 4 minibatches of 4096; LRPG's
# episodes are capped at 40 steps (the recipe's 200: a cut in depth).
ONPOLICY_ENVS = 512
PPO_ROLLOUT = 32
PPO_ARGV = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --pixel-encoder conv "
            f"--num-envs {ONPOLICY_ENVS} --rollout-steps {PPO_ROLLOUT} --ppo-epochs 4 "
            "--ppo-minibatches 4 --learning-rate 3e-4 --lr-schedule cosine --reward-scale 0.1 "
            "--grad-clip 0.5 --num-eval 64 --eval-freq 1 --ckpt-freq 1 "
            f"--max-episode-len {CLI_MAX_LEN}").split()
PPO_TRAIN_FIELDS = ["ts", "elapsed_s", "event", "update", "env_steps", *ppo.METRIC_KEYS,
                    "eval_ep_len", "eval_ep_rew"]
LRPG_MAX_LEN = 40
LRPG_ARGV = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --pixel-encoder conv "
             f"--num-envs {ONPOLICY_ENVS} --max-episode-len {LRPG_MAX_LEN} --num-eval 64 "
             "--eval-freq 1 --ckpt-freq 1").split()
LRPG_TRAIN_FIELDS = ["ts", "elapsed_s", "event", "update", "loss", "train_ep_len",
                     "train_ep_rew", "eval_ep_len", "eval_ep_rew"]

# The JAX package's full Rainbow DQN checkpoint (scripts/chip_queue6.sh step 2:
# low-dim, 128 envs, dueling, C51 with 51 atoms on [0, 10], NoisyNet heads, PER,
# 3-step returns, double-Q), its online QNetwork's leaves in an npz
# (scripts/export_dqn_q_npz.py from runs/ckpt_dqn_rainbow/ckpt_50000.msgpack;
# tests/test_torch_dqn.py holds it equal to the checkpoint).  Its eval config
# is the default low-dim discrete one (K1, K2).
DQN_Q = os.path.join("chip_inputs", "dqn_rainbow_50000_q.npz")
DQN_Q_SHA256 = "4a90bf40f9789fb2394bc2e635798d1a4e90cca77694569e88794a9687e895a0"
DQN_NET = dict(dueling=True, num_atoms=51, noisy=True)
CONFIG_DQN = CartpoleConfig(discrete_actions=True)
# The JAX references: the TPU run's recorded final eval and its eval-only run of
# the checkpoint (runs/dqn_rainbow_s0.jsonl, runs/dqn_rainbow_eval.jsonl, segment
# 50000) and the JAX package's own greedy eval of the checkpoint on the CPU, 5
# keys × 64 envs (scripts/jax_dqn_eval_cpu.py, kept in runs/jax_dqn_eval_cpu.jsonl).
JAX_RECORDED_DQN = {"segment": 50000, "eval_ep_len": 198.703125, "eval_ep_rew": 198.671875,
                    "eval_only_ep_len": 195.921875}
JAX_CPU_DQN_LENS = (198.171875, 195.921875, 198.578125, 198.34375, 195.359375)
# The DQN program at config 5 (dqn_cli phase): the full Rainbow flags of the
# recipe (--per --n-step 3 --dueling --c51 51 --c51-vmax 10 --noisy, reward
# scale 0.1, clip 10, batch 256, cosine) on the conv encoder at the default
# widths, 512 envs (the pixel recipes' count), and a replay of 8192 (16 blocks
# of 512), a cut in depth from the recipe's 131072.
DQN_ENVS = 512
DQN_ARGV = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --pixel-encoder conv "
            f"--num-envs {DQN_ENVS} --replay-capacity 8192 --batch-size 256 "
            f"--steps-per-segment {CLI_STEPS} --max-episode-len {CLI_MAX_LEN} "
            "--warmup-steps 1 --lr-schedule cosine --reward-scale 0.1 "
            "--grad-clip 10 --per --n-step 3 --dueling --c51 51 --c51-vmax 10 --noisy "
            "--num-eval 64 --eval-freq 2 --ckpt-freq 1").split()
DQN_TRAIN_FIELDS = ["ts", "elapsed_s", "event", "segment", "env_steps", "loss", "eps",
                    "mean_reward", "eval_ep_len", "eval_ep_rew"]
DQN_EVENT_FIELDS = {**EVENT_FIELDS, "train": DQN_TRAIN_FIELDS}
# The NAF program at config 5 (naf_cli phase): scripts/sweep.sh's NAF recipe's
# optimiser and exploration flags (lr 3e-4 cosine, reward scale 0.1, clip 10,
# OU σ annealed to 0.05 over 100000 steps) with batch norm, on the conv
# encoder at the default widths, 512 envs (the pixel recipes' count), batch
# 256, and a replay of 8192 (16 blocks of 512), a cut in depth from the
# recipe's 131072.  NAF_UPDATES updates of its saved network are then held
# card against CPU on rows of its saved replay: V, µ and l_entries each
# within CONV_ATOL times its own max |CPU value| (its heads start at ±3e-3,
# so their outputs may be no larger than CONV_ATOL itself) and within half
# of what the update moved it on the CPU (one update moves V by about that
# relative bound, so the bound alone would pass a card that skipped it),
# the running statistics within NAF_STATS_RTOL in norm.
NAF_ENVS = 512
NAF_ARGV = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --pixel-encoder conv "
            f"--num-envs {NAF_ENVS} --replay-capacity 8192 --batch-size 256 "
            f"--steps-per-segment {CLI_STEPS} --max-episode-len {CLI_MAX_LEN} "
            "--warmup-steps 1 --learning-rate 3e-4 --lr-schedule cosine "
            "--reward-scale 0.1 --grad-clip 10 --ou-sigma-min 0.05 --ou-decay-steps 100000 "
            "--use-batch-norm --num-eval 64 --eval-freq 2 --ckpt-freq 1").split()
NAF_TRAIN_FIELDS = ["ts", "elapsed_s", "event", "segment", "env_steps", "loss", "mean_reward",
                    "eval_ep_len", "eval_ep_rew"]
NAF_EVENT_FIELDS = {**EVENT_FIELDS, "train": NAF_TRAIN_FIELDS}
NAF_UPDATES = 3
NAF_STATS_RTOL = 1e-3
# Data parallelism on the one card (parallel phase): ddpg_cli's flags over 2
# ranks (each 2048 envs, replay 4096, batch 64) with PARALLEL_STEPS steps a
# segment (a cut in depth from ddpg_cli's 20: each update waits on a gloo
# all-reduce staged through host memory) and a checkpoint at each run's end
# only; the ranks' time limit, and the launchers' seconds to exit after it.
PARALLEL_RANKS = 2
PARALLEL_STEPS = 5
PARALLEL_ARGV = [*CLI_ARGV[:CLI_ARGV.index("--steps-per-segment")],
                 "--steps-per-segment", str(PARALLEL_STEPS),
                 *CLI_ARGV[CLI_ARGV.index("--steps-per-segment") + 2:CLI_ARGV.index("--ckpt-freq")],
                 "--ckpt-freq", "1000", "--num-devices", str(PARALLEL_RANKS)]
PARALLEL_RANK_TIMEOUT_S = 90
PARALLEL_EXIT_S = 30
# (b)'s launchers start with (a), import the port, make their CUDA context
# and wait for (a)'s file before they call ``ddpg.main`` (a process takes
# about 8 s to reach the card, which (a)'s run hides).
_HELD_MAIN = """
import os, sys, time
import torch
from cartpoleplusplus_tpu_torch.agents import ddpg
torch.zeros(1, device="cuda")
go, deadline = sys.argv[1], time.monotonic() + float(sys.argv[2])
while not os.path.exists(go):
    if time.monotonic() > deadline:
        sys.exit("no go file")
    time.sleep(0.02)
ddpg.main(sys.argv[3:])
"""
_K1_K4 = ("step_repeats", "step_substeps", "render_repeats", "render_batched")

# The bench's training hyperparameters (utils/benchmark.py build) and the
# TD3 recipe's stabilizers.
REPLAY_CAPACITY = 8192
TRAIN_HP = dict(gamma=0.99, tau=0.005, batch_size=128, warmup_steps=0, steps_per_segment=20,
                ou_theta=0.15, ou_sigma=0.2)
TD3_HP = dict(twin_critic=True, policy_delay=2, target_noise=0.2, aug_shift=2,
              reward_scale=0.1, grad_clip=10.0)
# The per-env surface (per_env): AoS physics card against CPU on AOS_ENVS
# states, one substep at PHYS_ATOL and the reset's 30-substep push within
# AOS_PUSH_ATOL in every field (on an H100 80GB HBM3 at 700 W the push came
# 3.3e-8 off in position, 2.9e-7 in the quaternion, 2.8e-6 in velocity and
# 9.7e-6 in angular velocity, the substep 9.5e-7: no rsqrt here, IEEE sqrt
# and division on both sides; the bound is ten times the largest); a per-env reset and PER_ENV_STEPS steps of config
# 5 (K4, K3 at E = 1) and of 1cam_exact (K5a at E = 1), and of the low-dim
# config, each on the card and on the CPU; one fresh-reset vector step at
# NUM_ENVS envs; the random agent's PER_ENV_EPISODES low-dim episodes of at
# most PER_ENV_STEPS + 1 steps (a cut in depth: each costs a step's ~0.2 s).
AOS_ENVS = 256
AOS_PUSH_ATOL = 1e-4
PER_ENV_STEPS = 5
PER_ENV_EPISODES = 2
# The fidelity phase's --tolerance: per_env's log re-simulated on the card (the
# engine that recorded it) and on the CPU (the AoS engine's bound against the
# card, tests/test_torch_aos.py's long-horizon position bound).
FIDELITY_TOL = 2e-3
# The polyak step target ← target + τ·(online − target), checked in norm.
TARGET_STEP_RTOL = 1e-3
_PHYS = ("step_repeats", "step_substeps")
# (row, the bench's options for it at NUM_ENVS, kernels the row must launch)
TRAIN_ROWS = (
    ("2cam_samples2", dict(num_cameras=2, obs_samples=2),
     (*_PHYS, "render_repeats", "render_batched")),
    ("1cam_exact", dict(num_cameras=1, obs_samples=0),
     (*_PHYS, "render_repeats_raster", "render_batched_raster")),
    ("2cam_samples2_ratio", dict(num_cameras=2, obs_samples=2, render_recip=False),
     (*_PHYS, "render_repeats_ratio", "render_batched_ratio")),
    ("1cam_exact_hoist", dict(num_cameras=1, obs_samples=0, raster_hoist=True),
     (*_PHYS, "pack_setups", "render_repeats_raster_hoist", "render_batched_raster_hoist")),
    ("1cam_exact_mxu", dict(num_cameras=1, obs_samples=0, render_mxu=True),
     (*_PHYS, "render_repeats_raster_mxu", "render_batched_raster_mxu")),
)
# The render modes of parity_modes: (name, Renderer options, config at the
# main path's inputs); the seeded inputs are seen by 2 cameras.
MODES = (
    ("ratio", dict(recip=False), CONFIG5),
    ("raster_hoist", dict(raster=True, hoist=True), CONFIG1_EXACT),
    ("raster_mxu", dict(raster=True, mxu=True), CONFIG1_EXACT),
    ("raster_hoist_mxu", dict(raster=True, hoist=True, mxu=True), CONFIG1_EXACT),
)

KERNELS = (
    ("step_repeats", "cartpoleplusplus_tpu_torch/csrc/physics.cu",
     "cartpoleplusplus_tpu/physics/pallas_step.py:113"),
    ("step_substeps", "cartpoleplusplus_tpu_torch/csrc/physics.cu",
     "cartpoleplusplus_tpu/physics/pallas_step.py:180"),
    ("render_repeats", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:347"),
    ("render_batched", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:436"),
    ("render_repeats_raster", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:225"),
    ("render_batched_raster", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:225"),
    ("render_repeats_ratio", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:210"),
    ("render_batched_ratio", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:210"),
    ("pack_setups", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:111"),
    ("render_repeats_raster_hoist", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:226"),
    ("render_batched_raster_hoist", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:226"),
    ("render_repeats_raster_mxu", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:248"),
    ("render_batched_raster_mxu", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:248"),
    *((f"roofline_{mix}", "cartpoleplusplus_tpu_torch/csrc/roofline.cu", "scripts/roofline.py:56")
      for mix in roofline.CHAINS),
)


class OpCensus(TorchDispatchMode):
    """Counts element operations of the arithmetic ATen ops a function runs:
    each op adds its output's element count (a reduction its input's).
    Views, copies, dtype casts, concatenation and allocation are not
    counted."""

    ELEMENTWISE = {
        "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "rsqrt", "sqrt",
        "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where", "abs",
        "floor", "ge", "gt", "le", "lt", "eq", "ne", "bitwise_and", "bitwise_or",
        "bitwise_not", "logical_and", "logical_or", "logical_not", "sin", "cos",
        "atan2", "asin", "tanh", "relu",
    }
    REDUCTIONS = {"sum", "mean"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self.REDUCTIONS:
            self.ops += args[0].numel()
        elif name in self.ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def census(fn) -> int:
    with OpCensus() as c:
        fn()
    return c.ops


def sass_opcodes(lib_path: str, function: str) -> dict | None:
    """Opcode counts of one kernel's SASS in the built library, by
    ``cuobjdump -sass`` (None where the toolkit has no cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int = 20) -> float | None:
    """Mean device time per call of ``fn`` from a torch.profiler trace of
    ``reps`` calls: the kernels' own durations, without the host's time
    between launches (which bounds :func:`time_ms` where a kernel is
    shorter than a wrapper's call).  None where the trace holds no device
    time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    return us / 1e3 / reps if us else None


def state_err(a: RigidState, b: RigidState) -> float:
    return max(float((getattr(a, f) - getattr(b, f)).abs().max()) for f in ("pos", "quat", "vel", "ang"))


def pixel_check(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    if got.shape != want.shape or got.dtype != torch.uint8:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}")
    d = (got.int() - want.int()).abs()
    beyond = float((d > PIX_LEVEL).float().mean())
    res = {"max_abs_err": int(d.max()), "share_beyond_2": beyond,
           "mean_abs_err": float(d.float().mean())}
    if 1.0 - beyond < PIX_SHARE or res["mean_abs_err"] >= PIX_MEAN:
        raise AssertionError(f"{name} disagrees with its plain version: {res}")
    return res


def cast_mask(scene, rnd, poses) -> torch.Tensor:
    """The plain predicate of the casts ``rnd``'s kernel makes on poses
    (E, 16) (``raycast.slab_cast_mask``, or ``raster_cast_mask`` for K5a
    and K5d)."""
    args = (scene, poses, rnd.planes, rnd.cam_meta, rnd.p2, rnd.n)
    if rnd.raster:
        return raycast.raster_cast_mask(*args, rnd.order, mxu=rnd.mxu)
    return raycast.slab_cast_mask(*args, rnd.width)


def cast_shares(scene, rnd, poses) -> dict:
    """Share of box casts a column-run kernel's cull skips on poses (R, E,
    16), for the cart and the pole: of all (sub-ray, box) casts, those in
    warps that skip the box (the plain predicate, :func:`cast_mask`)."""
    skipped = torch.stack([
        1.0 - cast_mask(scene, rnd, poses[r]).float().mean(dim=(0, 1, 2))
        for r in range(poses.shape[0])]).mean(0)
    return {"cart": float(skipped[0]), "pole": float(skipped[1])}


def cull_check(scene, rnd, poses, name: str) -> dict:
    """The slab kernel's cull on poses (R, E, 16) in ``rnd``'s cast mode
    (K3/K4, or K5b where ``rnd.recip`` is False), where it could fail: the
    casts the plain predicate skips that the mode's slab cast hits
    (``raycast.slab_cull_violations``, which must be 0), and the kernel's
    frames byte-equal to its own with culling off (``ray_abs`` = inf
    widens every cull rectangle to the plane); K5b's frames byte-equal to
    the plain ratio version's too.  Plus the share of casts skipped."""
    violations = sum(raycast.slab_cull_violations(scene, poses[r], rnd.planes, rnd.cam_meta,
                                                  rnd.p2, rnd.n, rnd.width, rnd.recip)
                     for r in range(poses.shape[0]))
    frames = []
    for ray_abs in (rnd.ray_abs, float("inf")):
        params = rnd.kernel_params(scene)
        params.ray_abs = ray_abs
        out = torch.empty((poses.shape[1], poses.shape[0], rnd.frame_width), dtype=torch.uint8,
                          device=poses.device)
        rnd.launch(params, poses.contiguous(), out)
        frames.append(out)
    differ = int((frames[0] != frames[1]).sum())
    if violations or differ:
        raise AssertionError(f"{name}: the slab cull skipped {violations} hitting casts; "
                             f"{differ} bytes differ from the kernel's frames without culling")
    res = {"violations": violations, "bytes_differing_from_uncull": differ,
           "skipped_cast_share": cast_shares(scene, rnd, poses)}
    if not rnd.recip:
        if not torch.equal(frames[0], rnd.plain(scene, poses)):
            raise AssertionError(f"{name}: K5b's frames differ from the plain ratio version's")
        res["levels_vs_plain"] = 0
    return res


def slab_cull_checks(scene, cfg, poses, name: str) -> dict:
    """:func:`cull_check` of K3/K4 and of K5b on poses (R, E, 16) seen by
    ``cfg``'s cameras."""
    return {key: cull_check(scene, Renderer(cfg, poses.device, recip=recip), poses,
                            f"{name} {key}")
            for key, recip in (("k3", True), ("k5b", False))}


def raster_cull_check(scene, cfg, poses, name: str) -> dict:
    """K5a's, K5c's and K5d's cull on poses (R, E, 16) seen by ``cfg``'s
    cameras, where it could fail: no skipped cast that the plain cast hits
    (``raycast.raster_cull_violations``, which must be 0), and each
    kernel's frames byte-equal to its own with the cull off
    (``RenderParams.cull`` = 0).  K5a's and K5c's frames must equal the
    plain raster's; K5d's keep the silhouette rule against K5a's and against
    its plain version.  Plus the share of casts skipped.  K5c's setups are
    K5a's bit for bit, so its plain predicate, and the count of its
    violations, are K5a's."""
    dev, r = poses.device, poses.shape[0]
    k5a = Renderer(cfg, dev, raster=True)
    k5c = Renderer(cfg, dev, raster=True, hoist=True)
    k5d = Renderer(cfg, dev, raster=True, mxu=True)
    out, frames = {}, {}
    for key, rnd in (("k5a", k5a), ("k5c", k5c), ("k5d", k5d)):
        setups = None
        if rnd.hoist:
            setups = torch.empty((*poses.shape[:2], rnd.setup_width), device=dev)
            rnd.launch_pack(rnd.kernel_params(scene), poses.contiguous(), setups)
        by_cull = []
        for cull in (1, 0):
            params = rnd.kernel_params(scene)
            params.cull = cull
            by_cull.append(torch.empty((poses.shape[1], r, rnd.frame_width), dtype=torch.uint8,
                                       device=dev))
            rnd.launch(params, poses.contiguous(), by_cull[-1], setups)
        if rnd.hoist:
            violations, shares = out["k5a"]["violations"], out["k5a"]["skipped_cast_share"]
        else:
            violations = sum(raycast.raster_cull_violations(
                scene, poses[i], rnd.planes, rnd.cam_meta, rnd.p2, rnd.n, rnd.order, rnd.mxu)
                for i in range(r))
            shares = cast_shares(scene, rnd, poses)
        differ = int((by_cull[0] != by_cull[1]).sum())
        if violations or differ:
            raise AssertionError(f"{name} {key}: the cull skipped {violations} hitting casts; "
                                 f"{differ} bytes differ from the frames without culling")
        frames[key] = by_cull[0]
        out[key] = {"violations": violations, "bytes_differing_from_uncull": differ,
                    "skipped_cast_share": shares}
    if not torch.equal(frames["k5a"], k5a.plain(scene, poses)):
        raise AssertionError(f"{name}: K5a's frames differ from the plain raster's")
    if not torch.equal(frames["k5c"], frames["k5a"]):
        raise AssertionError(f"{name}: K5c's frames differ from K5a's")
    h, w = cfg.obs_height, cfg.obs_width
    out["k5a"]["levels_vs_plain"] = 0
    out["k5c"]["levels_vs_plain"] = out["k5c"]["levels_vs_k5a"] = 0
    out["k5d"]["silhouette_vs_k5a"] = silhouette_check(f"{name} k5d vs k5a", frames["k5d"],
                                                       frames["k5a"], h, w)
    out["k5d"]["silhouette_vs_plain"] = silhouette_check(f"{name} k5d", frames["k5d"],
                                                         k5d.plain(scene, poses), h, w)
    return out


def needed_plain(scene, rnd, poses):
    """The plain version of the slab mode (reciprocal or, where
    ``rnd.recip`` is False, ratio), or of the raster (``rnd.raster``; K5c's
    and K5d's work is K5a's), doing only the work these inputs need, as a
    function of poses (R, E, 16): each box cast only for the sub-rays it
    hits, a pooled pixel shaded and pooled only where a sub-ray of it hits
    a box, every other pixel the background colour of its static ray rows
    (a table, no operation).  The hits and indices are found here, outside
    the function, by the plain cast.  Its op census is the work these
    inputs need; its frames are the plain version's."""
    p2, n = rnd.p2, rnd.n
    e = poses.shape[1]
    # cast_where → (depth terms, lambert, hit); nearer compares two boxes'
    # depth terms, the cart's first.
    if rnd.raster:
        setup = lambda basis, eye, center, quat, he: raycast._obb_q_setup(
            basis, eye, center, quat, he, raycast.LIGHT_DIR)
        hits_of = lambda rows, su, he: raycast._obb_q_cast(rows[0], rows[1], su)[2]
        cast_where = lambda rows, su, he, m: (lambda q, lam, hit: ((q,), lam, hit))(
            *raycast._obb_q_cast_where(rows[0], rows[1], su, m))
        nearer = lambda c, p: c[0] >= p[0]  # inverse depth
    else:
        recip = rnd.recip
        setup = lambda basis, eye, center, quat, he: raycast._slab_setup(
            basis, eye, center, quat, raycast.LIGHT_DIR)
        hits_of = lambda rows, su, he: raycast._slab_cast(rows[0], rows[1], su, he, recip)[3]
        cast_where = lambda rows, su, he, m: (lambda num, den, lam, hit: ((num, den), lam, hit))(
            *raycast._slab_cast_where(rows[0], rows[1], su, he, m, recip))
        if recip:
            nearer = lambda c, p: c[0] <= p[0]  # depth
        else:
            nearer = lambda c, p: c[0] * p[1] <= p[0] * c[1]  # nc·dp ≤ np·dc
    miss = torch.zeros((1, p2 * n), dtype=torch.bool, device=poses.device)
    zeros = torch.zeros((1, p2 * n), device=poses.device)
    plan, background = [], []
    for c in range(len(rnd.cam_meta)):
        rows = rnd.planes[:, c].reshape(4, 1, p2 * n)
        background.append(raycast.shade_pool(miss, miss, zeros, zeros, rows[2], rows[3], p2, n))
    for r in range(poses.shape[0]):
        for c, (basis, eye) in enumerate(rnd.cam_meta):
            rows = rnd.planes[:, c].reshape(4, 1, p2 * n)
            hits = [hits_of(rows, setup(basis, eye, center, quat, he), he)
                    for center, quat, he in raycast.pose_boxes(scene, poses[r])]
            ie, ij = (hits[0] | hits[1]).reshape(e, p2, n).any(1).nonzero(as_tuple=True)
            sub = (torch.arange(p2, device=poses.device)[:, None] * n + ij).reshape(-1)
            plan.append((hits, ie, ij, ie.repeat(p2), sub))

    def run():
        frames, i = [], 0
        for r in range(poses.shape[0]):
            boxes, out = raycast.pose_boxes(scene, poses[r]), []
            for c, (basis, eye) in enumerate(rnd.cam_meta):
                hits, ie, ij, ie_sub, sub = plan[i]
                i += 1
                rows = rnd.planes[:, c].reshape(4, 1, p2 * n)
                (tc, lc, hc), (tp, lp, hp) = (
                    cast_where(rows, setup(basis, eye, center, quat, he), he, hit)
                    for (center, quat, he), hit in zip(boxes, hits))
                at = lambda t: t[ie_sub, sub][None]  # the hit pixels' sub-rays, p2 blocks
                depth_c, depth_p = tuple(map(at, tc)), tuple(map(at, tp))
                colors = raycast.shade_pool(at(hc) & nearer(depth_c, depth_p), at(hp), at(lc),
                                            at(lp), rows[2][:, sub], rows[3][:, sub], p2, len(ie))
                for k in range(3):
                    plane = background[c][k].expand(e, n).clone()
                    plane[ie, ij] = colors[k][0]
                    out.append(plane)
            frames.append(torch.cat(out, dim=-1))
        return torch.stack(frames, dim=1)

    return run


def probe_rigid(poses: torch.Tensor) -> RigidState:
    """Poses (E, 16) as a RigidState at rest (K4's input)."""
    zeros = torch.zeros((poses.shape[0], 2, 3), device=poses.device)
    return RigidState(pos=torch.stack([poses[:, 0:3], poses[:, 7:10]], 1),
                      quat=torch.stack([poses[:, 3:7], poses[:, 10:14]], 1), vel=zeros, ang=zeros)


# Mangled-name fragments of each kernel's CUDA function, for its ptxas
# registers and spills.
PTXAS_NAMES = {
    "step_repeats": "phys_kernelILb1E", "step_substeps": "phys_kernelILb0E",
    "render_repeats": "render_slab_kernelILi0ELb1E",
    "render_batched": "render_slab_kernelILi0ELb1E",
    "render_repeats_raster": "render_raster_kernelILb0ELb1E",
    "render_batched_raster": "render_raster_kernelILb0ELb1E",
    "render_repeats_ratio": "render_slab_kernelILi2ELb1E",
    "render_batched_ratio": "render_slab_kernelILi2ELb1E",
    "pack_setups": "pack_setups_kernel",
    "render_repeats_raster_hoist": "render_raster_kernelILb1ELb1E",
    "render_batched_raster_hoist": "render_raster_kernelILb1ELb1E",
    "render_repeats_raster_mxu": "render_raster_mxu_kernelILb0ELb1E",
    "render_batched_raster_mxu": "render_raster_mxu_kernelILb0ELb1E",
    # K6: enum Chain in csrc/roofline.cu
    "roofline_fma_f32": "chain_f32_kernelILi0E", "roofline_fma_bf16": "chain_bf16_kernelILi1E",
    "roofline_mix_f32": "chain_f32_kernelILi2E", "roofline_mix_bf16": "chain_bf16_kernelILi3E",
    "roofline_recip_f32": "chain_f32_kernelILi4E", "roofline_div_f32": "chain_f32_kernelILi5E",
}


def ptxas_usage(log: str) -> dict:
    """``nvcc -Xptxas -v`` output → {mangled function: {registers,
    spill_bytes, stack_bytes}} (spill stores plus loads; the stack frame,
    local memory per thread)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = out.setdefault(m.group(1), {})
        elif current is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            if (m := re.search(r"(\d+) bytes stack frame", line)):
                current["stack_bytes"] = int(m.group(1))
        elif current is not None and (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
    return out


def usage_of(usage: dict, name: str) -> dict:
    """A kernel's registers, spill bytes and stack frame from
    :func:`ptxas_usage` (None where the build log names no such
    function)."""
    fragment = PTXAS_NAMES.get(name)
    found = [v for k, v in usage.items() if fragment and fragment in k]
    return {key: found[0].get(key) if found else None
            for key in ("registers", "spill_bytes", "stack_bytes")}


def raw_launches(scene, renderer, rigid, force, poses, spr, n_push):
    """Closures that launch each kernel on prepared buffers through the
    package's launch functions, so that timing sees the kernels and not the
    wrappers' packing.  A hoisted renderer's render kernels read setup
    tables packed here once; its setup pass is timed on its own
    (``pack_setups``).  They count no launches."""
    e, reps = rigid.pos.shape[0], poses.shape[0]
    packed, force_t = soa.pack_state(rigid).contiguous(), force.t().contiguous()
    state_out, pose_out = torch.empty_like(packed), torch.empty_like(poses)
    poses_r = poses.contiguous()
    poses_b = raycast.poses_from_rigid(rigid)[None].contiguous()
    frames_r = torch.empty((e, reps, renderer.frame_width), dtype=torch.uint8, device=poses.device)
    frames_b = torch.empty((e, 1, renderer.frame_width), dtype=torch.uint8, device=poses.device)
    phys_p, render_p = cuda_step.phys_params(scene), renderer.kernel_params(scene)
    setups_r = setups_b = None
    raw = {}
    if renderer.hoist:
        setups_r, setups_b = (torch.empty((*p.shape[:2], renderer.setup_width), device=p.device)
                              for p in (poses_r, poses_b))
        renderer.launch_pack(render_p, poses_r, setups_r)
        renderer.launch_pack(render_p, poses_b, setups_b)
        raw["pack_setups"] = lambda: renderer.launch_pack(render_p, poses_r, setups_r)
    return {
        **raw,
        "step_repeats": lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, pose_out, reps, spr),
        "step_substeps": lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, None, 1, n_push),
        "render_repeats": lambda: renderer.launch(render_p, poses_r, frames_r, setups_r),
        "render_batched": lambda: renderer.launch(render_p, poses_b, frames_b, setups_b),
    }


def silhouette_stats(got: torch.Tensor, want: torch.Tensor, h: int, w: int) -> dict:
    """Frames (…, C·3·h·w) of a product-rounded render against another: the
    share of bytes that differ and how many differing pixels lie further
    than one pixel from an edge of more than SIL_EDGE levels in either."""
    g, v = (x.int().reshape(-1, h, w) for x in (got, want))

    def edges(img):
        e = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        d = (img[..., :, 1:] - img[..., :, :-1]).abs() > SIL_EDGE
        e[..., :, :-1] |= d
        e[..., :, 1:] |= d
        d = (img[..., 1:, :] - img[..., :-1, :]).abs() > SIL_EDGE
        e[..., :-1, :] |= d
        e[..., 1:, :] |= d
        return e

    zone = edges(g) | edges(v)
    near = zone.clone()
    near[..., :-1, :] |= zone[..., 1:, :]
    near[..., 1:, :] |= zone[..., :-1, :]
    near[..., :, :-1] |= zone[..., :, 1:]
    near[..., :, 1:] |= zone[..., :, :-1]
    diff = g != v
    return {"share_bytes_differing": float(diff.float().mean()),
            "differing_off_silhouette": int((diff & ~near).sum())}


def silhouette_check(name: str, got: torch.Tensor, want: torch.Tensor, h: int, w: int) -> dict:
    """:func:`silhouette_stats`, which must show under SIL_SHARE of bytes
    differing and every differing pixel on a silhouette; raises otherwise."""
    res = silhouette_stats(got, want, h, w)
    if res["differing_off_silhouette"] or res["share_bytes_differing"] >= SIL_SHARE:
        raise AssertionError(f"{name} breaks the silhouette rule: {res}")
    return res


def phys_parity(scene, rigid, force) -> tuple[dict, tuple]:
    """K1 and K2 against the plain version on the CPU → (max abs error by
    kernel, the plain K1's poses); raises where one disagrees.  PyTorch's
    CUDA rsqrt is approximate, which on its own moves the pole's spin ~1e-4
    off the exactly rounded result after 30 substeps."""
    spr, reps, n_push = CONFIG5.steps_per_repeat, CONFIG5.action_repeats, CONFIG5.initial_force_steps
    cpu = lambda st: st.map(lambda x: x.cpu())
    rigid_cpu, force_cpu = cpu(rigid), force.cpu()
    k2 = cuda_step.step_substeps(scene, rigid, force, n_push)
    p2 = soa.step_substeps_batched(scene, rigid_cpu, force_cpu, n_push)
    k1, k1_poses = cuda_step.step_repeats(scene, rigid, force, spr, reps)
    p1, p1_poses = soa.step_repeats_batched(scene, rigid_cpu, force_cpu, spr, reps)
    errs = {
        "step_repeats": max(state_err(cpu(k1), p1), float((k1_poses.cpu() - p1_poses).abs().max())),
        "step_substeps": state_err(cpu(k2), p2),
    }
    for name, err in errs.items():
        if not err <= PHYS_ATOL:
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
    return errs, p1_poses


def parity(scene, renderer, rigid, force) -> tuple[dict, dict]:
    """Each kernel against its plain version on these inputs → (max abs
    error by kernel, pixel statistics by render kernel); raises where one
    disagrees.  K3 renders the poses of the plain K1."""
    errs, p1_poses = phys_parity(scene, rigid, force)
    poses = p1_poses.to(rigid.pos.device)
    pix = {
        "render_repeats": pixel_check(
            "render_repeats", renderer.render_repeats(scene, poses), renderer.plain(scene, poses)),
        "render_batched": pixel_check(
            "render_batched", renderer.render_batched(scene, rigid),
            renderer.plain(scene, raycast.poses_from_rigid(rigid)[None])[:, 0]),
    }
    errs.update({k: v["max_abs_err"] for k, v in pix.items()})
    torch.cuda.synchronize()
    return errs, pix


def parity_inputs(scene, device, e: int = PARITY_ENVS):
    """E states from a seed: the reset push then a few random steps (plain
    PyTorch), so contacts and tilts vary; plus a force for the next step."""
    g = torch.Generator(device=device).manual_seed(SEED)
    state, _ = cartpole.reset_batched(
        CONFIG5, scene, e, soa.step_substeps_batched,
        lambda s, r: torch.zeros((e, 1), device=device), device, generator=g)
    rigid = state.rigid
    for _ in range(3):
        force = 50.0 * (2.0 * torch.rand((e, 2), generator=g, device=device) - 1.0)
        force = torch.cat([force, torch.zeros((e, 1), device=device)], -1)
        rigid = soa.step_substeps_batched(scene, rigid, force, CONFIG5.steps_per_repeat * 3)
    force = 50.0 * (2.0 * torch.rand((e, 2), generator=g, device=device) - 1.0)
    force = torch.cat([force, torch.zeros((e, 1), device=device)], -1)
    return rigid, force


def raster_parity(scene, renderer, rigid, poses) -> dict:
    """K5a in both launch forms against the plain raster version on the
    card → pixel statistics by form; raises where one disagrees."""
    pix = {
        "render_repeats_raster": pixel_check(
            "render_repeats_raster", renderer.render_repeats(scene, poses),
            renderer.plain(scene, poses)),
        "render_batched_raster": pixel_check(
            "render_batched_raster", renderer.render_batched(scene, rigid),
            renderer.plain(scene, raycast.poses_from_rigid(rigid)[None])[:, 0]),
    }
    torch.cuda.synchronize()
    return pix


def mode_parity(scene, name, mode, cfg, rigid, poses) -> dict:
    """One mode of the render kernel in both launch forms against its plain
    version on the card → statistics by form; raises where one disagrees.
    The hoisted raster must equal its plain version and K5a byte for byte;
    the product's raster must keep the silhouette rule against both."""
    dev = rigid.pos.device
    rnd, k5a = Renderer(cfg, dev, **mode), Renderer(cfg, dev, raster=True)
    poses_b = raycast.poses_from_rigid(rigid)[None]
    forms = {
        "repeats": (rnd.render_repeats(scene, poses), rnd.plain(scene, poses),
                    k5a.render_repeats(scene, poses)),
        "batched": (rnd.render_batched(scene, rigid), rnd.plain(scene, poses_b)[:, 0],
                    k5a.render_batched(scene, rigid)),
    }
    out = {}
    for form, (got, plain, base) in forms.items():
        label = f"{name}_{form}"
        res = pixel_check(label, got, plain)
        if mode.get("raster"):
            res["max_abs_err_vs_k5a"] = pixel_check(label + "_vs_k5a", got, base)["max_abs_err"]
            if mode.get("mxu"):
                h, w = cfg.obs_height, cfg.obs_width
                res["silhouette_vs_plain"] = silhouette_check(label, got, plain, h, w)
                res["silhouette_vs_k5a"] = silhouette_check(label + "_vs_k5a", got, base, h, w)
            elif not (torch.equal(got, plain) and torch.equal(got, base)):
                raise AssertionError(f"{label} is not byte-equal to its plain version and K5a")
        out[form] = res
    torch.cuda.synchronize()
    return out


def params_of(*modules) -> list[torch.Tensor]:
    return [p.detach().clone() for m in modules for p in m.parameters()]


def target_step_err(t0, online, t1, tau) -> float:
    """‖t1 − (t0 + τ·(online − t0))‖ / ‖τ·(online − t0)‖ over all params, in
    float64: how far one update's target step is from the polyak step."""
    num = den = 0.0
    for a, o, b in zip(t0, online, t1):
        a, o, b = a.double(), o.double(), b.double()
        step = tau * (o - a)
        num += float(((b - a) - step).pow(2).sum())
        den += float(step.pow(2).sum())
    return math.sqrt(num / den) if den > 0 else math.inf


# The training rows' and the bench phase's timed windows, cut from the
# bench's defaults (3 windows of 5 segments, each at least 0.5 s) to fit the
# watchdog: 2 windows of 1 segment, each at least 0.1 s (a 20-step segment
# takes 0.15-0.2 s at 4096 pixel or 8192 low-dim envs).  Their rates are the
# bench's own measure at a smaller depth; bench_torch.py's suite run at its
# defaults gives the rows' numbers (PERF.md §5).
SMOKE_WINDOWS = dict(segments=1, bench_windows=2, min_wall_s=0.1)


def bench_opts(**overrides) -> argparse.Namespace:
    """The bench's options (its defaults: utils/benchmark.py, with the
    smoke's windows) for one row."""
    opts = benchmark.make_parser().parse_args([])
    for k, v in {**SMOKE_WINDOWS, **overrides}.items():
        setattr(opts, k, v)
    return opts


def train_row(opts, row_kernels) -> tuple[dict, dict]:
    """Train one bench row at full width as the bench does: its
    ``build``, one warm segment, its timed windows and their best rate
    (``benchmark.timed_windows``, ``best_window``); then one more update
    outside the counted run to check the polyak step → (the row's line,
    what the later phases need)."""
    cfg = benchmark.bench_config(opts)
    e = opts.num_envs
    st, segment = benchmark.build(opts)
    actor0 = params_of(st.actor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_warm = time.monotonic()
    st, warm = segment(st)
    warm = {k: float(v) for k, v in warm.items()}
    warm_s = time.monotonic() - t_warm
    seen = []
    st, windows = benchmark.timed_windows(segment, st, opts, seen)
    launches = dict(kernels.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    seg_metrics = [{k: float(v) for k, v in m.items()} for m in seen]
    rate, _, rates = benchmark.best_window(windows, e * opts.steps_per_segment)
    actor_moved = max(float((a - b).abs().max()) for a, b in zip(actor0, params_of(st.actor)))

    train_once = ddpg.make_train_once(cfg, gamma=TRAIN_HP["gamma"], tau=TRAIN_HP["tau"],
                                      warmup_steps=TRAIN_HP["warmup_steps"])
    t0 = params_of(st.target_actor, st.target_critic)
    train_once(st, replay_mod.sample(st.replay, TRAIN_HP["batch_size"], st.generator),
               st.env_steps)
    step_err = target_step_err(t0, params_of(st.actor, st.critic),
                               params_of(st.target_actor, st.target_critic), TRAIN_HP["tau"])

    mean = lambda k: sum(m[k] for m in seg_metrics) / len(seg_metrics)
    trained = [m for m in seg_metrics if m["updates"] > 0]
    checks = {
        "row_kernels_launched": all(launches[k] > 0 for k in row_kernels),
        "other_render_mode_not_launched": all(
            v == 0 for k, v in launches.items()
            if k.startswith(("render", "pack")) and k not in row_kernels),
        "losses_finite": all(math.isfinite(m[k]) for m in [warm, *seg_metrics]
                             for k in ("critic_loss", "actor_loss")),
        "critic_loss_positive_once_trained": bool(trained)
        and all(m["critic_loss"] > 0.0 for m in trained),
        "actor_moved": actor_moved > 0.0,
        "target_moved_by_tau": step_err < TARGET_STEP_RTOL,
        "replay_full": st.replay.size == st.replay.capacity,
    }
    config = dict(use_raw_pixels=False)
    if cfg.use_raw_pixels:
        config = dict(num_cameras=cfg.num_cameras, obs_samples=cfg.obs_samples,
                      obs_pool=cfg.obs_pool, raster=cfg.obs_samples == 0)
    line = dict(
        envs=e, config=config,
        render_options={k: getattr(opts, k) for k in (
            "render_raster", "render_recip", "raster_hoist", "render_mxu")},
        hyperparameters={**TRAIN_HP, "replay_capacity": opts.replay_capacity},
        warm_segment_s=warm_s, min_wall_s=opts.min_wall_s,
        window_s=[t for _, t in windows], window_segments=[n for n, _ in windows],
        window_env_steps_per_s=rates, env_steps_per_s=rate,
        spread=(max(rates) - min(rates)) / rate, step_ms=1e3 * e / rate,
        mean_critic_loss=mean("critic_loss"), mean_actor_loss=mean("actor_loss"),
        mean_reward=mean("reward"), mean_done_frac=mean("done_frac"),
        double_reset_frac=mean("double_reset_frac"), warm_segment=warm,
        updates=sum(m["updates"] for m in seg_metrics) + int(warm["updates"]),
        replay_size=st.replay.size, replay_cursor=st.replay.cursor,
        replay_capacity=st.replay.capacity, env_steps=st.env_steps,
        actor_max_param_change=actor_moved, target_step_rel_err=step_err,
        launches=launches, peak_mem_mib=peak_mib, checks=checks,
    )
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return line, {"state": st, "segment": lambda st: segment(st)[1],
                  "step_ms": 1e3 * e / rate, "launches": launches}


def bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same float32 bits."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def lowdim_parity(scene, venv, rigid, force, name: str) -> dict:
    """The low-dim step (one K1 launch, frames read from its poses) against
    the JAX venv's per-repeat composition run through the port's kernels
    (K2 per repeat, then ``observe_lowdim``): frames and states byte-equal;
    and within PHYS_ATOL of the plain composition on the CPU.  Raises where
    one disagrees."""
    cfg = venv.config
    k1_rigid, k1_obs = venv.sim_fn(scene, rigid, force)
    k2_rigid, k2_obs = cartpole.simulate_repeats(cfg, scene, rigid, force, cuda_step.step_substeps,
                                                 cartpole.observe_lowdim)
    byte_equal = {"frames": bytes_equal(k1_obs, k2_obs),
                  **{f: bytes_equal(getattr(k1_rigid, f), getattr(k2_rigid, f))
                     for f in ("pos", "quat", "vel", "ang")}}
    cpu = lambda st: st.map(lambda x: x.cpu())
    p_rigid, p_obs = cartpole.simulate_repeats(cfg, scene, cpu(rigid), force.cpu(),
                                               soa.step_substeps_batched, cartpole.observe_lowdim)
    err = max(state_err(cpu(k1_rigid), p_rigid), float((k1_obs.cpu() - p_obs).abs().max()))
    if not all(byte_equal.values()):
        raise AssertionError(f"{name}: K1's low-dim step is not byte-equal to K2 per repeat + "
                             f"observe_lowdim: {byte_equal}")
    if not err <= PHYS_ATOL:
        raise AssertionError(f"{name}: the low-dim step is {err} off the plain composition")
    return {"envs": rigid.pos.shape[0], "obs_shape": list(k1_obs.shape),
            "byte_equal_to_k2_per_repeat": byte_equal, "max_abs_err_vs_plain_cpu": err}


def bench_check(out: str) -> tuple[list, dict, dict]:
    """The bench suite's stdout → (row lines, summary line, checks): four
    row lines in ROW_SPECS' order, then the summary last; every row on
    ``cuda`` with a value > 0, its card and power limit; the low-dim row's
    metric without ``_pixel_render``, the others with it; every ceiling the
    row's measured mix rate over the census of its config; no row's child
    imported ``torch._dynamo``."""
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    rows, summary = lines[:-1], lines[-1] if lines else {}
    defaults = benchmark.make_parser().parse_args([])

    def ceiling_ok(row, overrides) -> bool:
        ns = SimpleNamespace(**{**vars(defaults), **overrides,
                                "render_raster": row["_render_raster"]})
        mix = row.get("_mix_ops_per_s")
        return (isinstance(mix, float) and math.isfinite(mix) and mix > 0
                and row["_census_ops_per_step"] == benchmark.census_ops_per_step(ns)
                and row["ceiling"] == round(benchmark.census_ceiling(ns, mix), 1))

    specs = benchmark.ROW_SPECS
    paired = list(zip(rows, specs))
    checks = {
        "four_rows_then_summary": len(rows) == len(specs)
        and [r.get("config") for r in rows] == [label for label, _, _ in specs]
        and "rows" in summary,
        "all_cuda": all(r.get("_backend") == "cuda" and r.get("_device")
                        and r.get("_power_limit") for r in rows),
        "values_positive": all(r.get("value", 0) > 0 for r in rows),
        "lowdim_not_pixel_render": all(
            ("_pixel_render" in r["metric"]) != bool(over.get("lowdim"))
            for r, (_, _, over) in paired),
        "ceilings_from_measured_mix": all(ceiling_ok(r, over) for r, (_, _, over) in paired),
        "summary_without_error": bool(rows) and "error" not in summary
        and summary.get("metric") == rows[0]["metric"] + specs[0][1],
        "no_dynamo_in_rows": all(r.get("_dynamo_imported") is False for r in rows),
    }
    return rows, summary, checks


def training_profile(st, segment, step_ms: float) -> dict:
    """Device time per env step of one profiled training segment, split
    into the port's kernels (by name), the learner (kernels launched by an
    op inside a ``ddpg.LEARNER_SPAN`` span: GEMMs, Adam, target updates,
    sampling) and the rest; plus the busy share against the unprofiled
    step time."""
    steps = TRAIN_HP["steps_per_segment"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        {k: float(v) for k, v in segment(st).items()}
        torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == ddpg.LEARNER_SPAN and not str(e.device_type).endswith("CUDA")]
    learner_us = 0.0
    for e in events:
        ks = getattr(e, "kernels", None) or []
        if ks and not str(e.device_type).endswith("CUDA") and any(
                a <= e.time_range.start <= b for a, b in spans):
            learner_us += sum(k.duration for k in ks)
    by_name = {}
    for e in device_events(prof):
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    total_us = sum(by_name.values())
    ours_us = sum(v for k, v in by_name.items() if any(n in k for n in benchmark.PORT_KERNELS))
    per_step = lambda us: us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        device_ms_per_step=per_step(total_us), kernels_ms_per_step=per_step(ours_us),
        learner_ms_per_step=per_step(learner_us) if spans else None,
        rest_ms_per_step=per_step(total_us - ours_us - learner_us) if spans else None,
        learner_spans=len(spans), step_ms=step_ms,
        device_busy_share=per_step(total_us) / step_ms if total_us else None,
        learner_share_of_device=learner_us / total_us if total_us and spans else None,
        top_device_ms_per_step={k: per_step(v) for k, v in top},
    )


def load_td3_checkpoint(root: str, work: str) -> dict:
    """The TD3 checkpoint through ``ddpg_params_from_jax_checkpoint``, from
    its xz copy decompressed into ``work``; its bytes checked by sha256."""
    path = os.path.join(root, TD3_CKPT)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} is absent: the conv and crossload phases read it")
    with lzma.open(path) as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != TD3_CKPT_SHA256:
        raise AssertionError(f"{path} decompresses to sha256 {digest}, not the checkpoint's")
    out = os.path.join(work, "ckpt_15000.msgpack")
    with open(out, "wb") as f:
        f.write(data)
    return ddpg_params_from_jax_checkpoint(out)


def conv_check(td3: dict, dev) -> tuple[dict, Actor]:
    """The conv actor and twin critic with the TD3 checkpoint's weights on
    the card against the same modules on the CPU, on its 512 obs."""
    nets = {}
    for where in ("cpu", dev):
        actor = Actor(CONFIG2_EXACT.obs_shape, device=where, **TD3_NET)
        critic = TwinCritic(CONFIG2_EXACT.obs_shape, device=where, **TD3_NET)
        actor.load_state_dict(td3["actor"])
        critic.load_state_dict(td3["critic"])
        nets[str(where)] = (actor, critic)
    (actor_c, critic_c), (actor_g, critic_g) = nets["cpu"], nets[str(dev)]
    obs_c = td3["obs"]
    obs_g = obs_c.to(dev)
    with torch.no_grad():
        a_c = actor_c(obs_c)
        a_g = actor_g(obs_g)
        q_c = critic_c(obs_c, a_c)
        a_in = a_c.to(dev)
        q_g = critic_g(obs_g, a_in)
        actor_ms = time_ms(lambda: actor_g(obs_g), reps=50)
        critic_ms = time_ms(lambda: critic_g(obs_g, a_in), reps=50)
    errs = {"actions": float((a_g.cpu() - a_c).abs().max()),
            "q1": float((q_g[0].cpu() - q_c[0]).abs().max()),
            "q2": float((q_g[1].cpu() - q_c[1]).abs().max())}
    checks = {f"{k}_within_bound": v <= CONV_ATOL for k, v in errs.items()}
    checks["finite"] = bool(torch.isfinite(a_g).all() and torch.isfinite(q_g).all())
    nhwc = (CONFIG2_EXACT.obs_height, CONFIG2_EXACT.obs_width,
            CONFIG2_EXACT.obs_shape[1] * CONFIG2_EXACT.action_repeats
            // (CONFIG2_EXACT.obs_height * CONFIG2_EXACT.obs_width))
    line = dict(envs=int(obs_c.shape[0]), nhwc=nhwc, trunk_in=actor_g.encoder.conv_trunk.out_features,
                bound=CONV_ATOL, max_abs_err=errs, actor_ms=actor_ms, twin_critic_ms=critic_ms,
                max_abs_action=float(a_c.abs().max()), max_abs_q=float(q_c.abs().max()),
                checks=checks)
    return line, actor_g


def crossload_eval(actor, dev) -> tuple[dict, dict]:
    """Greedy evals of the cross-loaded TD3 actor on a 64-env venv of the
    recipe's config (exact: prefer_raster gives K5a), one per generator
    seed."""
    venv = make_venv(CONFIG2_EXACT, CROSSLOAD_ENVS, device=dev)
    act = greedy_act(actor)
    per_seed = []
    kernels.reset_launches()
    for seed in range(CROSSLOAD_SEEDS):
        t = time.monotonic()
        mean_len, mean_rew = eval_rollout(venv, act, torch.Generator(device=dev).manual_seed(seed))
        per_seed.append({"seed": seed, "mean_len": float(mean_len), "mean_rew": float(mean_rew),
                         "eval_s": time.monotonic() - t})
    launches = dict(kernels.LAUNCHES)
    lens = [p["mean_len"] for p in per_seed]
    mean_len = sum(lens) / len(lens)
    lo, hi = min(JAX_CPU_TD3_LENS) - CROSSLOAD_WIDEN, max(JAX_CPU_TD3_LENS) + CROSSLOAD_WIDEN
    checks = {
        "finite": all(math.isfinite(p[k]) for p in per_seed for k in ("mean_len", "mean_rew")),
        "episode_len_in_range": all(1.0 <= v <= CONFIG2_EXACT.max_episode_len for v in lens),
        "raster_launched": all(launches[k] > 0 for k in (
            "step_repeats", "step_substeps", "render_repeats_raster", "render_batched_raster")),
        "slab_not_launched": launches["render_repeats"] == 0 and launches["render_batched"] == 0,
    }
    line = dict(envs=CROSSLOAD_ENVS, per_seed=per_seed, mean_len=mean_len, min_len=min(lens),
                max_len=max(lens),
                mean_rew=sum(p["mean_rew"] for p in per_seed) / len(per_seed),
                jax_recorded_final=JAX_RECORDED_TD3, jax_cpu_eval_lens=JAX_CPU_TD3_LENS,
                jax_cpu_mean_len=sum(JAX_CPU_TD3_LENS) / len(JAX_CPU_TD3_LENS),
                jax_cpu_range_widened=(lo, hi), within_jax_cpu_range_widened=lo <= mean_len <= hi,
                launches=launches, checks=checks)
    return line, launches


def load_sac_actor(root: str) -> dict:
    """The SAC checkpoint's actor leaves from their npz, its bytes checked
    by sha256 → a GaussianActor state_dict."""
    path = os.path.join(root, SAC_ACTOR)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} is absent: the sac_crossload phase reads it")
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != SAC_ACTOR_SHA256:
        raise AssertionError(f"{path} has sha256 {digest}, not the exported actor's")
    with np.load(path) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    return gaussian_actor_params_from_flax(tree)


def sac_crossload(sd: dict, dev) -> tuple[dict, dict]:
    """The config-5 SAC checkpoint's GaussianActor on the card: its (mu,
    log_std) on the eval's first observations against the same module on
    the CPU (bf16 bound), then greedy evals on a 64-env venv of the
    recipe's config (slab: K1-K4), one per generator seed."""
    actors = {}
    for where in ("cpu", dev):
        actors[str(where)] = GaussianActor(CONFIG5.obs_shape, device=where, **TD3_NET)
        actors[str(where)].load_state_dict(sd)
    actor_c, actor_g = actors["cpu"], actors[str(dev)]
    venv = make_venv(CONFIG5, CROSSLOAD_ENVS, device=dev)
    _, obs = venv.reset(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        mu_g, ls_g = actor_g(obs)
        mu_c, ls_c = actor_c(obs.cpu())
        actor_ms = time_ms(lambda: actor_g(obs), reps=50)
    errs = {"mu": float((mu_g.cpu() - mu_c).abs().max()),
            "log_std": float((ls_g.cpu() - ls_c).abs().max())}
    act = sac.greedy_act(actor_g)
    per_seed = []
    kernels.reset_launches()
    for seed in range(CROSSLOAD_SEEDS):
        t = time.monotonic()
        mean_len, mean_rew = eval_rollout(venv, act, torch.Generator(device=dev).manual_seed(seed))
        per_seed.append({"seed": seed, "mean_len": float(mean_len), "mean_rew": float(mean_rew),
                         "eval_s": time.monotonic() - t})
    launches = dict(kernels.LAUNCHES)
    lens = [p["mean_len"] for p in per_seed]
    mean_len = sum(lens) / len(lens)
    lo, hi = min(JAX_CPU_SAC_LENS) - CROSSLOAD_WIDEN, max(JAX_CPU_SAC_LENS) + CROSSLOAD_WIDEN
    checks = {
        **{f"{k}_within_bound": v <= CONV_ATOL for k, v in errs.items()},
        "finite": all(math.isfinite(p[k]) for p in per_seed for k in ("mean_len", "mean_rew"))
        and bool(torch.isfinite(mu_g).all() and torch.isfinite(ls_g).all()),
        "episode_len_in_range": all(1.0 <= v <= CONFIG5.max_episode_len for v in lens),
        "slab_launched": all(launches[k] > 0 for k in (
            "step_repeats", "step_substeps", "render_repeats", "render_batched")),
        "raster_not_launched": all(v == 0 for k, v in launches.items()
                                   if k.startswith(("render", "pack")) and k not in (
                                       "render_repeats", "render_batched")),
    }
    line = dict(envs=CROSSLOAD_ENVS, bound=CONV_ATOL, max_abs_err=errs, actor_ms=actor_ms,
                max_abs_mu=float(mu_c.abs().max()), per_seed=per_seed, mean_len=mean_len,
                min_len=min(lens), max_len=max(lens),
                mean_rew=sum(p["mean_rew"] for p in per_seed) / len(per_seed),
                jax_recorded_final=JAX_RECORDED_SAC, jax_cpu_eval_lens=JAX_CPU_SAC_LENS,
                jax_cpu_mean_len=sum(JAX_CPU_SAC_LENS) / len(JAX_CPU_SAC_LENS),
                jax_cpu_range_widened=(lo, hi), within_jax_cpu_range_widened=lo <= mean_len <= hi,
                launches=launches, checks=checks)
    return line, launches


def replay_cpu(replay):
    """A host copy of a replay (the cursor, size and block as they are)."""
    return dataclasses.replace(replay, **{k: getattr(replay, k).cpu() for k in (
        "s1", "action", "reward", "s2", "terminal", "priority")})


def sampler_check(replay, alpha: float, beta: float, n_step: int, gamma: float) -> dict:
    """``sample_prioritized`` and ``nstep_batch`` on the card against the
    same functions on a CPU copy of the card's replay, fed the same
    uniforms.  Indices may differ only where a draw lies within the two
    CDFs' rounding gap of a slot boundary (the card's cumsum associates
    otherwise); every other index, and every gathered field at equal
    indices, must agree exactly (the weights to float32 rounding)."""
    dev = replay.s1.device
    host = replay_cpu(replay)
    u = torch.rand((REPLAY_EXT_DRAWS,), generator=torch.Generator().manual_seed(SEED))
    (b_g, idx_g, iw_g) = replay_mod.sample_prioritized(replay, REPLAY_EXT_DRAWS, alpha, beta,
                                                       n_step=n_step, gamma=gamma, u=u.to(dev))
    (b_c, idx_c, iw_c) = replay_mod.sample_prioritized(host, REPLAY_EXT_DRAWS, alpha, beta,
                                                       n_step=n_step, gamma=gamma, u=u)
    idx_g = idx_g.cpu()
    mask, _ = replay_mod.valid_mask(host, n_step)
    w = torch.where(mask, host.priority ** alpha, 0.0)
    cdf_c = torch.cumsum(w, 0)
    cdf_g = torch.cumsum(torch.where(mask.to(dev), replay.priority ** alpha, 0.0), 0).cpu()
    gap = float((cdf_g - cdf_c).abs().max())
    total = float(cdf_c[-1])
    scaled = (u * (1.0 - torch.finfo(torch.float32).eps)) * cdf_c[-1]
    differ = (idx_g != idx_c).nonzero().flatten()
    ulp = math.ulp(total)
    boundary = torch.minimum(idx_g, idx_c)[differ]
    close = (scaled[differ] - cdf_c[boundary]).abs() <= gap + 4 * ulp
    same = idx_g == idx_c
    fields_equal = all(torch.equal(g.cpu()[same], c[same]) for g, c in zip(b_g, b_c))
    iw_rel = float(((iw_g.cpu() - iw_c).abs() / iw_c)[same].max())
    nb_g = replay_mod.nstep_batch(replay, idx_c.to(dev), n_step, gamma)
    nb_c = replay_mod.nstep_batch(host, idx_c, n_step, gamma)
    return dict(draws=REPLAY_EXT_DRAWS, index_differences=int(differ.numel()),
                index_differences_at_boundaries=int(close.sum()),
                cdf_max_abs_gap=gap, cdf_total=total,
                iw_max_rel_err=iw_rel, fields_equal_at_equal_indices=fields_equal,
                nstep_batch_equal=all(torch.equal(g.cpu(), c) for g, c in zip(nb_g, nb_c)),
                other_index_differences=int((~close).sum()))


def replay_ext(dev) -> tuple[dict, dict]:
    """``ddpg.main`` at config 5 with ``--per --n-step 3`` (replay of 4
    blocks of 4096 envs, ddpg_cli's TD3 flags, 2 segments).  Spies on the
    replay: each insert's rows must carry the running max priority (at
    least 1), each write-back ``|td| + per_eps`` at the sampled rows; then
    the sampler on the card against the CPU (:func:`sampler_check`)."""
    states, betas, seg_s = [], [], []
    stamp_ok, written_ok, counts = [], [], collections.Counter()

    def spy_add(real):
        def add(replay, s1, *rest):
            if not replay.prioritized:
                return real(replay, s1, *rest)
            pmax = torch.clamp(replay.priority.max(), min=1.0)
            at = replay.cursor
            out = real(replay, s1, *rest)
            stamp_ok.append((replay.priority[at:at + s1.shape[0]] == pmax).all())
            counts["inserts"] += 1
            return out
        return add

    def spy_sample(real):
        def sample_p(replay, batch_size, alpha, beta, **kw):
            betas.append(beta)
            return real(replay, batch_size, alpha, beta, **kw)
        return sample_p

    def spy_update(real):
        def update(replay, idx, td_abs, eps=1e-2, gate=None):
            out = real(replay, idx, td_abs, eps, gate)
            got, want = replay.priority[idx], td_abs + eps
            written_ok.append(torch.isin(idx, idx[got == want]).all())
            counts["write_backs"] += 1
            return out
        return update

    def spy_segment(real):
        def make(*a, **kw):
            segment = real(*a, **kw)

            def timed(st):
                states.append(st)
                t = time.monotonic()
                out = segment(st)
                torch.cuda.synchronize()
                seg_s.append(time.monotonic() - t)
                return out
            return timed
        return make

    kernels.reset_launches()
    with patched(replay_mod, "add_batch", spy_add), \
            patched(replay_mod, "sample_prioritized", spy_sample), \
            patched(replay_mod, "update_priorities", spy_update), \
            patched(ddpg, "make_segment", spy_segment):
        final = ddpg.main(REPLAY_EXT_ARGV)
    launches = dict(kernels.LAUNCHES)
    opts = ddpg.make_parser().parse_args(REPLAY_EXT_ARGV)
    st = states[-1]
    sampler = sampler_check(st.replay, opts.per_alpha, betas[-1], opts.n_step, opts.gamma)
    pri = st.replay.priority
    checks = {
        "prioritized_replay": st.replay.prioritized and st.replay.block == NUM_ENVS
        and st.replay.capacity == 4 * NUM_ENVS,
        "inserts_stamp_max_priority": counts["inserts"] > 0 and bool(torch.stack(stamp_ok).all()),
        "write_backs_are_td_plus_eps": counts["write_backs"] > 0
        and bool(torch.stack(written_ok).all()),
        # n = 3 excludes the newest 3 blocks: the gate opens once the ring
        # holds 4, at step 4 of 40.
        "updates_after_gate": counts["write_backs"] == 2 * 20 - 3,
        "beta_anneals": betas[0] < betas[-1] <= 1.0,
        "priorities_finite_positive": bool(torch.isfinite(pri).all() and (pri > 0).all()),
        "eval_finite": math.isfinite(final),
        "sampler_only_boundary_index_differences": sampler["other_index_differences"] == 0,
        "sampler_fields_equal": sampler["fields_equal_at_equal_indices"],
        "sampler_weights_close": sampler["iw_max_rel_err"] <= 1e-5,
        "nstep_batch_equal": sampler["nstep_batch_equal"],
        "slab_kernels_launched": all(launches[k] > 0 for k in (
            "step_repeats", "step_substeps", "render_repeats", "render_batched")),
    }
    line = dict(argv=REPLAY_EXT_ARGV, segment_s=seg_s, final_eval=final, inserts=counts["inserts"],
                write_backs=counts["write_backs"], beta_first=betas[0], beta_last=betas[-1],
                priority_max=float(pri.max()), priority_min=float(pri.min()),
                sampler=sampler, launches=launches, checks=checks)
    return line, launches


@contextlib.contextmanager
def patched(obj, name: str, make):
    """Replace ``obj.name`` by ``make(original)`` for the block."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def host_tree(tree):
    """A host copy of a nested state dict (tensors cloned to the CPU)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def trees_equal(a, b) -> bool:
    """Nested dicts equal key for key, tensors byte for byte."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            trees_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a == b


def net_state(st) -> dict:
    """Host copies of a training state's networks' parameters (and of SAC's
    ``log_alpha``)."""
    nets = {k: host_tree(getattr(st, k).state_dict()) for k in type(st)._NETS}
    if hasattr(st, "log_alpha"):
        nets["log_alpha"] = {"": st.log_alpha.detach().cpu().clone()}
    return nets


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def drive_cli(agent, argv: list, work: str, whole: bool = False,
              eval_extra: tuple = (), first_extra: tuple = ()) -> SimpleNamespace:
    """``agent.main`` in-process on ``argv``: 2 segments (with
    ``first_extra``); a resume to 4 (both with --ckpt-best); a
    --ckpt-skip-replay save and resume to 3; --eval-only on the latest (with
    ``eval_extra``) and on --ckpt-best.  Spies on
    checkpoint.save/restore_latest (the networks at each save and after
    each restore; with ``whole`` the whole state dict too, at step 2),
    ``agent.make_segment`` (each segment's seconds and launches) and
    eval_rollout (its seconds) → what the runs left behind."""
    ckpt_dir, lean_dir = os.path.join(work, "ckpt"), os.path.join(work, "lean")
    metrics, lean_metrics = os.path.join(work, "m.jsonl"), os.path.join(work, "lean.jsonl")
    saved, restored, seg_s, seg_launches, eval_s = {}, [], [], [], []
    saved_whole, restored_whole = {}, {}

    def spy_save(real):
        def save(d, step, tree, skip_replay=False):
            saved[(d, step)] = net_state(tree)
            if whole and step == 2:  # the saves restored_whole_equals_saved compares
                saved_whole[(d, step)] = host_tree(tree.state_dict())
            return real(d, step, tree, skip_replay)
        return save

    def spy_restore(real):
        def restore(d, target):
            out, step = real(d, target)
            if step is not None:
                restored.append((d, step, net_state(out), out.replay.size))
                if whole and step == 2:
                    restored_whole[(d, step)] = host_tree(out.state_dict())
            return out, step
        return restore

    def spy_segment(real):
        def make(*a, **kw):
            segment = real(*a, **kw)

            def timed(st):
                before = dict(kernels.LAUNCHES)
                t = time.monotonic()
                out = segment(st)
                torch.cuda.synchronize()
                seg_s.append(time.monotonic() - t)
                seg_launches.append({k: v - before[k] for k, v in kernels.LAUNCHES.items()})
                return out
            return timed
        return make

    def spy_eval(real):
        def timed(*a, **kw):
            t = time.monotonic()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            eval_s.append(time.monotonic() - t)
            return out
        return timed

    def run(d, jsonl, n, *extra):
        return agent.main([*argv, "--ckpt-dir", d, "--metrics-jsonl", jsonl,
                           "--num-train-batches", str(n), *extra])

    kernels.reset_launches()
    with patched(checkpoint, "save", spy_save), \
            patched(checkpoint, "restore_latest", spy_restore), \
            patched(agent, "make_segment", spy_segment), patched(common, "eval_rollout", spy_eval):
        run(ckpt_dir, metrics, 2, "--ckpt-best", *first_extra)
        first = {n: os.path.getmtime(os.path.join(ckpt_dir, f"ckpt_{n}.pt"))
                 for n in (1, 2) if os.path.exists(os.path.join(ckpt_dir, f"ckpt_{n}.pt"))}
        run(ckpt_dir, metrics, 4, "--ckpt-best")
        files_after_resume = sorted(os.listdir(ckpt_dir))
        run(lean_dir, lean_metrics, 2, "--ckpt-skip-replay")
        lean_raw = checkpoint.load_raw(lean_dir, 2)
        run(lean_dir, lean_metrics, 3, "--ckpt-skip-replay")
        n_eval = len(eval_s)
        eval_latest = run(ckpt_dir, metrics, 4, "--eval-only", *eval_extra)
        eval_best = run(ckpt_dir, metrics, 4, "--eval-only", "--ckpt-best")
    events, lean_events = read_jsonl(metrics), read_jsonl(lean_metrics)
    return SimpleNamespace(
        ckpt_dir=ckpt_dir, lean_dir=lean_dir, saved=saved, seg_s=seg_s,
        seg_launches=seg_launches, saved_whole=saved_whole, restored_whole=restored_whole,
        eval_s=eval_s,
        n_eval=n_eval, first=first, files_after_resume=files_after_resume, lean_raw=lean_raw,
        last_raw=checkpoint.load_raw(ckpt_dir, 4), eval_latest=eval_latest,
        eval_best=eval_best, launches=dict(kernels.LAUNCHES), events=events,
        lean_events=lean_events, best=checkpoint.best_meta(ckpt_dir),
        resume={(d, step): (nets, size) for d, step, nets, size in restored},
        trains=[e for e in events if e["event"] == "train"],
        evals=[e for e in events if e["event"] == "eval_only"])


def cli_checks(r: SimpleNamespace, fresh: tuple, fields: dict, steps_per_segment: int,
               num_envs: int, full_size: int, loss_keys=("critic_loss", "actor_loss")) -> dict:
    """The checks ``ddpg_cli`` and ``sac_cli`` share: finite losses, the JAX
    jsonl fields, the events in order, monotonic env steps and checkpoint
    numbers, restored networks byte-equal to the saved ones, the replay
    restored whole from a full file and empty from a skip-replay one, and
    both eval-only evals (the latest equal to ``fresh``, a fresh eval of
    the in-memory actor at its last save)."""
    fresh_len, fresh_rew = fresh
    lean_trains = [e for e in r.lean_events if e["event"] == "train"]
    return {
        "losses_finite": all(math.isfinite(e[k]) for e in r.trains + lean_trains
                             for k in loss_keys),
        "jax_field_sets": all(list(e) == fields[e["event"]] for e in r.events + r.lean_events),
        "events": [e["event"] for e in r.events
                   if e["event"] not in ("event_log", "export_policy")] == [
            "train", "restore", "train", "restore", "eval_only", "restore", "eval_only"],
        "env_steps_monotonic": [e["env_steps"] for e in r.trains] == [
            s * steps_per_segment * num_envs for s in (2, 4)],
        "resume_numbering": r.files_after_resume[-2:] == ["ckpt_best.pt", "ckpt_best.pt.json"]
        and "ckpt_4.pt" in r.files_after_resume and all(
            os.path.getmtime(os.path.join(r.ckpt_dir, f"ckpt_{n}.pt")) == t
            for n, t in r.first.items()),
        "restored_equals_saved": trees_equal(r.resume[(r.ckpt_dir, 2)][0], r.saved[(r.ckpt_dir, 2)])
        and trees_equal(r.resume[(r.lean_dir, 2)][0], r.saved[(r.lean_dir, 2)]),
        "full_replay_restored": r.resume[(r.ckpt_dir, 2)][1] == full_size,
        "skip_replay_file_empty": tuple(r.lean_raw["replay"]["s1"].shape) == (0,)
        and r.lean_raw["replay"]["size"] == 0,
        "skip_replay_restores_empty": r.resume[(r.lean_dir, 2)][1] == 0,
        "skip_replay_resume_trained": [e["segment"] for e in lean_trains] == [2, 3],
        "eval_only_latest": r.evals[0]["segment"] == 4
        and (r.evals[0]["eval_ep_len"], r.evals[0]["eval_ep_rew"]) == (float(fresh_len),
                                                                      float(fresh_rew))
        and r.eval_latest == r.evals[0]["eval_ep_len"],
        "eval_only_best": r.best is not None and r.evals[1]["segment"] == r.best["step"]
        and r.eval_best == r.evals[1]["eval_ep_len"],
        "slab_kernels_launched": all(r.launches[k] > 0 for k in (
            "step_repeats", "step_substeps", "render_repeats", "render_batched")),
    }


def cli_line(r: SimpleNamespace, argv: list, fresh: tuple, checks: dict) -> dict:
    train_evals = r.eval_s[:r.n_eval]
    return dict(argv=argv, segments_run=len(r.seg_s),
                segment_s=r.seg_s, mean_segment_s=sum(r.seg_s[1:]) / max(len(r.seg_s) - 1, 1),
                eval_s=r.eval_s, mean_eval_s=sum(train_evals) / max(len(train_evals), 1),
                train_events=r.trains, eval_only_events=r.evals,
                fresh_eval={"eval_ep_len": float(fresh[0]), "eval_ep_rew": float(fresh[1])},
                best_meta=r.best, launches=r.launches, checks=checks)


def artifact_paths(art: dict, name: str) -> dict:
    return {k: os.path.join(art["dir"], f"{name}_{k}.pt2") for k in ("trained", "eval_only")}


def exported_checks(r: SimpleNamespace, paths: dict) -> bool:
    """The two ``export_policy`` events of a :func:`drive_cli` run with
    ``--export-policy`` on its first run and its first --eval-only run: each
    right after that run's last event, naming its artifact and its bytes."""
    names = [e["event"] for e in r.events]
    logged = [(i, e) for i, e in enumerate(r.events) if e["event"] == "export_policy"]
    return [e["path"] for _, e in logged] == [paths["trained"], paths["eval_only"]] \
        and all(e["bytes"] == os.path.getsize(e["path"]) for _, e in logged) \
        and [names[i - 1] for i, _ in logged] == ["train", "eval_only"]


def tb_check(tb: str, trains: list) -> tuple[bool, dict]:
    """``--tb-dir`` on a run whose ``train`` events are ``trains``: where
    tensorboard imports, the logdir's ``train/eval_ep_len`` scalars are
    those events' (step = segment); where it does not, the logger only
    warned and wrote no logdir → (ok, what was read)."""
    if importlib.util.find_spec("tensorboard") is None:
        return not os.path.exists(tb), {"tb_available": False}
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(tb)
    acc.Reload()
    got = [(e.step, e.value) for e in acc.Scalars("train/eval_ep_len")]
    want = [(e["segment"], e["eval_ep_len"]) for e in trains]
    return got == want and len(got) > 0, {"tb_available": True, "tags": acc.Tags()["scalars"],
                                          "eval_ep_len": got}


def ddpg_cli(work: str, dev, art: dict) -> tuple[dict, dict]:
    """``ddpg.main`` in-process at config 5 full width through
    :func:`drive_cli`'s runs, and its checks; ``--tb-dir`` and
    ``--export-policy`` on the first run and ``--export-policy`` on the
    first --eval-only run (the conv Actor, uint8 frames in).  The artifacts
    (in ``art["dir"]``), the actor's saved weights and 4096 of the replay's
    config-5 frames go into ``art`` for :func:`export_check`."""
    tb, paths = os.path.join(work, "tb"), artifact_paths(art, "ddpg")
    r = drive_cli(ddpg, CLI_ARGV, work, whole=True,
                  first_extra=("--tb-dir", tb, "--export-policy", paths["trained"]),
                  eval_extra=("--export-policy", paths["eval_only"]))
    # A fresh eval of the in-memory actor at its last save, same generator seed.
    actor = Actor(CONFIG5.obs_shape, device=dev, **TD3_NET)
    actor.load_state_dict(r.saved[(r.ckpt_dir, 4)]["actor"])
    fresh = eval_rollout(make_venv(CONFIG5_CLI, 64, device=dev), greedy_act(actor),
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    checks = cli_checks(r, fresh, EVENT_FIELDS, 20, NUM_ENVS, 8192)
    checks["resume_numbering"] = checks["resume_numbering"] and r.files_after_resume == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt", "ckpt_best.pt", "ckpt_best.pt.json"]
    checks["restored_whole_equals_saved"] = restored_whole_equals_saved(r)
    first_run = r.events[:[e["event"] for e in r.events].index("restore")]
    checks["tb_scalars"], tb = tb_check(tb, [e for e in first_run if e["event"] == "train"])
    checks["export_policy_events"] = exported_checks(r, paths)
    art["ddpg"] = {"paths": paths, "states": {n: r.saved[(r.ckpt_dir, n)]["actor"] for n in (2, 4)}}
    art["frames"] = r.last_raw["replay"]["s1"][:NUM_ENVS].clone()
    line = cli_line(r, CLI_ARGV, fresh, checks)
    line["tensorboard"] = tb
    return line, r.launches


def sac_cli(work: str, dev) -> tuple[dict, dict]:
    """``sac.main`` in-process with the config-5 SAC recipe at full width
    (512 envs, conv encoder, replay 16384, batch 256) through
    :func:`drive_cli`'s runs; the checks of ``ddpg_cli`` and SAC's own:
    ``alpha`` at or above ``--alpha-min`` on every trained segment, and
    ``log_alpha`` and ``alpha_opt`` in the checkpoint."""
    r = drive_cli(sac, SAC_ARGV, work, whole=True)
    actor = GaussianActor(CONFIG5.obs_shape, device=dev, **TD3_NET)
    actor.load_state_dict(r.saved[(r.ckpt_dir, 4)]["actor"])
    fresh = eval_rollout(make_venv(CONFIG5_CLI, 64, device=dev), sac.greedy_act(actor),
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    checks = cli_checks(r, fresh, SAC_EVENT_FIELDS, CLI_STEPS, SAC_ENVS,
                        min(2 * CLI_STEPS * SAC_ENVS, SAC_REPLAY),
                        loss_keys=("critic_loss", "actor_loss", "alpha", "entropy"))
    lean_trains = [e for e in r.lean_events if e["event"] == "train"]
    log_alpha = r.last_raw.get("log_alpha")
    alpha_opt = r.last_raw.get("alpha_opt") or {}
    checks.update({
        "alpha_at_or_above_floor": all(e["alpha"] >= SAC_ALPHA_MIN for e in r.trains + lean_trains),
        "checkpoint_holds_log_alpha": torch.is_tensor(log_alpha) and log_alpha.dim() == 0
        and math.exp(float(log_alpha)) >= SAC_ALPHA_MIN * (1 - 1e-6),
        "checkpoint_holds_alpha_opt": bool(alpha_opt.get("state")),
        "restored_log_alpha": "log_alpha" in r.resume[(r.ckpt_dir, 2)][0],
        "restored_whole_equals_saved": restored_whole_equals_saved(r),
    })
    line = cli_line(r, SAC_ARGV, fresh, checks)
    line["log_alpha"] = None if log_alpha is None else float(log_alpha)
    return line, r.launches


def load_dqn_q(root: str) -> dict:
    """The Rainbow checkpoint's online QNetwork leaves from their npz, its
    bytes checked by sha256 → a QNetwork state_dict."""
    path = os.path.join(root, DQN_Q)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} is absent: the dqn_crossload phase reads it")
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != DQN_Q_SHA256:
        raise AssertionError(f"{path} has sha256 {digest}, not the exported network's")
    with np.load(path) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    return q_network_params_from_flax(tree)


def dqn_crossload(sd: dict, dev) -> tuple[dict, dict]:
    """The JAX full Rainbow checkpoint's QNetwork (dueling, C51, noisy) on
    the card: its atom logits and C51 means (the unit support greedy acting
    reads) on the eval's first observations against the same module on the
    CPU (bf16 bound), then greedy evals on a 64-env venv of the low-dim
    discrete config (K1, K2), one per generator seed."""
    qs = {}
    for where in ("cpu", dev):
        qs[str(where)] = QNetwork(CONFIG_DQN.obs_shape, device=where, **DQN_NET)
        qs[str(where)].load_state_dict(sd)
    q_c, q_g = qs["cpu"], qs[str(dev)]
    venv = make_venv(CONFIG_DQN, CROSSLOAD_ENVS, device=dev)
    _, obs = venv.reset(torch.Generator(device=dev).manual_seed(0))
    z = dqn.support(0.0, 1.0, DQN_NET["num_atoms"])
    with torch.no_grad():
        out_g, out_c = q_g(obs), q_c(obs.cpu())
        mean_g, mean_c = dqn.q_scalar(out_g.cpu(), z), dqn.q_scalar(out_c, z)
        q_ms = time_ms(lambda: q_g(obs), reps=50)
    errs = {"logits": float((out_g.cpu() - out_c).abs().max()),
            "c51_mean": float((mean_g - mean_c).abs().max())}
    act = dqn.greedy_act(q_g)
    per_seed = []
    kernels.reset_launches()
    for seed in range(CROSSLOAD_SEEDS):
        t = time.monotonic()
        mean_len, mean_rew = eval_rollout(venv, act, torch.Generator(device=dev).manual_seed(seed))
        per_seed.append({"seed": seed, "mean_len": float(mean_len), "mean_rew": float(mean_rew),
                         "eval_s": time.monotonic() - t})
    launches = dict(kernels.LAUNCHES)
    lens = [p["mean_len"] for p in per_seed]
    mean_len = sum(lens) / len(lens)
    lo, hi = min(JAX_CPU_DQN_LENS) - CROSSLOAD_WIDEN, max(JAX_CPU_DQN_LENS) + CROSSLOAD_WIDEN
    checks = {
        **{f"{k}_within_bound": v <= CONV_ATOL for k, v in errs.items()},
        "finite": all(math.isfinite(p[k]) for p in per_seed for k in ("mean_len", "mean_rew"))
        and bool(torch.isfinite(out_g).all()),
        "episode_len_in_range": all(1.0 <= v <= CONFIG_DQN.max_episode_len for v in lens),
        "physics_launched": launches["step_repeats"] > 0 and launches["step_substeps"] > 0,
        "render_not_launched": all(v == 0 for k, v in launches.items()
                                   if k.startswith(("render", "pack"))),
    }
    line = dict(envs=CROSSLOAD_ENVS, bound=CONV_ATOL, max_abs_err=errs, q_ms=q_ms,
                greedy_actions_equal_cpu=int((torch.argmax(mean_g, -1)
                                              == torch.argmax(mean_c, -1)).sum()),
                per_seed=per_seed, mean_len=mean_len, min_len=min(lens), max_len=max(lens),
                mean_rew=sum(p["mean_rew"] for p in per_seed) / len(per_seed),
                jax_recorded=JAX_RECORDED_DQN, jax_cpu_eval_lens=JAX_CPU_DQN_LENS,
                jax_cpu_mean_len=sum(JAX_CPU_DQN_LENS) / len(JAX_CPU_DQN_LENS),
                jax_cpu_range_widened=(lo, hi), within_jax_cpu_range_widened=lo <= mean_len <= hi,
                launches=launches, checks=checks)
    return line, launches


def dqn_cli(work: str, dev, art: dict) -> tuple[dict, dict]:
    """``dqn.main`` in-process at config 5 with the full Rainbow flags (512
    envs, conv encoder, replay 8192, batch 256) through :func:`drive_cli`'s
    runs, ``--export-policy`` on the first run and the first --eval-only run
    (the C51 QNetwork with NoisyNet heads, action indices out; artifacts and
    saved weights into ``art`` for :func:`export_check`); the checks of
    ``ddpg_cli`` and DQN's own: ``eps`` 0 (NoisyNet
    exploration) on every trained segment, the restored state (networks,
    Adam, schedule, replay, env states, obs, generator, ``env_steps``)
    byte-equal to the saved one (a skip-replay file's without the replay),
    every stored action an index in [0, 5), priorities written back once
    per update, and K2 and K4 launched once per segment (its reset pool)."""
    writes, samples = [], []

    def spy_update(real):
        def update(replay, idx, priority, *a, **kw):
            writes.append(int(priority.shape[0]))
            return real(replay, idx, priority, *a, **kw)
        return update

    def spy_sample(real):
        def sample(*a, **kw):
            samples.append(1)
            return real(*a, **kw)
        return sample

    with patched(replay_mod, "update_priorities", spy_update), \
            patched(replay_mod, "sample_prioritized", spy_sample):
        paths = artifact_paths(art, "dqn")
        r = drive_cli(dqn, DQN_ARGV, work, whole=True,
                      first_extra=("--export-policy", paths["trained"]),
                      eval_extra=("--export-policy", paths["eval_only"]))
    q = QNetwork(CONFIG5.obs_shape, device=dev, **TD3_NET, **DQN_NET)
    q.load_state_dict(r.saved[(r.ckpt_dir, 4)]["q"])
    cfg = dataclasses.replace(CONFIG5_CLI, discrete_actions=True)
    fresh = eval_rollout(make_venv(cfg, 64, device=dev), dqn.greedy_act(q),
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    checks = cli_checks(r, fresh, DQN_EVENT_FIELDS, CLI_STEPS, DQN_ENVS, 8192, loss_keys=("loss",))
    lean_trains = [e for e in r.lean_events if e["event"] == "train"]
    actions = r.last_raw["replay"]["action"]
    priority = r.last_raw["replay"]["priority"]
    checks.update({
        "eps_zero": all(e["eps"] == 0.0 for e in r.trains + lean_trains),
        "restored_state_equals_saved": restored_whole_equals_saved(r),
        "actions_in_range": actions.dtype == torch.int32 and int(actions.min()) >= 0
        and int(actions.max()) < 5,
        "priorities_written_back": len(writes) > 0 and len(writes) == len(samples)
        and all(n == int(DQN_ARGV[DQN_ARGV.index("--batch-size") + 1]) for n in writes)
        and int(torch.unique(priority).numel()) > 1
        and float(priority.min()) > 0.0,
        "reset_kernels_every_segment": len(r.seg_launches) == 7 and all(
            d["step_substeps"] == 1 and d["render_batched"] == 1 for d in r.seg_launches),
        "export_policy_events": exported_checks(r, paths),
    })
    art["dqn"] = {"paths": paths, "states": {n: r.saved[(r.ckpt_dir, n)]["q"] for n in (2, 4)}}
    line = cli_line(r, DQN_ARGV, fresh, checks)
    line.update(priority_writes=len(writes), segment_launches=r.seg_launches,
                action_range=(int(actions.min()), int(actions.max())))
    return line, r.launches


def drive_onpolicy(agent, argv: list, work: str) -> SimpleNamespace:
    """``agent.main`` in-process on ``argv``: 2 updates and a resume to 4
    (both with --ckpt-best), then --eval-only on the latest checkpoint and
    on --ckpt-best.  Spies on checkpoint.save/restore_latest (the whole
    state dict at the saves of updates 2 and 4, which the resume and the
    eval-only run restore, and after each restore; every save's
    ``update``), ``agent.make_train_step``
    (each update's seconds and launches) and eval_rollout (its seconds) →
    what the runs left behind."""
    ckpt_dir, metrics = os.path.join(work, "ckpt"), os.path.join(work, "m.jsonl")
    saved, restored, step_s, step_launches, eval_s, updates = {}, {}, [], [], [], {}

    def spy_save(real):
        def save(d, step, tree, skip_replay=False):
            sd = tree.state_dict()
            updates[step] = sd["update"]
            if step in (2, 4):  # the saves restored_equals_saved compares
                saved[step] = host_tree(sd)
            return real(d, step, tree, skip_replay)
        return save

    def spy_restore(real):
        def restore(d, target):
            out, step = real(d, target)
            if step is not None:
                restored[step] = host_tree(out.state_dict())
            return out, step
        return restore

    def spy_train_step(real):
        def make(*a, **kw):
            train_step = real(*a, **kw)

            def timed(st):
                before = dict(kernels.LAUNCHES)
                t = time.monotonic()
                out = train_step(st)
                torch.cuda.synchronize()
                step_s.append(time.monotonic() - t)
                step_launches.append({k: v - before[k] for k, v in kernels.LAUNCHES.items()})
                return out
            return timed
        return make

    def spy_eval(real):
        def timed(*a, **kw):
            t = time.monotonic()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            eval_s.append(time.monotonic() - t)
            return out
        return timed

    def run(n, *extra):
        return agent.main([*argv, "--ckpt-dir", ckpt_dir, "--metrics-jsonl", metrics,
                           "--num-train-batches", str(n), *extra])

    kernels.reset_launches()
    with patched(checkpoint, "save", spy_save), \
            patched(checkpoint, "restore_latest", spy_restore), \
            patched(agent, "make_train_step", spy_train_step), \
            patched(common, "eval_rollout", spy_eval):
        run(2, "--ckpt-best")
        first = {n: os.path.getmtime(os.path.join(ckpt_dir, f"ckpt_{n}.pt")) for n in (1, 2)}
        run(4, "--ckpt-best")
        files = sorted(os.listdir(ckpt_dir))
        n_eval = len(eval_s)
        eval_latest = run(4, "--eval-only")
        eval_best = run(4, "--eval-only", "--ckpt-best")
    events = read_jsonl(metrics)
    return SimpleNamespace(
        ckpt_dir=ckpt_dir, saved=saved, restored=restored, updates=updates, step_s=step_s,
        step_launches=step_launches, eval_s=eval_s, n_eval=n_eval, first=first, files=files,
        eval_latest=eval_latest, eval_best=eval_best, launches=dict(kernels.LAUNCHES),
        events=events, best=checkpoint.best_meta(ckpt_dir),
        trains=[e for e in events if e["event"] == "train"],
        evals=[e for e in events if e["event"] == "eval_only"])


def onpolicy_checks(r: SimpleNamespace, fresh: tuple, train_fields: list,
                    loss_keys: tuple) -> dict:
    """The checks ``ppo_cli`` and ``lrpg_cli`` share: finite losses, the JAX
    jsonl fields, the events in order, updates 1-4 with a checkpoint each
    (the first run's files untouched by the resume), the restored state
    (networks, optimizer, env states, obs, generator, ``update``) byte-equal
    to the saved one at the resume and at the eval-only restore, both
    eval-only evals (the latest equal to ``fresh``, a fresh eval of the
    in-memory policy at its last save), K1-K4 launched and K2 and K4 on
    every update (its reset)."""
    fields = {"train": train_fields, "restore": EVENT_FIELDS["restore"],
              "eval_only": EVENT_FIELDS["eval_only"]}
    fresh_len, fresh_rew = fresh
    return {
        "losses_finite": all(math.isfinite(e[k]) for e in r.trains for k in loss_keys),
        "jax_field_sets": all(list(e) == fields[e["event"]] for e in r.events),
        "events": [e["event"] for e in r.events] == [
            "train", "train", "restore", "train", "train", "restore", "eval_only", "restore",
            "eval_only"],
        "update_numbering": [e["update"] for e in r.trains] == [1, 2, 3, 4]
        and r.files == ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt", "ckpt_best.pt",
                        "ckpt_best.pt.json"]
        and all(os.path.getmtime(os.path.join(r.ckpt_dir, f"ckpt_{n}.pt")) == t
                for n, t in r.first.items()),
        "saved_updates": all(r.updates[n] == n for n in (1, 2, 3, 4)),
        "restored_equals_saved": sorted(r.restored) == [2, 4]
        and all(trees_equal(r.restored[n], r.saved[n]) for n in (2, 4)),
        "eval_only_latest": r.evals[0]["segment"] == 4
        and (r.evals[0]["eval_ep_len"], r.evals[0]["eval_ep_rew"]) == (float(fresh_len),
                                                                      float(fresh_rew))
        and r.eval_latest == r.evals[0]["eval_ep_len"],
        "eval_only_best": r.best is not None and r.evals[1]["segment"] == r.best["step"]
        and r.eval_best == r.evals[1]["eval_ep_len"],
        "slab_kernels_launched": all(r.launches[k] > 0 for k in (
            "step_repeats", "step_substeps", "render_repeats", "render_batched")),
        "reset_kernels_every_update": len(r.step_launches) == 4 and all(
            d["step_substeps"] >= 1 and d["render_batched"] >= 1 for d in r.step_launches),
    }


def onpolicy_line(r: SimpleNamespace, argv: list, fresh: tuple, checks: dict) -> dict:
    train_evals = r.eval_s[:r.n_eval]
    return dict(argv=argv, updates_run=len(r.step_s), update_s=r.step_s,
                mean_update_s=sum(r.step_s[1:]) / max(len(r.step_s) - 1, 1),
                update_launches=r.step_launches, eval_s=r.eval_s,
                mean_eval_s=sum(train_evals) / max(len(train_evals), 1),
                train_events=r.trains, eval_only_events=r.evals,
                fresh_eval={"eval_ep_len": float(fresh[0]), "eval_ep_rew": float(fresh[1])},
                best_meta=r.best, launches=r.launches, checks=checks)


def ppo_cli(work: str, dev) -> tuple[dict, dict]:
    """``ppo.main`` in-process at config 5 (512 envs, conv encoder, 32-step
    rollouts, 4 × 4 minibatches of 4096, cosine schedule) through
    :func:`drive_onpolicy`'s runs; its checks and PPO's own: ``clip_frac``
    in [0, 1], ``env_steps`` = update × 32 × 512."""
    r = drive_onpolicy(ppo, PPO_ARGV, work)
    actor = GaussianActor(CONFIG5.obs_shape, device=dev, **TD3_NET)
    actor.load_state_dict(r.saved[4]["params"]["actor"])
    fresh = eval_rollout(make_venv(CONFIG5_CLI, 64, device=dev), ppo.greedy_act(actor),
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    checks = onpolicy_checks(r, fresh, PPO_TRAIN_FIELDS,
                             ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"))
    checks.update({
        "clip_frac_in_unit": all(0.0 <= e["clip_frac"] <= 1.0 for e in r.trains),
        "env_steps": [e["env_steps"] for e in r.trains] == [
            u * PPO_ROLLOUT * ONPOLICY_ENVS for u in (1, 2, 3, 4)],
    })
    return onpolicy_line(r, PPO_ARGV, fresh, checks), r.launches


def lrpg_cli(work: str, dev) -> tuple[dict, dict]:
    """``lrpg.main`` in-process at config 5 (512 envs, conv encoder,
    40-step episodes) through :func:`drive_onpolicy`'s runs; its checks
    and LRPG's own: every sampled action an index in [0, 5) (a spy on
    ``lrpg.rollout_batch``), ``train_ep_len`` ≤ 40."""
    actions = []

    def spy_rollout(real):
        def rollout(*a, **kw):
            out = real(*a, **kw)
            actions.append((int(out[1].min()), int(out[1].max()), out[1].dtype == torch.int64))
            return out
        return rollout

    with patched(lrpg, "rollout_batch", spy_rollout):
        r = drive_onpolicy(lrpg, LRPG_ARGV, work)
    policy = DiscretePolicy(CONFIG5.obs_shape, device=dev, **TD3_NET)
    policy.load_state_dict(r.saved[4]["params"])
    cfg = dataclasses.replace(CONFIG5, discrete_actions=True, max_episode_len=LRPG_MAX_LEN)
    fresh = eval_rollout(make_venv(cfg, 64, device=dev), lrpg.greedy_act(policy),
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    checks = onpolicy_checks(r, fresh, LRPG_TRAIN_FIELDS, ("loss", "train_ep_len",
                                                          "train_ep_rew"))
    checks.update({
        "actions_in_range": len(actions) == 4 and all(
            lo >= 0 and hi < 5 and is_int for lo, hi, is_int in actions),
        "train_ep_len_capped": all(0.0 < e["train_ep_len"] <= LRPG_MAX_LEN for e in r.trains),
    })
    line = onpolicy_line(r, LRPG_ARGV, fresh, checks)
    line["sampled_action_range"] = actions
    return line, r.launches


def naf_update_parity(raw: dict, dev) -> dict:
    """NAF_UPDATES updates of a naf_cli checkpoint's conv NAFNetwork with
    batch norm (its network, target and Adam state), on the card and on the
    CPU from the same weights, statistics and batches: rows of its saved
    replay at offsets drawn once on the host, with the recipe's γ, τ,
    reward scale and clip at a constant 3e-4.  After each update, V, µ and
    l_entries of an eval-mode forward on the replay's first 256 rows, card
    against CPU (within CONV_ATOL times the output's max |CPU value|, and
    within half of the update's move of that output on the CPU: nearer the
    CPU's output after the update than before it), and the online and
    target running statistics (within NAF_STATS_RTOL in norm); on the card
    the target's step is held to the Polyak step (``target_step_err``)."""
    hp = dict(gamma=0.99, tau=0.005, reward_scale=0.1, grad_clip=10.0)
    rep = raw["replay"]

    def side(where):
        net, target = (NAFNetwork(CONFIG5.obs_shape, device=where, use_batch_norm=True, **TD3_NET)
                       for _ in range(2))
        net.load_state_dict(raw["variables"])
        target.load_state_dict(raw["target_variables"])
        target.requires_grad_(False)
        opt, _ = ddpg.adam(net, 3e-4)
        # A copy: on the CPU, load_state_dict would keep raw's moments, and
        # the first side's steps would move them under the second.
        opt.load_state_dict(copy.deepcopy(raw["opt"]))
        opt.param_groups[0]["lr"] = 3e-4
        replay = replay_mod.ReplayState(
            **{k: rep[k].to(where) for k in ("s1", "action", "reward", "s2", "terminal",
                                             "priority")},
            cursor=int(rep["cursor"]), size=int(rep["size"]), block=int(rep["block"]))
        return naf.NAFState(net=net, target_net=target, opt=opt, sched=None, replay=replay,
                            env_states=None, obs=None, ou_noise=None, generator=None)

    cpu, card = side("cpu"), side(dev)
    batch = int(NAF_ARGV[NAF_ARGV.index("--batch-size") + 1])
    gen = torch.Generator().manual_seed(SEED)
    offsets = [replay_mod.sample_offsets(cpu.replay, batch, gen) for _ in range(NAF_UPDATES)]
    probe = replay_mod.decode_obs(cpu.replay.s1[:batch])
    train_once = naf.make_train_once(**hp)
    stat = lambda sd: {k: v for k, v in sd.items() if k.endswith(("batch_norm.mean",
                                                                   "batch_norm.var"))}
    rel = lambda a, b: float(torch.linalg.vector_norm(a.cpu().double() - b.double())
                             / torch.linalg.vector_norm(b.double()))
    with torch.no_grad():
        prev_c = cpu.net(probe)
    updates = []
    for off in offsets:
        losses = {}
        t0 = [v.clone() for v in card.target_net.state_dict().values()]
        for name, st in (("cpu", cpu), ("card", card)):
            where = st.replay.s1.device
            losses[name] = float(train_once(st, replay_mod.sample(st.replay, batch,
                                                                  offsets=off.to(where))))
        step_err = target_step_err(t0, list(card.net.state_dict().values()),
                                   list(card.target_net.state_dict().values()), hp["tau"])
        with torch.no_grad():
            out_c = cpu.net(probe)
            out_g = card.net(probe.to(dev))
        errs = {k: float((g.cpu() - c).abs().max())
                for k, g, c in zip(("value", "mu", "l_entries"), out_g, out_c)}
        stats = {f"{which}.{k.rsplit('.', 1)[1]}": rel(v, stat(getattr(cpu, which).state_dict())[k])
                 for which in ("net", "target_net")
                 for k, v in stat(getattr(card, which).state_dict()).items()}
        scale = {k: float(c.abs().max()) for k, c in zip(errs, out_c)}
        bound = {k: CONV_ATOL * scale[k] for k in errs}
        moved = {k: float((c - p).abs().max()) for k, c, p in zip(errs, out_c, prev_c)}
        prev_c = out_c
        updates.append(dict(losses=losses, max_abs_err=errs, scale=scale, bound=bound,
                            max_rel_err={k: errs[k] / max(scale[k], 1e-30) for k in errs},
                            update_moved=moved, stats_rel_err=stats,
                            target_step_rel_err=step_err,
                            finite=all(bool(torch.isfinite(g).all()) for g in out_g)))
    checks = {
        "outputs_within_bound": all(u["max_abs_err"][k] <= u["bound"][k]
                                    for u in updates for k in u["bound"]),
        "outputs_within_half_update": all(u["max_abs_err"][k] < 0.5 * u["update_moved"][k]
                                          for u in updates for k in u["bound"]),
        "stats_within_bound": all(v <= NAF_STATS_RTOL for u in updates
                                  for v in u["stats_rel_err"].values()),
        "target_moved_by_tau": all(u["target_step_rel_err"] < TARGET_STEP_RTOL for u in updates),
        "finite": all(u["finite"] and all(map(math.isfinite, u["losses"].values()))
                      for u in updates),
        "stats_moved": not all(torch.equal(v.cpu(), raw["variables"][k])
                               for k, v in stat(card.net.state_dict()).items()),
    }
    return dict(updates=updates, batch=batch, rel_bound=CONV_ATOL, stats_rtol=NAF_STATS_RTOL,
                hyperparameters={**hp, "learning_rate": 3e-4}, checks=checks)


def restored_whole_equals_saved(r: SimpleNamespace) -> bool:
    """A :func:`drive_cli` run with ``whole``: the state restored from the
    full file of step 2 byte-equal to the one saved, and the one restored
    from the skip-replay file equal to its save but for the replay."""
    no_replay = lambda tree: {k: v for k, v in tree.items() if k != "replay"}
    return trees_equal(r.restored_whole[(r.ckpt_dir, 2)], r.saved_whole[(r.ckpt_dir, 2)]) \
        and trees_equal(no_replay(r.restored_whole[(r.lean_dir, 2)]),
                        no_replay(r.saved_whole[(r.lean_dir, 2)]))


def naf_cli(work: str, dev) -> tuple[dict, dict]:
    """``naf.main`` in-process at config 5 with the NAF recipe's optimiser
    flags and batch norm (512 envs, conv encoder, replay 8192, batch 256)
    through :func:`drive_cli`'s runs; the checks of ``ddpg_cli`` and NAF's
    own: the restored state (networks with their statistics, Adam, schedule,
    replay, env states, obs, OU noise, generator, ``env_steps``) byte-equal
    to the saved one, the checkpoint's online statistics moved from (0, 1),
    the first update's target step (parameters, and the statistics alone)
    the Polyak step of the online network, K2 and K4 launched once per
    segment, and :func:`naf_update_parity` on the last checkpoint."""
    first = []

    def spy_make(real):
        def make(**kw):
            train_once = real(**kw)

            def once(st, batch):
                if first:
                    return train_once(st, batch)
                keys = list(st.target_net.state_dict())
                t0 = [v.clone() for v in st.target_net.state_dict().values()]
                loss = train_once(st, batch)
                first.append((keys, t0, [v.clone() for v in st.net.state_dict().values()],
                              [v.clone() for v in st.target_net.state_dict().values()],
                              kw["tau"]))
                return loss
            return once
        return make

    log_path = os.path.join(work, "eval.events")
    with patched(naf, "make_train_once", spy_make):
        r = drive_cli(naf, NAF_ARGV, work, whole=True, eval_extra=("--event-log-out", log_path))
    logged = [e for e in r.events if e["event"] == "event_log"]
    episodes = list(event_log.read_event_log(log_path))
    event_log_ok = [e["event"] for e in r.events][-4:] == [
        "eval_only", "event_log", "restore", "eval_only"] and len(logged) == 1 \
        and logged[0]["episodes"] == len(episodes) == 3 \
        and logged[0]["lengths"] == [len(ep.event) for ep in episodes]
    net = NAFNetwork(CONFIG5.obs_shape, device=dev, use_batch_norm=True, **TD3_NET)
    net.load_state_dict(r.saved[(r.ckpt_dir, 4)]["net"])
    fresh = eval_rollout(make_venv(CONFIG5_CLI, 64, device=dev), naf.greedy_act(net),
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    checks = cli_checks(r, fresh, NAF_EVENT_FIELDS, CLI_STEPS, NAF_ENVS, 8192, loss_keys=("loss",))
    keys, t0, online, t1, tau = first[0]
    is_stat = [k.endswith(("batch_norm.mean", "batch_norm.var")) for k in keys]
    pick = lambda vs: [v for v, s in zip(vs, is_stat) if s]
    step_err = target_step_err(t0, online, t1, tau)
    stats_step_err = target_step_err(pick(t0), pick(online), pick(t1), tau)
    sd = r.last_raw["variables"]
    parity = naf_update_parity(r.last_raw, dev)
    checks.update({
        "restored_whole_equals_saved": restored_whole_equals_saved(r),
        "batch_norm_stats_moved": float(sd["encoder.batch_norm.mean"].abs().max()) > 0.0
        and float((sd["encoder.batch_norm.var"] - 1.0).abs().max()) > 0.0,
        "target_moved_by_tau": step_err < TARGET_STEP_RTOL,
        "target_stats_moved_by_tau": sum(is_stat) == 2 and stats_step_err < TARGET_STEP_RTOL,
        "reset_kernels_every_segment": len(r.seg_launches) == 7 and all(
            d["step_substeps"] == 1 and d["render_batched"] == 1 for d in r.seg_launches),
        "eval_only_event_log": event_log_ok,
        **{f"card_vs_cpu_{k}": v for k, v in parity["checks"].items()},
    })
    line = cli_line(r, NAF_ARGV, fresh, checks)
    line.update(segment_launches=r.seg_launches, event_log=logged, target_step_rel_err=step_err,
                target_stats_step_rel_err=stats_step_err, card_vs_cpu=parity,
                batch_norm={k.rsplit(".", 1)[1]: [float(sd[k].min()), float(sd[k].max())]
                            for k in ("encoder.batch_norm.mean", "encoder.batch_norm.var")})
    return line, r.launches


def frame_spy(record: list):
    """Patches for ``Renderer.render_repeats``/``render_batched`` that
    record each launch's renderer, input and frames, so the frames can be
    held against the plain version on the same poses."""
    def spy(kind):
        def make(real):
            def call(self, scene, x):
                out = real(self, scene, x)
                poses = x if kind == "repeats" else raycast.poses_from_rigid(x)[None]
                record.append((kind, self, scene, poses.clone(), out.clone()))
                return out
            return call
        return make
    return spy("repeats"), spy("batched")


def per_env_episode(cfg, device, seed: int, warm_up: bool) -> dict:
    """``gym_env.Cartpole`` on ``device``: with ``warm_up`` a reset and one
    step of uniform random actions first, then a reset and PER_ENV_STEPS
    steps, and one ``render()`` → seconds per reset and the median step of
    the timed pass."""
    env = gym_env.Cartpole(cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    assert not cfg.discrete_actions
    sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" else (
        lambda: None)
    for n_steps in (1, PER_ENV_STEPS)[0 if warm_up else 1:]:
        t = time.monotonic()
        obs = env.reset()
        sync()
        reset_s = time.monotonic() - t
        step_s = []
        for _ in range(n_steps):
            t = time.monotonic()
            obs, reward, done, _ = env.step(rng.uniform(-1.0, 1.0, 2).astype(np.float32))
            sync()
            step_s.append(time.monotonic() - t)
            if done:
                obs = env.reset()
    img = env.render()
    return {"reset_s": reset_s, "step_s": sorted(step_s)[len(step_s) // 2],
            "obs_shape": list(obs.shape), "obs_dtype": str(obs.dtype),
            "render_shape": list(img.shape), "render_dtype": str(img.dtype),
            "finite": bool(np.isfinite(obs.astype(np.float64)).all())}


def per_env(work: str, dev) -> tuple[dict, dict]:
    """The per-env surface on the card (``per_env``):

    - the AoS engine card against CPU on AOS_ENVS seeded states: one
      substep within PHYS_ATOL, and the reset's 30-substep push from
      jittered rest states (``reset_batched`` with ``engine.step_substeps``)
      within AOS_PUSH_ATOL;
    - ``gym_env.Cartpole`` at config 5 (K4 for the reset frame, K3 over a
      step's repeats, at E = 1), at 1cam_exact (K5a both) and low-dim: a
      reset and PER_ENV_STEPS steps and ``render()`` (K4) on the card and on
      the CPU, the seconds per reset and per step; every frame the card
      renders held against its plain version on the same poses within the
      pixel rule;
    - one fresh-reset ``VectorCartpole.step`` at NUM_ENVS envs of config 5
      (K1, K3, and K2, K4 for the fresh batch, one launch each);
    - ``random_agent.main`` low-dim, PER_ENV_EPISODES episodes with
      ``--event-log-out --record-renders`` (K4 at E = 1 per step, unpooled
      1-camera frames: the slab cast, as the JAX agent renders), read back
      by the port's reader: episodes and lengths equal to the metrics
      jsonl's, each step's frame within the pixel rule of its plain version
      and its stored PNG equal to that frame."""
    scene = cartpole.scene_for(CONFIG5)
    to_cpu = lambda r: r.map(lambda x: x.cpu())
    rigid, force = parity_inputs(scene, dev, AOS_ENVS)
    substep_err = state_err(to_cpu(engine.substep(scene, rigid, force)),
                            engine.substep(scene, to_cpu(rigid), force.cpu()))
    g = torch.Generator().manual_seed(SEED)
    theta, jitter = 2.0 * math.pi * torch.rand((AOS_ENVS,), generator=g), torch.randn(
        (AOS_ENVS, 2), generator=g)
    pushed = {d: cartpole.reset_batched(CONFIG5, scene, AOS_ENVS, engine.step_substeps,
                                        cartpole.observe_lowdim, d, theta=theta,
                                        jitter=jitter)[0].rigid for d in (dev, "cpu")}
    push_err = {f: float((getattr(pushed[dev], f).cpu() - getattr(pushed["cpu"], f)).abs().max())
                for f in ("pos", "quat", "vel", "ang")}
    one = rigid.map(lambda x: x[:1].contiguous())
    one_cpu, force_cpu = to_cpu(one), force[:1].cpu()
    engine.substep(scene, one_cpu, force_cpu)
    t = time.monotonic()
    for _ in range(10):
        engine.substep(scene, one_cpu, force_cpu)
    aos_ms = {"card": time_ms(lambda: engine.substep(scene, one, force[:1]), reps=10),
              "cpu": (time.monotonic() - t) / 10 * 1e3}

    record = []
    spy_repeats, spy_batched = frame_spy(record)
    kernels.reset_launches()
    timing = {}
    lowdim = dataclasses.replace(CONFIG5, use_raw_pixels=False)
    log_path, jsonl = os.path.join(work, "random.events"), os.path.join(work, "random.jsonl")
    with patched(Renderer, "render_repeats", spy_repeats), \
            patched(Renderer, "render_batched", spy_batched):
        for name, cfg in (("config5", CONFIG5), ("1cam_exact", CONFIG1_EXACT),
                          ("lowdim", lowdim)):
            timing[name] = {"card": per_env_episode(cfg, dev, SEED, warm_up=not timing)}
        env_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        n_env = len(record)
        # The random agent's event log with stored renders (K4 at E = 1 per
        # step), its frames recorded beside the gym env's.
        kernels.reset_launches()
        t = time.monotonic()
        lengths = random_agent.main(["--num-episodes", str(PER_ENV_EPISODES),
                                     "--max-episode-len", str(PER_ENV_STEPS + 1),
                                     "--event-log-out", log_path, "--record-renders",
                                     "--metrics-jsonl", jsonl, "--seed", str(SEED),
                                     "--device", str(dev)])
        agent_s = time.monotonic() - t
        agent_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    frames = {"repeats": 0, "batched": 0, "random_agent": 0, "byte_equal": 0}
    worst = {"max_abs_err": 0, "share_beyond_2": 0.0, "mean_abs_err": 0.0}
    for i, (kind, rnd, scn, poses, out) in enumerate(record):
        want = rnd.plain(scn, poses)
        want = want if kind == "repeats" else want[:, 0]
        res = pixel_check(f"per_env_{kind}{rnd.suffix}", out, want)
        worst = {k: max(worst[k], res[k]) for k in worst}
        frames["random_agent" if i >= n_env else kind] += poses.shape[0]
        frames["byte_equal"] += int(torch.equal(out, want)) * poses.shape[0]
    for i, (name, cfg) in enumerate((("config5", CONFIG5), ("1cam_exact", CONFIG1_EXACT),
                                     ("lowdim", lowdim))):
        timing[name]["cpu"] = per_env_episode(cfg, "cpu", SEED, warm_up=i == 0)

    # One fresh-reset vector step at full width.
    venv = make_venv(CONFIG5, NUM_ENVS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, obs = venv.reset(gen)
    action = torch.zeros((NUM_ENVS, 2), device=dev)
    kernels.reset_launches()
    carried, obs2, reward, done, next_obs = venv.step(states, action, generator=gen)
    torch.cuda.synchronize()
    fresh_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    fresh_ok = fresh_launches == {"step_repeats": 1, "render_repeats": 1, "step_substeps": 1,
                                  "render_batched": 1} \
        and tuple(next_obs.shape) == tuple(obs2.shape) == (NUM_ENVS,) + CONFIG5.obs_shape \
        and bool(torch.isfinite(carried.rigid.pos).all()) and bool(torch.isfinite(reward).all())

    one_env = collections.Counter(env_launches)
    one_env.update(agent_launches)
    launches = one_env + collections.Counter(fresh_launches)
    episodes = list(event_log.read_event_log(log_path))
    logged = [e["steps"] for e in read_jsonl(jsonl) if e["event"] == "episode"]
    # The PNGs the log stores are the kernel's frames (one camera).
    stored = [img for ep in episodes for img in event_log.episode_frames(ep)]
    rendered = [out[0].view(3, *img.shape[:2]).permute(1, 2, 0).cpu().numpy()
                for (_, _, _, _, out), img in zip(record[n_env:], stored)]
    checks = {
        "aos_substep_within_atol": substep_err <= PHYS_ATOL,
        "aos_push_within_atol": max(push_err.values()) <= AOS_PUSH_ATOL,
        "k3_k4_at_one_env": env_launches.get("render_repeats", 0) >= PER_ENV_STEPS
        and env_launches.get("render_batched", 0) >= 2,
        "k5a_at_one_env": env_launches.get("render_repeats_raster", 0) >= PER_ENV_STEPS
        and env_launches.get("render_batched_raster", 0) >= 1,
        "no_physics_kernel_per_env": not any(k.startswith("step_") for k in env_launches),
        "frames_checked": frames["repeats"] >= (1 + 2 * PER_ENV_STEPS) * CONFIG5.action_repeats,
        "shapes": all(t["card"]["obs_shape"] == t["cpu"]["obs_shape"] and t["card"]["finite"]
                      and t["card"]["render_shape"] == [50, 50, 3] for t in timing.values()),
        "fresh_reset_step": fresh_ok,
        "random_agent_log": len(episodes) == len(logged) == PER_ENV_EPISODES
        and [len(ep.event) for ep in episodes] == logged == lengths
        and all(len(ev.render) == 1 and ev.HasField("cart") for ep in episodes
                for ev in ep.event),
        "random_agent_renders_k4": agent_launches == {"render_batched": sum(lengths)}
        and frames["random_agent"] == sum(lengths),
        "random_agent_pngs_are_kernel_frames": len(stored) == len(record) - n_env == sum(lengths)
        and all(np.array_equal(a, b) for a, b in zip(rendered, stored)),
    }
    line = dict(aos_envs=AOS_ENVS, physics_atol=PHYS_ATOL, push_atol=AOS_PUSH_ATOL,
                aos_substep_max_abs_err=substep_err, aos_push_max_abs_err=push_err,
                aos_substep_ms_one_env=aos_ms, per_env_s=timing, steps=PER_ENV_STEPS,
                frames_vs_plain=dict(frames, **worst), gym_env_launches=env_launches,
                one_env_launches=dict(one_env), launches=dict(launches),
                fresh_reset_envs=NUM_ENVS, fresh_reset_launches=fresh_launches,
                random_agent=dict(episodes=len(episodes), lengths=lengths, seconds=agent_s,
                                  launches=agent_launches),
                card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True, text=True,
                                    timeout=60).stdout.strip(), checks=checks)
    return line, dict(launches)


def action_agreement(got: torch.Tensor, want: torch.Tensor, gap: torch.Tensor | None) -> dict:
    """An artifact's actions against the direct greedy act's: continuous
    within CONV_ATOL; discrete equal on every row whose top two atom means
    (``gap``) are more than CONV_ATOL apart."""
    if gap is None:
        err = float((got - want).abs().max())
        return {"max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
                "ok": got.shape == want.shape and err <= CONV_ATOL}
    differ = got != want
    return {"rows_differing": int(differ.sum()), "rows_clear": int((gap > CONV_ATOL).sum()),
            "bit_equal": bool(torch.equal(got, want)),
            "ok": got.shape == want.shape and not bool((differ & (gap > CONV_ATOL)).any())}


# The agents whose artifacts export_check holds: (network at config 5, greedy
# policy, the atoms of the C51 support or None).
EXPORTED = {
    "ddpg": (lambda d: Actor(CONFIG5.obs_shape, device=d, **TD3_NET), ddpg.greedy_act, None),
    "dqn": (lambda d: QNetwork(CONFIG5.obs_shape, device=d, **TD3_NET, **DQN_NET),
            dqn.greedy_act, DQN_NET["num_atoms"]),
}
EXPORT_BATCHES = (1, 64, NUM_ENVS)
EXPORT_CPU_BATCHES = (1, 64)


def export_check(art: dict, dev) -> tuple[dict, dict]:
    """The serving artifacts of ``ddpg_cli`` and ``dqn_cli`` (``export``):

    - the one exported under --eval-only (on the card's run, from its
      weights copied to the CPU) and one this phase exports on the CPU from
      the same saved weights, each loaded on the card and run on 1, 64 and
      4096 config-5 frames (``ddpg_cli``'s replay) against the direct greedy
      act on the card (:func:`action_agreement`);
    - the card run's artifact loaded on the CPU at 1 and 64 frames, equal to
      the greedy act on the CPU bit for bit (as on the CPU tests);
    - the artifact written after the first training run against the greedy
      act with that run's saved weights, on the card at 64 frames;
    - the describe'd signature (symbolic batch from 1, uint8 in), bytes, the
      CPU export's seconds, and ms per call at 4096 frames on the card,
      beside the direct greedy act's."""
    frames = art["frames"]
    kernels.reset_launches()
    line, checks = {}, {}
    for name, (make, greedy, atoms) in EXPORTED.items():
        paths, states = art[name]["paths"], art[name]["states"]
        policies, nets = {}, {}
        for n in (2, 4):
            for where in ("cuda", "cpu"):
                net = make(dev if where == "cuda" else "cpu")
                net.load_state_dict(states[n])
                nets[(n, where)], policies[(n, where)] = net, greedy(net)
        z = None if atoms is None else dqn.support(0.0, 1.0, atoms, dev)

        def gap(obs, n=4):
            if z is None:
                return None
            with torch.no_grad():
                top2 = torch.topk(dqn.q_scalar(nets[(n, "cuda")](obs), z), 2, dim=-1).values
            return top2[:, 0] - top2[:, 1]

        cpu_path = os.path.join(art["dir"], f"{name}_cpu_exported.pt2")
        t = time.monotonic()
        cpu_bytes = export.save_policy(cpu_path, policies[(4, "cpu")], CONFIG5.obs_shape,
                                       torch.uint8)
        export_s = time.monotonic() - t
        meta = export.describe(paths["eval_only"])
        res = {"bytes": meta["bytes"], "bytes_trained": os.path.getsize(paths["trained"]),
               "bytes_cpu_exported": cpu_bytes, "export_s_cpu": export_s,
               "inputs": meta["inputs"], "outputs": meta["outputs"], "batch": meta["batch"]}
        ok = [meta["batch"]["symbolic"] and meta["batch"]["min"] == 1 and meta["dtype"] == "uint8"]
        on_card = {}
        for label, path in (("card_exported", paths["eval_only"]), ("cpu_exported", cpu_path)):
            t = time.monotonic()
            on_card[label] = export.load_policy(path, dev)
            res[f"{label}_load_s"] = time.monotonic() - t
            for b in EXPORT_BATCHES:
                obs = frames[:b].to(dev)
                agree = action_agreement(on_card[label](obs), policies[(4, "cuda")](obs), gap(obs))
                res[f"{label}_on_card_b{b}"] = agree
                ok.append(agree["ok"])
        on_cpu = export.load_policy(paths["eval_only"], "cpu")
        for b in EXPORT_CPU_BATCHES:
            equal = bool(torch.equal(on_cpu(frames[:b]), policies[(4, "cpu")](frames[:b])))
            res[f"card_exported_on_cpu_b{b}_bit_equal"] = equal
            ok.append(equal)
        obs = frames[:64].to(dev)
        agree = action_agreement(export.load_policy(paths["trained"], dev)(obs),
                                 policies[(2, "cuda")](obs), gap(obs, 2))
        res["trained_on_card_b64"] = agree
        ok.append(agree["ok"])
        obs = frames.to(dev)
        res["ms_4096"] = time_ms(lambda: on_card["card_exported"](obs), reps=20)
        res["direct_ms_4096"] = time_ms(lambda: policies[(4, "cuda")](obs), reps=20)
        line[name] = res
        checks[f"{name}_artifacts"] = all(ok)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    checks["no_kernel_launches"] = not launches
    line.update(batches=list(EXPORT_BATCHES), cpu_batches=list(EXPORT_CPU_BATCHES),
                atol=CONV_ATOL, launches=launches, checks=checks)
    return line, dict(kernels.LAUNCHES)


def fidelity_check(log_path: str, work: str, dev) -> tuple[dict, dict]:
    """The fidelity harness on ``per_env``'s random-agent log (recorded on the
    card): its CLI re-simulating every episode on the card with
    ``--tolerance FIDELITY_TOL`` (exit 0), ``resim_episode`` on the CPU, and
    the CLI on a copy with one pose moved by 1 cm, which must exit 1 (on the
    CPU) → ``max_pos_err`` card and CPU, and seconds."""
    kernels.reset_launches()
    out = io.StringIO()
    t = time.monotonic()
    with contextlib.redirect_stdout(out):
        worst_card = fidelity.main(["--log-file", log_path, "--json", "--tolerance",
                                    str(FIDELITY_TOL), "--device", str(dev)])
    card_s = time.monotonic() - t
    card = [json.loads(ln) for ln in out.getvalue().splitlines()]
    episodes = list(event_log.read_event_log(log_path))
    config = CartpoleConfig(max_episode_len=10**9)
    t = time.monotonic()
    cpu = [fidelity.divergence_report(*fidelity.resim_episode(ep, config, "cpu"))
           for ep in episodes if len(ep.event) >= 2]
    cpu_s = time.monotonic() - t
    moved = next(ep for ep in episodes if len(ep.event) >= 2)
    moved.event[-1].cart.position[0] += 0.01
    moved_path = os.path.join(work, "moved.events")
    log = event_log.EventLog(moved_path)
    log.add_episode(moved.event)
    log.close()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        try:
            fidelity.main(["--log-file", moved_path, "--tolerance", "1e-3", "--device", "cpu"])
            moved_exit = 0
        except SystemExit as e:
            moved_exit = e.code
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    checks = {
        "every_episode_resimulated": len(card) == len(cpu) == sum(
            len(ep.event) >= 2 for ep in episodes) > 0,
        "card_within_tolerance": worst_card <= FIDELITY_TOL,
        "cpu_within_tolerance": max(r["max_pos_err"] for r in cpu) <= FIDELITY_TOL,
        "moved_log_exits_1": moved_exit == 1,
        "no_kernel_launches": not launches,
    }
    line = dict(episodes=len(episodes), steps=[len(ep.event) for ep in episodes],
                tolerance=FIDELITY_TOL, card_reports=card, cpu_reports=cpu,
                max_pos_err={"card": worst_card, "cpu": max(r["max_pos_err"] for r in cpu)},
                seconds={"card_cli": card_s, "cpu": cpu_s}, moved_exit=moved_exit,
                launches=launches, checks=checks)
    return line, dict(kernels.LAUNCHES)


def rank_lines(out: str) -> dict:
    """A launcher's stderr → its ranks' ``PARALLEL`` end reports by rank and
    the segments each rank's logger reported training and restoring."""
    ends = [json.loads(ln[9:]) for ln in out.splitlines() if ln.startswith("PARALLEL ")]
    return dict(ends={r["rank"]: r for r in ends if r["event"] == "end"},
                trained=[int(m) for m in re.findall(r"\] train segment=(\d+)", out)],
                restored=[int(m) for m in re.findall(r"\] restore step=(\d+)", out)])


def parallel_check(work: str, dev, ddpg_cli_segment_s: float) -> tuple[dict, dict]:
    """Data parallelism on the one card: (a) one launcher of 2 ranks, (b)
    two launchers resuming from (a)'s global file, (c) a 1-rank NCCL group
    against the plain segment → (the line, the launches of every rank)."""
    ck = os.path.join(work, "ck")
    env = {**os.environ, distributed.RANK_TIMEOUT_ENV: str(PARALLEL_RANK_TIMEOUT_S),
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    os.environ[distributed.RANK_TIMEOUT_ENV] = str(PARALLEL_RANK_TIMEOUT_S)

    # (b)'s two launchers, one rank each, held until (a) has written its file
    go, port = os.path.join(work, "go"), free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HELD_MAIN, go, str(PARALLEL_RANK_TIMEOUT_S), *PARALLEL_ARGV,
         "--num-processes", "2", "--process-id", str(pid), "--coordinator",
         f"localhost:{port}", "--ckpt-dir", ck, "--num-train-batches", "3",
         "--metrics-jsonl", os.path.join(work, f"b{pid}.jsonl")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    try:
        # (a) one launcher, two spawned ranks sharing the card
        m_a = os.path.join(work, "a.jsonl")
        t = time.monotonic()
        final_a = ddpg.main([*PARALLEL_ARGV, "--ckpt-dir", ck, "--metrics-jsonl", m_a,
                             "--num-train-batches", "2"])
        a_s = time.monotonic() - t
        reports_a = list(distributed.LAST_REPORTS)
        trains_a = [e for e in read_jsonl(m_a) if e["event"] == "train"]
        files_a = sorted(os.listdir(ck))

        # (b) resumes to segment 3; (c) runs in this process meanwhile
        t = time.monotonic()
        open(go, "w").close()
        # (c) one config-5 segment on a 1-rank NCCL group against the plain one
        venv = make_venv(CONFIG5, NUM_ENVS)
        plain = parallel.global_ddpg_state(CONFIG5, NUM_ENVS, REPLAY_CAPACITY, seed=SEED,
                                           device=dev)
        want = ddpg.make_segment(venv, **TRAIN_HP)(plain)
        st = parallel.global_ddpg_state(CONFIG5, NUM_ENVS, REPLAY_CAPACITY, seed=SEED,
                                        device=dev)
        kernels.reset_launches()
        t_c = time.monotonic()
        mesh = parallel.init_process_group(f"localhost:{free_port()}", 0, 1, device=dev)
        try:
            segment, shard = parallel.make_distributed_segment(mesh, venv, **TRAIN_HP)
            shard(st)
            got = segment(st)
            torch.cuda.synchronize()
            backend_c = mesh.backend
        finally:
            parallel.destroy()
        c_s = time.monotonic() - t_c
        launches_c = dict(kernels.LAUNCHES)
        nccl_equal = trees_equal(host_tree(st.state_dict()), host_tree(plain.state_dict())) \
            and all(trees_equal(host_tree(got[k]), host_tree(want[k])) for k in want)
        del plain, st, venv
        outs = [p.communicate(timeout=PARALLEL_RANK_TIMEOUT_S + PARALLEL_EXIT_S)[1]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    b_s = time.monotonic() - t
    ranks_b = [rank_lines(out) for out in outs]
    paths = [os.path.join(ck, f"ckpt_3.rank{k}of2.pt") for k in (0, 1)]
    rank_files = [torch.load(p, map_location="cpu", weights_only=True) if os.path.exists(p)
                  else None for p in paths]
    b0 = os.path.join(work, "b0.jsonl")
    events_b = read_jsonl(b0) if os.path.exists(b0) else []

    # the mean over both ranks of their segments after the first (a warm-up)
    a_segment_s = sum(s for r in reports_a for s in r["segment_s"][1:]) / max(
        sum(len(r["segment_s"][1:]) for r in reports_a), 1)
    ranks = {f"a{r['rank']}": r for r in reports_a}
    ranks.update({f"b{k}": rb["ends"].get(k, {}) for k, rb in enumerate(ranks_b)})
    launches = {name: sum(r.get("launches", {}).get(name, 0) for r in ranks.values())
                + launches_c.get(name, 0) for name in kernels.LAUNCHES}
    net_keys = ("actor", "critic", "target_actor", "target_critic", "actor_opt", "critic_opt")
    checks = {
        "a_two_ranks_gloo_on_one_card": [(r["rank"], r["backend"], r["device"])
                                         for r in reports_a] == [(0, "gloo", "cuda:0"),
                                                                 (1, "gloo", "cuda:0")],
        "a_trained_two_segments": [e["segment"] for e in trains_a] == [2]
        and [e["env_steps"] for e in trains_a] == [2 * PARALLEL_STEPS * NUM_ENVS]
        and all(len(r["segment_s"]) == 2 for r in reports_a)
        and all(math.isfinite(e[k]) for e in trains_a for k in ("critic_loss", "actor_loss"))
        and final_a == trains_a[-1]["eval_ep_len"],
        "a_global_file": files_a == ["ckpt_2.pt"],
        "b_both_ranks_restored_at_2": all(
            r["ends"].get(k, {}).get("backend") == "gloo" and r["restored"] == [2]
            for k, r in enumerate(ranks_b)),
        "b_trained_segment_3_only": all(r["trained"] == [3] and len(
            r["ends"].get(k, {}).get("segment_s", [])) == 1 for k, r in enumerate(ranks_b)),
        "b_exit_0": [p.returncode for p in procs] == [0, 0],
        "b_rank_files_nets_equal": None not in rank_files and all(
            trees_equal(rank_files[0][k], rank_files[1][k]) for k in net_keys),
        "b_rank_files_env_shards_differ": None not in rank_files and not torch.equal(
            rank_files[0]["env_states"]["pos"], rank_files[1]["env_states"]["pos"]),
        "b_one_metrics_writer": not os.path.exists(os.path.join(work, "b1.jsonl"))
        and [e["event"] for e in events_b] == ["restore", "train"],
        "k1_k4_on_every_rank": all(r.get("launches", {}).get(k, 0) > 0
                                   for r in ranks.values() for k in _K1_K4),
        "c_nccl": backend_c == "nccl",
        "c_nccl_segment_equals_plain": nccl_equal,
        "c_k1_k4_launched": all(launches_c[k] > 0 for k in _K1_K4),
    }
    if not checks["b_exit_0"]:
        checks["b_stderr_tail"] = [out[-2000:] for out in outs]
    line = dict(
        argv=PARALLEL_ARGV, ranks=PARALLEL_RANKS,
        backend={"a": [r["backend"] for r in reports_a], "b": [
            r["ends"].get(k, {}).get("backend") for k, r in enumerate(ranks_b)], "c": backend_c},
        segment_s={k: r.get("segment_s") for k, r in ranks.items()},
        ddpg_cli_mean_segment_s=ddpg_cli_segment_s,
        ddpg_cli_step_s=ddpg_cli_segment_s / int(CLI_ARGV[CLI_ARGV.index("--steps-per-segment") + 1]),
        a_mean_segment_s=a_segment_s, a_step_s=a_segment_s / PARALLEL_STEPS,
        launches_by_rank={k: {n: v for n, v in r.get("launches", {}).items() if v}
                          for k, r in ranks.items()},
        launches_c={n: v for n, v in launches_c.items() if v},
        a_s=a_s, b_s=b_s, c_s=c_s, a_train_events=trains_a, b_events=events_b,
        checks={k: v for k, v in checks.items() if isinstance(v, bool)},
        **({"b_stderr_tail": checks["b_stderr_tail"]} if "b_stderr_tail" in checks else {}))
    return line, launches


def native_check(work: str) -> dict:
    """The trajlog codec (``native``): the library built from
    ``native/trajlog.cpp`` under the port's ``_build/`` (by the first event
    log of this run, or here), and the same records written by the native
    and the Python codec → byte-equal files, each read back by the other."""
    available = native.native_available()
    payloads = [b"", b"x", os.urandom(1 << 16), os.urandom(3 << 20)]
    files = {}
    t = time.monotonic()
    for force_python in (False, True):
        path = os.path.join(work, f"trajlog_{force_python}.log")
        w = native.RecordWriter(path, force_python=force_python)
        for p in payloads:
            w.write(p)
        w.close()
        with open(path, "rb") as f:
            files[force_python] = (path, f.read())
    round_trip_s = time.monotonic() - t
    checks = {
        "native_available": available,
        "built_under_build": native.BUILD_INFO.get("path", "").startswith(
            native.BUILD_ROOT + os.sep),
        "byte_equal": files[False][1] == files[True][1],
        "cross_read": list(native.read_records(files[False][0], force_python=True)) == payloads
        and list(native.read_records(files[True][0])) == payloads
        and native.scan_records(files[True][0]) == native.scan_records(
            files[False][0], force_python=True),
    }
    return dict(build=native.BUILD_INFO, bytes=len(files[False][1]), round_trip_s=round_trip_s,
                checks=checks)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        return run()
    finally:
        faulthandler.cancel_dump_traceback_later()


def run() -> int:
    t0 = time.monotonic()
    last = [t0]

    def emit(phase: str, **fields):
        now = time.monotonic()
        print(json.dumps({"phase": phase, "elapsed_s": round(now - t0, 3),
                          "phase_s": round(now - last[0], 3), **fields}), flush=True)
        last[0] = now

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    info = kernels.build()
    kernels.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", nvcc_s=round(info["nvcc_s"], 3), built=info["built"], ptxas=ptxas)

    # 3. parity: each kernel against its plain version on seeded states
    scene = cartpole.scene_for(CONFIG5)
    renderer = Renderer(CONFIG5, dev)
    rigid, force = parity_inputs(scene, dev)
    seeded_errs, pix = parity(scene, renderer, rigid, force)
    # The plain version on the card against itself on the CPU, for scale.
    plain_gap = state_err(
        soa.step_substeps_batched(scene, rigid, force, CONFIG5.initial_force_steps).map(lambda x: x.cpu()),
        soa.step_substeps_batched(scene, rigid.map(lambda x: x.cpu()), force.cpu(),
                                  CONFIG5.initial_force_steps))
    emit("parity", envs=PARITY_ENVS, physics_atol=PHYS_ATOL,
         step_substeps_max_abs_err=seeded_errs["step_substeps"],
         step_repeats_max_abs_err=seeded_errs["step_repeats"],
         plain_cuda_vs_cpu_step_substeps_max_abs_err=plain_gap, **pix)

    # 4. K5a against the plain raster version: the 1cam_exact row's own
    # reset state and first step under a seeded actor, and seeded states
    # seen by 2 cameras (the TD3 recipe's camera count).
    spr, reps, n_push = CONFIG5.steps_per_repeat, CONFIG5.action_repeats, CONFIG5.initial_force_steps
    venv1 = make_venv(CONFIG1_EXACT, NUM_ENVS)
    raster1 = Renderer(CONFIG1_EXACT, dev, raster=True)
    actor1 = Actor(CONFIG1_EXACT.obs_shape, use_raw_pixels=True, height=CONFIG1_EXACT.obs_height,
                   width=CONFIG1_EXACT.obs_width, generator=torch.Generator().manual_seed(SEED))
    gen1 = torch.Generator(device=dev).manual_seed(SEED)
    state1, obs1 = venv1.reset(gen1)
    rigid1 = state1.rigid
    with torch.no_grad():
        force1 = cartpole.action_to_force(CONFIG1_EXACT, actor1(obs1))
    _, poses1 = cuda_step.step_repeats(scene, rigid1, force1, spr, reps)
    pix_main = raster_parity(scene, raster1, rigid1, poses1)
    raster2 = Renderer(CONFIG2_EXACT, dev, raster=True)
    _, poses_seeded = soa.step_repeats_batched(scene, rigid, force, spr, reps)
    pix_2cam = raster_parity(scene, raster2, rigid, poses_seeded)
    raster_errs = {k: v["max_abs_err"] for k, v in pix_main.items()}
    seeded_errs.update({k: v["max_abs_err"] for k, v in pix_2cam.items()})
    emit("parity_raster", envs_1cam_exact=NUM_ENVS, envs_2cam_exact=PARITY_ENVS,
         pixel_bound={"level": PIX_LEVEL, "share": PIX_SHARE, "mean": PIX_MEAN},
         one_cam_exact=pix_main, two_cam_exact=pix_2cam)

    # 4b. K5b, K5c and K5d against their plain versions: the main path's
    # 4096-env inputs (config 5's reset state and first step for the ratio
    # slab, the 1cam_exact row's for the raster modes) and the seeded
    # states seen by 2 cameras.
    venv = make_venv(CONFIG5, NUM_ENVS)
    actor = Actor(CONFIG5.obs_shape, use_raw_pixels=True, height=CONFIG5.obs_height,
                  width=CONFIG5.obs_width, generator=torch.Generator().manual_seed(SEED))
    act = greedy_act(actor)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state5, obs5 = venv.reset(gen)
    rigid5 = state5.rigid
    with torch.no_grad():
        force5 = cartpole.action_to_force(CONFIG5, act(obs5))
    _, poses5 = cuda_step.step_repeats(scene, rigid5, force5, spr, reps)
    mode_inputs = {CONFIG5: (rigid5, poses5), CONFIG1_EXACT: (rigid1, poses1)}
    pix_modes, mode_errs = {}, {}
    for name, mode, cfg in MODES:
        seeded_cfg = CONFIG5 if cfg is CONFIG5 else CONFIG2_EXACT
        pix_modes[name] = {
            "main_path": mode_parity(scene, name, mode, cfg, *mode_inputs[cfg]),
            "seeded_2cam": mode_parity(scene, name, mode, seeded_cfg, rigid, poses_seeded),
        }
        suffix = Renderer(cfg, dev, **mode).suffix
        for form, launch in (("repeats", "render_repeats"), ("batched", "render_batched")):
            mode_errs[launch + suffix] = pix_modes[name]["main_path"][form]["max_abs_err"]
            seeded_errs[launch + suffix] = pix_modes[name]["seeded_2cam"][form]["max_abs_err"]
    # K5c's setup pass alone: its packed table byte-equal to the plain
    # packing (the same operations, rounded as written).
    for key, p_in, errs_to in (("main_path", poses1, mode_errs),
                               ("seeded_2cam", poses_seeded, seeded_errs)):
        hoisted = Renderer(CONFIG1_EXACT if key == "main_path" else CONFIG2_EXACT, dev,
                           raster=True, hoist=True)
        table = torch.empty((*p_in.shape[:2], hoisted.setup_width), device=dev)
        hoisted.launch_pack(hoisted.kernel_params(scene), p_in.contiguous(), table)
        want = raycast.pack_setups(scene, hoisted.cam_meta, p_in)
        err = float((table - want).abs().max())
        if not torch.equal(table.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"pack_setups is not byte-equal to its plain version: {err}")
        errs_to["pack_setups"] = err
        pix_modes["raster_hoist"][key]["pack_setups_byte_equal"] = True
    emit("parity_modes", envs_main_path=NUM_ENVS, envs_seeded=PARITY_ENVS,
         pixel_bound={"level": PIX_LEVEL, "share": PIX_SHARE, "mean": PIX_MEAN},
         silhouette_rule={"share": SIL_SHARE, "edge_levels": SIL_EDGE}, modes=pix_modes)

    # 4c. Shapes the card had not run: K3/K4 at one sample per pooled pixel
    # (the 1cam_samples1 row's reset state and first step), K1/K2 at 8192
    # envs against the plain version on the CPU.
    venv_s1 = make_venv(CONFIG1_S1, NUM_ENVS)
    state_s1, obs_s1 = venv_s1.reset(gen1)
    with torch.no_grad():
        force_s1 = cartpole.action_to_force(CONFIG1_S1, actor1(obs_s1))
    _, poses_s1 = cuda_step.step_repeats(scene, state_s1.rigid, force_s1, spr, reps)
    slab_s1 = Renderer(CONFIG1_S1, dev)
    pix_s1 = {
        "render_repeats": pixel_check("render_repeats_p2_1", slab_s1.render_repeats(scene, poses_s1),
                                      slab_s1.plain(scene, poses_s1)),
        "render_batched": pixel_check(
            "render_batched_p2_1", slab_s1.render_batched(scene, state_s1.rigid),
            slab_s1.plain(scene, raycast.poses_from_rigid(state_s1.rigid)[None])[:, 0]),
    }
    phys_8k, _ = phys_parity(scene, *parity_inputs(scene, dev, OWED_PHYS_ENVS))
    phys_ragged, _ = phys_parity(scene, *parity_inputs(scene, dev, RAGGED_ENVS))
    # K3/K4 on poses chosen to break the slab kernel's cull: the eye inside a
    # slab, a pole lying flat, a cart at the frame's border, a pole tip at
    # the camera plane, anything anywhere (raycast.cull_probe_poses).
    probe = raycast.cull_probe_poses(PROBE_POSES, SEED).to(dev)
    pix_probe = {
        "render_repeats": pixel_check("render_repeats_probe", renderer.render_repeats(
            scene, probe[None]), renderer.plain(scene, probe[None])),
        "render_batched": pixel_check("render_batched_probe", renderer.render_batched(
            scene, probe_rigid(probe)), renderer.plain(scene, probe[None])[:, 0]),
    }
    other_errs = {
        "step_repeats": {f"{OWED_PHYS_ENVS}_envs": phys_8k["step_repeats"],
                         f"{RAGGED_ENVS}_envs": phys_ragged["step_repeats"]},
        "step_substeps": {f"{OWED_PHYS_ENVS}_envs": phys_8k["step_substeps"],
                          f"{RAGGED_ENVS}_envs": phys_ragged["step_substeps"]},
        **{k: {"p2_1": pix_s1[k]["max_abs_err"], "adversarial": pix_probe[k]["max_abs_err"]}
           for k in ("render_repeats", "render_batched")},
    }
    # The cull of K3/K4 and of K5b where it could fail, and frames too large
    # to stage 3 repeats of in shared memory (config 5 at 192 x 192:
    # straight to global memory; one camera unpooled at 124 x 124: one
    # repeat per block), on the probe's poses as 3 repeats.
    cull = {"seeded": slab_cull_checks(scene, CONFIG5, poses_seeded, "seeded"),
            "p2_1": slab_cull_checks(scene, CONFIG1_S1, poses_s1, "p2_1"),
            "adversarial": slab_cull_checks(scene, CONFIG5, probe[None], "adversarial")}
    probe3 = probe[: 3 * LARGE_FRAME_ENVS].reshape(3, LARGE_FRAME_ENVS, 16)
    large = {}
    for key, cfg in (("config5_192", CONFIG5_WIDE), ("1cam_unpooled_124", CONFIG1_UNPOOLED)):
        rnd = Renderer(cfg, dev)
        large[key] = dict(
            blocking=dict(zip(("reps", "staged"), slab_blocking(rnd.num_cams, rnd.n, 3))),
            render_repeats=pixel_check(f"render_repeats_{key}", rnd.render_repeats(scene, probe3),
                                       rnd.plain(scene, probe3)),
            cull=slab_cull_checks(scene, cfg, probe3, key))
        other_errs["render_repeats"][key] = large[key]["render_repeats"]["max_abs_err"]
    emit("parity_owed", physics_atol=PHYS_ATOL,
         one_cam_samples1=dict(envs=NUM_ENVS, p2=slab_s1.p2, n=slab_s1.n, **pix_s1),
         physics=dict(envs=OWED_PHYS_ENVS, step_substeps_max_abs_err=phys_8k["step_substeps"],
                      step_repeats_max_abs_err=phys_8k["step_repeats"]),
         physics_ragged=dict(envs=RAGGED_ENVS,
                             step_substeps_max_abs_err=phys_ragged["step_substeps"],
                             step_repeats_max_abs_err=phys_ragged["step_repeats"]),
         adversarial=dict(envs=PROBE_POSES, **pix_probe), cull=cull,
         large_frames=dict(envs=LARGE_FRAME_ENVS, **large))
    del venv_s1, state_s1, obs_s1

    # 4d. K5a's and K5d's cull where it could fail: the 1cam_exact row's
    # main-path poses, the seeded states seen by 2 cameras, the probe's
    # poses seen by 1 and by 2 cameras, and a frame over the shared memory
    # left for staging (2 cameras exact at 192 x 192, written straight to
    # global memory).
    raster_cull = {
        "main_path": raster_cull_check(scene, CONFIG1_EXACT, poses1, "main_path"),
        "seeded_2cam": raster_cull_check(scene, CONFIG2_EXACT, poses_seeded, "seeded_2cam"),
        "probe_1cam": raster_cull_check(scene, CONFIG1_EXACT, probe[None], "probe_1cam"),
        "probe_2cam": raster_cull_check(scene, CONFIG2_EXACT, probe[None], "probe_2cam"),
        "2cam_exact_192": raster_cull_check(scene, CONFIG2_EXACT_WIDE, probe3, "2cam_exact_192"),
    }
    wide = Renderer(CONFIG2_EXACT_WIDE, dev, raster=True)
    blocking = dict(zip(("reps", "staged"),
                        slab_blocking(wide.num_cams, wide.n, 3, RASTER_FRAME_BYTES)))
    if blocking["staged"]:
        raise AssertionError("2cam_exact_192: expected a frame too large to stage")
    emit("parity_raster_cull", envs_main_path=NUM_ENVS, envs_seeded=PARITY_ENVS,
         envs_probe=PROBE_POSES, envs_large=LARGE_FRAME_ENVS, large_blocking=blocking,
         sets=raster_cull)

    # 5. acting main path at config 5, full width
    with torch.no_grad():  # the actor's first call sets up cuBLAS: keep it out of the timing
        act(venv.reset(gen)[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    eval_rates, episodes = [], []
    for _ in range(EVAL_ROLLOUTS):
        t_eval = time.monotonic()
        mean_len, mean_rew = eval_rollout(venv, act, gen)
        episodes.append((float(mean_len), float(mean_rew)))
        eval_rates.append(NUM_ENVS * CONFIG5.max_episode_len / (time.monotonic() - t_eval))
    eval_rates.sort()
    with torch.no_grad():
        states, obs = venv.reset(gen)
        pool = (states, obs)
        done = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
        reward_sum = torch.zeros((NUM_ENVS,), device=dev)
        torch.cuda.synchronize()
        window_s = []
        for _ in range(SIM_ONLY_WINDOWS):
            t_sim = time.monotonic()
            for _ in range(SIM_ONLY_STEPS):
                obs_in = resolve_obs(done, pool[1], obs)
                states, obs, reward, done = venv.step_lazy(states, act(obs_in), reset_pool=pool)
                reward_sum += reward
            torch.cuda.synchronize()
            window_s.append(time.monotonic() - t_sim)
    sim_rates = sorted(NUM_ENVS * SIM_ONLY_STEPS / t for t in window_s)
    sim_rate = sim_rates[len(sim_rates) // 2]
    launches = dict(kernels.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    checks = {
        "launches_all_positive": all(launches[k] > 0 for k, _, _ in KERNELS[:4]),
        "other_render_mode_not_launched": all(
            v == 0 for k, v in launches.items()
            if k.startswith(("render", "pack")) and k not in ("render_repeats", "render_batched")),
        "finite": all(math.isfinite(v) for ep in episodes for v in ep)
        and bool(torch.isfinite(reward_sum).all())
        and all(bool(torch.isfinite(getattr(states.rigid, f)).all())
                for f in ("pos", "quat", "vel", "ang")),
        "episode_len_in_range": all(1.0 <= ep[0] <= CONFIG5.max_episode_len for ep in episodes),
        "obs_shape": tuple(obs.shape) == (NUM_ENVS,) + CONFIG5.pixel_obs_shape
        and obs.dtype == torch.uint8,
        "obs_not_blank": int(obs.max()) > int(obs.min()),
    }
    emit("main_path", envs=NUM_ENVS, eval_steps=CONFIG5.max_episode_len,
         eval_env_steps_per_s=eval_rates[len(eval_rates) // 2], eval_rollout_rates=eval_rates,
         sim_only_windows_s=window_s, sim_only_steps_per_window=SIM_ONLY_STEPS,
         sim_only_env_steps_per_s=sim_rate, sim_only_window_rates=sim_rates,
         sim_only_spread=(sim_rates[-1] - sim_rates[0]) / sim_rate,
         mean_episode_len=[ep[0] for ep in episodes],
         mean_episode_reward=[ep[1] for ep in episodes],
         sim_only_mean_reward=float(reward_sum.mean()) / (SIM_ONLY_WINDOWS * SIM_ONLY_STEPS),
         launches=launches,
         peak_mem_mib=peak_mib, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    launches_by_path = {"acting_2cam_samples2": launches}

    # 6. DDPG training at each row, full width, the bench's hyperparameters
    trained = {}
    for name, overrides, row_kernels in TRAIN_ROWS:
        line, trained[name] = train_row(bench_opts(num_envs=NUM_ENVS, **overrides), row_kernels)
        launches_by_path[f"train_{name}"] = line["launches"]
        emit(f"train_{name}", **line)

    # Poses from the end of the config-5 training row: its env states after
    # the timed windows, stepped once under the seeded actor.
    st5 = trained["2cam_samples2"]["state"]
    with torch.no_grad():
        force_te = cartpole.action_to_force(CONFIG5, act(st5.obs))
    _, poses_te = soa.step_repeats_batched(scene, st5.env_states.rigid, force_te, spr, reps)
    pix_te = pixel_check("render_repeats_training_end", renderer.render_repeats(scene, poses_te),
                         renderer.plain(scene, poses_te))
    cull["training_end"] = slab_cull_checks(scene, CONFIG5, poses_te, "training_end")
    other_errs["render_repeats"]["training_end"] = pix_te["max_abs_err"]
    # The raster cull on poses from the end of the 1cam_exact training row,
    # stepped once under its seeded actor.
    st1 = trained["1cam_exact"]["state"]
    with torch.no_grad():
        force_te1 = cartpole.action_to_force(CONFIG1_EXACT, actor1(st1.obs))
    _, poses_te1 = soa.step_repeats_batched(scene, st1.env_states.rigid, force_te1, spr, reps)
    raster_cull["training_end"] = raster_cull_check(scene, CONFIG1_EXACT, poses_te1,
                                                    "training_end")
    emit("parity_training_end", envs=NUM_ENVS, render_repeats=pix_te, cull=cull["training_end"],
         raster_cull=raster_cull["training_end"])

    # 7. one TD3 segment at the 1cam_exact row
    td3_opts = SimpleNamespace(seed=SEED, replay_capacity=REPLAY_CAPACITY, twin_critic=True)
    td3_state = ddpg.init_state(td3_opts, CONFIG1_EXACT, venv1)
    td3_segment = ddpg.make_segment(venv1, **TRAIN_HP, **TD3_HP)
    kernels.reset_launches()
    t_td3 = time.monotonic()
    td3 = {k: float(v) for k, v in td3_segment(td3_state).items()}
    td3_s = time.monotonic() - t_td3
    launches_by_path["td3_1cam_exact"] = dict(kernels.LAUNCHES)
    td3_checks = {
        "losses_finite": all(math.isfinite(td3[k]) for k in ("critic_loss", "actor_loss")),
        "updated": td3["updates"] > 0,
        "twin": isinstance(td3_state.critic, ddpg.TwinCritic),
    }
    emit("td3_1cam_exact", hyperparameters={**TRAIN_HP, **TD3_HP}, segment_s=td3_s,
         metrics=td3, launches=launches_by_path["td3_1cam_exact"], checks=td3_checks)
    if not all(td3_checks.values()):
        raise AssertionError(f"td3 checks failed: {td3_checks}")
    del td3_state, td3_segment

    # 7a. the low-dim path at 8192 envs (the bench's fourth row): K1's
    # frames and states byte-equal to K2 per repeat + observe_lowdim on the
    # main path's reset states under a seeded actor and on seeded states,
    # then a training row with the bench's hyperparameters.
    opts_ld = bench_opts(lowdim=True, num_envs=LOWDIM_ENVS)
    cfg_ld = benchmark.bench_config(opts_ld)
    venv_ld = make_venv(cfg_ld, LOWDIM_ENVS)
    actor_ld = Actor(cfg_ld.obs_shape, generator=torch.Generator().manual_seed(SEED))
    state_ld, obs_ld = venv_ld.reset(torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        force_ld = cartpole.action_to_force(cfg_ld, actor_ld(obs_ld))
    scene_ld = venv_ld.scene
    ld_parity = {
        "main_path": lowdim_parity(scene_ld, venv_ld, state_ld.rigid, force_ld, "main_path"),
        "seeded": lowdim_parity(scene_ld, venv_ld, *parity_inputs(scene_ld, dev, LOWDIM_ENVS),
                                "seeded"),
    }
    # K1 and K2 at the low-dim path's 8192 envs, launched on prepared
    # buffers as in the kernels line.
    packed = soa.pack_state(state_ld.rigid).contiguous()
    state_out, force_t = torch.empty_like(packed), force_ld.t().contiguous()
    poses_ld = torch.empty((cfg_ld.action_repeats, LOWDIM_ENVS, cuda_step.POSE_COLS),
                           device=dev)
    phys_p = cuda_step.phys_params(scene_ld)
    ld_ms = {
        "step_repeats": time_ms(lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, poses_ld, cfg_ld.action_repeats,
            cfg_ld.steps_per_repeat), reps=50),
        "step_substeps": time_ms(lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, None, 1, cfg_ld.initial_force_steps),
            reps=50),
    }
    line, trained["lowdim"] = train_row(opts_ld, _PHYS)
    launches_by_path["train_lowdim"] = line["launches"]
    emit("lowdim", parity=ld_parity, kernel_ms_8192_envs=ld_ms, **line)
    del state_ld, obs_ld

    # 7b. the card's element-op rate (K6): each chain against its plain
    # version, then timed at N and 2N iterations
    k6_errs, k6_moved = {}, {}
    for mix, (_, _, dtype) in roofline.CHAINS.items():
        x = roofline.varied(mix, roofline.SHAPE, dev)
        want = roofline.plain_chain(mix, x, K6_PARITY_ITERS, fused=True).float()
        err = float((roofline.run_chain(mix, x, K6_PARITY_ITERS).float() - want).abs().max())
        moved = float((want - x.float()).abs().max())
        if not err <= min(K6_ATOL[dtype], K6_MOVE_SHARE * moved):
            raise AssertionError(
                f"roofline {mix} disagrees with its plain version: {err} (plain moved {moved})")
        k6_errs[f"roofline_{mix}"], k6_moved[mix] = err, moved
    kernels.reset_launches()
    probe = {mix: roofline.measure_chain(mix) for mix in roofline.CHAINS}
    launches_by_path["roofline"] = dict(kernels.LAUNCHES)
    # fma_f32's chain must be FFMAs only (no FMUL/FADD pair, nothing folded);
    # checked where the toolkit has cuobjdump.
    fma_sass = sass_opcodes(kernels.build()["path"], "chain_f32_kernelILi0E")
    if fma_sass is None:
        print("chip_smoke: no cuobjdump; fma_f32's SASS is not checked", file=sys.stderr)
    elif not (fma_sass.get("FFMA", 0) > 0 and not fma_sass.get("FMUL") and not fma_sass.get("FADD")):
        raise AssertionError(f"fma_f32's chain is not FFMAs only: {fma_sass}")
    peak = {m: PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S
            for m, (_, _, dtype) in roofline.CHAINS.items()}
    emit("roofline", shape=roofline.SHAPE, iters=roofline.ITERS, card=smi,
         fma_f32_sass_opcodes=fma_sass, fma_f32_sass_checked=fma_sass is not None,
         parity_iters=K6_PARITY_ITERS, max_abs_err=k6_errs, plain_moved=k6_moved,
         chains=probe, peak_ops_per_s=peak,
         share_of_peak={m: v["el_ops_per_s"] / peak[m] for m, v in probe.items()},
         launches={k: v for k, v in launches_by_path["roofline"].items() if v})

    # 8. kernels at the main paths' shapes: parity, time, plain time, bound
    e = NUM_ENVS
    state0, obs0 = venv.reset(gen)
    rigid0 = state0.rigid
    with torch.no_grad():
        force0 = cartpole.action_to_force(CONFIG5, act(obs0))
    errs, pix = parity(scene, renderer, rigid0, force0)
    emit("parity_main_path", envs=NUM_ENVS, physics_atol=PHYS_ATOL,
         step_substeps_max_abs_err=errs["step_substeps"],
         step_repeats_max_abs_err=errs["step_repeats"], **pix)
    errs.update(raster_errs)
    errs.update(mode_errs)
    errs.update(k6_errs)
    _, poses0 = cuda_step.step_repeats(scene, rigid0, force0, spr, reps)
    cull["main_path"] = slab_cull_checks(scene, CONFIG5, poses0, "main_path")
    raster_main = raster_cull["main_path"]
    skipped_main = {"": cull["main_path"]["k3"]["skipped_cast_share"],
                    "_ratio": cull["main_path"]["k5b"]["skipped_cast_share"],
                    "_raster": raster_main["k5a"]["skipped_cast_share"],
                    "_raster_hoist": raster_main["k5c"]["skipped_cast_share"],
                    "_raster_mxu": raster_main["k5d"]["skipped_cast_share"]}
    # Every render kernel culls, so its work depends on the data: its bound
    # is the census of the work these inputs need (needed_plain), the
    # full-work census beside it.
    full_ops = {}
    # name → (wrapper call or None, plain version, bytes, operations or None
    # for the census of the plain version)
    work = {
        "step_repeats": (
            lambda: cuda_step.step_repeats(scene, rigid0, force0, spr, reps),
            lambda: soa.step_repeats_batched(scene, rigid0, force0, spr, reps),
            (26 + 3 + 26 + reps * 16) * 4 * e, None),
        "step_substeps": (
            lambda: cuda_step.step_substeps(scene, rigid0, force0, n_push),
            lambda: soa.step_substeps_batched(scene, rigid0, force0, n_push),
            (26 + 3 + 26) * 4 * e, None),
    }
    raw = raw_launches(scene, renderer, rigid0, force0, poses0, spr, n_push)
    # Each render mode at its main path's inputs: K3/K4 and K5b at config
    # 5's, K5a, K5c and K5d at the 1cam_exact row's (the hoisted raster
    # with its product is held in parity_modes only: no row runs it).
    renderers = [(renderer, rigid0, poses0), (raster1, rigid1, poses1)]
    for _, mode, cfg in MODES[:3]:
        renderers.append((Renderer(cfg, dev, **mode), *mode_inputs[cfg]))
    for rnd, rig, pos in renderers:
        suffix = rnd.suffix
        # K5c and K5d compute K5a's frames: their bound is K5a's census, not
        # that of K5d's product, five of whose eight K columns are zero.
        ops_rnd = raster1 if rnd.raster else rnd
        frame_bytes, ray_bytes = rnd.frame_width, rnd.planes.numel() * 4
        # The hoisted render kernel reads its setup table, not the poses,
        # and computes no setup; its setup pass is a row of its own.
        in_width = rnd.setup_width if rnd.hoist else 16
        pack_ops = lambda pos, rnd=rnd: census(
            lambda: raycast.pack_setups(scene, rnd.cam_meta, pos)) if rnd.hoist else 0
        pos_b = raycast.poses_from_rigid(rig)[None]
        full_ops["render_repeats" + suffix] = census(
            lambda rnd=ops_rnd, pos=pos: rnd.plain(scene, pos)) - pack_ops(pos)
        full_ops["render_batched" + suffix] = census(
            lambda rnd=ops_rnd, pos_b=pos_b: rnd.plain(scene, pos_b)) - pack_ops(pos_b)
        needed = needed_plain(scene, ops_rnd, pos), needed_plain(scene, ops_rnd, pos_b)
        for fn, p_in in zip(needed, (pos, pos_b)):
            if not torch.equal(fn(), ops_rnd.plain(scene, p_in)):
                raise AssertionError("needed_plain's frames differ from the plain version")
        ops_r, ops_b = census(needed[0]) - pack_ops(pos), census(needed[1]) - pack_ops(pos_b)
        work["render_repeats" + suffix] = (
            lambda rnd=rnd, pos=pos: rnd.render_repeats(scene, pos),
            lambda rnd=rnd, pos=pos: rnd.plain(scene, pos),
            reps * e * in_width * 4 + ray_bytes + e * reps * frame_bytes, ops_r)
        work["render_batched" + suffix] = (
            lambda rnd=rnd, rig=rig: rnd.render_batched(scene, rig),
            lambda rnd=rnd, pos_b=pos_b: rnd.plain(scene, pos_b),
            e * in_width * 4 + ray_bytes + e * frame_bytes, ops_b)
        if suffix:
            mode_raw = raw_launches(scene, rnd, rig, force0, pos, spr, n_push)
            raw.update({k + suffix: v for k, v in mode_raw.items() if k.startswith("render")})
        if rnd.hoist:
            raw["pack_setups"] = mode_raw["pack_setups"]
            one = pos[:1, :1].contiguous()
            one_table = torch.empty((1, 1, rnd.setup_width), device=dev)
            one_p = rnd.kernel_params(scene)
            raw["pack_setups_one"] = lambda rnd=rnd, one_p=one_p, one=one, t=one_table: (
                rnd.launch_pack(one_p, one, t))
            work["pack_setups"] = (
                None, lambda rnd=rnd, pos=pos: raycast.pack_setups(scene, rnd.cam_meta, pos),
                reps * e * (16 + rnd.setup_width) * 4, None)
    for mix, (_, ops_per, _) in roofline.CHAINS.items():
        x = roofline.initial(mix, roofline.SHAPE, dev)
        out = torch.empty_like(x)
        work[f"roofline_{mix}"] = (
            lambda mix=mix, x=x: roofline.run_chain(mix, x, K6_ROW_ITERS),
            lambda mix=mix, x=x: roofline.plain_chain(mix, x, K6_ROW_ITERS),
            2 * x.numel() * x.element_size(), ops_per * x.numel() * K6_ROW_ITERS)
        raw[f"roofline_{mix}"] = lambda mix=mix, x=x, out=out: roofline.launch(
            mix, x, out, K6_ROW_ITERS)
    total_launches = {name: sum(p.get(name, 0) for p in launches_by_path.values())
                      for name, _, _ in KERNELS}
    frames_te = torch.empty((e, reps, renderer.frame_width), dtype=torch.uint8, device=dev)
    render_p, poses_te = renderer.kernel_params(scene), poses_te.contiguous()
    k3_training_end_ms = time_ms(lambda: renderer.launch(render_p, poses_te, frames_te), reps=50)
    usage = ptxas_usage(info["log"])
    rows = []
    with torch.no_grad():
        for name, source, replaces in KERNELS:
            wrapper_fn, plain_fn, nbytes, ops = work[name]
            ops = census(plain_fn) if ops is None else ops
            peak_ops = peak.get(name.removeprefix("roofline_"), PEAK_F32_OPS_PER_S)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": total_launches[name],
                "launches_by_path": {p: v.get(name, 0) for p, v in launches_by_path.items()},
                "max_abs_err": errs[name],
                "seeded_max_abs_err": seeded_errs.get(name),
                "ms": time_ms(raw[name], reps=50),
                "device_ms": kernel_device_ms(raw[name]),
                "wrapper_ms": None if wrapper_fn is None else time_ms(wrapper_fn, reps=50),
                "plain_ms": time_ms(plain_fn, reps=PLAIN_REPS, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "census_ops": ops, "bytes": nbytes,
                **usage_of(usage, name),
            })
            if name in full_ops:
                rows[-1]["bound_ms_full_work"] = max(
                    t_bytes, full_ops[name] / PEAK_F32_OPS_PER_S * 1e3)
                rows[-1]["census_ops_full_work"] = full_ops[name]
                rows[-1]["skipped_cast_share"] = skipped_main[name.removeprefix(
                    "render_repeats").removeprefix("render_batched")]
            if name == "render_repeats":
                rows[-1]["ms_training_end"] = k3_training_end_ms
                rows[-1]["skipped_cast_share_training_end"] = (
                    cull["training_end"]["k3"]["skipped_cast_share"])
            if name in other_errs:
                rows[-1]["other_max_abs_err"] = other_errs[name]
            if name in ld_ms:
                rows[-1]["ms_lowdim_8192_envs"] = ld_ms[name]
            if name == "pack_setups":
                # The floor of a launch: the same kernel on one (repeat, env).
                rows[-1]["floor_ms"] = time_ms(raw["pack_setups_one"], reps=50)
                rows[-1]["floor_device_ms"] = kernel_device_ms(raw["pack_setups_one"])
    # Where a main-path step goes: the actor's forward at full width beside
    # the kernels' times and the measured wall time of a sim-only step.
    actor_ms = time_ms(lambda: act(obs0), reps=20)
    step_ms = 1e3 * NUM_ENVS / sim_rate
    emit("kernels_timed", card=smi, actor_forward_ms=actor_ms, sim_only_step_ms=step_ms)

    # 9. device time from torch.profiler traces: a few sim-only steps (the
    # card's busy share and the kernels that take it), then one training
    # segment per row of PROFILE_ROWS split into the port's kernels, the
    # learner and the rest.  Null where a trace holds no device time.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            obs_in = resolve_obs(done, pool[1], obs)
            states, obs, reward, done = venv.step_lazy(states, act(obs_in), reset_pool=pool)
        torch.cuda.synchronize()
    device_ms = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            device_ms[ev.key[:80]] = us / 1e3 / PROFILE_STEPS
    device_step_ms = sum(device_ms.values()) or None
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    training = {name: training_profile(t["state"], t["segment"], t["step_ms"])
                for name, t in trained.items() if name in PROFILE_ROWS}
    emit("profile", steps=PROFILE_STEPS, device_ms_per_step=device_step_ms,
         device_busy_share=device_step_ms and device_step_ms / step_ms,
         device_kernels=len(device_ms), top_device_ms_per_step=dict(top),
         training=training)

    # 10. the port's bench: bench_torch.py's suite (its main, in this
    # process), the four rows of the JAX bench, each in a child of its own.
    # The suite's own card probe (a child that only multiplies on the card) is
    # off: this script has found the card, and each row's timeout bounds a
    # lost one.
    budget = WATCHDOG_S - (time.monotonic() - t0) - BENCH_MARGIN_S
    row_timeout = min(BENCH_ROW_TIMEOUT_S, budget / len(benchmark.ROW_SPECS))
    argv = ["--row-timeout", f"{row_timeout:.1f}", "--row-attempts", "1", "--probe-timeout", "0",
            *(f"--{k.replace('_', '-')}={v}" for k, v in SMOKE_WINDOWS.items())]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = benchmark.main(argv)
    bench_rows, summary, bench_checks = bench_check(out.getvalue())
    bench_checks["exit_0"] = rc == 0
    emit("bench", argv=argv, rc=rc, rows=bench_rows,
         summary={k: v for k, v in summary.items() if k != "rows"}, checks=bench_checks)
    if not all(bench_checks.values()):
        raise AssertionError(f"bench checks failed: {bench_checks}\n{err.getvalue()[-4000:]}")

    # 11. the conv pixel encoder at the TD3 recipe's shape (25×25×18 NHWC →
    # 512 → (100, 50)) with the JAX checkpoint's weights, card against CPU
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        td3 = load_td3_checkpoint(root, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line, td3_actor = conv_check(td3, dev)
    emit("conv", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"conv checks failed: {line['checks']}")

    # 12. the cross-loaded TD3 policy's greedy eval on the card (K5a)
    line, launches_by_path["crossload_td3"] = crossload_eval(td3_actor, dev)
    emit("crossload", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"crossload checks failed: {line['checks']}")
    del td3, td3_actor

    # 13. the DDPG program: ddpg.main at config 5, full width (K1-K4), with
    # --tb-dir and --export-policy.  Each artifact's export is timed (the
    # first one imports torch._dynamo); the artifacts stay for phase 20b.
    art = {"dir": tempfile.mkdtemp(prefix="chip_smoke_export_")}
    dynamo_before = "torch._dynamo" in sys.modules
    export_s = []

    def timed_save(real):
        def save(*a, **kw):
            t = time.monotonic()
            out = real(*a, **kw)
            export_s.append(time.monotonic() - t)
            return out
        return save

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with patched(export, "save_policy", timed_save):
            line, launches_by_path["ddpg_cli"] = ddpg_cli(work, dev, art)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("ddpg_cli", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"ddpg_cli checks failed: {line['checks']}")
    ddpg_cli_segment_s = line["mean_segment_s"]

    # 14. the JAX config-5 SAC checkpoint's actor on the card and its greedy
    # eval (slab: K1-K4)
    line, launches_by_path["sac_crossload"] = sac_crossload(load_sac_actor(root), dev)
    emit("sac_crossload", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"sac_crossload checks failed: {line['checks']}")

    # 15. the SAC program: sac.main with the config-5 pixel recipe (K1-K4)
    work = tempfile.mkdtemp(prefix="chip_smoke_sac_")
    try:
        line, launches_by_path["sac_cli"] = sac_cli(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("sac_cli", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"sac_cli checks failed: {line['checks']}")

    # 16. prioritized replay and 3-step returns in DDPG at config 5 (K1-K4)
    line, launches_by_path["replay_ext"] = replay_ext(dev)
    emit("replay_ext", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"replay_ext checks failed: {line['checks']}")

    # 17-18. the on-policy programs: ppo.main and lrpg.main at config 5 (K1-K4)
    for name, drive in (("ppo_cli", ppo_cli), ("lrpg_cli", lrpg_cli)):
        work = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            line, launches_by_path[name] = drive(work, dev)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        emit(name, **line)
        if not all(line["checks"].values()):
            raise AssertionError(f"{name} checks failed: {line['checks']}")
    # 19. the JAX full Rainbow checkpoint's QNetwork on the card and its greedy
    # eval (low-dim: K1, K2)
    line, launches_by_path["dqn_crossload"] = dqn_crossload(load_dqn_q(root), dev)
    emit("dqn_crossload", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"dqn_crossload checks failed: {line['checks']}")

    # 20. the DQN program: dqn.main with the full Rainbow flags at config 5 (K1-K4)
    work = tempfile.mkdtemp(prefix="chip_smoke_dqn_")
    try:
        with patched(export, "save_policy", timed_save):
            line, launches_by_path["dqn_cli"] = dqn_cli(work, dev, art)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("dqn_cli", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"dqn_cli checks failed: {line['checks']}")

    # 20b. the serving artifacts of ddpg_cli and dqn_cli on the card and the CPU
    try:
        line, launches_by_path["export"] = export_check(art, dev)
    finally:
        shutil.rmtree(art["dir"], ignore_errors=True)
    emit("export", cli_export_s=export_s, dynamo_imported_before=dynamo_before, card=smi, **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"export checks failed: {line['checks']}")
    del art

    # 21. the NAF program: naf.main with batch norm at config 5 (K1-K4), and
    # three updates of its saved network card against CPU
    work = tempfile.mkdtemp(prefix="chip_smoke_naf_")
    try:
        line, launches_by_path["naf_cli"] = naf_cli(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("naf_cli", **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"naf_cli checks failed: {line['checks']}")

    # 22. the per-env surface: AoS physics card against CPU, the gym env at
    # config 5 (K3/K4 at E = 1), 1cam_exact (K5a) and low-dim, a fresh-reset
    # vector step, the random agent's event log
    # 23-24. per_env's random-agent log re-simulated by the fidelity harness on
    # the card and the CPU; the trajlog codec
    work = tempfile.mkdtemp(prefix="chip_smoke_per_env_")
    try:
        line, launches_by_path["per_env"] = per_env(work, dev)
        emit("per_env", **line)
        if not all(line["checks"].values()):
            raise AssertionError(f"per_env checks failed: {line['checks']}")
        one_env = line["one_env_launches"]
        line, launches_by_path["fidelity"] = fidelity_check(
            os.path.join(work, "random.events"), work, dev)
        emit("fidelity", card=smi, **line)
        if not all(line["checks"].values()):
            raise AssertionError(f"fidelity checks failed: {line['checks']}")
        kernels.reset_launches()
        line = native_check(work)
        launches_by_path["native"] = dict(kernels.LAUNCHES)
        line["checks"]["no_kernel_launches"] = not any(launches_by_path["native"].values())
        emit("native", **line)
        if not all(line["checks"].values()):
            raise AssertionError(f"native checks failed: {line['checks']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 25. data parallelism on the one card: two ranks over gloo (one
    # launcher, then two), a 1-rank NCCL group against the plain segment
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        line, launches_by_path["parallel"] = parallel_check(work, dev, ddpg_cli_segment_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("parallel", card=smi, **line)
    if not all(line["checks"].values()):
        raise AssertionError(f"parallel checks failed: {line['checks']}")
    for row in rows:
        row["launches_one_env"] = one_env.get(row["name"], 0)
        for path in ("crossload_td3", "ddpg_cli", "sac_crossload", "sac_cli", "replay_ext",
                     "ppo_cli", "lrpg_cli", "dqn_crossload", "dqn_cli", "export", "naf_cli",
                     "per_env", "fidelity", "native", "parallel"):
            n = launches_by_path[path].get(row["name"], 0)
            row["launches_by_path"][path] = n
            row["launches"] += n
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
