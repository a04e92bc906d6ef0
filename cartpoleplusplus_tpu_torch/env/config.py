"""Environment configuration: a copy of cartpoleplusplus_tpu.env.config.

Kept as a copy rather than an import because the JAX package's ``env``
package imports jax.  Field defaults and checks are identical, and so are
the argparse helpers (``add_opts``: the JAX flags, defaults and choices).
"""

from __future__ import annotations

import argparse
import dataclasses

# Reward calculation modes (reference: --reward-calc).
REWARD_FIXED = "fixed"  # +1 per surviving step
REWARD_ANGLE = "angle"  # reward ∝ pole uprightness
REWARD_ACTION = "action"  # +1 minus action-magnitude penalty
REWARD_ANGLE_ACTION = "angle_action"  # both
REWARD_CALCS = (REWARD_FIXED, REWARD_ANGLE, REWARD_ACTION, REWARD_ANGLE_ACTION)

# Discrete action table: index → (fx, fy) direction, scaled by action_force.
DISCRETE_ACTIONS = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))
NUM_DISCRETE_ACTIONS = len(DISCRETE_ACTIONS)


@dataclasses.dataclass(frozen=True)
class CartpoleConfig:
    """Static env parameters (see the JAX package's CartpoleConfig for the
    field ↔ reference-flag map)."""

    discrete_actions: bool = True
    action_force: float = 50.0
    initial_force: float = 55.0
    initial_force_steps: int = 30
    action_repeats: int = 3
    steps_per_repeat: int = 5
    max_episode_len: int = 200
    random_theta_jitter: float = 0.01  # pole pose jitter at reset (rad)
    pos_threshold: float = 2.0
    angle_threshold: float = 0.3  # rad, on pole roll/pitch
    reward_calc: str = REWARD_FIXED
    use_raw_pixels: bool = False
    render_width: int = 50
    render_height: int = 50
    num_cameras: int = 1
    # k×k average-pool of each rendered frame inside the render epilogue.
    obs_pool: int = 1
    # Sub-pixel samples shaded per pooled obs pixel (0 = all obs_pool²).
    obs_samples: int = 0
    dt: float = 1.0 / 240.0
    solver_iterations: int = 3

    def __post_init__(self):
        if self.reward_calc not in REWARD_CALCS:
            raise ValueError(
                f"reward_calc must be one of {REWARD_CALCS}, got {self.reward_calc!r}"
            )
        if self.num_cameras not in (1, 2):
            raise ValueError("num_cameras must be 1 or 2")
        if self.obs_pool < 1 or (
            self.render_height % self.obs_pool
            or self.render_width % self.obs_pool
        ):
            raise ValueError(
                f"obs_pool {self.obs_pool} must divide "
                f"{self.render_height}x{self.render_width}"
            )
        if self.obs_samples < 0 or self.obs_samples > self.obs_pool**2:
            raise ValueError(
                f"obs_samples {self.obs_samples} must be in "
                f"[0, obs_pool²={self.obs_pool ** 2}]"
            )

    @property
    def lowdim_obs_shape(self) -> tuple[int, int, int]:
        """(repeats, 2 bodies, 7 pose dims)."""
        return (self.action_repeats, 2, 7)

    @property
    def obs_height(self) -> int:
        """Height of the frames the pipeline carries (post obs_pool)."""
        return self.render_height // self.obs_pool

    @property
    def obs_width(self) -> int:
        return self.render_width // self.obs_pool

    @property
    def pixel_obs_shape(self) -> tuple[int, int]:
        """(repeats, cameras·H'·W'·3) flat plane-major RGB frames."""
        return (
            self.action_repeats,
            self.num_cameras * self.obs_height * self.obs_width * 3,
        )

    @property
    def obs_shape(self):
        return self.pixel_obs_shape if self.use_raw_pixels else self.lowdim_obs_shape

    @property
    def num_actions(self) -> int:
        return NUM_DISCRETE_ACTIONS if self.discrete_actions else 2


def add_opts(parser: argparse.ArgumentParser) -> None:
    """Register the env flags (the JAX ``add_opts``: same names, defaults
    and choices)."""
    parser.add_argument("--action-force", type=float, default=50.0,
                        help="magnitude of cart push force (N)")
    parser.add_argument("--initial-force", type=float, default=55.0,
                        help="magnitude of random push at reset (N)")
    parser.add_argument("--action-repeats", type=int, default=3,
                        help="observation frames captured per env step")
    parser.add_argument("--steps-per-repeat", type=int, default=5,
                        help="physics substeps per observation frame")
    parser.add_argument("--max-episode-len", type=int, default=200,
                        help="episode step cap")
    parser.add_argument("--reward-calc", type=str, default=REWARD_FIXED,
                        choices=list(REWARD_CALCS))
    parser.add_argument("--use-raw-pixels", action="store_true",
                        help="observe camera renders instead of poses")
    parser.add_argument("--render-width", type=int, default=50)
    parser.add_argument("--render-height", type=int, default=50)
    parser.add_argument("--num-cameras", type=int, default=1, choices=[1, 2])
    parser.add_argument("--obs-pool", type=int, default=1,
                        help="k×k average-pool rendered frames inside the render "
                             "kernel; observations, replay and policy input carry "
                             "the pooled frames")
    parser.add_argument("--obs-samples", type=int, default=0,
                        help="sub-pixel samples shaded per pooled obs pixel "
                             "(0 = all obs-pool², the exact average; 2 = "
                             "quincunx; 1 = point sample)")
    parser.add_argument("--pos-threshold", type=float, default=2.0)
    parser.add_argument("--angle-threshold", type=float, default=0.3)
    parser.add_argument("--solver-iters", type=int, default=3,
                        help="Jacobi contact-solver iterations per physics substep")


def config_from_opts(opts: argparse.Namespace, discrete_actions: bool) -> CartpoleConfig:
    """Build a CartpoleConfig from parsed args (the JAX ``config_from_opts``)."""
    return CartpoleConfig(
        discrete_actions=discrete_actions,
        action_force=opts.action_force,
        initial_force=opts.initial_force,
        action_repeats=opts.action_repeats,
        steps_per_repeat=opts.steps_per_repeat,
        max_episode_len=opts.max_episode_len,
        reward_calc=opts.reward_calc,
        use_raw_pixels=opts.use_raw_pixels,
        render_width=opts.render_width,
        render_height=opts.render_height,
        num_cameras=opts.num_cameras,
        obs_pool=getattr(opts, "obs_pool", 1),
        obs_samples=getattr(opts, "obs_samples", 0),
        pos_threshold=opts.pos_threshold,
        angle_threshold=opts.angle_threshold,
        solver_iterations=getattr(opts, "solver_iters", 3),
    )
