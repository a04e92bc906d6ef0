"""Environment configuration: a copy of cartpoleplusplus_tpu.env.config.

Kept as a copy rather than an import because the JAX package's ``env``
package imports jax.  Field defaults and checks are identical; the argparse
helpers are not ported yet.
"""

from __future__ import annotations

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
