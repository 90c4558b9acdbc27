"""MaWalker: multi-agent planar biped — walker2d_2x3 of the MaBrax suite.

The reference's MaBrax scenario list is [ant_4x2, halfcheetah_6x1, hopper_3x1,
humanoid_9|8, walker2d_2x3] (`mava/configs/env/mabrax.yaml:7`); with MaHopper
and MaCheetah this covers the three PLANAR robots natively (the 3D ant is
`maant.py`'s point-cloud Lagrangian engine — see docs/environments.md).

The walker is the same kinematic-tree machinery as `macheetah.py` with a biped
body: a vertical torso whose bottom end carries TWO identical three-link legs
(thigh/shin/foot), six joints split one LEG per agent (walker2d_2x3: agent 0 =
right leg, agent 1 = left leg). Knee limits only bend backward; foot limits
keep the feet near flat — the standing pose can brace, but balance is unstable
and must be learned.

Task (MuJoCo Walker2d-v4 semantics): shared reward = forward velocity
+ healthy bonus - 1e-3 * ctrl; TERMINATES (discount 0) when the torso drops or
pitches past the healthy range.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mava_jax.envs.macheetah import MaCheetah

# link: (name, parent, anchor fraction on parent, length, rest angle offset)
# Torso points DOWN from the base (TORSO_REST = -pi/2); both legs hang from its
# bottom end, continuing straight down at rest; feet fold +pi/2 to lie flat.
_WALKER_TOPOLOGY = (
    ("torso", -1, 0.0, 0.40, 0.0),
    ("rthigh", 0, 1.0, 0.45, 0.0),
    ("rshin", 1, 1.0, 0.50, 0.0),
    ("rfoot", 2, 1.0, 0.20, np.pi / 2),
    ("lthigh", 0, 1.0, 0.45, 0.0),
    ("lshin", 4, 1.0, 0.50, 0.0),
    ("lfoot", 5, 1.0, 0.20, np.pi / 2),
)


class MaWalker(MaCheetah):
    """Planar biped (vertical torso + 2 legs), one leg per agent."""

    TOPOLOGY = _WALKER_TOPOLOGY
    # thigh swings mostly forward, knee bends backward only, foot stays near flat
    JOINT_LO = (-1.0, -2.0, -0.6, -1.0, -2.0, -0.6)
    JOINT_HI = (1.0, 0.05, 0.6, 1.0, 0.05, 0.6)
    DEFAULT_TORQUE = 30.0
    CTRL_COST = 1e-3
    HEALTHY_BONUS = 1.0
    TORSO_REST = -np.pi / 2

    def __init__(
        self,
        num_agents: int = 2,
        joints_per_agent: int = 3,
        time_limit: int = 250,
        min_torso_height: float = 0.75,
        max_pitch: float = 0.8,
        **kwargs,
    ):
        super().__init__(num_agents, joints_per_agent, time_limit, **kwargs)
        self.min_torso_height = float(min_torso_height)
        self.max_pitch = float(max_pitch)

    def _terminated(self, q: jnp.ndarray) -> jnp.ndarray:
        torso_y = self._body_frame(q)[0][0, 1]
        pitch = jnp.arctan2(
            jnp.sin(q[2] - self.TORSO_REST), jnp.cos(q[2] - self.TORSO_REST)
        )
        return (torso_y < self.min_torso_height) | (jnp.abs(pitch) > self.max_pitch)

    @property
    def unwrapped(self) -> "MaWalker":
        return self
