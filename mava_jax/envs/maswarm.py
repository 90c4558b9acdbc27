"""MaSwarm: continuous-action multi-agent particle control, implemented natively in JAX.

The reference's continuous-control suite is MaBrax (MuJoCo-MJX via JaxMARL,
`mava/wrappers/jaxmarl.py:376-405`); brax/mujoco are not available in this image, so
this framework ships its own continuous suite with MPE-style point-mass physics
(the standard open benchmark shape for cooperative continuous MARL):

  * `spread`: N agents must cover N landmarks. Team reward = -sum over landmarks of the
    distance to the closest agent, with a -1 penalty per colliding agent pair;
  * actions: per-agent 2-D acceleration in [-1, 1] (matches the tanh action head);
  * physics: velocity damping 0.25, dt 0.1, force scale 5, speed clip 1.3 (MPE values);
  * observation per agent: [own vel(2), own pos(2), rel landmark pos (2L),
    rel other-agent pos (2(A-1))];
  * action_mask is all-ones (continuous heads ignore it; kept for API uniformity);
  * episodes are fixed-length (truncation at time_limit) — like MPE/SAC benchmarks.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_DT = 0.1
_DAMPING = 0.25
_FORCE_SCALE = 5.0
_MAX_SPEED = 1.3
_COLLIDE_DIST = 0.15
_ARENA = 1.0  # landmarks/agents spawn in [-1, 1]^2


@struct.dataclass
class MaSwarmState:
    key: PRNGKey
    step_count: jnp.ndarray
    pos: jnp.ndarray  # (A, 2)
    vel: jnp.ndarray  # (A, 2)
    landmarks: jnp.ndarray  # (L, 2)


class MaSwarm:
    def __init__(
        self,
        num_agents: int = 3,
        num_landmarks: int | None = None,
        time_limit: int = 100,
    ):
        self.num_agents = num_agents
        self.num_landmarks = num_landmarks or num_agents
        self.time_limit = time_limit
        self.action_dim = 2
        self.num_obs_features = 4 + 2 * self.num_landmarks + 2 * (num_agents - 1)

    def _observe(self, state: MaSwarmState) -> Observation:
        a = self.num_agents
        rel_land = state.landmarks[None, :, :] - state.pos[:, None, :]  # (A, L, 2)
        rel_agents = state.pos[None, :, :] - state.pos[:, None, :]  # (A, A, 2)
        # Drop self (zeros on the diagonal): roll rows so self is first, cut it.
        idx = (jnp.arange(a)[None, :] + jnp.arange(a)[:, None]) % a
        rel_agents = jnp.take_along_axis(rel_agents, idx[..., None], axis=1)[:, 1:]

        agents_view = jnp.concatenate(
            [
                state.vel,
                state.pos,
                rel_land.reshape(a, -1),
                rel_agents.reshape(a, -1),
            ],
            axis=-1,
        ).astype(jnp.float32)
        mask = jnp.ones((a, self.action_dim), dtype=jnp.bool_)
        return Observation(agents_view, mask, jnp.repeat(state.step_count, a))

    def _reward(self, state: MaSwarmState) -> jnp.ndarray:
        dists = jnp.linalg.norm(
            state.landmarks[:, None, :] - state.pos[None, :, :], axis=-1
        )  # (L, A)
        cover = -jnp.sum(jnp.min(dists, axis=1))
        agent_dists = jnp.linalg.norm(
            state.pos[:, None, :] - state.pos[None, :, :], axis=-1
        )
        colliding = (agent_dists < _COLLIDE_DIST) & ~jnp.eye(
            self.num_agents, dtype=jnp.bool_
        )
        penalty = -jnp.sum(colliding) / 2.0
        team = (cover + penalty).astype(jnp.float32)
        return jnp.repeat(team, self.num_agents)

    def reset(self, key: PRNGKey) -> Tuple[MaSwarmState, TimeStep]:
        key, pos_key, land_key = jax.random.split(key, 3)
        pos = jax.random.uniform(
            pos_key, (self.num_agents, 2), minval=-_ARENA, maxval=_ARENA
        )
        landmarks = jax.random.uniform(
            land_key, (self.num_landmarks, 2), minval=-_ARENA, maxval=_ARENA
        )
        state = MaSwarmState(
            key=key,
            step_count=jnp.int32(0),
            pos=pos,
            vel=jnp.zeros((self.num_agents, 2)),
            landmarks=landmarks,
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: MaSwarmState, action: jnp.ndarray
    ) -> Tuple[MaSwarmState, TimeStep]:
        action = jnp.clip(action, -1.0, 1.0)
        vel = state.vel * (1.0 - _DAMPING) + action * _FORCE_SCALE * _DT
        speed = jnp.linalg.norm(vel, axis=-1, keepdims=True)
        vel = jnp.where(speed > _MAX_SPEED, vel / speed * _MAX_SPEED, vel)
        pos = jnp.clip(state.pos + vel * _DT, -3.0, 3.0)

        step_count = state.step_count + 1
        new_state = MaSwarmState(
            key=state.key,
            step_count=step_count,
            pos=pos,
            vel=vel,
            landmarks=state.landmarks,
        )
        reward = self._reward(new_state)
        obs = self._observe(new_state)
        # Fused timestep: time_up -> truncation (LAST, discount stays 1).
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=jnp.where(
                time_up, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras={},
        )
        return new_state, timestep

    def observation_spec(self) -> specs.TreeSpec:
        return specs.TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=specs.Array(
                (self.num_agents, self.num_obs_features), jnp.float32, "agents_view"
            ),
            action_mask=specs.Array(
                (self.num_agents, self.action_dim), jnp.bool_, "action_mask"
            ),
            step_count=specs.BoundedArray(
                (self.num_agents,),
                jnp.int32,
                "step_count",
                minimum=0,
                maximum=self.time_limit,
            ),
        )

    def action_spec(self) -> specs.BoundedArray:
        return specs.BoundedArray(
            (self.num_agents, self.action_dim),
            jnp.float32,
            "action",
            minimum=-1.0,
            maximum=1.0,
        )

    def reward_spec(self) -> specs.Array:
        return specs.Array((self.num_agents,), jnp.float32, "reward")

    @property
    def unwrapped(self) -> "MaSwarm":
        return self
