"""Cleaner: cooperative grid cleaning, implemented natively in JAX.

The reference wraps Jumanji's Cleaner (`mava/wrappers/jumanji.py:314-415`); this is our
own implementation of the task: a maze whose free tiles all start dirty, agents that
clean every tile they enter, team reward = newly cleaned tiles per step, win when the
grid is clean.

Maze: a pillar lattice (walls at odd/odd coordinates) — always connected, generated
without host-side search so reset stays cheap under the vmapped auto-reset (Jumanji
uses a host-side random maze generator instead; task structure is identical).
Agents all start at the top-left corner (as in Jumanji). Actions: 0=up, 1=right,
2=down, 3=left; moves into walls/out of bounds are masked.

Observation (the reference wrapper's 4-channel view, `jumanji.py:324-357`):
per agent (R, C, 4): [dirty, wall, all-agent positions, own position], float32.
Global state for CTDE: the first 3 channels (shared across agents).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_MOVES = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int32)
NUM_ACTIONS = 4


@struct.dataclass
class CleanerState:
    key: PRNGKey
    step_count: jnp.ndarray
    agent_pos: jnp.ndarray  # (A, 2)
    dirty: jnp.ndarray  # (R, C) bool


class Cleaner:
    def __init__(self, num_rows: int = 10, num_cols: int = 10, num_agents: int = 3,
                 time_limit: int = 100):
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_agents = num_agents
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS

        rows, cols = np.mgrid[0:num_rows, 0:num_cols]
        wall_np = (rows % 2 == 1) & (cols % 2 == 1)
        self._wall = jnp.asarray(wall_np)
        init_dirty = ~wall_np
        init_dirty[0, 0] = False  # start tile cleaned
        self._init_dirty = jnp.asarray(init_dirty)
        self._cell_iota = jnp.arange(num_rows * num_cols, dtype=jnp.int32)

    def _agent_onehot(self, agent_pos: jnp.ndarray) -> jnp.ndarray:
        """(A, R*C) one-hot occupancy from iota compares (no scatter)."""
        flat = agent_pos[:, 0] * self.num_cols + agent_pos[:, 1]
        return (self._cell_iota[None, :] == flat[:, None]).astype(jnp.float32)

    def _observe(self, state: CleanerState) -> Observation:
        a = self.num_agents
        onehot = self._agent_onehot(state.agent_pos)  # (A, RC)
        pos_grid = jnp.sum(onehot, axis=0).reshape(self.num_rows, self.num_cols)
        own = onehot.reshape(a, self.num_rows, self.num_cols)

        dirty = jnp.broadcast_to(
            state.dirty.astype(jnp.float32), (a, self.num_rows, self.num_cols)
        )
        wall = jnp.broadcast_to(
            self._wall.astype(jnp.float32), (a, self.num_rows, self.num_cols)
        )
        agents = jnp.broadcast_to(pos_grid, (a, self.num_rows, self.num_cols))
        view = jnp.stack([dirty, wall, agents, own], axis=-1)  # (A, R, C, 4)

        action_mask = self._action_mask(state)
        return Observation(view, action_mask, jnp.repeat(state.step_count, a))

    def _action_mask(self, state: CleanerState) -> jnp.ndarray:
        targets = state.agent_pos[:, None, :] + _MOVES_J[None, :, :]  # (A, 4, 2)
        in_bounds = (
            (targets[..., 0] >= 0)
            & (targets[..., 0] < self.num_rows)
            & (targets[..., 1] >= 0)
            & (targets[..., 1] < self.num_cols)
        )
        safe = jnp.clip(
            targets,
            0,
            jnp.array([self.num_rows - 1, self.num_cols - 1], dtype=jnp.int32),
        )
        not_wall = ~self._wall[safe[..., 0], safe[..., 1]]
        return in_bounds & not_wall

    def reset(self, key: PRNGKey) -> Tuple[CleanerState, TimeStep]:
        key, _ = jax.random.split(key)
        state = CleanerState(
            key=key,
            step_count=jnp.int32(0),
            agent_pos=jnp.zeros((self.num_agents, 2), dtype=jnp.int32),
            dirty=self._init_dirty,
        )
        obs = self._observe(state)
        extras = {"won_episode": jnp.bool_(False)}
        return state, restart(obs, extras, self.num_agents)

    def step(self, state: CleanerState, action: jnp.ndarray) -> Tuple[CleanerState, TimeStep]:
        action = jnp.clip(action.astype(jnp.int32), 0, NUM_ACTIONS - 1)
        targets = state.agent_pos + _MOVES_J[action]
        in_bounds = (
            (targets[:, 0] >= 0)
            & (targets[:, 0] < self.num_rows)
            & (targets[:, 1] >= 0)
            & (targets[:, 1] < self.num_cols)
        )
        safe = jnp.clip(
            targets,
            0,
            jnp.array([self.num_rows - 1, self.num_cols - 1], dtype=jnp.int32),
        )
        not_wall = ~self._wall[safe[:, 0], safe[:, 1]]
        valid = in_bounds & not_wall
        new_pos = jnp.where(valid[:, None], safe, state.agent_pos)

        # Clean every entered tile: compare-based occupancy instead of a scatter.
        occupied = (
            jnp.sum(self._agent_onehot(new_pos), axis=0)
            .reshape(self.num_rows, self.num_cols)
            > 0
        )
        dirty = state.dirty & ~occupied
        # Count uniquely cleaned tiles (two agents entering the same dirty tile = 1).
        num_cleaned = jnp.sum(state.dirty) - jnp.sum(dirty)
        team_reward = num_cleaned.astype(jnp.float32)
        reward = jnp.repeat(team_reward, self.num_agents)

        step_count = state.step_count + 1
        new_state = CleanerState(
            key=state.key, step_count=step_count, agent_pos=new_pos, dirty=dirty
        )
        obs = self._observe(new_state)
        all_clean = ~jnp.any(dirty)
        extras = {"won_episode": all_clean}
        # Fused timestep: all_clean -> termination (discount 0), time_up -> truncation.
        time_up = step_count >= self.time_limit
        done = all_clean | time_up
        timestep = TimeStep(
            step_type=jnp.where(
                done, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(all_clean, 0.0, 1.0)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras=extras,
        )
        return new_state, timestep

    def get_global_state(self, obs: Observation, state: CleanerState) -> jnp.ndarray:
        return obs.agents_view[..., :3]

    def global_state_spec(self) -> specs.Array:
        return specs.Array(
            (self.num_agents, self.num_rows, self.num_cols, 3),
            jnp.float32,
            "global_state",
        )

    def observation_spec(self) -> specs.TreeSpec:
        return specs.TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=specs.Array(
                (self.num_agents, self.num_rows, self.num_cols, 4),
                jnp.float32,
                "agents_view",
            ),
            action_mask=specs.Array(
                (self.num_agents, NUM_ACTIONS), jnp.bool_, "action_mask"
            ),
            step_count=specs.BoundedArray(
                (self.num_agents,), jnp.int32, "step_count", minimum=0,
                maximum=self.time_limit,
            ),
        )

    def action_spec(self) -> specs.DiscreteArray:
        return specs.DiscreteArray(
            (self.num_agents,), jnp.int32, "action", num_values=NUM_ACTIONS
        )

    def reward_spec(self) -> specs.Array:
        return specs.Array((self.num_agents,), jnp.float32, "reward")

    @property
    def unwrapped(self) -> "Cleaner":
        return self


_MOVES_J = jnp.asarray(_MOVES)
