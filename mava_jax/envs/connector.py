"""MaConnector: cooperative wire routing, implemented natively in JAX.

The reference wraps Jumanji's MaConnector (`mava/wrappers/jumanji.py:218-311`). Task:
each agent must walk its head from a random start to its own target, leaving an
impassable path trail behind; the episode is won when every agent has connected.

Dynamics:
  * actions: 0=noop, 1=up, 2=right, 3=down, 4=left;
  * a move is legal iff the target cell is in bounds and not occupied by any path,
    any agent head, or another agent's target; two heads proposing the same cell both
    stay; connected agents stop (noop-only mask);
  * per-agent reward: +1.0 on connecting, -0.03 per step while unconnected (Jumanji's
    dense default); the reference wrapper team-sums rewards — done here directly;
  * extras["won_episode"] = all agents connected.

Observation is the reference wrapper's 5-channel view (`jumanji.py:232-247`):
(A, G, G, 5): [all heads (id-normalised), all targets (id-normalised), paths,
own head, own target]; global state = first 3 channels (shared).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_MOVES = np.array(
    [[0, 0], [-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int32
)  # noop, up, right, down, left
NUM_ACTIONS = 5


@struct.dataclass
class ConnectorState:
    key: PRNGKey
    step_count: jnp.ndarray
    head_pos: jnp.ndarray  # (A, 2)
    target_pos: jnp.ndarray  # (A, 2)
    paths: jnp.ndarray  # (G, G) bool — trail cells (all agents)
    connected: jnp.ndarray  # (A,) bool


class MaConnector:
    def __init__(self, grid_size: int = 10, num_agents: int = 5, time_limit: int = 50):
        self.grid_size = grid_size
        self.num_agents = num_agents
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        self._cell_iota = jnp.arange(grid_size * grid_size, dtype=jnp.int32)

    # ------------------------------------------------------------------ helpers
    def _flat(self, pos: jnp.ndarray) -> jnp.ndarray:
        return pos[..., 0] * self.grid_size + pos[..., 1]

    def _onehot(self, pos: jnp.ndarray) -> jnp.ndarray:
        """(A, G*G) one-hot occupancy from iota compares (no scatter)."""
        return (self._cell_iota[None, :] == self._flat(pos)[:, None]).astype(
            jnp.float32
        )

    def _blocked_at(self, state: ConnectorState, query: jnp.ndarray) -> jnp.ndarray:
        """query (A, Q, 2): per-agent candidate cells -> (A, Q) bool blocked.
        Blocked by any path, any head, or another agent's target — computed with
        compares against the entity tables (the only gather is the path bitmap)."""
        flat_q = self._flat(query)  # (A, Q)
        path_hit = state.paths.reshape(-1)[flat_q]
        head_hit = jnp.any(
            flat_q[..., None] == self._flat(state.head_pos)[None, None, :], axis=-1
        )
        tgt_eq = flat_q[..., None] == self._flat(state.target_pos)[None, None, :]
        not_own = ~jnp.eye(self.num_agents, dtype=jnp.bool_)[:, None, :]  # (A, 1, A)
        other_tgt_hit = jnp.any(tgt_eq & not_own, axis=-1)
        return path_hit | head_hit | other_tgt_hit

    def _action_mask(self, state: ConnectorState) -> jnp.ndarray:
        targets = state.head_pos[:, None, :] + _MOVES_J[None, 1:, :]  # (A, 4, 2)
        in_bounds = jnp.all(
            (targets >= 0) & (targets < self.grid_size), axis=-1
        )
        safe = jnp.clip(targets, 0, self.grid_size - 1)
        free = ~self._blocked_at(state, safe)
        move_ok = in_bounds & free & ~state.connected[:, None]
        ones = jnp.ones((self.num_agents, 1), dtype=jnp.bool_)
        return jnp.concatenate([ones, move_ok], axis=-1)

    def _observe(self, state: ConnectorState) -> Observation:
        a, g = self.num_agents, self.grid_size
        ids = (jnp.arange(a, dtype=jnp.float32) + 1.0) / a

        head_onehot = self._onehot(state.head_pos)  # (A, GG)
        target_onehot = self._onehot(state.target_pos)  # (A, GG)
        heads = jnp.einsum("ac,a->c", head_onehot, ids).reshape(g, g)
        targets = jnp.einsum("ac,a->c", target_onehot, ids).reshape(g, g)
        paths = state.paths.astype(jnp.float32)

        own_head = head_onehot.reshape(a, g, g)
        own_target = target_onehot.reshape(a, g, g)

        view = jnp.stack(
            [
                jnp.broadcast_to(heads, (a, g, g)),
                jnp.broadcast_to(targets, (a, g, g)),
                jnp.broadcast_to(paths, (a, g, g)),
                own_head,
                own_target,
            ],
            axis=-1,
        )  # (A, G, G, 5)
        return Observation(
            view, self._action_mask(state), jnp.repeat(state.step_count, a)
        )

    # ------------------------------------------------------------------ API
    def reset(self, key: PRNGKey) -> Tuple[ConnectorState, TimeStep]:
        key, cells_key = jax.random.split(key)
        # Distinct uniform cells via top-k over iid uniforms (cheaper than
        # random.choice(replace=False)'s argsort; runs per step under AutoReset).
        n_cells = self.grid_size * self.grid_size
        _, cells = jax.lax.top_k(
            jax.random.uniform(cells_key, (n_cells,)), 2 * self.num_agents
        )
        coords = jnp.stack(
            [cells // self.grid_size, cells % self.grid_size], axis=-1
        ).astype(jnp.int32)
        state = ConnectorState(
            key=key,
            step_count=jnp.int32(0),
            head_pos=coords[: self.num_agents],
            target_pos=coords[self.num_agents :],
            paths=jnp.zeros((self.grid_size, self.grid_size), dtype=jnp.bool_),
            connected=jnp.zeros(self.num_agents, dtype=jnp.bool_),
        )
        obs = self._observe(state)
        extras = {"won_episode": jnp.bool_(False)}
        return state, restart(obs, extras, self.num_agents)

    def step(
        self, state: ConnectorState, action: jnp.ndarray
    ) -> Tuple[ConnectorState, TimeStep]:
        action = jnp.clip(action.astype(jnp.int32), 0, NUM_ACTIONS - 1)

        proposed = state.head_pos + _MOVES_J[action]
        in_bounds = jnp.all(
            (proposed >= 0) & (proposed < self.grid_size), axis=-1
        )
        safe = jnp.clip(proposed, 0, self.grid_size - 1)
        free = ~self._blocked_at(state, safe[:, None, :])[:, 0]
        moving = (action != 0) & in_bounds & free & ~state.connected
        new_pos = jnp.where(moving[:, None], safe, state.head_pos)

        # Same-cell conflicts: both stay.
        flat = new_pos[:, 0] * self.grid_size + new_pos[:, 1]
        clash = (flat[:, None] == flat[None, :]) & ~jnp.eye(
            self.num_agents, dtype=jnp.bool_
        )
        has_clash = jnp.any(clash, axis=-1) & moving
        moving = moving & ~has_clash
        new_pos = jnp.where(moving[:, None], new_pos, state.head_pos)

        # Old head becomes path for agents that moved — compare-based, no scatter.
        old_head_hit = (
            self._cell_iota[None, :] == self._flat(state.head_pos)[:, None]
        ) & moving[:, None]  # (A, GG)
        paths = state.paths | jnp.any(old_head_hit, axis=0).reshape(
            self.grid_size, self.grid_size
        )

        newly_connected = (
            jnp.all(new_pos == state.target_pos, axis=-1) & ~state.connected
        )
        connected = state.connected | newly_connected

        per_agent_reward = (
            newly_connected.astype(jnp.float32)
            - 0.03 * (~connected).astype(jnp.float32)
        )
        team_reward = jnp.sum(per_agent_reward)
        reward = jnp.repeat(team_reward, self.num_agents)

        step_count = state.step_count + 1
        new_state = ConnectorState(
            key=state.key,
            step_count=step_count,
            head_pos=new_pos,
            target_pos=state.target_pos,
            paths=paths,
            connected=connected,
        )
        obs = self._observe(new_state)
        all_connected = jnp.all(connected)
        extras = {"won_episode": all_connected}
        # Fused timestep: all_connected -> termination (discount 0), else truncation.
        time_up = step_count >= self.time_limit
        done = all_connected | time_up
        timestep = TimeStep(
            step_type=jnp.where(
                done, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(all_connected, 0.0, 1.0)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras=extras,
        )
        return new_state, timestep

    def get_global_state(self, obs: Observation, state: ConnectorState) -> jnp.ndarray:
        return obs.agents_view[..., :3]

    def global_state_spec(self) -> specs.Array:
        return specs.Array(
            (self.num_agents, self.grid_size, self.grid_size, 3),
            jnp.float32,
            "global_state",
        )

    def observation_spec(self) -> specs.TreeSpec:
        return specs.TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=specs.Array(
                (self.num_agents, self.grid_size, self.grid_size, 5),
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
    def unwrapped(self) -> "MaConnector":
        return self


_MOVES_J = jnp.asarray(_MOVES)
