"""Level-Based Foraging (LBF), implemented natively in JAX.

The reference wraps Jumanji's LevelBasedForaging (`mava/wrappers/jumanji.py:158-215`);
the env itself is reimplemented here from the published LBF rules with Jumanji's
parameterisation (grid_size, fov, num_agents, num_food, max_agent_level, force_coop):

  * agents and foods live on a grid; agent levels ~ U{1..max_agent_level}; food level =
    sum of all agent levels when `force_coop`, else U{1..sum of the three highest
    agent levels};
  * actions: 0=noop, 1=up, 2=down, 3=left, 4=right, 5=load. Moves into occupied cells
    (food or agent) are invalid; two agents targeting the same cell both stay;
  * a food is eaten when the summed level of orthogonally-adjacent LOADING agents
    reaches its level; each participant is rewarded
    food_level * agent_level / (adjacent_level_sum * total_initial_food_levels), so the
    per-episode team total is at most 1 (the original LBF normalisation);
  * team-reward aggregation (sum repeated per agent) happens here when
    `use_individual_rewards=False` — the reference applies it in `LbfWrapper`;
  * observation per agent (vector observer): (y, x, level) triplets for every food then
    every agent (self first), with -1 for out-of-view entries; float32;
  * episode ends when all food is eaten (termination) or at time_limit (truncation).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

NOOP, UP, DOWN, LEFT, RIGHT, LOAD = 0, 1, 2, 3, 4, 5
NUM_ACTIONS = 6
# Row/col deltas for actions 1..4.
_MOVES = np.array([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]], dtype=np.int32)
_ADJ = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.int32)


@struct.dataclass
class LbfState:
    key: PRNGKey
    step_count: jnp.ndarray
    agent_pos: jnp.ndarray  # (A, 2)
    agent_level: jnp.ndarray  # (A,)
    food_pos: jnp.ndarray  # (F, 2)
    food_level: jnp.ndarray  # (F,)
    food_eaten: jnp.ndarray  # (F,) bool
    total_food_level: jnp.ndarray  # () float32 — normaliser fixed at reset


class LevelBasedForaging:
    def __init__(
        self,
        grid_size: int = 8,
        fov: int = 8,
        num_agents: int = 2,
        num_food: int = 2,
        max_agent_level: int = 2,
        force_coop: bool = False,
        use_individual_rewards: bool = False,
        time_limit: int = 100,
    ):
        self.grid_size = grid_size
        self.fov = fov
        self.num_agents = num_agents
        self.num_food = num_food
        self.max_agent_level = max_agent_level
        self.force_coop = force_coop
        self.use_individual_rewards = use_individual_rewards
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        self.num_obs_features = 3 * num_food + 3 * num_agents

    # ------------------------------------------------------------------ helpers
    def _blocked_at(self, state: LbfState, query: jnp.ndarray) -> jnp.ndarray:
        """query (..., 2) -> (...) bool: cell blocked by an agent or uneaten food.
        Direct compares against the (tiny) entity tables — no grid scatter/gather."""
        flat_q = query[..., 0] * self.grid_size + query[..., 1]
        flat_agent = state.agent_pos[:, 0] * self.grid_size + state.agent_pos[:, 1]
        flat_food = state.food_pos[:, 0] * self.grid_size + state.food_pos[:, 1]
        agent_hit = jnp.any(flat_q[..., None] == flat_agent, axis=-1)
        food_hit = jnp.any(
            (flat_q[..., None] == flat_food) & ~state.food_eaten, axis=-1
        )
        return agent_hit | food_hit

    def _observe(self, state: LbfState) -> Observation:
        a, f = self.num_agents, self.num_food

        def one_agent(i: jnp.ndarray) -> jnp.ndarray:
            my_pos = state.agent_pos[i]
            in_view = (
                lambda pos: jnp.max(jnp.abs(pos - my_pos), axis=-1) <= self.fov
            )

            food_visible = in_view(state.food_pos) & ~state.food_eaten
            food_feats = jnp.where(
                food_visible[:, None],
                jnp.concatenate(
                    [
                        state.food_pos.astype(jnp.float32),
                        state.food_level.astype(jnp.float32)[:, None],
                    ],
                    axis=-1,
                ),
                -1.0,
            )  # (F, 3)

            agent_visible = in_view(state.agent_pos)
            agent_feats = jnp.where(
                agent_visible[:, None],
                jnp.concatenate(
                    [
                        state.agent_pos.astype(jnp.float32),
                        state.agent_level.astype(jnp.float32)[:, None],
                    ],
                    axis=-1,
                ),
                -1.0,
            )  # (A, 3)
            # Self first, then others in index order.
            order = (jnp.arange(a) + i) % a
            agent_feats = agent_feats[order]
            return jnp.concatenate([food_feats.reshape(-1), agent_feats.reshape(-1)])

        agents_view = jax.vmap(one_agent)(jnp.arange(a))
        action_mask = self._action_mask(state)
        step_count = jnp.repeat(state.step_count, a)
        return Observation(agents_view, action_mask, step_count)

    def _action_mask(self, state: LbfState) -> jnp.ndarray:
        targets = state.agent_pos[:, None, :] + _MOVES_J[None, 1:5, :]  # (A, 4, 2)
        in_bounds = jnp.all((targets >= 0) & (targets < self.grid_size), axis=-1)
        safe = jnp.clip(targets, 0, self.grid_size - 1)
        move_ok = in_bounds & ~self._blocked_at(state, safe)  # (A, 4)

        # Load: any orthogonally-adjacent uneaten food — (A, 4, F) compare.
        adj = state.agent_pos[:, None, :] + _ADJ_J[None, :, :]  # (A, 4, 2)
        diff = jnp.abs(adj[:, :, None, :] - state.food_pos[None, None, :, :])
        adjacent_food = jnp.all(diff == 0, axis=-1) & ~state.food_eaten[None, None, :]
        load_ok = jnp.any(adjacent_food, axis=(1, 2))

        ones = jnp.ones((self.num_agents, 1), dtype=jnp.bool_)
        return jnp.concatenate([ones, move_ok, load_ok[:, None]], axis=-1)

    # ------------------------------------------------------------------ API
    def reset(self, key: PRNGKey) -> Tuple[LbfState, TimeStep]:
        key, pos_key, alevel_key, flevel_key = jax.random.split(key, 4)

        # Distinct uniform cells via top-k over iid uniforms (cheaper than
        # random.choice(replace=False)'s argsort; runs per step under AutoReset).
        n_cells = self.grid_size * self.grid_size
        _, cells = jax.lax.top_k(
            jax.random.uniform(pos_key, (n_cells,)),
            self.num_agents + self.num_food,
        )
        coords = jnp.stack([cells // self.grid_size, cells % self.grid_size], axis=-1)
        agent_pos = coords[: self.num_agents].astype(jnp.int32)
        food_pos = coords[self.num_agents :].astype(jnp.int32)

        agent_level = jax.random.randint(
            alevel_key, (self.num_agents,), 1, self.max_agent_level + 1
        )
        if self.force_coop:
            food_level = jnp.full(
                (self.num_food,), jnp.sum(agent_level), dtype=jnp.int32
            )
        else:
            top3 = jnp.sort(agent_level)[-3:] if self.num_agents >= 3 else agent_level
            max_food_level = jnp.maximum(jnp.sum(top3), 1)
            food_level = jax.random.randint(
                flevel_key, (self.num_food,), 1, max_food_level + 1
            )

        state = LbfState(
            key=key,
            step_count=jnp.int32(0),
            agent_pos=agent_pos,
            agent_level=agent_level.astype(jnp.int32),
            food_pos=food_pos,
            food_level=food_level.astype(jnp.int32),
            food_eaten=jnp.zeros(self.num_food, dtype=jnp.bool_),
            total_food_level=jnp.sum(food_level).astype(jnp.float32),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(self, state: LbfState, action: jnp.ndarray) -> Tuple[LbfState, TimeStep]:
        action = action.astype(jnp.int32)
        # --- movement with simultaneous-conflict resolution (both stay) -----------
        deltas = _MOVES_J[action]
        targets = state.agent_pos + deltas
        in_bounds = jnp.all((targets >= 0) & (targets < self.grid_size), axis=-1)
        safe = jnp.clip(targets, 0, self.grid_size - 1)
        # Blocked by food or by any agent's CURRENT cell (conservative, as original).
        valid = (
            in_bounds
            & ~self._blocked_at(state, safe)
            & (action >= UP)
            & (action <= RIGHT)
        )
        proposed = jnp.where(valid[:, None], safe, state.agent_pos)
        # Two agents proposing the same cell -> both stay.
        flat = proposed[:, 0] * self.grid_size + proposed[:, 1]
        clash = (flat[:, None] == flat[None, :]) & ~jnp.eye(
            self.num_agents, dtype=jnp.bool_
        )
        has_clash = jnp.any(clash, axis=-1)
        new_pos = jnp.where(has_clash[:, None], state.agent_pos, proposed)

        # --- loading --------------------------------------------------------------
        loading = action == LOAD
        # adjacency matrix agents x foods (orthogonal, uneaten)
        diff = jnp.abs(new_pos[:, None, :] - state.food_pos[None, :, :])
        adjacent = (jnp.sum(diff, axis=-1) == 1) & ~state.food_eaten[None, :]
        load_levels = jnp.where(
            (loading[:, None] & adjacent),
            state.agent_level[:, None],
            0,
        )  # (A, F)
        level_sum = jnp.sum(load_levels, axis=0)  # (F,)
        eaten_now = (level_sum >= state.food_level) & (level_sum > 0)

        # reward_i = sum_f eaten_now_f * food_level_f * level_i / (adj_sum_f * total)
        contrib = jnp.where(
            eaten_now[None, :],
            load_levels
            * state.food_level[None, :]
            / jnp.maximum(level_sum[None, :], 1),
            0.0,
        )  # (A, F)
        individual_rewards = jnp.sum(contrib, axis=-1) / jnp.maximum(
            state.total_food_level, 1.0
        )
        if self.use_individual_rewards:
            reward = individual_rewards.astype(jnp.float32)
        else:
            reward = jnp.repeat(
                jnp.sum(individual_rewards).astype(jnp.float32), self.num_agents
            )

        food_eaten = state.food_eaten | eaten_now
        step_count = state.step_count + 1
        new_state = LbfState(
            key=state.key,
            step_count=step_count,
            agent_pos=new_pos,
            agent_level=state.agent_level,
            food_pos=state.food_pos,
            food_level=state.food_level,
            food_eaten=food_eaten,
            total_food_level=state.total_food_level,
        )
        obs = self._observe(new_state)

        # One fused timestep build: all_eaten -> termination (discount 0),
        # time_up -> truncation (discount 1) — no lax.cond over the obs pytree.
        all_eaten = jnp.all(food_eaten)
        time_up = step_count >= self.time_limit
        done = all_eaten | time_up
        timestep = TimeStep(
            step_type=jnp.where(
                done, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(all_eaten, 0.0, 1.0)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras={},
        )
        return new_state, timestep

    # ------------------------------------------------------------------ specs
    def observation_spec(self) -> specs.TreeSpec:
        return specs.TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=specs.Array(
                (self.num_agents, self.num_obs_features), jnp.float32, "agents_view"
            ),
            action_mask=specs.Array(
                (self.num_agents, NUM_ACTIONS), jnp.bool_, "action_mask"
            ),
            step_count=specs.BoundedArray(
                (self.num_agents,),
                jnp.int32,
                "step_count",
                minimum=0,
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
    def unwrapped(self) -> "LevelBasedForaging":
        return self


_MOVES_J = jnp.asarray(_MOVES)
_ADJ_J = jnp.asarray(_ADJ)
