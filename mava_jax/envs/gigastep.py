"""Gigastep-style two-team environment, implemented natively in JAX.

The reference wraps the external `gigastep` package (`mava/wrappers/gigastep.py`),
whose Mava-facing structure is: a controllable team and an adversary team whose random
actions are cached in the env state (`gigastep.py:86-98,286-300`), with
`won_episode` = "more agents alive than the adversary at episode end"
(`gigastep.py:268-284`). This module reimplements that two-team task structure with our
own compact engine:

  * continuous 2D arena, discrete actions: 0=stay, 1..8 = 8 compass directions;
  * `hide_and_seek`: the policy team tags adversaries within range (a tagged adversary
    is deactivated, +1 team reward); adversaries are random walkers (their actions are
    drawn from the state's cached key each step, like the reference's cached
    adversary actions); adversaries that touch a policy agent deactivate it;
  * `waypoint`: both teams race to reach a shared waypoint (+1 to whoever arrives
    first, then a new waypoint spawns); "alive" score = waypoints collected;
  * episode ends at time_limit (truncation) or when either team is wiped
    (hide_and_seek); won_episode = policy team strictly ahead;
  * `fobs` (full observability) or `pobs` (limited sight radius) observation modes:
    per agent [own pos(2), own active(1)] + per other unit [visible, rel_x, rel_y,
    active, is_adversary].
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_DIRS = np.array(
    [[0, 0], [0, 1], [1, 1], [1, 0], [1, -1], [0, -1], [-1, -1], [-1, 0], [-1, 1]],
    dtype=np.float32,
)
_DIRS = _DIRS / np.maximum(np.linalg.norm(_DIRS, axis=-1, keepdims=True), 1.0)
NUM_ACTIONS = 9
_ARENA = 10.0
_SPEED = 0.5
_TAG_RANGE = 0.7
_WAYPOINT_RANGE = 0.7


@struct.dataclass
class GigastepState:
    key: PRNGKey
    step_count: jnp.ndarray
    team_pos: jnp.ndarray  # (A, 2) policy team
    adv_pos: jnp.ndarray  # (E, 2) adversary team
    team_active: jnp.ndarray  # (A,) bool
    adv_active: jnp.ndarray  # (E,) bool
    team_score: jnp.ndarray  # () float32
    adv_score: jnp.ndarray  # () float32
    waypoint: jnp.ndarray  # (2,)


class Gigastep:
    def __init__(
        self,
        scenario: str = "hide_and_seek",
        num_agents: int = 5,
        num_adversaries: int = 5,
        partial_obs: bool = False,
        sight_radius: float = 3.0,
        time_limit: int = 100,
    ):
        assert scenario in ("hide_and_seek", "waypoint"), scenario
        self.scenario = scenario
        self.num_agents = num_agents
        self.num_adversaries = num_adversaries
        self.partial_obs = partial_obs
        self.sight_radius = sight_radius
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        n_others = num_agents - 1 + num_adversaries
        self.num_obs_features = 3 + 5 * n_others + 2  # + waypoint rel pos

    def _observe(self, state: GigastepState) -> Observation:
        a = self.num_agents
        all_pos = jnp.concatenate([state.team_pos, state.adv_pos])
        all_active = jnp.concatenate([state.team_active, state.adv_active])
        is_adv = jnp.concatenate(
            [jnp.zeros(a), jnp.ones(self.num_adversaries)]
        )

        rel = all_pos[None, :, :] - state.team_pos[:, None, :]  # (A, N, 2)
        dist = jnp.linalg.norm(rel, axis=-1)
        if self.partial_obs:
            visible = (dist <= self.sight_radius) & all_active[None, :]
        else:
            visible = jnp.broadcast_to(all_active[None, :], dist.shape)
        feats = jnp.concatenate(
            [
                visible[..., None].astype(jnp.float32),
                rel / _ARENA,
                jnp.broadcast_to(
                    all_active[None, :, None].astype(jnp.float32), (*dist.shape, 1)
                ),
                jnp.broadcast_to(is_adv[None, :, None], (*dist.shape, 1)),
            ],
            axis=-1,
        ) * visible[..., None]  # (A, N, 5)

        n = a + self.num_adversaries
        idx = (jnp.arange(n)[None, :] + jnp.arange(a)[:, None]) % n
        feats = jnp.take_along_axis(feats, idx[..., None], axis=1)[:, 1:]

        own = jnp.concatenate(
            [state.team_pos / _ARENA, state.team_active[:, None].astype(jnp.float32)],
            axis=-1,
        )
        wp_rel = (state.waypoint[None, :] - state.team_pos) / _ARENA
        agents_view = jnp.concatenate(
            [own, feats.reshape(a, -1), wp_rel], axis=-1
        ).astype(jnp.float32)

        mask = jnp.ones((a, 1), dtype=jnp.bool_)
        move_ok = jnp.broadcast_to(state.team_active[:, None], (a, NUM_ACTIONS - 1))
        action_mask = jnp.concatenate([mask, move_ok], axis=-1)
        return Observation(agents_view, action_mask, jnp.repeat(state.step_count, a))

    def reset(self, key: PRNGKey) -> Tuple[GigastepState, TimeStep]:
        key, team_key, adv_key, wp_key = jax.random.split(key, 4)
        team_pos = jax.random.uniform(
            team_key, (self.num_agents, 2), minval=0.0, maxval=_ARENA / 2
        )
        adv_pos = jax.random.uniform(
            adv_key, (self.num_adversaries, 2), minval=_ARENA / 2, maxval=_ARENA
        )
        state = GigastepState(
            key=key,
            step_count=jnp.int32(0),
            team_pos=team_pos,
            adv_pos=adv_pos,
            team_active=jnp.ones(self.num_agents, dtype=jnp.bool_),
            adv_active=jnp.ones(self.num_adversaries, dtype=jnp.bool_),
            team_score=jnp.float32(0.0),
            adv_score=jnp.float32(0.0),
            waypoint=jax.random.uniform(wp_key, (2,), minval=0.0, maxval=_ARENA),
        )
        obs = self._observe(state)
        return state, restart(obs, {"won_episode": jnp.bool_(False)}, self.num_agents)

    def step(self, state: GigastepState, action: jnp.ndarray) -> Tuple[GigastepState, TimeStep]:
        key, adv_key, wp_key = jax.random.split(state.key, 3)
        action = jnp.clip(action.astype(jnp.int32), 0, NUM_ACTIONS - 1)

        # Adversary team: cached random actions from the state key.
        adv_action = jax.random.randint(adv_key, (self.num_adversaries,), 0, NUM_ACTIONS)

        team_pos = state.team_pos + _DIRS_J[action] * _SPEED * state.team_active[:, None]
        adv_pos = state.adv_pos + _DIRS_J[adv_action] * _SPEED * state.adv_active[:, None]
        team_pos = jnp.clip(team_pos, 0.0, _ARENA)
        adv_pos = jnp.clip(adv_pos, 0.0, _ARENA)

        dist = jnp.linalg.norm(
            team_pos[:, None, :] - adv_pos[None, :, :], axis=-1
        )  # (A, E)
        contact = (
            (dist <= _TAG_RANGE)
            & state.team_active[:, None]
            & state.adv_active[None, :]
        )

        if self.scenario == "hide_and_seek":
            tagged_adv = jnp.any(contact, axis=0)  # adversary caught by anyone
            adv_active = state.adv_active & ~tagged_adv
            team_active = state.team_active
            team_reward = jnp.sum(tagged_adv).astype(jnp.float32)
            team_score = state.team_score + team_reward
            adv_score = state.adv_score
            waypoint = state.waypoint
        else:  # waypoint
            team_at = (
                jnp.linalg.norm(team_pos - state.waypoint[None], axis=-1)
                <= _WAYPOINT_RANGE
            ) & state.team_active
            adv_at = (
                jnp.linalg.norm(adv_pos - state.waypoint[None], axis=-1)
                <= _WAYPOINT_RANGE
            ) & state.adv_active
            team_hit = jnp.any(team_at)
            adv_hit = jnp.any(adv_at) & ~team_hit  # policy team wins ties
            team_reward = team_hit.astype(jnp.float32)
            team_score = state.team_score + team_reward
            adv_score = state.adv_score + adv_hit.astype(jnp.float32)
            waypoint = jnp.where(
                team_hit | adv_hit,
                jax.random.uniform(wp_key, (2,), minval=0.0, maxval=_ARENA),
                state.waypoint,
            )
            team_active = state.team_active
            adv_active = state.adv_active

        reward = jnp.repeat(team_reward, self.num_agents)
        step_count = state.step_count + 1

        new_state = GigastepState(
            key=key,
            step_count=step_count,
            team_pos=team_pos,
            adv_pos=adv_pos,
            team_active=team_active,
            adv_active=adv_active,
            team_score=team_score,
            adv_score=adv_score,
            waypoint=waypoint,
        )
        obs = self._observe(new_state)

        if self.scenario == "hide_and_seek":
            won = jnp.sum(team_active) > jnp.sum(adv_active)
            wiped = ~jnp.any(adv_active) | ~jnp.any(team_active)
        else:
            won = team_score > adv_score
            wiped = jnp.bool_(False)
        extras = {"won_episode": won}

        # Fused timestep: wiped -> termination (discount 0), time_up -> truncation.
        time_up = step_count >= self.time_limit
        done = wiped | time_up
        timestep = TimeStep(
            step_type=jnp.where(
                done, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(wiped, 0.0, 1.0)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras=extras,
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
    def unwrapped(self) -> "Gigastep":
        return self


_DIRS_J = jnp.asarray(_DIRS)
