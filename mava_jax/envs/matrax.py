"""Matrax: repeated two-player matrix games, implemented natively in JAX.

The reference wraps the `matrax` package (`mava/wrappers/matrax.py:28-98`). Scenario
names follow matrax conventions: `Climbing-{stateless|stateful}-v0` and
`Penalty-{k}-{stateless|stateful}-v0`. Stateless games observe a zero vector; stateful
games observe the joint action of the previous step. Action mask is all-ones
(reference `matrax.py:38`).

The matrax package additionally registers the 78 Rapoport 2x2 ordinal games as
`NoConflict-{0..20}-*-v0` / `Conflict-{0..56}-*-v0` — those ids resolve here
through `envs/matrax_catalog.py`, which derives the taxonomy from its
published definition (21 no-conflict + 57 conflict classes, asserted). The
catalog's id ORDER is this repo's deterministic lexicographic enumeration (the
matrax package's internal order isn't reproducible offline); the game set is
identical, and `matrax_catalog.canonical_id` maps any ordinal 2x2 game to its
id here. Beyond the catalog, ANY matrix game is expressible directly:
`Custom-{stateless|stateful}-v0` plus a `payoff` kwarg (per-agent payoff
matrices, shape (num_agents, rows, cols)), settable from a scenario yaml's
`task_config.payoff`. See `configs/env/scenario/matrax-pd.yaml` (prisoner's
dilemma) for the pattern.
"""

from __future__ import annotations

import re
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_CLIMBING = np.array(
    [[11.0, -30.0, 0.0], [-30.0, 7.0, 6.0], [0.0, 0.0, 5.0]], dtype=np.float32
)


def _penalty(k: float) -> np.ndarray:
    return np.array(
        [[-k, 0.0, 10.0], [0.0, 2.0, 0.0], [10.0, 0.0, -k]], dtype=np.float32
    )


def _parse_task(task_name: str, payoff=None) -> Tuple[np.ndarray, bool]:
    """Returns (payoff matrices (num_agents, rows, cols), stateful)."""
    m = re.match(r"Climbing-(stateless|stateful)-v0", task_name)
    if m:
        return np.stack([_CLIMBING, _CLIMBING]), m.group(1) == "stateful"
    m = re.match(r"Penalty-(\d+)-(stateless|stateful)-v0", task_name)
    if m:
        p = _penalty(float(m.group(1)))
        return np.stack([p, p]), m.group(2) == "stateful"
    m = re.match(r"(NoConflict|Conflict)-(\d+)-(stateless|stateful)-v0", task_name)
    if m:
        from mava_jax.envs.matrax_catalog import catalog_payoff

        return (
            catalog_payoff(m.group(1), int(m.group(2))),
            m.group(3) == "stateful",
        )
    m = re.match(r"Custom-(stateless|stateful)-v0", task_name)
    if m:
        if payoff is None:
            raise ValueError(
                "Matrax Custom-*-v0 needs a `payoff` kwarg: per-agent payoff "
                "matrices, shape (num_agents, rows, cols) — set "
                "task_config.payoff in the scenario yaml."
            )
        arr = np.asarray(payoff, dtype=np.float32)
        # Matrix games are two-player (matrax convention): the step rule
        # indexes payoff[agent, action_0, action_1].
        if arr.ndim != 3 or arr.shape[0] != 2 or arr.shape[1] != arr.shape[2]:
            raise ValueError(
                "Custom payoff must be (2, n_actions, n_actions); "
                f"got {arr.shape}."
            )
        return arr, m.group(1) == "stateful"
    raise ValueError(
        f"Unknown Matrax task '{task_name}'. Supported: Climbing-*-v0, "
        "Penalty-k-*-v0, NoConflict-{0..20}-*-v0, Conflict-{0..56}-*-v0, "
        "Custom-*-v0 (with a payoff kwarg)."
    )


@struct.dataclass
class MatraxState:
    key: PRNGKey
    step_count: jnp.ndarray
    last_actions: jnp.ndarray  # (num_agents,) int32


class Matrax:
    def __init__(
        self,
        task_name: str = "Climbing-stateless-v0",
        time_limit: int = 10,
        payoff=None,
    ):
        payoff, stateful = _parse_task(task_name, payoff)
        self.payoff = jnp.asarray(payoff)  # (A, rows, cols)
        self.stateful = stateful
        self.num_agents = payoff.shape[0]
        self.num_actions = payoff.shape[1]
        self.action_dim = self.num_actions
        self.time_limit = time_limit
        self.num_obs_features = self.num_agents if stateful else 1

    def _observe(self, state: MatraxState) -> Observation:
        if self.stateful:
            view = jnp.tile(
                state.last_actions.astype(jnp.float32), (self.num_agents, 1)
            )
        else:
            view = jnp.zeros((self.num_agents, 1), dtype=jnp.float32)
        mask = jnp.ones((self.num_agents, self.num_actions), dtype=jnp.bool_)
        return Observation(view, mask, jnp.repeat(state.step_count, self.num_agents))

    def reset(self, key: PRNGKey) -> Tuple[MatraxState, TimeStep]:
        state = MatraxState(
            key=key,
            step_count=jnp.int32(0),
            last_actions=jnp.zeros(self.num_agents, dtype=jnp.int32),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(self, state: MatraxState, action: jnp.ndarray) -> Tuple[MatraxState, TimeStep]:
        action = action.astype(jnp.int32)
        reward = self.payoff[jnp.arange(self.num_agents), action[0], action[1]]
        step_count = state.step_count + 1
        new_state = MatraxState(
            key=state.key, step_count=step_count, last_actions=action
        )
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
                (self.num_agents, self.num_actions), jnp.bool_, "action_mask"
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
            (self.num_agents,), jnp.int32, "action", num_values=self.num_actions
        )

    def reward_spec(self) -> specs.Array:
        return specs.Array((self.num_agents,), jnp.float32, "reward")

    @property
    def unwrapped(self) -> "Matrax":
        return self
