"""Generic environment wrappers.

Capability parity with the reference's wrapper stack (`mava/wrappers/observation.py`,
`auto_reset_wrapper.py`, `episode_metrics.py`): AgentID one-hot concat, auto-reset with
`real_next_obs` in extras, and in-graph episode-metric recording. The reference's
per-suite wrappers (`mava/wrappers/jumanji.py` etc.) have no analog here because our
environments are native and already emit the Mava observation contract directly.

All wrappers are pure and vmap/scan-safe. Note that under `vmap`, the auto-reset
`lax.cond` lowers to a select that computes both branches — same cost profile as the
reference (`ff_ippo.py:94` vmaps the auto-reset step); environments here keep `reset`
cheap for exactly this reason.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import (
    Observation,
    ObservationGlobalState,
    PRNGKey,
    State,
    TimeStep,
)

OBS_IN_EXTRAS_KEY = "real_next_obs"


class Wrapper:
    """Base wrapper: forwards everything to the wrapped env."""

    def __init__(self, env: Any):
        self._env = env
        self.num_agents = env.num_agents
        self.time_limit = env.time_limit
        self.action_dim = env.action_dim

    def __getattr__(self, name: str) -> Any:
        return getattr(self._env, name)

    def reset(self, key: PRNGKey) -> Tuple[State, TimeStep]:
        return self._env.reset(key)

    def step(self, state: State, action: jnp.ndarray) -> Tuple[State, TimeStep]:
        return self._env.step(state, action)

    def observation_spec(self):
        return self._env.observation_spec()

    def action_spec(self):
        return self._env.action_spec()

    @property
    def unwrapped(self) -> Any:
        return getattr(self._env, "unwrapped", self._env)


class GlobalStateWrapper(Wrapper):
    """Adds a global state (tiled concat of all agent views) for centralised critics.

    Default global-state construction per reference `mava/wrappers/jumanji.py:53-59`.
    Environments that expose a bespoke `get_global_state(obs, state)` override this.
    """

    def _add_global_state(self, timestep: TimeStep, state: State) -> TimeStep:
        obs = timestep.observation
        if hasattr(self._env, "get_global_state"):
            global_state = self._env.get_global_state(obs, state)
        else:
            # Flatten each agent's full view (works for vector AND grid views),
            # concat across agents, tile per agent.
            flat = obs.agents_view.reshape(-1)
            global_state = jnp.tile(flat, (self.num_agents, 1))
        observation = ObservationGlobalState(
            agents_view=obs.agents_view,
            action_mask=obs.action_mask,
            global_state=global_state,
            step_count=obs.step_count,
        )
        return timestep.replace(observation=observation)

    def reset(self, key: PRNGKey) -> Tuple[State, TimeStep]:
        state, timestep = self._env.reset(key)
        return state, self._add_global_state(timestep, state)

    def step(self, state: State, action: jnp.ndarray) -> Tuple[State, TimeStep]:
        state, timestep = self._env.step(state, action)
        return state, self._add_global_state(timestep, state)

    def observation_spec(self):
        inner = self._env.observation_spec()
        if hasattr(self._env, "global_state_spec"):
            global_state = self._env.global_state_spec()
        else:
            view = inner.agents_view
            # Product of all per-agent view dims (vector or grid), times num_agents.
            per_agent = int(np.prod(view.shape[1:]))
            global_state = specs.Array(
                (self.num_agents, self.num_agents * per_agent),
                view.dtype,
                "global_state",
            )
        return specs.TreeSpec(
            ObservationGlobalState,
            "ObservationSpec",
            agents_view=inner.agents_view,
            action_mask=inner.action_mask,
            global_state=global_state,
            step_count=inner.step_count,
        )


class AgentIDWrapper(Wrapper):
    """Concatenates a one-hot agent id onto `agents_view`
    (reference `mava/wrappers/observation.py:26-82`)."""

    def _add_ids(self, timestep: TimeStep) -> TimeStep:
        obs = timestep.observation
        agent_ids = jnp.eye(self.num_agents, dtype=obs.agents_view.dtype)
        new_view = jnp.concatenate([agent_ids, obs.agents_view], axis=-1)
        return timestep.replace(observation=obs._replace(agents_view=new_view))

    def reset(self, key: PRNGKey) -> Tuple[State, TimeStep]:
        state, timestep = self._env.reset(key)
        return state, self._add_ids(timestep)

    def step(self, state: State, action: jnp.ndarray) -> Tuple[State, TimeStep]:
        state, timestep = self._env.step(state, action)
        return state, self._add_ids(timestep)

    def observation_spec(self):
        inner = self._env.observation_spec()
        view = inner.agents_view
        new_view = view.replace(
            shape=(*view.shape[:-1], view.shape[-1] + self.num_agents)
        )
        return inner.replace(agents_view=new_view)


class AutoResetWrapper(Wrapper):
    """Resets the env when an episode terminates, inside the compiled step.

    The terminal observation is preserved in `extras["real_next_obs"]` (needed by
    off-policy systems); the timestep's observation is replaced by the reset obs.
    Mirrors reference `mava/wrappers/auto_reset_wrapper.py:29-101`.
    """

    def _obs_in_extras(
        self, state: State, timestep: TimeStep
    ) -> Tuple[State, TimeStep]:
        extras = dict(timestep.extras)
        extras[OBS_IN_EXTRAS_KEY] = timestep.observation
        return state, timestep.replace(extras=extras)

    def _auto_reset(self, state: State, timestep: TimeStep) -> Tuple[State, TimeStep]:
        key, _ = jax.random.split(state.key)
        reset_state, reset_timestep = self._env.reset(key)
        state, timestep = self._obs_in_extras(state, timestep)
        timestep = timestep.replace(observation=reset_timestep.observation)
        return reset_state, timestep

    def reset(self, key: PRNGKey) -> Tuple[State, TimeStep]:
        return self._obs_in_extras(*self._env.reset(key))

    def step(self, state: State, action: jnp.ndarray) -> Tuple[State, TimeStep]:
        state, timestep = self._env.step(state, action)
        return jax.lax.cond(
            timestep.last(), self._auto_reset, self._obs_in_extras, state, timestep
        )


@struct.dataclass
class RecordEpisodeMetricsState:
    env_state: State
    key: PRNGKey
    running_count_episode_return: jnp.ndarray
    running_count_episode_length: jnp.ndarray
    episode_return: jnp.ndarray
    episode_length: jnp.ndarray


class RecordEpisodeMetrics(Wrapper):
    """Tracks episode return/length in wrapper state and emits them through
    `extras["episode_metrics"]` (reference `mava/wrappers/episode_metrics.py:46-111`)."""

    def reset(self, key: PRNGKey) -> Tuple[RecordEpisodeMetricsState, TimeStep]:
        key, reset_key = jax.random.split(key)
        state, timestep = self._env.reset(reset_key)
        wrapped = RecordEpisodeMetricsState(
            env_state=state,
            key=key,
            running_count_episode_return=jnp.float32(0.0),
            running_count_episode_length=jnp.int32(0),
            episode_return=jnp.float32(0.0),
            episode_length=jnp.int32(0),
        )
        extras = dict(timestep.extras)
        extras["episode_metrics"] = {
            "episode_return": jnp.float32(0.0),
            "episode_length": jnp.int32(0),
            "is_terminal_step": jnp.bool_(False),
        }
        return wrapped, timestep.replace(extras=extras)

    def step(
        self, state: RecordEpisodeMetricsState, action: jnp.ndarray
    ) -> Tuple[RecordEpisodeMetricsState, TimeStep]:
        env_state, timestep = self._env.step(state.env_state, action)

        done = timestep.last()
        not_done = 1 - done

        new_return = state.running_count_episode_return + jnp.mean(timestep.reward)
        new_length = state.running_count_episode_length + 1

        episode_return_info = state.episode_return * not_done + new_return * done
        episode_length_info = state.episode_length * not_done + new_length * done

        extras = dict(timestep.extras)
        extras["episode_metrics"] = {
            "episode_return": episode_return_info,
            "episode_length": episode_length_info,
            "is_terminal_step": done,
        }

        state = RecordEpisodeMetricsState(
            env_state=env_state,
            key=state.key,
            running_count_episode_return=new_return * not_done,
            running_count_episode_length=new_length * not_done,
            episode_return=episode_return_info,
            episode_length=episode_length_info,
        )
        return state, timestep.replace(extras=extras)


def get_final_step_metrics(
    metrics: Dict[str, jnp.ndarray],
) -> Tuple[Dict[str, jnp.ndarray], bool]:
    """Boolean-mask metrics at terminal steps for host-side logging. Not jittable
    (variable length); reference `episode_metrics.py:114-132`."""
    metrics = dict(metrics)
    # Multi-process runs hand episode metrics over sharded across hosts; the
    # boolean mask below materialises values host-side (np.nonzero), which
    # raises on non-addressable shards. Gather first — every process calls
    # this on the same program, so the collective is valid. Executed
    # 2-process evidence: scripts/multiproc_smoke.py.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        metrics = multihost_utils.process_allgather(metrics, tiled=True)
    is_final_ep = metrics.pop("is_terminal_step")
    has_final_ep_step = bool(jnp.any(is_final_ep))

    if not has_final_ep_step:
        final_metrics = jax.tree.map(jnp.zeros_like, metrics)
    else:
        final_metrics = jax.tree.map(lambda x: x[is_final_ep], metrics)
    return final_metrics, has_final_ep_step
