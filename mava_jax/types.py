"""Core type contracts for the framework.

Mirrors the capability surface of the reference's `mava/types.py` (Observation,
ObservationGlobalState, the MarlEnv protocol) and `jumanji.types.TimeStep`, but is fully
self-contained: this framework ships its own TimeStep and spec types because the target
image has no jumanji. All containers are pytrees so they flow through `jit`/`vmap`/
`lax.scan`/`shard_map` unchanged.
"""

from __future__ import annotations

import enum
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    NamedTuple,
    Protocol,
    Tuple,
    TypeAlias,
    TypeVar,
)

import jax.numpy as jnp

from mava_jax.utils import struct

Array: TypeAlias = jnp.ndarray
PRNGKey: TypeAlias = jnp.ndarray
Action: TypeAlias = Array
Value: TypeAlias = Array
Done: TypeAlias = Array
HiddenState: TypeAlias = Array
State: TypeAlias = Any
Metrics: TypeAlias = Dict[str, Array]


class StepType(enum.IntEnum):
    """First/mid/last marker for a timestep (dm_env convention)."""

    FIRST = 0
    MID = 1
    LAST = 2


@struct.dataclass
class TimeStep:
    """One environment transition.

    reward/discount have shape (num_agents,) after wrapping (the per-agent repetition
    the reference applies in e.g. `mava/wrappers/jumanji.py:135-144`).
    """

    step_type: Array  # () int32
    reward: Array  # (num_agents,)
    discount: Array  # (num_agents,)
    observation: Any
    extras: Dict[str, Any] = struct.field(default_factory=dict)

    def first(self) -> Array:
        return self.step_type == StepType.FIRST

    def mid(self) -> Array:
        return self.step_type == StepType.MID

    def last(self) -> Array:
        return self.step_type == StepType.LAST


def restart(observation: Any, extras: Dict[str, Any], num_agents: int) -> TimeStep:
    """Initial TimeStep of an episode."""
    return TimeStep(
        step_type=jnp.int32(StepType.FIRST),
        reward=jnp.zeros(num_agents, dtype=jnp.float32),
        discount=jnp.ones(num_agents, dtype=jnp.float32),
        observation=observation,
        extras=extras,
    )


def transition(
    reward: Array, observation: Any, extras: Dict[str, Any], num_agents: int
) -> TimeStep:
    """A mid-episode TimeStep."""
    return TimeStep(
        step_type=jnp.int32(StepType.MID),
        reward=reward,
        discount=jnp.ones(num_agents, dtype=jnp.float32),
        observation=observation,
        extras=extras,
    )


def termination(
    reward: Array, observation: Any, extras: Dict[str, Any], num_agents: int
) -> TimeStep:
    """A terminal TimeStep (discount = 0)."""
    return TimeStep(
        step_type=jnp.int32(StepType.LAST),
        reward=reward,
        discount=jnp.zeros(num_agents, dtype=jnp.float32),
        observation=observation,
        extras=extras,
    )


def truncation(
    reward: Array, observation: Any, extras: Dict[str, Any], num_agents: int
) -> TimeStep:
    """A time-limit TimeStep (last, but discount = 1 so bootstrapping continues)."""
    return TimeStep(
        step_type=jnp.int32(StepType.LAST),
        reward=reward,
        discount=jnp.ones(num_agents, dtype=jnp.float32),
        observation=observation,
        extras=extras,
    )


class Observation(NamedTuple):
    """Per-agent observation (reference `mava/types.py:111-121`)."""

    agents_view: Array  # (num_agents, num_obs_features)
    action_mask: Array  # (num_agents, num_actions)
    step_count: Array  # (num_agents,)


class ObservationGlobalState(NamedTuple):
    """Observation with a global state for centralised critics
    (reference `mava/types.py:124-134`)."""

    agents_view: Array  # (num_agents, num_obs_features)
    action_mask: Array  # (num_agents, num_actions)
    global_state: Array  # (num_agents, global_features)
    step_count: Array  # (num_agents,)


RNNObservation: TypeAlias = Tuple[Observation, Done]
RNNGlobalObservation: TypeAlias = Tuple[ObservationGlobalState, Done]


class MarlEnv(Protocol):
    """The environment API used by all systems (reference `mava/types.py:34-108`).

    Environments are pure: reset/step are jittable functions of (state, action, key).
    """

    num_agents: int
    time_limit: int
    action_dim: int

    def reset(self, key: PRNGKey) -> Tuple[State, TimeStep]: ...

    def step(self, state: State, action: Array) -> Tuple[State, TimeStep]: ...

    def observation_spec(self) -> Any: ...

    def action_spec(self) -> Any: ...


MavaState = TypeVar("MavaState")


class ExperimentOutput(NamedTuple, Generic[MavaState]):
    """Output of one compiled learner mega-step."""

    learner_state: MavaState
    episode_metrics: Metrics
    train_metrics: Metrics


LearnerFn = Callable[[MavaState], ExperimentOutput[MavaState]]
