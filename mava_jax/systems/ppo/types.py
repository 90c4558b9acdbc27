"""PPO-family state containers (reference `mava/systems/ppo/types.py`)."""

from __future__ import annotations

from typing import Dict

from typing import NamedTuple

from mava_jax.types import Action, Array, Done, HiddenState, PRNGKey, State, Value


class Params(NamedTuple):
    actor_params: Dict
    critic_params: Dict


class OptStates(NamedTuple):
    actor_opt_state: tuple
    critic_opt_state: tuple


class HiddenStates(NamedTuple):
    policy_hidden_state: HiddenState
    critic_hidden_state: HiddenState


class LearnerState(NamedTuple):
    """Carry of the feedforward PPO update scan."""

    params: Params
    opt_states: OptStates
    key: PRNGKey
    env_state: State
    timestep: object  # TimeStep


class RNNLearnerState(NamedTuple):
    """Carry of the recurrent PPO update scan."""

    params: Params
    opt_states: OptStates
    key: PRNGKey
    env_state: State
    timestep: object
    dones: Done  # (num_envs, num_agents) — done of the last timestep
    hstates: HiddenStates


class PPOTransition(NamedTuple):
    done: Done
    action: Action
    value: Value
    reward: Array
    log_prob: Array
    obs: object
    info: Dict


class RNNPPOTransition(NamedTuple):
    done: Done
    action: Action
    value: Value
    reward: Array
    log_prob: Array
    obs: object
    hstates: HiddenStates
    info: Dict
