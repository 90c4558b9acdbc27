"""Q-learning state containers (reference `mava/systems/q_learning/types.py`)."""

from __future__ import annotations

from typing import Any, Dict

from typing import NamedTuple

from mava_jax.types import Array, PRNGKey, State


class Transition(NamedTuple):
    """One stored transition. Both obs and next_obs are kept because the
    AutoResetWrapper replaces the terminal observation with the reset one
    (reference `types.py:29-39`)."""

    obs: Any
    action: Array
    reward: Array
    terminal: Array  # (1,) true termination (discount == 0)
    term_or_trunc: Array  # (1,) timestep.last()
    next_obs: Any


class QNetParams(NamedTuple):
    online: Dict
    target: Dict


class LearnerState(NamedTuple):
    # Interaction vars
    obs: Any
    terminal: Array
    term_or_trunc: Array
    hidden_state: Array
    env_state: State
    time_steps: Array
    # Train vars
    train_steps: Array
    opt_state: Any
    # Shared vars
    buffer_state: Any
    params: QNetParams
    key: PRNGKey


class ActionSelectionState(NamedTuple):
    online_params: Dict
    hidden_state: Array
    time_steps: Array
    key: PRNGKey


class ActionState(NamedTuple):
    action_selection_state: ActionSelectionState
    env_state: State
    buffer_state: Any
    obs: Any
    terminal: Array
    term_or_trunc: Array


class TrainState(NamedTuple):
    buffer_state: Any
    params: QNetParams
    opt_state: Any
    train_steps: Array
    key: PRNGKey
