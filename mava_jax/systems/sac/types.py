"""SAC state containers (reference `mava/systems/sac/types.py`)."""

from __future__ import annotations

from typing import Any, Dict

from typing import NamedTuple

from mava_jax.types import Array, PRNGKey, State


class QVals(NamedTuple):
    q1: Dict
    q2: Dict


class QValsAndTarget(NamedTuple):
    online: QVals
    targets: QVals


class SacParams(NamedTuple):
    actor: Dict
    q: QValsAndTarget
    log_alpha: Array


class OptStates(NamedTuple):
    actor: Any
    q: Any
    alpha: Any


class Transition(NamedTuple):
    obs: Any
    action: Array
    reward: Array
    done: Array
    next_obs: Any


class LearnerState(NamedTuple):
    obs: Any
    env_state: State
    buffer_state: Any
    params: SacParams
    opt_states: OptStates
    t: Array
    key: PRNGKey
