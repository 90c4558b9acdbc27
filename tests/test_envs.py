"""Environment invariants: static shapes, spec agreement, wrapper semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax.envs.rware import RobotWarehouse
from mava_jax.envs.wrappers import (
    AgentIDWrapper,
    AutoResetWrapper,
    GlobalStateWrapper,
    RecordEpisodeMetrics,
)


@pytest.fixture(scope="module")
def rware():
    return RobotWarehouse(time_limit=50)


def test_rware_obs_matches_spec(rware):
    state, ts = jax.jit(rware.reset)(jax.random.PRNGKey(0))
    spec = rware.observation_spec()
    assert ts.observation.agents_view.shape == spec.agents_view.shape
    assert ts.observation.action_mask.shape == spec.action_mask.shape
    assert ts.observation.step_count.shape == spec.step_count.shape
    assert ts.observation.agents_view.dtype == spec.agents_view.dtype
    # Jumanji RWARE emits 66 obs features at sensor_range=1.
    assert spec.agents_view.shape[-1] == 66


def test_rware_step_static_shapes(rware):
    state, ts = rware.reset(jax.random.PRNGKey(1))
    step = jax.jit(rware.step)
    for i in range(3):
        action = jax.random.randint(jax.random.PRNGKey(i), (2,), 0, 5)
        state, ts = step(state, action)
    assert ts.reward.shape == (2,)
    assert ts.discount.shape == (2,)


def test_rware_time_limit_truncates(rware):
    env = RobotWarehouse(time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(2))
    step = jax.jit(env.step)
    noop = jnp.zeros(2, dtype=jnp.int32)
    for _ in range(5):
        state, ts = step(state, noop)
    assert bool(ts.last())
    # Truncation bootstraps: discount stays 1.
    np.testing.assert_array_equal(np.asarray(ts.discount), np.ones(2))


def test_rware_collision_terminates():
    env = RobotWarehouse(time_limit=50)
    state, ts = env.reset(jax.random.PRNGKey(3))
    # Force agents adjacent & facing each other -> both move forward -> swap collision.
    state = state.replace(
        agent_pos=jnp.array([[0, 0], [0, 1]], dtype=jnp.int32),
        agent_dir=jnp.array([1, 3], dtype=jnp.int32),  # right, left
    )
    state, ts = env.step(state, jnp.array([1, 1], dtype=jnp.int32))
    assert bool(ts.last())
    np.testing.assert_array_equal(np.asarray(ts.discount), np.zeros(2))


def test_rware_delivery_reward():
    env = RobotWarehouse(time_limit=50)
    state, ts = env.reset(jax.random.PRNGKey(4))
    # Place agent 0 carrying requested shelf 0 on a goal cell; agent 1 far away.
    goal = np.asarray(env._goals)[0]
    state = state.replace(
        agent_pos=jnp.array([goal, [0, 0]], dtype=jnp.int32),
        agent_carrying=jnp.array([0, -1], dtype=jnp.int32),
        shelf_requested=jnp.zeros(env.num_shelves, dtype=jnp.bool_).at[0].set(True),
    )
    state2, ts2 = env.step(state, jnp.array([0, 0], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(ts2.reward), np.ones(2))
    # Shelf 0 no longer requested; another shelf newly requested.
    assert not bool(state2.shelf_requested[0])
    assert int(jnp.sum(state2.shelf_requested)) == 1
    # Sitting there again yields no further reward.
    state3, ts3 = env.step(state2, jnp.array([0, 0], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(ts3.reward), np.zeros(2))


def test_agent_id_wrapper(rware):
    env = AgentIDWrapper(rware)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.agents_view.shape == (2, 66 + 2)
    np.testing.assert_array_equal(
        np.asarray(ts.observation.agents_view[:, :2]), np.eye(2)
    )
    assert env.observation_spec().agents_view.shape == (2, 68)


def test_global_state_wrapper(rware):
    env = GlobalStateWrapper(rware)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.global_state.shape == (2, 2 * 66)
    # Both agents see the same global state.
    np.testing.assert_array_equal(
        np.asarray(ts.observation.global_state[0]),
        np.asarray(ts.observation.global_state[1]),
    )


def test_auto_reset_wrapper():
    env = AutoResetWrapper(RobotWarehouse(time_limit=3))
    state, ts = env.reset(jax.random.PRNGKey(5))
    step = jax.jit(env.step)
    noop = jnp.zeros(2, dtype=jnp.int32)
    for _ in range(3):
        state, ts = step(state, noop)
    assert bool(ts.last())
    # Observation was replaced with the reset observation (step_count 0)...
    np.testing.assert_array_equal(np.asarray(ts.observation.step_count), np.zeros(2))
    # ...while the terminal obs is preserved in extras.
    np.testing.assert_array_equal(
        np.asarray(ts.extras["real_next_obs"].step_count), 3 * np.ones(2)
    )
    # Next step continues the new episode.
    state, ts = step(state, noop)
    assert not bool(ts.last())
    np.testing.assert_array_equal(np.asarray(ts.observation.step_count), np.ones(2))


def test_record_episode_metrics():
    env = RecordEpisodeMetrics(AutoResetWrapper(RobotWarehouse(time_limit=4)))
    state, ts = env.reset(jax.random.PRNGKey(6))
    step = jax.jit(env.step)
    noop = jnp.zeros(2, dtype=jnp.int32)
    for i in range(4):
        state, ts = step(state, noop)
    m = ts.extras["episode_metrics"]
    assert bool(m["is_terminal_step"])
    assert int(m["episode_length"]) == 4
    state, ts = step(state, noop)
    assert not bool(ts.extras["episode_metrics"]["is_terminal_step"])
