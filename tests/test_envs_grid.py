"""Cleaner / Connector / Gigastep mechanics tests."""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.cleaner import Cleaner
from mava_jax.envs.connector import MaConnector
from mava_jax.envs.gigastep import Gigastep


def test_cleaner_cleans_and_wins():
    env = Cleaner(num_rows=3, num_cols=3, num_agents=2, time_limit=50)
    state, ts = env.reset(jax.random.PRNGKey(0))
    # 3x3 pillar lattice: wall only at (1,1); 8 free tiles, (0,0) pre-cleaned.
    assert int(jnp.sum(state.dirty)) == 7
    # Agent 0 walks right: cleans (0,1).
    state, ts = env.step(state, jnp.array([1, 1], dtype=jnp.int32))
    # both agents moved to (0,1): one newly cleaned tile.
    np.testing.assert_allclose(np.asarray(ts.reward), [1.0, 1.0])
    assert int(jnp.sum(state.dirty)) == 6


def test_cleaner_wall_masked():
    env = Cleaner(num_rows=3, num_cols=3, num_agents=1, time_limit=50)
    state, ts = env.reset(jax.random.PRNGKey(0))
    state = state.replace(agent_pos=jnp.array([[0, 1]], dtype=jnp.int32))
    mask = np.asarray(env._observe(state).action_mask)
    # down from (0,1) is the pillar (1,1): masked; up is out of bounds: masked.
    assert not mask[0, 2] and not mask[0, 0]
    assert mask[0, 1] and mask[0, 3]


def test_connector_connect_and_win():
    env = MaConnector(grid_size=5, num_agents=2, time_limit=25)
    state, ts = env.reset(jax.random.PRNGKey(0))
    state = state.replace(
        head_pos=jnp.array([[0, 0], [4, 4]], dtype=jnp.int32),
        target_pos=jnp.array([[0, 1], [4, 3]], dtype=jnp.int32),
        connected=jnp.zeros(2, dtype=jnp.bool_),
        paths=jnp.zeros((5, 5), dtype=jnp.bool_),
    )
    # Agent 0 moves right onto its target; agent 1 moves left onto its target.
    state, ts = env.step(state, jnp.array([2, 4], dtype=jnp.int32))
    assert bool(state.connected[0]) and bool(state.connected[1])
    assert bool(ts.extras["won_episode"]) and bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.reward), [2.0, 2.0])  # team sum
    # Old heads became paths.
    assert bool(state.paths[0, 0]) and bool(state.paths[4, 4])


def test_connector_blocked_by_path():
    env = MaConnector(grid_size=5, num_agents=2, time_limit=25)
    state, _ = env.reset(jax.random.PRNGKey(0))
    state = state.replace(
        head_pos=jnp.array([[2, 2], [0, 0]], dtype=jnp.int32),
        target_pos=jnp.array([[4, 4], [0, 4]], dtype=jnp.int32),
        connected=jnp.zeros(2, dtype=jnp.bool_),
        paths=jnp.zeros((5, 5), dtype=jnp.bool_).at[2, 3].set(True),
    )
    mask = np.asarray(env._observe(state).action_mask)
    assert not mask[0, 2]  # right into the path cell is illegal
    # Trying it anyway is a no-op.
    state2, _ = env.step(state, jnp.array([2, 0], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(state2.head_pos[0]), [2, 2])


def test_gigastep_tagging():
    env = Gigastep(scenario="hide_and_seek", num_agents=2, num_adversaries=2,
                   time_limit=50)
    state, _ = env.reset(jax.random.PRNGKey(0))
    state = state.replace(
        team_pos=jnp.array([[5.0, 5.0], [1.0, 1.0]]),
        adv_pos=jnp.array([[5.2, 5.0], [9.0, 9.0]]),
    )
    state2, ts = env.step(state, jnp.zeros(2, dtype=jnp.int32))
    assert not bool(state2.adv_active[0])  # tagged (within range even after drift)
    assert float(ts.reward[0]) == 1.0
    assert bool(ts.extras["won_episode"])  # 2 alive vs 1


def test_gigastep_waypoint_scoring():
    env = Gigastep(scenario="waypoint", num_agents=1, num_adversaries=1, time_limit=50)
    state, _ = env.reset(jax.random.PRNGKey(0))
    state = state.replace(
        team_pos=jnp.array([[5.0, 5.0]]),
        adv_pos=jnp.array([[0.0, 0.0]]),
        waypoint=jnp.array([5.1, 5.0]),
    )
    state2, ts = env.step(state, jnp.zeros(1, dtype=jnp.int32))
    assert float(ts.reward[0]) == 1.0
    assert float(state2.team_score) == 1.0
    # Waypoint respawned somewhere else.
    assert not np.allclose(np.asarray(state2.waypoint), [5.1, 5.0])
