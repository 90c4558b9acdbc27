"""Deeper mechanic tests for the rewritten (scatter-free) env steps."""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.rware import FORWARD, NOOP, TOGGLE, RobotWarehouse
from mava_jax.envs.smax import Smax


def test_rware_carried_shelf_travels_with_agent():
    env = RobotWarehouse(time_limit=50)
    state, _ = env.reset(jax.random.PRNGKey(0))
    # Agent 0 carries shelf 0, stands on a highway cell facing right with free cell.
    shelf0 = np.asarray(state.shelf_pos)[0]
    state = state.replace(
        agent_pos=jnp.array([[0, 0], [5, 0]], dtype=jnp.int32),
        agent_dir=jnp.array([1, 1], dtype=jnp.int32),  # right
        agent_carrying=jnp.array([0, -1], dtype=jnp.int32),
        shelf_pos=state.shelf_pos.at[0].set(jnp.array([0, 0], dtype=jnp.int32)),
    )
    state2, _ = env.step(state, jnp.array([FORWARD, NOOP], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(state2.agent_pos[0]), [0, 1])
    np.testing.assert_array_equal(np.asarray(state2.shelf_pos[0]), [0, 1])
    # Other shelves unmoved.
    np.testing.assert_array_equal(
        np.asarray(state2.shelf_pos[1:]), np.asarray(state.shelf_pos[1:])
    )
    del shelf0


def test_rware_pickup_and_drop():
    env = RobotWarehouse(time_limit=50)
    state, _ = env.reset(jax.random.PRNGKey(1))
    shelf0 = jnp.asarray(np.asarray(state.shelf_pos)[0])
    # Unloaded agent standing under shelf 0 toggles -> picks it up.
    state = state.replace(
        agent_pos=jnp.stack([shelf0, jnp.array([0, 0], dtype=jnp.int32)]),
        agent_carrying=jnp.array([-1, -1], dtype=jnp.int32),
    )
    state2, _ = env.step(state, jnp.array([TOGGLE, NOOP], dtype=jnp.int32))
    assert int(state2.agent_carrying[0]) == 0
    # Toggling again on the storage cell drops it.
    state3, _ = env.step(state2, jnp.array([TOGGLE, NOOP], dtype=jnp.int32))
    assert int(state3.agent_carrying[0]) == -1


def test_rware_carrying_blocked_by_occupied_storage():
    env = RobotWarehouse(time_limit=50)
    state, _ = env.reset(jax.random.PRNGKey(2))
    # Shelf 0 at [1,1] (storage); agent carrying shelf 1 at [1,0] facing right must
    # NOT be able to move into the occupied storage cell.
    state = state.replace(
        agent_pos=jnp.array([[1, 0], [9, 9]], dtype=jnp.int32),
        agent_dir=jnp.array([1, 0], dtype=jnp.int32),
        agent_carrying=jnp.array([1, -1], dtype=jnp.int32),
        shelf_pos=state.shelf_pos.at[0]
        .set(jnp.array([1, 1], dtype=jnp.int32))
        .at[1]
        .set(jnp.array([1, 0], dtype=jnp.int32)),
    )
    mask = env._observe(state).action_mask
    assert not bool(mask[0, FORWARD])
    state2, _ = env.step(state, jnp.array([FORWARD, NOOP], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(state2.agent_pos[0]), [1, 0])
    # Unloaded agents CAN pass under shelves.
    state = state.replace(agent_carrying=jnp.array([-1, -1], dtype=jnp.int32))
    mask = env._observe(state).action_mask
    assert bool(mask[0, FORWARD])


def test_smax_attack_requires_range_and_deals_dps():
    env = Smax(scenario="2s3z")
    state, _ = env.reset(jax.random.PRNGKey(0))
    a = env.num_agents
    # Put ally 0 (stalker, atk range 6, dps 10) right next to enemy 0; everyone else
    # far away in a corner so the scripted enemies can't retaliate within one step.
    pos = np.full((env.num_units, 2), 30.0, dtype=np.float32)
    pos[0] = [5.0, 5.0]
    pos[a] = [6.0, 5.0]  # within range
    state = state.replace(unit_pos=jnp.asarray(pos))
    hp_before = float(state.unit_hp[a])

    action = jnp.zeros(a, dtype=jnp.int32).at[0].set(5 + 0)  # attack enemy 0
    state2, ts = env.step(state, action)
    dps = float(np.asarray(env._stats)[int(state.unit_types[0]), 1])
    assert float(state2.unit_hp[a]) == hp_before - dps
    assert float(ts.reward[0]) > 0.0  # damage reward

    # Out of range: no damage.
    pos[a] = [25.0, 5.0]
    state = state.replace(unit_pos=jnp.asarray(pos))
    state3, ts3 = env.step(state, action)
    assert float(state3.unit_hp[a]) == hp_before


def test_smax_damage_accumulates_from_multiple_attackers():
    env = Smax(scenario="2s3z")
    state, _ = env.reset(jax.random.PRNGKey(1))
    a = env.num_agents
    pos = np.full((env.num_units, 2), 30.0, dtype=np.float32)
    pos[0] = [5.0, 5.0]
    pos[1] = [7.0, 5.0]
    pos[a] = [6.0, 5.0]  # enemy between both stalkers
    state = state.replace(unit_pos=jnp.asarray(pos))
    hp_before = float(state.unit_hp[a])

    action = jnp.zeros(a, dtype=jnp.int32)
    action = action.at[0].set(5).at[1].set(5)  # both attack enemy 0
    state2, _ = env.step(state, action)
    stats = np.asarray(env._stats)
    expected = (
        stats[int(state.unit_types[0]), 1] + stats[int(state.unit_types[1]), 1]
    )
    assert float(state2.unit_hp[a]) == hp_before - expected


def test_rware_reset_positions_distinct():
    env = RobotWarehouse()
    for seed in range(5):
        state, _ = env.reset(jax.random.PRNGKey(seed))
        flat = np.asarray(state.agent_pos[:, 0] * env.width + state.agent_pos[:, 1])
        assert len(set(flat.tolist())) == env.num_agents
        assert int(jnp.sum(state.shelf_requested)) == env.request_queue_size
