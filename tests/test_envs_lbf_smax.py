"""LBF / SMAX / Matrax mechanics tests."""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.lbf import LevelBasedForaging
from mava_jax.envs.matrax import Matrax
from mava_jax.envs.smax import Smax


def test_lbf_coop_load_eats_and_rewards():
    env = LevelBasedForaging(
        grid_size=8, fov=8, num_agents=2, num_food=2, force_coop=True, time_limit=20
    )
    state, ts = env.reset(jax.random.PRNGKey(0))
    state = state.replace(
        agent_pos=jnp.array([[3, 3], [3, 5]], dtype=jnp.int32),
        food_pos=jnp.array([[3, 4], [7, 7]], dtype=jnp.int32),
        food_eaten=jnp.array([False, True]),
        agent_level=jnp.array([1, 1], dtype=jnp.int32),
        food_level=jnp.array([2, 2], dtype=jnp.int32),
        total_food_level=jnp.float32(4.0),
    )
    s2, ts2 = env.step(state, jnp.array([5, 5], dtype=jnp.int32))
    assert bool(s2.food_eaten[0])
    np.testing.assert_allclose(np.asarray(ts2.reward), [0.5, 0.5])
    assert bool(ts2.last())  # all food eaten -> termination

    # A single level-1 agent cannot eat a level-2 food.
    s3, ts3 = env.step(state, jnp.array([5, 0], dtype=jnp.int32))
    assert not bool(s3.food_eaten[0])
    np.testing.assert_allclose(np.asarray(ts3.reward), [0.0, 0.0])


def test_lbf_move_conflict_both_stay():
    env = LevelBasedForaging(grid_size=8, num_agents=2, num_food=1, time_limit=20)
    state, _ = env.reset(jax.random.PRNGKey(1))
    state = state.replace(
        agent_pos=jnp.array([[2, 2], [2, 4]], dtype=jnp.int32),
        food_pos=jnp.array([[7, 7]], dtype=jnp.int32),
    )
    # Both move toward (2, 3): right for agent 0, left for agent 1.
    s2, _ = env.step(state, jnp.array([4, 3], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(s2.agent_pos), [[2, 2], [2, 4]])


def test_lbf_obs_spec_agreement():
    env = LevelBasedForaging(grid_size=10, fov=2, num_agents=3, num_food=3)
    state, ts = jax.jit(env.reset)(jax.random.PRNGKey(2))
    spec = env.observation_spec()
    assert ts.observation.agents_view.shape == spec.agents_view.shape
    assert spec.agents_view.shape == (3, 3 * 3 + 3 * 3)


def test_smax_attack_mask_range():
    env = Smax(scenario="3s_vs_5z")
    state, ts = env.reset(jax.random.PRNGKey(0))
    # Put ally 0 (stalker, range 6) at distance 5 from enemy 0, far from others.
    pos = np.asarray(state.unit_pos).copy()
    pos[0] = [10.0, 10.0]
    pos[3] = [15.0, 10.0]  # first enemy at distance 5 < 6
    for i in range(4, 8):
        pos[i] = [30.0, 30.0]
    state = state.replace(unit_pos=jnp.asarray(pos))
    obs = env._observe(state)
    mask = np.asarray(obs.action_mask)
    assert mask[0, 5]  # attack enemy 0 legal
    assert not mask[0, 6]  # enemy 1 out of range


def test_smax_kill_and_win():
    env = Smax(scenario="3s_vs_5z", time_limit=50)
    state, ts = env.reset(jax.random.PRNGKey(0))
    # All enemies at 1 hp, in range of allies; allies focus-fire.
    hp = np.asarray(state.unit_hp).copy()
    hp[3:] = 1.0
    pos = np.asarray(state.unit_pos).copy()
    pos[:3] = [[10, 10], [10, 11], [10, 12]]
    pos[3:] = [[12, 10], [12, 11], [12, 12], [12, 13], [12, 14]]
    state = state.replace(unit_hp=jnp.asarray(hp), unit_pos=jnp.asarray(pos))
    # Ally i attacks enemy i; ally 0 also finishes later ones over steps.
    done = False
    for step_i in range(6):
        mask = np.asarray(env._observe(state).action_mask)
        acts = []
        for i in range(3):
            attack_choices = np.nonzero(mask[i, 5:])[0]
            acts.append(5 + attack_choices[0] if len(attack_choices) else 0)
        state, ts = env.step(state, jnp.asarray(acts, dtype=jnp.int32))
        if bool(ts.last()):
            done = True
            break
    assert done and bool(ts.extras["won_episode"])
    assert float(ts.reward[0]) > 0  # win bonus present


def test_smax_dead_agents_only_noop():
    env = Smax(scenario="2s3z")
    state, _ = env.reset(jax.random.PRNGKey(0))
    hp = np.asarray(state.unit_hp).copy()
    hp[0] = 0.0
    state = state.replace(unit_hp=jnp.asarray(hp))
    mask = np.asarray(env._observe(state).action_mask)
    assert mask[0, 0] and not mask[0, 1:].any()
    # Dead agent observes zeros.
    view = np.asarray(env._observe(state).agents_view)
    assert np.allclose(view[0, : 3 + 7], 0.0)


def test_matrax_climbing_payoffs():
    env = Matrax("Climbing-stateless-v0", time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    state, ts = env.step(state, jnp.array([0, 0], dtype=jnp.int32))
    np.testing.assert_allclose(np.asarray(ts.reward), [11.0, 11.0])
    state, ts = env.step(state, jnp.array([0, 1], dtype=jnp.int32))
    np.testing.assert_allclose(np.asarray(ts.reward), [-30.0, -30.0])


def test_matrax_stateful_observes_last_actions():
    env = Matrax("Penalty-25-stateful-v0", time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    state, ts = env.step(state, jnp.array([2, 1], dtype=jnp.int32))
    np.testing.assert_allclose(
        np.asarray(ts.observation.agents_view), [[2.0, 1.0], [2.0, 1.0]]
    )


def test_matrax_custom_payoff_prisoners_dilemma():
    pd = [
        [[3.0, 0.0], [5.0, 1.0]],  # agent 0: rows = own action
        [[3.0, 5.0], [0.0, 1.0]],  # agent 1: transpose view
    ]
    env = Matrax("Custom-stateless-v0", time_limit=5, payoff=pd)
    state, ts = env.reset(jax.random.PRNGKey(0))
    # Mutual cooperation.
    state, ts = env.step(state, jnp.array([0, 0], dtype=jnp.int32))
    np.testing.assert_allclose(np.asarray(ts.reward), [3.0, 3.0])
    # Agent 0 defects on a cooperator: temptation vs sucker payoff.
    state, ts = env.step(state, jnp.array([1, 0], dtype=jnp.int32))
    np.testing.assert_allclose(np.asarray(ts.reward), [5.0, 0.0])


def test_matrax_custom_payoff_validation():
    import pytest

    with pytest.raises(ValueError, match="payoff"):
        Matrax("Custom-stateless-v0")  # missing payoff
    with pytest.raises(ValueError, match="2, n_actions"):
        Matrax("Custom-stateless-v0", payoff=[[[1.0]]])  # one agent


def test_matrax_pd_scenario_via_factory():
    from mava_jax import envs as environments
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo", ["env=matrax", "env/scenario=matrax-pd"]
    )
    env, _ = environments.make(cfg)
    assert env.action_dim == 2 and env.num_agents == 2
