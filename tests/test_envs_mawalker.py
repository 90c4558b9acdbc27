"""MaWalker biped correctness.

The walker reuses MaCheetah's tree-kinematics/contact machinery (itself pinned
by `test_envs_macheetah.py`); these tests pin what is NEW in the subclass: the
biped topology (two identical legs branching from the torso BOTTOM end, feet
folded flat), Walker2d-v4 reward/termination semantics (healthy bonus, fall ->
discount 0), instability of the passive/naive-PD body, and that a simple
pitch-feedback balance controller CAN survive the full horizon — i.e. the
balance problem is hard but solvable inside the action space.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.mawalker import _WALKER_TOPOLOGY, MaWalker


def test_biped_branching_kinematics():
    """Straight pose: torso hangs DOWN from the base, both thighs anchor at the
    torso's far (bottom) end, legs continue straight down, feet fold flat."""
    env = MaWalker()
    q = jnp.zeros(9).at[2].set(env.TORSO_REST)
    starts, steps, phi = env._frames(q)

    down = -np.pi / 2
    np.testing.assert_allclose(phi[:3], down, atol=1e-6)  # torso, rthigh, rshin
    np.testing.assert_allclose(phi[3], 0.0, atol=1e-6)  # rfoot flat
    np.testing.assert_allclose(phi[4:6], down, atol=1e-6)  # lthigh, lshin
    np.testing.assert_allclose(phi[6], 0.0, atol=1e-6)  # lfoot flat

    torso_end = jnp.array([0.0, -_WALKER_TOPOLOGY[0][3]])
    np.testing.assert_allclose(starts[1], torso_end, atol=1e-6)
    np.testing.assert_allclose(starts[4], torso_end, atol=1e-6)  # SAME anchor


def test_reset_stands_feet_on_ground():
    env = MaWalker()
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert float(env._body_frame(state.q)[0][0, 1]) > 1.0  # torso high
    assert abs(float(jnp.min(env._contact_points(state.q)[:, 1]))) < 0.02
    assert ts.observation.agents_view.shape == (2, env.num_obs_features)
    assert env.action_spec().shape == (2, 3)


def test_healthy_bonus_in_reward():
    """A near-static standing step earns ~the alive bonus (forward ~ 0)."""
    env = MaWalker()
    state, _ = env.reset(jax.random.PRNGKey(0))
    _, ts = env.step(state, jnp.zeros((2, 3)))
    np.testing.assert_allclose(ts.reward, ts.reward[0])  # cooperative
    assert 0.5 < float(ts.reward[0]) < 1.5  # HEALTHY_BONUS = 1.0 dominates


def test_passive_walker_falls_and_terminates():
    """Zero torque: the biped topples within ~1.5s and the healthy-state check
    TERMINATES (discount 0) — unlike MaCheetah which never terminates."""
    env = MaWalker(time_limit=1_000)
    state, _ = env.reset(jax.random.PRNGKey(0))
    step = jax.jit(env.step)
    for i in range(200):
        state, ts = step(state, jnp.zeros((2, 3)))
        if bool(ts.last()):
            break
    assert bool(ts.last()), "walker never fell"
    assert i < 120
    np.testing.assert_allclose(np.asarray(ts.discount), 0.0)


def test_pitch_feedback_controller_survives_horizon():
    """A hand-tuned pitch-feedback balance law (hip + ankle strategy) keeps the
    walker healthy through the full 250-step horizon and ends in truncation
    (discount 1): balancing is learnable within the torque limits."""
    env = MaWalker()
    state, _ = env.reset(jax.random.PRNGKey(2))

    @jax.jit
    def ctrl(s):
        pitch = jnp.arctan2(
            jnp.sin(s.q[2] - env.TORSO_REST), jnp.cos(s.q[2] - env.TORSO_REST)
        )
        a = -3.0 * s.q[3:] - 0.8 * s.qd[3:]
        a = a.at[jnp.array([0, 3])].add(4.0 * pitch + 0.8 * s.qd[2])
        a = a.at[jnp.array([2, 5])].add(2.5 * pitch + 0.24 * s.qd[2])
        return jnp.clip(a.reshape(2, 3), -1.0, 1.0)

    step = jax.jit(env.step)
    for i in range(250):
        state, ts = step(state, ctrl(state))
        if bool(ts.last()):
            break
    assert i == 249, f"balance controller fell at step {i}"
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)  # truncation


def test_vmapped_rollout_runs():
    env = MaWalker(time_limit=10)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    states, _ = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    for _ in range(3):
        states, ts = step(states, jnp.zeros((8, 2, 3)))
    assert ts.reward.shape == (8, 2)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
