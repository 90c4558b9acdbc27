"""MaReacher articulated-dynamics correctness.

The env derives its equations of motion from the FK via autodiff; these tests pin
them against closed-form 2-link manipulator formulas and physical invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np

import mava_jax.envs.mareacher as mr
from mava_jax.envs.mareacher import MaReacher


def test_mass_matrix_matches_closed_form_two_link():
    """For a 2-link planar arm with point masses at link ends the textbook mass
    matrix is  M11 = (m1+m2)l1² + m2 l2² + 2 m2 l1 l2 cos q2,
               M12 = M21 = m2 l2² + m2 l1 l2 cos q2,   M22 = m2 l2²."""
    env = MaReacher(num_agents=2, joints_per_agent=1)
    l1 = l2 = 0.5
    m1 = m2 = 0.5
    for q2 in [0.0, 0.7, -1.3, 2.9]:
        q = jnp.array([0.3, q2])
        M = np.asarray(env.mass_matrix(q))
        c2 = np.cos(q2)
        expected = np.array(
            [
                [
                    (m1 + m2) * l1**2 + m2 * l2**2 + 2 * m2 * l1 * l2 * c2,
                    m2 * l2**2 + m2 * l1 * l2 * c2,
                ],
                [m2 * l2**2 + m2 * l1 * l2 * c2, m2 * l2**2],
            ]
        )
        np.testing.assert_allclose(M, expected, rtol=1e-5, atol=1e-6)
        # Symmetric positive definite.
        np.testing.assert_allclose(M, M.T, atol=1e-6)
        assert np.all(np.linalg.eigvalsh(M) > 0)


def test_energy_conserved_free_double_pendulum(monkeypatch):
    """Zero torque, zero damping, gravity on: the symplectic integrator must hold
    total energy to a small drift over many steps (chaotic double pendulum)."""
    monkeypatch.setattr(mr, "_DAMPING", 0.0)
    env = MaReacher(num_agents=2, joints_per_agent=1, gravity=9.81)

    # Moderate-energy swing from near-hanging: resolvable at the env's h (the
    # high-energy chaotic whip regime needs a smaller step and never occurs in
    # the actual task, where torque<=1 and damping=0.5 keep motion tame).
    q = jnp.array([-jnp.pi / 2 + 0.6, 0.3])
    qd = jnp.array([0.0, 0.0])
    e0 = float(env._kinetic(q, qd) + env._potential(q))

    tau = jnp.zeros(2)
    integrate = jax.jit(env._integrate)
    energies = []
    for _ in range(200):  # 200 env steps x 4 RK4 substeps at h=0.0125
        q, qd = integrate(q, qd, tau)
        energies.append(float(env._kinetic(q, qd) + env._potential(q)))

    scale = max(1.0, abs(e0))
    assert max(abs(e - e0) for e in energies) / scale < 0.01


def test_accel_reduces_to_pendulum():
    """Single effective joint (lock joint 2 torque, straight arm at rest): angular
    acceleration must equal tau / I with I the straight-arm inertia."""
    env = MaReacher(num_agents=2, joints_per_agent=1)
    q = jnp.zeros(2)
    qd = jnp.zeros(2)
    tau = jnp.array([1.0, 0.0])
    qdd = np.asarray(env._accel(q, qd, tau))
    # M(0) from the closed form above; at rest, qdd = M^{-1} tau exactly.
    M = np.asarray(env.mass_matrix(q))
    np.testing.assert_allclose(qdd, np.linalg.solve(M, [1.0, 0.0]), rtol=1e-5)


def test_api_shapes_and_team_reward():
    env = MaReacher(num_agents=3, joints_per_agent=2, time_limit=5)
    key = jax.random.PRNGKey(0)
    state, ts = env.reset(key)
    assert ts.observation.agents_view.shape == (3, env.num_obs_features)
    assert env.action_spec().shape == (3, 2)

    action = jnp.ones((3, 2)) * 0.3
    state, ts = env.step(state, action)
    assert ts.reward.shape == (3,)
    # Cooperative: identical reward for every agent, and negative (distance cost).
    np.testing.assert_allclose(ts.reward, ts.reward[0])
    assert float(ts.reward[0]) < 0

    # Truncation at the time limit (LAST with discount 1 — SAC bootstraps through).
    for _ in range(4):
        state, ts = env.step(state, action)
    assert bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)


def test_vmapped_rollout_runs():
    env = MaReacher(num_agents=2, joints_per_agent=1, time_limit=10)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    states, _ = jax.vmap(env.reset)(keys)
    actions = jnp.zeros((8, 2, 1))
    step = jax.jit(jax.vmap(env.step))
    for _ in range(3):
        states, ts = step(states, actions)
    assert ts.reward.shape == (8, 2)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
