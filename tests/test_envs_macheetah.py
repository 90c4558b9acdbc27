"""MaCheetah tree-kinematics and contact-locomotion correctness.

Beyond the invariants shared with MaHopper (ballistic flight, flight-energy
conservation, impenetrability), these tests pin what is NEW here: the
path-matrix TREE kinematics (two legs branching off one torso) against a
hand-computed pose, the joint-limit bracing that keeps the body off the
ground, and that a naive open-loop trot produces net forward travel (the
env's learning signal).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.macheetah import _DT, _GRAVITY, _TOPOLOGY, MaCheetah


def test_tree_kinematics_hand_computed():
    """Straight pose (th=0, all joints 0): link angles must be the cumulative
    rest offsets along each BRANCH (back and front legs independent), and the
    front-thigh start must sit at the torso's far end while the back-thigh
    start sits at the base — the branching the serial-chain envs can't express."""
    env = MaCheetah()
    q = jnp.zeros(9)
    starts, steps, phi = env._frames(q)

    rest = {t[0]: t[4] for t in _TOPOLOGY}
    np.testing.assert_allclose(phi[0], 0.0, atol=1e-6)  # torso
    np.testing.assert_allclose(phi[1], rest["bthigh"], atol=1e-6)
    np.testing.assert_allclose(phi[3], rest["bthigh"] + rest["bshin"] + rest["bfoot"], atol=1e-6)
    np.testing.assert_allclose(phi[4], rest["fthigh"], atol=1e-6)  # NOT via back leg
    np.testing.assert_allclose(phi[6], rest["fthigh"] + rest["fshin"] + rest["ffoot"], atol=1e-6)

    np.testing.assert_allclose(starts[1], jnp.zeros(2), atol=1e-6)  # bthigh at base
    np.testing.assert_allclose(starts[4], jnp.array([1.0, 0.0]), atol=1e-6)  # fthigh at torso end
    # bshin starts where bthigh ends
    np.testing.assert_allclose(starts[2], starts[1] + steps[1], atol=1e-6)


def test_ballistic_com_parabola_and_energy():
    env = MaCheetah(joint_damping=0.0)
    state, _ = env.reset(jax.random.PRNGKey(0))
    q0 = state.q.at[1].add(3.0)
    qd0 = jnp.array([1.0, 2.0, 0.3, 0.1, -0.2, 0.05, 0.2, -0.1, 0.15])
    com0 = env._com(q0)
    com_v0 = jax.jvp(env._com, (q0,), (qd0,))[1]
    e0 = float(env._kinetic(q0, qd0) + env._potential(q0))

    steps = 10
    q, qd = q0, qd0
    for _ in range(steps):
        q, qd = env._integrate(q, qd, jnp.zeros(9))

    t = steps * _DT
    predicted = com0 + com_v0 * t + jnp.array([0.0, -0.5 * _GRAVITY * t**2])
    np.testing.assert_allclose(env._com(q), predicted, atol=1e-5)
    e1 = float(env._kinetic(q, qd) + env._potential(q))
    assert abs(e1 - e0) / abs(e0) < 1e-4


def test_passive_body_braces_on_joint_limits():
    """Zero torque: gravity folds the legs onto their range limits and the body
    comes to rest PROPPED UP (torso well off the ground), like the MuJoCo
    half-cheetah's limited joints — without limits it collapses flat."""
    env = MaCheetah()
    state, _ = env.reset(jax.random.PRNGKey(1))

    @jax.jit
    def run(s):
        def body(s, _):
            s, _ = env.step(s, jnp.zeros((6, 1)))
            return s, None

        return jax.lax.scan(body, s, None, 250)[0]

    s = run(state)
    assert float(env._kinetic(s.q, s.qd)) < 0.05  # settled
    assert float(env._body_frame(s.q)[0][0, 1]) > 0.15  # torso propped up
    assert float(jnp.min(env._contact_points(s.q)[:, 1])) > -0.02  # no tunneling


def test_open_loop_trot_travels_forward():
    """An antiphase sinusoidal leg gait must produce order-1 forward travel —
    the learning signal exists without any feedback control."""
    env = MaCheetah()
    state, _ = env.reset(jax.random.PRNGKey(2))

    @jax.jit
    def run(s):
        def body(carry, t):
            s, ret = carry
            w = 2 * jnp.pi * 2.0 * t * _DT
            a = jnp.array(
                [
                    jnp.sin(w),
                    0.5 * jnp.sin(w + 1.5),
                    0.4 * jnp.sin(w + 1.5),
                    jnp.sin(w + jnp.pi),
                    0.5 * jnp.sin(w + jnp.pi + 1.5),
                    0.4 * jnp.sin(w + jnp.pi + 1.5),
                ]
            )
            s, ts = env.step(s, a.reshape(6, 1))
            return (s, ret + ts.reward[0]), None

        return jax.lax.scan(body, (s, 0.0), jnp.arange(250))[0]

    s, ret = run(state)
    assert float(s.q[0]) > 0.5
    # The shaped return of a NAIVE gait is near zero (forward term ~ ctrl cost);
    # only guard against gross negatives — trained gaits go far positive.
    assert float(ret) > -20.0
    assert bool(jnp.all(jnp.isfinite(s.q)))


def test_api_shapes_team_reward_and_truncation():
    env = MaCheetah(time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.agents_view.shape == (6, env.num_obs_features)
    assert env.action_spec().shape == (6, 1)

    action = jnp.ones((6, 1)) * 0.1
    state, ts = env.step(state, action)
    assert ts.reward.shape == (6,)
    np.testing.assert_allclose(ts.reward, ts.reward[0])  # cooperative

    for _ in range(4):
        state, ts = env.step(state, action)
    assert bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)  # truncation only


def test_factorization_3x2():
    """halfcheetah_3x2-style split (3 agents x 2 joints) reshapes cleanly."""
    env = MaCheetah(num_agents=3, joints_per_agent=2)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.agents_view.shape == (3, env.num_obs_features)
    state, ts = env.step(state, jnp.zeros((3, 2)))
    assert ts.reward.shape == (3,)


def test_vmapped_rollout_runs():
    env = MaCheetah(time_limit=10)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    states, _ = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    for _ in range(3):
        states, ts = step(states, jnp.zeros((8, 6, 1)))
    assert ts.reward.shape == (8, 6)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
