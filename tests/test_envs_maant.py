"""MaAnt 3D point-cloud Lagrangian correctness.

The planar envs pin the autodiff-Lagrangian machinery in 2D; these tests pin
what is NEW in 3D: the roll-pitch-yaw kinematics against hand-computed poses,
conservation laws of the 14-DOF free-flying body (COM parabola, energy), a
positive-definite mass matrix including at large tilt (the Euler-armature
regularization), Ant-v4 health semantics (passive body STANDS healthy; a
flipped body terminates with discount 0), and MaBrax-style factorization
reshapes (4x2 / 2x4 / 8x1).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.maant import (
    _DT,
    _GRAVITY,
    _LOWER_LEN,
    _TORSO_RADIUS,
    _UPPER_LEN,
    MaAnt,
    _rpy_matrix,
)


def _ballistic(env, q0, qd0, steps):
    @jax.jit
    def run(q, qd):
        def body(carry, _):
            q, qd = carry
            return env._integrate(q, qd, jnp.zeros(14)), None

        return jax.lax.scan(body, (q, qd), None, steps)[0]

    return run(q0, qd0)


def test_rpy_matrix_axes():
    """Pure yaw spins x into y; pure roll spins y into z; identity at zero."""
    np.testing.assert_allclose(_rpy_matrix(jnp.zeros(3)), np.eye(3), atol=1e-7)
    yaw90 = _rpy_matrix(jnp.array([0.0, 0.0, np.pi / 2]))
    np.testing.assert_allclose(yaw90 @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-7)
    roll90 = _rpy_matrix(jnp.array([np.pi / 2, 0.0, 0.0]))
    np.testing.assert_allclose(roll90 @ np.array([0, 1.0, 0]), [0, 0, 1], atol=1e-7)


def test_leg_kinematics_hand_computed():
    """Zero joints: each knee sits UPPER_LEN beyond the attachment along its
    azimuth in the horizontal plane; each foot drops LOWER_LEN at the rest
    ankle angle below horizontal, continuing outward along the same azimuth."""
    env = MaAnt()
    attach, knee, foot = env._leg_local(jnp.zeros(8))
    for i, az in enumerate(np.asarray(env._azimuths)):
        u = np.array([np.cos(az), np.sin(az), 0.0])
        np.testing.assert_allclose(attach[i], _TORSO_RADIUS * u, atol=1e-6)
        np.testing.assert_allclose(knee[i], (_TORSO_RADIUS + _UPPER_LEN) * u, atol=1e-6)
        drop = _LOWER_LEN * np.array(
            [np.cos(1.0) * u[0], np.cos(1.0) * u[1], -np.sin(1.0)]
        )
        np.testing.assert_allclose(foot[i], np.asarray(knee[i]) + drop, atol=1e-5)


def test_hip_swings_in_horizontal_plane():
    """A hip rotation moves the knee at constant height and constant distance
    from the attachment (rotation about the torso z-axis)."""
    env = MaAnt()
    a0, k0, _ = env._leg_local(jnp.zeros(8))
    alpha = jnp.zeros(8).at[0].set(0.5)  # front-left hip
    a1, k1, _ = env._leg_local(alpha)
    np.testing.assert_allclose(k1[0, 2], k0[0, 2], atol=1e-6)  # same height
    np.testing.assert_allclose(
        jnp.linalg.norm(k1[0] - a1[0]), jnp.linalg.norm(k0[0] - a0[0]), atol=1e-6
    )
    assert abs(float(k1[0, 0] - k0[0, 0])) > 0.01  # it did move


def test_ballistic_com_parabola_3d():
    """In flight, internal forces cannot move the center of mass: it follows
    the 3D parabola exactly (gravity enters only through -dV/dq)."""
    env = MaAnt(joint_damping=0.0)
    state, _ = env.reset(jax.random.PRNGKey(0))
    q0 = state.q.at[2].add(3.0)
    qd0 = jnp.array(
        [1.0, 0.5, 2.0, 0.3, -0.2, 0.4, 0.2, -0.1, 0.15, 0.05, -0.3, 0.1, 0.2, -0.25]
    )
    com0 = env._com(q0)
    com_v0 = jax.jvp(env._com, (q0,), (qd0,))[1]
    e0 = float(env._kinetic(q0, qd0) + env._potential(q0))

    steps = 10
    q, qd = _ballistic(env, q0, qd0, steps)
    t = steps * _DT
    predicted = com0 + com_v0 * t + jnp.array([0.0, 0.0, -0.5 * _GRAVITY * t**2])
    np.testing.assert_allclose(env._com(q), predicted, atol=1e-5)
    e1 = float(env._kinetic(q, qd) + env._potential(q))
    assert abs(e1 - e0) / abs(e0) < 1e-4  # energy conserved through RK4


def test_newton_accel_matches_lagrangian():
    """The production Newton-d'Alembert accel (pointcloud3d.newton_accel) must
    equal the Euler-Lagrange reference built from the energies by autodiff —
    the two are algebraically identical for point-cloud bodies + armature."""
    env = MaAnt()
    state, _ = env.reset(jax.random.PRNGKey(5))
    q = state.q.at[2].add(0.3)  # some contact, some flight
    qd = 0.5 * jax.random.normal(jax.random.PRNGKey(6), (14,))
    tau = 0.7 * jax.random.normal(jax.random.PRNGKey(8), (14,))

    got = env._accel(q, qd, tau)

    # reference path: hessian mass matrix + Coriolis/energy gradients
    M = jax.hessian(env._kinetic, argnums=1)(q, jnp.zeros_like(q))
    momentum = lambda q_: jax.grad(env._kinetic, argnums=1)(q_, qd)
    coriolis = jax.jacfwd(momentum)(q) @ qd
    dT_dq = jax.grad(env._kinetic, argnums=0)(q, qd)
    dV_dq = jax.grad(env._potential)(q)
    damping = -env.joint_damping * jnp.concatenate([jnp.zeros(6), qd[6:]])
    alpha, alpha_d = q[6:], qd[6:]
    excess = jnp.maximum(alpha - env._joint_hi, 0.0) + jnp.minimum(
        alpha - env._joint_lo, 0.0
    )
    limit_tau = -200.0 * excess - 5.0 * alpha_d * (excess != 0.0)
    limits = jnp.concatenate([jnp.zeros(6), limit_tau])
    rhs = tau + env._contact_force(q, qd) + damping + limits - coriolis + dT_dq - dV_dq
    want = jnp.linalg.solve(M, rhs)

    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mass_matrix_positive_definite_even_tilted():
    """M(q) must stay positive definite everywhere a dead body can tumble —
    including near the pitch = pi/2 Euler singularity, where the rotational
    armature provides the floor."""
    env = MaAnt()
    state, _ = env.reset(jax.random.PRNGKey(0))
    for pitch in [0.0, 1.0, np.pi / 2, 2.5]:
        q = state.q.at[4].set(pitch)
        w = np.linalg.eigvalsh(np.asarray(env.mass_matrix(q)))
        assert w.min() > 1e-3, f"M not PD at pitch={pitch}: {w.min()}"


def test_passive_ant_stands_healthy():
    """Zero torque: the body settles onto its joint limits and STAYS healthy
    (the MuJoCo-ant passive equilibrium) — survival is the easy part here."""
    env = MaAnt()
    state, _ = env.reset(jax.random.PRNGKey(1))

    @jax.jit
    def run(s):
        def body(carry, _):
            s, min_disc = carry
            s, ts = env.step(s, jnp.zeros((4, 2)))
            return (s, jnp.minimum(min_disc, ts.discount[0])), None

        return jax.lax.scan(body, (s, jnp.inf), None, 150)[0]

    s, min_disc = run(state)
    assert float(min_disc) == 1.0  # never terminated
    assert 0.25 < float(s.q[2]) < 0.6  # settled standing, not collapsed
    assert float(env._kinetic(s.q, s.qd)) < 0.5
    assert float(jnp.min(env._contact_points(s.q)[:, 2])) > -0.02  # no tunneling


def test_flipped_ant_terminates():
    env = MaAnt()
    state, _ = env.reset(jax.random.PRNGKey(2))
    state = state.replace(q=state.q.at[3].set(1.5))  # rolled past max_tilt
    _, ts = env.step(state, jnp.zeros((4, 2)))
    assert bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.discount), 0.0)


def test_open_loop_gait_locomotes():
    """A phase-wave gait around the four legs must carry the body order-1
    metres while staying healthy: the dynamics support real locomotion
    (steering it FORWARD is the part left to learning)."""
    env = MaAnt()
    state, _ = env.reset(jax.random.PRNGKey(2))
    pi = np.pi
    hip_ph = jnp.array([0.0, pi / 2, pi, 3 * pi / 2])

    @jax.jit
    def run(s):
        def body(carry, t):
            s, min_disc = carry
            w = 2 * pi * 1.5 * t * _DT
            hip = 0.5 * jnp.sin(w + hip_ph)
            ank = 0.7 * jnp.sin(w + hip_ph + pi / 2)
            s, ts = env.step(s, jnp.stack([hip, ank], axis=-1))
            return (s, jnp.minimum(min_disc, ts.discount[0])), None

        return jax.lax.scan(body, (s, jnp.inf), jnp.arange(250))[0]

    s, min_disc = run(state)
    assert float(min_disc) == 1.0  # stayed healthy throughout
    assert float(jnp.linalg.norm(s.q[:2])) > 1.0  # travelled
    assert bool(jnp.all(jnp.isfinite(s.q)))


def test_api_shapes_team_reward_and_truncation():
    env = MaAnt(time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.agents_view.shape == (4, env.num_obs_features)
    assert env.action_spec().shape == (4, 2)

    action = jnp.ones((4, 2)) * 0.1
    state, ts = env.step(state, action)
    assert ts.reward.shape == (4,)
    np.testing.assert_allclose(ts.reward, ts.reward[0])  # cooperative

    for _ in range(4):
        state, ts = env.step(state, action)
    assert bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)  # truncation


def test_factorizations_reshape():
    """ant_2x4 (front/back halves) and ant_8x1 are reshapes of one joint order."""
    for a, jpa in [(2, 4), (8, 1)]:
        env = MaAnt(num_agents=a, joints_per_agent=jpa)
        state, ts = env.reset(jax.random.PRNGKey(0))
        assert ts.observation.agents_view.shape == (a, env.num_obs_features)
        _, ts = env.step(state, jnp.zeros((a, jpa)))
        assert ts.reward.shape == (a,)


def test_vmapped_rollout_runs():
    env = MaAnt(time_limit=10)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    states, _ = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    for _ in range(3):
        states, ts = step(states, jnp.zeros((8, 4, 2)))
    assert ts.reward.shape == (8, 4)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
