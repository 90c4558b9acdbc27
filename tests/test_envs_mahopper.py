"""MaHopper contact-locomotion correctness.

The env adds the two physics features the other continuous envs don't have —
gravity and compliant ground contact — plus failure-state termination. These
tests pin them against closed-form invariants: ballistic center-of-mass flight
under gravity, total-energy conservation in flight, impenetrability/settling of
the penalty contact, and the MuJoCo-hopper termination/truncation semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.mahopper import _DT, _GRAVITY, MaHopper, MaHopperState


def _airborne(env, dy=3.0):
    """A state lifted well above the ground (no contact active)."""
    state, _ = env.reset(jax.random.PRNGKey(0))
    return state.replace(q=state.q.at[1].add(dy))


def test_ballistic_com_parabola():
    """In flight with zero torque and no joint damping, internal forces cannot
    move the center of mass: it must follow the closed-form parabola exactly
    (this pins gravity's entry into the Euler-Lagrange right-hand side)."""
    env = MaHopper(joint_damping=0.0)
    state = _airborne(env)
    qd0 = jnp.array([1.0, 2.0, 0.3, 0.1, -0.2, 0.05])
    com0 = env._com(state.q)
    com_v0 = jax.jvp(env._com, (state.q,), (qd0,))[1]

    steps = 10
    q, qd = state.q, qd0
    for _ in range(steps):
        q, qd = env._integrate(q, qd, jnp.zeros(6))

    t = steps * _DT
    predicted = com0 + com_v0 * t + jnp.array([0.0, -0.5 * _GRAVITY * t**2])
    np.testing.assert_allclose(env._com(q), predicted, atol=1e-5)


def test_energy_conserved_in_flight():
    """Kinetic + gravitational potential is an invariant of the undamped
    airborne dynamics; RK4 at the chosen substep must hold it."""
    env = MaHopper(joint_damping=0.0)
    state = _airborne(env)
    qd0 = jnp.array([0.5, 1.0, 0.4, 0.8, -0.6, 0.3])
    e0 = float(env._kinetic(state.q, qd0) + env._potential(state.q))

    q, qd = state.q, qd0
    for _ in range(20):
        q, qd = env._integrate(q, qd, jnp.zeros(6))
    e1 = float(env._kinetic(q, qd) + env._potential(q))
    assert abs(e1 - e0) / abs(e0) < 1e-4


def test_drop_settles_without_tunneling():
    """Dropped from a metre up with zero torque: the penalty contact must stop
    the fall (bounded penetration at impact, no tunneling) and dissipate the
    energy (the body comes to rest on the ground)."""
    env = MaHopper(time_limit=100_000)
    state, _ = env.reset(jax.random.PRNGKey(1))
    state = MaHopperState(
        key=state.key,
        step_count=state.step_count,
        q=state.q.at[1].add(1.0),
        qd=jnp.zeros(6),
    )

    @jax.jit
    def run(s):
        def body(carry, _):
            s, min_y = carry
            s, _ = env.step(s, jnp.zeros((3, 1)))
            min_y = jnp.minimum(min_y, jnp.min(env._contact_points(s.q)[:, 1]))
            return (s, min_y), None

        return jax.lax.scan(body, (s, jnp.inf), None, 400)[0]

    s, min_y = run(state)
    assert float(min_y) > -0.08  # impact penetration bounded, no tunneling
    assert float(env._kinetic(s.q, s.qd)) < 0.01  # settled
    assert float(jnp.min(env._contact_points(s.q)[:, 1])) > -0.02  # resting on top


def test_unactuated_hopper_falls_and_terminates():
    """Zero torque from the standing start: gravity must topple the body and
    the healthy-state check must TERMINATE the episode (discount 0), unlike the
    swimmer/reacher tasks which only truncate."""
    env = MaHopper(time_limit=1_000)
    state, _ = env.reset(jax.random.PRNGKey(2))
    step = jax.jit(env.step)
    for i in range(200):
        state, ts = step(state, jnp.zeros((3, 1)))
        if bool(ts.last()):
            break
    assert bool(ts.last()), "hopper never fell"
    assert i < 150
    np.testing.assert_allclose(np.asarray(ts.discount), 0.0)  # termination


def test_standing_near_static_at_start():
    """The reset pose is in near-static contact equilibrium for a few steps:
    the initial observation distribution is not an impact transient."""
    env = MaHopper()
    state, _ = env.reset(jax.random.PRNGKey(3))
    h0 = float(env._torso_height(state.q))
    for _ in range(3):
        state, ts = env.step(state, jnp.zeros((3, 1)))
    assert abs(float(env._torso_height(state.q)) - h0) < 0.05
    assert not bool(ts.last())


def test_api_shapes_team_reward_and_truncation():
    env = MaHopper(num_agents=3, joints_per_agent=1, time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.agents_view.shape == (3, env.num_obs_features)
    assert env.action_spec().shape == (3, 1)

    action = jnp.ones((3, 1)) * 0.1
    state, ts = env.step(state, action)
    assert ts.reward.shape == (3,)
    np.testing.assert_allclose(ts.reward, ts.reward[0])  # cooperative

    for _ in range(4):
        state, ts = env.step(state, action)
    assert bool(ts.last())
    # Still healthy at the 5-step horizon -> truncation, discount 1.
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)


def test_vmapped_rollout_runs():
    env = MaHopper(time_limit=10)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    states, _ = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    for _ in range(3):
        states, ts = step(states, jnp.zeros((8, 3, 1)))
    assert ts.reward.shape == (8, 3)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
