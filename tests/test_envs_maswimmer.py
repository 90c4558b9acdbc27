"""MaSwimmer free-floating locomotion correctness.

The env derives its equations of motion (including the anisotropic fluid drag,
via a Rayleigh dissipation function) from the kinematics by autodiff; these
tests pin the physics against invariants a hand-rolled integrator would break:
conservation laws with dissipation off, the scallop theorem with isotropic
drag, and net thrust from a traveling-wave gait with anisotropic drag.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.maswimmer import _DT, MaSwimmer


@functools.partial(jax.jit, static_argnums=(0, 3))
def _free_drift(env, q, qd, steps):
    def body(carry, _):
        q, qd = carry
        return env._integrate(q, qd, jnp.zeros_like(q)), None

    return jax.lax.scan(body, (q, qd), None, steps)[0]


def _gait_displacement(env, steps=300, amp=1.0, omega=6.0, beta=-1.5):
    """Net center-of-mass x-displacement of an open-loop traveling-wave gait."""
    state, _ = env.reset(jax.random.PRNGKey(1))
    state = state.replace(q=state.q.at[2:].set(0.0))  # straight +x start
    n_joints = env.num_joints

    @jax.jit
    def run(s):
        def body(s, t):
            tau_t = amp * jnp.sin(omega * t * _DT - beta * jnp.arange(n_joints))
            action = jnp.clip(tau_t, -1, 1).reshape(
                env.num_agents, env.joints_per_agent
            )
            s, ts = env.step(s, action)
            return s, jnp.max(jnp.abs(s.qd))

        return jax.lax.scan(body, s, jnp.arange(steps))

    end, max_speed = run(state)
    dx = float(env._com(end.q)[0] - env._com(state.q)[0])
    return dx, float(max_speed.max())


def test_energy_and_momentum_conserved_without_dissipation():
    """All dissipation off, zero torque: kinetic energy and center-of-mass
    momentum are exact invariants of the true dynamics; RK4 must hold both."""
    env = MaSwimmer(2, 1, drag_normal=0.0, drag_tangent=0.0, joint_damping=0.0)
    state, _ = env.reset(jax.random.PRNGKey(0))
    qd0 = jnp.array([0.3, -0.2, 0.5, 1.0, -0.7])
    e0 = float(env._kinetic(state.q, qd0))
    com_v0 = jax.jvp(env._com, (state.q,), (qd0,))[1]

    q, qd = _free_drift(env, state.q, qd0, 100)

    assert abs(float(env._kinetic(q, qd)) - e0) / e0 < 1e-4
    com_v1 = jax.jvp(env._com, (q,), (qd,))[1]
    np.testing.assert_allclose(com_v1, com_v0, atol=1e-5)


def test_isotropic_drag_cannot_swim():
    """Scallop theorem check: with isotropic drag the COM momentum equation is
    closed (M dV/dt = -c L V, V(0)=0), so NO gait can move the center of mass.
    This also guards the integration: a velocity clip or integrator error acts
    as an external impulse and showed up here as spurious swimming."""
    env = MaSwimmer(2, 1, drag_normal=2.0, drag_tangent=2.0)
    dx, _ = _gait_displacement(env)
    assert abs(dx) < 1e-3


def test_anisotropic_drag_swims():
    """The same traveling-wave gait with the default anisotropic drag produces
    order-1 net displacement — the env's entire learning signal."""
    env = MaSwimmer(2, 1)
    dx, max_speed = _gait_displacement(env)
    assert dx > 0.5
    assert max_speed < 10.0  # joint damping bounds speeds far below the clip


def test_many_link_chain_is_stable():
    """swimmer-4x2 (9 links): rod inertias shrink as 1/L^3 and without armature
    the joint dynamics are stiffer than RK4's stability region — this pins the
    armature fix. Random bang-bang torques are the worst case."""
    env = MaSwimmer(4, 2)
    state, _ = env.reset(jax.random.PRNGKey(2))

    @jax.jit
    def run(state, key):
        def body(carry, _):
            s, key = carry
            key, k = jax.random.split(key)
            action = jax.random.uniform(k, (4, 2), minval=-1.0, maxval=1.0)
            s, _ = env.step(s, action)
            return (s, key), jnp.max(jnp.abs(s.qd))

        (state, _), max_speed = jax.lax.scan(body, (state, key), None, 300)
        return state, max_speed.max()

    state, max_speed = run(state, jax.random.PRNGKey(3))
    assert float(max_speed) < 10.0
    assert bool(jnp.all(jnp.isfinite(state.q)))


def test_api_shapes_team_reward_and_truncation():
    env = MaSwimmer(num_agents=4, joints_per_agent=2, time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    assert ts.observation.agents_view.shape == (4, env.num_obs_features)
    assert env.action_spec().shape == (4, 2)

    action = jnp.ones((4, 2)) * 0.3
    state, ts = env.step(state, action)
    assert ts.reward.shape == (4,)
    np.testing.assert_allclose(ts.reward, ts.reward[0])  # cooperative

    for _ in range(4):
        state, ts = env.step(state, action)
    assert bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)  # truncation


def test_vmapped_rollout_runs():
    env = MaSwimmer(2, 1, time_limit=10)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    states, _ = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    for _ in range(3):
        states, ts = step(states, jnp.zeros((8, 2, 1)))
    assert ts.reward.shape == (8, 2)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
