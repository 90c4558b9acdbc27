"""MaHumanoid correctness: heterogeneous padding + deep-tree 3D kinematics.

The ant pins the 3D point-cloud machinery; these tests pin what is NEW here:
the 11-body tree with 3-DOF ball joints against hand-computed poses, the
heterogeneous 9|8 padding contract (masked column is a DYNAMICS NO-OP and
excluded from control cost), 23-DOF conservation laws in flight, and the
Humanoid-v4 health semantics (passive body falls fast and terminates; trunk
feedback measurably extends survival — the coordination signal exists).

The 23-DOF step is expensive to trace, so every test drives ONE shared
module-level jitted step (truncation is exercised by setting `step_count`
near the horizon rather than constructing a second env instance).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.envs.mahumanoid import (
    _DT,
    _GRAVITY,
    _HEAD_OFF,
    _HIP_HALF,
    _PELVIS_HALF,
    _SHIN_LEN,
    _THIGH_LEN,
    _TOE_LEN,
    _TORSO_LEN,
    MaHumanoid,
)

ENV = MaHumanoid()
STEP = jax.jit(ENV.step)


def test_tree_kinematics_hand_computed():
    """Zero pose: trunk stacks straight up (head at the known height), legs
    straight down from the hip offsets, toes TOE_LEN forward of the heels."""
    q = jnp.zeros(23)
    b = ENV._bodies(q)
    np.testing.assert_allclose(
        b["head"], [0.0, 0.0, _PELVIS_HALF + _TORSO_LEN + _HEAD_OFF], atol=1e-6
    )
    np.testing.assert_allclose(
        b["r_heel"], [0.0, -_HIP_HALF, -0.05 - _THIGH_LEN - _SHIN_LEN], atol=1e-6
    )
    np.testing.assert_allclose(
        b["l_toe"], [_TOE_LEN, _HIP_HALF, -0.05 - _THIGH_LEN - _SHIN_LEN], atol=1e-6
    )


def test_knee_bends_about_leg_y_axis():
    """Bending the right knee moves the heel forward/up, not sideways."""
    b0 = ENV._bodies(jnp.zeros(23))
    b1 = ENV._bodies(jnp.zeros(23).at[6 + 12].set(-1.0))  # right_knee
    assert abs(float(b1["r_heel"][1] - b0["r_heel"][1])) < 1e-6  # no lateral move
    assert float(b1["r_heel"][2]) > float(b0["r_heel"][2])  # heel lifts
    np.testing.assert_allclose(b1["l_heel"], b0["l_heel"], atol=1e-7)  # other leg


def test_padded_action_column_is_dynamics_noop():
    """action[1, 8] is padding: flipping it must not change the next state OR
    the reward (it is excluded from the control cost)."""
    state, _ = ENV.reset(jax.random.PRNGKey(0))
    base = jnp.full((2, 9), 0.3)
    s_a, ts_a = STEP(state, base)
    s_b, ts_b = STEP(state, base.at[1, 8].set(-1.0))
    np.testing.assert_array_equal(np.asarray(s_a.q), np.asarray(s_b.q))
    np.testing.assert_array_equal(np.asarray(ts_a.reward), np.asarray(ts_b.reward))
    # while the same flip on a REAL column does change the state
    s_c, _ = STEP(state, base.at[1, 7].set(-1.0))
    assert not np.array_equal(np.asarray(s_a.q), np.asarray(s_c.q))


def test_padding_contract_in_observation():
    _, ts = ENV.reset(jax.random.PRNGKey(0))
    obs = ts.observation
    assert obs.agents_view.shape == (2, ENV.num_obs_features)
    assert bool(obs.action_mask[0].all())
    assert bool(obs.action_mask[1, :8].all()) and not bool(obs.action_mask[1, 8])
    # padded joint slot reads (0, 0, 0), not (cos 0 = 1, ...)
    np.testing.assert_allclose(obs.agents_view[1, 8], 0.0, atol=1e-6)  # cos slot
    np.testing.assert_allclose(obs.agents_view[1, 17], 0.0, atol=1e-6)  # sin slot


def test_ballistic_com_parabola_23dof():
    env = MaHumanoid(joint_damping=0.0)
    state, _ = env.reset(jax.random.PRNGKey(0))
    q0 = state.q.at[2].add(3.0)
    qd0 = 0.4 * jax.random.normal(jax.random.PRNGKey(7), (23,))
    com0 = env._com(q0)
    com_v0 = jax.jvp(env._com, (q0,), (qd0,))[1]
    e0 = float(env._kinetic(q0, qd0) + env._potential(q0))

    @jax.jit
    def run(q, qd):
        def body(carry, _):
            q, qd = carry
            return env._integrate(q, qd, jnp.zeros(23)), None

        return jax.lax.scan(body, (q, qd), None, 10)[0]

    q, qd = run(q0, qd0)
    t = 10 * _DT
    predicted = com0 + com_v0 * t + jnp.array([0.0, 0.0, -0.5 * _GRAVITY * t**2])
    np.testing.assert_allclose(env._com(q), predicted, atol=1e-5)
    e1 = float(env._kinetic(q, qd) + env._potential(q))
    assert abs(e1 - e0) / abs(e0) < 1e-4


def test_mass_matrix_positive_definite_tilted():
    state, _ = ENV.reset(jax.random.PRNGKey(0))
    mm = jax.jit(ENV.mass_matrix)
    for pitch in [0.0, np.pi / 2, 2.0]:
        w = np.linalg.eigvalsh(np.asarray(mm(state.q.at[4].set(pitch))))
        assert w.min() > 1e-3, f"M not PD at pitch={pitch}"


def _run_until_done(state, ctrl, max_steps=250):
    for i in range(max_steps):
        state, ts = STEP(state, ctrl(state))
        if bool(ts.last()):
            break
    return i + 1, ts


def test_passive_humanoid_falls_and_terminates():
    """Zero torque: the biped collapses in under ~1.6 s and TERMINATES with
    discount 0 — the alive bonus must be EARNED, unlike MaAnt."""
    state, _ = ENV.reset(jax.random.PRNGKey(3))
    n, ts = _run_until_done(state, lambda s: jnp.zeros((2, 9)))
    assert bool(ts.last()), "humanoid never fell"
    assert n < 80
    np.testing.assert_allclose(np.asarray(ts.discount), 0.0)


def test_trunk_feedback_extends_survival():
    """PD to the rest pose + trunk-tilt feedback into hips/abdomen keeps the
    body up at least 1.5x longer than passive: a coordination gradient exists
    for learning to climb."""
    state, _ = ENV.reset(jax.random.PRNGKey(3))
    passive, _ = _run_until_done(state, lambda s: jnp.zeros((2, 9)))

    @jax.jit
    def fb(s):
        a17 = -3.0 * s.q[6:] - 0.8 * s.qd[6:]
        pitch, roll = s.q[4], s.q[3]
        a17 = a17.at[jnp.array([11, 15])].add(5.0 * (pitch + 0.3 * s.qd[4]))
        a17 = a17.at[jnp.array([9, 13])].add(-5.0 * (roll + 0.3 * s.qd[3]))
        a17 = a17.at[1].add(-5.0 * (pitch + 0.3 * s.qd[4]))
        a = jnp.stack([a17[:9], jnp.concatenate([a17[9:], jnp.zeros(1)])])
        return jnp.clip(a, -1.0, 1.0)

    with_fb, _ = _run_until_done(state, fb)
    assert with_fb >= 1.5 * passive, f"fb {with_fb} vs passive {passive}"


def test_api_shapes_team_reward_and_truncation():
    state, ts = ENV.reset(jax.random.PRNGKey(0))
    assert ENV.action_spec().shape == (2, 9)
    action = jnp.ones((2, 9)) * 0.05
    state, ts = STEP(state, action)
    assert ts.reward.shape == (2,)
    np.testing.assert_allclose(ts.reward, ts.reward[0])  # cooperative
    # jump to the horizon: still healthy -> truncation, discount 1
    state = state.replace(step_count=jnp.int32(ENV.time_limit - 1))
    _, ts = STEP(state, action)
    assert bool(ts.last())
    np.testing.assert_allclose(np.asarray(ts.discount), 1.0)


def test_vmapped_rollout_runs():
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    states, _ = jax.vmap(ENV.reset)(keys)
    vstep = jax.jit(jax.vmap(ENV.step))
    for _ in range(3):
        states, ts = vstep(states, jnp.zeros((4, 2, 9)))
    assert ts.reward.shape == (4, 2)
    assert bool(jnp.all(jnp.isfinite(ts.observation.agents_view)))
