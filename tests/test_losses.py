"""Numerical unit tests for the PPO loss primitives (reference semantics:
`mava/systems/ppo/ff_ippo.py:162-213`)."""

import jax.numpy as jnp
import numpy as np

from mava_jax.ops import clipped_ppo_policy_loss, clipped_value_loss


def test_policy_loss_matches_hand_computation():
    log_prob = jnp.array([0.0, -1.0, -0.5])
    old_log_prob = jnp.array([-0.1, -0.9, -0.5])
    gae = jnp.array([1.0, -1.0, 0.5])
    clip_eps = 0.2

    ratio = np.exp(np.asarray(log_prob) - np.asarray(old_log_prob))
    g = np.asarray(gae)
    g = (g - g.mean()) / (g.std() + 1e-8)
    l1 = ratio * g
    l2 = np.clip(ratio, 0.8, 1.2) * g
    expected = -np.minimum(l1, l2).mean()

    got = clipped_ppo_policy_loss(log_prob, old_log_prob, gae, clip_eps)
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_policy_loss_zero_at_old_policy_mean_adv_zero():
    # ratio == 1 everywhere -> loss = -mean(normalised gae) = 0.
    log_prob = jnp.array([-0.5, -0.2, -1.0, -0.7])
    gae = jnp.array([2.0, -1.0, 0.5, -1.5])
    got = clipped_ppo_policy_loss(log_prob, log_prob, gae, 0.2)
    np.testing.assert_allclose(got, 0.0, atol=1e-6)


def test_policy_loss_clips_large_ratios():
    # A huge ratio with positive advantage must be clipped at 1 + eps.
    log_prob = jnp.array([5.0, 0.0])
    old_log_prob = jnp.array([0.0, 0.0])
    gae = jnp.array([1.0, -1.0])  # normalised -> [1, -1]
    got = clipped_ppo_policy_loss(log_prob, old_log_prob, gae, 0.2)
    # elem0: min(e^5 * 1, 1.2 * 1) = 1.2; elem1: ratio 1 -> min(-1, -1) = -1
    np.testing.assert_allclose(got, -(1.2 - 1.0) / 2, rtol=1e-5)


def test_value_loss_unclipped_region():
    value = jnp.array([1.0, 2.0])
    old_value = jnp.array([1.05, 1.95])  # within clip range of value
    targets = jnp.array([1.5, 1.5])
    got = clipped_value_loss(value, old_value, targets, clip_eps=0.2)
    # clipped value == value (|delta| <= eps) -> plain 0.5 * mse
    expected = 0.5 * np.mean((np.array([1.0, 2.0]) - np.array([1.5, 1.5])) ** 2)
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_value_loss_takes_max_of_clipped_and_unclipped():
    value = jnp.array([2.0])  # moved far from old value
    old_value = jnp.array([0.0])
    targets = jnp.array([0.0])
    got = clipped_value_loss(value, old_value, targets, clip_eps=0.2)
    # unclipped: (2-0)^2 = 4; clipped value = 0.2 -> (0.2)^2 = 0.04; max = 4
    np.testing.assert_allclose(got, 0.5 * 4.0, rtol=1e-6)


def test_entropy_coefficient_schedule():
    """ent_coef_final anneals linearly on the Adam step count; default is constant."""
    import optax
    from types import SimpleNamespace

    from mava_jax.utils.config import Config
    from mava_jax.utils.training import entropy_coefficient, make_optimizer

    system = Config(
        {
            "ent_coef": 0.05,
            "ent_coef_final": 0.0,
            "ppo_epochs": 2,
            "num_minibatches": 2,
            "num_updates": 5,  # -> 20 total minibatch updates
        }
    )
    cfg = SimpleNamespace(system=system)

    opt = make_optimizer(1e-3, max_grad_norm=0.5)
    params = {"w": jnp.zeros(3)}
    state = opt.init(params)

    np.testing.assert_allclose(entropy_coefficient(cfg, state), 0.05)
    for _ in range(10):  # half the run
        _, state = opt.update({"w": jnp.ones(3)}, state, params)
    np.testing.assert_allclose(entropy_coefficient(cfg, state), 0.025, rtol=1e-6)
    for _ in range(20):  # past the end: clamps at final
        _, state = opt.update({"w": jnp.ones(3)}, state, params)
    np.testing.assert_allclose(entropy_coefficient(cfg, state), 0.0, atol=1e-9)

    # Default (ent_coef_final unset) stays the plain constant.
    system_const = Config({"ent_coef": 0.01, "ppo_epochs": 2, "num_minibatches": 2, "num_updates": 5})
    assert entropy_coefficient(SimpleNamespace(system=system_const), state) == 0.01


def test_entropy_coefficient_with_decayed_adam_opt_state():
    """Regression: with decay_learning_rates the actor optimizer is
    adam(schedule), whose chain carries TWO 'count' leaves; entropy_coefficient
    must read the step anyway instead of raising on the ambiguity."""
    import jax.numpy as jnp
    import optax

    from mava_jax.utils.config import Config
    from mava_jax.utils.training import (
        entropy_coefficient,
        make_learning_rate,
        make_optimizer,
    )

    cfg = Config.from_dict(
        {
            "system": {
                "ppo_epochs": 1,
                "num_minibatches": 1,
                "num_updates": 10,
                "decay_learning_rates": True,
                "ent_coef": 0.02,
                "ent_coef_final": 0.002,
            }
        }
    )
    optim = make_optimizer(make_learning_rate(3e-4, cfg), 0.5)
    params = {"w": jnp.zeros(3)}
    state = optim.init(params)
    assert abs(float(entropy_coefficient(cfg, state)) - 0.02) < 1e-7
    for _ in range(5):
        u, state = optim.update({"w": jnp.ones(3)}, state, params)
        params = optax.apply_updates(params, u)
    mid = float(entropy_coefficient(cfg, state))
    assert 0.002 < mid < 0.02  # halfway through the anneal
