"""Numerical unit tests for the hand-rolled distributions (the reference has no such
tests; SURVEY.md §4 calls for adding them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax.distributions import (
    Categorical,
    MaskedCategorical,
    MaskedEpsGreedy,
    TanhNormal,
)


def test_categorical_log_prob_matches_log_softmax():
    logits = jnp.array([[1.0, 2.0, 0.5], [0.0, -1.0, 3.0]])
    dist = Categorical(logits)
    actions = jnp.array([1, 2])
    expected = jax.nn.log_softmax(logits)[jnp.arange(2), actions]
    np.testing.assert_allclose(dist.log_prob(actions), expected, rtol=1e-6)


def test_categorical_entropy_uniform():
    logits = jnp.zeros((4,))
    dist = Categorical(logits)
    np.testing.assert_allclose(dist.entropy(), np.log(4.0), rtol=1e-6)


def test_masked_categorical_never_samples_illegal():
    logits = jnp.array([5.0, 5.0, 5.0, 5.0])
    mask = jnp.array([True, False, True, False])
    dist = MaskedCategorical(logits, mask)
    samples = jax.vmap(lambda k: dist.sample(seed=k))(
        jax.random.split(jax.random.PRNGKey(0), 512)
    )
    assert set(np.unique(np.asarray(samples))) <= {0, 2}


def test_masked_categorical_entropy_ignores_masked():
    logits = jnp.array([1.0, 100.0, 1.0])
    mask = jnp.array([True, False, True])
    dist = MaskedCategorical(logits, mask)
    np.testing.assert_allclose(dist.entropy(), np.log(2.0), rtol=1e-5)


def test_tanh_normal_sample_in_bounds_and_log_prob_finite():
    loc = jnp.array([[0.0, 2.0], [-3.0, 0.5]])
    scale = jnp.array([[1.0, 0.5], [2.0, 1.0]])
    dist = TanhNormal(loc, scale)
    samples = dist.sample(seed=jax.random.PRNGKey(0))
    assert np.all(np.abs(np.asarray(samples)) <= 1.0)
    lp = dist.log_prob(samples)
    assert np.all(np.isfinite(np.asarray(lp)))
    # Log prob of clipped boundary actions is finite and differentiable.
    lp_edge = dist.log_prob(jnp.ones_like(loc))
    assert np.all(np.isfinite(np.asarray(lp_edge)))
    grad = jax.grad(lambda m: TanhNormal(m, scale).log_prob(jnp.ones_like(m)).sum())(loc)
    assert np.all(np.isfinite(np.asarray(grad)))


def test_tanh_normal_log_prob_matches_change_of_variables():
    # For a in (-1, 1): log p(a) = log N(atanh(a); mu, sigma) - log(1 - a^2)
    loc = jnp.array([[0.3]])
    scale = jnp.array([[0.7]])
    a = jnp.array([[0.42]])
    dist = TanhNormal(loc, scale)
    pre = np.arctanh(0.42)
    expected = (
        -0.5 * ((pre - 0.3) / 0.7) ** 2
        - 0.5 * np.log(2 * np.pi)
        - np.log(0.7)
        - np.log(1 - 0.42**2)
    )
    np.testing.assert_allclose(np.asarray(dist.log_prob(a))[0], expected, rtol=1e-5)


def test_eps_greedy_mode_is_masked_argmax():
    q = jnp.array([[1.0, 9.0, 2.0]])
    mask = jnp.array([[True, False, True]])
    dist = MaskedEpsGreedy(q, jnp.float32(0.3), mask)
    assert int(dist.mode()[0]) == 2


def test_eps_greedy_sample_distribution():
    q = jnp.array([0.0, 1.0, 0.0, 0.0])
    mask = jnp.array([True, True, True, False])
    eps = 0.5
    dist = MaskedEpsGreedy(q, jnp.float32(eps), mask)
    keys = jax.random.split(jax.random.PRNGKey(1), 8000)
    samples = np.asarray(jax.vmap(lambda k: dist.sample(seed=k))(keys))
    freqs = np.bincount(samples, minlength=4) / len(samples)
    # greedy idx 1: (1-eps) + eps/3; others legal: eps/3; illegal: 0.
    np.testing.assert_allclose(freqs[1], 0.5 + 0.5 / 3, atol=0.03)
    np.testing.assert_allclose(freqs[0], 0.5 / 3, atol=0.03)
    assert freqs[3] == 0.0


def test_sample_from_noise_matches_sample():
    """Hoisted-noise sampling must match seeded sampling exactly: categorical is
    argmax(logits + gumbel(key)) (what jax.random.categorical does), tanh-normal is
    tanh(loc + scale * normal(key))."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mava_jax.distributions import Categorical, TanhNormal

    key = jax.random.PRNGKey(7)
    logits = jax.random.normal(key, (6, 3, 5))
    d = Categorical(logits)
    np.testing.assert_array_equal(
        np.asarray(d.sample(seed=key)),
        np.asarray(d.sample_from_noise(jax.random.gumbel(key, logits.shape))),
    )

    loc = jax.random.normal(key, (6, 4))
    t = TanhNormal(loc, jnp.ones_like(loc) * 0.5)
    np.testing.assert_allclose(
        np.asarray(t.sample(seed=key)),
        np.asarray(t.sample_from_noise(jax.random.normal(key, loc.shape))),
        rtol=1e-6,
    )


def test_log_prob_from_params_matches_distribution_log_prob():
    """Deferred log_prob reconstruction (store raw_params in the rollout scan,
    recompute post-scan) must equal the distribution's own log_prob exactly."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mava_jax.distributions import MaskedCategorical, TanhNormal
    from mava_jax.networks.factory import make_log_prob_from_params

    key = jax.random.PRNGKey(11)
    logits = jax.random.normal(key, (4, 3, 6))
    mask = jax.random.bernoulli(key, 0.7, (4, 3, 6)).at[..., 0].set(True)
    d = MaskedCategorical(logits, mask)
    action = d.sample(seed=key)
    fn = make_log_prob_from_params({"type": "DiscreteActionHead"})
    np.testing.assert_array_equal(
        np.asarray(fn(d.raw_params(), action)), np.asarray(d.log_prob(action))
    )

    loc = jax.random.normal(key, (4, 5))
    scale = jnp.exp(jax.random.normal(key, (4, 5)) * 0.3)
    t = TanhNormal(loc, scale)
    a = t.sample(seed=key)
    fn = make_log_prob_from_params({"type": "ContinuousActionHead"})
    np.testing.assert_allclose(
        np.asarray(fn(t.raw_params(), a)), np.asarray(t.log_prob(a)), rtol=1e-6
    )


def test_masked_greedy_matches_eps_greedy_mode():
    """masked_greedy (the fused double-DQN target path) is exactly
    MaskedEpsGreedy.mode() — greedy masked argmax."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mava_jax.distributions import MaskedEpsGreedy, masked_greedy

    q = jax.random.normal(jax.random.PRNGKey(0), (5, 3, 7))
    mask = jax.random.bernoulli(jax.random.PRNGKey(1), 0.6, (5, 3, 7))
    # Guarantee at least one legal action everywhere.
    mask = mask.at[..., 0].set(True)
    np.testing.assert_array_equal(
        np.asarray(masked_greedy(q, mask)),
        np.asarray(MaskedEpsGreedy(q, 0.1, mask).mode()),
    )
    # The argmax never lands on an illegal action.
    greedy = np.asarray(masked_greedy(q, mask))
    legal = np.take_along_axis(np.asarray(mask), greedy[..., None], axis=-1)
    assert legal.all()
