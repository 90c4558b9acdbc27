"""Action distributions, hand-rolled on pure jax.numpy.

The reference builds these on tensorflow_probability (`mava/distributions.py:24-165`,
`mava/networks.py:116-124,164-169`); tfp/distrax are not available here, and hand-rolled
distributions trace to leaner XLA anyway. API kept identical to the reference surface:
`sample(seed)`, `log_prob(x)`, `entropy(seed)`, `mode()`.

All distributions are plain Python objects constructed and consumed inside a single
`jit` trace — they never cross a jit boundary, so they need not be pytrees.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

Array = jnp.ndarray
PRNGKey = jnp.ndarray

_MASK_NEG = jnp.finfo(jnp.float32).min


class Categorical:
    """Categorical over the last axis of `logits`.

    Matches tfd.Categorical semantics for sample/log_prob/entropy/mode. If the logits
    were masked with float32.min (see `masked_logits`) all ops remain stable: softmax
    assigns ~0 probability to masked entries.
    """

    def __init__(self, logits: Array):
        self.logits = logits

    @property
    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def sample(self, seed: PRNGKey) -> Array:
        return jax.random.categorical(seed, self.logits, axis=-1)

    def sample_from_noise(self, gumbel_noise: Array) -> Array:
        """Sample via pre-generated Gumbel noise: argmax(logits + g).

        Identical in distribution to `sample` (the Gumbel-max trick is exactly what
        `jax.random.categorical` does); lets rollout scans hoist ALL their RNG into
        one batched pre-scan call instead of per-step key splits + uniforms."""
        return jnp.argmax(self.logits + gumbel_noise, axis=-1)

    def raw_params(self) -> Array:
        """Distribution parameters sufficient to recompute log_prob later (see
        `log_prob_from_params` registry in networks.factory): rollout scans store
        these instead of running log_softmax per step."""
        return self.logits

    def log_prob(self, value: Array) -> Array:
        log_probs = jax.nn.log_softmax(self.logits, axis=-1)
        # One-hot select instead of take_along_axis: a multiply-sum over the small
        # action axis fuses with its neighbours, where a per-element gather along
        # the minor axis may not (hypothesis to A/B on the GPU, ROADMAP S5).
        # Out-of-range values clamp like gather would, rather than returning 0.
        value = jnp.clip(value.astype(jnp.int32), 0, self.num_categories - 1)
        onehot = value[..., None] == jnp.arange(self.num_categories)
        return jnp.sum(jnp.where(onehot, log_probs, 0.0), axis=-1)

    def entropy(self, seed: Optional[PRNGKey] = None) -> Array:
        log_probs = jax.nn.log_softmax(self.logits, axis=-1)
        probs = jnp.exp(log_probs)
        # 0 * (-inf) -> 0 for fully-masked entries.
        plogp = jnp.where(probs > 0, probs * log_probs, 0.0)
        return -jnp.sum(plogp, axis=-1)

    def mode(self) -> Array:
        return jnp.argmax(self.logits, axis=-1)

    def kl_divergence(self, other: "Categorical") -> Array:
        log_p = jax.nn.log_softmax(self.logits, axis=-1)
        log_q = jax.nn.log_softmax(other.logits, axis=-1)
        p = jnp.exp(log_p)
        return jnp.sum(jnp.where(p > 0, p * (log_p - log_q), 0.0), axis=-1)


def masked_logits(logits: Array, mask: Array) -> Array:
    """Set illegal-action logits to float32.min (reference `networks.py:116-120`)."""
    return jnp.where(mask, logits, _MASK_NEG)


class MaskedCategorical(Categorical):
    """Categorical with an action mask applied to the logits."""

    def __init__(self, logits: Array, mask: Array):
        super().__init__(masked_logits(logits, mask))


def _normal_log_prob(value: Array, loc: Array, scale: Array) -> Array:
    log_unnormalized = -0.5 * jnp.square((value - loc) / scale)
    log_normalization = 0.5 * jnp.log(2.0 * jnp.pi) + jnp.log(scale)
    return log_unnormalized - log_normalization


def _normal_entropy(scale: Array) -> Array:
    return 0.5 * jnp.log(2.0 * jnp.pi * jnp.e) + jnp.log(scale)


def _tanh_forward_log_det_jacobian(x: Array) -> Array:
    # log|d tanh(x)/dx| = log(1 - tanh(x)^2), computed stably.
    return 2.0 * (jnp.log(2.0) - x - jax.nn.softplus(-2.0 * x))


class TanhNormal:
    """Independent tanh-squashed diagonal Normal over the last axis.

    Equivalent to the reference's `Independent(TanhTransformedDistribution(Normal), 1)`
    (`mava/networks.py:164-169`, `mava/distributions.py:24-91`): events live in [-1, 1];
    log_prob is clipped at |a| >= threshold with differentiable boundary log-probs so
    gradients stay defined; entropy is a single-sample estimate of
    H[normal] + E[log det J_tanh].
    """

    def __init__(self, loc: Array, scale: Array, threshold: float = 0.999):
        self.loc = loc
        self.scale = scale
        self._threshold = threshold
        inverse_threshold = jnp.arctanh(threshold)
        log_epsilon = jnp.log(1.0 - threshold)
        # log P(pre-tanh <= -atanh(t)) and log P(pre-tanh >= atanh(t)), averaged over
        # the clipped interval of width (1 - t). Differentiable w.r.t. loc/scale.
        self._log_prob_left = (
            jax.scipy.stats.norm.logcdf(-inverse_threshold, loc, scale) - log_epsilon
        )
        self._log_prob_right = (
            jax.scipy.stats.norm.logcdf(-inverse_threshold, -loc, scale) - log_epsilon
        )

    def sample(self, seed: PRNGKey) -> Array:
        eps = jax.random.normal(seed, self.loc.shape, dtype=self.loc.dtype)
        return jnp.tanh(self.loc + self.scale * eps)

    def sample_from_noise(self, normal_noise: Array) -> Array:
        """Sample via pre-generated standard-normal noise (same trick as the
        Categorical Gumbel version: hoists rollout RNG out of the scan)."""
        return jnp.tanh(self.loc + self.scale * normal_noise)

    def raw_params(self):
        """(loc, scale) — see Categorical.raw_params."""
        return (self.loc, self.scale)

    def sample_and_log_prob(self, seed: PRNGKey):
        eps = jax.random.normal(seed, self.loc.shape, dtype=self.loc.dtype)
        pre_tanh = self.loc + self.scale * eps
        action = jnp.tanh(pre_tanh)
        per_dim = _normal_log_prob(pre_tanh, self.loc, self.scale)
        per_dim -= _tanh_forward_log_det_jacobian(pre_tanh)
        return action, jnp.sum(per_dim, axis=-1)

    def _elementwise_log_prob(self, event: Array) -> Array:
        event = jnp.clip(event, -self._threshold, self._threshold)
        pre_tanh = jnp.arctanh(event)
        in_bounds = _normal_log_prob(pre_tanh, self.loc, self.scale)
        in_bounds -= _tanh_forward_log_det_jacobian(pre_tanh)
        return jnp.where(
            event <= -self._threshold,
            self._log_prob_left,
            jnp.where(event >= self._threshold, self._log_prob_right, in_bounds),
        )

    def log_prob(self, event: Array) -> Array:
        # Independent over the last (action) axis.
        return jnp.sum(self._elementwise_log_prob(event), axis=-1)

    def entropy(self, seed: PRNGKey) -> Array:
        eps = jax.random.normal(seed, self.loc.shape, dtype=self.loc.dtype)
        pre_tanh = self.loc + self.scale * eps
        per_dim = _normal_entropy(self.scale) + _tanh_forward_log_det_jacobian(pre_tanh)
        return jnp.sum(per_dim, axis=-1)

    def mode(self) -> Array:
        return jnp.tanh(self.loc)


def masked_greedy(q_values: Array, mask: Array) -> Array:
    """Greedy masked argmax over the last axis — `MaskedEpsGreedy.mode()`
    without constructing the distribution (used by the fused double-DQN
    target pass, `systems/q_learning/rec_iql.py`)."""
    return jnp.argmax(jnp.where(mask, q_values, _MASK_NEG), axis=-1)


class MaskedEpsGreedy(Categorical):
    """Epsilon-greedy over masked q-values (reference `distributions.py:94-143`).

    probs = eps * uniform(legal actions) + (1 - eps) * onehot(argmax masked q).
    `mode()` is the greedy masked argmax; `sample()` is epsilon-greedy.
    """

    def __init__(self, q_values: Array, epsilon: Array, mask: Array):
        self.q_values = q_values
        mask_f = mask.astype(q_values.dtype)
        n_legal = jnp.sum(mask_f, axis=-1, keepdims=True)
        uniform = mask_f / n_legal
        self._greedy = masked_greedy(q_values, mask)
        greedy = jax.nn.one_hot(
            self._greedy, q_values.shape[-1], dtype=q_values.dtype
        )
        probs = epsilon * uniform + (1.0 - epsilon) * greedy
        # Represent as logits for the Categorical base (log of mixture probs).
        super().__init__(jnp.log(jnp.clip(probs, 1e-12, None)))

    def mode(self) -> Array:
        return self._greedy
