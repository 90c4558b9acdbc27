"""Action heads producing distributions.

Parity with reference `mava/networks.py:88-169`: discrete masked-categorical head with
orthogonal(0.01) logits layer; continuous tanh-Normal head with state-independent or
state-dependent log-std and softplus scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mava_jax.distributions import MaskedCategorical, TanhNormal
from mava_jax.networks.layers import Module, Scope, dense, module, orthogonal, zeros
from mava_jax.types import Observation


@module
class DiscreteActionHead(Module):
    """Dense -> logits, masked by `observation.action_mask`."""

    action_dim: int

    def __call__(self, scope: Scope, obs_embedding: jnp.ndarray, observation: Observation):
        logits = dense(
            scope.child("Dense_0"), obs_embedding, self.action_dim, orthogonal(0.01)
        )
        return MaskedCategorical(logits, observation.action_mask)


@module
class ContinuousActionHead(Module):
    """Tanh-squashed Normal head; actions in [-1, 1] (reference `networks.py:127-169`)."""

    action_dim: int
    min_scale: float = 1e-3
    independent_std: bool = True

    def __call__(self, scope: Scope, obs_embedding: jnp.ndarray, observation: Observation):
        loc = dense(
            scope.child("Dense_0"), obs_embedding, self.action_dim, orthogonal(0.01)
        )
        if self.independent_std:
            log_std = scope.param("log_std", zeros, (self.action_dim,))
        else:
            log_std = dense(
                scope.child("Dense_1"), obs_embedding, self.action_dim, orthogonal(0.01)
            )
        scale = jax.nn.softplus(log_std) + self.min_scale
        scale = jnp.broadcast_to(scale, loc.shape)
        return TanhNormal(loc, scale)
