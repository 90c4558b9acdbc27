"""Actor / critic / Q networks, feedforward and recurrent.

Capability parity with reference `mava/networks.py:172-384`. The recurrent modules use a
GRU scanned over the time axis with carry reset on episode boundaries, keeping the
time axis inside `lax.scan` on-device (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from mava_jax.distributions import MaskedEpsGreedy
from mava_jax.networks.layers import (
    Module,
    Scope,
    dense,
    lecun_normal,
    module,
    orthogonal,
    zeros,
)
from mava_jax.types import (
    Observation,
    ObservationGlobalState,
    RNNGlobalObservation,
    RNNObservation,
)


def _critic_input(
    observation: Union[Observation, ObservationGlobalState], centralised: bool
) -> jnp.ndarray:
    if not centralised:
        return observation.agents_view
    if not isinstance(observation, ObservationGlobalState):
        raise ValueError("Centralised critic requires a global state.")
    return observation.global_state


@module
class FeedForwardActor(Module):
    """torso(agents_view) -> action_head(embedding, obs)."""

    torso: Module
    action_head: Module

    def __call__(self, scope: Scope, observation: Observation):
        obs_embedding = self.torso(scope.child("torso"), observation.agents_view)
        return self.action_head(scope.child("action_head"), obs_embedding, observation)


@module
class FeedForwardValueNet(Module):
    """V(obs); centralised variant consumes the global state (CTDE)."""

    torso: Module
    centralised_critic: bool = False

    def __call__(
        self, scope: Scope, observation: Union[Observation, ObservationGlobalState]
    ) -> jnp.ndarray:
        x = self.torso(
            scope.child("torso"), _critic_input(observation, self.centralised_critic)
        )
        value = dense(scope.child("Dense_0"), x, 1, orthogonal(1.0))
        return jnp.squeeze(value, axis=-1)


@module
class FeedForwardQNet(Module):
    """Q(obs, action) for continuous control (reference `networks.py:210-235`)."""

    torso: Module
    centralised_critic: bool = False

    def __call__(
        self,
        scope: Scope,
        observation: Union[Observation, ObservationGlobalState],
        action: jnp.ndarray,
    ) -> jnp.ndarray:
        x = _critic_input(observation, self.centralised_critic)
        x = jnp.concatenate([x, action], axis=-1)
        x = self.torso(scope.child("torso"), x)
        q = dense(scope.child("Dense_0"), x, 1, orthogonal(1.0))
        return jnp.squeeze(q, axis=-1)


def _blockwise_orthogonal(key: jax.Array, shape: Sequence[int], dtype=jnp.float32):
    """Init a (h, 3h) recurrent kernel as 3 independent orthogonal (h, h) blocks.

    Matches `flax.linen.GRUCell`'s per-gate `recurrent_kernel_init=orthogonal()`
    exactly in distribution — a single orthogonal draw over the fused (h, 3h) shape
    would correlate the gate blocks instead.
    """
    h = shape[0]
    assert shape[1] == 3 * h, "fused recurrent kernel must be (h, 3h)"
    init = orthogonal()
    keys = jax.random.split(key, 3)
    return jnp.concatenate([init(k, (h, h), dtype) for k in keys], axis=-1)


def _gru_params(scope: Scope, in_features: int, hidden: int):
    """The fused GRU weights: input kernel/bias (in, 3h)/(3h,), recurrent kernel
    (h, 3h) and the `n` gate's recurrent-side bias (h,)."""
    w_i = scope.param("wi", lecun_normal(), (in_features, 3 * hidden))
    b_i = scope.param("bi", zeros, (3 * hidden,))
    w_h = scope.param("wh", _blockwise_orthogonal, (hidden, 3 * hidden))
    b_hn = scope.param("bhn", zeros, (hidden,))
    return w_i, b_i, w_h, b_hn


def _gru_update(gates_i, h, w_h, b_hn):
    """One GRU step from the precomputed input gates `x @ Wi + bi`:

        r = sigmoid(x @ Wir + bir + h @ Whr)
        z = sigmoid(x @ Wiz + biz + h @ Whz)
        n = tanh(x @ Win + bin + r * (h @ Whn + bhn))
        h' = (1 - z) * n + z * h
    """
    xr, xz, xn = jnp.split(gates_i, 3, axis=-1)
    hr, hz, hn = jnp.split(h @ w_h, 3, axis=-1)
    r = jax.nn.sigmoid(xr + hr)
    z = jax.nn.sigmoid(xz + hz)
    n = jnp.tanh(xn + r * (hn + b_hn))
    return (1.0 - z) * n + z * h


@module
class FusedGRUCell(Module):
    """GRU cell with the 6 gate projections fused into 2 wide matmuls.

    Function-identical to `flax.linen.GRUCell` (reference `networks.py:238-266`
    uses the flax cell), but issues the input projections as ONE (B, in) @ (in, 3h)
    matmul and the recurrent projections as ONE (B, h) @ (h, 3h) matmul instead of
    six separate Dense kernels. Init distributions match flax per gate block
    (lecun-normal input kernels, orthogonal recurrent blocks, zero biases; only the
    `n` gate has a recurrent-side bias). Numerical equivalence to packed flax
    params is pinned in tests/test_recurrent.py.
    """

    def __call__(self, scope: Scope, carry: jnp.ndarray, inputs: jnp.ndarray):
        w_i, b_i, w_h, b_hn = _gru_params(scope, inputs.shape[-1], carry.shape[-1])
        new_h = _gru_update(inputs @ w_i + b_i, carry, w_h, b_hn)
        return new_h, new_h


# ScannedRNN implementations, selected by `network.gru_impl`:
#   "hoisted" (default): the input projection for ALL timesteps is one wide
#     matmul before the serial scan; only `h @ Wh` and the gate arithmetic
#     remain inside it.
#   "cell": the plain per-step GRU cell, input projection inside the scan —
#     the reference the hoisted path is tested against (tests/test_recurrent.py).
# Both read the same parameters.
GRU_IMPLS = ("hoisted", "cell")


def resolve_gru_impl(impl: Optional[str] = None) -> str:
    """Map a `gru_impl` setting to a concrete implementation. `None` and the
    older `"auto"` mean the default, "hoisted", on every platform."""
    if impl in (None, "auto"):
        return "hoisted"
    if impl not in GRU_IMPLS:
        raise ValueError(f"unknown gru_impl {impl!r}; expected one of {GRU_IMPLS}")
    return impl


@module
class ScannedRNN(Module):
    """GRU scanned over the leading (time) axis with carry reset where `resets` is set.

    Input x is a tuple (inputs, resets): inputs (T, B, A, F), resets (T, B, A). The
    params are broadcast over time so one weight set serves the whole scan
    (reference `networks.py:238-266`). Same math as FusedGRUCell.
    """

    hidden_state_dim: int = 128
    # When set, each step's output also includes its INPUT carry (pre-reset) — used
    # by the post-rollout batched critic pass to reconstruct the per-step hidden
    # states a fused in-rollout critic would have stored.
    collect_carries: bool = False
    gru_impl: Optional[str] = None

    def __call__(
        self, scope: Scope, carry: jnp.ndarray, x: Tuple[jnp.ndarray, jnp.ndarray]
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        ins, resets = x
        w_i, b_i, w_h, b_hn = _gru_params(scope, ins.shape[-1], self.hidden_state_dim)
        collect = self.collect_carries
        hoisted = resolve_gru_impl(self.gru_impl) == "hoisted"

        def step(h_prev, inp):
            x_t, reset_t = inp
            h = jnp.where(reset_t[..., jnp.newaxis], 0.0, h_prev)
            gates_i = x_t if hoisted else x_t @ w_i + b_i
            new_h = _gru_update(gates_i, h, w_h, b_hn)
            return new_h, ((h_prev, new_h) if collect else new_h)

        # Named so a profiler trace can attribute device time to the GRU.
        with jax.named_scope("gru_scan"):
            # Hoisted: one wide matmul for every timestep's input gates (T folds
            # into the batch) before the serial scan.
            xs = ins @ w_i + b_i if hoisted else ins
            return jax.lax.scan(step, carry, (xs, resets))

    @staticmethod
    def initialize_carry(batch_shape: Sequence[int], hidden_size: int) -> jnp.ndarray:
        return jnp.zeros((*batch_shape, hidden_size), dtype=jnp.float32)


@module
class RecurrentActor(Module):
    """pre_torso -> GRU -> post_torso -> action head."""

    pre_torso: Module
    post_torso: Module
    action_head: Module
    hidden_state_dim: int = 128
    gru_impl: Optional[str] = None

    def __call__(
        self,
        scope: Scope,
        policy_hidden_state: jnp.ndarray,
        observation_done: RNNObservation,
    ):
        observation, done = observation_done
        embedding = self.pre_torso(scope.child("pre_torso"), observation.agents_view)
        policy_hidden_state, embedding = ScannedRNN(
            self.hidden_state_dim, gru_impl=self.gru_impl
        )(scope.child("ScannedRNN_0"), policy_hidden_state, (embedding, done))
        embedding = self.post_torso(scope.child("post_torso"), embedding)
        pi = self.action_head(scope.child("action_head"), embedding, observation)
        return policy_hidden_state, pi


@module
class RecurrentValueNet(Module):
    """Recurrent V(obs); centralised variant consumes the global state.

    With `collect_carries` the call also returns every step's input hidden state
    (pre-reset): `(final_hidden, (per_step_hidden, values))`. Parameters are
    identical either way, so the same params serve both call styles.
    """

    pre_torso: Module
    post_torso: Module
    centralised_critic: bool = False
    hidden_state_dim: int = 128
    collect_carries: bool = False
    gru_impl: Optional[str] = None

    def __call__(
        self,
        scope: Scope,
        value_hidden_state: jnp.ndarray,
        observation_done: Union[RNNObservation, RNNGlobalObservation],
    ):
        observation, done = observation_done
        x = _critic_input(observation, self.centralised_critic)
        embedding = self.pre_torso(scope.child("pre_torso"), x)
        value_hidden_state, rnn_out = ScannedRNN(
            self.hidden_state_dim,
            collect_carries=self.collect_carries,
            gru_impl=self.gru_impl,
        )(scope.child("ScannedRNN_0"), value_hidden_state, (embedding, done))
        if self.collect_carries:
            carries, embedding = rnn_out
        else:
            embedding = rnn_out
        embedding = self.post_torso(scope.child("post_torso"), embedding)
        value = dense(scope.child("Dense_0"), embedding, 1, orthogonal(1.0))
        value = jnp.squeeze(value, axis=-1)
        if self.collect_carries:
            return value_hidden_state, (carries, value)
        return value_hidden_state, value


@module
class RecQNetwork(Module):
    """Recurrent Q-network with eps-greedy distribution head
    (reference `networks.py:343-384`)."""

    pre_torso: Module
    post_torso: Module
    num_actions: int
    hidden_state_dim: int = 128
    gru_impl: Optional[str] = None

    def get_q_values(
        self,
        scope: Scope,
        hidden_state: jnp.ndarray,
        observations_resets: RNNObservation,
    ):
        obs, resets = observations_resets
        embedding = self.pre_torso(scope.child("pre_torso"), obs.agents_view)
        hidden_state, embedding = ScannedRNN(
            self.hidden_state_dim, gru_impl=self.gru_impl
        )(scope.child("ScannedRNN_0"), hidden_state, (embedding, resets))
        embedding = self.post_torso(scope.child("post_torso"), embedding)
        q_values = dense(
            scope.child("Dense_0"), embedding, self.num_actions, orthogonal(0.01)
        )
        return hidden_state, q_values

    def __call__(
        self,
        scope: Scope,
        hidden_state: jnp.ndarray,
        observations_resets: RNNObservation,
        eps: float = 0.0,
    ):
        obs, _ = observations_resets
        hidden_state, q_values = self.get_q_values(
            scope, hidden_state, observations_resets
        )
        return hidden_state, MaskedEpsGreedy(q_values, eps, obs.action_mask)
