"""Generalised Advantage Estimation.

Shared by every PPO system (reference duplicates this inline per system,
`mava/systems/ppo/ff_ippo.py:124-151`). The reference computes GAE as a reverse
`lax.scan` with `unroll=16` — T sequential steps, each a tiny elementwise op over
(envs, agents). GAE is a first-order *linear* recurrence

    gae_t = delta_t + c_t * gae_{t+1},   c_t = gamma * lambda * (1 - done_t)

so the default (`impl="assoc"`) solves it with `jax.lax.associative_scan`:
affine maps (c, delta) compose associatively, giving a log2(T)-depth parallel
prefix where every level is one full-width elementwise op. Hypothesis to A/B on
the GPU (ROADMAP S5): that this beats T serial steps at a 128-step rollout.

`impl="sequential"` is the reference's reverse `lax.scan` formulation
(`mava/systems/ppo/ff_ippo.py:124-151`, `unroll=16`). The two implementations
agree to float-associativity tolerance (tests/test_gae_impls.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _suffix_linear_scan(c: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Solve y_t = delta_t + c_t * y_{t+1} (y_T = 0) over axis 0 in parallel.

    Each element is the affine map y -> c*y + delta; composition
    (right after left) is (c_l*c_r, delta_l*c_r + delta_r), which is associative.
    """
    a = jnp.flip(c, axis=0)
    b = jnp.flip(delta, axis=0)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, b_l * a_r + b_r

    _, y = jax.lax.associative_scan(combine, (a, b), axis=0)
    return jnp.flip(y, axis=0)


def _suffix_linear_scan_sequential(
    c: jnp.ndarray, delta: jnp.ndarray, unroll: int = 16
) -> jnp.ndarray:
    """Same recurrence as `_suffix_linear_scan`, solved with the reference's
    reverse `lax.scan` (T sequential steps, `unroll=16` —
    `mava/systems/ppo/ff_ippo.py:142-148`)."""

    def _body(carry, xs):
        c_t, d_t = xs
        y = d_t + c_t * carry
        return y, y

    _, ys = jax.lax.scan(
        _body, jnp.zeros_like(delta[0]), (c, delta), reverse=True, unroll=unroll
    )
    return ys


def _solve(c, delta, impl: str, unroll: int) -> jnp.ndarray:
    if impl == "assoc":
        return _suffix_linear_scan(c, delta)
    if impl == "sequential":
        return _suffix_linear_scan_sequential(c, delta, unroll)
    raise ValueError(f"Unknown gae_impl '{impl}' (expected 'assoc' or 'sequential').")


def calculate_gae(
    rewards: jnp.ndarray,  # (T, ...)
    values: jnp.ndarray,  # (T, ...)
    dones: jnp.ndarray,  # (T, ...) — 1.0 where the episode ended at this step
    last_value: jnp.ndarray,  # (...)
    gamma: float,
    gae_lambda: float,
    unroll: int = 16,  # used by the sequential impl only
    impl: str = "assoc",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (advantages, targets) with targets = advantages + values."""
    next_values = jnp.concatenate([values[1:], last_value[None]], axis=0)
    not_done = 1.0 - dones.astype(rewards.dtype)
    delta = rewards + gamma * next_values * not_done - values
    advantages = _solve(gamma * gae_lambda * not_done, delta, impl, unroll)
    return advantages, advantages + values


def calculate_gae_with_next_done(
    rewards: jnp.ndarray,
    values: jnp.ndarray,
    next_dones: jnp.ndarray,  # done flag of the *next* timestep (recurrent systems)
    last_done: jnp.ndarray,
    last_value: jnp.ndarray,
    gamma: float,
    gae_lambda: float,
    unroll: int = 16,
    impl: str = "assoc",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """GAE variant that masks bootstrap with the done of the step being bootstrapped
    from (reference `rec_ippo.py:181-203` carries `next_done`): the mask for step t
    is next_dones[t+1], with last_done closing the horizon."""
    mask_done = jnp.concatenate([next_dones[1:], last_done[None]], axis=0)
    next_values = jnp.concatenate([values[1:], last_value[None]], axis=0)
    not_done = 1.0 - mask_done.astype(rewards.dtype)
    delta = rewards + gamma * next_values * not_done - values
    advantages = _solve(gamma * gae_lambda * not_done, delta, impl, unroll)
    return advantages, advantages + values
