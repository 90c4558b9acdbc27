"""Staggered environment resets for massively parallel on-policy training.

With hundreds of vectorised envs reset together at t=0, fixed-length (or
near-fixed-length) episodes terminate in LOCKSTEP: every rollout contains the
same episode phase across the whole batch, so consecutive updates see
phase-correlated data instead of an i.i.d. mix of episode stages (Staggered
Environment Resets Improve Massively Parallel On-Policy Reinforcement
Learning, arXiv:2511.21011). This hits exactly the high-env operating points
that throughput favours.

`stagger_env_states` desynchronises the batch ONCE at setup: after the normal
vmapped reset, each env i is advanced by k_i ~ U[0, time_limit) random-action
burn-in steps (a single `lax.scan` of the wrapped env step with a per-env
advance mask — both branches of the select are computed, the usual vmap
auto-reset cost profile, and the burn-in data is discarded). Thereafter env
i's episodes end near t ≡ k_i (mod L) instead of all together. No per-step
semantics change: episode lengths, rewards and termination rules are
untouched, which is why this lives at setup rather than as a wrapper.

Opt-in via `arch.stagger_resets=True` (feedforward systems; a recurrent
policy would start mid-episode with a zero carry, a different trade-off we
don't make by default). The reference has no analogue — all its envs reset
synchronously at t=0 (`mava/systems/ppo/ff_ippo.py:414-419`).

Caveat: the first in-progress episode per env begins with a random-action
prefix, so the very first logged episode returns are slightly depressed;
evaluation episodes are unaffected (the eval env is reset fresh).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from mava_jax import specs


def derive_stagger_key(key: jnp.ndarray) -> jnp.ndarray:
    """Stagger key via fold_in (NOT split): enabling the burn-in must not shift
    the caller's downstream RNG stream, so A/B arms stay action-identical. One
    constant, used by every entry point — the reproducibility contract depends
    on all call sites deriving identically."""
    return jax.random.fold_in(key, 0x57A6)


def _random_action_fn(env: Any):
    """Uniform random legal actions for a batched timestep."""
    spec = env.action_spec()
    if isinstance(spec, specs.DiscreteArray):

        def sample(key: jnp.ndarray, timestep: Any) -> jnp.ndarray:
            mask = timestep.observation.action_mask  # (N, A, Act) bool
            logits = jnp.where(mask, 0.0, -1e9)
            return jax.random.categorical(key, logits, axis=-1).astype(spec.dtype)

    else:
        lo = -1.0 if spec.minimum is None else spec.minimum
        hi = 1.0 if spec.maximum is None else spec.maximum

        def sample(key: jnp.ndarray, timestep: Any) -> jnp.ndarray:
            n = timestep.reward.shape[0]
            return jax.random.uniform(
                key, (n, *spec.shape), dtype=spec.dtype, minval=lo, maxval=hi
            )

    return sample


def stagger_env_states(
    env: Any, env_states: Any, timesteps: Any, key: jnp.ndarray
) -> Tuple[Any, Any]:
    """Advance env i by k_i ~ U[0, time_limit) random-action steps, k drawn per env.

    `env_states`/`timesteps` are the batched (leading env axis) outputs of a
    vmapped reset of the fully wrapped train env (auto-reset included, so episodes
    that end naturally during burn-in just roll over). Returns the desynchronised
    (states, timesteps) with identical structure/sharding; all burn-in data is
    discarded. Callers derive `key` with `jax.random.fold_in` rather than a
    `split` so enabling the stagger does not shift the downstream RNG stream
    (keeps A/B arms action-identical).
    """
    time_limit = int(env.time_limit)
    n_envs = int(jax.tree.leaves(timesteps)[0].shape[0])
    sample_action = _random_action_fn(env)

    def burn_in(states: Any, ts: Any, k: jnp.ndarray) -> Tuple[Any, Any]:
        cap_key, step_key = jax.random.split(k)
        caps = jax.random.randint(cap_key, (n_envs,), 0, time_limit)
        # Max cap is time_limit-1, so the last scan iteration would be fully
        # masked — run time_limit-1 steps.
        n_steps = time_limit - 1
        step_keys = jax.random.split(step_key, max(n_steps, 1))[:n_steps]

        def body(carry, inp):
            t, sk = inp
            cur_states, cur_ts = carry
            actions = sample_action(sk, cur_ts)
            new_states, new_ts = jax.vmap(env.step)(cur_states, actions)
            advance = t < caps  # (N,)

            def sel(new, old):
                m = advance.reshape((n_envs,) + (1,) * (new.ndim - 1))
                return jnp.where(m, new, old)

            return (
                jax.tree.map(sel, new_states, cur_states),
                jax.tree.map(sel, new_ts, cur_ts),
            ), None

        (states, ts), _ = jax.lax.scan(
            body, (states, ts), (jnp.arange(n_steps), step_keys)
        )
        return states, ts

    return jax.jit(burn_in)(env_states, timesteps, key)


def reject_stagger(config: Any, system_name: str) -> None:
    """Fail fast when `arch.stagger_resets` is set for a system that ignores it.

    The burn-in is a feedforward-PPO setup transform: a recurrent policy would
    start mid-episode with a zero carry, and off-policy replay already
    decorrelates episode phase. Silently accepting the flag would let a user
    believe they measured staggered resets when they measured the baseline.
    """
    if config.arch.get("stagger_resets", False):
        raise ValueError(
            f"arch.stagger_resets=True is not supported by {system_name} "
            "(feedforward PPO systems only — see mava_jax/envs/stagger.py)."
        )
