"""Staggered-reset burn-in (`envs/stagger.py`): desynchronisation, semantics
preservation, discrete + continuous action sampling, and the end-to-end opt-in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax import envs as environments
from mava_jax.envs.stagger import reject_stagger, stagger_env_states
from mava_jax.utils.config import load_config


def _batched_reset(env, n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(env.reset)(keys)


def _make_env(default, overrides):
    cfg = load_config(default, overrides)
    env, _ = environments.make(cfg)
    return env


def test_stagger_desynchronises_rware():
    # RWARE has no early termination, so after burn-in each env's step_count
    # equals its drawn offset k_i exactly.
    env = _make_env("default_ff_ippo", ["env.kwargs.time_limit=32"])
    n = 64
    states, ts = _batched_reset(env, n)
    new_states, new_ts = stagger_env_states(env, states, ts, jax.random.PRNGKey(3))

    counts = np.asarray(new_states.env_state.step_count)
    assert counts.shape == (n,)
    assert (counts >= 0).all() and (counts < env.time_limit).all()
    # Uniform over 32 offsets with 64 draws: lockstep (all-equal) is gone.
    assert len(np.unique(counts)) > 10
    # The timestep is the observation OF the staggered state.
    np.testing.assert_array_equal(
        np.asarray(new_ts.observation.step_count)[:, 0], counts
    )


def test_stagger_preserves_structure():
    env = _make_env("default_ff_ippo", ["env.kwargs.time_limit=16"])
    n = 8
    states, ts = _batched_reset(env, n)
    new_states, new_ts = stagger_env_states(env, states, ts, jax.random.PRNGKey(1))

    for old, new in zip(jax.tree.leaves((states, ts)), jax.tree.leaves((new_states, new_ts))):
        assert old.shape == new.shape
        assert old.dtype == new.dtype


def test_stagger_continuous_actions():
    env = _make_env(
        "default_ff_isac", ["env=maswarm", "env.kwargs.time_limit=16"]
    )
    n = 16
    states, ts = _batched_reset(env, n)
    new_states, _ = stagger_env_states(env, states, ts, jax.random.PRNGKey(2))
    counts = np.asarray(new_states.env_state.step_count)
    assert len(np.unique(counts)) > 4


def test_stagger_zero_offset_env_untouched():
    # With time_limit large and a crafted key we can't pin k_i, but k=0 envs
    # must remain bit-identical to their reset state: verify by forcing caps=0
    # via time_limit=1 (randint(0,1) == 0 always -> no env advances).
    env = _make_env("default_ff_ippo", ["env.kwargs.time_limit=1"])
    n = 4
    states, ts = _batched_reset(env, n)
    new_states, new_ts = stagger_env_states(env, states, ts, jax.random.PRNGKey(0))
    for old, new in zip(jax.tree.leaves((states, ts)), jax.tree.leaves((new_states, new_ts))):
        np.testing.assert_array_equal(np.asarray(old), np.asarray(new))


def test_ff_ippo_runs_with_stagger(fast_config_overrides):
    from mava_jax.systems.ppo import ff_ippo

    cfg = load_config(
        "default_ff_ippo",
        fast_config_overrides
        + ["env.kwargs.time_limit=16", "arch.stagger_resets=True"],
    )
    perf = ff_ippo.run_experiment(cfg)
    assert isinstance(perf, float)


def test_reject_stagger_on_unsupported_systems():
    cfg = load_config(
        "default_rec_iql", ["arch.stagger_resets=True", "logger.use_console=False"]
    )
    with pytest.raises(ValueError, match="stagger_resets"):
        reject_stagger(cfg, "rec-IQL")


def test_stagger_on_mesh_sharded_batch():
    """The burn-in must compile and run on MESH-SHARDED states/timesteps (the
    real call site feeds sharded_env_reset outputs): shardings propagate
    through the jitted scan and the offsets still desynchronise."""
    from mava_jax.parallel import make_mesh, num_learner_devices, sharded_env_reset

    env = _make_env("default_ff_ippo", ["env.kwargs.time_limit=32"])
    mesh = make_mesh()
    n = num_learner_devices(mesh) * 4  # 4 envs per device on the test mesh
    states, ts = sharded_env_reset(env, jax.random.PRNGKey(0), n, mesh)
    new_states, new_ts = stagger_env_states(env, states, ts, jax.random.PRNGKey(9))

    counts = np.asarray(new_states.env_state.step_count)
    assert counts.shape == (n,)
    assert len(np.unique(counts)) > 5
    # Output sharding matches the input sharding (no silent gather-to-host).
    assert (
        new_states.env_state.step_count.sharding
        == states.env_state.step_count.sharding
    )
