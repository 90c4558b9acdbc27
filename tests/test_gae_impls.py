"""assoc vs sequential GAE equivalence.

`ops/gae.py` solves GAE with an associative scan by default and ships the
reference's reverse-scan formulation behind `impl="sequential"`. These tests
pin (a) the two implementations agree to float-associativity tolerance, (b)
both survive a seed vmap at a (T, E=256, A=4) shape, and (c) the defaulting:
stock systems and the seed-vmapped programs read 'assoc' unless set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax.ops import calculate_gae
from mava_jax.ops.gae import calculate_gae_with_next_done


def _random_inputs(rng, shape):
    rewards = rng.randn(*shape).astype(np.float32)
    values = rng.randn(*shape).astype(np.float32)
    dones = (rng.rand(*shape) < 0.2).astype(np.float32)
    last = np.asarray(rng.randn(*shape[1:]), dtype=np.float32)
    return rewards, values, dones, last


@pytest.mark.parametrize("shape", [(13,), (16, 5, 3), (128, 8, 2)])
def test_assoc_equals_sequential(shape):
    rewards, values, dones, last = _random_inputs(np.random.RandomState(0), shape)
    out_assoc = calculate_gae(rewards, values, dones, last, 0.99, 0.95, impl="assoc")
    out_seq = calculate_gae(
        rewards, values, dones, last, 0.99, 0.95, impl="sequential"
    )
    for a, s in zip(out_assoc, out_seq):
        np.testing.assert_allclose(np.asarray(a), np.asarray(s), rtol=1e-5, atol=1e-5)


def test_assoc_equals_sequential_next_done_variant():
    rng = np.random.RandomState(1)
    shape = (32, 4, 5)
    rewards, values, dones, _ = _random_inputs(rng, shape)
    last_done = (rng.rand(*shape[1:]) < 0.2).astype(np.float32)
    last_val = rng.randn(*shape[1:]).astype(np.float32)
    out_assoc = calculate_gae_with_next_done(
        rewards, values, dones, last_done, last_val, 0.99, 0.95, impl="assoc"
    )
    out_seq = calculate_gae_with_next_done(
        rewards, values, dones, last_done, last_val, 0.99, 0.95, impl="sequential"
    )
    for a, s in zip(out_assoc, out_seq):
        np.testing.assert_allclose(np.asarray(a), np.asarray(s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["assoc", "sequential"])
def test_seed_vmapped_gae_at_the_j104_shape(impl):
    """3 vmapped seeds over a (T, 256 envs, 4 agents) GAE, jitted, for both
    impls; per-seed outputs must equal the unvmapped ones."""
    rng = np.random.RandomState(2)
    seeds, T, E, A = 3, 8, 256, 4
    rewards = rng.randn(seeds, T, E, A).astype(np.float32)
    values = rng.randn(seeds, T, E, A).astype(np.float32)
    dones = (rng.rand(seeds, T, E, A) < 0.2).astype(np.float32)
    last = rng.randn(seeds, E, A).astype(np.float32)

    fn = lambda r, v, d, lv: calculate_gae(r, v, d, lv, 0.99, 0.95, impl=impl)
    batched = jax.jit(jax.vmap(fn))(rewards, values, dones, last)
    for s in range(seeds):
        single = fn(rewards[s], values[s], dones[s], last[s])
        for b, u in zip(batched, single):
            np.testing.assert_allclose(
                np.asarray(b[s]), np.asarray(u), rtol=1e-5, atol=1e-5
            )


def test_unknown_impl_raises():
    r = jnp.ones((4, 2))
    with pytest.raises(ValueError, match="gae_impl"):
        calculate_gae(r, r, r, r[0], 0.99, 0.95, impl="magic")


def test_seed_programs_default_to_sequential():
    """ff_ippo_vmap_seeds.learner_setup (shared by seeds/sweep/MAPPO/PBT) no
    longer forces gae_impl='sequential': seed-lifted programs take the stock
    system.gae_impl ('assoc' unless set), and an explicit setting wins."""
    from mava_jax import envs as environments
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo",
        [
            "env.kwargs.time_limit=8",
            "arch.num_envs=2",
            "system.rollout_length=4",
            "system.num_updates=1",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.num_updates_per_eval = 1
    assert cfg.system.get("gae_impl", "assoc") == "assoc"  # stock default
    env, _ = environments.make(cfg)
    vs.learner_setup(env, jax.random.PRNGKey(0), cfg, mesh, num_seeds=2)
    assert cfg.system.get("gae_impl", "assoc") == "assoc"

    # Explicit user setting wins.
    cfg2 = load_config(
        "default_ff_ippo",
        [
            "env.kwargs.time_limit=8",
            "arch.num_envs=2",
            "system.rollout_length=4",
            "system.num_updates=1",
            "+system.gae_impl=sequential",
            "logger.use_console=False",
        ],
    )
    cfg2.arch.n_devices = num_learner_devices(mesh)
    cfg2.system.num_updates_per_eval = 1
    env2, _ = environments.make(cfg2)
    vs.learner_setup(env2, jax.random.PRNGKey(0), cfg2, mesh, num_seeds=2)
    assert cfg2.system.gae_impl == "sequential"
