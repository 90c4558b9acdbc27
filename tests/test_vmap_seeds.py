"""Equivalence of the vmapped multi-seed learner vs the stock single-seed one.

The vmap-seeds module (`advanced_usage/ff_ippo_vmap_seeds.py`) claims pure
replication: seed s of the batched program must produce the state the stock
ff-IPPO learner produces when started from seed s's slice — identical RNG
streams, identical update sequence (CLAUDE.md invariant: perf transformations
are distribution-preserving, with tests). Comparison is tight-tolerance rather
than bitwise: vmap lowers per-seed matmuls to batched kernels whose float
accumulation order differs in the last bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
    make_mesh,
    num_learner_devices,
)
from mava_jax.systems.ppo import ff_ippo
from mava_jax.systems.ppo.types import LearnerState
from mava_jax.types import ExperimentOutput
from mava_jax.utils.config import load_config


def test_vmap_seeds_matches_stock_learner_bitwise():
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs

    cfg = load_config(
        "default_ff_ippo",
        [
            "env.kwargs.time_limit=8",
            "arch.num_envs=2",
            "system.rollout_length=4",
            "system.num_updates=1",
            "system.ppo_epochs=1",
            "system.num_minibatches=2",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates_per_eval = 1
    num_seeds = 2

    env, _ = environments.make(cfg)
    key = jax.random.PRNGKey(0)

    # Batched state via the module's own setup.
    learn_vmap, _, state_vmap = vs.learner_setup(env, key, cfg, mesh, num_seeds)

    # Stock learner over the same mesh.
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    learn_stock, _, _ = ff_ippo.learner_setup(env, tuple(keys), cfg, mesh)

    out_vmap = learn_vmap(state_vmap)
    out_vmap = jax.device_get(out_vmap)

    for s in range(num_seeds):
        # Start the stock learner from seed s's exact slice of the batched state.
        state_s = jax.tree.map(lambda x: x[s], jax.device_get(state_vmap))
        state_s = LearnerState(
            params=vs._put(state_s.params, mesh, P()),
            opt_states=vs._put(state_s.opt_states, mesh, P()),
            key=vs._put(state_s.key, mesh, P(DATA_AXIS)),
            env_state=vs._put(state_s.env_state, mesh, P(DATA_AXIS)),
            timestep=vs._put(state_s.timestep, mesh, P(DATA_AXIS)),
        )
        out_s = jax.device_get(learn_stock(state_s))

        got = jax.tree.map(lambda x: x[s], out_vmap.learner_state)
        want = out_s.learner_state
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            g, w = np.asarray(g), np.asarray(w)
            if np.issubdtype(g.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)


def _assert_tree_close(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_isac_vmap_seeds_matches_stock_learner():
    """Off-policy extension of the same claim: seed s of the batched SAC
    program (explore + one update, including its per-seed replay buffer)
    equals the stock ff-ISAC learner started from seed s's initial state."""
    from mava_jax.advanced_usage import ff_isac_vmap_seeds as vs
    from mava_jax.systems.sac import ff_isac

    cfg = load_config(
        "default_ff_isac",
        [
            "env=maswarm",
            "env.kwargs.time_limit=8",
            "arch.num_envs=2",
            "system.rollout_length=2",
            "system.explore_steps=8",
            "system.buffer_size=32",
            "system.batch_size=4",
            "system.epochs=2",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.scan_steps = 2
    num_seeds = 2

    _, _, (explore_v, update_v), state_v, _ = vs.learner_setup(cfg, mesh, num_seeds)
    init_host = jax.device_get(state_v)

    mid_v, _ = explore_v(state_v)
    out_v, _ = update_v(mid_v)
    out_v = jax.device_get(out_v)

    # Stock learner fns (identical construction path).
    envs_, networks, optims, rb, _, target_entropy, _ = ff_isac.init(cfg, mesh)
    explore_fn, update_fn = ff_isac.make_update_fns(
        cfg, envs_[0], networks, optims, rb, target_entropy, False
    )
    stock_specs = ff_isac._state_specs(init_host.buffer_state)
    from mava_jax.parallel import build_learner

    explore_s = build_learner(
        explore_fn, mesh, in_specs=(stock_specs,),
        out_specs=(stock_specs, P(None, DATA_AXIS)),
    )
    update_s = build_learner(
        update_fn, mesh, in_specs=(stock_specs,),
        out_specs=(stock_specs, (P(None, None, DATA_AXIS), P())),
    )

    for s in range(num_seeds):
        state_s = jax.tree.map(lambda x: x[s], init_host)
        state_s = vs.place_state(state_s, stock_specs, mesh)
        mid_s, _ = explore_s(state_s)
        out_s, _ = update_s(mid_s)
        _assert_tree_close(jax.tree.map(lambda x: x[s], out_v), jax.device_get(out_s))


def test_rec_iql_vmap_seeds_matches_stock_learner():
    """Same claim for the fused act+train Q-learner: per-seed slice of the
    batched program equals the stock rec-IQL update (replay write + sample +
    double-DQN train, eps schedule driven by the per-seed step counter)."""
    from mava_jax.advanced_usage import rec_iql_vmap_seeds as vs
    from mava_jax.systems.q_learning import rec_iql

    cfg = load_config(
        "default_rec_iql",
        [
            "env=smax",
            "env/scenario=2s3z",
            "arch.num_envs=2",
            "system.rollout_length=4",
            "system.buffer_size=16",
            "system.sample_batch_size=2",
            "system.sample_sequence_length=8",
            "system.epochs=1",
            "system.min_buffer_size=2",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.scan_steps = 2
    num_seeds = 2

    _, _, update_v, state_v = vs.learner_setup(cfg, mesh, num_seeds)
    init_host = jax.device_get(state_v)
    out_v, _ = update_v(state_v)
    out_v = jax.device_get(out_v)

    envs_, q_net, opt, rb, ls, _ = rec_iql.init(cfg, mesh)
    update_s = rec_iql.build_learn_fn(
        cfg, envs_[0], q_net, opt, rb, mesh, ls.buffer_state
    )
    stock_specs = vs._stock_specs(init_host.buffer_state)

    for s in range(num_seeds):
        state_s = jax.tree.map(lambda x: x[s], init_host)
        state_s = vs.place_state(state_s, stock_specs, mesh)
        out_s, _ = update_s(state_s)
        _assert_tree_close(jax.tree.map(lambda x: x[s], out_v), jax.device_get(out_s))


def test_buffer_experience_stays_on_device_in_seed_setup():
    """The r5 init rework (BASELINE j062/j905): per-seed replay EXPERIENCE must
    never round-trip through the host — the host-side stacked state carries
    `experience=()` and the placed state's experience is device-created zeros
    with the seed-lifted sharding."""
    import numpy as np

    from mava_jax.advanced_usage import ff_isac_vmap_seeds as vs

    class BufState:
        def __init__(self, experience, current_index, is_full):
            self.experience = experience
            self.current_index = current_index
            self.is_full = is_full

        def replace(self, **kw):
            d = dict(
                experience=self.experience,
                current_index=self.current_index,
                is_full=self.is_full,
            )
            d.update(kw)
            return BufState(**d)

    from collections import namedtuple

    LS = namedtuple("LS", ["params", "buffer_state"])
    ls = LS(
        params={"w": jnp.ones((3,))},
        buffer_state=BufState(
            experience={"obs": jnp.zeros((4, 8, 2))},
            current_index=jnp.int32(0),
            is_full=jnp.bool_(False),
        ),
    )
    small, template = vs.split_buffer_experience(ls)
    assert small.buffer_state.experience == ()
    sds = template["obs"]
    assert sds.shape == (4, 8, 2) and sds.dtype == jnp.float32

    mesh = make_mesh()
    num_seeds = 2
    # Stacked zeros, created on device: dim 0 = seed axis (unsharded), dim 1 =
    # the add-batch axis sharded over the 8-device data mesh (8 rows -> 1 per
    # device), mirroring the real _state_specs layout.
    exp = vs.make_stacked_experience(
        {"obs": jax.ShapeDtypeStruct((8, 2), jnp.float32)},
        num_seeds,
        {"obs": P(None, DATA_AXIS)},
        mesh,
    )
    assert exp["obs"].shape == (num_seeds, 8, 2)
    np.testing.assert_array_equal(np.asarray(exp["obs"]), 0.0)
    shard = exp["obs"].addressable_shards[0]
    assert shard.data.shape == (num_seeds, 1, 2)  # add-batch split 8 ways
