"""Seed-SHARDED multi-seed training equals the unsharded vmap-seeds program.

`make_seed_sharded_mesh` answers the vmap-seeds memory bound: vmapping seeds
replicates the replay buffer per seed on EVERY device, so device memory caps
the seed count. Sharding the seed axis over its own mesh
axis gives each device only `num_seeds / seed_shards` buffers, and — because
the stock learner's `pmean('data')` reduces over the data axis of a 2-D
`(seed, data)` mesh — independent seeds never mix gradients, with the stock
update fn reused verbatim.

Claims tested here (CLAUDE.md invariant: perf/placement transformations are
distribution-preserving, with tests):
  1. per-seed outputs of the seed-sharded program match the unsharded vmap
     program run over the SAME per-seed data-shard count (tight tolerance —
     placement changes collective accumulation order in the last bits);
  2. each device materialises only its LOCAL seeds' replay buffers (the
     actual memory claim);
  3. the sharded program's losses differ across seeds (i.e. the pmean did
     NOT average over the seed axis).
"""

import jax
import numpy as np
import pytest

from mava_jax.parallel import SEED_AXIS, make_mesh, make_seed_sharded_mesh
from mava_jax.utils.config import load_config

NUM_SEEDS = 2


def _tiny_iql_cfg():
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
    cfg.system.scan_steps = 2
    return cfg


def _assert_tree_close(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_rec_iql_seed_sharded_matches_unsharded_vmap():
    from mava_jax.advanced_usage import rec_iql_vmap_seeds as vs

    # Sharded: 2 seed groups x 4 data shards on the 8-device mesh.
    cfg_sh = _tiny_iql_cfg()
    cfg_sh.arch.n_devices = 4
    mesh_sh = make_seed_sharded_mesh(NUM_SEEDS)
    _, _, update_sh, state_sh = vs.learner_setup(
        cfg_sh, mesh_sh, NUM_SEEDS, seed_axis=SEED_AXIS
    )

    # Memory claim: each device holds ONE seed's buffer rows, not all of them.
    exp_leaf = jax.tree.leaves(state_sh.buffer_state.experience)[0]
    local_seed_dims = {s.data.shape[0] for s in exp_leaf.addressable_shards}
    assert local_seed_dims == {NUM_SEEDS // 2}, (
        f"seed axis not sharded: per-device leading dims {local_seed_dims}"
    )

    out_sh, (_, losses_sh) = update_sh(state_sh)
    out_sh = jax.device_get(out_sh)

    # Baseline: the existing unsharded vmap program over the SAME per-seed
    # data-shard count (a 1-D mesh over the first 4 devices).
    cfg_un = _tiny_iql_cfg()
    cfg_un.arch.n_devices = 4
    mesh_un = make_mesh(jax.devices()[:4])
    _, _, update_un, state_un = vs.learner_setup(cfg_un, mesh_un, NUM_SEEDS)

    # Same starting point by construction (identical per-seed stock inits).
    _assert_tree_close(jax.device_get(state_sh), jax.device_get(state_un))

    out_un, (_, losses_un) = update_un(state_un)
    _assert_tree_close(out_sh, jax.device_get(out_un))

    # Independence: seeds produced different losses -> pmean stayed within a
    # seed group (a pmean over the seed axis would equalise them).
    q_loss = np.asarray(jax.device_get(losses_sh["q_loss"]))
    assert not np.allclose(q_loss[0], q_loss[1]), "seed losses identical: pmean leaked"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_isac_seed_sharded_matches_unsharded_vmap():
    """Same claim for the SAC family (explore + one update through the
    per-seed replay buffers)."""
    from mava_jax.advanced_usage import ff_isac_vmap_seeds as vs

    def tiny_cfg():
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
        cfg.system.scan_steps = 2
        return cfg

    cfg_sh = tiny_cfg()
    cfg_sh.arch.n_devices = 4
    mesh_sh = make_seed_sharded_mesh(NUM_SEEDS)
    _, _, (explore_sh, update_sh), state_sh, _ = vs.learner_setup(
        cfg_sh, mesh_sh, NUM_SEEDS, seed_axis=SEED_AXIS
    )

    cfg_un = tiny_cfg()
    cfg_un.arch.n_devices = 4
    mesh_un = make_mesh(jax.devices()[:4])
    _, _, (explore_un, update_un), state_un, _ = vs.learner_setup(
        cfg_un, mesh_un, NUM_SEEDS
    )

    # Memory claim (mirrors the rec-IQL test; ADVICE r3): each device holds
    # only its LOCAL seed's replay buffer rows.
    exp_leaf = jax.tree.leaves(state_sh.buffer_state.experience)[0]
    local_seed_dims = {s.data.shape[0] for s in exp_leaf.addressable_shards}
    assert local_seed_dims == {NUM_SEEDS // 2}, (
        f"seed axis not sharded: per-device leading dims {local_seed_dims}"
    )

    mid_sh, _ = explore_sh(state_sh)
    out_sh, (_, losses_sh) = update_sh(mid_sh)
    mid_un, _ = explore_un(state_un)
    out_un, _ = update_un(mid_un)
    _assert_tree_close(jax.device_get(out_sh), jax.device_get(out_un))

    # Independence: per-seed losses differ -> the pmean stayed within one seed
    # group (a pmean over the seed axis would equalise them).
    q_loss = np.asarray(jax.device_get(losses_sh["loss"]))
    assert not np.allclose(q_loss[0], q_loss[1]), "seed losses identical: pmean leaked"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_ff_ippo_seed_sharded_matches_unsharded_vmap():
    """PPO-family seed sharding (r4, API-uniform with the replay families):
    the 2-D (seed, data) mesh placement is distribution-preserving vs the
    unsharded vmap program over the same per-seed data-shard count."""
    from mava_jax import envs as environments
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs

    def tiny_cfg():
        cfg = load_config(
            "default_ff_ippo",
            [
                "env.kwargs.time_limit=8",
                "arch.num_envs=2",
                "system.rollout_length=4",
                "+system.ppo_epochs=1",
                "+system.num_minibatches=2",
                "logger.use_console=False",
            ],
        )
        cfg.system.num_updates = 2
        cfg.system.num_updates_per_eval = 2
        return cfg

    cfg_sh = tiny_cfg()
    cfg_sh.arch.n_devices = 4
    env_sh, _ = environments.make(cfg_sh)
    mesh_sh = make_seed_sharded_mesh(NUM_SEEDS)
    learn_sh, _, state_sh = vs.learner_setup(
        env_sh, jax.random.PRNGKey(7), cfg_sh, mesh_sh, NUM_SEEDS,
        seed_axis=SEED_AXIS,
    )
    # Each device holds only its LOCAL seed's params/envs.
    param_leaf = jax.tree.leaves(state_sh.params)[0]
    local_dims = {s.data.shape[0] for s in param_leaf.addressable_shards}
    assert local_dims == {NUM_SEEDS // 2}, local_dims

    out_sh = learn_sh(state_sh)

    cfg_un = tiny_cfg()
    cfg_un.arch.n_devices = 4
    env_un, _ = environments.make(cfg_un)
    mesh_un = make_mesh(jax.devices()[:4])
    learn_un, _, state_un = vs.learner_setup(
        env_un, jax.random.PRNGKey(7), cfg_un, mesh_un, NUM_SEEDS
    )
    _assert_tree_close(jax.device_get(state_sh), jax.device_get(state_un))
    out_un = learn_un(state_un)

    _assert_tree_close(
        jax.device_get((out_sh.learner_state, out_sh.train_metrics)),
        jax.device_get((out_un.learner_state, out_un.train_metrics)),
    )
    # Independence across the sharded seed axis.
    loss = np.asarray(jax.device_get(out_sh.train_metrics["total_loss"]))
    assert not np.allclose(loss[0], loss[1]), "seed losses identical: pmean leaked"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_rec_iql_seed_sharded_run_experiment_with_eval():
    """The FULL seed-sharded entry point (ADVICE r3 medium): run_experiment
    with +system.seed_shards=2 through training AND two eval cycles — the
    handoff from the 2-D (seed, data) training mesh into the fresh 1-D
    all-device eval mesh (per-seed params gather, hidden-state resharding,
    seed-sharded loss logging)."""
    from mava_jax.advanced_usage import rec_iql_vmap_seeds as vs

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
            "system.num_updates=4",
            "arch.num_evaluation=2",
            "arch.num_eval_episodes=8",
            "arch.absolute_metric=False",
            "logger.use_console=False",
            "+system.num_seeds=2",
            "+system.seed_shards=2",
        ],
    )
    perf = vs.run_experiment(cfg)
    assert isinstance(perf, float) and np.isfinite(perf)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_isac_sweep_sharded_run_experiment_with_eval():
    """Sweep-SHARDED lr entries (VERDICT r3 #2): the replay-family vmap-sweep
    path hits the same per-entry buffer HBM scaling as vmap-seeds; the 2-D
    mesh divides it identically. Full run_experiment with sweep_lrs +
    seed_shards=2 through explore, train and eval cycles."""
    from mava_jax.advanced_usage import ff_isac_vmap_seeds as vs

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
            "system.num_updates=4",
            "arch.num_evaluation=2",
            "arch.num_eval_episodes=8",
            "arch.absolute_metric=False",
            "logger.use_console=False",
            "+system.seed_shards=2",
        ],
    )
    perf = vs.run_experiment(cfg, sweep_lrs=[1e-4, 3e-4])
    assert isinstance(perf, float) and np.isfinite(perf)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_make_eval_setup_sizes_eval_for_the_full_device_count():
    """ADVICE r3 low: in seed-sharded mode cfg.arch.n_devices holds the
    PER-SEED data-shard count (n/K) while eval rides a 1-D mesh over ALL n
    devices — the evaluator must size its per-device env batches from the
    EVAL mesh's count or it runs K x the configured episodes (and warns on
    every eval)."""
    from mava_jax.advanced_usage.ff_isac_vmap_seeds import make_eval_setup
    from mava_jax.evaluator import get_num_eval_envs

    cfg = _tiny_iql_cfg()
    cfg.arch.num_envs = 2
    cfg.arch.num_eval_episodes = 32
    mesh = make_seed_sharded_mesh(2)
    cfg.arch.n_devices = mesh.shape["data"]  # 4 — what run_experiment sets

    eval_mesh, eval_cfg = make_eval_setup(cfg, mesh, SEED_AXIS)
    assert eval_mesh.devices.size == 8
    assert eval_cfg.arch.n_devices == 8
    # Episode accounting (the evaluator's own loop math): per-device envs x
    # ALL 8 mesh devices x loops covers EXACTLY the configured 32 episodes.
    # Sizing from the per-seed count (the pre-fix bug) plans loops for a
    # 4-device budget while the eval shard_map spans 8 — running 2x the
    # configured episodes and warning about divisibility on every eval.
    import math

    per_device = get_num_eval_envs(eval_cfg, absolute_metric=False)
    parallel = per_device * eval_mesh.devices.size
    loops = math.ceil(eval_cfg.arch.num_eval_episodes / parallel)
    assert loops * parallel == 32  # exact, no over-run

    buggy_parallel = get_num_eval_envs(cfg, absolute_metric=False) * 8
    buggy_loops = math.ceil(cfg.arch.num_eval_episodes / (buggy_parallel // 2))
    assert buggy_loops * buggy_parallel == 64  # the 2x over-run the fix removes
    # The training config is untouched (per-seed count preserved).
    assert cfg.arch.n_devices == 4


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device mesh")
def test_ff_ippo_seed_sharded_run_experiment_with_eval(fast_config_overrides):
    """PPO-family seed-sharded entry path end-to-end: run_experiment with
    +system.seed_shards=2 through training and eval cycles (per-seed params
    gather off the sharded seed axis into the 1-D eval mesh)."""
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs

    cfg = load_config(
        "default_ff_ippo",
        fast_config_overrides
        + [
            "env.kwargs.time_limit=16",
            "+system.num_seeds=2",
            "+system.seed_shards=2",
        ],
    )
    perf = vs.run_experiment(cfg)
    assert isinstance(perf, float) and np.isfinite(perf)
