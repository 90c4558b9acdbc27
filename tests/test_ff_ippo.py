"""End-to-end integration test for ff-IPPO on the 8-device virtual mesh.

The reference tests run each system's real `run_experiment` with a shrunken config
(`test/integration_test.py:35-46`); same strategy here, plus it exercises the real
multi-device shard_map path (which the reference never tests, SURVEY.md §4)."""

from mava_jax.utils.config import load_config


def test_ff_ippo_runs_multidevice(fast_config_overrides):
    from mava_jax.systems.ppo.ff_ippo import run_experiment

    cfg = load_config(
        "default_ff_ippo", fast_config_overrides + ["env.kwargs.time_limit=16"]
    )
    perf = run_experiment(cfg)
    assert isinstance(perf, float)


def test_rollout_unroll_is_math_identical():
    """system.rollout_unroll only changes how XLA schedules the rollout scan
    (k steps per loop iteration) — outputs must be IDENTICAL to the rolled
    default from the same initial state (BASELINE r4 j040 A/B lever)."""
    import jax
    import numpy as np

    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo.ff_ippo import learner_setup
    from mava_jax.utils.config import load_config

    def build(unroll):
        cfg = load_config(
            "default_ff_ippo",
            [
                "env.kwargs.time_limit=8",
                "arch.num_envs=2",
                "system.rollout_length=4",
                f"+system.rollout_unroll={unroll}",
                "+system.ppo_epochs=1",
                "+system.num_minibatches=2",
                "logger.use_console=False",
            ],
        )
        mesh = make_mesh()
        cfg.arch.n_devices = num_learner_devices(mesh)
        cfg.system.num_updates = 2
        cfg.system.num_updates_per_eval = 2
        env, _ = environments.make(cfg)
        keys = jax.random.split(jax.random.PRNGKey(3), 3)
        return learner_setup(env, tuple(keys), cfg, mesh)

    learn1, _, state1 = build(1)
    learn4, _, state4 = build(4)
    out1 = learn1(state1)
    out4 = learn4(state4)
    for a, b in zip(
        jax.tree.leaves((out1.learner_state.params, out1.train_metrics)),
        jax.tree.leaves((out4.learner_state.params, out4.train_metrics)),
    ):
        np.testing.assert_allclose(
            np.asarray(jax.device_get(a)),
            np.asarray(jax.device_get(b)),
            rtol=1e-6,
            atol=1e-7,
        )
