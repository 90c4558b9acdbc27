"""System x env integration matrix, run end-to-end on the 8-device virtual mesh with
shrunken configs (the reference's strategy, `test/integration_test.py`)."""

import pytest

from mava_jax.utils.config import load_config


def _run(module_name: str, default: str, overrides):
    import importlib

    module = importlib.import_module(f"mava_jax.systems.{module_name}")
    cfg = load_config(default, overrides)
    return module.run_experiment(cfg)


def test_ff_mappo(fast_config_overrides):
    perf = _run(
        "ppo.ff_mappo",
        "default_ff_mappo",
        fast_config_overrides + ["env.kwargs.time_limit=16", "env.scenario=tiny-4ag"],
    )
    assert isinstance(perf, float)


def test_rec_ippo(fast_config_overrides):
    perf = _run(
        "ppo.rec_ippo",
        "default_rec_ippo",
        fast_config_overrides
        + ["env.kwargs.time_limit=16", "system.recurrent_chunk_size=2"],
    )
    assert isinstance(perf, float)


def test_rec_mappo(fast_config_overrides):
    perf = _run(
        "ppo.rec_mappo",
        "default_rec_mappo",
        fast_config_overrides + ["env.kwargs.time_limit=16"],
    )
    assert isinstance(perf, float)


def test_rec_iql(fast_config_overrides):
    perf = _run(
        "q_learning.rec_iql",
        "default_rec_iql",
        fast_config_overrides
        + [
            "env.kwargs.time_limit=16",
            "system.num_updates=8",
            "system.rollout_length=2",
            "system.buffer_size=64",
            "system.min_buffer_size=4",
            "system.sample_batch_size=4",
            "system.sample_sequence_length=4",
        ],
    )
    assert isinstance(perf, float)


def test_ff_isac(fast_config_overrides):
    perf = _run(
        "sac.ff_isac",
        "default_ff_isac",
        fast_config_overrides
        + [
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_masac(fast_config_overrides):
    perf = _run(
        "sac.ff_masac",
        "default_ff_masac",
        fast_config_overrides
        + [
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_ippo_smax(fast_config_overrides):
    perf = _run(
        "ppo.ff_ippo",
        "default_ff_ippo",
        fast_config_overrides + ["env=smax", "env.scenario=2s3z"],
    )
    assert isinstance(perf, float)


def test_ff_mappo_lbf(fast_config_overrides):
    perf = _run(
        "ppo.ff_mappo",
        "default_ff_mappo",
        fast_config_overrides + ["env=lbf"],
    )
    assert isinstance(perf, float)


def test_ff_masac_mareacher(fast_config_overrides):
    """MASAC on the articulated-arm env (joint-factorized continuous control)."""
    perf = _run(
        "sac.ff_masac",
        "default_ff_masac",
        fast_config_overrides
        + [
            "env=mareacher",
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_ippo_cleaner_cnn(fast_config_overrides):
    """CNN torso composed through a full system run (reference matrix pairs grid
    envs with network=cnn, `test/integration_test.py:111-124`)."""
    perf = _run(
        "ppo.ff_ippo",
        "default_ff_ippo",
        fast_config_overrides + ["env=cleaner", "network=cnn"],
    )
    assert isinstance(perf, float)


def test_rec_mappo_connector_rcnn(fast_config_overrides):
    """Recurrent CNN (rcnn) torso through a recurrent CTDE system on a grid env."""
    perf = _run(
        "ppo.rec_mappo",
        "default_rec_mappo",
        fast_config_overrides
        + ["env=connector", "network=rcnn", "system.recurrent_chunk_size=2"],
    )
    assert isinstance(perf, float)


def test_store_experience(fast_config_overrides, tmp_path, monkeypatch):
    import os

    monkeypatch.chdir(tmp_path)
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo", fast_config_overrides + ["env.kwargs.time_limit=16"]
    )
    cfg.logger.system_name = "store_exp_test"
    from mava_jax.advanced_usage.ff_ippo_store_experience import run_experiment

    perf = run_experiment(cfg)
    assert isinstance(perf, float)
    vault_dirs = list((tmp_path / "vaults" / "store_exp_test").iterdir())
    assert len(vault_dirs) == 1
    assert (vault_dirs[0] / "manifest.json").exists()


def test_ff_isac_maswimmer(fast_config_overrides):
    """ISAC on the locomotion env (free-floating joint-factorized swimmer)."""
    perf = _run(
        "sac.ff_isac",
        "default_ff_isac",
        fast_config_overrides
        + [
            "env=maswimmer",
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_masac_mahopper(fast_config_overrides):
    """MASAC on the contact-locomotion env: exercises real termination
    (discount 0 on falls) through the off-policy bootstrap + the CTDE joint
    critic on a 3-agent continuous task."""
    perf = _run(
        "sac.ff_masac",
        "default_ff_masac",
        fast_config_overrides
        + [
            "env=mahopper",
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_isac_macheetah(fast_config_overrides):
    """ISAC on the tree-kinematics contact env (halfcheetah 6x1: 6 agents)."""
    perf = _run(
        "sac.ff_isac",
        "default_ff_isac",
        fast_config_overrides
        + [
            "env=macheetah",
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_isac_maant(fast_config_overrides):
    """ISAC on the 3D quadruped (ant_4x2): exercises the point-cloud Lagrangian
    engine + tilt termination through the off-policy bootstrap."""
    perf = _run(
        "sac.ff_isac",
        "default_ff_isac",
        fast_config_overrides
        + [
            "env=maant",
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_masac_mahumanoid(fast_config_overrides):
    """MASAC on the heterogeneous humanoid (9|8 padded split): exercises the
    masked/padded action column through the CTDE joint-action critic."""
    perf = _run(
        "sac.ff_masac",
        "default_ff_masac",
        fast_config_overrides
        + [
            "env=mahumanoid",
            "env.kwargs.time_limit=16",
            "system.num_updates=16",
            "system.rollout_length=2",
            "system.buffer_size=128",
            "system.explore_steps=8",
            "system.batch_size=4",
            "system.epochs=2",
        ],
    )
    assert isinstance(perf, float)


def test_ff_ippo_continuous_maswarm(fast_config_overrides):
    """PPO with the continuous tanh-Normal head (network=continuous_mlp) end-to-end —
    exercises TanhNormal.sample_from_noise in the hoisted-RNG rollout."""
    perf = _run(
        "ppo.ff_ippo",
        "default_ff_ippo",
        fast_config_overrides
        + ["env=maswarm", "network=continuous_mlp", "env.kwargs.time_limit=16"],
    )
    assert isinstance(perf, float)


def test_rec_iql_epsilon_schedule_and_global_step_counting():
    """Pins the eps-decay deviation from the reference (rec_iql.py:277 counts
    per-shard steps): the schedule is linear 1 -> eps_min over eps_decay GLOBAL
    env steps, and one fused call advances the counter by
    scan_steps * rollout_length * num_envs * n_devices."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    import numpy as np

    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.q_learning import rec_iql
    from mava_jax.utils.config import Config, load_config

    # Schedule shape (pure function of the global step count).
    cfg_s = SimpleNamespace(system=Config({"eps_min": 0.05, "eps_decay": 1000}))
    sched = rec_iql.epsilon_schedule
    np.testing.assert_allclose(float(sched(cfg_s, 0)), 1.0)
    np.testing.assert_allclose(float(sched(cfg_s, 500)), 1 - 0.5 * 0.95, rtol=1e-6)
    np.testing.assert_allclose(float(sched(cfg_s, 1000)), 0.05, rtol=1e-6)
    np.testing.assert_allclose(float(sched(cfg_s, 10_000)), 0.05, rtol=1e-6)  # clamped

    # Global step counting through the real fused update on the 8-device mesh.
    cfg = load_config(
        "default_rec_iql",
        [
            "env.kwargs.time_limit=16",
            "arch.num_envs=2",
            "system.rollout_length=2",
            "system.buffer_size=64",
            "system.min_buffer_size=4",
            "system.sample_batch_size=4",
            "system.sample_sequence_length=4",
            "system.epochs=1",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.scan_steps = 3
    (env, _), q_net, opt, rb, state, _ = rec_iql.init(cfg, mesh)
    update = rec_iql.build_learn_fn(cfg, env, q_net, opt, rb, mesh, state.buffer_state)

    state2, _ = update(state)
    expected = 3 * cfg.system.rollout_length * cfg.arch.num_envs * n_devices
    got = int(np.ravel(np.asarray(jnp.asarray(state2.time_steps)))[0])
    assert got == expected, (got, expected)


def test_ff_ippo_vmap_seeds(fast_config_overrides):
    """N independent seeds trained in ONE compiled program (vmap inside shard_map);
    per-seed grad pmean over the mesh axis rides the vmap automatically."""
    from mava_jax.advanced_usage.ff_ippo_vmap_seeds import run_experiment

    cfg = load_config(
        "default_ff_ippo",
        fast_config_overrides + ["env.kwargs.time_limit=16", "+system.num_seeds=3"],
    )
    perf = run_experiment(cfg)
    assert isinstance(perf, float)


def test_rec_ippo_vmap_seeds(fast_config_overrides):
    from mava_jax.advanced_usage.rec_ippo_vmap_seeds import run_experiment

    cfg = load_config(
        "default_rec_ippo",
        fast_config_overrides
        + [
            "env.kwargs.time_limit=16",
            "system.recurrent_chunk_size=2",
            "+system.num_seeds=2",
        ],
    )
    perf = run_experiment(cfg)
    assert isinstance(perf, float)


def test_ff_mappo_vmap_seeds(fast_config_overrides):
    """CTDE delta composes with the seed axis: centralised critic + global state."""
    from mava_jax.advanced_usage.ff_mappo_vmap_seeds import run_experiment

    cfg = load_config(
        "default_ff_mappo",
        fast_config_overrides + ["env.kwargs.time_limit=16", "+system.num_seeds=2"],
    )
    perf = run_experiment(cfg)
    assert isinstance(perf, float)


def test_rec_mappo_vmap_seeds(fast_config_overrides):
    from mava_jax.advanced_usage.rec_mappo_vmap_seeds import run_experiment

    cfg = load_config(
        "default_rec_mappo",
        fast_config_overrides
        + [
            "env.kwargs.time_limit=16",
            "system.recurrent_chunk_size=2",
            "+system.num_seeds=2",
        ],
    )
    perf = run_experiment(cfg)
    assert isinstance(perf, float)


class _GruImplSpy:
    """Records the ScannedRNN implementation each trace resolves, to prove the
    config wiring selected the intended path (the impl is threaded through
    network construction — there is no module global to assert on)."""

    def __enter__(self):
        from mava_jax.networks import actor_critic

        self._mod = actor_critic
        self._orig = actor_critic.resolve_gru_impl
        self.traced = []

        def spy(impl=None):
            self.traced.append(self._orig(impl))
            return self.traced[-1]

        actor_critic.resolve_gru_impl = spy
        return self

    def __exit__(self, *exc):
        self._mod.resolve_gru_impl = self._orig
        return False


def test_rec_ippo_cell_gru(fast_config_overrides):
    """rec-IPPO end-to-end with network.gru_impl=cell: the per-step reference
    GRU composes with shard_map over the 8-device mesh, chunked BPTT and the
    evaluator — the full system surface, not just the cell in isolation."""
    with _GruImplSpy() as spy:
        perf = _run(
            "ppo.rec_ippo",
            "default_rec_ippo",
            fast_config_overrides
            + [
                "env.kwargs.time_limit=16",
                "system.recurrent_chunk_size=2",
                "network.gru_impl=cell",
            ],
        )
    # The config wiring must actually have traced the cell path, and only it.
    assert spy.traced and set(spy.traced) == {"cell"}
    assert isinstance(perf, float)


def test_rec_iql_cell_gru(fast_config_overrides):
    """rec-IQL end-to-end with network.gru_impl=cell — its replay-train BPTT
    feeds resets with a trailing singleton agent axis, broadcast against the
    carry in the per-step path as in the hoisted one."""
    with _GruImplSpy() as spy:
        perf = _run(
            "q_learning.rec_iql",
            "default_rec_iql",
            fast_config_overrides
            + [
                "env.kwargs.time_limit=16",
                "system.num_updates=8",
                "system.rollout_length=2",
                "system.buffer_size=64",
                "system.min_buffer_size=4",
                "system.sample_batch_size=4",
                "system.sample_sequence_length=4",
                "network.gru_impl=cell",
            ],
        )
    assert spy.traced and set(spy.traced) == {"cell"}
    assert isinstance(perf, float)


def test_rec_iql_fused_target_pass_equivalence():
    """system.fused_target_pass folds double-DQN's online-greedy + target GRU
    passes over next_obs into ONE vmapped pass of stacked params — a
    distribution-preserving perf transformation (CLAUDE.md invariant). Same
    initial state, same sampled data => same greedy actions, targets,
    gradients and updated params as the legacy sequential double pass."""
    import copy

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.q_learning import rec_iql

    cfg = load_config(
        "default_rec_iql",
        [
            "env=smax",
            "env/scenario=2s3z",  # action masks exercise the masked argmax
            "arch.num_envs=2",
            "system.rollout_length=4",
            "system.buffer_size=32",
            "system.min_buffer_size=4",
            "system.sample_batch_size=4",
            "system.sample_sequence_length=8",
            "system.epochs=2",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.scan_steps = 2

    cfg_fused = copy.deepcopy(cfg)
    cfg_fused.system.fused_target_pass = True
    cfg_unfused = copy.deepcopy(cfg)
    cfg_unfused.system.fused_target_pass = False

    (env, _), q_net, opt, rb, state, _ = rec_iql.init(cfg_fused, mesh)
    upd_f = rec_iql.build_learn_fn(
        cfg_fused, env, q_net, opt, rb, mesh, state.buffer_state
    )
    upd_u = rec_iql.build_learn_fn(
        cfg_unfused, env, q_net, opt, rb, mesh, state.buffer_state
    )

    state_f, (_, losses_f) = upd_f(state)
    state_u, (_, losses_u) = upd_u(state)

    for g, w in zip(
        jax.tree.leaves((state_f.params, losses_f)),
        jax.tree.leaves((state_u.params, losses_u)),
    ):
        g, w = np.asarray(jnp.asarray(g)), np.asarray(jnp.asarray(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_two_systems_different_gru_impl_one_process(fast_config_overrides):
    """Two recurrent SYSTEMS built with different network.gru_impl coexist in
    one process. rec-IQL runs on the cell path, then rec-IPPO on the hoisted
    one, so any module-global leakage (the old design: last setup wins) would
    misroute one of them. The spy proves rec-IQL traced only the cell path and
    rec-IPPO only the hoisted one."""
    with _GruImplSpy() as spy:
        perf_iql = _run(
            "q_learning.rec_iql",
            "default_rec_iql",
            fast_config_overrides
            + [
                "env.kwargs.time_limit=16",
                "system.num_updates=8",
                "system.rollout_length=2",
                "system.buffer_size=64",
                "system.min_buffer_size=4",
                "system.sample_batch_size=4",
                "system.sample_sequence_length=4",
                "network.gru_impl=cell",
            ],
        )
        iql_traced = list(spy.traced)
        assert iql_traced and set(iql_traced) == {"cell"}
        perf_ippo = _run(
            "ppo.rec_ippo",
            "default_rec_ippo",
            fast_config_overrides
            + [
                "env.kwargs.time_limit=16",
                "system.recurrent_chunk_size=2",
                "network.gru_impl=hoisted",
            ],
        )
        ippo_traced = spy.traced[len(iql_traced):]
        assert ippo_traced and set(ippo_traced) == {"hoisted"}
    assert isinstance(perf_iql, float) and isinstance(perf_ippo, float)
