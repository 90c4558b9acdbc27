"""Equivalence of the vmapped lr-sweep learner vs stock learners at each lr.

Two claims (CLAUDE.md invariant: perf transformations are distribution-
preserving, with tests):

1. `make_swept_optimizer` + `set_peak_lr` IS the stock `make_optimizer` — same
   clipped-Adam update stream, constant and decayed — the lr just lives in
   optimizer state instead of a closure (bitwise on synthetic gradients).
2. Entry i of the batched sweep program (`ff_ippo_vmap_sweep`) matches the
   stock ff-IPPO learner configured at `sweep_lrs[i]` and started from the
   same initial state (tight tolerance: vmap batches the matmuls, so float
   accumulation order differs in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.parallel import DATA_AXIS, make_mesh, num_learner_devices
from mava_jax.systems.ppo import ff_ippo
from mava_jax.systems.ppo.types import LearnerState
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.training import (
    make_learning_rate,
    make_optimizer,
    make_swept_optimizer,
    set_peak_lr,
)


def _toy_config(decay: bool) -> Config:
    return Config.from_dict(
        {
            "system": {
                "ppo_epochs": 2,
                "num_minibatches": 2,
                "num_updates": 3,
                "decay_learning_rates": decay,
            }
        }
    )


def test_swept_optimizer_bitwise_matches_stock():
    params = {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) / 7.0}
    grads_seq = [
        {"w": jnp.sin(jnp.arange(6, dtype=jnp.float32).reshape(2, 3) + t)}
        for t in range(5)
    ]
    for decay in (False, True):
        cfg = _toy_config(decay)
        for lr in (2.5e-4, 1e-3):
            stock = make_optimizer(make_learning_rate(lr, cfg), 0.5)
            swept = make_swept_optimizer(cfg, 0.5)
            p_a, s_a = params, stock.init(params)
            p_b, s_b = params, set_peak_lr(swept.init(params), lr)
            for g in grads_seq:
                u_a, s_a = stock.update(g, s_a, p_a)
                p_a = jax.tree.map(lambda p, u: p + u, p_a, u_a)
                u_b, s_b = swept.update(g, s_b, p_b)
                p_b = jax.tree.map(lambda p, u: p + u, p_b, u_b)
            np.testing.assert_array_equal(
                np.asarray(p_a["w"]),
                np.asarray(p_b["w"]),
                err_msg=f"decay={decay} lr={lr}",
            )


def test_vmap_sweep_entry_matches_stock_learner_at_that_lr():
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs

    overrides = [
        "env.kwargs.time_limit=8",
        "arch.num_envs=2",
        "system.rollout_length=4",
        "system.num_updates=1",
        "system.ppo_epochs=1",
        "system.num_minibatches=2",
        "logger.use_console=False",
    ]
    cfg = load_config("default_ff_ippo", overrides)
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates_per_eval = 1
    sweep_lrs = [1e-4, 1e-3]

    env, _ = environments.make(cfg)
    key = jax.random.PRNGKey(0)
    learn_vmap, _, state_vmap = vs.learner_setup(
        env, key, cfg, mesh, len(sweep_lrs), sweep_lrs=sweep_lrs
    )
    out_vmap = jax.device_get(learn_vmap(state_vmap))
    state_host = jax.device_get(state_vmap)

    # Shared-init invariant: entries start from identical params/envs.
    for a, b in zip(
        jax.tree.leaves(jax.tree.map(lambda x: x[0], state_host.params)),
        jax.tree.leaves(jax.tree.map(lambda x: x[1], state_host.params)),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    for s, lr in enumerate(sweep_lrs):
        cfg_s = load_config(
            "default_ff_ippo",
            overrides + [f"system.actor_lr={lr}", f"system.critic_lr={lr}"],
        )
        cfg_s.arch.n_devices = n_devices
        cfg_s.system.num_updates_per_eval = 1
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        learn_stock, _, stock_state = ff_ippo.learner_setup(
            env, tuple(keys), cfg_s, mesh
        )

        # Start the stock learner from entry s's exact slice (params/envs/rng),
        # keeping the stock optimizer's own fresh state (zeros, like the sweep's).
        slice_s = jax.tree.map(lambda x: x[s], state_host)
        state_s = LearnerState(
            params=vs._put(slice_s.params, mesh, P()),
            opt_states=stock_state.opt_states,
            key=vs._put(slice_s.key, mesh, P(DATA_AXIS)),
            env_state=vs._put(slice_s.env_state, mesh, P(DATA_AXIS)),
            timestep=vs._put(slice_s.timestep, mesh, P(DATA_AXIS)),
        )
        out_s = jax.device_get(learn_stock(state_s))

        got = jax.tree.map(lambda x: x[s], out_vmap.learner_state)
        for field in ("params", "key", "env_state", "timestep"):
            for g, w in zip(
                jax.tree.leaves(getattr(got, field)),
                jax.tree.leaves(getattr(out_s.learner_state, field)),
            ):
                g, w = np.asarray(g), np.asarray(w)
                if np.issubdtype(g.dtype, np.floating):
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
                else:
                    np.testing.assert_array_equal(g, w)

    # The two entries must actually have DIVERGED (the lr is doing something).
    p0 = jax.tree.leaves(
        jax.tree.map(lambda x: x[0], out_vmap.learner_state.params)
    )
    p1 = jax.tree.leaves(
        jax.tree.map(lambda x: x[1], out_vmap.learner_state.params)
    )
    assert any(not np.array_equal(a, b) for a, b in zip(p0, p1))


def test_rec_vmap_sweep_entry_matches_stock_learner_at_that_lr():
    """Recurrent counterpart: entry i of the batched rec-IPPO sweep matches the
    stock rec-IPPO learner configured at sweep_lrs[i], started from entry i's
    initial state (params/envs/rng/hstates)."""
    from mava_jax.advanced_usage import rec_ippo_vmap_seeds as vs
    from mava_jax.systems.ppo import rec_ippo
    from mava_jax.systems.ppo.types import RNNLearnerState

    overrides = [
        "env.kwargs.time_limit=8",
        "network=rnn",
        "arch.num_envs=2",
        "system.rollout_length=4",
        "system.num_updates=1",
        "system.ppo_epochs=1",
        "system.num_minibatches=1",
        "logger.use_console=False",
    ]
    cfg = load_config("default_rec_ippo", overrides)
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates_per_eval = 1
    cfg.system.recurrent_chunk_size = cfg.system.rollout_length
    sweep_lrs = [1e-4, 1e-3]

    env, _ = environments.make(cfg)
    key = jax.random.PRNGKey(0)
    learn_vmap, _, state_vmap = vs.learner_setup(
        env, key, cfg, mesh, len(sweep_lrs), sweep_lrs=sweep_lrs
    )
    out_vmap = jax.device_get(learn_vmap(state_vmap))
    state_host = jax.device_get(state_vmap)

    for s, lr in enumerate(sweep_lrs):
        cfg_s = load_config(
            "default_rec_ippo",
            overrides + [f"system.actor_lr={lr}", f"system.critic_lr={lr}"],
        )
        cfg_s.arch.n_devices = n_devices
        cfg_s.system.num_updates_per_eval = 1
        cfg_s.system.recurrent_chunk_size = cfg_s.system.rollout_length
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        learn_stock, _, stock_state = rec_ippo.learner_setup(
            env, tuple(keys), cfg_s, mesh
        )

        slice_s = jax.tree.map(lambda x: x[s], state_host)
        state_s = RNNLearnerState(
            params=vs._put(slice_s.params, mesh, P()),
            opt_states=stock_state.opt_states,
            key=vs._put(slice_s.key, mesh, P(DATA_AXIS)),
            env_state=vs._put(slice_s.env_state, mesh, P(DATA_AXIS)),
            timestep=vs._put(slice_s.timestep, mesh, P(DATA_AXIS)),
            dones=vs._put(slice_s.dones, mesh, P(DATA_AXIS)),
            hstates=vs._put(slice_s.hstates, mesh, P(DATA_AXIS)),
        )
        out_s = jax.device_get(learn_stock(state_s))

        got = jax.tree.map(lambda x: x[s], out_vmap.learner_state)
        for field in ("params", "key", "env_state", "timestep", "dones", "hstates"):
            for g, w in zip(
                jax.tree.leaves(getattr(got, field)),
                jax.tree.leaves(getattr(out_s.learner_state, field)),
            ):
                g, w = np.asarray(g), np.asarray(w)
                if np.issubdtype(g.dtype, np.floating):
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
                else:
                    np.testing.assert_array_equal(g, w)


def test_swept_adam_bitwise_matches_stock_sac_optimizer():
    """make_swept_adam (lr in state) IS chain(clip, adam(lr)) — the SAC
    family's optimizer — on a synthetic gradient stream."""
    import optax

    from mava_jax.utils.training import make_swept_adam

    params = {"w": jnp.arange(8, dtype=jnp.float32).reshape(2, 4) / 3.0}
    for lr in (3e-4, 1e-3):
        stock = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
        swept = make_swept_adam(lr, 10.0)
        p_a, s_a = params, stock.init(params)
        p_b, s_b = params, swept.init(params)
        for t in range(5):
            g = {"w": jnp.cos(jnp.arange(8, dtype=jnp.float32).reshape(2, 4) + t)}
            u_a, s_a = stock.update(g, s_a, p_a)
            p_a = jax.tree.map(lambda p, u: p + u, p_a, u_a)
            u_b, s_b = swept.update(g, s_b, p_b)
            p_b = jax.tree.map(lambda p, u: p + u, p_b, u_b)
        np.testing.assert_array_equal(np.asarray(p_a["w"]), np.asarray(p_b["w"]))


def test_isac_vmap_sweep_entry_matches_stock_at_that_lr():
    """Entry i of the batched SAC lr sweep (same seed everywhere, lr in
    optimizer state) matches the stock non-swept ff-ISAC — params, replay
    buffer and counters — run at policy_lr=q_lr=sweep_lrs[i]."""
    from mava_jax.advanced_usage import ff_isac_vmap_seeds as vs
    from mava_jax.parallel import build_learner
    from mava_jax.systems.sac import ff_isac

    overrides = [
        "env=maswarm",
        "env.kwargs.time_limit=8",
        "arch.num_envs=2",
        "system.rollout_length=2",
        "system.explore_steps=8",
        "system.buffer_size=32",
        "system.batch_size=4",
        "system.epochs=2",
        "logger.use_console=False",
    ]
    cfg = load_config("default_ff_isac", overrides)
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.scan_steps = 2
    sweep_lrs = [1e-4, 1e-3]

    _, _, (explore_v, update_v), state_v, _ = vs.learner_setup(
        cfg, mesh, len(sweep_lrs), sweep_lrs=sweep_lrs
    )
    mid_v, _ = explore_v(state_v)
    out_v, _ = update_v(mid_v)
    out_v = jax.device_get(out_v)

    for s, lr in enumerate(sweep_lrs):
        cfg_s = load_config(
            "default_ff_isac",
            overrides + [f"system.policy_lr={lr}", f"system.q_lr={lr}"],
        )
        cfg_s.arch.n_devices = cfg.arch.n_devices
        cfg_s.system.scan_steps = 2
        envs_, networks, optims, rb, ls, target_entropy, _ = ff_isac.init(cfg_s, mesh)
        explore_fn, update_fn = ff_isac.make_update_fns(
            cfg_s, envs_[0], networks, optims, rb, target_entropy, False
        )
        stock_specs = ff_isac._state_specs(jax.device_get(ls).buffer_state)
        explore_s = build_learner(
            explore_fn, mesh, in_specs=(stock_specs,),
            out_specs=(stock_specs, P(None, DATA_AXIS)),
        )
        update_s = build_learner(
            update_fn, mesh, in_specs=(stock_specs,),
            out_specs=(stock_specs, (P(None, None, DATA_AXIS), P())),
        )
        mid_s, _ = explore_s(ls)
        out_s, _ = update_s(mid_s)
        out_s = jax.device_get(out_s)

        got = jax.tree.map(lambda x: x[s], out_v)
        for field in ("params", "buffer_state", "t", "key", "env_state"):
            for g, w in zip(
                jax.tree.leaves(getattr(got, field)),
                jax.tree.leaves(getattr(out_s, field)),
            ):
                g, w = np.asarray(g), np.asarray(w)
                if np.issubdtype(g.dtype, np.floating):
                    np.testing.assert_allclose(
                        g, w, rtol=1e-4, atol=1e-6, err_msg=field
                    )
                else:
                    np.testing.assert_array_equal(g, w, err_msg=field)


def test_rec_iql_vmap_sweep_entry_matches_stock_at_that_lr():
    """Entry i of the batched rec-IQL lr sweep matches the stock non-swept
    rec-IQL (params, trajectory buffer, counters) run at q_lr=sweep_lrs[i]
    from the same seed."""
    from mava_jax.advanced_usage import rec_iql_vmap_seeds as vs
    from mava_jax.systems.q_learning import rec_iql

    overrides = [
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
    ]
    cfg = load_config("default_rec_iql", overrides)
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.scan_steps = 2
    sweep_lrs = [1e-4, 1e-3]

    _, _, update_v, state_v = vs.learner_setup(
        cfg, mesh, len(sweep_lrs), sweep_lrs=sweep_lrs
    )
    out_v, _ = update_v(state_v)
    out_v = jax.device_get(out_v)

    for s, lr in enumerate(sweep_lrs):
        cfg_s = load_config("default_rec_iql", overrides + [f"system.q_lr={lr}"])
        cfg_s.arch.n_devices = cfg.arch.n_devices
        cfg_s.system.scan_steps = 2
        envs_, q_net, opt, rb, ls, _ = rec_iql.init(cfg_s, mesh)
        update_s = rec_iql.build_learn_fn(
            cfg_s, envs_[0], q_net, opt, rb, mesh, jax.device_get(ls).buffer_state
        )
        out_s, _ = update_s(ls)
        out_s = jax.device_get(out_s)

        got = jax.tree.map(lambda x: x[s], out_v)
        for field in ("params", "buffer_state", "time_steps", "train_steps", "key"):
            for g, w in zip(
                jax.tree.leaves(getattr(got, field)),
                jax.tree.leaves(getattr(out_s, field)),
            ):
                g, w = np.asarray(g), np.asarray(w)
                if np.issubdtype(g.dtype, np.floating):
                    np.testing.assert_allclose(
                        g, w, rtol=1e-4, atol=1e-6, err_msg=field
                    )
                else:
                    np.testing.assert_array_equal(g, w, err_msg=field)


def test_decay_schedule_clamps_at_zero_past_horizon():
    """Past the planned horizon the lr must hold at 0, not go negative
    (regression for the gradient-ascent failure mode), in BOTH the stock
    schedule and the swept optimizer."""
    from mava_jax.utils.training import make_learning_rate_schedule

    cfg = _toy_config(decay=True)  # horizon = 2*2*3 = 12 updates
    sched = make_learning_rate_schedule(1e-3, cfg)
    assert float(sched(12)) == 0.0
    assert float(sched(50)) == 0.0
    assert float(sched(6)) > 0.0

    swept = make_swept_optimizer(cfg, 10.0)
    params = {"w": jnp.ones(3)}
    state = set_peak_lr(swept.init(params), 1e-3)
    g = {"w": jnp.ones(3)}
    for _ in range(20):  # run well past the 12-update horizon
        u, state = swept.update(g, state, params)
    np.testing.assert_array_equal(np.asarray(u["w"]), np.zeros(3))


def test_parse_sweep_lrs_accepts_yaml_list_and_comma_string():
    """CLI robustness: yaml parses `[1e-4, 3e-4]` to a list of STRINGS (bare
    scientific notation is not a yaml float), and users may also pass a plain
    comma string — both must coerce to floats."""
    from mava_jax.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs

    cfg = Config.from_dict({"system": {"sweep_lrs": ["1e-4", "3e-4", 0.001]}})
    assert parse_sweep_lrs(cfg) == [1e-4, 3e-4, 1e-3]
    cfg = Config.from_dict({"system": {"sweep_lrs": "1e-4, 3e-4"}})
    assert parse_sweep_lrs(cfg) == [1e-4, 3e-4]
    cfg = Config.from_dict({"system": {}})
    assert len(parse_sweep_lrs(cfg)) == 4  # documented default grid
