"""`system.reward_scale` (SAC TD-target scaling, default 1.0).

The knob exists for the MaSwarm epochs=32 joint-critic divergence ablation
(BASELINE.md parity notes): scaling the reward term of the TD target shrinks
the Q magnitude the critic extrapolates, everything else untouched. These
tests pin the contract: the update is deterministic, and reward_scale changes
ONLY the critic target (same data, same RNG -> different Q params).
"""

import jax

from mava_jax.parallel import make_mesh, num_learner_devices
from mava_jax.systems.sac import ff_isac
from mava_jax.utils.config import load_config
from mava_jax.utils.timestep_checker import check_total_timesteps

TINY = [
    "system.num_updates=4",
    "arch.num_evaluation=1",
    "system.rollout_length=2",
    "arch.num_envs=2",
    "system.buffer_size=64",
    "system.explore_steps=8",
    "system.batch_size=4",
    "system.epochs=2",
    "env.kwargs.time_limit=16",
    "logger.use_console=False",
]


def _one_update(reward_scale: float):
    cfg = load_config(
        "default_ff_isac", TINY + [f"system.reward_scale={reward_scale}"]
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg = check_total_timesteps(cfg)
    cfg.system.scan_steps = 2

    explore, update, state = ff_isac.build_bench_learners(cfg, mesh)
    state, _ = explore(state)
    state, _ = update(state)
    return jax.device_get(state.params)


def test_reward_scale_default_is_deterministic_identity():
    a = _one_update(1.0)
    b = _one_update(1.0)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert (x == y).all()


def test_reward_scale_changes_only_the_critic_update():
    base = _one_update(1.0)
    scaled = _one_update(0.1)
    # Same data and RNG: the Q params must differ (the TD target moved)...
    q_diff = any(
        not (x == y).all()
        for x, y in zip(
            jax.tree.leaves(base.q.online), jax.tree.leaves(scaled.q.online)
        )
    )
    assert q_diff, "reward_scale=0.1 left the critic update unchanged"


def test_global_state_dedup_roundtrip():
    """Replay-buffer global-state dedup (compress at write, expand at sample)
    is lossless: GlobalStateWrapper gives every agent the same vector."""
    import jax.numpy as jnp

    from mava_jax.types import ObservationGlobalState

    obs = ObservationGlobalState(
        agents_view=jnp.arange(24.0).reshape(2, 4, 3),
        action_mask=jnp.ones((2, 4, 5)),
        global_state=jnp.broadcast_to(jnp.arange(7.0), (2, 4, 7)),
        step_count=jnp.zeros((2, 4)),
    )
    stored = ff_isac.compress_stored_obs(obs)
    assert stored.global_state.shape == (2, 1, 7)
    restored = ff_isac.expand_sampled_obs(stored, 4)
    for a, b in zip(jax.tree.leaves(obs), jax.tree.leaves(restored)):
        assert (a == b).all()


def test_q_divergence_warning_fires_on_synthetic_divergence():
    """The j200 guardrail (VERDICT r3 #6): a runtime warning fires when mean
    |Q| exceeds the configured bound, naming the reward_scale fix; healthy
    magnitudes stay silent."""
    import warnings

    import jax.numpy as jnp
    import pytest

    from mava_jax.utils.training import warn_q_divergence

    divergent = {"q1_a_vals": jnp.float32(12_000.0), "q2_a_vals": jnp.float32(9.0)}
    with pytest.warns(UserWarning, match="reward_scale"):
        assert warn_q_divergence(divergent, 1000.0, "ff_masac") is True

    # Negative divergence trips the |.| bound too.
    with pytest.warns(UserWarning, match="q_divergence_warn_bound"):
        assert warn_q_divergence({"mean_q": jnp.float32(-5e4)}, 1000.0) is True

    # NaN is the TERMINAL state of the divergence (inf-inf in the TD math) —
    # it must fire, not silently compare False against the bound.
    with pytest.warns(UserWarning, match="diverging"):
        assert warn_q_divergence({"mean_q": jnp.float32(float("nan"))}, 1000.0) is True

    healthy = {"q1_a_vals": jnp.float32(42.0), "mean_q": jnp.float32(-17.0)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert warn_q_divergence(healthy, 1000.0) is False

    # Loss dicts without Q keys (PPO-family) are a silent no-op.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert warn_q_divergence({"total_loss": jnp.float32(1e9)}, 1000.0) is False
