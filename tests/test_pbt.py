"""Unit tests for the PBT exploit/explore step (advanced_usage/ff_ippo_pbt.py).

The step is host-side array surgery on the stacked population state; these pin
its contract: bottom-frac members receive a top-frac member's params AND
optimizer state with a perturbed lr; survivors (including every top member)
are bit-untouched; lr perturbation stays within bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mava_jax.advanced_usage.ff_ippo_pbt import (
    pbt_exploit_explore,
    resolve_rank_metric,
)
from mava_jax.systems.ppo.types import OptStates, Params
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.training import make_swept_optimizer, set_peak_lr


def _population(pop=8, seed=0):
    cfg = Config.from_dict(
        {
            "system": {
                "ppo_epochs": 1,
                "num_minibatches": 1,
                "num_updates": 10,
                "decay_learning_rates": False,
            }
        }
    )
    optim = make_swept_optimizer(cfg, 0.5)
    single = {"w": jnp.zeros((3, 2)), "b": jnp.zeros(2)}
    keys = jax.random.split(jax.random.PRNGKey(seed), pop)
    stacked = jax.vmap(
        lambda k: jax.tree.map(
            lambda x: jax.random.normal(k, x.shape), single
        )
    )(keys)
    params = Params(stacked, jax.tree.map(lambda x: x + 1.0, stacked))
    opts = OptStates(
        jax.vmap(optim.init)(params.actor_params),
        jax.vmap(optim.init)(params.critic_params),
    )
    lrs = jnp.linspace(1e-4, 1e-3, pop)
    opts = OptStates(
        set_peak_lr(opts.actor_opt_state, lrs),
        set_peak_lr(opts.critic_opt_state, lrs),
    )
    return params, opts, lrs


def test_exploit_copies_top_into_bottom_and_survivors_untouched():
    pop = 8
    params, opts, lrs = _population(pop)
    returns = np.arange(pop, dtype=np.float32)  # member i has return i
    new_params, new_opts, src, factors = pbt_exploit_explore(
        params, opts, returns, jax.random.PRNGKey(1), frac=0.25, perturb=(0.8, 1.25)
    )
    src = np.asarray(src)
    k = pop // 4
    bottom, top = list(range(k)), list(range(pop - k, pop))

    # Bottom members copied from some top member; everyone else from themselves.
    for i in range(pop):
        if i in bottom:
            assert src[i] in top
        else:
            assert src[i] == i

    for i in range(pop):
        got = jax.tree.map(lambda x: np.asarray(x[i]), new_params)
        want = jax.tree.map(lambda x: np.asarray(x[src[i]]), params)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)

    # Optimizer state migrated with the params (Adam moments follow weights).
    new_lrs = np.asarray(
        optax.tree_utils.tree_get(new_opts.actor_opt_state, "peak_lr")
    )
    new_lrs_c = np.asarray(
        optax.tree_utils.tree_get(new_opts.critic_opt_state, "peak_lr")
    )
    np.testing.assert_array_equal(new_lrs, new_lrs_c)
    for i in range(pop):
        base = float(np.asarray(lrs)[src[i]])
        if i in bottom:
            assert 0.8 * base - 1e-12 <= new_lrs[i] <= 1.25 * base + 1e-12
            assert factors[i] != 1.0
        else:
            np.testing.assert_allclose(new_lrs[i], base, rtol=0, atol=0)


def test_explore_perturbs_only_copied_members():
    pop = 4
    params, opts, lrs = _population(pop, seed=3)
    returns = np.array([5.0, 1.0, 3.0, 4.0], dtype=np.float32)  # member 1 worst
    _, new_opts, src, factors = pbt_exploit_explore(
        params, opts, returns, jax.random.PRNGKey(2), frac=0.25, perturb=(0.5, 2.0)
    )
    src = np.asarray(src)
    assert src[1] == 0  # k=1: the single worst copies the single best
    assert all(src[i] == i for i in (0, 2, 3))
    f = np.asarray(factors)
    assert 0.5 <= f[1] <= 2.0 and f[1] != 1.0
    np.testing.assert_array_equal(f[[0, 2, 3]], np.ones(3))

def test_resolve_rank_metric_maps_win_rate_to_won_episode():
    """Configs name the SMAX/gigastep headline metric 'win_rate', but the
    evaluator's output dict carries the per-episode booleans under
    'won_episode' — ranking must use the key that actually exists
    (regression: round-2 rec-PBT hardware runs crashed with
    KeyError: 'win_rate', results/r2_queue/job19_rec_pbt.log)."""
    assert (
        resolve_rank_metric(Config.from_dict({"env": {"eval_metric": "win_rate"}}))
        == "won_episode"
    )
    assert (
        resolve_rank_metric(
            Config.from_dict({"env": {"eval_metric": "episode_return"}})
        )
        == "episode_return"
    )
    assert resolve_rank_metric(Config.from_dict({"env": {}})) == "episode_return"


def test_rec_pbt_end_to_end_on_win_rate_env(fast_config_overrides):
    """rec-PBT end-to-end on SMAX — the env family whose eval_metric is
    'win_rate'. Covers the full crash path from the round-2 hardware run:
    evaluator output -> rank metric lookup -> exploit/explore (2 eval
    intervals so the PBT step itself executes once)."""
    from mava_jax.advanced_usage import rec_ippo_pbt

    cfg = load_config(
        "default_rec_ippo",
        fast_config_overrides
        + [
            "env=smax",
            "env.scenario=2s3z",
            "system.recurrent_chunk_size=2",
            "arch.num_evaluation=2",
            "+system.pbt_population=4",
        ],
    )
    perf = rec_ippo_pbt.run_experiment(cfg)
    assert isinstance(perf, float)


def test_ff_pbt_fixed_lr_control(fast_config_overrides):
    """`+system.pbt_exploit=False` turns the PBT runner into a fixed-lr
    population control (same compiled program, no exploit/explore) — the A/B
    arm of the PBT-utility comparison."""
    from mava_jax.advanced_usage import ff_ippo_pbt

    cfg = load_config(
        "default_ff_ippo",
        fast_config_overrides
        + [
            "arch.num_evaluation=2",
            "+system.pbt_population=4",
            "+system.pbt_exploit=False",
        ],
    )
    perf = ff_ippo_pbt.run_experiment(cfg)
    assert isinstance(perf, float)


def test_pbt_rejects_seed_shards():
    """PBT needs the full population on every device (exploit/explore is a
    cross-member op) — system.seed_shards must fail loudly, not silently
    no-op (review r4)."""
    import pytest

    from mava_jax.advanced_usage.ff_ippo_pbt import run_experiment
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo",
        ["+system.seed_shards=2", "logger.use_console=False"],
    )
    with pytest.raises(ValueError, match="seed_shards is not supported"):
        run_experiment(cfg)
