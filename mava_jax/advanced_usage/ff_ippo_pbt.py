"""ff-IPPO with POPULATION-BASED TRAINING: exploit/explore a vmapped population.

Builds on the one-program sweep machinery: a population of N members trains on
the leading vmap axis (`ff_ippo_vmap_seeds.learner_setup` with per-member
learning rates via the swept optimizer, `utils/training.py:scale_by_swept_lr`).
Between evaluation intervals a PBT step (Jaderberg et al. 2017) runs HOST-side
on the stacked state:

  exploit — the bottom `pbt_frac` of members (by eval return) copy the params
            AND optimizer state of randomly chosen top-`pbt_frac` members;
  explore — the copied members' learning rate (an optimizer-STATE leaf, so a
            plain array gather away) is perturbed by a random factor in
            `pbt_perturb`.

Because the lr lives in optimizer state rather than a Python closure, the
whole exploit/explore step is pure array surgery — no recompilation, the same
compiled learner keeps running. The reference has no sweep or PBT story at
all (one process per config). Env states and rng streams stay member-local
(standard PBT: weights and hyperparameters migrate, experience does not).

Usage:
    python -m mava_jax.advanced_usage.ff_ippo_pbt \
        env=rware env/scenario=tiny-2ag arch.num_envs=64 \
        '+system.pbt_population=8' '+system.pbt_lr_range=[1e-4, 1e-3]'

The exploit/explore step itself is unit-tested in tests/test_pbt.py.
"""

from __future__ import annotations

import sys
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mava_jax.utils.config import Config, load_config
from mava_jax.utils.training import set_peak_lr


def pbt_exploit_explore(
    params,
    opt_states,
    returns: np.ndarray,
    key,
    frac: float = 0.25,
    perturb: Tuple[float, float] = (0.8, 1.25),
):
    """One PBT step on a stacked (leading population axis) state.

    Returns (params, opt_states, src, factors): the bottom-k members (by
    `returns`) are overwritten with a uniformly chosen top-k member's params and
    optimizer state, and their peak_lr is multiplied by a factor drawn uniformly
    from `perturb`. All other members (and every member's env/rng state, which
    is not passed in) are untouched. `src[i]` is the member i copied from
    (identity for survivors) — returned for logging/testing.
    """
    pop = returns.shape[0]
    k = max(1, int(pop * frac))
    assert 2 * k <= pop, (
        f"pbt_frac={frac} makes bottom-{k} and top-{k} overlap in a "
        f"population of {pop}; use frac <= 0.5"
    )
    order = jnp.argsort(jnp.asarray(returns))  # ascending
    bottom, top = order[:k], order[-k:]

    key, pick_key, fac_key = jax.random.split(key, 3)
    src = jnp.arange(pop).at[bottom].set(
        top[jax.random.randint(pick_key, (k,), 0, k)]
    )

    # Actor and critic optimizers carry the same per-member lr; read the
    # actor's (tree_get would see two peak_lr leaves on the combined tree).
    lrs = optax.tree_utils.tree_get(opt_states[0], "peak_lr")  # (pop,)
    factors = jnp.ones(pop).at[bottom].set(
        jax.random.uniform(fac_key, (k,), minval=perturb[0], maxval=perturb[1])
    )

    params = jax.tree.map(lambda x: x[src], params)
    opt_states = jax.tree.map(lambda x: x[src], opt_states)
    new_lrs = lrs[src] * factors
    opt_states = type(opt_states)(
        set_peak_lr(opt_states[0], new_lrs),
        set_peak_lr(opt_states[1], new_lrs),
    )
    return params, opt_states, src, factors


def resolve_rank_metric(config: Config) -> str:
    """Key of the evaluator output used to rank PBT members.

    Configs name the headline metric ``win_rate`` (SMAX/gigastep), but the
    evaluator returns the per-episode boolean array under ``won_episode``
    (`evaluator.py:92`) — ``win_rate`` is only materialized later by the
    logger. Ranking uses the mean of the per-episode array, which for
    ``won_episode`` IS the win rate.
    """
    metric = config.env.get("eval_metric", "episode_return")
    return "won_episode" if metric == "win_rate" else metric


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    import copy
    import time

    from mava_jax import envs as environments
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs
    from mava_jax.envs.wrappers import get_final_step_metrics
    from mava_jax.evaluator import get_eval_fn, make_ff_eval_act_fn
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.utils.logger import LogEvent, MavaLogger
    from mava_jax.utils.timestep_checker import check_total_timesteps

    config = copy.deepcopy(config)
    if int(config.system.get("seed_shards", 1)) > 1:
        raise ValueError(
            "system.seed_shards is not supported by the PBT programs: "
            "exploit/explore ranks and clones ACROSS the population, which "
            "needs every member's state on every device. Use the "
            "*_vmap_seeds / *_vmap_sweep programs for seed sharding."
        )
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    config.arch.n_devices = n_devices

    pop = int(config.system.get("pbt_population", 8))
    lr_range = [float(x) for x in config.system.get("pbt_lr_range", [1e-4, 1e-3])]
    frac = float(config.system.get("pbt_frac", 0.25))
    perturb = tuple(
        float(x) for x in config.system.get("pbt_perturb", [0.8, 1.25])
    )
    # Log-uniform initial lr grid across the population.
    init_lrs = list(
        np.exp(np.linspace(np.log(lr_range[0]), np.log(lr_range[1]), pop))
    )

    env, eval_env = environments.make(config, add_global_state=centralised_critic)
    key, key_e, key_pbt = jax.random.split(
        jax.random.PRNGKey(config.system.seed), 3
    )

    # num_updates derives from total_timesteps BEFORE the optimizers are built.
    config = check_total_timesteps(config)

    learn, actor_network, learner_state = vs.learner_setup(
        env, key, config, mesh, pop, centralised_critic, sweep_lrs=init_lrs
    )

    eval_act_fn = make_ff_eval_act_fn(actor_network.apply, config)
    evaluator = get_eval_fn(eval_env, eval_act_fn, config, mesh, absolute_metric=False)

    config.system.num_updates_per_eval = (
        config.system.num_updates // config.arch.num_evaluation
    )
    steps_per_rollout = (
        n_devices
        * config.system.num_updates_per_eval
        * config.system.rollout_length
        * config.arch.num_envs
    )

    logger = MavaLogger(config)
    returns = np.zeros(pop)
    # Rank members by the env's headline metric (win_rate on SMAX/gigastep,
    # episode_return elsewhere) — the same metric BASELINE tables report.
    rank_metric = resolve_rank_metric(config)

    for eval_step in range(config.arch.num_evaluation):
        start = time.time()
        out = learn(learner_state)
        jax.block_until_ready(out)
        elapsed = time.time() - start

        t = int(steps_per_rollout * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(out.episode_metrics)
        episode_metrics["steps_per_second"] = pop * steps_per_rollout / elapsed
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(out.train_metrics, t, eval_step, LogEvent.TRAIN)

        state = out.learner_state
        for m in range(pop):
            key_e, eval_key = jax.random.split(key_e)
            params_m = jax.tree.map(lambda x: x[m], state.params.actor_params)
            returns[m] = float(
                jnp.mean(evaluator(params_m, eval_key, {})[rank_metric])
            )
        lrs = np.asarray(
            optax.tree_utils.tree_get(state.opt_states[0], "peak_lr")
        )
        logger.log(
            {
                "episode_return": jnp.asarray(returns),
                "pbt_best_return": float(returns.max()),
                "pbt_best_lr": float(lrs[int(returns.argmax())]),
            },
            t,
            eval_step,
            LogEvent.EVAL,
        )

        # PBT exploit/explore between intervals (skip after the last one).
        # `+system.pbt_exploit=False` disables the step entirely, turning the
        # run into a fixed-lr population control — the exact same compiled
        # program and eval cadence, so the PBT-vs-fixed-grid comparison is a
        # clean A/B (BASELINE round-3 PBT-utility row).
        exploit_enabled = bool(config.system.get("pbt_exploit", True))
        if exploit_enabled and eval_step + 1 < config.arch.num_evaluation:
            key_pbt, step_key = jax.random.split(key_pbt)
            new_params, new_opts, src, _ = pbt_exploit_explore(
                state.params, state.opt_states, returns, step_key, frac, perturb
            )
            state = state._replace(params=new_params, opt_states=new_opts)
        learner_state = state

    best = int(returns.argmax())
    print(
        f"PBT final: best member {best} return {returns[best]:.2f} "
        f"lr {float(lrs[best]):.2e}; population returns "
        + ", ".join(f"{r:.2f}" for r in returns)
    )
    logger.stop()
    return float(returns.max())


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-IPPO PBT experiment completed.")
    return performance


if __name__ == "__main__":
    main()
