"""rec-IPPO with POPULATION-BASED TRAINING over the vmapped population.

Recurrent counterpart of `ff_ippo_pbt.py` (same exploit/explore step —
`pbt_exploit_explore` is state-shape-agnostic): a population of recurrent
members trains on the vmap axis, weights + optimizer state migrate between
members, learning rates perturb through optimizer state, while GRU hidden
states, env states and rng streams stay member-local.

Usage:
    python -m mava_jax.advanced_usage.rec_ippo_pbt \
        env=smax env/scenario=3s5z arch.num_envs=32 \
        '+system.pbt_population=8' '+system.pbt_lr_range=[1e-4, 1e-3]'
"""

from __future__ import annotations

import copy
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mava_jax.advanced_usage.ff_ippo_pbt import (
    pbt_exploit_explore,
    resolve_rank_metric,
)
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    from mava_jax import envs as environments
    from mava_jax.advanced_usage import rec_ippo_vmap_seeds as vs
    from mava_jax.envs.wrappers import get_final_step_metrics
    from mava_jax.evaluator import (
        get_eval_fn,
        get_num_eval_envs,
        make_rec_eval_act_fn,
    )
    from mava_jax.networks import ScannedRNN
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
    perturb = tuple(float(x) for x in config.system.get("pbt_perturb", [0.8, 1.25]))
    init_lrs = list(
        np.exp(np.linspace(np.log(lr_range[0]), np.log(lr_range[1]), pop))
    )

    if config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length

    env, eval_env = environments.make(config, add_global_state=centralised_critic)
    key, key_e, key_pbt = jax.random.split(jax.random.PRNGKey(config.system.seed), 3)

    # num_updates derives from total_timesteps BEFORE the optimizers are built.
    config = check_total_timesteps(config)

    learn, actor_network, learner_state = vs.learner_setup(
        env, key, config, mesh, pop, centralised_critic, sweep_lrs=init_lrs
    )

    eval_act_fn = make_rec_eval_act_fn(actor_network.apply, config)
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
    eval_batch_size = get_num_eval_envs(config, absolute_metric=False)
    eval_hs = ScannedRNN.initialize_carry(
        (eval_batch_size, config.system.num_agents),
        config.network.hidden_state_dim,
    )
    returns = np.zeros(pop)
    lrs = np.asarray(init_lrs)
    # Rank members by the env's headline metric (win_rate on SMAX/gigastep).
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
                jnp.mean(
                    evaluator(params_m, eval_key, {"hidden_state": eval_hs})[
                        rank_metric
                    ]
                )
            )
        lrs = np.asarray(optax.tree_utils.tree_get(state.opt_states[0], "peak_lr"))
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

        # `+system.pbt_exploit=False` disables exploit/explore, turning the run
        # into a fixed-lr population control arm (same gate as ff_ippo_pbt.py).
        exploit_enabled = bool(config.system.get("pbt_exploit", True))
        if exploit_enabled and eval_step + 1 < config.arch.num_evaluation:
            key_pbt, step_key = jax.random.split(key_pbt)
            new_params, new_opts, _, _ = pbt_exploit_explore(
                state.params, state.opt_states, returns, step_key, frac, perturb
            )
            state = state._replace(params=new_params, opt_states=new_opts)
        learner_state = state

    best = int(returns.argmax())
    print(
        f"rec PBT final: best member {best} return {returns[best]:.2f} "
        f"lr {float(lrs[best]):.2e}; population returns "
        + ", ".join(f"{r:.2f}" for r in returns)
    )
    logger.stop()
    return float(returns.max())


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IPPO PBT experiment completed.")
    return performance


if __name__ == "__main__":
    main()
