"""rec-IQL with VMAPPED SEEDS: N independent Q-learning seeds in ONE program.

Same pattern as `ff_isac_vmap_seeds.py`: the stock `rec_iql.init` runs once
per seed (seed s = `system.seed + s`), the learner states are stacked on a
leading axis, and the stock fused act+train update fn is wrapped in
`jax.vmap` inside `shard_map` with the stock sharding specs lifted by one
unsharded seed axis. The epsilon schedule is driven by the per-seed
`time_steps` counter, which advances identically across seeds, so every seed
sees exactly the stock exploration schedule. Replay memory is replicated per
seed (`num_seeds * buffer_size` trajectories of device memory). Under vmap
the buffer write's dynamic-slice fast path becomes a scatter; what that costs
per seed on the GPU is not measured yet (ROADMAP S5). This program is the
correctness-tested building block for multi-device `seed_shards` placement.

Multi-chip escape hatch: `+system.seed_shards=K` shards the seed axis over a
2-D `(seed, data)` mesh (`make_seed_sharded_mesh`) so each device holds only
`num_seeds / K` buffers; the stock update's `pmean('data')` then syncs within
one seed group by mesh construction, so independent seeds never mix. On an
8-chip slice, 8 seeds at `seed_shards=8` cost the HBM of ONE stock run per
chip.

Usage:
    python -m mava_jax.advanced_usage.rec_iql_vmap_seeds \
        env=smax env/scenario=2s3z +system.num_seeds=4
    # 8 seeds, one replay buffer per chip, on an 8-chip slice:
    python -m mava_jax.advanced_usage.rec_iql_vmap_seeds \
        env=smax env/scenario=2s3z +system.num_seeds=8 +system.seed_shards=8
"""

from __future__ import annotations

import copy
import time
from typing import Any, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mava_jax.advanced_usage.ff_isac_vmap_seeds import (
    lift_specs,
    make_eval_setup,
    make_seed_mesh,
    make_stacked_experience,
    place_state,
    split_buffer_experience,
    stack_states,
)
from mava_jax.envs.wrappers import get_final_step_metrics
from mava_jax.evaluator import get_eval_fn, get_num_eval_envs
from mava_jax.networks import ScannedRNN
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
    make_mesh,
)
from mava_jax.systems.q_learning import rec_iql
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.timestep_checker import check_total_timesteps


# Sharding layout comes from the stock system — single source of truth.
_stock_specs = rec_iql._state_specs


def learner_setup(
    cfg: Config, mesh, num_seeds: int, sweep_lrs=None, seed_axis=None
) -> Tuple[Any, Any, Any, Any]:
    """Per-seed stock init, stacked. With `sweep_lrs`, entries share the SAME
    seed and differ only in q_lr, baked into optimizer state by the swept-Adam
    init (`rec_iql.init(swept_lr=True)`).

    With `seed_axis=SEED_AXIS`, `mesh` is a 2-D `(seed, data)` mesh and the
    seed axis is SHARDED: each device holds `num_seeds / seed_shards` replay
    buffers instead of all of them, which lifts the vmap-seeds device-memory
    bound. The stock fused act+train update
    is reused verbatim; its `pmean(DATA_AXIS)` reduces within one seed group
    by mesh construction."""
    setup_mesh = make_mesh(list(mesh.devices[0])) if seed_axis else mesh
    states = []
    for s in range(num_seeds):
        cfg_s = copy.deepcopy(cfg)
        if sweep_lrs is None:
            cfg_s.system.seed = int(cfg.system.seed) + s
        else:
            cfg_s.system.q_lr = float(sweep_lrs[s])
        envs_, q_net, opt, rb, ls, _ = rec_iql.init(
            cfg_s, setup_mesh, swept_lr=sweep_lrs is not None
        )
        # Replay experience stays on device (GB-scale zeros; r5 j062): strip it
        # before the host transfer and recreate the stacked zeros in place.
        ls, exp_template = split_buffer_experience(ls)
        states.append(jax.device_get(ls))
        del ls  # free seed s's device arrays before seed s+1 allocates
    stacked = stack_states(states)

    buffer_template = stacked.buffer_state.replace(experience=exp_template)
    seed_specs = lift_specs(_stock_specs(buffer_template), seed_axis)
    small_specs = seed_specs._replace(
        buffer_state=seed_specs.buffer_state.replace(experience=())
    )
    learner_state = place_state(stacked, small_specs, mesh)
    experience = make_stacked_experience(
        exp_template, num_seeds, seed_specs.buffer_state.experience, mesh
    )
    learner_state = learner_state._replace(
        buffer_state=learner_state.buffer_state.replace(experience=experience)
    )

    env, eval_env = envs_
    cfg.system.num_agents = env.num_agents  # init() set it only on seed copies
    update_fn = rec_iql.make_update_fn(cfg, env, q_net, opt, rb)
    update = build_learner(
        jax.vmap(update_fn),
        mesh,
        in_specs=(seed_specs,),
        out_specs=(
            seed_specs,
            (lift_specs(P(None, None, DATA_AXIS), seed_axis), lift_specs(P(), seed_axis)),
        ),
        donate=cfg.arch.get("donate_buffers", False),
    )
    return (env, eval_env), q_net, update, learner_state


def run_experiment(cfg: Config, sweep_lrs=None) -> float:
    cfg = copy.deepcopy(cfg)
    if sweep_lrs is not None:
        num_seeds = len(sweep_lrs)
    else:
        num_seeds = int(cfg.system.get("num_seeds", 4))
    mesh, seed_axis = make_seed_mesh(cfg, num_seeds)
    # Per-seed data-shard count (the whole mesh unless the seed axis is sharded).
    n_devices = mesh.shape[DATA_AXIS]
    cfg.arch.n_devices = n_devices
    cfg = check_total_timesteps(cfg)

    steps_per_rollout = int(cfg.system.total_timesteps // cfg.arch.num_evaluation)
    anakin_act_steps = n_devices * cfg.arch.num_envs * cfg.system.rollout_length
    cfg.system.scan_steps = max(1, int(steps_per_rollout / anakin_act_steps))

    (env, eval_env), q_net, update, learner_state = learner_setup(
        cfg, mesh, num_seeds, sweep_lrs=sweep_lrs, seed_axis=seed_axis
    )

    logger = MavaLogger(cfg)
    key = jax.random.PRNGKey(cfg.system.seed)

    def eval_act_fn(params, timestep, key, actor_state):
        hidden_state = actor_state["hidden_state"]
        term_or_trunc = timestep.last()
        net_input = (timestep.observation, term_or_trunc[..., jnp.newaxis])
        net_input = jax.tree.map(lambda x: x[jnp.newaxis], net_input)
        next_hidden_state, eps_greedy_dist = q_net.apply(
            params, hidden_state, net_input, 0.0
        )
        action = eps_greedy_dist.sample(seed=key).squeeze(0)
        return action, {"hidden_state": next_hidden_state}

    # Eval rides a 1-D data mesh over ALL devices (params replicated); the 2-D
    # seed mesh is a training-placement concern only — the eval cfg carries the
    # eval mesh's full device count (see make_eval_setup).
    eval_mesh, eval_cfg = make_eval_setup(cfg, mesh, seed_axis)
    evaluator = get_eval_fn(
        eval_env, eval_act_fn, eval_cfg, eval_mesh, absolute_metric=False
    )
    eval_batch_size = get_num_eval_envs(eval_cfg, absolute_metric=False)

    seed_returns = jnp.zeros(num_seeds)
    per_seed = [0.0] * num_seeds  # read after the loop; the loop can be empty
    for eval_idx, t in enumerate(
        range(steps_per_rollout, int(cfg.system.total_timesteps + 1), steps_per_rollout)
    ):
        start_time = time.time()
        learner_state, (metrics, losses) = update(learner_state)
        jax.block_until_ready(learner_state)

        elapsed = time.time() - start_time
        final_metrics, ep_completed = get_final_step_metrics(metrics)
        final_metrics["steps_per_second"] = num_seeds * steps_per_rollout / elapsed
        if ep_completed:
            logger.log(final_metrics, t, eval_idx, LogEvent.ACT)
        logger.log(losses, t, eval_idx, LogEvent.TRAIN)

        per_seed = []
        for s in range(num_seeds):
            key, eval_key = jax.random.split(key)
            params_s = jax.tree.map(lambda x: x[s], learner_state.params.online)
            eval_hs = ScannedRNN.initialize_carry(
                (eval_batch_size, cfg.system.num_agents),
                cfg.network.hidden_state_dim,
            )
            eval_metrics = evaluator(params_s, eval_key, {"hidden_state": eval_hs})
            per_seed.append(float(jnp.mean(eval_metrics["episode_return"])))
        seed_returns = jnp.array(per_seed)
        logger.log(
            {
                "episode_return": seed_returns,
                "seed_return_best": float(seed_returns.max()),
                "seed_return_worst": float(seed_returns.min()),
            },
            t,
            eval_idx,
            LogEvent.EVAL,
        )

    if sweep_lrs is not None:
        print(
            "vmap-sweep final eval returns per lr: "
            + ", ".join(f"lr={lr:g}: {r:.2f}" for lr, r in zip(sweep_lrs, per_seed))
        )
    else:
        print(
            "vmap-seeds final eval returns per seed: "
            + ", ".join(f"{r:.2f}" for r in per_seed)
        )
    logger.stop()
    return float(seed_returns.mean())


def main() -> float:
    import sys

    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_iql", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IQL vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
