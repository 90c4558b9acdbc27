"""ff-IPPO with VMAPPED SEEDS: train N independent seeds in ONE compiled program.

The fused MARL step is a long serial chain (the rollout scan) over small batch
dimensions. Hypothesis to A/B on the GPU (ROADMAP S5): that leaves the device's
batch dimensions mostly idle, so independent-seed replication is nearly free —
`vmap` the per-shard learner over a leading seed axis and the seeds ride the same
serial chain, instead of N sequential runs.

This is a capability the reference does not have (its closest pattern is
the `update_batch_size` vmap-DP axis, `mava/systems/ppo/ff_ippo.py:239-253`, which
replicates ONE seed for devices — here we batch DIFFERENT seeds for science).
Everything reuses the stock ff-IPPO learner (`get_learner_fn`) — the only changes
are a leading seed axis on the learner state and `jax.vmap` inside `shard_map`
(collectives over the mesh axis are per-seed automatically under vmap).

Usage:
    python -m mava_jax.advanced_usage.ff_ippo_vmap_seeds \
        env=rware env/scenario=tiny-2ag arch.num_envs=128 +system.num_seeds=4
    # Shard the seed axis over a 2-D (seed, data) mesh on a multi-chip slice
    # (API-uniform with the replay families; see make_seed_sharded_mesh):
    python -m mava_jax.advanced_usage.ff_ippo_vmap_seeds \
        env=rware env/scenario=tiny-2ag +system.num_seeds=8 +system.seed_shards=8

Per-seed env batches are real: `arch.num_envs` envs per seed per device. The
evaluator runs per seed (cheap, outside the hot loop); final output prints a
per-seed table and returns the mean eval performance across seeds.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.envs.stagger import derive_stagger_key, stagger_env_states
from mava_jax.envs.wrappers import get_final_step_metrics
from mava_jax.evaluator import get_eval_fn, make_ff_eval_act_fn
from mava_jax.networks import FeedForwardActor as Actor
from mava_jax.networks import FeedForwardValueNet as Critic
from mava_jax.networks.factory import make_action_head, make_torso
from mava_jax.advanced_usage.ff_isac_vmap_seeds import (
    lift_specs,
    make_eval_setup,
    make_seed_mesh,
)
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
)
from mava_jax.systems.ppo.ff_ippo import get_learner_fn
from mava_jax.systems.ppo.types import LearnerState, OptStates, Params
from mava_jax.types import ExperimentOutput, MarlEnv
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.timestep_checker import check_total_timesteps
from mava_jax.utils.training import (
    make_learning_rate,
    make_optimizer,
    make_swept_optimizer,
    set_peak_lr,
)


def _put(tree: Any, mesh, spec: P) -> Any:
    sharding = NamedSharding(mesh, spec)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def learner_setup(
    env: MarlEnv,
    key,
    config: Config,
    mesh,
    num_seeds: int,
    centralised_critic: bool = False,
    sweep_lrs=None,
    seed_axis=None,
) -> Tuple[Any, Any, LearnerState]:
    """Stock ff-IPPO learner with a leading seed axis on the whole learner state.

    With `sweep_lrs` (array of `num_seeds` learning rates), the batch axis sweeps
    HYPERPARAMETERS instead of just rng: the optimizer becomes
    `make_swept_optimizer` (lr read from optimizer state, identical Adam math)
    and entry i trains at `sweep_lrs[i]` for both actor and critic — N learning
    rates in one compiled program (see ff_ippo_vmap_sweep.py).

    With `seed_axis=SEED_AXIS`, `mesh` is a 2-D `(seed, data)` mesh
    (`make_seed_sharded_mesh`) and the seed axis is SHARDED over it: each
    device group holds only `num_seeds / seed_shards` seeds' params/envs. The
    on-policy family has no replay buffer, so this is an API-uniformity +
    params/env-memory lever rather than the replay-memory fix;
    the vmapped learner's `pmean(DATA_AXIS)` reduces within one seed group by
    mesh construction either way.
    """
    # Per-seed data-shard count (the whole mesh unless the seed axis is sharded).
    n_devices = mesh.shape[DATA_AXIS]
    config.system.num_agents = env.num_agents

    actor_torso = make_torso(config.network.actor_network.pre_torso)
    action_head = make_action_head(config.network.action_head, env.action_dim)
    critic_torso = make_torso(config.network.critic_network.pre_torso)
    actor_network = Actor(torso=actor_torso, action_head=action_head)
    critic_network = Critic(torso=critic_torso, centralised_critic=centralised_critic)

    if sweep_lrs is None:
        actor_optim = make_optimizer(
            make_learning_rate(config.system.actor_lr, config),
            config.system.max_grad_norm,
        )
        critic_optim = make_optimizer(
            make_learning_rate(config.system.critic_lr, config),
            config.system.max_grad_norm,
        )
    else:
        actor_optim = make_swept_optimizer(config, config.system.max_grad_norm)
        critic_optim = make_swept_optimizer(config, config.system.max_grad_norm)

    obs = env.observation_spec().generate_value()
    init_x = jax.tree.map(lambda x: x[jnp.newaxis, ...], obs)

    # Per-entry keys: independent for seed batching; IDENTICAL for an lr sweep
    # (so entry-to-entry differences are attributable to the lr alone).
    def entry_keys(k):
        if sweep_lrs is None:
            return jax.random.split(k, num_seeds)
        return jnp.tile(k[None], (num_seeds, 1))

    key, actor_key, critic_key = jax.random.split(key, 3)
    actor_params = jax.vmap(actor_network.init, in_axes=(0, None))(
        entry_keys(actor_key), init_x
    )
    critic_params = jax.vmap(critic_network.init, in_axes=(0, None))(
        entry_keys(critic_key), init_x
    )
    params = Params(actor_params, critic_params)
    opt_states = OptStates(
        jax.vmap(actor_optim.init)(actor_params),
        jax.vmap(critic_optim.init)(critic_params),
    )
    if sweep_lrs is not None:
        lrs = jnp.asarray(sweep_lrs, jnp.float32)
        assert lrs.shape == (num_seeds,), "one lr per sweep entry"
        opt_states = OptStates(
            set_peak_lr(opt_states.actor_opt_state, lrs),
            set_peak_lr(opt_states.critic_opt_state, lrs),
        )

    apply_fns = (actor_network.apply, critic_network.apply)
    update_fns = (actor_optim.update, critic_optim.update)

    # vmap INSIDE shard_map: each shard runs its LOCAL seeds over its env
    # slice; the gradient pmean over the mesh axis applies per seed under the
    # vmap. The specs are the stock per-seed layout lifted by one seed axis
    # (unsharded by default; sharded over a 2-D seed mesh with seed_axis).
    learner = jax.vmap(get_learner_fn(env, apply_fns, update_fns, config))

    state_specs = lift_specs(
        LearnerState(
            params=P(),  # (S, ...) replicated across the data axis
            opt_states=P(),
            key=P(DATA_AXIS),  # (S, n_devices, 2)
            env_state=P(DATA_AXIS),  # (S, n_devices*num_envs, ...)
            timestep=P(DATA_AXIS),
        ),
        seed_axis,
    )
    out_specs = ExperimentOutput(
        learner_state=state_specs,
        episode_metrics=lift_specs(P(None, None, DATA_AXIS), seed_axis),  # (S,U,T,E)
        train_metrics=lift_specs(P(), seed_axis),
    )
    learn = build_learner(
        learner,
        mesh,
        in_specs=(state_specs,),
        out_specs=out_specs,
        donate=config.arch.get("donate_buffers", False),
    )

    # (S, total_envs) env instances, sharded on the env axis — independent draws
    # per seed entry, or the same total_envs instances tiled for an lr sweep.
    key, env_key = jax.random.split(key)
    total_envs = n_devices * config.arch.num_envs
    if sweep_lrs is None:
        reset_keys = jax.random.split(env_key, num_seeds * total_envs)
    else:
        reset_keys = jnp.tile(
            jax.random.split(env_key, total_envs), (num_seeds, 1)
        )
    env_states, timesteps = jax.vmap(env.reset)(reset_keys)
    if config.arch.get("stagger_resets", False):
        stagger_key = derive_stagger_key(key)
        if sweep_lrs is None:
            # Seed batching: independent offsets per seed entry (flat S*E).
            env_states, timesteps = stagger_env_states(
                env, env_states, timesteps, stagger_key
            )
        else:
            # lr sweep: IDENTICAL offsets per entry (same invariant as the
            # tiled reset keys above — entry differences attributable to lr
            # alone). Stagger one env copy, tile across entries.
            one = jax.tree.map(lambda x: x[:total_envs], (env_states, timesteps))
            one_states, one_ts = stagger_env_states(env, *one, stagger_key)
            env_states, timesteps = jax.tree.map(
                lambda x: jnp.tile(x, (num_seeds,) + (1,) * (x.ndim - 1)),
                (one_states, one_ts),
            )
    env_states, timesteps = jax.tree.map(
        lambda x: x.reshape((num_seeds, total_envs) + x.shape[1:]),
        (env_states, timesteps),
    )
    env_seed_spec = lift_specs(P(DATA_AXIS), seed_axis)
    env_states = _put(env_states, mesh, env_seed_spec)
    timesteps = _put(timesteps, mesh, env_seed_spec)

    key, step_key = jax.random.split(key)
    if sweep_lrs is None:
        step_keys = jax.random.split(step_key, num_seeds * n_devices).reshape(
            num_seeds, n_devices, -1
        )
    else:
        step_keys = jnp.tile(
            jax.random.split(step_key, n_devices)[None], (num_seeds, 1, 1)
        )

    params = _put(params, mesh, lift_specs(P(), seed_axis))
    opt_states = _put(opt_states, mesh, lift_specs(P(), seed_axis))
    step_keys = _put(step_keys, mesh, env_seed_spec)

    init_state = LearnerState(params, opt_states, step_keys, env_states, timesteps)
    return learn, actor_network, init_state


def run_experiment(
    _config: Config, centralised_critic: bool = False, sweep_lrs=None
) -> float:
    config = copy.deepcopy(_config)

    if sweep_lrs is not None:
        num_seeds = len(sweep_lrs)
    else:
        num_seeds = int(config.system.get("num_seeds", 4))
    mesh, seed_axis = make_seed_mesh(config, num_seeds)
    # Per-seed data-shard count (whole mesh unless the seed axis is sharded).
    n_devices = mesh.shape[DATA_AXIS]
    config.arch.n_devices = n_devices

    env, eval_env = environments.make(config, add_global_state=centralised_critic)
    key, key_e = jax.random.split(jax.random.PRNGKey(config.system.seed))

    # num_updates must be derived from total_timesteps BEFORE the optimizers
    # (and their decay horizons) are built.
    config = check_total_timesteps(config)

    learn, actor_network, learner_state = learner_setup(
        env, key, config, mesh, num_seeds, centralised_critic,
        sweep_lrs=sweep_lrs, seed_axis=seed_axis,
    )

    eval_act_fn = make_ff_eval_act_fn(actor_network.apply, config)
    eval_mesh, eval_cfg = make_eval_setup(config, mesh, seed_axis)
    evaluator = get_eval_fn(
        eval_env, eval_act_fn, eval_cfg, eval_mesh, absolute_metric=False
    )

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
    seed_returns = jnp.zeros(num_seeds)
    per_seed = [0.0] * num_seeds  # read after the loop; num_evaluation can be 0

    for eval_step in range(config.arch.num_evaluation):
        start_time = time.time()
        learner_output = learn(learner_state)
        jax.block_until_ready(learner_output)
        elapsed = time.time() - start_time

        # Per-seed env steps all count: S seeds x steps_per_rollout each.
        t = int(steps_per_rollout * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(
            learner_output.episode_metrics
        )
        episode_metrics["steps_per_second"] = (
            num_seeds * steps_per_rollout / elapsed
        )
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(learner_output.train_metrics, t, eval_step, LogEvent.TRAIN)

        # Evaluate each seed with the stock evaluator (params are tiny; the
        # per-seed indexing is a host-side gather outside the hot loop).
        per_seed = []
        for s in range(num_seeds):
            key_e, eval_key = jax.random.split(key_e)
            params_s = jax.tree.map(
                lambda x: x[s], learner_output.learner_state.params.actor_params
            )
            eval_metrics = evaluator(params_s, eval_key, {})
            per_seed.append(float(jnp.mean(eval_metrics["episode_return"])))
        seed_returns = jnp.array(per_seed)
        logger.log(
            {
                "episode_return": seed_returns,
                "seed_return_best": float(seed_returns.max()),
                "seed_return_worst": float(seed_returns.min()),
            },
            t,
            eval_step,
            LogEvent.EVAL,
        )
        learner_state = learner_output.learner_state

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
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-IPPO vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
