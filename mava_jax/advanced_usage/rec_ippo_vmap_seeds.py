"""rec-IPPO with VMAPPED SEEDS — the SMAX seed-sweep case.

Same construction as `ff_ippo_vmap_seeds.py` (see its module docstring for the
latency-bound rationale): `jax.vmap` the stock per-shard recurrent learner
(`rec_ippo.get_learner_fn`) over a leading seed axis inside `shard_map`; the seed
axis additionally rides the GRU hidden states and last-step dones. Win-rate
tables over N seeds (the JaxMARL/reference benchmark protocol) train in ONE
compiled program instead of N sequential runs.

Usage:
    python -m mava_jax.advanced_usage.rec_ippo_vmap_seeds \
        env=smax env/scenario=3s5z arch.num_envs=64 +system.num_seeds=3
    # Seed-sharded over a 2-D (seed, data) mesh on a multi-chip slice:
    python -m mava_jax.advanced_usage.rec_ippo_vmap_seeds \
        env=smax env/scenario=3s5z +system.num_seeds=8 +system.seed_shards=8
"""

from __future__ import annotations

import copy
import time
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.advanced_usage.ff_isac_vmap_seeds import (
    lift_specs,
    make_eval_setup,
    make_seed_mesh,
)
from mava_jax.envs.wrappers import get_final_step_metrics
from mava_jax.evaluator import get_eval_fn, get_num_eval_envs, make_rec_eval_act_fn
from mava_jax.networks import RecurrentActor as Actor
from mava_jax.networks import RecurrentValueNet as Critic
from mava_jax.networks import ScannedRNN
from mava_jax.networks.factory import make_action_head, make_torso
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
)
from mava_jax.envs.stagger import reject_stagger
from mava_jax.systems.ppo.rec_ippo import get_learner_fn
from mava_jax.systems.ppo.types import (
    HiddenStates,
    OptStates,
    Params,
    RNNLearnerState,
)
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
) -> Tuple[Any, Any, RNNLearnerState]:
    """Stock rec-IPPO learner with a leading batch axis over seeds — or, with
    `sweep_lrs`, over LEARNING RATES (shared init/env seeds, swept optimizer;
    see ff_ippo_vmap_seeds.learner_setup for the mechanism). With
    `seed_axis=SEED_AXIS`, `mesh` is a 2-D `(seed, data)` mesh and the seed
    axis is SHARDED over it (see ff_ippo_vmap_seeds.learner_setup)."""
    reject_stagger(config, "rec-IPPO vmap-seeds/sweep/PBT")
    # Honor network.gru_impl exactly like the stock recurrent setup does.
    gru_impl = config.network.get("gru_impl", None)

    # Per-seed data-shard count (whole mesh unless the seed axis is sharded).
    n_devices = mesh.shape[DATA_AXIS]
    num_agents = env.num_agents
    config.system.num_agents = num_agents

    actor_network = Actor(
        pre_torso=make_torso(config.network.actor_network.pre_torso),
        post_torso=make_torso(config.network.actor_network.post_torso),
        action_head=make_action_head(config.network.action_head, env.action_dim),
        hidden_state_dim=config.network.hidden_state_dim,
        gru_impl=gru_impl,
    )
    critic_kwargs = dict(
        pre_torso=make_torso(config.network.critic_network.pre_torso),
        post_torso=make_torso(config.network.critic_network.post_torso),
        hidden_state_dim=config.network.hidden_state_dim,
        centralised_critic=centralised_critic,
        gru_impl=gru_impl,
    )
    critic_network = Critic(**critic_kwargs)
    critic_carry_network = Critic(**critic_kwargs, collect_carries=True)

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

    def entry_keys(k):
        # Independent per-seed keys; IDENTICAL keys for an lr sweep (the lr is
        # the only thing that differs between entries).
        if sweep_lrs is None:
            return jax.random.split(k, num_seeds)
        return jnp.tile(k[None], (num_seeds, 1))

    init_obs = env.observation_spec().generate_value()
    init_obs = jax.tree.map(
        lambda x: jnp.repeat(x[jnp.newaxis, ...], config.arch.num_envs, axis=0),
        init_obs,
    )
    init_obs = jax.tree.map(lambda x: x[jnp.newaxis, ...], init_obs)
    init_done = jnp.zeros((1, config.arch.num_envs, num_agents), dtype=bool)
    init_x = (init_obs, init_done)
    init_hstate = ScannedRNN.initialize_carry(
        (config.arch.num_envs, num_agents), config.network.hidden_state_dim
    )

    key, actor_key, critic_key = jax.random.split(key, 3)
    actor_params = jax.vmap(actor_network.init, in_axes=(0, None, None))(
        entry_keys(actor_key), init_hstate, init_x
    )
    critic_params = jax.vmap(critic_network.init, in_axes=(0, None, None))(
        entry_keys(critic_key), init_hstate, init_x
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

    apply_fns = (
        actor_network.apply, critic_network.apply, critic_carry_network.apply
    )
    update_fns = (actor_optim.update, critic_optim.update)

    learner = jax.vmap(get_learner_fn(env, apply_fns, update_fns, config))

    state_specs = lift_specs(
        RNNLearnerState(
            params=P(),
            opt_states=P(),
            key=P(DATA_AXIS),
            env_state=P(DATA_AXIS),
            timestep=P(DATA_AXIS),
            dones=P(DATA_AXIS),
            hstates=P(DATA_AXIS),
        ),
        seed_axis,
    )
    out_specs = ExperimentOutput(
        learner_state=state_specs,
        episode_metrics=lift_specs(P(None, None, DATA_AXIS), seed_axis),
        train_metrics=lift_specs(P(), seed_axis),
    )
    learn = build_learner(
        learner,
        mesh,
        in_specs=(state_specs,),
        out_specs=out_specs,
        donate=config.arch.get("donate_buffers", False),
    )

    key, env_key = jax.random.split(key)
    total_envs = n_devices * config.arch.num_envs
    if sweep_lrs is None:
        reset_keys = jax.random.split(env_key, num_seeds * total_envs)
    else:
        reset_keys = jnp.tile(jax.random.split(env_key, total_envs), (num_seeds, 1))
    env_states, timesteps = jax.vmap(env.reset)(reset_keys)
    env_states, timesteps = jax.tree.map(
        lambda x: x.reshape((num_seeds, total_envs) + x.shape[1:]),
        (env_states, timesteps),
    )
    env_seed_spec = lift_specs(P(DATA_AXIS), seed_axis)
    env_states = _put(env_states, mesh, env_seed_spec)
    timesteps = _put(timesteps, mesh, env_seed_spec)

    dones = jnp.zeros((num_seeds, total_envs, num_agents), dtype=bool)
    hstates = HiddenStates(
        jnp.zeros(
            (num_seeds, total_envs, num_agents, config.network.hidden_state_dim)
        ),
        jnp.zeros(
            (num_seeds, total_envs, num_agents, config.network.hidden_state_dim)
        ),
    )

    key, step_key = jax.random.split(key)
    if sweep_lrs is None:
        step_keys = jax.random.split(step_key, num_seeds * n_devices).reshape(
            num_seeds, n_devices, -1
        )
    else:
        step_keys = jnp.tile(
            jax.random.split(step_key, n_devices)[None], (num_seeds, 1, 1)
        )

    init_state = RNNLearnerState(
        params=_put(params, mesh, lift_specs(P(), seed_axis)),
        opt_states=_put(opt_states, mesh, lift_specs(P(), seed_axis)),
        key=_put(step_keys, mesh, env_seed_spec),
        env_state=env_states,
        timestep=timesteps,
        dones=_put(dones, mesh, env_seed_spec),
        hstates=_put(hstates, mesh, env_seed_spec),
    )
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

    if config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length

    env, eval_env = environments.make(config, add_global_state=centralised_critic)
    key, key_e = jax.random.split(jax.random.PRNGKey(config.system.seed))

    # num_updates must be derived from total_timesteps BEFORE the optimizers
    # (and their decay horizons) are built.
    config = check_total_timesteps(config)

    learn, actor_network, learner_state = learner_setup(
        env, key, config, mesh, num_seeds, centralised_critic,
        sweep_lrs=sweep_lrs, seed_axis=seed_axis,
    )

    eval_act_fn = make_rec_eval_act_fn(actor_network.apply, config)
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

    eval_batch_size = get_num_eval_envs(eval_cfg, absolute_metric=False)
    eval_hs = ScannedRNN.initialize_carry(
        (eval_batch_size, config.system.num_agents),
        config.network.hidden_state_dim,
    )

    # Bound BEFORE the loop: both are read after it, and num_evaluation can
    # legitimately be 0 (ADVICE r4).
    per_seed = [0.0] * num_seeds
    per_seed_win = [None] * num_seeds
    seed_returns = jnp.zeros(num_seeds)
    for eval_step in range(config.arch.num_evaluation):
        start_time = time.time()
        learner_output = learn(learner_state)
        jax.block_until_ready(learner_output)
        elapsed = time.time() - start_time

        t = int(steps_per_rollout * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(
            learner_output.episode_metrics
        )
        episode_metrics["steps_per_second"] = num_seeds * steps_per_rollout / elapsed
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(learner_output.train_metrics, t, eval_step, LogEvent.TRAIN)

        per_seed_win = [None] * num_seeds
        for s in range(num_seeds):
            key_e, eval_key = jax.random.split(key_e)
            params_s = jax.tree.map(
                lambda x: x[s], learner_output.learner_state.params.actor_params
            )
            eval_metrics = evaluator(
                params_s, eval_key, {"hidden_state": eval_hs}
            )
            per_seed[s] = float(jnp.mean(eval_metrics["episode_return"]))
            if "won_episode" in eval_metrics:
                won = jnp.asarray(eval_metrics["won_episode"])
                per_seed_win[s] = float(100.0 * won.sum() / won.size)
        seed_returns = jnp.array(per_seed)
        eval_log = {
            "episode_return": seed_returns,
            "seed_return_best": float(seed_returns.max()),
            "seed_return_worst": float(seed_returns.min()),
        }
        if per_seed_win[0] is not None:
            # Mean win rate as the SCALAR the marl-eval JSON schema shares
            # with the stock systems (SMAX's headline comparison unit);
            # per-seed values go to stdout + the seed_win_* spread keys.
            eval_log["win_rate"] = float(np.mean(per_seed_win))
            eval_log["seed_win_best"] = float(np.max(per_seed_win))
            eval_log["seed_win_worst"] = float(np.min(per_seed_win))
        logger.log(eval_log, t, eval_step, LogEvent.EVAL)
        learner_state = learner_output.learner_state

    if sweep_lrs is not None:
        print(
            "rec vmap-sweep final eval returns per lr: "
            + ", ".join(f"lr={lr:g}: {r:.2f}" for lr, r in zip(sweep_lrs, per_seed))
        )
    else:
        print(
            "rec vmap-seeds final eval returns per seed: "
            + ", ".join(f"{r:.2f}" for r in per_seed)
        )
    if per_seed_win[0] is not None:
        print(
            "rec vmap-seeds final eval win rates per seed: "
            + ", ".join(f"{w:.1f}%" for w in per_seed_win)
        )
    logger.stop()
    return float(seed_returns.mean())


def main() -> float:
    import sys

    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IPPO vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
