"""Feedforward Independent PPO (ff-IPPO).

Capability parity with reference `mava/systems/ppo/ff_ippo.py` — jitted rollout scan ->
GAE -> minibatched clipped-PPO epochs, fused into one compiled megastep — rebuilt on the
mesh runtime:

  * the learner is written for ONE shard of environments and `shard_map`ped over the
    `data` mesh axis (`mava_jax/parallel/mesh.py`); gradients and loss metrics sync
    with a single `lax.pmean('data')` (the reference needed two pmeans,
    `ff_ippo.py:239-253`, because of its extra vmap-DP "update_batch_size" axis — that
    axis does not exist here, per-chip batching is real batching);
  * params/optimizer state are replicated, env state / rollout data sharded on envs;
  * the N-chip program is identical to the 1-chip program.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.evaluator import get_eval_fn, make_ff_eval_act_fn
from mava_jax.networks import FeedForwardActor as Actor
from mava_jax.networks import FeedForwardValueNet as Critic
from mava_jax.networks.factory import (
    make_action_head,
    make_log_prob_from_params,
    make_rollout_noise_fn,
    make_torso,
)
from mava_jax.ops import calculate_gae, clipped_ppo_policy_loss, clipped_value_loss
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
    make_mesh,
    num_learner_devices,
    put_replicated,
    put_sharded_rows,
    sharded_env_reset,
)
from mava_jax.utils.profiling import PhaseTimer, maybe_trace
from mava_jax.systems.ppo.types import LearnerState, OptStates, Params, PPOTransition
from mava_jax.types import ExperimentOutput, LearnerFn, MarlEnv
from mava_jax.utils.checkpointing import Checkpointer, multihost_safe_state
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.jax_utils import merge_leading_dims, pack_pytree_rows
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.timestep_checker import check_total_timesteps
from mava_jax.utils.training import (
    entropy_coefficient,
    make_learning_rate,
    make_optimizer,
)
from mava_jax.envs.stagger import derive_stagger_key, stagger_env_states
from mava_jax.envs.wrappers import get_final_step_metrics


def get_learner_fn(
    env: MarlEnv,
    apply_fns: Tuple[Callable, Callable],
    update_fns: Tuple[Callable, Callable],
    config: Config,
    return_trajectories: bool = False,
) -> LearnerFn[LearnerState]:
    """Build the per-shard learner function (one device's slice of envs).

    `return_trajectories` additionally returns the raw PPOTransition batch from each
    update (the experience-recording variant, reference
    `mava/advanced_usage/ff_ippo_store_experience.py:308-341`).
    """
    actor_apply_fn, critic_apply_fn = apply_fns
    actor_update_fn, critic_update_fn = update_fns
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)

    def _update_step(learner_state: LearnerState, _: Any) -> Tuple[LearnerState, Tuple]:
        def _env_step(
            learner_state: LearnerState, sample_noise: jnp.ndarray
        ) -> Tuple[LearnerState, Tuple]:
            params, opt_states, key, env_state, last_timestep = learner_state

            actor_policy = actor_apply_fn(params.actor_params, last_timestep.observation)
            action = actor_policy.sample_from_noise(sample_noise)
            # Store the (already computed) distribution params; log_prob runs once,
            # batched, after the scan.
            log_prob_payload = actor_policy.raw_params()

            env_state, timestep = jax.vmap(env.step)(env_state, action)

            done = jnp.repeat(
                timestep.last()[:, None], config.system.num_agents, axis=1
            ).astype(jnp.float32)
            info = timestep.extras["episode_metrics"]

            partial = (
                done, action, timestep.reward, log_prob_payload,
                last_timestep.observation, info,
            )
            learner_state = LearnerState(params, opt_states, key, env_state, timestep)
            return learner_state, partial

        # The rollout scan runs ONLY what steering the envs needs: the actor forward
        # (sample + log_prob come from the same logits). The critic depends only on
        # params that are CONSTANT during the rollout, so values are computed
        # afterwards in one batched pass over the stored (T, E)
        # observations instead of T tiny dispatch-bound in-scan calls — numerically
        # identical. All rollout RNG is likewise hoisted: one batched noise draw
        # (Gumbel for discrete, Normal for continuous heads) feeds the in-scan
        # sampling (identical in distribution).
        key, sample_key = jax.random.split(learner_state.key)
        learner_state = learner_state._replace(key=key)
        sample_noise = noise_fn(
            sample_key,
            (
                config.system.rollout_length,
                config.arch.num_envs,
                config.system.num_agents,
                env.action_dim,
            ),
        )
        learner_state, (dones, actions, rewards, log_probs, obs_seq, infos) = (
            jax.lax.scan(
                _env_step,
                learner_state,
                sample_noise,
                config.system.rollout_length,
                # Light unroll amortises scan-loop overhead on the serial
                # rollout chain (math-identical; tests/test_ff_ippo.py).
                unroll=int(config.system.get("rollout_unroll", 1)),
            )
        )
        log_probs = log_prob_from_params(log_probs, actions)

        params = learner_state.params
        values = critic_apply_fn(params.critic_params, obs_seq)
        last_val = critic_apply_fn(
            params.critic_params, learner_state.timestep.observation
        )

        traj_batch = PPOTransition(
            dones, actions, values, rewards, log_probs, obs_seq, infos
        )

        params, opt_states, key, env_state, last_timestep = learner_state
        advantages, targets = calculate_gae(
            traj_batch.reward,
            traj_batch.value,
            traj_batch.done,
            last_val,
            config.system.gamma,
            config.system.gae_lambda,
            # 'assoc' (parallel-prefix, default) or 'sequential' (the
            # reference's reverse scan), ops/gae.py.
            impl=config.system.get("gae_impl", "assoc"),
        )

        # Pack the whole shuffle payload ONCE into a single wide int32 matrix
        # (bit-exact): the per-epoch shuffle then is ONE contiguous-row gather
        # instead of a dozen skinny per-leaf gathers (utils/jax_utils.py).
        # The losses never read `info` — drop the metrics dict from the payload.
        batch_size = config.system.rollout_length * config.arch.num_envs
        flat_batch = jax.tree.map(
            lambda x: merge_leading_dims(x, 2),
            (traj_batch._replace(info={}), advantages, targets),
        )
        packed_batch, unpack_rows = pack_pytree_rows(flat_batch, batch_size)

        def _update_epoch(update_state: Tuple, permutation: jnp.ndarray) -> Tuple:
            def _update_minibatch(train_state: Tuple, minibatch_rows) -> Tuple:
                params, opt_states, key = train_state
                traj_batch, advantages, targets = unpack_rows(minibatch_rows)
                ent_coef = entropy_coefficient(config, opt_states.actor_opt_state)

                def _actor_loss_fn(actor_params, traj_batch, gae, entropy_key):
                    actor_policy = actor_apply_fn(actor_params, traj_batch.obs)
                    log_prob = actor_policy.log_prob(traj_batch.action)
                    loss_actor = clipped_ppo_policy_loss(
                        log_prob, traj_batch.log_prob, gae, config.system.clip_eps
                    )
                    entropy = actor_policy.entropy(seed=entropy_key).mean()
                    total = loss_actor - ent_coef * entropy
                    return total, (loss_actor, entropy)

                def _critic_loss_fn(critic_params, traj_batch, targets):
                    value = critic_apply_fn(critic_params, traj_batch.obs)
                    value_loss = clipped_value_loss(
                        value, traj_batch.value, targets, config.system.clip_eps
                    )
                    return config.system.vf_coef * value_loss, value_loss

                key, entropy_key = jax.random.split(key)
                actor_grad_fn = jax.value_and_grad(_actor_loss_fn, has_aux=True)
                actor_loss_info, actor_grads = actor_grad_fn(
                    params.actor_params, traj_batch, advantages, entropy_key
                )
                critic_grad_fn = jax.value_and_grad(_critic_loss_fn, has_aux=True)
                critic_loss_info, critic_grads = critic_grad_fn(
                    params.critic_params, traj_batch, targets
                )

                # One all-reduce over the mesh; per-device batch is already real.
                (actor_grads, actor_loss_info, critic_grads, critic_loss_info) = (
                    jax.lax.pmean(
                        (actor_grads, actor_loss_info, critic_grads, critic_loss_info),
                        axis_name=DATA_AXIS,
                    )
                )

                actor_updates, actor_new_opt_state = actor_update_fn(
                    actor_grads, opt_states.actor_opt_state
                )
                actor_new_params = optax.apply_updates(
                    params.actor_params, actor_updates
                )
                critic_updates, critic_new_opt_state = critic_update_fn(
                    critic_grads, opt_states.critic_opt_state
                )
                critic_new_params = optax.apply_updates(
                    params.critic_params, critic_updates
                )

                new_params = Params(actor_new_params, critic_new_params)
                new_opt_state = OptStates(actor_new_opt_state, critic_new_opt_state)
                loss_info = {
                    "total_loss": actor_loss_info[0] + critic_loss_info[0],
                    "value_loss": critic_loss_info[1],
                    "actor_loss": actor_loss_info[1][0],
                    "entropy": actor_loss_info[1][1],
                    # Global norm of the mesh-averaged gradients, before clipping.
                    "grad_norm": optax.tree.norm((actor_grads, critic_grads)),
                }
                return (new_params, new_opt_state, key), loss_info

            params, opt_states, key = update_state

            # Shuffle (T*E) rows of the packed payload and split into minibatches.
            shuffled = jnp.take(packed_batch, permutation, axis=0)
            minibatches = jnp.reshape(
                shuffled, (config.system.num_minibatches, -1, shuffled.shape[1])
            )

            (params, opt_states, key), loss_info = jax.lax.scan(
                _update_minibatch, (params, opt_states, key), minibatches
            )
            return (params, opt_states, key), loss_info

        # All epoch shuffles generated up front as ONE batched (ppo_epochs, N)
        # argsort instead of a vmapped `random.permutation`.
        # Sort raw uint32 bits, not float32 uniforms: floats only span 2^24 distinct
        # values, so at N~65k stable-argsort tie-breaking slightly biases the
        # permutation toward original order (ADVICE r1); uint32 makes ties ~2^-32.
        key, shuffle_key = jax.random.split(key)
        permutations = jnp.argsort(
            jax.random.bits(
                shuffle_key,
                (config.system.ppo_epochs, batch_size),
                dtype=jnp.uint32,
            ),
            axis=1,
        )

        update_state = (params, opt_states, key)
        update_state, loss_info = jax.lax.scan(
            _update_epoch, update_state, permutations
        )

        params, opt_states, key = update_state
        learner_state = LearnerState(params, opt_states, key, env_state, last_timestep)
        if return_trajectories:
            return learner_state, ((traj_batch.info, loss_info), traj_batch)
        return learner_state, (traj_batch.info, loss_info)

    def learner_fn(learner_state: LearnerState):
        # Per-shard entry: key arrives as the (1, 2) slice of the (D, 2) key array.
        params, opt_states, key, env_state, timestep = learner_state
        state = LearnerState(params, opt_states, key[0], env_state, timestep)

        state, outputs = jax.lax.scan(
            _update_step, state, None, config.system.num_updates_per_eval
        )
        state = LearnerState(
            state.params, state.opt_states, state.key[None], state.env_state,
            state.timestep,
        )
        if return_trajectories:
            (episode_info, loss_info), trajectories = outputs
            return (
                ExperimentOutput(
                    learner_state=state,
                    episode_metrics=episode_info,
                    train_metrics=loss_info,
                ),
                trajectories,
            )
        episode_info, loss_info = outputs
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=episode_info,
            train_metrics=loss_info,
        )

    return learner_fn


def learner_setup(
    env: MarlEnv, keys: Tuple, config: Config, mesh, centralised_critic: bool = False
) -> Tuple[Callable, Any, LearnerState]:
    n_devices = num_learner_devices(mesh)
    config.system.num_agents = env.num_agents

    key, actor_net_key, critic_net_key = keys

    actor_torso = make_torso(config.network.actor_network.pre_torso)
    action_head = make_action_head(config.network.action_head, env.action_dim)
    critic_torso = make_torso(config.network.critic_network.pre_torso)
    actor_network = Actor(torso=actor_torso, action_head=action_head)
    critic_network = Critic(torso=critic_torso, centralised_critic=centralised_critic)

    actor_lr = make_learning_rate(config.system.actor_lr, config)
    critic_lr = make_learning_rate(config.system.critic_lr, config)
    actor_optim = make_optimizer(actor_lr, config.system.max_grad_norm)
    critic_optim = make_optimizer(critic_lr, config.system.max_grad_norm)

    obs = env.observation_spec().generate_value()
    init_x = jax.tree.map(lambda x: x[jnp.newaxis, ...], obs)

    actor_params = actor_network.init(actor_net_key, init_x)
    actor_opt_state = actor_optim.init(actor_params)
    critic_params = critic_network.init(critic_net_key, init_x)
    critic_opt_state = critic_optim.init(critic_params)
    params = Params(actor_params, critic_params)

    apply_fns = (actor_network.apply, critic_network.apply)
    update_fns = (actor_optim.update, critic_optim.update)

    # Per-shard learner, mapped over the data mesh.
    learner = get_learner_fn(env, apply_fns, update_fns, config)
    state_specs = LearnerState(
        params=P(),
        opt_states=P(),
        key=P(DATA_AXIS),
        env_state=P(DATA_AXIS),
        timestep=P(DATA_AXIS),
    )
    out_specs = ExperimentOutput(
        learner_state=state_specs,
        episode_metrics=P(None, None, DATA_AXIS),
        train_metrics=P(),
    )
    learn = build_learner(
        learner,
        mesh,
        in_specs=(state_specs,),
        out_specs=out_specs,
        donate=config.arch.get("donate_buffers", False),
    )

    # Initialise env states sharded over the env axis (per-host local resets on a
    # pod slice — see parallel/distributed.py).
    key, env_key = jax.random.split(key)
    env_states, timesteps = sharded_env_reset(
        env, env_key, n_devices * config.arch.num_envs, mesh
    )
    if config.arch.get("stagger_resets", False):
        # Desynchronise episode boundaries across the env batch (see
        # envs/stagger.py) — opt-in, feedforward operating points.
        env_states, timesteps = stagger_env_states(
            env, env_states, timesteps, derive_stagger_key(key)
        )

    if config.logger.checkpointing.load_model:
        loaded_checkpoint = Checkpointer(
            model_name=config.logger.system_name,
            **config.logger.checkpointing.load_args,
        )
        restored_params, _ = loaded_checkpoint.restore_params(input_params=params)
        params = restored_params

    key, step_key = jax.random.split(key)
    step_keys = jax.random.split(step_key, n_devices)

    params = put_replicated(params, mesh)
    opt_states = put_replicated(OptStates(actor_opt_state, critic_opt_state), mesh)
    step_keys = put_sharded_rows(step_keys, mesh)

    init_learner_state = LearnerState(
        params, opt_states, step_keys, env_states, timesteps
    )
    return learn, actor_network, init_learner_state


def run_experiment(_config: Config, centralised_critic: bool = False) -> float:
    """Train ff-IPPO (or ff-MAPPO when `centralised_critic`: the only deltas are the
    critic consuming `global_state` and the env emitting it — the same two-line diff
    as the reference's `ff_mappo.py:354,442`)."""
    config = copy.deepcopy(_config)

    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    config.arch.n_devices = n_devices

    env, eval_env = environments.make(config, add_global_state=centralised_critic)

    key, key_e, actor_net_key, critic_net_key = jax.random.split(
        jax.random.PRNGKey(config.system.seed), num=4
    )

    # Derive num_updates from total_timesteps BEFORE building the learner:
    # the lr-decay horizon is baked into the optimizer at setup time.
    config = check_total_timesteps(config)
    assert config.system.num_updates >= config.arch.num_evaluation, (
        "Number of updates per evaluation must be less than total number of updates."
    )

    learn, actor_network, learner_state = learner_setup(
        env, (key, actor_net_key, critic_net_key), config, mesh, centralised_critic
    )

    # Exact-state resume (beyond the reference's params-level resume): restore
    # the whole learner state — optimizer/rng/env state included — from a
    # checkpoint written with `save_full_state=True`, and continue bit-exactly.
    start_t = 0
    if config.logger.checkpointing.get("load_full_state", False):
        loader = Checkpointer(
            model_name=config.logger.system_name,
            **config.logger.checkpointing.load_args,
        )
        template = multihost_safe_state(learner_state)
        restored = loader.restore_full_state(template)
        start_t = int(loader._manager.latest_step())
        learner_state = jax.tree.map(
            lambda t, x: jax.device_put(x, t.sharding), learner_state, restored
        )
        loader.close()

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

    save_checkpoint = config.logger.checkpointing.save_model
    if save_checkpoint:
        checkpointer = Checkpointer(
            metadata=config.to_dict(),
            model_name=config.logger.system_name,
            **config.logger.checkpointing.save_args,
        )

    max_episode_return = -jnp.inf
    best_params = None
    for eval_step in range(config.arch.num_evaluation):
        timer = PhaseTimer()
        start_time = time.time()
        with maybe_trace(config, eval_step), timer.phase("learn"):
            learner_output = learn(learner_state)
            jax.block_until_ready(learner_output)

        elapsed_time = time.time() - start_time
        t = start_t + int(steps_per_rollout * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(
            learner_output.episode_metrics
        )
        episode_metrics["steps_per_second"] = steps_per_rollout / elapsed_time

        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(learner_output.train_metrics, t, eval_step, LogEvent.TRAIN)

        trained_params = learner_output.learner_state.params.actor_params
        key_e, eval_key = jax.random.split(key_e)
        with timer.phase("eval"):
            eval_metrics = evaluator(trained_params, eval_key, {})
        logger.log(eval_metrics, t, eval_step, LogEvent.EVAL)
        logger.log({"timestep": t, **timer.metrics()}, t, eval_step, LogEvent.MISC)
        episode_return = jnp.mean(eval_metrics["episode_return"])

        if save_checkpoint:
            checkpointer.save(
                timestep=t,
                unreplicated_learner_state=multihost_safe_state(
                    learner_output.learner_state
                ),
                episode_return=episode_return,
                full_state=config.logger.checkpointing.get("save_full_state", False),
            )

        if config.arch.absolute_metric and max_episode_return <= episode_return:
            best_params = jax.tree.map(lambda x: x.copy(), trained_params)
            max_episode_return = episode_return

        learner_state = learner_output.learner_state

    eval_performance = float(jnp.mean(eval_metrics[config.env.eval_metric]))

    if config.arch.absolute_metric:
        abs_metric_evaluator = get_eval_fn(
            eval_env, eval_act_fn, config, mesh, absolute_metric=True
        )
        key_e, eval_key = jax.random.split(key_e)
        eval_metrics = abs_metric_evaluator(best_params, eval_key, {})
        t = start_t + int(steps_per_rollout * (eval_step + 1))
        logger.log(eval_metrics, t, eval_step, LogEvent.ABSOLUTE)

    logger.stop()
    return eval_performance


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    overrides = sys.argv[1:]
    cfg = load_config("default_ff_ippo", overrides)
    performance = run_experiment(cfg)
    print("ff-IPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
