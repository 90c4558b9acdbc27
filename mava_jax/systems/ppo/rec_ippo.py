"""Recurrent (GRU) Independent PPO — rec-IPPO (and rec-MAPPO via `centralised_critic`).

Capability parity with reference `mava/systems/ppo/rec_ippo.py` / `rec_mappo.py`:
rollout carries actor+critic hidden states with carry-reset on episode boundaries,
GAE carries `next_done`, the loss re-runs the RNN from each chunk's stored initial
hidden state, and minibatches shuffle whole env/chunk sequences (never time steps).

Rebuilt on the mesh runtime (see ff_ippo.py for the SPMD layout). One deliberate
deviation: chunked-BPTT minibatching defaults to time-CONTIGUOUS chunks
((T,E) -> (chunk, n_chunks*E) via an explicit chunk split + transpose), where the
reference's single reshape (`rec_ippo.py:348-356`) produces time-strided chunks.
Both are identical at the default `recurrent_chunk_size = rollout_length`; the
reference-exact layout ships behind `system.chunk_layout=strided` for airtight
non-default-chunk A/Bs.
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
from mava_jax.evaluator import get_eval_fn, get_num_eval_envs, make_rec_eval_act_fn
from mava_jax.networks import RecurrentActor as Actor
from mava_jax.networks import RecurrentValueNet as Critic
from mava_jax.networks import ScannedRNN
from mava_jax.networks.factory import (
    make_action_head,
    make_log_prob_from_params,
    make_rollout_noise_fn,
    make_torso,
)
from mava_jax.ops import clipped_ppo_policy_loss, clipped_value_loss
from mava_jax.ops.gae import calculate_gae_with_next_done
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
    make_mesh,
    num_learner_devices,
    put_replicated,
    put_sharded_rows,
    sharded_env_reset,
    tile_for_shards,
)
from mava_jax.systems.ppo.types import (
    HiddenStates,
    OptStates,
    Params,
    RNNLearnerState,
    RNNPPOTransition,
)
from mava_jax.types import ExperimentOutput, LearnerFn, MarlEnv
from mava_jax.utils.checkpointing import Checkpointer, multihost_safe_state
from mava_jax.utils.jax_utils import pack_pytree_rows
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.profiling import PhaseTimer, maybe_trace
from mava_jax.utils.timestep_checker import check_total_timesteps
from mava_jax.utils.training import (
    entropy_coefficient,
    make_learning_rate,
    make_optimizer,
)
from mava_jax.envs.stagger import reject_stagger
from mava_jax.envs.wrappers import get_final_step_metrics


def get_learner_fn(
    env: MarlEnv,
    apply_fns: Tuple[Callable, Callable],
    update_fns: Tuple[Callable, Callable],
    config: Config,
) -> LearnerFn[RNNLearnerState]:
    actor_apply_fn, critic_apply_fn, critic_carry_apply_fn = apply_fns
    actor_update_fn, critic_update_fn = update_fns
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)

    def _update_step(
        learner_state: RNNLearnerState, _: Any
    ) -> Tuple[RNNLearnerState, Tuple]:
        rollout_initial_critic_hstate = learner_state.hstates.critic_hidden_state

        def _env_step(
            learner_state: RNNLearnerState, sample_noise: jnp.ndarray
        ) -> Tuple[RNNLearnerState, Tuple]:
            (params, opt_states, key, env_state, last_timestep, last_done,
             last_hstates) = learner_state

            # Networks consume one time slice: add a leading time dim of 1.
            batched_observation = jax.tree.map(
                lambda x: x[jnp.newaxis, :], last_timestep.observation
            )
            ac_in = (batched_observation, last_done[jnp.newaxis, :])

            policy_hidden_state, actor_policy = actor_apply_fn(
                params.actor_params, last_hstates.policy_hidden_state, ac_in
            )

            action = actor_policy.sample_from_noise(sample_noise[jnp.newaxis])
            action = action.squeeze(0)
            # Store the (already computed) distribution params; log_prob runs once,
            # batched, after the scan (see ff_ippo).
            log_prob_payload = jax.tree.map(
                lambda p: p.squeeze(0), actor_policy.raw_params()
            )

            env_state, timestep = jax.vmap(env.step)(env_state, action)

            done = jnp.repeat(
                timestep.last()[:, None], config.system.num_agents, axis=1
            )
            info = timestep.extras["episode_metrics"]

            # The critic is NOT run in the rollout scan — its hidden state is
            # reconstructed afterwards in one batched pass (params are constant
            # during the rollout, so the result is identical). The carried critic
            # hstate stays at its rollout-initial value.
            hstates = HiddenStates(
                policy_hidden_state, last_hstates.critic_hidden_state
            )
            partial = (
                last_done, action, timestep.reward, log_prob_payload,
                last_timestep.observation, last_hstates.policy_hidden_state, info,
            )
            learner_state = RNNLearnerState(
                params, opt_states, key, env_state, timestep, done, hstates
            )
            return learner_state, partial

        # All rollout RNG hoisted into one batched noise draw (see ff_ippo).
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
        learner_state, scan_out = jax.lax.scan(
            _env_step,
            learner_state,
            sample_noise,
            config.system.rollout_length,
            # Light unroll amortises scan-loop overhead in the latency-bound rollout.
            unroll=2,
        )
        (dones, actions, rewards, log_probs, obs_seq, policy_hstates, infos) = scan_out
        log_probs = log_prob_from_params(log_probs, actions)

        (params, opt_states, key, env_state, last_timestep, last_done,
         hstates) = learner_state

        # Batched critic pass over the stored rollout observations: values for GAE,
        # per-step input hidden states for the chunked-BPTT loss, and the
        # post-rollout critic state for the next update — one batched pass
        # instead of T tiny in-scan calls (numerically identical). The bootstrap
        # value is one extra single-slice call from the final carry.
        critic_hstate_after, (critic_carries, values) = critic_carry_apply_fn(
            params.critic_params,
            rollout_initial_critic_hstate,
            (obs_seq, dones),
        )
        batched_last_observation = jax.tree.map(
            lambda x: x[jnp.newaxis], last_timestep.observation
        )
        _, last_val = critic_apply_fn(
            params.critic_params,
            critic_hstate_after,
            (batched_last_observation, last_done[jnp.newaxis]),
        )
        last_val = last_val.squeeze(0)
        hstates = HiddenStates(hstates.policy_hidden_state, critic_hstate_after)

        traj_batch = RNNPPOTransition(
            dones, actions, values, rewards, log_probs, obs_seq,
            HiddenStates(policy_hstates, critic_carries), infos,
        )

        advantages, targets = calculate_gae_with_next_done(
            traj_batch.reward,
            traj_batch.value,
            traj_batch.done.astype(jnp.float32),
            last_done.astype(jnp.float32),
            last_val,
            config.system.gamma,
            config.system.gae_lambda,
            # 'assoc' (default) or 'sequential' (the reference's scan), ops/gae.py.
            impl=config.system.get("gae_impl", "assoc"),
        )

        # Chunked BPTT: split the rollout into contiguous time chunks, fold the
        # chunk axis into the env/batch axis. The shuffle permutes whole SEQUENCES
        # (never time steps), so transpose once to sequence-major rows and pack the
        # payload bit-exactly into ONE wide int32 matrix — the per-epoch shuffle is
        # then a single contiguous-row gather instead of a dozen strided axis-1
        # gathers (same fix as ff_ippo, scripts/profile_bisect.py). The loss only
        # reads the chunk-INITIAL hidden states (it re-runs the RNN from there) and
        # never reads `info` — drop the full per-step hstates (the largest leaves)
        # and the metrics dict from the payload.
        chunk = config.system.recurrent_chunk_size
        num_chunks = config.system.rollout_length // chunk
        num_sequences = num_chunks * config.arch.num_envs
        batch = (traj_batch, advantages, targets)
        chunk_layout = config.system.get("chunk_layout", "contiguous")
        if chunk_layout == "contiguous":
            batch = jax.tree.map(
                lambda x: x.reshape(num_chunks, chunk, *x.shape[1:])
                .swapaxes(0, 1)
                .reshape(chunk, num_chunks * x.shape[1], *x.shape[2:]),
                batch,
            )
        elif chunk_layout == "strided":
            # Reference-exact layout (`mava/systems/ppo/rec_ippo.py:344-356`):
            # the bare (T, E) -> (chunk, num_chunks*E) reshape, whose chunk rows
            # stride through real time with step `num_chunks`. Identical to
            # contiguous at the default chunk = rollout_length; offered so
            # non-default-chunk curve A/Bs against reference runs are airtight
            # (VERDICT r4 next-7; tests/test_chunked_bptt.py).
            batch = jax.tree.map(
                lambda x: x.reshape(chunk, num_chunks * x.shape[1], *x.shape[2:]),
                batch,
            )
        else:
            raise ValueError(
                f"Unknown chunk_layout '{chunk_layout}' "
                "(expected 'contiguous' or 'strided')."
            )
        tb = batch[0]
        batch = (
            tb._replace(
                hstates=jax.tree.map(lambda h: h[0:1], tb.hstates), info={}
            ),
            batch[1],
            batch[2],
        )
        seq_major = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), batch)
        packed_batch, unpack_rows = pack_pytree_rows(seq_major, num_sequences)

        def _update_epoch(update_state: Tuple, permutation: jnp.ndarray) -> Tuple:
            def _update_minibatch(train_state: Tuple, minibatch_rows) -> Tuple:
                params, opt_states, key = train_state
                minibatch = unpack_rows(minibatch_rows)
                traj_batch, advantages, targets = jax.tree.map(
                    lambda x: jnp.swapaxes(x, 0, 1), minibatch
                )

                ent_coef = entropy_coefficient(config, opt_states.actor_opt_state)

                def _actor_loss_fn(actor_params, traj_batch, gae, entropy_key):
                    obs_and_done = (traj_batch.obs, traj_batch.done)
                    # Re-run the RNN from the chunk-initial hidden state.
                    _, actor_policy = actor_apply_fn(
                        actor_params,
                        traj_batch.hstates.policy_hidden_state[0],
                        obs_and_done,
                    )
                    log_prob = actor_policy.log_prob(traj_batch.action)
                    loss_actor = clipped_ppo_policy_loss(
                        log_prob, traj_batch.log_prob, gae, config.system.clip_eps
                    )
                    entropy = actor_policy.entropy(seed=entropy_key).mean()
                    total = loss_actor - ent_coef * entropy
                    return total, (loss_actor, entropy)

                def _critic_loss_fn(critic_params, traj_batch, targets):
                    obs_and_done = (traj_batch.obs, traj_batch.done)
                    _, value = critic_apply_fn(
                        critic_params,
                        traj_batch.hstates.critic_hidden_state[0],
                        obs_and_done,
                    )
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
                }
                return (new_params, new_opt_state, key), loss_info

            params, opt_states, key = update_state

            # Shuffle whole sequences: one wide row gather of the packed payload.
            shuffled = jnp.take(packed_batch, permutation, axis=0)
            minibatches = jnp.reshape(
                shuffled, (config.system.num_minibatches, -1, shuffled.shape[1])
            )

            (params, opt_states, key), loss_info = jax.lax.scan(
                _update_minibatch, (params, opt_states, key), minibatches
            )
            return (params, opt_states, key), loss_info

        # All epoch shuffles generated up front as ONE batched argsort (see ff_ippo).
        key, shuffle_key = jax.random.split(key)
        permutations = jnp.argsort(
            jax.random.bits(
                shuffle_key,
                (config.system.ppo_epochs, num_sequences),
                dtype=jnp.uint32,
            ),
            axis=1,
        )

        update_state = (params, opt_states, key)
        update_state, loss_info = jax.lax.scan(
            _update_epoch, update_state, permutations
        )

        params, opt_states, key = update_state
        learner_state = RNNLearnerState(
            params, opt_states, key, env_state, last_timestep, last_done, hstates
        )
        return learner_state, (traj_batch.info, loss_info)

    def learner_fn(learner_state: RNNLearnerState) -> ExperimentOutput[RNNLearnerState]:
        (params, opt_states, key, env_state, timestep, dones, hstates) = learner_state
        state = RNNLearnerState(
            params, opt_states, key[0], env_state, timestep, dones, hstates
        )
        state, (episode_info, loss_info) = jax.lax.scan(
            _update_step, state, None, config.system.num_updates_per_eval
        )
        state = RNNLearnerState(
            state.params, state.opt_states, state.key[None], state.env_state,
            state.timestep, state.dones, state.hstates,
        )
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=episode_info,
            train_metrics=loss_info,
        )

    return learner_fn


def learner_setup(
    env: MarlEnv, keys: Tuple, config: Config, mesh, centralised_critic: bool = False
) -> Tuple[Callable, Any, RNNLearnerState]:
    reject_stagger(config, "rec-IPPO/rec-MAPPO")
    # The ScannedRNN implementation (hoisted | cell) is threaded through network
    # construction — no module-level state, so systems with different impls
    # coexist in one process (tests/test_recurrent.py).
    gru_impl = config.network.get("gru_impl", None)

    n_devices = num_learner_devices(mesh)
    num_agents = env.num_agents
    config.system.num_agents = num_agents

    key, actor_net_key, critic_net_key = keys

    actor_network = Actor(
        pre_torso=make_torso(config.network.actor_network.pre_torso),
        post_torso=make_torso(config.network.actor_network.post_torso),
        action_head=make_action_head(config.network.action_head, env.action_dim),
        hidden_state_dim=config.network.hidden_state_dim,
        gru_impl=gru_impl,
    )
    critic_network = Critic(
        pre_torso=make_torso(config.network.critic_network.pre_torso),
        post_torso=make_torso(config.network.critic_network.post_torso),
        centralised_critic=centralised_critic,
        hidden_state_dim=config.network.hidden_state_dim,
        gru_impl=gru_impl,
    )
    # Same params, carry-collecting call style — used for the post-rollout batched
    # critic pass (values + per-step hidden states in one go).
    critic_carry_network = Critic(
        pre_torso=make_torso(config.network.critic_network.pre_torso),
        post_torso=make_torso(config.network.critic_network.post_torso),
        centralised_critic=centralised_critic,
        hidden_state_dim=config.network.hidden_state_dim,
        collect_carries=True,
        gru_impl=gru_impl,
    )

    actor_lr = make_learning_rate(config.system.actor_lr, config)
    critic_lr = make_learning_rate(config.system.critic_lr, config)
    actor_optim = make_optimizer(actor_lr, config.system.max_grad_norm)
    critic_optim = make_optimizer(critic_lr, config.system.max_grad_norm)

    init_obs = env.observation_spec().generate_value()
    init_obs = jax.tree.map(
        lambda x: jnp.repeat(x[jnp.newaxis, ...], config.arch.num_envs, axis=0),
        init_obs,
    )
    init_obs = jax.tree.map(lambda x: x[jnp.newaxis, ...], init_obs)
    init_done = jnp.zeros((1, config.arch.num_envs, num_agents), dtype=bool)
    init_x = (init_obs, init_done)

    init_policy_hstate = ScannedRNN.initialize_carry(
        (config.arch.num_envs, num_agents), config.network.hidden_state_dim
    )
    init_critic_hstate = ScannedRNN.initialize_carry(
        (config.arch.num_envs, num_agents), config.network.hidden_state_dim
    )

    actor_params = actor_network.init(actor_net_key, init_policy_hstate, init_x)
    actor_opt_state = actor_optim.init(actor_params)
    critic_params = critic_network.init(critic_net_key, init_critic_hstate, init_x)
    critic_opt_state = critic_optim.init(critic_params)

    apply_fns = (
        actor_network.apply, critic_network.apply, critic_carry_network.apply
    )
    update_fns = (actor_optim.update, critic_optim.update)

    learner = get_learner_fn(env, apply_fns, update_fns, config)
    state_specs = RNNLearnerState(
        params=P(),
        opt_states=P(),
        key=P(DATA_AXIS),
        env_state=P(DATA_AXIS),
        timestep=P(DATA_AXIS),
        dones=P(DATA_AXIS),
        hstates=P(DATA_AXIS),
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

    params = Params(actor_params, critic_params)
    hstates = HiddenStates(init_policy_hstate, init_critic_hstate)

    if config.logger.checkpointing.load_model:
        loaded_checkpoint = Checkpointer(
            model_name=config.logger.system_name,
            **config.logger.checkpointing.load_args,
        )
        restored_params, restored_hstates = loaded_checkpoint.restore_params(
            input_params=params, restore_hstates=True, input_hstates=hstates
        )
        params = restored_params
        hstates = restored_hstates if restored_hstates else hstates

    # Env states sharded over the env axis (per-host local resets on a pod slice —
    # see parallel/distributed.py).
    key, env_key = jax.random.split(key)
    env_states, timesteps = sharded_env_reset(
        env, env_key, n_devices * config.arch.num_envs, mesh
    )

    # Dones and hidden states are per-env state: identical per-shard templates,
    # tiled to the global env axis (only local rows materialized on a pod slice).
    dones = tile_for_shards(
        jnp.zeros((config.arch.num_envs, num_agents), dtype=bool), mesh
    )
    global_hstates = tile_for_shards(hstates, mesh)

    key, step_key = jax.random.split(key)
    step_keys = jax.random.split(step_key, n_devices)

    params = put_replicated(params, mesh)
    opt_states = put_replicated(OptStates(actor_opt_state, critic_opt_state), mesh)
    step_keys = put_sharded_rows(step_keys, mesh)

    init_learner_state = RNNLearnerState(
        params=params,
        opt_states=opt_states,
        key=step_keys,
        env_state=env_states,
        timestep=timesteps,
        dones=dones,
        hstates=global_hstates,
    )
    return learn, actor_network, init_learner_state


def run_experiment(_config: Config, centralised_critic: bool = False) -> float:
    """Train rec-IPPO (rec-MAPPO when `centralised_critic`)."""
    config = copy.deepcopy(_config)

    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    config.arch.n_devices = n_devices

    if config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length
    else:
        assert (
            config.system.rollout_length % config.system.recurrent_chunk_size == 0
        ), "Rollout length must be divisible by recurrent chunk size."

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
    # the whole learner state — optimizer/rng/env/hidden state included — from
    # a checkpoint written with `save_full_state=True` (see ff_ippo.py).
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

    save_checkpoint = config.logger.checkpointing.save_model
    if save_checkpoint:
        checkpointer = Checkpointer(
            metadata=config.to_dict(),
            model_name=config.logger.system_name,
            **config.logger.checkpointing.save_args,
        )

    # Per-shard eval hidden state (replicated into each shard by the evaluator).
    eval_batch_size = get_num_eval_envs(config, absolute_metric=False)
    eval_hs = ScannedRNN.initialize_carry(
        (eval_batch_size, config.system.num_agents),
        config.network.hidden_state_dim,
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
            eval_metrics = evaluator(
                trained_params, eval_key, {"hidden_state": eval_hs}
            )
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
        eval_batch_size = get_num_eval_envs(config, absolute_metric=True)
        eval_hs = ScannedRNN.initialize_carry(
            (eval_batch_size, config.system.num_agents),
            config.network.hidden_state_dim,
        )
        abs_metric_evaluator = get_eval_fn(
            eval_env, eval_act_fn, config, mesh, absolute_metric=True
        )
        key_e, eval_key = jax.random.split(key_e)
        eval_metrics = abs_metric_evaluator(
            best_params, eval_key, {"hidden_state": eval_hs}
        )
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

    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("Recurrent IPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
