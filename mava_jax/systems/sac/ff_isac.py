"""Feedforward Independent / Multi-Agent Soft Actor-Critic (ff-ISAC / ff-MASAC).

Capability parity with reference `mava/systems/sac/ff_isac.py` and `ff_masac.py`:
continuous tanh-Normal actors, twin Q networks with polyak targets, auto-tuned
entropy temperature alpha, TD3-style delayed (and compensated) policy updates, a
uniform-random exploration phase filling an on-device item replay buffer, and a fused
act-then-train compiled step. `centralised_critic=True` turns it into MASAC: twin
critics consume (global_state, joint action), with the actor loss substituting each
agent's fresh action into the replayed joint action
(reference `ff_masac.py:124-128,270,304,325`).

Mesh-runtime layout as in rec_iql.py: env/buffer sharded over `data`, params/counters
replicated, gradient pmean over the mesh.

Deviation from the reference: random exploration samples Uniform[-1, 1] (the action
space) rather than the reference's Uniform[0, 1) (`ff_isac.py:442`), which only covers
the positive quadrant — this looks like an upstream bug, not a behaviour to match.
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
from mava_jax.networks import FeedForwardQNet as QNetwork
from mava_jax.networks.factory import make_action_head, make_torso
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
from mava_jax.replay import make_item_buffer
from mava_jax.systems.sac.types import (
    LearnerState,
    OptStates,
    QVals,
    QValsAndTarget,
    SacParams,
    Transition,
)
from mava_jax.utils.centralised_training import (
    get_joint_action,
    get_updated_joint_actions,
)
from mava_jax.utils.checkpointing import Checkpointer, multihost_safe_state
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.profiling import PhaseTimer, maybe_trace
from mava_jax.utils.training import warn_q_divergence
from mava_jax.utils.timestep_checker import check_total_timesteps
from mava_jax.envs.wrappers import get_final_step_metrics
from mava_jax.envs.stagger import reject_stagger


def init(
    cfg: Config, mesh, centralised_critic: bool = False, swept_lr: bool = False
) -> Tuple:
    reject_stagger(cfg, "ff-ISAC/ff-MASAC")
    n_devices = num_learner_devices(mesh)

    env, eval_env = environments.make(cfg, add_global_state=centralised_critic)
    n_agents = env.num_agents
    action_dim = env.action_dim
    cfg.system.num_agents = n_agents

    key = jax.random.PRNGKey(cfg.system.seed)
    key, actor_key, q1_key, q2_key, q1_t_key, q2_t_key = jax.random.split(key, 6)

    acts = env.action_spec().generate_value()  # (A, act)
    obs = env.observation_spec().generate_value()
    obs_batched = jax.tree.map(lambda x: x[jnp.newaxis, ...], obs)  # (1, A, ...)
    if centralised_critic:
        act_batched = get_joint_action(acts[jnp.newaxis, ...])  # (1, A, A*act)
    else:
        act_batched = acts[jnp.newaxis, ...]  # (1, A, act)

    actor_network = Actor(
        torso=make_torso(cfg.network.actor_network.pre_torso),
        action_head=make_action_head(
            dict(cfg.network.action_head, independent_std=False), action_dim
        ),
    )
    actor_params = actor_network.init(actor_key, obs_batched)

    q_network = QNetwork(
        torso=make_torso(cfg.network.critic_network.pre_torso),
        centralised_critic=centralised_critic,
    )
    q1_params = q_network.init(q1_key, obs_batched, act_batched)
    q2_params = q_network.init(q2_key, obs_batched, act_batched)
    # Targets start as COPIES of the online critics (standard SAC). The reference
    # initialises them from fresh keys (`ff_isac.py:124-125`), which makes early TD
    # targets pure noise until polyak averaging catches up — documented deviation.
    del q1_t_key, q2_t_key
    q1_target_params = q1_params
    q2_target_params = q2_params

    target_entropy = -cfg.system.target_entropy_scale * action_dim
    target_entropy = jnp.repeat(target_entropy, n_agents).astype(float)[jnp.newaxis, :]
    if cfg.system.autotune:
        log_alpha = jnp.zeros_like(target_entropy)
    else:
        log_alpha = jnp.broadcast_to(
            jnp.log(cfg.system.init_alpha), target_entropy.shape
        )

    params = SacParams(
        actor_params,
        QValsAndTarget(
            QVals(q1_params, q2_params), QVals(q1_target_params, q2_target_params)
        ),
        log_alpha,
    )

    grad_clip = optax.clip_by_global_norm(cfg.system.max_grad_norm)
    if swept_lr:
        # Same math as the stock chain, but the actor/q lr lives in optimizer
        # STATE — stacked per-entry inits + vmap give a one-program lr sweep
        # (advanced_usage/ff_isac_vmap_sweep.py). Alpha keeps its closure lr.
        from mava_jax.utils.training import make_swept_adam

        actor_opt = make_swept_adam(
            cfg.system.policy_lr, cfg.system.max_grad_norm
        )
        q_opt = make_swept_adam(cfg.system.q_lr, cfg.system.max_grad_norm)
    else:
        actor_opt = optax.chain(grad_clip, optax.adam(cfg.system.policy_lr))
        q_opt = optax.chain(grad_clip, optax.adam(cfg.system.q_lr))
    alpha_opt = optax.chain(grad_clip, optax.adam(cfg.system.alpha_lr))
    opt_states = OptStates(
        actor_opt.init(params.actor),
        q_opt.init(params.q.online),
        alpha_opt.init(params.log_alpha),
    )

    init_transition = Transition(
        obs=compress_stored_obs(obs),
        action=acts,
        reward=jnp.zeros((n_agents,), dtype=jnp.float32),
        done=jnp.zeros((n_agents,), dtype=bool),
        next_obs=compress_stored_obs(obs),
    )
    rb = make_item_buffer(
        max_length=int(cfg.system.buffer_size),
        min_length=int(cfg.system.explore_steps),
        sample_batch_size=int(cfg.system.batch_size),
        add_batch_size=cfg.arch.num_envs,
    )
    buffer_state = rb.init(init_transition)

    # Env reset sharded over the mesh's env axis (per-host local resets on a pod
    # slice — see parallel/distributed.py).
    key, reset_key = jax.random.split(key)
    env_state, first_timestep = sharded_env_reset(
        env, reset_key, n_devices * cfg.arch.num_envs, mesh
    )

    key, step_key = jax.random.split(key)
    step_keys = jax.random.split(step_key, n_devices)

    # Buffer experience is per-shard; ring counters evolve identically -> replicated.
    buffer_state = buffer_state.replace(
        experience=tile_for_shards(buffer_state.experience, mesh),
        current_index=put_replicated(buffer_state.current_index, mesh),
        is_full=put_replicated(buffer_state.is_full, mesh),
    )

    learner_state = LearnerState(
        obs=first_timestep.observation,
        env_state=env_state,
        buffer_state=buffer_state,
        params=put_replicated(params, mesh),
        opt_states=put_replicated(opt_states, mesh),
        t=put_replicated(jnp.int32(0), mesh),
        key=put_sharded_rows(step_keys, mesh),
    )

    networks = (actor_network, q_network)
    optims = (actor_opt, q_opt, alpha_opt)
    return (env, eval_env), networks, optims, rb, learner_state, target_entropy, key


def compress_stored_obs(obs: Any) -> Any:
    """Deduplicate the global state before an observation enters the replay
    buffer. `GlobalStateWrapper` gives every agent the SAME global-state
    vector (reference semantics), so storing it per agent multiplies buffer
    HBM by num_agents for nothing — at the reference's 1M-item buffer this is
    what separates MASAC+MaCheetah fitting in 15.75G HBM from an 18.8G OOM
    (r3 queue j110). Only the stored copy is compressed; live observations
    are untouched."""
    if hasattr(obs, "global_state"):
        gs = obs.global_state
        # The slice below assumes the agent axis is second-to-last, i.e. a
        # per-agent-duplicated (…, A, G) VECTOR global state. Grid-shaped
        # global states (e.g. Cleaner/Connector's (A, H, W, C)) would be
        # sliced along the wrong axis and silently corrupt the critic input —
        # fail loudly instead. agents_view is (…, A, obs_dim) on the SAC path,
        # so its second-to-last dim is the agent count to match.
        if gs.ndim != obs.agents_view.ndim or gs.shape[-2] != obs.agents_view.shape[-2]:
            raise ValueError(
                "compress_stored_obs expects a per-agent-duplicated (…, A, G) "
                f"vector global state; got global_state {gs.shape} vs "
                f"agents_view {obs.agents_view.shape}. Grid global states are "
                "not supported by the replay dedup."
            )
        return obs._replace(global_state=gs[..., :1, :])
    return obs


def expand_sampled_obs(obs: Any, n_agents: int) -> Any:
    """Inverse of `compress_stored_obs` at the sample boundary: broadcast the
    stored single global-state row back to (…, n_agents, G)."""
    if hasattr(obs, "global_state"):
        gs = obs.global_state
        return obs._replace(
            global_state=jnp.broadcast_to(
                gs, (*gs.shape[:-2], n_agents, gs.shape[-1])
            )
        )
    return obs


def make_update_fns(
    cfg: Config,
    env: Any,
    networks: Tuple,
    optims: Tuple,
    rb,
    target_entropy: jnp.ndarray,
    centralised_critic: bool = False,
) -> Tuple[Callable, Callable]:
    actor_net, q_net = networks
    actor_opt, q_opt, alpha_opt = optims

    full_action_shape = (cfg.arch.num_envs, *env.action_spec().shape)

    def critic_action(action: jnp.ndarray) -> jnp.ndarray:
        return get_joint_action(action) if centralised_critic else action

    def step(action, obs, env_state, buffer_state):
        env_state, timestep = jax.vmap(env.step)(env_state, action)
        next_obs = timestep.observation
        rewards = timestep.reward
        terms = ~timestep.discount.astype(bool)
        infos = timestep.extras

        transition = Transition(
            compress_stored_obs(obs),
            action,
            rewards,
            terms,
            compress_stored_obs(infos["real_next_obs"]),
        )
        buffer_state = rb.add(buffer_state, transition)
        return next_obs, env_state, buffer_state, infos["episode_metrics"]

    # ---- losses ----------------------------------------------------------------
    def q_loss_fn(q_params: QVals, obs, action, target):
        q1_a_values = q_net.apply(q_params.q1, obs, action)
        q2_a_values = q_net.apply(q_params.q2, obs, action)
        q1_loss = jnp.mean(jnp.square(q1_a_values - target))
        q2_loss = jnp.mean(jnp.square(q2_a_values - target))
        loss = q1_loss + q2_loss
        # Means only: the logger reduces to a mean anyway, and carrying the full
        # per-sample arrays through pmean + two scans wastes all-reduce bandwidth.
        loss_info = {
            "loss": loss,
            "q1_loss": q1_loss,
            "q2_loss": q2_loss,
            "q1_a_vals": jnp.mean(q1_a_values),
            "q2_a_vals": jnp.mean(q2_a_values),
        }
        return loss, loss_info

    def actor_loss_fn(actor_params, obs, data_action, alpha, q_params: QVals, key):
        pi = actor_net.apply(actor_params, obs)
        action, log_prob = pi.sample_and_log_prob(seed=key)
        if centralised_critic:
            q_action = get_updated_joint_actions(data_action, action)
        else:
            q_action = action
        qval_1 = q_net.apply(q_params.q1, obs, q_action)
        qval_2 = q_net.apply(q_params.q2, obs, q_action)
        min_q_val = jnp.minimum(qval_1, qval_2)
        return ((alpha * log_prob) - min_q_val).mean()

    def alpha_loss_fn(log_alpha, log_pi, target_entropy):
        return jnp.mean(-jnp.exp(log_alpha) * (log_pi + target_entropy))

    # ---- updates ---------------------------------------------------------------
    def update_q(params: SacParams, opt_states: OptStates, data: Transition, key):
        pi = actor_net.apply(params.actor, data.next_obs)
        next_action, next_log_prob = pi.sample_and_log_prob(seed=key)
        next_q_action = critic_action(next_action)

        next_q1_val = q_net.apply(params.q.targets.q1, data.next_obs, next_q_action)
        next_q2_val = q_net.apply(params.q.targets.q2, data.next_obs, next_q_action)
        next_q_val = jnp.minimum(next_q1_val, next_q2_val)
        next_q_val = next_q_val - jnp.exp(params.log_alpha) * next_log_prob

        # reward_scale (default 1.0 = reference semantics) shrinks the TD target —
        # and hence the Q magnitude the critic must extrapolate — the standard
        # mitigation for the joint-action-critic overtraining divergence observed
        # on MaSwarm at epochs=32 (BASELINE.md parity notes; ablation row).
        target_q_val = (
            cfg.system.reward_scale * data.reward
            + (1.0 - data.done) * cfg.system.gamma * next_q_val
        )

        q_grad_fn = jax.grad(q_loss_fn, has_aux=True)
        q_grads, q_loss_info = q_grad_fn(
            params.q.online, data.obs, critic_action(data.action), target_q_val
        )
        q_grads, q_loss_info = jax.lax.pmean(
            (q_grads, q_loss_info), axis_name=DATA_AXIS
        )
        q_updates, new_q_opt_state = q_opt.update(q_grads, opt_states.q)
        new_online_q_params = optax.apply_updates(params.q.online, q_updates)

        new_target_q_params = optax.incremental_update(
            new_online_q_params, params.q.targets, cfg.system.tau
        )
        params = params._replace(
            q=QValsAndTarget(new_online_q_params, new_target_q_params)
        )
        opt_states = opt_states._replace(q=new_q_opt_state)
        return params, opt_states, q_loss_info

    def update_actor_and_alpha(
        params: SacParams, opt_states: OptStates, data: Transition, key
    ):
        assert cfg.system.policy_update_delay > 0
        # TD3 trick: do `policy_update_delay` updates to compensate for the delay.
        for _ in range(cfg.system.policy_update_delay):
            key, actor_key, alpha_key = jax.random.split(key, 3)

            actor_grad_fn = jax.value_and_grad(actor_loss_fn)
            actor_loss, act_grads = actor_grad_fn(
                params.actor,
                data.obs,
                data.action,
                jnp.exp(params.log_alpha),
                params.q.online,
                actor_key,
            )
            actor_loss, act_grads = jax.lax.pmean(
                (actor_loss, act_grads), axis_name=DATA_AXIS
            )
            actor_updates, new_actor_opt_state = actor_opt.update(
                act_grads, opt_states.actor
            )
            new_actor_params = optax.apply_updates(params.actor, actor_updates)
            params = params._replace(actor=new_actor_params)
            opt_states = opt_states._replace(actor=new_actor_opt_state)

            alpha_loss = 0.0
            if cfg.system.autotune:
                pi = actor_net.apply(params.actor, data.obs)
                _, log_prob = pi.sample_and_log_prob(seed=alpha_key)
                alpha_grad_fn = jax.value_and_grad(alpha_loss_fn)
                alpha_loss, alpha_grads = alpha_grad_fn(
                    params.log_alpha, log_prob, target_entropy
                )
                alpha_loss, alpha_grads = jax.lax.pmean(
                    (alpha_loss, alpha_grads), axis_name=DATA_AXIS
                )
                alpha_updates, new_alpha_opt_state = alpha_opt.update(
                    alpha_grads, opt_states.alpha
                )
                new_log_alpha = optax.apply_updates(params.log_alpha, alpha_updates)
                params = params._replace(log_alpha=new_log_alpha)
                opt_states = opt_states._replace(alpha=new_alpha_opt_state)

        return params, opt_states, {"actor_loss": actor_loss, "alpha_loss": alpha_loss}

    # ---- act / train loops -----------------------------------------------------
    def train(carry, epoch_idx):
        buffer_state, params, opt_states, t, key = carry
        key, buff_key, q_key, actor_key = jax.random.split(key, 4)
        data = rb.sample(buffer_state, buff_key).experience
        data = data._replace(
            obs=expand_sampled_obs(data.obs, env.num_agents),
            next_obs=expand_sampled_obs(data.next_obs, env.num_agents),
        )

        params, opt_states, q_loss_info = update_q(params, opt_states, data, q_key)
        # TD3-style delay gated on the TRAIN-step index. The reference gates on the
        # env-step counter t (`ff_isac.py:400`), which is constant across the epochs
        # scan and always a multiple of the delay whenever num_envs is — making the
        # gate permanently true and the actor train delay-times too often. Gating on
        # the epoch index restores the intended 1:1 average actor:critic ratio
        # (the compensation loop below then runs `delay` updates every `delay`-th
        # train) — documented deviation.
        params, opt_states, act_loss_info = jax.lax.cond(
            epoch_idx % cfg.system.policy_update_delay == 0,
            update_actor_and_alpha,
            lambda params, opt_states, *_: (
                params,
                opt_states,
                {"actor_loss": 0.0, "alpha_loss": 0.0},
            ),
            params,
            opt_states,
            data,
            actor_key,
        )
        losses = {**q_loss_info, **act_loss_info}
        return (buffer_state, params, opt_states, t, key), losses

    def act(carry, _):
        actor_params, obs, env_state, buffer_state, key = carry
        key, act_key = jax.random.split(key)
        pi = actor_net.apply(actor_params, obs)
        action = pi.sample(seed=act_key)
        next_obs, env_state, buffer_state, metrics = step(
            action, obs, env_state, buffer_state
        )
        return (actor_params, next_obs, env_state, buffer_state, key), metrics

    def explore(carry: LearnerState, _):
        obs, env_state, buffer_state, params, opt_states, t, key = carry
        key, explore_key = jax.random.split(key)
        action = jax.random.uniform(
            explore_key, full_action_shape, minval=-1.0, maxval=1.0
        )
        next_obs, env_state, buffer_state, metrics = step(
            action, obs, env_state, buffer_state
        )
        learner_state = carry._replace(
            obs=next_obs,
            env_state=env_state,
            buffer_state=buffer_state,
            t=t + cfg.arch.num_envs,
            key=key,
        )
        return learner_state, metrics

    def update_step(carry: LearnerState, _):
        obs, env_state, buffer_state, params, opt_states, t, key = carry
        key, act_key, learn_key = jax.random.split(key, 3)

        act_state = (params.actor, obs, env_state, buffer_state, act_key)
        (_, next_obs, env_state, buffer_state, _), metrics = jax.lax.scan(
            act,
            act_state,
            None,
            length=cfg.system.rollout_length,
            # Light unroll amortises the per-env-step loop overhead exactly as
            # on the ff-PPO rollout (math-identical).
            unroll=int(cfg.system.get("rollout_unroll", 1)),
        )

        learn_state = (buffer_state, params, opt_states, t, learn_key)
        (buffer_state, params, opt_states, _, _), losses = jax.lax.scan(
            train, learn_state, jnp.arange(cfg.system.epochs)
        )

        t = t + cfg.arch.num_envs * cfg.system.rollout_length
        return (
            LearnerState(next_obs, env_state, buffer_state, params, opt_states, t, key),
            (metrics, losses),
        )

    explore_steps = cfg.system.explore_steps // cfg.arch.num_envs

    def explore_fn(learner_state: LearnerState):
        state = learner_state._replace(key=learner_state.key[0])
        state, metrics = jax.lax.scan(explore, state, None, length=explore_steps)
        return state._replace(key=state.key[None]), metrics

    def update_fn(learner_state: LearnerState):
        state = learner_state._replace(key=learner_state.key[0])
        state, (metrics, losses) = jax.lax.scan(
            update_step, state, None, length=cfg.system.scan_steps
        )
        return state._replace(key=state.key[None]), (metrics, losses)

    return explore_fn, update_fn


def _state_specs(buffer_template) -> LearnerState:
    buffer_specs = buffer_template.replace(
        experience=jax.tree.map(lambda _: P(DATA_AXIS), buffer_template.experience),
        current_index=P(),
        is_full=P(),
    )
    return LearnerState(
        obs=P(DATA_AXIS),
        env_state=P(DATA_AXIS),
        buffer_state=buffer_specs,
        params=P(),
        opt_states=P(),
        t=P(),
        key=P(DATA_AXIS),
    )


def build_bench_learners(
    cfg: Config, mesh, centralised_critic: bool = False
) -> Tuple[Callable, Callable, LearnerState]:
    """(explore, update, initial state): the shard_mapped explore/update
    programs. One home for the spec wiring shared by the perf/bench tooling
    (scripts/bench_mfu.py, scripts/profile_sac.py, tests) — run_experiment
    keeps its own copy because it also threads checkpoint/donation options."""
    (env, _), networks, optims, rb, state, target_entropy, _ = init(
        cfg, mesh, centralised_critic
    )
    explore_fn, update_fn = make_update_fns(
        cfg, env, networks, optims, rb, target_entropy, centralised_critic
    )
    specs = _state_specs(state.buffer_state)
    explore = build_learner(
        explore_fn, mesh, in_specs=(specs,), out_specs=(specs, P(None, DATA_AXIS))
    )
    update = build_learner(
        update_fn,
        mesh,
        in_specs=(specs,),
        out_specs=(specs, (P(None, None, DATA_AXIS), P())),
    )
    return explore, update, state


def run_experiment(cfg: Config, centralised_critic: bool = False) -> float:
    cfg = copy.deepcopy(cfg)
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg = check_total_timesteps(cfg)

    steps_per_rollout = int(cfg.system.total_timesteps // cfg.arch.num_evaluation)
    anakin_act_steps = n_devices * cfg.arch.num_envs * cfg.system.rollout_length
    cfg.system.scan_steps = max(1, int(steps_per_rollout / anakin_act_steps))

    (env, eval_env), networks, optims, rb, learner_state, target_entropy, key = init(
        cfg, mesh, centralised_critic
    )
    explore_fn, update_fn = make_update_fns(
        cfg, env, networks, optims, rb, target_entropy, centralised_critic
    )

    state_specs = _state_specs(learner_state.buffer_state)
    donate = cfg.arch.get("donate_buffers", False)
    explore = build_learner(
        explore_fn,
        mesh,
        in_specs=(state_specs,),
        out_specs=(state_specs, P(None, DATA_AXIS)),
        donate=donate,
    )
    update = build_learner(
        update_fn,
        mesh,
        in_specs=(state_specs,),
        out_specs=(state_specs, (P(None, None, DATA_AXIS), P())),
        donate=donate,
    )

    # Exact-state resume: restore the WHOLE learner state (params, optimizer
    # moments, replay buffer, env states, rng, step counter) and continue. The
    # env-step counter lives in the state, so a resumed run finishes the
    # REMAINING total_timesteps budget and skips the explore phase.
    resumed = False
    if cfg.logger.checkpointing.get("load_full_state", False):
        loader = Checkpointer(
            model_name=cfg.logger.system_name,
            **cfg.logger.checkpointing.load_args,
        )
        template = multihost_safe_state(learner_state)
        restored = loader.restore_full_state(template)
        learner_state = jax.tree.map(
            lambda t_, x: jax.device_put(x, t_.sharding), learner_state, restored
        )
        loader.close()
        resumed = True

    logger = MavaLogger(cfg)

    actor, _ = networks
    eval_act_fn = make_ff_eval_act_fn(actor.apply, cfg)
    evaluator = get_eval_fn(eval_env, eval_act_fn, cfg, mesh, absolute_metric=False)

    if cfg.logger.checkpointing.save_model:
        checkpointer = Checkpointer(
            metadata=cfg.to_dict(),
            model_name=cfg.logger.system_name,
            **cfg.logger.checkpointing.save_args,
        )

    max_episode_return = -jnp.inf
    best_params = None

    if not resumed:
        start_time = time.time()
        learner_state, metrics = explore(learner_state)
        jax.block_until_ready(learner_state)

        # Global env-step accounting: explore consumed explore-steps per shard.
        t = int(learner_state.t) * n_devices
        sps = t / (time.time() - start_time)
        logger.log({"step": t}, t, 0, LogEvent.MISC)
        final_metrics, ep_completed = get_final_step_metrics(metrics)
        final_metrics["steps_per_second"] = sps
        if ep_completed:  # long time limits may complete no episode in explore
            logger.log(final_metrics, t, 0, LogEvent.ACT)
    else:
        t = int(learner_state.t) * n_devices
        logger.log({"step": t}, t, 0, LogEvent.MISC)

    start = t
    stop = int(cfg.system.total_timesteps + 1)
    assert start < stop, (
        f"resumed at env-step {start} but total_timesteps={stop - 1} — "
        "nothing left to train; raise system.total_timesteps to extend the run"
    )
    for eval_idx, t in enumerate(range(start, stop, steps_per_rollout)):
        timer = PhaseTimer()
        start_time = time.time()
        with maybe_trace(cfg, eval_idx), timer.phase("learn"):
            learner_state, (metrics, losses) = update(learner_state)
            jax.block_until_ready(learner_state)
        t += steps_per_rollout

        elapsed_time = time.time() - start_time
        final_metrics, ep_completed = get_final_step_metrics(metrics)
        final_metrics["steps_per_second"] = steps_per_rollout / elapsed_time
        loss_metrics = {**losses, "log_alpha": learner_state.params.log_alpha}
        # Q-divergence guardrail (BASELINE.md j200 failure mode): warn from the
        # already-logged mean-Q magnitudes, host-side, zero device cost.
        warn_q_divergence(
            losses,
            float(cfg.system.get("q_divergence_warn_bound", 1e3)),
            cfg.logger.system_name,
        )

        if ep_completed:
            logger.log(final_metrics, t, eval_idx, LogEvent.ACT)
        logger.log(loss_metrics, t, eval_idx, LogEvent.TRAIN)

        key, eval_key = jax.random.split(key)
        with timer.phase("eval"):
            eval_metrics = evaluator(learner_state.params.actor, eval_key, {})
        logger.log(eval_metrics, t, eval_idx, LogEvent.EVAL)
        logger.log({"timestep": t, **timer.metrics()}, t, eval_idx, LogEvent.MISC)
        episode_return = jnp.mean(eval_metrics["episode_return"])

        if cfg.arch.absolute_metric and max_episode_return <= episode_return:
            best_params = jax.tree.map(lambda x: x.copy(), learner_state.params.actor)
            max_episode_return = episode_return

        if cfg.logger.checkpointing.save_model:
            checkpointer.save(
                timestep=t,
                unreplicated_learner_state=multihost_safe_state(learner_state),
                episode_return=episode_return,
                full_state=cfg.logger.checkpointing.get("save_full_state", False),
            )

    eval_performance = float(jnp.mean(eval_metrics[cfg.env.eval_metric]))

    if cfg.arch.absolute_metric:
        abs_metric_evaluator = get_eval_fn(
            eval_env, eval_act_fn, cfg, mesh, absolute_metric=True
        )
        key, eval_key = jax.random.split(key)
        eval_metrics = abs_metric_evaluator(best_params, eval_key, {})
        logger.log(eval_metrics, t, eval_idx, LogEvent.ABSOLUTE)

    logger.stop()
    return float(eval_performance)


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    cfg = load_config("default_ff_isac", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ISAC experiment completed.")
    return performance


if __name__ == "__main__":
    main()
