"""Recurrent Independent Q-Learning (rec-IQL / IDQN).

Capability parity with reference `mava/systems/q_learning/rec_iql.py`: a fused
act-then-train compiled step — epsilon-greedy acting with a recurrent Q network into an
on-device trajectory replay buffer, then double-DQN updates on sampled sequences with
hard (periodic) or soft (incremental) target updates.

Mesh-runtime layout (vs the reference's `pmap(vmap(scan(...)))`, `rec_iql.py:521-528`):
env/buffer/hidden state are sharded over the `data` axis (the per-shard buffer holds
that shard's envs, add_batch_size = per-device num_envs); params/optimizer/counters are
replicated; gradients sync with one `pmean('data')`. Buffer ring counters
evolve identically on every shard, so they stay replicated scalars.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.distributions import masked_greedy
from mava_jax.evaluator import get_eval_fn, get_num_eval_envs
from mava_jax.networks import RecQNetwork, ScannedRNN
from mava_jax.networks.factory import make_torso
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
from mava_jax.replay import make_trajectory_buffer
from mava_jax.systems.q_learning.types import (
    ActionSelectionState,
    ActionState,
    LearnerState,
    QNetParams,
    TrainState,
    Transition,
)
from mava_jax.utils.checkpointing import Checkpointer, multihost_safe_state
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.jax_utils import select_along_last, switch_leading_axes
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.profiling import PhaseTimer, maybe_trace
from mava_jax.utils.training import warn_q_divergence
from mava_jax.utils.timestep_checker import check_total_timesteps
from mava_jax.envs.wrappers import get_final_step_metrics
from mava_jax.envs.stagger import reject_stagger


def epsilon_schedule(cfg: Config, t):
    """Exploration epsilon at GLOBAL env-step count `t`: linear 1 -> eps_min over
    the first `eps_decay` global steps, flat after.

    `t` is advanced by `num_envs * n_devices` per act step (shards act in
    lockstep), so the schedule is positioned in the same global-timestep units
    that `eps_decay` is configured and logged in. The single-process reference
    counts per-shard steps (`rec_iql.py:277`), which on a mesh would decay
    epsilon n_devices times slower; `tests/test_systems_integration.py`
    pins this schedule shape and the global counting.
    """
    return jnp.maximum(
        cfg.system.eps_min,
        1 - (t / cfg.system.eps_decay) * (1 - cfg.system.eps_min),
    )


def make_update_fn(
    cfg: Config, env: Any, q_net: RecQNetwork, opt: optax.GradientTransformation, rb
) -> Callable:
    """Build the per-shard scanned act+train update."""

    # ---- acting --------------------------------------------------------------
    def select_eps_greedy_action(
        action_selection_state: ActionSelectionState, obs, term_or_trunc
    ):
        params, hidden_state, t, key = action_selection_state
        eps = epsilon_schedule(cfg, t)
        obs = jax.tree.map(lambda x: x[jnp.newaxis, ...], obs)
        term_or_trunc = jax.tree.map(lambda x: x[jnp.newaxis, ...], term_or_trunc)
        next_hidden_state, eps_greedy_dist = q_net.apply(
            params, hidden_state, (obs, term_or_trunc), eps
        )
        new_key, explore_key = jax.random.split(key)
        action = eps_greedy_dist.sample(seed=explore_key)[0]  # (1,B,A) -> (B,A)
        # Count GLOBAL env steps (shards step in lockstep): eps_decay is configured
        # and logged in global timesteps, so per-shard counting (as in the
        # single-process reference, `rec_iql.py:277`) would decay epsilon n_devices
        # times slower on a mesh.
        step_increment = cfg.arch.num_envs * cfg.arch.n_devices
        return (
            ActionSelectionState(
                params, next_hidden_state, t + step_increment, new_key
            ),
            action,
        )

    def action_step(action_state: ActionState, _: Any) -> Tuple[ActionState, Dict]:
        (action_selection_state, env_state, buffer_state, obs, terminal,
         term_or_trunc) = action_state

        next_action_selection_state, action = select_eps_greedy_action(
            action_selection_state, obs, term_or_trunc
        )
        next_env_state, next_timestep = jax.vmap(env.step)(env_state, action)

        transition = Transition(
            obs, action, next_timestep.reward, terminal, term_or_trunc,
            next_timestep.extras["real_next_obs"],
        )
        transition = jax.tree.map(lambda x: x[:, jnp.newaxis, ...], transition)
        next_buffer_state = rb.add(buffer_state, transition)

        next_obs = next_timestep.observation
        next_terminal = (1 - next_timestep.discount[..., 0, jnp.newaxis]).astype(bool)
        next_term_or_trunc = next_timestep.last()[..., jnp.newaxis]

        new_act_state = ActionState(
            next_action_selection_state, next_env_state, next_buffer_state,
            next_obs, next_terminal, next_term_or_trunc,
        )
        return new_act_state, next_timestep.extras["episode_metrics"]

    # ---- training ------------------------------------------------------------
    def prep_inputs_to_scannedrnn(obs, term_or_trunc):
        hidden_state = ScannedRNN.initialize_carry(
            (cfg.system.sample_batch_size, obs.agents_view.shape[2]),
            cfg.network.hidden_state_dim,
        )
        # Buffer samples are (B, T, ...); the RNN scans (T, B, ...).
        obs = switch_leading_axes(obs)
        term_or_trunc = switch_leading_axes(term_or_trunc)
        return hidden_state, (obs, term_or_trunc)

    def q_loss_fn(q_online_params, obs, term_or_trunc, action, target):
        hidden_state, obs_term_or_trunc = prep_inputs_to_scannedrnn(obs, term_or_trunc)
        _, q_online = q_net.apply(
            q_online_params, hidden_state, obs_term_or_trunc, method="get_q_values"
        )
        q_online = switch_leading_axes(q_online)
        q_online = select_along_last(q_online, action)
        q_loss = jnp.mean(jnp.square(q_online - target))
        loss_info = {
            "q_loss": q_loss,
            "mean_q": jnp.mean(q_online),
            "mean_target": jnp.mean(target),
        }
        return q_loss, loss_info

    def update_q(params: QNetParams, opt_state, data: Transition, t_train):
        # Align current/next steps: the stored next_obs of step t pairs with the
        # terminal flags stored at step t+1 (AutoResetWrapper bookkeeping).
        data_first = jax.tree.map(lambda x: x[:, :-1, ...], data)
        data_next = jax.tree.map(lambda x: x[:, 1:, ...], data)

        next_obs = data_first.next_obs
        next_term_or_trunc = data_next.term_or_trunc
        next_terminal = data_next.terminal

        hidden_state, next_inputs = prep_inputs_to_scannedrnn(
            next_obs, next_term_or_trunc
        )
        if cfg.system.get("fused_target_pass", True):
            # Double-DQN's online-greedy action and target Q-values both come
            # from full-length GRU passes over the SAME next_inputs. Stacking
            # online+target params on a leading axis and vmapping the apply
            # folds them into ONE pass of 2x batch: one serial recurrence chain
            # instead of two. The reference pays the sequential double pass
            # (`mava/systems/q_learning/rec_iql.py:400-420`). Equivalence to
            # the unfused path is pinned in tests/test_systems_integration.py.
            stacked = jax.tree.map(
                lambda o, t: jnp.stack([o, t]), params.online, params.target
            )
            _, q_both = jax.vmap(
                lambda p: q_net.apply(
                    p, hidden_state, next_inputs, method="get_q_values"
                )
            )(stacked)
            next_action = masked_greedy(q_both[0], next_inputs[0].action_mask)
            next_q_vals_target = q_both[1]
        else:
            _, next_online_greedy_dist = q_net.apply(
                params.online, hidden_state, next_inputs
            )
            _, next_q_vals_target = q_net.apply(
                params.target, hidden_state, next_inputs, method="get_q_values"
            )
            next_action = next_online_greedy_dist.mode()
        next_q_val = select_along_last(next_q_vals_target, next_action)
        next_q_val = switch_leading_axes(next_q_val)

        target_q_val = (
            data_first.reward
            + (1.0 - next_terminal) * cfg.system.gamma * next_q_val
        )

        q_grad_fn = jax.grad(q_loss_fn, has_aux=True)
        q_grads, q_loss_info = q_grad_fn(
            params.online,
            data_first.obs,
            data_first.term_or_trunc,
            data_first.action,
            target_q_val,
        )
        q_grads, q_loss_info = jax.lax.pmean(
            (q_grads, q_loss_info), axis_name=DATA_AXIS
        )
        q_updates, next_opt_state = opt.update(q_grads, opt_state)
        next_online_params = optax.apply_updates(params.online, q_updates)

        if cfg.system.hard_update:
            next_target_params = optax.periodic_update(
                next_online_params, params.target, t_train, cfg.system.update_period
            )
        else:
            next_target_params = optax.incremental_update(
                next_online_params, params.target, cfg.system.tau
            )
        return QNetParams(next_online_params, next_target_params), next_opt_state, q_loss_info

    def train(train_state: TrainState, _: Any) -> Tuple[TrainState, Dict]:
        buffer_state, params, opt_state, t_train, key = train_state
        next_key, buff_key = jax.random.split(key)
        data = rb.sample(buffer_state, buff_key).experience
        next_params, next_opt_state, q_loss_info = update_q(
            params, opt_state, data, t_train
        )
        return (
            TrainState(buffer_state, next_params, next_opt_state, t_train + 1, next_key),
            q_loss_info,
        )

    # ---- fused act + train ----------------------------------------------------
    def update_step(learner_state: LearnerState, _: Any):
        (obs, terminal, term_or_trunc, hidden_state, env_state, time_steps,
         train_steps, opt_state, buffer_state, params, key) = learner_state
        new_key, act_key, train_key = jax.random.split(key, 3)

        action_selection_state = ActionSelectionState(
            params.online, hidden_state, time_steps, act_key
        )
        action_state = ActionState(
            action_selection_state, env_state, buffer_state, obs, terminal,
            term_or_trunc,
        )
        final_action_state, metrics = jax.lax.scan(
            action_step,
            action_state,
            None,
            length=cfg.system.rollout_length,
            # Light unroll on the serial act chain (math-identical).
            unroll=int(cfg.system.get("rollout_unroll", 1)),
        )

        train_state = TrainState(
            final_action_state.buffer_state, params, opt_state, train_steps, train_key
        )
        final_train_state, losses = jax.lax.scan(
            train, train_state, None, length=cfg.system.epochs
        )

        next_learner_state = LearnerState(
            final_action_state.obs,
            final_action_state.terminal,
            final_action_state.term_or_trunc,
            final_action_state.action_selection_state.hidden_state,
            final_action_state.env_state,
            final_action_state.action_selection_state.time_steps,
            final_train_state.train_steps,
            final_train_state.opt_state,
            final_action_state.buffer_state,
            final_train_state.params,
            new_key,
        )
        return next_learner_state, (metrics, losses)

    def learner_fn(learner_state: LearnerState):
        state = learner_state._replace(key=learner_state.key[0])
        state, (metrics, losses) = jax.lax.scan(
            update_step, state, None, length=cfg.system.scan_steps
        )
        state = state._replace(key=state.key[None])
        return state, (metrics, losses)

    return learner_fn


def init(cfg: Config, mesh, swept_lr: bool = False) -> Tuple:
    reject_stagger(cfg, "rec-IQL")
    # The ScannedRNN implementation (hoisted | cell) is threaded through
    # network construction — no module-level state.
    gru_impl = cfg.network.get("gru_impl", None)

    n_devices = num_learner_devices(mesh)

    env, eval_env = environments.make(cfg)
    action_dim = env.action_dim
    num_agents = env.num_agents
    cfg.system.num_agents = num_agents

    key = jax.random.PRNGKey(cfg.system.seed)
    key, q_key = jax.random.split(key)

    init_obs = env.observation_spec().generate_value()
    init_obs_batched = jax.tree.map(
        lambda x: x[jnp.newaxis, jnp.newaxis, ...], init_obs
    )  # (T=1, B=1, A, ...)
    init_term_or_trunc = jnp.zeros((1, 1, 1), dtype=bool)
    init_x = (init_obs_batched, init_term_or_trunc)
    init_hidden_state = ScannedRNN.initialize_carry(
        (cfg.arch.num_envs, num_agents), cfg.network.hidden_state_dim
    )

    q_net = RecQNetwork(
        make_torso(cfg.network.q_network.pre_torso),
        make_torso(cfg.network.q_network.post_torso),
        action_dim,
        cfg.network.hidden_state_dim,
        gru_impl=gru_impl,
    )
    q_params = q_net.init(q_key, init_hidden_state, init_x)
    q_target_params = q_net.init(q_key, init_hidden_state, init_x)
    params = QNetParams(q_params, q_target_params)

    if swept_lr:
        # Same math, lr moved into optimizer STATE so stacked per-entry inits
        # + vmap sweep it in one program (advanced_usage/rec_iql_vmap_sweep.py).
        from mava_jax.utils.training import make_swept_adam

        opt = make_swept_adam(cfg.system.q_lr, cfg.system.max_grad_norm, eps=1e-5)
    else:
        opt = optax.chain(
            optax.clip_by_global_norm(cfg.system.max_grad_norm),
            optax.adam(learning_rate=cfg.system.q_lr, eps=1e-5),
        )
    opt_state = opt.init(params.online)

    init_acts = env.action_spec().generate_value()
    init_transition = Transition(
        obs=init_obs,
        action=init_acts,
        reward=jnp.zeros((num_agents,), dtype=jnp.float32),
        terminal=jnp.zeros((1,), dtype=bool),
        term_or_trunc=jnp.zeros((1,), dtype=bool),
        next_obs=init_obs,
    )

    rb = make_trajectory_buffer(
        sample_sequence_length=cfg.system.sample_sequence_length + 1,
        period=1,
        add_batch_size=cfg.arch.num_envs,
        sample_batch_size=cfg.system.sample_batch_size,
        max_length_time_axis=cfg.system.buffer_size,
        min_length_time_axis=cfg.system.min_buffer_size,
    )
    buffer_state = rb.init(init_transition)

    # Env reset sharded over the mesh's env axis (per-host local resets on a pod
    # slice — see parallel/distributed.py).
    key, reset_key = jax.random.split(key)
    env_state, first_timestep = sharded_env_reset(
        env, reset_key, n_devices * cfg.arch.num_envs, mesh
    )

    # Eager ops on the already-sharded timestep: every process executes the same
    # program, so these are multi-process safe and stay shard-local.
    first_obs = first_timestep.observation
    first_term_or_trunc = first_timestep.last()[..., jnp.newaxis]
    first_term = (1 - first_timestep.discount[..., 0, jnp.newaxis]).astype(bool)

    key, step_key = jax.random.split(key)
    step_keys = jax.random.split(step_key, n_devices)

    # Buffer experience is per-shard (its add-batch rows are this shard's envs);
    # ring counters evolve identically everywhere -> replicated.
    buffer_state = buffer_state.replace(
        experience=tile_for_shards(buffer_state.experience, mesh),
        current_index=put_replicated(buffer_state.current_index, mesh),
        is_full=put_replicated(buffer_state.is_full, mesh),
    )

    learner_state = LearnerState(
        obs=first_obs,
        terminal=first_term,
        term_or_trunc=first_term_or_trunc,
        hidden_state=tile_for_shards(init_hidden_state, mesh),
        env_state=env_state,
        time_steps=put_replicated(jnp.int32(0), mesh),
        train_steps=put_replicated(jnp.int32(0), mesh),
        opt_state=put_replicated(opt_state, mesh),
        buffer_state=buffer_state,
        params=put_replicated(params, mesh),
        key=put_sharded_rows(step_keys, mesh),
    )
    return (env, eval_env), q_net, opt, rb, learner_state, key


def _state_specs(buffer_template) -> LearnerState:
    """Per-shard sharding layout of the rec-IQL learner state: env-parallel
    leaves (obs/env/hidden/rng and the replay EXPERIENCE) ride the data axis;
    params/opt and the ring counters are replicated. Single source of truth for
    both the stock learner and the vmapped variants
    (advanced_usage/rec_iql_vmap_seeds.py)."""
    buffer_specs = buffer_template.replace(
        experience=jax.tree.map(lambda _: P(DATA_AXIS), buffer_template.experience),
        current_index=P(),
        is_full=P(),
    )
    return LearnerState(
        obs=P(DATA_AXIS),
        terminal=P(DATA_AXIS),
        term_or_trunc=P(DATA_AXIS),
        hidden_state=P(DATA_AXIS),
        env_state=P(DATA_AXIS),
        time_steps=P(),
        train_steps=P(),
        opt_state=P(),
        buffer_state=buffer_specs,
        params=P(),
        key=P(DATA_AXIS),
    )


def build_learn_fn(cfg: Config, env, q_net, opt, rb, mesh, buffer_template) -> Callable:
    learner = make_update_fn(cfg, env, q_net, opt, rb)
    state_specs = _state_specs(buffer_template)
    out_specs = (
        state_specs,
        (P(None, None, DATA_AXIS), P()),  # episode metrics; pmean'd losses
    )
    return build_learner(
        learner,
        mesh,
        in_specs=(state_specs,),
        out_specs=out_specs,
        donate=cfg.arch.get("donate_buffers", False),
    )


def run_experiment(cfg: Config) -> float:
    cfg = copy.deepcopy(cfg)
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg = check_total_timesteps(cfg)

    steps_per_rollout = int(cfg.system.total_timesteps // cfg.arch.num_evaluation)
    anakin_act_steps = n_devices * cfg.arch.num_envs * cfg.system.rollout_length
    cfg.system.scan_steps = max(1, int(steps_per_rollout / anakin_act_steps))

    (env, eval_env), q_net, opt, rb, learner_state, key = init(cfg, mesh)

    # Exact-state resume: restore the WHOLE learner state (params, optimizer,
    # trajectory buffer, env/hidden states, counters) and train the remaining
    # budget; the checkpoint's step key gives the already-consumed env steps.
    resumed_t = 0
    if cfg.logger.checkpointing.get("load_full_state", False):
        loader = Checkpointer(
            model_name=cfg.logger.system_name,
            **cfg.logger.checkpointing.load_args,
        )
        template = multihost_safe_state(learner_state)
        restored = loader.restore_full_state(template)
        resumed_t = int(loader._manager.latest_step())
        learner_state = jax.tree.map(
            lambda t_, x: jax.device_put(x, t_.sharding), learner_state, restored
        )
        loader.close()

    # Build the spec template from a single-shard buffer state structure.
    update = build_learn_fn(
        cfg, env, q_net, opt, rb, mesh, learner_state.buffer_state
    )

    logger = MavaLogger(cfg)

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

    evaluator = get_eval_fn(eval_env, eval_act_fn, cfg, mesh, absolute_metric=False)

    if cfg.logger.checkpointing.save_model:
        checkpointer = Checkpointer(
            metadata=cfg.to_dict(),
            model_name=cfg.logger.system_name,
            **cfg.logger.checkpointing.save_args,
        )

    eval_batch_size = get_num_eval_envs(cfg, absolute_metric=False)
    eval_hs = ScannedRNN.initialize_carry(
        (eval_batch_size, cfg.system.num_agents), cfg.network.hidden_state_dim
    )

    max_episode_return = -jnp.inf
    best_params = None
    assert resumed_t + steps_per_rollout <= cfg.system.total_timesteps, (
        f"resumed at env-step {resumed_t} with total_timesteps="
        f"{int(cfg.system.total_timesteps)} — nothing left to train; raise "
        "system.total_timesteps to extend the run"
    )
    for eval_idx, t in enumerate(
        range(
            resumed_t + steps_per_rollout,
            int(cfg.system.total_timesteps + 1),
            steps_per_rollout,
        )
    ):
        timer = PhaseTimer()
        start_time = time.time()
        with maybe_trace(cfg, eval_idx), timer.phase("learn"):
            learner_state, (metrics, losses) = update(learner_state)
            jax.block_until_ready(learner_state)

        elapsed_time = time.time() - start_time
        eps = jnp.maximum(
            cfg.system.eps_min,
            1 - (t / cfg.system.eps_decay) * (1 - cfg.system.eps_min),
        )
        final_metrics, ep_completed = get_final_step_metrics(metrics)
        final_metrics["steps_per_second"] = steps_per_rollout / elapsed_time

        if ep_completed:
            logger.log(final_metrics, t, eval_idx, LogEvent.ACT)
        # Q-divergence guardrail (same failure mode as SAC, BASELINE.md j200):
        # host-side check on the already-logged mean-Q magnitudes.
        warn_q_divergence(
            losses,
            float(cfg.system.get("q_divergence_warn_bound", 1e3)),
            cfg.logger.system_name,
        )
        logger.log(losses, t, eval_idx, LogEvent.TRAIN)

        key, eval_key = jax.random.split(key)
        eval_params = learner_state.params.online
        with timer.phase("eval"):
            eval_metrics = evaluator(eval_params, eval_key, {"hidden_state": eval_hs})
        logger.log(eval_metrics, t, eval_idx, LogEvent.EVAL)
        logger.log(
            {"timestep": t, "epsilon": eps, **timer.metrics()},
            t,
            eval_idx,
            LogEvent.MISC,
        )
        episode_return = jnp.mean(eval_metrics["episode_return"])

        if cfg.arch.absolute_metric and max_episode_return <= episode_return:
            best_params = jax.tree.map(lambda x: x.copy(), eval_params)
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
        eval_batch_size = get_num_eval_envs(cfg, absolute_metric=True)
        eval_hs = ScannedRNN.initialize_carry(
            (eval_batch_size, cfg.system.num_agents), cfg.network.hidden_state_dim
        )
        abs_metric_evaluator = get_eval_fn(
            eval_env, eval_act_fn, cfg, mesh, absolute_metric=True
        )
        key, eval_key = jax.random.split(key)
        eval_metrics = abs_metric_evaluator(
            best_params, eval_key, {"hidden_state": eval_hs}
        )
        logger.log(eval_metrics, t, eval_idx, LogEvent.ABSOLUTE)

    logger.stop()
    return float(eval_performance)


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    cfg = load_config("default_rec_iql", sys.argv[1:])
    performance = run_experiment(cfg)
    print("IDQN experiment completed.")
    return performance


if __name__ == "__main__":
    main()
