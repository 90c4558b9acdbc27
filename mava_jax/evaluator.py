"""Evaluator: fixed-length episode rollouts, metrics gathered at the first done step.

Capability parity with reference `mava/evaluator.py:48-209`, rebuilt on the mesh
runtime: instead of `jax.pmap(eval_fn)` the evaluation function is `shard_map`ped over
the data mesh — params replicated, per-shard RNG keys, per-shard vmapped envs — so the
same code evaluates on 1 chip or a pod slice. Episodes run a full `time_limit` scan
(static shape; XLA-friendly) and the metric for each env is read at the first done
index via argmax.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Callable, Dict, Protocol, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mava_jax.parallel import DATA_AXIS, num_learner_devices
from mava_jax.types import Metrics, PRNGKey, TimeStep

ActorState = Dict[str, Any]
EvalFn = Callable[[Any, PRNGKey, ActorState], Metrics]


class EvalActFn(Protocol):
    def __call__(
        self, params: Any, timestep: TimeStep, key: PRNGKey, actor_state: ActorState
    ) -> Tuple[jnp.ndarray, ActorState]: ...


def get_num_eval_envs(config, absolute_metric: bool) -> int:
    """Vmapped env count per device during eval (reference `evaluator.py:64-77`)."""
    n_devices = config.arch.n_devices
    n_parallel_envs = config.arch.num_envs * n_devices
    eval_episodes = (
        config.arch.num_absolute_metric_eval_episodes
        if absolute_metric
        else config.arch.num_eval_episodes
    )
    if eval_episodes <= n_parallel_envs:
        return math.ceil(eval_episodes / n_devices)
    return config.arch.num_envs


def get_eval_fn(
    env: Any, act_fn: EvalActFn, config, mesh: Mesh, absolute_metric: bool
) -> EvalFn:
    """Build a jitted, mesh-mapped evaluation function."""
    n_devices = num_learner_devices(mesh)
    eval_episodes = (
        config.arch.num_absolute_metric_eval_episodes
        if absolute_metric
        else config.arch.num_eval_episodes
    )
    n_vmapped_envs = get_num_eval_envs(config, absolute_metric)
    n_parallel_envs = n_vmapped_envs * n_devices
    episode_loops = math.ceil(eval_episodes / n_parallel_envs)
    log_win_rate = config.env.get("log_win_rate", False)

    if eval_episodes % n_parallel_envs != 0:
        warnings.warn(
            f"num eval episodes ({eval_episodes}) not divisible by parallel envs "
            f"({n_parallel_envs}); running {episode_loops * n_parallel_envs} episodes.",
            stacklevel=2,
        )

    def eval_shard(params: Any, key: PRNGKey, init_act_state: ActorState) -> Metrics:
        """Evaluation for one shard (one device's worth of envs)."""
        key = key[0]  # (1, 2) shard slice -> (2,)

        def _env_step(eval_state, _):
            env_state, ts, key, actor_state = eval_state
            key, act_key = jax.random.split(key)
            action, actor_state = act_fn(params, ts, act_key, actor_state)
            env_state, ts = jax.vmap(env.step)(env_state, action)
            return (env_state, ts, key, actor_state), ts

        def _episode(key, _):
            key, reset_key = jax.random.split(key)
            reset_keys = jax.random.split(reset_key, n_vmapped_envs)
            env_state, ts = jax.vmap(env.reset)(reset_keys)

            step_state = (env_state, ts, key, init_act_state)
            _, timesteps = jax.lax.scan(_env_step, step_state, length=env.time_limit)

            metrics = dict(timesteps.extras["episode_metrics"])
            if log_win_rate:
                metrics["won_episode"] = timesteps.extras["won_episode"]

            # First done step per env; episodes always terminate within time_limit.
            done_idx = jnp.argmax(timesteps.last(), axis=0)
            metrics = jax.tree.map(
                lambda m: m[done_idx, jnp.arange(n_vmapped_envs)], metrics
            )
            del metrics["is_terminal_step"]
            return key, metrics

        _, metrics = jax.lax.scan(_episode, key, xs=None, length=episode_loops)
        return jax.tree.map(lambda x: x.reshape(-1), metrics)  # (loops*envs,)

    mapped = jax.shard_map(
        eval_shard,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def timed_eval_fn(params: Any, key: PRNGKey, init_act_state: ActorState) -> Metrics:
        start_time = time.time()
        keys = jax.random.split(key, n_devices)
        metrics = jitted(params, keys, init_act_state)
        metrics = jax.block_until_ready(metrics)
        end_time = time.time()

        metrics = jax.tree.map(jnp.asarray, metrics)
        total_timesteps = jnp.sum(metrics["episode_length"])
        metrics["steps_per_second"] = total_timesteps / (end_time - start_time)
        return metrics

    return timed_eval_fn


def make_ff_eval_act_fn(actor_apply_fn: Callable, config) -> EvalActFn:
    """Greedy or sampling act selection for feedforward actors."""

    def eval_act_fn(params, timestep, key, actor_state):
        pi = actor_apply_fn(params, timestep.observation)
        action = pi.mode() if config.arch.evaluation_greedy else pi.sample(seed=key)
        return action, actor_state

    return eval_act_fn


def make_rec_eval_act_fn(actor_apply_fn: Callable, config) -> EvalActFn:
    """Recurrent variant: threads `hidden_state` through actor_state and feeds the
    network time-major slices of one step (reference `evaluator.py:189-209`)."""

    _hidden_state = "hidden_state"

    def eval_act_fn(params, timestep, key, actor_state):
        hidden_state = actor_state[_hidden_state]
        n_agents = timestep.observation.agents_view.shape[1]
        last_done = timestep.last()[:, jnp.newaxis].repeat(n_agents, axis=-1)
        ac_in = (timestep.observation, last_done)
        ac_in = jax.tree.map(lambda x: x[jnp.newaxis], ac_in)  # add time dim

        hidden_state, pi = actor_apply_fn(params, hidden_state, ac_in)
        action = pi.mode() if config.arch.evaluation_greedy else pi.sample(seed=key)
        return action.squeeze(0), {_hidden_state: hidden_state}

    return eval_act_fn
