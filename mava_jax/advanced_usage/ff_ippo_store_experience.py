"""ff-IPPO with experience recording for offline MARL.

Capability parity with reference `mava/advanced_usage/ff_ippo_store_experience.py`:
the learner additionally returns the raw `PPOTransition` batch of every update; the
host reshapes it to (batch, time, ...) slabs and appends them to a `Vault` on disk
(the OG-MARL offline-dataset pattern). Built by reusing ff-IPPO's learner with
`return_trajectories=True` instead of duplicating the system file.
"""

from __future__ import annotations

import copy
import time
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mava_jax import envs as environments
from mava_jax.parallel import (
    DATA_AXIS,
    build_learner,
    make_mesh,
    num_learner_devices,
)
from mava_jax.replay import Vault
from mava_jax.systems.ppo import ff_ippo
from mava_jax.systems.ppo.types import LearnerState
from mava_jax.types import ExperimentOutput
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.profiling import PhaseTimer, maybe_trace
from mava_jax.utils.timestep_checker import check_total_timesteps
from mava_jax.envs.wrappers import get_final_step_metrics


def run_experiment(_config: Config) -> float:
    config = copy.deepcopy(_config)
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    config.arch.n_devices = n_devices

    env, eval_env = environments.make(config)
    key, key_e, actor_net_key, critic_net_key = jax.random.split(
        jax.random.PRNGKey(config.system.seed), num=4
    )

    # Standard ff-IPPO setup, then rebuild the learner with trajectory output.
    _, actor_network, learner_state = ff_ippo.learner_setup(
        env, (key, actor_net_key, critic_net_key), config, mesh
    )

    from mava_jax.networks import FeedForwardValueNet as Critic
    from mava_jax.networks.factory import make_torso
    from mava_jax.utils.training import make_learning_rate, make_optimizer

    critic_network = Critic(
        torso=make_torso(config.network.critic_network.pre_torso)
    )
    actor_optim = make_optimizer(
        make_learning_rate(config.system.actor_lr, config), config.system.max_grad_norm
    )
    critic_optim = make_optimizer(
        make_learning_rate(config.system.critic_lr, config), config.system.max_grad_norm
    )
    learner = ff_ippo.get_learner_fn(
        env,
        (actor_network.apply, critic_network.apply),
        (actor_optim.update, critic_optim.update),
        config,
        return_trajectories=True,
    )
    state_specs = LearnerState(
        params=P(), opt_states=P(), key=P(DATA_AXIS),
        env_state=P(DATA_AXIS), timestep=P(DATA_AXIS),
    )
    out_specs = (
        ExperimentOutput(
            learner_state=state_specs,
            episode_metrics=P(None, None, DATA_AXIS),
            train_metrics=P(),
        ),
        P(None, None, DATA_AXIS),  # trajectories: (NU, T, E_global, ...)
    )
    learn = build_learner(learner, mesh, in_specs=(state_specs,), out_specs=out_specs)

    config = check_total_timesteps(config)
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
    vault = Vault(vault_name=config.logger.system_name)

    for eval_step in range(config.arch.num_evaluation):
        timer = PhaseTimer()
        start_time = time.time()
        with maybe_trace(config, eval_step), timer.phase("learn"):
            learner_output, trajectories = learn(learner_state)
            jax.block_until_ready(learner_output)

        # (NU, T, E, ...) -> (E*NU, T, ...): batch-major slabs for the vault
        # (reference reshape `ff_ippo_store_experience.py:308-341`).
        with timer.phase("vault"):
            flat = jax.tree.map(
                lambda x: jnp.moveaxis(x, 2, 0).reshape(
                    x.shape[2] * x.shape[0], x.shape[1], *x.shape[3:]
                ),
                trajectories,
            )
            vault.write(jax.device_get(flat))

        elapsed_time = time.time() - start_time
        t = int(steps_per_rollout * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(
            learner_output.episode_metrics
        )
        episode_metrics["steps_per_second"] = steps_per_rollout / elapsed_time
        logger.log({"timestep": t, **timer.metrics()}, t, eval_step, LogEvent.MISC)
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(learner_output.train_metrics, t, eval_step, LogEvent.TRAIN)

        learner_state = learner_output.learner_state

    logger.stop()
    print(f"Experience stored in {vault.base_dir}")
    return float(
        jnp.mean(learner_output.episode_metrics["episode_return"])
    )


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    cfg = load_config("default_ff_ippo", sys.argv[1:])
    cfg.logger.system_name = "ff_ippo_store_experience"
    performance = run_experiment(cfg)
    print("ff-IPPO experience-recording run completed.")
    return performance


if __name__ == "__main__":
    main()
