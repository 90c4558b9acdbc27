"""Throughput benchmark: env-steps/s/chip for ff-IPPO on RWARE tiny-2ag.

Prints the device (platform, device_kind, count, power limit) on one line, then ONE
JSON line: {"metric", "value", "unit", "vs_baseline"}. Refuses to run without a GPU.

Baseline normalisation: the reference claims ~an order of magnitude over EPyMARL on
RWARE with 16 vectorised envs (reference `README.md:80-104`; plots only, no numbers).
We take 700 env-steps/s as the EPyMARL-equivalent single-accelerator figure for
rware-tiny (Papoudakis et al. era torch stack) and the driver target of >=10x that
(BASELINE.md) as the baseline: vs_baseline = value / 7000.

The measured configuration: one device, a large vectorised env batch (512 envs per
device), the full fused train step (rollout + GAE + 4 PPO epochs), so "env-steps/s"
counts only real training env steps.
"""

from __future__ import annotations

import json
import time

import jax

EPYMARL_EQUIVALENT_SPS = 700.0
BASELINE_SPS = 10.0 * EPYMARL_EQUIVALENT_SPS

NUM_ENVS = 512
ROLLOUT_LENGTH = 128
UPDATES_PER_CALL = 4
TIMED_CALLS = 10
# The first executions after compile can read slow (allocator/autotune warm-up),
# so a couple of calls are executed and discarded before timing.
WARMUP_CALLS = 3


def main() -> None:
    from mava_jax.systems.ppo.ff_ippo import learner_setup
    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.utils.config import load_config
    from mava_jax.utils.device import describe_devices, require_gpu

    print(describe_devices(require_gpu()), flush=True)
    cfg = load_config(
        "default_ff_ippo",
        [
            f"arch.num_envs={NUM_ENVS}",
            f"system.rollout_length={ROLLOUT_LENGTH}",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates = UPDATES_PER_CALL * (TIMED_CALLS + WARMUP_CALLS)
    cfg.system.num_updates_per_eval = UPDATES_PER_CALL

    env, _ = environments.make(cfg)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 3)
    learn, _, learner_state = learner_setup(env, tuple(keys), cfg, mesh)

    # Warmup: compile + steady-state ramp (see WARMUP_CALLS note).
    out = learn(learner_state)
    for _ in range(WARMUP_CALLS - 1):
        out = learn(out.learner_state)
    jax.block_until_ready(out)

    steps_per_call = n_devices * UPDATES_PER_CALL * ROLLOUT_LENGTH * NUM_ENVS
    start = time.perf_counter()
    for _ in range(TIMED_CALLS):
        out = learn(out.learner_state)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - start

    sps = TIMED_CALLS * steps_per_call / elapsed
    sps_per_chip = sps / n_devices

    print(
        json.dumps(
            {
                "metric": "ff_ippo_rware_tiny2ag_env_steps_per_second_per_chip",
                "value": round(sps_per_chip, 1),
                "unit": "env-steps/s/chip",
                "vs_baseline": round(sps_per_chip / BASELINE_SPS, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
