"""Multi-config throughput suite. One JSON line per config, after a line naming
the device (platform, device_kind, count, power limit). Refuses to run without a GPU.

Usage: python scripts/bench_suite.py [config ...]
Configs: ff_ippo_rware  ff_mappo_rware4  ff_mappo_lbf  rec_ippo_smax  rec_mappo_smax
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

CONFIGS = {
    "ff_ippo_rware": (
        "default_ff_ippo",
        "mava_jax.systems.ppo.ff_ippo",
        ["env=rware", "env/scenario=tiny-2ag", "arch.num_envs=256"],
        dict(centralised_critic=False),
    ),
    "ff_mappo_rware4": (
        "default_ff_mappo",
        "mava_jax.systems.ppo.ff_ippo",
        ["env=rware", "env/scenario=tiny-4ag", "arch.num_envs=256"],
        dict(centralised_critic=True),
    ),
    "ff_mappo_lbf": (
        "default_ff_mappo",
        "mava_jax.systems.ppo.ff_ippo",
        ["env=lbf", "env/scenario=8x8-2p-2f-coop", "arch.num_envs=256"],
        dict(centralised_critic=True),
    ),
    "rec_ippo_smax": (
        "default_rec_ippo",
        "mava_jax.systems.ppo.rec_ippo",
        [
            "env=smax",
            "env/scenario=3s5z",
            "network=rnn",
            "arch.num_envs=64",
            "system.recurrent_chunk_size=16",
        ],
        dict(centralised_critic=False),
    ),
    "rec_mappo_smax": (
        "default_rec_mappo",
        "mava_jax.systems.ppo.rec_ippo",
        [
            "env=smax",
            "env/scenario=3s5z",
            "network=rnn",
            "arch.num_envs=64",
            "system.recurrent_chunk_size=16",
        ],
        dict(centralised_critic=True),
    ),
}

ROLLOUT = 128
UPDATES_PER_CALL = 4
TIMED_CALLS = 3


def bench_one(name: str) -> None:
    import importlib

    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.utils.config import load_config

    default, module_name, overrides, kwargs = CONFIGS[name]
    module = importlib.import_module(module_name)

    cfg = load_config(
        default,
        overrides + [f"system.rollout_length={ROLLOUT}", "logger.use_console=False"],
    )
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates = UPDATES_PER_CALL * (TIMED_CALLS + 4)
    cfg.system.num_updates_per_eval = UPDATES_PER_CALL

    env, _ = environments.make(
        cfg, add_global_state=kwargs.get("centralised_critic", False)
    )
    key = jax.random.PRNGKey(0)

    keys = jax.random.split(key, 3)
    learn, _, learner_state = module.learner_setup(
        env, tuple(keys), cfg, mesh, kwargs["centralised_critic"]
    )

    out = learn(learner_state)
    # Steady state needs a few post-compile warmup calls (allocator/autotune).
    for _ in range(3):
        out = learn(out.learner_state)
    jax.block_until_ready(out)

    num_envs = cfg.arch.num_envs
    steps_per_call = n_devices * UPDATES_PER_CALL * ROLLOUT * num_envs
    start = time.perf_counter()
    for _ in range(TIMED_CALLS):
        out = learn(out.learner_state)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - start

    sps_per_chip = TIMED_CALLS * steps_per_call / elapsed / n_devices
    print(
        json.dumps(
            {
                "metric": f"{name}_env_steps_per_second_per_chip",
                "value": round(sps_per_chip, 1),
                "unit": "env-steps/s/chip",
            }
        ),
        flush=True,
    )


def main() -> None:
    from mava_jax.utils.device import describe_devices, require_gpu

    print(describe_devices(require_gpu()), flush=True)
    names = sys.argv[1:] or list(CONFIGS)
    for name in names:
        bench_one(name)


if __name__ == "__main__":
    main()
