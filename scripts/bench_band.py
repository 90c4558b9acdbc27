"""Headline-bench jitter band: 3 in-process repeats of bench.py's measurement.

The official bench number is a single draw. This script compiles the headline
ff-IPPO program ONCE and repeats the 5-call timing loop three times in the same
process, printing min/median/max so a low draw of the single official number can
be read against the in-process band.

Prints the device (platform, device_kind, count, power limit) on one line, then
one JSON line: {"repeats": [...], "min": .., "median": .., "max": ..}. Refuses
to run without a GPU.
(bench.py itself is untouched and still prints its single driver line.)

Usage: python scripts/bench_band.py [repeats]
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

NUM_ENVS = 512
ROLLOUT_LENGTH = 128
UPDATES_PER_CALL = 4
TIMED_CALLS = 5


def main() -> None:
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo.ff_ippo import learner_setup
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
    # Enough updates for warmup + all repeats.
    cfg.system.num_updates = UPDATES_PER_CALL * (repeats * TIMED_CALLS + 1)
    cfg.system.num_updates_per_eval = UPDATES_PER_CALL

    env, _ = environments.make(cfg)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 3)
    learn, _, learner_state = learner_setup(env, tuple(keys), cfg, mesh)

    out = learn(learner_state)  # compile + warmup
    jax.block_until_ready(out)

    steps_per_call = n_devices * UPDATES_PER_CALL * ROLLOUT_LENGTH * NUM_ENVS
    band = []
    for r in range(repeats):
        start = time.perf_counter()
        for _ in range(TIMED_CALLS):
            out = learn(out.learner_state)
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - start
        sps_per_chip = TIMED_CALLS * steps_per_call / elapsed / n_devices
        band.append(round(sps_per_chip, 1))
        print(f"repeat {r}: {sps_per_chip:,.0f} env-steps/s/chip", flush=True)

    print(
        json.dumps(
            {
                "metric": "bench_band_ff_ippo_rware_tiny2ag",
                "repeats": band,
                "min": min(band),
                "median": statistics.median(band),
                "max": max(band),
                "unit": "env-steps/s/chip",
            }
        )
    )


if __name__ == "__main__":
    main()
