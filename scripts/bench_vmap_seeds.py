"""Measure the vmap-seeds claim: N seeds in one compiled program vs N sequential runs.

Times the stock single-seed ff-IPPO learn call and the S-seed vmapped call on the
SAME config (RWARE tiny-2ag, 128 envs/seed — the learning-validated operating
point), whole compiled programs in one process (CLAUDE.md timing rule). Reports
the wall-clock ratio and the effective speedup over running the seeds
sequentially. Hypothesis under test: the step is a long serial chain over small
batches, so seeds batch almost free until the device's capacity saturates.
Refuses to run without a GPU.

Usage: python scripts/bench_vmap_seeds.py [num_seeds ...]  (default: 2 4 8)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

NUM_ENVS = int(os.environ.get("BENCH_NUM_ENVS", 128))
ROLLOUT = int(os.environ.get("BENCH_ROLLOUT", 128))
UPDATES_PER_CALL = 4
TIMED_CALLS = int(os.environ.get("BENCH_TIMED_CALLS", 5))
OVERRIDES = [
    "env=rware",
    "env/scenario=tiny-2ag",
    f"arch.num_envs={NUM_ENVS}",
    f"system.rollout_length={ROLLOUT}",
    "logger.use_console=False",
]


def timeit(fn, state):
    out = fn(state)
    jax.block_until_ready(out)
    start = time.perf_counter()
    for _ in range(TIMED_CALLS):
        out = fn(out.learner_state)
    jax.block_until_ready(out)
    return (time.perf_counter() - start) / TIMED_CALLS


def main() -> None:
    from mava_jax import envs as environments
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds as vs
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo import ff_ippo
    from mava_jax.utils.config import load_config
    from mava_jax.utils.device import describe_devices, require_gpu

    print(describe_devices(require_gpu()), flush=True)
    seed_counts = [int(a) for a in sys.argv[1:]] or [2, 4, 8]

    cfg = load_config("default_ff_ippo", OVERRIDES)
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates = UPDATES_PER_CALL * (TIMED_CALLS + 1)
    cfg.system.num_updates_per_eval = UPDATES_PER_CALL
    env, _ = environments.make(cfg)

    steps_per_call = n_devices * UPDATES_PER_CALL * ROLLOUT * NUM_ENVS

    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    learn1, _, state1 = ff_ippo.learner_setup(env, tuple(keys), cfg, mesh)
    t1 = timeit(learn1, state1)
    print(
        json.dumps(
            {
                "config": "1 seed (stock)",
                "ms_per_call": round(t1 * 1e3, 2),
                "env_steps_per_second": round(steps_per_call / t1),
            }
        ),
        flush=True,
    )

    for num_seeds in seed_counts:
        learnS, _, stateS = vs.learner_setup(
            env, jax.random.PRNGKey(0), cfg, mesh, num_seeds
        )
        tS = timeit(learnS, stateS)
        print(
            json.dumps(
                {
                    "config": f"{num_seeds} seeds (vmap)",
                    "ms_per_call": round(tS * 1e3, 2),
                    "env_steps_per_second_all_seeds": round(
                        num_seeds * steps_per_call / tS
                    ),
                    "cost_vs_1_seed": round(tS / t1, 3),
                    "speedup_vs_sequential": round(num_seeds * t1 / tS, 2),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
