"""Quickstart: train ff-IPPO to SOLVE Level-Based Foraging in one command.

The runnable counterpart of the reference's `examples/Quickstart.ipynb` (which
walks through building MAPPO on Jumanji RWARE cell by cell): here the same
journey is a guided tour of the framework's real modules, because every piece
the notebook hand-rolls already exists as a tested component:

* networks      -> `mava_jax/networks/` (torsos, heads, FeedForwardActor/ValueNet)
* learner       -> `mava_jax/systems/ppo/ff_ippo.py::get_learner_fn`
                   (rollout scan -> GAE -> minibatched PPO epochs, one compiled step)
* device layout -> `mava_jax/parallel/mesh.py` (data-sharded envs on a Mesh +
                   shard_map; several devices run the same program)
* evaluation    -> `mava_jax/evaluator.py` (greedy eval episodes, win/return table)
* config        -> `mava_jax/configs/` (composable yaml groups, CLI overrides)

Run it (defaults: LBF 2s-8x8-2p-2f-coop, 2M env steps, 10 evaluations — the
eval return climbs to near-perfect play, absolute 0.96 of the 1.0 maximum, in
the earlier rounds' learning runs recorded in BASELINE.md):

    python examples/quickstart.py

Every config knob is overridable hydra-style, e.g. a RWARE run on a harder
4-agent map:

    python examples/quickstart.py env=rware env/scenario=tiny-4ag \
        system.total_timesteps=5000000

The console prints an eval table as training progresses; the script returns
the final evaluation episode return.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mava_jax.parallel import distributed
from mava_jax.systems.ppo import ff_ippo
from mava_jax.utils.config import load_config

QUICKSTART_DEFAULTS = [
    "env=lbf",
    "env/scenario=2s-8x8-2p-2f-coop",
    "system.total_timesteps=2000000",
    "arch.num_envs=128",
    "arch.num_evaluation=10",
    "logger.use_console=True",
]


def main() -> float:
    # Multi-host bootstrap first (no-op on a single host) — the quickstart is
    # the same program that runs on a pod slice.
    distributed.initialize()

    # CLI overrides are appended after the quickstart defaults, so anything can
    # be changed: algorithm knobs, env scenario, eval cadence ...
    cfg = load_config("default_ff_ippo", QUICKSTART_DEFAULTS + sys.argv[1:])

    print(
        f"Training ff-IPPO on {cfg.env.env_name} {cfg.env.scenario.task_name} "
        f"for {int(cfg.system.total_timesteps):,} env steps "
        f"({cfg.arch.num_envs} vectorised envs)...",
        flush=True,
    )
    final_eval_return = ff_ippo.run_experiment(cfg)
    print(f"Final evaluation episode return: {final_eval_return:.2f}", flush=True)
    return final_eval_return


if __name__ == "__main__":
    main()
