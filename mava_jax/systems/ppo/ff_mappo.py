"""Feedforward Multi-Agent PPO (ff-MAPPO): CTDE with a centralised critic.

Identical to ff-IPPO except the critic consumes the global state and the env factory
attaches one (reference `mava/systems/ppo/ff_mappo.py`, whose only diffs from ff_ippo
are `Critic(centralised_critic=True)` :354 and `make(add_global_state=True)` :442).
"""

from __future__ import annotations

from mava_jax.systems.ppo import ff_ippo
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return ff_ippo.run_experiment(config, centralised_critic=True)


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    cfg = load_config("default_ff_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-MAPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
