"""Recurrent Multi-Agent PPO (rec-MAPPO): rec-IPPO + centralised recurrent critic.

Reference `mava/systems/ppo/rec_mappo.py` — diffs from rec_ippo are only
`centralised_critic=True` :470 and `add_global_state=True` :594.
"""

from __future__ import annotations

from mava_jax.systems.ppo import rec_ippo
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return rec_ippo.run_experiment(config, centralised_critic=True)


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    cfg = load_config("default_rec_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("Recurrent MAPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
