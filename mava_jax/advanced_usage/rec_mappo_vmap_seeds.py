"""rec-MAPPO with vmapped seeds: N independent recurrent CTDE seeds in one program.

Same construction as `rec_ippo_vmap_seeds` with the centralised-critic delta
(see `systems/ppo/rec_mappo.py`).
"""

from __future__ import annotations

from mava_jax.advanced_usage import rec_ippo_vmap_seeds
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return rec_ippo_vmap_seeds.run_experiment(config, centralised_critic=True)


def main() -> float:
    import sys

    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-MAPPO vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
