"""rec-MAPPO with a vmapped learning-rate sweep: N recurrent CTDE configs in
one compiled program (see `rec_ippo_vmap_sweep` / `ff_ippo_vmap_sweep` for the
swept-optimizer mechanism; the CTDE delta is one parameter)."""

from __future__ import annotations

import sys

from mava_jax.advanced_usage import rec_ippo_vmap_sweep
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return rec_ippo_vmap_sweep.run_experiment(config, centralised_critic=True)


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-MAPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
