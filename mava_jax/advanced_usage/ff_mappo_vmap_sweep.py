"""ff-MAPPO with a vmapped learning-rate sweep: N CTDE configs in one program.

Same construction as `ff_ippo_vmap_sweep` with the centralised-critic delta —
which, as everywhere in this framework, is one parameter (see
`systems/ppo/ff_mappo.py`; reference contrast: a 569-line near-copy).
"""

from __future__ import annotations

import sys

from mava_jax.advanced_usage import ff_ippo_vmap_sweep
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return ff_ippo_vmap_sweep.run_experiment(config, centralised_critic=True)


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-MAPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
