"""ff-MASAC with a vmapped learning-rate sweep: the CTDE delta over
`ff_isac_vmap_sweep` (one parameter — the centralised joint-action critic
threads through the sweep axis unchanged)."""

from __future__ import annotations

import sys

from mava_jax.advanced_usage.ff_isac_vmap_sweep import run_experiment
from mava_jax.utils.config import load_config


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_masac", sys.argv[1:])
    performance = run_experiment(cfg, centralised_critic=True)
    print("ff-MASAC vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
