"""ff-MASAC with vmapped seeds: the CTDE delta over `ff_isac_vmap_seeds`.

Same one-parameter delta the stock systems use (`ff_masac.py` vs `ff_isac.py`):
the centralised joint-action critic threads through the seed axis unchanged.
"""

from __future__ import annotations

from mava_jax.advanced_usage.ff_isac_vmap_seeds import run_experiment
from mava_jax.utils.config import load_config


def main() -> float:
    import sys

    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_masac", sys.argv[1:])
    performance = run_experiment(cfg, centralised_critic=True)
    print("ff-MASAC vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
