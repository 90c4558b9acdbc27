"""Feedforward Multi-Agent SAC (ff-MASAC): ISAC + centralised twin critics over the
global state and joint actions (reference `mava/systems/sac/ff_masac.py`)."""

from __future__ import annotations

from mava_jax.systems.sac import ff_isac
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return ff_isac.run_experiment(config, centralised_critic=True)


def main() -> float:
    import sys

    # Multi-process bootstrap (no-op off a pod slice) — must precede any
    # backend-touching jax call (SURVEY.md §2.7 multi-host row).
    from mava_jax.parallel import initialize

    initialize()

    cfg = load_config("default_ff_masac", sys.argv[1:])
    performance = run_experiment(cfg)
    print("MASAC experiment completed.")
    return performance


if __name__ == "__main__":
    main()
