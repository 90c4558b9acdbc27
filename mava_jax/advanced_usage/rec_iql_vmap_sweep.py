"""rec-IQL with a VMAPPED LEARNING-RATE SWEEP: N Q-learners in ONE program.

Q-learning counterpart of `ff_ippo_vmap_sweep.py`: entry i trains with
`q_lr = sweep_lrs[i]`, baked into optimizer state by the swept-Adam init
(`utils/training.py:make_swept_adam`, eps=1e-5 like the stock optimizer).
Entries share the SAME seed — per-entry trajectory buffers diverge only
through the lr's effect on the greedy policy. Replay memory scales as
`len(sweep_lrs) * buffer_size`.

Usage:
    python -m mava_jax.advanced_usage.rec_iql_vmap_sweep \
        env=smax env/scenario=2s3z '+system.sweep_lrs=[1e-4, 3e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_jax.advanced_usage import rec_iql_vmap_seeds as _seeds
from mava_jax.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return _seeds.run_experiment(config, sweep_lrs=parse_sweep_lrs(config))


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_iql", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IQL vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
