"""rec-IPPO with a VMAPPED LEARNING-RATE SWEEP: N configs in ONE compiled program.

Recurrent counterpart of `ff_ippo_vmap_sweep.py` (see its docstring for the
swept-optimizer mechanism): the sweep axis rides the GRU hidden states too, so
a full SMAX lr study — rollout, chunked BPTT, per-lr evaluation — runs as one
compiled program. Entries share param-init and env seeds; entry-to-entry
differences are attributable to the lr alone.

Usage:
    python -m mava_jax.advanced_usage.rec_ippo_vmap_sweep \
        env=smax env/scenario=3s5z arch.num_envs=64 \
        '+system.sweep_lrs=[1e-4, 2.5e-4, 5e-4]'
"""

from __future__ import annotations

import sys

from mava_jax.advanced_usage import rec_ippo_vmap_seeds as _seeds
from mava_jax.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return _seeds.run_experiment(
        config, centralised_critic, sweep_lrs=parse_sweep_lrs(config)
    )


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
