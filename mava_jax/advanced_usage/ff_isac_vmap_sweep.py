"""ff-ISAC with a VMAPPED LEARNING-RATE SWEEP: N SAC configs in ONE program.

Off-policy counterpart of `ff_ippo_vmap_sweep.py`: entry i trains with
`policy_lr = q_lr = sweep_lrs[i]` (alpha's lr stays at the config value). The
lr is baked into optimizer STATE by the swept-Adam init
(`utils/training.py:make_swept_adam` — math-identical to the stock clipped
Adam), so stacking the per-entry stock init states and vmapping the stock
explore/update fns sweeps the lr on the batch axis. Entries share the SAME
seed: per-entry replay buffers diverge only through the lr's effect on the
policy. Replay memory scales as `len(sweep_lrs) * buffer_size`.

Usage:
    python -m mava_jax.advanced_usage.ff_isac_vmap_sweep \
        env=mahopper system.total_timesteps=300000 \
        '+system.sweep_lrs=[1e-4, 3e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_jax.advanced_usage import ff_isac_vmap_seeds as _seeds
from mava_jax.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs
from mava_jax.utils.config import Config, load_config


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return _seeds.run_experiment(
        config, centralised_critic, sweep_lrs=parse_sweep_lrs(config)
    )


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_isac", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-ISAC vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
