"""ff-IPPO with a VMAPPED LEARNING-RATE SWEEP: N configs in ONE compiled program.

The vmap-seeds machinery (`ff_ippo_vmap_seeds.py`) batches independent *rng*
replicas on a leading vmap axis because the fused MARL step is latency-bound
and the extra batch rides almost free. This module sweeps a *hyperparameter*
on the same axis: the learning rate is moved out of the optimizer closure and
into optimizer STATE (`utils/training.py:scale_by_swept_lr` — the exact Adam
math of the stock `make_optimizer`, with the peak lr as a traced leaf), so
stacking opt_states with different peaks and vmapping the STOCK learner trains
N learning rates simultaneously. One compile, one program, a full lr study.

The reference tunes lr by launching separate processes per config (its sweep
story is external — neptune tags over repeated runs); there is no single-
program analogue. Here the sweep axis is just another batch dimension.

Entries share the SAME param-init and env seeds (config `system.seed`-derived,
identical across entries), so the sweep isolates the lr: entry-to-entry
differences are attributable to lr alone, not init noise. Combine with
`ff_ippo_vmap_seeds` (run the sweep at several `system.seed`s) for a grid.

Usage:
    python -m mava_jax.advanced_usage.ff_ippo_vmap_sweep \
        env=rware env/scenario=tiny-2ag arch.num_envs=128 \
        '+system.sweep_lrs=[1e-4, 2.5e-4, 5e-4, 1e-3]'

Equivalence is tested in tests/test_vmap_sweep.py: entry i of the batched
program matches the stock ff-IPPO learner run at `sweep_lrs[i]`.
"""

from __future__ import annotations

import sys
from typing import List

from mava_jax.advanced_usage import ff_ippo_vmap_seeds as _seeds
from mava_jax.utils.config import Config, load_config


def parse_sweep_lrs(config: Config) -> List[float]:
    """`system.sweep_lrs` as floats — accepts a YAML list or a comma string
    (yaml parses bare `1e-4` as a string, so coerce each element)."""
    raw = config.system.get("sweep_lrs", [1e-4, 2.5e-4, 5e-4, 1e-3])
    if isinstance(raw, str):
        raw = raw.strip("[]").split(",")
    return [float(x) for x in raw]


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return _seeds.run_experiment(
        config, centralised_critic, sweep_lrs=parse_sweep_lrs(config)
    )


def main() -> float:
    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-IPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
