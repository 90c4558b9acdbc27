"""Run a system config across several seeds and print a result-per-seed table.

Usage:
  python scripts/run_seeds.py <module> <default> [seeds] [override ...]
  python scripts/run_seeds.py ppo.rec_ippo default_rec_ippo 42,7,123 \\
      env=smax env/scenario=3s5z network=rnn arch.num_envs=64 \\
      system.recurrent_chunk_size=16 system.total_timesteps=10000000

Each seed runs the full experiment (including the absolute metric when enabled) and
the script prints one line per seed plus mean/std — the artifact backing the
"matches the reference within seed variance" criterion (BASELINE.md).
"""

from __future__ import annotations

import importlib
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mava_jax.utils.config import load_config


def main() -> None:
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    module_name, default = sys.argv[1], sys.argv[2]
    try:
        seeds = [int(s) for s in sys.argv[3].split(",")]
        overrides = sys.argv[4:]
    except (IndexError, ValueError):
        # Seeds argument omitted — everything from argv[3] on is overrides.
        seeds = [42, 7, 123]
        overrides = sys.argv[3:]

    module = importlib.import_module(f"mava_jax.systems.{module_name}")
    results = []
    for seed in seeds:
        cfg = load_config(default, overrides + [f"system.seed={seed}"])
        perf = module.run_experiment(cfg)
        results.append(perf)
        print(f"seed={seed}: {cfg.env.eval_metric}={perf:.4f}", flush=True)

    mean = statistics.mean(results)
    std = statistics.stdev(results) if len(results) > 1 else 0.0
    print(f"mean={mean:.4f} std={std:.4f} over {len(results)} seeds", flush=True)


if __name__ == "__main__":
    main()
