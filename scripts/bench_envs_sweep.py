"""Throughput vs vectorized-env count — the reference's speed-plot protocol.

The reference's README speed section plots steps-per-second against the
number of vectorized envs (`docs/images/speed_results/mava_sps_results.png`,
RTX 3060). This measures the same curve for the ff-IPPO headline config on
the GPU: full training step, steady-state timing (3 warmups), one
process for all points. Refuses to run without a GPU. Writes a JSON line per point and (if matplotlib is
importable) a figure to results/plots/sps_vs_envs.png following the repo
chart conventions (scripts/plot_results.py).

Usage: python scripts/bench_envs_sweep.py [timed_calls]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from mava_jax import envs as environments
from mava_jax.parallel import make_mesh, num_learner_devices
from mava_jax.systems.ppo.ff_ippo import learner_setup
from mava_jax.utils.config import load_config

ENV_COUNTS = (16, 64, 256, 512, 1024, 2048)
ROLLOUT = 128
UPDATES_PER_CALL = 4
WARMUPS = 3


def bench_point(num_envs: int, n: int) -> float:
    cfg = load_config(
        "default_ff_ippo",
        [
            f"arch.num_envs={num_envs}",
            f"system.rollout_length={ROLLOUT}",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.num_updates = UPDATES_PER_CALL * (n + WARMUPS + 1)
    cfg.system.num_updates_per_eval = UPDATES_PER_CALL
    env, _ = environments.make(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    learn, _, state = learner_setup(env, tuple(keys), cfg, mesh)

    out = learn(state)
    for _ in range(WARMUPS):
        out = learn(out.learner_state)
    jax.block_until_ready(out.learner_state)
    start = time.perf_counter()
    for _ in range(n):
        out = learn(out.learner_state)
    jax.block_until_ready(out.learner_state)
    dt = (time.perf_counter() - start) / n
    return UPDATES_PER_CALL * ROLLOUT * num_envs / dt


def main():
    from mava_jax.utils.device import describe_devices, require_gpu

    devices = require_gpu()
    print(describe_devices(devices), flush=True)
    device_kind = devices[0].device_kind
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    points = []
    for num_envs in ENV_COUNTS:
        sps = bench_point(num_envs, n)
        points.append((num_envs, sps))
        print(
            json.dumps(
                {
                    "metric": "ff_ippo_sps_vs_envs",
                    "num_envs": num_envs,
                    "value": round(sps, 1),
                    "unit": "env-steps/s/chip",
                }
            ),
            flush=True,
        )

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4.5), dpi=120)
        xs, ys = zip(*points)
        ax.plot(xs, ys, color="#E8A33D", linewidth=2.25, marker="o")
        ax.set_xscale("log", base=2)
        ax.set_xticks(xs)
        ax.set_xticklabels([str(x) for x in xs])
        ax.set_xlabel("vectorized envs per chip")
        ax.set_ylabel("env-steps / s / chip")
        ax.set_title(f"ff-IPPO RWARE tiny-2ag — full training step ({device_kind})")
        ax.grid(True, color="#E3E1DC", linewidth=0.8)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        out_path = os.path.join("results", "plots", "sps_vs_envs.png")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        fig.tight_layout()
        fig.savefig(out_path)
        print(f"wrote {out_path}", flush=True)
    except Exception as e:  # plotting is best-effort
        print(f"plot skipped: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
