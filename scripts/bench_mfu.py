"""MFU / roofline accounting for the headline configs.

For each config: build the REAL compiled learner (learner_setup), pull XLA's own
cost model from the compiled executable (`compiled.cost_analysis()`: flops + bytes
accessed), time the whole fused step, and report

  env-steps/s/chip, model TFLOP/s achieved, its share of the card's published
  TF32 peak (float32 matmuls may run as TF32) and bf16 peak, arithmetic intensity
  (flops/byte) and the HBM-bandwidth-bound ceiling,

one JSON line per config, after a line naming the device. The peaks come from
`mava_jax/utils/device.py:PEAKS` (NVIDIA's data sheet), keyed by `device_kind`;
an unknown device is an error, and the script refuses to run without a GPU.

Usage: python scripts/bench_mfu.py [config ...]
Configs: ff_ippo_rware  rec_ippo_smax  ff_ippo_cleaner_cnn
         rec_iql_smax  ff_isac_maswarm   (off-policy rows)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

ROLLOUT = 128
UPDATES_PER_CALL = 4
TIMED_CALLS = 5

CONFIGS = {
    "ff_ippo_rware": (
        "default_ff_ippo",
        ["env=rware", "env/scenario=tiny-2ag", "arch.num_envs=512"],
    ),
    "rec_ippo_smax": (
        "default_rec_ippo",
        [
            "env=smax",
            "env/scenario=3s5z",
            "arch.num_envs=64",
            "system.recurrent_chunk_size=16",
        ],
    ),
    "ff_ippo_cleaner_cnn": (
        "default_ff_ippo",
        ["env=cleaner", "network=cnn", "arch.num_envs=128"],
    ),
    # Off-policy rows. These families fuse act+train in one step, so the
    # accounting covers the whole algorithm exactly like the PPO rows.
    "rec_iql_smax": (
        "default_rec_iql",
        ["env=smax", "env/scenario=2s3z", "arch.num_envs=64"],
    ),
    "ff_isac_maswarm": (
        "default_ff_isac",
        ["env=maswarm", "arch.num_envs=64"],
    ),
}


def _cost(compiled) -> dict:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):  # older jax: one dict per device
        ca = ca[0]
    return dict(ca or {})


OFFPOLICY_SCAN_STEPS = 32


def _build_ppo(default, overrides, mesh, n_devices):
    import importlib

    from mava_jax import envs as environments
    from mava_jax.utils.config import load_config

    module = importlib.import_module(
        "mava_jax.systems.ppo.rec_ippo" if "rec" in default else
        "mava_jax.systems.ppo.ff_ippo"
    )
    cfg = load_config(
        default,
        overrides + [f"system.rollout_length={ROLLOUT}", "logger.use_console=False"],
    )
    cfg.arch.n_devices = n_devices
    cfg.system.num_updates = UPDATES_PER_CALL * (TIMED_CALLS + 1)
    cfg.system.num_updates_per_eval = UPDATES_PER_CALL

    env, _ = environments.make(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    learn, _, state = module.learner_setup(env, tuple(keys), cfg, mesh, False)
    steps = n_devices * UPDATES_PER_CALL * ROLLOUT * cfg.arch.num_envs
    return learn, state, steps, lambda out: out.learner_state


def _build_rec_iql(overrides, mesh, n_devices):
    from mava_jax.systems.q_learning import rec_iql
    from mava_jax.utils.config import load_config

    cfg = load_config("default_rec_iql", overrides + ["logger.use_console=False"])
    cfg.arch.n_devices = n_devices
    cfg.system.scan_steps = OFFPOLICY_SCAN_STEPS
    (env, _), q_net, opt, rb, state, _ = rec_iql.init(cfg, mesh)
    update = rec_iql.build_learn_fn(cfg, env, q_net, opt, rb, mesh, state.buffer_state)
    steps = n_devices * OFFPOLICY_SCAN_STEPS * cfg.system.rollout_length * cfg.arch.num_envs
    return update, state, steps, lambda out: out[0]


def _build_ff_isac(overrides, mesh, n_devices):
    from mava_jax.systems.sac import ff_isac
    from mava_jax.utils.config import load_config
    from mava_jax.utils.timestep_checker import check_total_timesteps

    cfg = load_config("default_ff_isac", overrides + ["logger.use_console=False"])
    cfg.arch.n_devices = n_devices
    cfg = check_total_timesteps(cfg)
    cfg.system.scan_steps = OFFPOLICY_SCAN_STEPS

    explore, update, state = ff_isac.build_bench_learners(cfg, mesh)
    state, _ = explore(state)  # fill the buffer past min size before timing
    steps = n_devices * OFFPOLICY_SCAN_STEPS * cfg.system.rollout_length * cfg.arch.num_envs
    return update, state, steps, lambda out: out[0]


def bench_one(name: str, peak: dict) -> None:
    from mava_jax.parallel import make_mesh, num_learner_devices

    default, overrides = CONFIGS[name]
    mesh = make_mesh()
    n_devices = num_learner_devices(mesh)
    if default == "default_rec_iql":
        learn, learner_state, env_steps_per_call, next_state = _build_rec_iql(
            overrides, mesh, n_devices
        )
    elif default == "default_ff_isac":
        learn, learner_state, env_steps_per_call, next_state = _build_ff_isac(
            overrides, mesh, n_devices
        )
    else:
        learn, learner_state, env_steps_per_call, next_state = _build_ppo(
            default, overrides, mesh, n_devices
        )

    compiled = learn.lower(learner_state).compile()
    cost = _cost(compiled)

    out = compiled(learner_state)
    jax.block_until_ready(out)
    start = time.perf_counter()
    for _ in range(TIMED_CALLS):
        out = compiled(next_state(out))
    jax.block_until_ready(out)
    per_call = (time.perf_counter() - start) / TIMED_CALLS
    flops_per_call = float(cost.get("flops", 0.0))
    bytes_per_call = float(cost.get("bytes accessed", 0.0))

    achieved_flops = flops_per_call / per_call
    achieved_bw = bytes_per_call / per_call
    intensity = flops_per_call / bytes_per_call if bytes_per_call else 0.0
    # Roofline: with this arithmetic intensity the best achievable FLOP/s is
    # min(peak_flops, intensity * peak_bw); MFU relative to that ceiling shows how
    # close the program is to ITS roof (vs the absolute TF32 peak).
    roof = (
        min(peak["tf32_flops"], intensity * peak["hbm_bytes_per_s"]) if intensity else 0.0
    )

    print(
        json.dumps(
            {
                "config": name,
                "env_steps_per_second_per_chip": round(
                    env_steps_per_call / per_call / n_devices, 1
                ),
                "step_ms": round(per_call * 1e3, 2),
                "xla_flops_per_call": flops_per_call,
                "xla_bytes_per_call": bytes_per_call,
                "achieved_tflops": round(achieved_flops / 1e12, 4),
                "achieved_hbm_gbps": round(achieved_bw / 1e9, 1),
                "arithmetic_intensity_flops_per_byte": round(intensity, 2),
                "mfu_vs_tf32_peak": round(achieved_flops / peak["tf32_flops"], 5),
                "mfu_vs_bf16_peak": round(achieved_flops / peak["bf16_flops"], 5),
                "mfu_vs_roofline": round(achieved_flops / roof, 4) if roof else None,
                "hbm_utilisation": round(achieved_bw / peak["hbm_bytes_per_s"], 4),
            }
        ),
        flush=True,
    )


def main() -> None:
    from mava_jax.utils.device import describe_devices, peaks, require_gpu

    devices = require_gpu()
    print(describe_devices(devices), flush=True)
    peak = peaks(devices[0].device_kind)
    names = sys.argv[1:] or list(CONFIGS)
    for name in names:
        bench_one(name, peak)


if __name__ == "__main__":
    main()
