"""Bring-up smoke test of the training path on an NVIDIA GPU.

    python chip_smoke.py              # one GPU: every phase below, in one process
    python chip_smoke.py --four-gpu   # four GPUs: only the data-parallel phase

Phases (one GPU):
  ff_ippo       ff-IPPO, RWARE tiny-2ag, 512 envs x 128-step rollouts, through
                `run_experiment` with evaluation on: finite losses, env steps advance.
  rec_ippo      rec-IPPO, SMAX 3s5z, 64 envs, GRU 128, BPTT chunks of 16, the same.
  donation      one ff-IPPO run with `arch.donate_buffers=True`.
  vmap_seeds    a 2-seed `ff_ippo_vmap_seeds` run with the associative-scan GAE.
  gru_trace     a profiler trace of one rec-IPPO learn call: the GRU's device time
                (ops under the `gru_scan` name scope) and its share of the call.
  gru_precision the hoisted GRU scan against the per-step `cell` reference at
                512 rows x H=128 x T=128, forward and gradients, on the GPU at
                default precision, on the GPU at "highest", and on the CPU.
  ff_precision  the first ff-IPPO learn call from one seed, GPU against CPU, both
                at "highest": loss metrics and the global gradient norm.

With --four-gpu: the ff-IPPO and rec-IPPO learners on a 4-GPU `data` mesh at the
per-device sizes above; params must be identical on all four cards after an
update, the state must be spread over all four, and the first learn call's loss
metrics must match the same 4-shard program on 4 virtual CPU devices.

Compile times are printed as set-up time, with `compiled.memory_analysis()` for
each learner step. The last line of stdout is one JSON object; it is printed
only when every phase passed, and the script exits non-zero otherwise (also when
JAX finds no GPU).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import sys
import time

# Four virtual CPU devices for the CPU side of the four-GPU comparison. Must be
# set before JAX initialises its backends; it affects only the host platform.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mava_jax.utils.device import card_info, require_gpu  # noqa: E402

# The CPU references run in this process, so keep the CPU backend available
# next to the GPU when JAX_PLATFORMS names only the GPU.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    jax.config.update("jax_platforms", _platforms + ",cpu")

OUT_DIR = os.path.join("results", "chip_smoke")
COMMON = [
    "logger.use_console=False",
    "arch.num_eval_episodes=32",
    "arch.absolute_metric=False",
]
FF_IPPO = COMMON + [
    "env=rware",
    "env/scenario=tiny-2ag",
    "arch.num_envs=512",
    "system.rollout_length=128",
]
REC_IPPO = COMMON + [
    "env=smax",
    "env/scenario=3s5z",
    "network.hidden_state_dim=128",
    "arch.num_envs=64",
    "system.rollout_length=128",
    "system.recurrent_chunk_size=16",
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, across all leaves of two pytrees."""
    diff = scale = 0.0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        diff = max(diff, float(np.max(np.abs(g - w))))
        scale = max(scale, float(np.max(np.abs(w))))
    return diff / max(scale, 1e-30)


def log(phase: str, message: str) -> None:
    print(f"[{phase}] {message}", flush=True)


@contextlib.contextmanager
def record_logs():
    """Capture what the systems hand to their logger, as (event, metrics)."""
    from mava_jax.utils import logger as logger_mod

    records = []
    original = logger_mod.MavaLogger.log

    def tee(self, metrics, t, t_eval, event):
        records.append((event.name, jax.device_get(metrics), t))
        return original(self, metrics, t, t_eval, event)

    logger_mod.MavaLogger.log = tee
    try:
        yield records
    finally:
        logger_mod.MavaLogger.log = original


def check_training(phase: str, records, n_calls: int) -> None:
    train = [m for event, m, _ in records if event == "TRAIN"]
    steps = [t for event, _, t in records if event == "TRAIN"]
    check(len(train) == n_calls, f"{phase}: {len(train)} learn calls logged, want {n_calls}")
    for metrics in train:
        for name, value in metrics.items():
            check(np.all(np.isfinite(value)), f"{phase}: non-finite {name}")
    check(
        all(b > a for a, b in zip([0] + steps, steps)),
        f"{phase}: env-step counter did not advance: {steps}",
    )
    last = {k: float(np.mean(v)) for k, v in train[-1].items()}
    log(phase, f"env steps after each learn call: {steps}; last losses: {last}")


def build(system: str, overrides, mesh=None, extra=None):
    """The learner a system's `run_experiment` builds: -> (learn, state, config)."""
    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo import ff_ippo, rec_ippo
    from mava_jax.utils.config import load_config
    from mava_jax.utils.timestep_checker import check_total_timesteps

    module = {"ff_ippo": ff_ippo, "rec_ippo": rec_ippo}[system]
    config = load_config(f"default_{system}", list(overrides) + list(extra or []))
    mesh = mesh if mesh is not None else make_mesh()
    config.arch.n_devices = num_learner_devices(mesh)
    if system == "rec_ippo" and config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length
    env, _ = environments.make(config)
    key, _, actor_key, critic_key = jax.random.split(
        jax.random.PRNGKey(config.system.seed), num=4
    )
    config = check_total_timesteps(config)
    config.system.num_updates_per_eval = (
        config.system.num_updates // config.arch.num_evaluation
    )
    learn, _, state = module.learner_setup(
        env, (key, actor_key, critic_key), config, mesh
    )
    return learn, state, config


def compile_step(phase: str, learn, state):
    start = time.perf_counter()
    compiled = learn.lower(state).compile()
    log(phase, f"set-up: learner step compiled in {time.perf_counter() - start:.1f} s")
    mem = compiled.memory_analysis()
    fields = (
        "argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
    )
    log(phase, "memory_analysis: " + ", ".join(
        f"{f}={getattr(mem, f, 'n/a')}" for f in fields
    ))
    return compiled


def run_system(phase: str, module, config_name: str, overrides, n_calls: int) -> None:
    """`module.run_experiment` on the composed config, checked through its logs."""
    from mava_jax.utils.config import load_config

    config = load_config(config_name, overrides)
    start = time.perf_counter()
    with record_logs() as records:
        performance = module.run_experiment(config)
    log(phase, f"run_experiment: {n_calls} learn calls + evals in "
        f"{time.perf_counter() - start:.1f} s (compile included), eval metric "
        f"{performance:.4f}")
    check(np.isfinite(performance), f"{phase}: non-finite eval metric")
    check_training(phase, records, n_calls)


def phase_train(system: str, overrides) -> None:
    from mava_jax.systems.ppo import ff_ippo, rec_ippo

    calls = ["system.num_updates=3", "arch.num_evaluation=3"]
    learn, state, _ = build(system, overrides, extra=calls)
    compile_step(system, learn, state)
    module = {"ff_ippo": ff_ippo, "rec_ippo": rec_ippo}[system]
    run_system(system, module, f"default_{system}", list(overrides) + calls, n_calls=3)


def phase_donation() -> None:
    from mava_jax.systems.ppo import ff_ippo

    run_system(
        "donation", ff_ippo, "default_ff_ippo",
        FF_IPPO + ["arch.donate_buffers=True", "system.num_updates=2",
                   "arch.num_evaluation=2"],
        n_calls=2,
    )


def phase_vmap_seeds() -> None:
    from mava_jax.advanced_usage import ff_ippo_vmap_seeds

    run_system(
        "vmap_seeds", ff_ippo_vmap_seeds, "default_ff_ippo",
        FF_IPPO + ["+system.num_seeds=2", "+system.gae_impl=assoc",
                   "system.num_updates=1", "arch.num_evaluation=1"],
        n_calls=1,
    )


_HLO_OP_RE = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]*)"')


def hlo_op_names(compiled) -> dict:
    """{HLO instruction name: its `op_name` metadata} from the optimized HLO.
    Kernels that XLA emits itself carry their fusion's instruction name in the
    trace, so this maps trace events back to the JAX name scopes they came from."""
    names = {}
    for line in compiled.as_text().splitlines():
        match = _HLO_OP_RE.match(line)
        if match:
            # Kernel names spell the instruction's '.' and '-' as '_'.
            kernel = re.sub(r"[.\-]", "_", match.group(1))
            names[match.group(1)] = names[kernel] = match.group(2)
    return names


def trace_device_time(trace_dir: str, op_names: dict, scope: str,
                      plane_prefix: str = "/device:GPU:0"):
    """Reduce the newest `.xplane.pb` under `trace_dir` to (device busy ns over
    the kernel (stream) lines, ns of kernels whose HLO op_name is under `scope`,
    {kernel name: ns} of kernels with no HLO instruction of that name)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    check(bool(paths), f"no trace written under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    intervals, scoped, unmapped = [], 0, {}
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for event in line.events:
                intervals.append((event.start_ns, event.start_ns + event.duration_ns))
                if event.name not in op_names:
                    unmapped[event.name] = unmapped.get(event.name, 0) + event.duration_ns
                elif scope in op_names[event.name]:
                    scoped += event.duration_ns
    intervals.sort()
    busy, end = 0.0, -1.0
    for start, stop in intervals:
        if start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy, scoped, unmapped


def _traced_busy(phase: str, name: str, fn, *args):
    """(device busy ns, compiled) of one traced call of jitted `fn` (warmed first)."""
    compiled = fn.lower(*args).compile()
    jax.block_until_ready(compiled(*args))
    trace_dir = os.path.join(OUT_DIR, f"trace_{name}")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(compiled(*args))
    busy, _, _ = trace_device_time(trace_dir, {}, "")
    check(busy > 0, f"{phase}: no device ops in the trace of {name}")
    return busy, compiled


def phase_gru_trace() -> None:
    """The GRU's device time in one rec-IPPO learn call, two ways: kernels of the
    traced step whose HLO op_name is under the `gru_scan` scope, and traced
    standalone GRU programs times the number of times the step runs each."""
    learn, state, config = build("rec_ippo", REC_IPPO, extra=["system.num_updates=1",
                                                             "arch.num_evaluation=1"])
    compiled = compile_step("gru_trace", learn, state)
    jax.block_until_ready(compiled(state))  # warm
    start = time.perf_counter()
    jax.block_until_ready(compiled(state))
    wall = time.perf_counter() - start
    trace_dir = os.path.join(OUT_DIR, "trace_rec_ippo")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(compiled(state))
    busy, gru, unmapped = trace_device_time(trace_dir, hlo_op_names(compiled), "gru_scan")
    check(busy > 0, "gru_trace: no device ops in the trace")
    top = sorted(unmapped.items(), key=lambda kv: -kv[1])[:5]
    log("gru_trace", (
        f"one rec-IPPO learn call (1 update, 64 envs x 128 steps x 8 agents, smoke "
        f"run): wall {wall * 1e3:.2f} ms untraced; device busy {busy / 1e6:.2f} ms "
        f"traced; kernels under gru_scan {gru / 1e6:.2f} ms = {100 * gru / busy:.1f}% "
        f"of busy; kernels with no HLO name {sum(unmapped.values()) / 1e6:.2f} ms "
        f"(top: {', '.join(f'{k[:40]} {v / 1e6:.2f} ms' for k, v in top)})"
    ))

    # Standalone: what the step's GRU calls cost, traced one program at a time.
    nets, fns = _gru_fns()
    rows = config.arch.num_envs * config.system.num_agents
    chunks = config.system.rollout_length // config.system.recurrent_chunk_size
    batch_rows = rows * chunks // config.system.num_minibatches
    params = None
    per_call = {}
    for label, steps, n_rows in (("bptt", config.system.recurrent_chunk_size, batch_rows),
                                 ("critic_pass", config.system.rollout_length, rows)):
        xs, resets, carry, probe = _gru_inputs(rows=n_rows, steps=steps)
        if params is None:
            params = nets["hoisted"].init(
                jax.random.PRNGKey(1), carry, (xs[:1], resets[:1])
            )
        fwd, grad = fns["hoisted"]
        fn = grad if label == "bptt" else fwd
        per_call[label], _ = _traced_busy("gru_trace", label, fn, params, carry, xs,
                                          resets, probe)
    # Per update: actor + critic BPTT fwd+bwd in every minibatch of every epoch,
    # one post-rollout critic pass over the whole rollout.
    n_bptt = 2 * config.system.ppo_epochs * config.system.num_minibatches
    estimate = n_bptt * per_call["bptt"] + per_call["critic_pass"]
    log("gru_trace", (
        f"standalone traced GRU programs: BPTT fwd+bwd T={config.system.recurrent_chunk_size} "
        f"rows={batch_rows} {per_call['bptt'] / 1e6:.3f} ms x {n_bptt} calls + critic "
        f"pass T={config.system.rollout_length} rows={rows} "
        f"{per_call['critic_pass'] / 1e6:.3f} ms = {estimate / 1e6:.2f} ms = "
        f"{100 * estimate / busy:.1f}% of the step's device busy (the rollout's "
        f"128 single-step actor GRU calls not counted)"
    ))


def _gru_inputs(rows=512, hidden=128, steps=128, features=128):
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    xs = jax.random.normal(keys[0], (steps, rows, features))
    resets = jax.random.bernoulli(keys[1], 0.02, (steps, rows))
    carry = 0.1 * jax.random.normal(keys[2], (rows, hidden))
    probe = jax.random.normal(keys[3], (rows, hidden))
    return xs, resets, carry, probe


def _gru_fns(hidden=128):
    from mava_jax.networks import ScannedRNN

    nets = {impl: ScannedRNN(hidden, gru_impl=impl) for impl in ("hoisted", "cell")}

    def make(impl):
        net = nets[impl]

        def loss(params, carry, xs, resets, probe):
            final, ys = net.apply(params, carry, (xs, resets))
            return jnp.sum(final * probe) + jnp.sum(ys * probe) / xs.shape[0]

        def fwd(params, carry, xs, resets, probe):
            return net.apply(params, carry, (xs, resets))

        return jax.jit(fwd), jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))

    return nets, {impl: make(impl) for impl in nets}


def _timed(fn, *args, reps=20) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return float(np.median(times))


def phase_gru_precision() -> None:
    nets, fns = _gru_fns()
    cpu = jax.devices("cpu")[0]
    xs, resets, carry, probe = _gru_inputs()
    params = nets["hoisted"].init(jax.random.PRNGKey(1), carry, (xs[:1], resets[:1]))
    args = (params, carry, xs, resets, probe)

    def run(impl, device, precision):
        with jax.default_device(device), jax.default_matmul_precision(precision):
            local = jax.device_put(args, device)
            fwd, grad = fns[impl]
            return jax.device_get((fwd(*local), grad(*local)))

    gpu = jax.devices()[0]
    ref = run("cell", cpu, "highest")
    results = {
        "gpu default": run("hoisted", gpu, "default"),
        "gpu highest": run("hoisted", gpu, "highest"),
        "cpu": run("hoisted", cpu, "highest"),
    }
    limits = {"gpu default": 1e-2, "gpu highest": 1e-5, "cpu": 1e-5}
    for name, (out, grads) in results.items():
        e_fwd, e_grad = rel_err(out, ref[0]), rel_err(grads, ref[1])
        log("gru_precision", (
            f"hoisted ({name}) vs cell (cpu, highest), 512 rows x H=128 x T=128: "
            f"forward rel err {e_fwd:.3e}, gradient rel err {e_grad:.3e} "
            f"(limit {limits[name]:g})"
        ))
        check(max(e_fwd, e_grad) <= limits[name], f"gru_precision: {name} out of tolerance")
    tf32 = rel_err(results["gpu default"], results["gpu highest"])
    log("gru_precision", (
        f"gpu default vs gpu highest rel err {tf32:.3e}: float32 matmuls "
        f"{'ran in TF32' if tf32 > 1e-5 else 'kept float32'} at default precision"
    ))

    # The scan's time on the card at the rollout's and the BPTT's shapes.
    for steps, rows in ((128, 512), (16, 2048)):
        xs_s, resets_s, carry_s, probe_s = _gru_inputs(rows=rows, steps=steps)
        targs = (params, carry_s, xs_s, resets_s, probe_s)
        for impl in ("hoisted", "cell"):
            fwd, grad = fns[impl]
            t_fwd, t_grad = _timed(fwd, *targs), _timed(grad, *targs)
            log("gru_precision", (
                f"smoke timing, {impl} GRU T={steps} rows={rows} H=128: forward "
                f"{t_fwd * 1e3:.3f} ms, forward+backward {t_grad * 1e3:.3f} ms "
                f"(host clock, median of 20)"
            ))


def _compare_first_call(phase: str, system: str, overrides, gpus, cpus, tol=1e-4):
    """One learn call of the same n-shard program on `gpus` and on `cpus`, both
    at "highest" and from the same initial state; compare the loss metrics.
    The first minibatch's are held to `tol` relative to the metric's largest
    magnitude in the call (they see the same rollout and the same params; only
    summation order differs); the other minibatches' differences are printed."""
    from mava_jax.parallel import make_mesh

    one_call = ["system.num_updates=1", "arch.num_evaluation=1"]
    with jax.default_matmul_precision("highest"):
        learn_c, state_c, _ = build(system, overrides, make_mesh(cpus), one_call)
        learn_g, state_g, _ = build(system, overrides, make_mesh(gpus), one_call)
        # Start the GPU run from the CPU run's exact initial state.
        host = jax.device_get(state_c)
        state_g = jax.tree.map(lambda g, h: jax.device_put(h, g.sharding), state_g, host)
        out_g = compile_step(phase, learn_g, state_g)(state_g)
        out_c = learn_c(state_c)
        metrics_g, metrics_c = jax.device_get((out_g.train_metrics, out_c.train_metrics))
    for name in sorted(metrics_c):
        got, want = metrics_g[name].reshape(-1), metrics_c[name].reshape(-1)
        scale = max(float(np.max(np.abs(want))), 1e-30)
        first = abs(float(got[0]) - float(want[0])) / scale
        whole = rel_err(got, want)
        log(phase, (
            f"{name}: first minibatch gpu {float(metrics_g[name].reshape(-1)[0]):.6e} "
            f"cpu {float(metrics_c[name].reshape(-1)[0]):.6e} rel err {first:.3e} "
            f"(limit {tol:g}); all minibatches rel err {whole:.3e}"
        ))
        check(first <= tol, f"{phase}: {name} differs by {first:.3e} > {tol:g}")
    return out_g


def phase_ff_precision() -> None:
    _compare_first_call(
        "ff_precision", "ff_ippo",
        [o for o in FF_IPPO if not o.startswith("arch.num_envs")] + ["arch.num_envs=64"],
        jax.devices()[:1], jax.devices("cpu")[:1],
    )


def phase_four_gpu() -> None:
    gpus = jax.devices()[:4]
    check(len(gpus) == 4, f"--four-gpu needs 4 GPUs, found {len(jax.devices())}")
    cpus = jax.devices("cpu")[:4]
    check(len(cpus) == 4, "--four-gpu needs 4 virtual CPU devices")
    for system, overrides in (("ff_ippo", FF_IPPO), ("rec_ippo", REC_IPPO)):
        phase = f"four_gpu/{system}"
        out = _compare_first_call(phase, system, overrides, gpus, cpus)
        state = out.learner_state
        for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            shards = [np.asarray(s.data) for s in leaf.addressable_shards]
            check(len(shards) == 4, f"{phase}: params leaf {path} on {len(shards)} devices")
            check(
                all(np.array_equal(shards[0], s) for s in shards[1:]),
                f"{phase}: params leaf {jax.tree_util.keystr(path)} differs across cards",
            )
        for leaf in jax.tree.leaves((state.env_state, state.timestep)):
            check(
                len(leaf.sharding.device_set) == 4
                and leaf.addressable_shards[0].data.shape[0] * 4 == leaf.shape[0],
                f"{phase}: env state not split over the 4 cards: {leaf.sharding}",
            )
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in gpus]
        log(phase, f"params identical on all 4 cards; env state split 4 ways; "
            f"peak bytes in use per card {peaks}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-gpu", action="store_true",
                        help="run only the four-GPU data-parallel phase")
    args = parser.parse_args(argv)

    devices = require_gpu()
    print(f"card: {card_info()}", flush=True)
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} device(s)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.four_gpu:
        phases = [("four_gpu", phase_four_gpu)]
    else:
        phases = [
            ("ff_ippo", lambda: phase_train("ff_ippo", FF_IPPO)),
            ("rec_ippo", lambda: phase_train("rec_ippo", REC_IPPO)),
            ("donation", phase_donation),
            ("vmap_seeds", phase_vmap_seeds),
            ("gru_precision", phase_gru_precision),
            ("ff_precision", phase_ff_precision),
            ("gru_trace", phase_gru_trace),
        ]
    for name, fn in phases:
        start = time.perf_counter()
        fn()
        log(name, f"passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": devices[0].platform, "kind": devices[0].device_kind,
                   "count": len(devices)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
