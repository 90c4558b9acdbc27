"""ff-ISAC/MASAC with VMAPPED SEEDS: N independent SAC seeds in ONE program.

Same rationale as `ff_ippo_vmap_seeds.py` (the MARL step is a long serial
chain over small batches), and plausibly more valuable for the off-policy
family, whose wall-clock is many tiny train-epoch steps. Replay memory is the
trade — the buffer is
replicated per seed, so device HBM scales as `num_seeds * buffer_size`
(keep `system.buffer_size` sized accordingly; the continuous-control tasks
use small observations, so the default 1e6 fits several seeds). On a
multi-chip slice, `+system.seed_shards=K` shards the seed axis over a 2-D
`(seed, data)` mesh instead, dividing per-device buffer HBM by K (see
`make_seed_mesh` / `make_seed_sharded_mesh`; equivalence-tested in
`tests/test_seed_sharding.py`).

Mechanics: the stock `ff_isac.init` is run once per seed (seed s uses
`system.seed + s`) and the resulting learner states are STACKED on a leading
axis — replication by construction, nothing re-derived. The stock
explore/update fns are wrapped in `jax.vmap` INSIDE `shard_map`, so the
gradient `pmean` over the mesh axis applies per seed automatically. Sharding
specs are the stock `_state_specs` lifted by one leading (unsharded) seed
axis.

Usage:
    python -m mava_jax.advanced_usage.ff_isac_vmap_seeds \
        env=mahopper system.total_timesteps=300000 +system.num_seeds=4

Reference contrast: the reference runs SAC seeds as separate processes
(`mava/systems/sac/ff_isac.py:418` one-seed main); this module is a
capability it does not have.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mava_jax.envs.wrappers import get_final_step_metrics
from mava_jax.evaluator import get_eval_fn, make_ff_eval_act_fn
from mava_jax.parallel import (
    DATA_AXIS,
    SEED_AXIS,
    build_learner,
    make_mesh,
    make_seed_sharded_mesh,
)
from mava_jax.systems.sac import ff_isac
from mava_jax.utils.config import Config, load_config
from mava_jax.utils.logger import LogEvent, MavaLogger
from mava_jax.utils.timestep_checker import check_total_timesteps


def lift_specs(spec_tree: Any, seed_axis: Any = None) -> Any:
    """Prepend a seed axis to every PartitionSpec in a tree.

    ``seed_axis=None`` (default) lifts with an UNSHARDED seed axis: every
    device holds all seeds (fine for on-policy, HBM-bound for replay systems).
    ``seed_axis=SEED_AXIS`` shards the seed axis over the ``seed`` row of a
    2-D ``make_seed_sharded_mesh`` — each device holds only its local seeds'
    replay buffers, which lifts the vmap-seeds device-memory bound."""
    return jax.tree.map(lambda s: P(seed_axis, *s), spec_tree)


def make_seed_mesh(cfg: Config, num_seeds: int):
    """Resolve the multi-seed mesh from `system.seed_shards` (default 1).

    Returns ``(mesh, seed_axis)``: the default 1-D data mesh with an unsharded
    (`None`) seed axis, or — when ``system.seed_shards > 1`` — a 2-D
    ``(seed, data)`` mesh with the seed axis name to shard over. Seed sharding
    divides per-device replay-buffer memory by ``seed_shards`` at the cost of
    running each seed over fewer data shards."""
    seed_shards = int(cfg.system.get("seed_shards", 1))
    if seed_shards <= 1:
        return make_mesh(), None
    if num_seeds % seed_shards != 0:
        raise ValueError(
            f"system.seed_shards={seed_shards} must divide num_seeds={num_seeds}"
        )
    return make_seed_sharded_mesh(seed_shards), SEED_AXIS


def make_eval_setup(cfg: Config, mesh, seed_axis: Any):
    """Resolve the (mesh, config) the EVALUATOR runs with.

    Eval always rides a 1-D data mesh over ALL devices (params replicated);
    the 2-D seed mesh is a training-placement concern only. In seed-sharded
    mode `cfg.arch.n_devices` holds the PER-SEED data-shard count (n/K), so
    the evaluator gets a copy with the eval mesh's FULL device count —
    otherwise `get_num_eval_envs` sizes per-device env batches for n/K
    devices while the eval shard_map spans n, running up to K x the
    configured episodes (and warning about divisibility on every eval)."""
    if seed_axis is None:
        return mesh, cfg
    eval_mesh = make_mesh()
    eval_cfg = copy.deepcopy(cfg)
    eval_cfg.arch.n_devices = len(eval_mesh.devices.reshape(-1))
    return eval_mesh, eval_cfg


def stack_states(states: list) -> Any:
    """Host-side stack of per-seed learner states on a new leading axis."""
    return jax.tree.map(lambda *xs: np.stack(xs), *states)


def split_buffer_experience(ls: Any) -> Tuple[Any, Any]:
    """Strip the replay EXPERIENCE out of a learner state before host transfer.

    The experience is all-zeros at init (`replay/{trajectory,item}_buffer.py`)
    and can be multiple GB per seed — round-tripping those zeros through the
    host is pure waste. Returns (state with `experience=()`, a ShapeDtypeStruct
    template of the removed leaves) — recreate the stacked zeros directly on
    device with `make_stacked_experience`."""
    template = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ls.buffer_state.experience
    )
    small = ls._replace(buffer_state=ls.buffer_state.replace(experience=()))
    return small, template


def make_stacked_experience(template: Any, num_seeds: int, exp_specs: Any, mesh):
    """(num_seeds, ...)-stacked all-zeros experience, created ON DEVICE with
    its target sharding — no host round trip (see split_buffer_experience)."""
    shardings = jax.tree.map(
        lambda p: NamedSharding(mesh, p),
        exp_specs,
        is_leaf=lambda x: isinstance(x, P),
    )
    make = jax.jit(
        lambda: jax.tree.map(
            lambda sd: jnp.zeros((num_seeds, *sd.shape), sd.dtype), template
        ),
        out_shardings=shardings,
    )
    return make()


def place_state(state: Any, spec_tree: Any, mesh) -> Any:
    """device_put a stacked state using a (prefix) tree of PartitionSpecs.

    `spec_tree`'s P leaves are prefixes over the state's subtrees (the same
    contract `shard_map` uses): each P is broadcast over the corresponding
    state subtree.
    """
    flat_specs, spec_def = jax.tree.flatten(
        spec_tree, is_leaf=lambda x: isinstance(x, P)
    )
    subtrees = spec_def.flatten_up_to(state)
    placed = [
        jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, spec)), sub)
        for spec, sub in zip(flat_specs, subtrees)
    ]
    return jax.tree.unflatten(spec_def, placed)


def learner_setup(
    cfg: Config, mesh, num_seeds: int, centralised_critic: bool = False,
    sweep_lrs=None, seed_axis=None,
) -> Tuple[Any, Any, Any, Any, Any]:
    """Per-seed stock init, stacked and placed with seed-lifted specs.

    With `sweep_lrs`, entry i keeps the SAME seed but its policy/q learning
    rate becomes `sweep_lrs[i]`, baked into optimizer STATE by the swept-Adam
    init (`ff_isac.init(swept_lr=True)`) — stacking the states automatically
    yields the (S,)-shaped peak_lr leaves the vmapped update sweeps over.

    With `seed_axis=SEED_AXIS`, `mesh` is a 2-D `(seed, data)` mesh from
    `make_seed_sharded_mesh` and the seed axis is SHARDED over it: each device
    group holds only its local seeds' replay buffers (the multi-chip fix for
    the per-seed buffer HBM scaling). The stock update fn is unchanged — its
    `pmean(DATA_AXIS)` reduces within one seed group by mesh construction."""
    # Stock init must see the PER-SEED data mesh (one row of a 2-D seed mesh):
    # env counts and rng rows are per-seed quantities.
    setup_mesh = make_mesh(list(mesh.devices[0])) if seed_axis else mesh
    states = []
    for s in range(num_seeds):
        cfg_s = copy.deepcopy(cfg)
        if sweep_lrs is None:
            cfg_s.system.seed = int(cfg.system.seed) + s
        else:
            cfg_s.system.policy_lr = float(sweep_lrs[s])
            cfg_s.system.q_lr = float(sweep_lrs[s])
        envs_, networks, optims, rb, ls, target_entropy, _ = ff_isac.init(
            cfg_s, setup_mesh, centralised_critic, swept_lr=sweep_lrs is not None
        )
        # Replay experience stays on device (GB-scale zeros; r5 j062): strip it
        # before the host transfer and recreate the stacked zeros in place.
        ls, exp_template = split_buffer_experience(ls)
        states.append(jax.device_get(ls))
        del ls  # free seed s's device arrays before seed s+1 allocates
    # env/networks/optims/rb are structurally identical across seeds; keep the last.
    stacked = stack_states(states)

    buffer_template = stacked.buffer_state.replace(experience=exp_template)
    seed_specs = lift_specs(ff_isac._state_specs(buffer_template), seed_axis)
    small_specs = seed_specs._replace(
        buffer_state=seed_specs.buffer_state.replace(experience=())
    )
    learner_state = place_state(stacked, small_specs, mesh)
    experience = make_stacked_experience(
        exp_template, num_seeds, seed_specs.buffer_state.experience, mesh
    )
    learner_state = learner_state._replace(
        buffer_state=learner_state.buffer_state.replace(experience=experience)
    )

    env, eval_env = envs_
    cfg.system.num_agents = env.num_agents  # init() set it only on seed copies
    explore_fn, update_fn = ff_isac.make_update_fns(
        cfg, env, networks, optims, rb, target_entropy, centralised_critic
    )
    donate = cfg.arch.get("donate_buffers", False)
    explore = build_learner(
        jax.vmap(explore_fn),
        mesh,
        in_specs=(seed_specs,),
        out_specs=(seed_specs, lift_specs(P(None, DATA_AXIS), seed_axis)),
        donate=donate,
    )
    update = build_learner(
        jax.vmap(update_fn),
        mesh,
        in_specs=(seed_specs,),
        out_specs=(
            seed_specs,
            (lift_specs(P(None, None, DATA_AXIS), seed_axis), lift_specs(P(), seed_axis)),
        ),
        donate=donate,
    )
    return (env, eval_env), networks, (explore, update), learner_state, num_seeds


def run_experiment(
    cfg: Config, centralised_critic: bool = False, sweep_lrs=None
) -> float:
    cfg = copy.deepcopy(cfg)
    if sweep_lrs is not None:
        num_seeds = len(sweep_lrs)
    else:
        num_seeds = int(cfg.system.get("num_seeds", 4))
    mesh, seed_axis = make_seed_mesh(cfg, num_seeds)
    # n_devices is the PER-SEED data-shard count (the whole mesh when the seed
    # axis is unsharded; one seed row of a 2-D seed-sharded mesh otherwise).
    n_devices = mesh.shape[DATA_AXIS]
    cfg.arch.n_devices = n_devices
    cfg = check_total_timesteps(cfg)

    steps_per_rollout = int(cfg.system.total_timesteps // cfg.arch.num_evaluation)
    anakin_act_steps = n_devices * cfg.arch.num_envs * cfg.system.rollout_length
    cfg.system.scan_steps = max(1, int(steps_per_rollout / anakin_act_steps))

    (env, eval_env), networks, (explore, update), learner_state, _ = learner_setup(
        cfg, mesh, num_seeds, centralised_critic, sweep_lrs=sweep_lrs,
        seed_axis=seed_axis,
    )

    logger = MavaLogger(cfg)
    actor, _ = networks
    eval_act_fn = make_ff_eval_act_fn(actor.apply, cfg)
    eval_mesh, eval_cfg = make_eval_setup(cfg, mesh, seed_axis)
    evaluator = get_eval_fn(
        eval_env, eval_act_fn, eval_cfg, eval_mesh, absolute_metric=False
    )
    key = jax.random.PRNGKey(cfg.system.seed)

    start_time = time.time()
    learner_state, metrics = explore(learner_state)
    jax.block_until_ready(learner_state)
    # every seed consumed explore-steps on every shard; t is identical per seed
    t = int(learner_state.t[0]) * n_devices
    final_metrics, ep_completed = get_final_step_metrics(metrics)
    final_metrics["steps_per_second"] = num_seeds * t / (time.time() - start_time)
    if ep_completed:
        logger.log(final_metrics, t, 0, LogEvent.ACT)

    seed_returns = jnp.zeros(num_seeds)
    per_seed = [0.0] * num_seeds  # read after the loop; the loop can be empty
    start, stop = t, int(cfg.system.total_timesteps + 1)
    for eval_idx, t in enumerate(range(start, stop, steps_per_rollout)):
        start_time = time.time()
        learner_state, (metrics, losses) = update(learner_state)
        jax.block_until_ready(learner_state)
        t += steps_per_rollout

        elapsed = time.time() - start_time
        final_metrics, ep_completed = get_final_step_metrics(metrics)
        final_metrics["steps_per_second"] = num_seeds * steps_per_rollout / elapsed
        if ep_completed:
            logger.log(final_metrics, t, eval_idx, LogEvent.ACT)
        logger.log(
            {**losses, "log_alpha": learner_state.params.log_alpha},
            t,
            eval_idx,
            LogEvent.TRAIN,
        )

        per_seed = []
        for s in range(num_seeds):
            key, eval_key = jax.random.split(key)
            params_s = jax.tree.map(lambda x: x[s], learner_state.params.actor)
            eval_metrics = evaluator(params_s, eval_key, {})
            per_seed.append(float(jnp.mean(eval_metrics["episode_return"])))
        seed_returns = jnp.array(per_seed)
        logger.log(
            {
                "episode_return": seed_returns,
                "seed_return_best": float(seed_returns.max()),
                "seed_return_worst": float(seed_returns.min()),
            },
            t,
            eval_idx,
            LogEvent.EVAL,
        )

    if sweep_lrs is not None:
        print(
            "vmap-sweep final eval returns per lr: "
            + ", ".join(f"lr={lr:g}: {r:.2f}" for lr, r in zip(sweep_lrs, per_seed))
        )
    else:
        print(
            "vmap-seeds final eval returns per seed: "
            + ", ".join(f"{r:.2f}" for r in per_seed)
        )
    logger.stop()
    return float(seed_returns.mean())


def main() -> float:
    import sys

    from mava_jax.parallel import initialize

    initialize()
    cfg = load_config("default_ff_isac", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-ISAC vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
