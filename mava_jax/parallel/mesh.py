"""Mesh-based SPMD runtime.

This replaces the reference's single-host `jax.pmap(jax.vmap(...))` Anakin core
(`mava/systems/ppo/ff_ippo.py:335,405`) with an explicit `jax.sharding.Mesh` +
`shard_map` design (SURVEY.md §2.7/§7):

  * one 1-D mesh axis `data` spans every device (single host: all local devices;
    multi-host: the global device array after `jax.distributed.initialize`). A flat
    axis fits GPUs joined all to all (NVLink): the mesh follows the algorithm;
  * the update step is written ONCE for a per-device shard of environments;
    `shard_map` runs it SPMD over the mesh, and gradients/metrics sync with
    `lax.pmean('data')`, which XLA lowers to an all-reduce (NCCL on GPUs);
  * params/optimizer state are replicated (PartitionSpec()), environment state and
    rollout data are sharded on their leading env axis (PartitionSpec('data')).

The N-device step IS the 1-device step — there is no `update_batch_size` replication
hack (that vmap-DP axis existed to keep per-GPU batches small; here it is folded into
the real per-device env batch).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SEED_AXIS = "seed"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A 1-D data mesh over the given (default: all) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (DATA_AXIS,))


def make_seed_sharded_mesh(
    seed_shards: int, devices: Optional[Sequence[jax.Device]] = None
) -> Mesh:
    """A 2-D ``(seed, data)`` mesh for SEED-SHARDED multi-seed training.

    The vmapped multi-seed programs (`advanced_usage/*_vmap_seeds.py`) stack N
    independent seeds on a leading axis. With the default 1-D mesh that axis is
    UNSHARDED, so every device holds all N seeds' replay buffers — the memory
    bound of vmapped replay systems.

    Sharding the seed axis over its own mesh axis removes it: each device
    group holds only ``N / seed_shards`` seeds' state, and — because independent
    seeds must NOT average gradients — the stock learner's ``pmean(DATA_AXIS)``
    needs no change at all: inside ``shard_map`` over this mesh it reduces over
    the ``data`` rows of one seed group only. The stock update fn is reused
    verbatim; only the placement changes.

    ``seed_shards`` must divide the device count; each seed group then runs the
    stock program over ``n_devices // seed_shards`` data shards.
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if n % seed_shards != 0:
        raise ValueError(
            f"seed_shards={seed_shards} must divide the device count ({n})"
        )
    grid = np.array(devices).reshape(seed_shards, n // seed_shards)
    return Mesh(grid, (SEED_AXIS, DATA_AXIS))


def num_learner_devices(mesh: Mesh) -> int:
    return int(np.prod(mesh.devices.shape))


def replicate_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leading_axis(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def build_learner(
    learner_fn: Callable,
    mesh: Mesh,
    in_specs: Any,
    out_specs: Any,
    donate: bool = False,
) -> Callable:
    """shard_map + jit a per-shard learner function over the mesh.

    `in_specs`/`out_specs` are pytrees of PartitionSpec matching the learner's
    argument/return structure (P() = replicated, P('data') = sharded leading axis).
    `check_vma=False` because the learner returns pmean-reduced (replicated-by-value)
    params from varying inputs, which the static replication checker can't prove.

    `donate` donates the learner-state buffers, so the step's outputs reuse them
    instead of holding a second copy (large for replay buffers). Set by
    `arch.donate_buffers`; its default is ROADMAP S6, to be decided by a
    measurement of peak memory and step time. With donation the state passes
    through `unaliased` first (see there).
    """
    mapped = jax.shard_map(
        learner_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    if not donate:
        return jax.jit(mapped)
    jitted = jax.jit(mapped, donate_argnums=(0,))

    def learn(state, *args):
        return jitted(unaliased(state), *args)

    learn.lower = jitted.lower
    return learn


def unaliased(tree: Any) -> Any:
    """`tree` with every leaf that shares a device buffer with an earlier leaf
    replaced by a copy. XLA on the GPU may return ONE buffer for two outputs
    that hold the same value (e.g. two zero-initialised state fields), and a
    buffer cannot be donated twice in one call."""
    seen = set()

    def fix(x):
        if not isinstance(x, jax.Array):
            return x
        pointers = [s.data.unsafe_buffer_pointer() for s in x.addressable_shards]
        if seen.intersection(pointers):
            return x.copy()
        seen.update(pointers)
        return x

    return jax.tree.map(fix, tree)


def tree_pspec(tree: Any, spec) -> Any:
    """Broadcast one PartitionSpec over a pytree structure."""
    return jax.tree.map(lambda _: spec, tree)
