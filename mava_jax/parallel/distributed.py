"""Multi-host support.

The reference is single-process only (`len(jax.devices())` everywhere, SURVEY.md §2.7);
this module provides the multi-host story: `jax.distributed.initialize` bootstrap, and
per-host environment sharding so env state never crosses hosts — only gradients and
metrics ride the collectives inside the shard_mapped learner.

Usage on a cluster (one process per host):
    mava_jax.parallel.distributed.initialize()   # reads cluster env vars
    ... systems work unchanged: the mesh spans all global devices, and
    `sharded_env_reset` builds the global env-state array from each host's local
    resets via `jax.make_array_from_process_local_data`.

Logging/checkpointing are process-0-only by construction (`MavaLogger` checks
`jax.process_index()`; orbax gathers across hosts natively).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mava_jax.parallel.mesh import DATA_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap multi-process JAX. With no args, relies on cluster auto-detection
    (cluster env vars). No-op if already initialized or single-process.

    MUST be called before any other jax API that touches the backend (e.g.
    `jax.devices()`, `jax.process_count()`) — every system `main()` calls this
    first. Deliberately does NOT query `jax.process_count()` itself: that would
    initialize the local backend and break the pod bootstrap.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # Single-process run (no cluster env vars / already initialized).
        pass


def is_main_process() -> bool:
    return jax.process_index() == 0


def put_replicated(tree: Any, mesh: Mesh) -> Any:
    """Place a host-built pytree replicated over the mesh; multi-process safe.

    Every process must pass the same values (true by construction here: init code
    is deterministic and identical across hosts).
    """
    sharding = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return jax.device_put(tree, sharding)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, np.asarray(x)),
        tree,
    )


def put_sharded_rows(tree: Any, mesh: Mesh) -> Any:
    """Place a host-built GLOBAL pytree sharded on its leading axis; multi-process
    safe. Each process materializes only its contiguous row slice (mesh device
    order is process-major, matching `jax.devices()`).
    """
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    if jax.process_count() == 1:
        return jax.device_put(tree, sharding)
    n_proc = jax.process_count()
    idx = jax.process_index()

    def go(x: Any) -> Any:
        rows = x.shape[0] // n_proc
        local = np.asarray(x[idx * rows : (idx + 1) * rows])
        return jax.make_array_from_process_local_data(sharding, local)

    return jax.tree.map(go, tree)


def tile_for_shards(tree: Any, mesh: Mesh) -> Any:
    """Tile a PER-SHARD pytree template along its leading axis so every mesh shard
    gets an identical copy (global leading dim = n_shards * local leading dim),
    materializing only this process's local rows. Used for replay-buffer
    experience and RNN hidden-state initialisation, where every shard starts from
    the same template but evolves its own rows.
    """
    n_global = int(mesh.devices.size)
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    if jax.process_count() == 1:

        def rep(x: jnp.ndarray) -> jnp.ndarray:
            tiled = jnp.broadcast_to(x, (n_global, *x.shape)).reshape(
                n_global * x.shape[0], *x.shape[1:]
            )
            return jax.device_put(tiled, sharding)

        return jax.tree.map(rep, tree)

    n_local = n_global // jax.process_count()

    def rep_local(x: Any) -> Any:
        x = np.asarray(x)
        tiled = np.broadcast_to(x, (n_local, *x.shape)).reshape(
            n_local * x.shape[0], *x.shape[1:]
        )
        return jax.make_array_from_process_local_data(sharding, tiled)

    return jax.tree.map(rep_local, tree)


def sharded_env_reset(
    env: Any, key: jnp.ndarray, n_total_envs: int, mesh: Mesh
) -> Tuple[Any, Any]:
    """Reset `n_total_envs` environments, sharded over the mesh's data axis.

    Single-process: one vmapped reset, device_put with the sharded layout.
    Multi-process: each host resets only its local slice (keys are derived from the
    env index so every host draws from the same global stream deterministically) and
    the global array is assembled with `make_array_from_process_local_data` — env
    state never crosses DCN.
    """
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    all_keys = jax.random.split(key, n_total_envs)

    if jax.process_count() == 1:
        env_states, timesteps = jax.vmap(env.reset)(all_keys)
        return (
            jax.device_put(env_states, sharding),
            jax.device_put(timesteps, sharding),
        )

    n_local = n_total_envs // jax.process_count()
    start = jax.process_index() * n_local
    local_keys = all_keys[start : start + n_local]
    local_states, local_timesteps = jax.vmap(env.reset)(local_keys)

    def to_global(local: Any) -> Any:
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(sharding, x), local
        )

    return to_global(local_states), to_global(local_timesteps)
