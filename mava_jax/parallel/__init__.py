from mava_jax.parallel.mesh import (
    DATA_AXIS,
    SEED_AXIS,
    build_learner,
    make_mesh,
    make_seed_sharded_mesh,
    num_learner_devices,
    replicate_sharding,
    shard_leading_axis,
)
from mava_jax.parallel.distributed import (
    initialize,
    is_main_process,
    put_replicated,
    put_sharded_rows,
    sharded_env_reset,
    tile_for_shards,
)

__all__ = [
    "DATA_AXIS",
    "SEED_AXIS",
    "build_learner",
    "initialize",
    "is_main_process",
    "make_mesh",
    "make_seed_sharded_mesh",
    "num_learner_devices",
    "put_replicated",
    "put_sharded_rows",
    "replicate_sharding",
    "shard_leading_axis",
    "sharded_env_reset",
    "tile_for_shards",
]
